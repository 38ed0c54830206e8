"""The port's LM layers (``repro_torch.models.layers``) and MoE FFN
(``repro_torch.models.moe``) on the CPU, held against ``repro``'s on the
same numpy inputs from a seed, in float32 (the reference's test dtype)
and, where stated, float64.

Tolerances (float32 unless said): ``rms_norm``, ``rope_freqs`` /
``apply_rope`` 1e-6 relative (one rounding of a few operations each; the
largest seen 2.4e-7); the attention functions and ``mlp_block`` 1e-5 x
(max|reference| + 1) (float32 accumulations in other orders; seen <= 1e-6);
``moe_ffn`` outputs 1e-5 x scale and ``aux`` 1e-6 relative, on inputs
whose routing overflows the default capacity (drops, counted by the
reference's own rule) and at capacity 64 (none).

Also C7 (ROADMAP section C): past ``s_max`` with no window the reference's
``dynamic_update_slice`` clamps the write and keeps decoding, overwriting
its last slot; the port raises ``ValueError``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JY
from repro.models import lm as JL
from repro.models import moe as JM
from repro_torch.models import layers as TY
from repro_torch.models import lm as TL
from repro_torch.models import moe as TM
from test_torch_lm import (as_np, both, cfgs, max_err, np_batch, np_params,
                           to_t)
from test_torch_saif import _one_torch_thread  # noqa: F401

TOL = 1e-5


def _rel(a, b):
    return max_err(a, b) / (float(np.max(np.abs(as_np(b)))) + 1.0)


def _x(shape, seed=0, dtype=np.float32, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(dtype)


def _layer0(arch, dtype="float32", **kw):
    """Layer 0 of the SMOKE config's stacked blocks, as numpy, jnp, torch."""
    jc, tc = cfgs(arch, dtype, **kw)
    tree = np_params(jc)
    bp = {k: v[0] for k, v in tree["blocks"].items()}
    return jc, tc, bp, {k: jnp.asarray(v) for k, v in bp.items()}, \
        {k: torch.from_numpy(v) for k, v in bp.items()}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_rms_norm(dtype):
    x, w = _x((2, 5, 48), 1, dtype, 3.0), _x((48,), 2, dtype)
    got = TY.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    want = JY.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)
    assert got.dtype == getattr(torch, np.dtype(dtype).name)
    assert _rel(got, want) <= 1e-6


def test_rope_freqs_and_apply_rope():
    pos2 = np.arange(7)[None, :]
    pos1 = np.array([3, 11, 1000])
    for pos in (pos2, pos1):
        tc, ts = TY.rope_freqs(16, 10_000.0, torch.from_numpy(pos))
        jc, js = JY.rope_freqs(16, 10_000.0, jnp.asarray(pos))
        assert tc.shape == jc.shape and tc.dtype == torch.float32
        assert max_err(tc, jc) <= 1e-6 and max_err(ts, js) <= 1e-6
    x = _x((2, 7, 3, 16), 4)
    c, s = TY.rope_freqs(16, 500.0, torch.from_numpy(pos2))
    jc, js = JY.rope_freqs(16, 500.0, jnp.asarray(pos2))
    got = TY.apply_rope(torch.from_numpy(x), c, s)
    want = JY.apply_rope(jnp.asarray(x), jc, js)
    assert _rel(got, want) <= 1e-6
    # (S, hd/2) tables too
    got2 = TY.apply_rope(torch.from_numpy(x), c[0], s[0])
    assert torch.equal(got2, got)


@pytest.mark.parametrize("case", ["causal", "bidirectional", "window",
                                  "q_offset", "float64"])
def test_gqa_attention(case):
    dt = np.float64 if case == "float64" else np.float32
    Sq = 3 if case == "q_offset" else 12
    q, k, v = (_x((2, Sq, 6, 8), 5, dt), _x((2, 12, 2, 8), 6, dt),
               _x((2, 12, 2, 8), 7, dt))
    kw = {"causal": case != "bidirectional",
          "window": 4 if case == "window" else 0}
    if case == "q_offset":
        kw["q_offset"] = 9
    got = TY.gqa_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    want = JY.gqa_attention(*map(jnp.asarray, (q, k, v)), **kw)
    assert got.dtype == getattr(torch, np.dtype(dt).name)
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("cross", [False, True])
def test_attention_block(cross):
    jc, tc, _, jp, tp = _layer0("glm4_9b")
    x = _x((2, 10, tc.d_model), 8)
    src = _x((2, 6, tc.d_model), 9) if cross else None
    pos = np.arange(10)[None, :]
    got = TY.attention_block(
        torch.from_numpy(x), tp, tc, positions=torch.from_numpy(pos),
        window=3, kv_x=None if src is None else torch.from_numpy(src),
        use_rope=not cross)
    want = JY.attention_block(
        jnp.asarray(x), jp, jc, positions=jnp.asarray(pos), window=3,
        kv_x=None if src is None else jnp.asarray(src), use_rope=not cross)
    assert got.shape == (2, 10, tc.d_model)
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("window", [0, 4])
def test_attention_decode_ring_wraps(window):
    """Ten decode steps into a cache of 4 slots (with a window of 4 the ring
    wraps twice): each output and the whole cache against the reference's
    after every step; without a window, four steps fill the cache."""
    jc, tc, _, jp, tp = _layer0("glm4_9b")
    B, S_max = 2, 4
    steps = 10 if window else S_max
    kc = np.zeros((B, S_max, tc.n_kv_heads, tc.hd), np.float32)
    jcache = JY.KVCache(jnp.asarray(kc), jnp.asarray(kc))
    tcache = TY.KVCache(torch.zeros(kc.shape), torch.zeros(kc.shape))
    xs = _x((steps, B, 1, tc.d_model), 10)
    for pos in range(steps):
        jo, jcache = JY.attention_decode(jnp.asarray(xs[pos]), jp, jc,
                                         jcache, pos, window=window)
        to, tcache = TY.attention_decode(torch.from_numpy(xs[pos]), tp, tc,
                                         tcache, pos, window=window)
        assert _rel(to, jo) <= TOL
        assert _rel(tcache.k, jcache.k) <= TOL
        assert _rel(tcache.v, jcache.v) <= TOL


@pytest.mark.parametrize("act", ["swiglu", "gelu", "sq_relu"])
def test_mlp_block(act):
    rng = np.random.default_rng(11)
    p = {k: (rng.standard_normal(s) * s[0] ** -0.5).astype(np.float32)
         for k, s in (("w1", (32, 64)), ("w3", (32, 64)), ("w2", (64, 32)))}
    x = _x((2, 5, 32), 12)
    got = TY.mlp_block(torch.from_numpy(x),
                       {k: torch.from_numpy(v) for k, v in p.items()}, act)
    want = JY.mlp_block(jnp.asarray(x),
                        {k: jnp.asarray(v) for k, v in p.items()}, act)
    assert _rel(got, want) <= TOL
    with pytest.raises(ValueError):
        TY.mlp_block(torch.from_numpy(x), {}, "relu")


def _kept(logits, cfg, T):
    """Which of the T*k assignments the capacity keeps (numpy, from the
    reference's own rule)."""
    topi = np.asarray(jax.lax.top_k(jnp.asarray(logits), cfg.top_k)[1])
    flat_e = topi.reshape(-1)
    rank = np.zeros_like(flat_e)
    for e in range(cfg.n_experts):
        idx = np.where(flat_e == e)[0]
        rank[idx] = np.arange(len(idx))
    C = max(int(T * cfg.top_k / cfg.n_experts * cfg.capacity_factor), 1)
    return rank < C


@pytest.mark.parametrize("arch,capacity", [
    ("qwen3_moe_30b_a3b", None), ("dbrx_132b", None),
    ("qwen3_moe_30b_a3b", 64.0), ("dbrx_132b", 64.0)])
def test_moe_ffn(arch, capacity):
    kw = {} if capacity is None else {"capacity_factor": capacity}
    jc, tc, bp, jp, tp = _layer0(arch, **kw)
    # inputs leaning toward expert 0, so that its queue outgrows the
    # default capacity
    r0 = bp["router"][:, 0]
    x = _x((3, 16, tc.d_model), 13) + 3.0 * r0 / np.linalg.norm(r0)
    got, taux = TM.moe_ffn(torch.from_numpy(x), tp, tc)
    want, jaux = JM.moe_ffn(jnp.asarray(x), jp, jc)
    assert _rel(got, want) <= TOL
    assert abs(float(taux) - float(jaux)) <= 1e-6 * abs(float(jaux))
    kept = _kept(np.asarray(x.reshape(-1, tc.d_model) @ np.asarray(
        jp["router"])), jc, 48)
    if capacity is None:
        assert not kept.all()          # the default capacity drops some
    else:
        assert kept.all()


def test_moe_top_k_ties_go_to_the_lower_expert():
    """Router logits with exact ties: the port picks the reference's
    experts (the lower id first, as ``jax.lax.top_k``)."""
    jc, tc, _, jp, tp = _layer0("qwen3_moe_30b_a3b", capacity_factor=64.0)
    router = np.zeros((tc.d_model, tc.n_experts), np.float32)
    router[:, 5] = 1.0                 # expert 5 first, then a 7-way tie
    jp = {**jp, "router": jnp.asarray(router)}
    tp = {**tp, "router": torch.from_numpy(router)}
    x = np.abs(_x((1, 4, tc.d_model), 14))
    got, _ = TM.moe_ffn(torch.from_numpy(x), tp, tc)
    want, _ = JM.moe_ffn(jnp.asarray(x), jp, jc)
    assert _rel(got, want) <= TOL


def test_decode_past_s_max_clamps_in_the_reference_and_raises_here():
    """C7: stablelm SMOKE with s_max = 4 and no window. The reference decodes
    6 steps with finite logits, its slot 3 rewritten by each late step; the
    port matches it for 4 steps and raises on the 5th."""
    arch = "stablelm_3b"
    jc, tc = cfgs(arch)
    jp, tp = both(np_params(jc), jc, tc)
    toks = np_batch(jc, 2, 6)["tokens"]
    step = jax.jit(lambda p, t, s: JL.decode_step(p, t, s, jc))
    js = JL.init_decode_state(jp, jc, 2, 4)
    ts = TL.init_decode_state(tp, tc, 2, 4)
    slot3 = []
    for t in range(6):
        jl, js = step(jp, jnp.asarray(toks[:, t]), js)
        assert bool(jnp.isfinite(jl).all())
        slot3.append(np.asarray(js.caches["kv"].k[:, :, 3]))
        if t < 4:
            tl, ts = TL.decode_step(tp, torch.from_numpy(toks[:, t]), ts, tc)
            assert _rel(tl, jl) <= 2e-5
    assert int(js.pos) == 6
    assert not np.array_equal(slot3[3], slot3[4])   # overwritten at pos 4
    assert not np.array_equal(slot3[4], slot3[5])   # and again at pos 5
    with pytest.raises(ValueError, match="outside the KV cache of 4"):
        TL.decode_step(tp, torch.from_numpy(toks[:, 4]), ts, tc)
    # a windowed cache is a ring and never raises
    jc, tc = cfgs(arch, window=4)
    jp, tp = both(np_params(jc), jc, tc)
    ts = TL.init_decode_state(tp, tc, 2, 4)
    for t in range(6):
        _, ts = TL.decode_step(tp, torch.from_numpy(toks[:, t]), ts, tc)
    assert ts.pos == 6


def test_decode_leaves_parameters_and_inputs_unchanged():
    """The in-place cache writes of decode touch only the state: the
    parameters and the inputs are left as they were."""
    jc, tc = cfgs("hymba_1_5b")
    _, tp = both(np_params(jc), jc, tc)
    before = {k: v.clone() for k, v in tp["blocks"].items()}
    b = to_t(np_batch(jc, 2, 5))
    toks = b["tokens"].clone()
    st = TL.init_decode_state(tp, tc, 2, 5)
    for t in range(5):
        _, st = TL.decode_step(tp, b["tokens"][:, t], st, tc)
    assert all(torch.equal(before[k], tp["blocks"][k]) for k in before)
    assert torch.equal(toks, b["tokens"])
