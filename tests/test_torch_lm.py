"""The LM scaffold's serving path in the port on the CPU, held against
``repro`` on the same numpy inputs from a seed.

Whole-package checks: every ``ModelConfig`` field and property, the
registry (``ARCH_IDS``, ``ALIASES``, ``SHAPES``, ``get_config``,
``smoke_config``, ``runnable_cells``), ``param_shapes`` / ``param_count`` /
``active_param_count`` of all ten full configs equal to the reference's;
``init``'s rules (shapes, dtypes, the fixed leaves, mean and std of the
drawn ones); ``convert.lm_params_from_numpy`` refusing a missing, extra or
misshapen leaf; ``device=None`` raising without a card; ``CausalLM``;
``launch.steps``; an LM tree through either package's checkpoint.

Per architecture (all ten SMOKE configs, float32 here and float64 in
``test_torch_lm_f64.py``): ``backbone`` + ``logits_fn`` and the aux loss,
``train_loss``, ``init_decode_state`` shapes and dtypes,
``fill_cross_cache``, and a 16-step ``decode_step`` sequence (logits and
final caches) against the reference's, and against the port's own forward
pass. Tolerances, relative to scale = max|reference logits| + 1:

  * against the reference, float32 and float64 alike: 2e-5 x scale. Both
    packages accumulate in float32 in different orders (the port's
    doubling scan against ``associative_scan``'s tree too), and float64
    compute keeps float32 stages in every family (attention logits and
    their softmax, ``preferred_element_type=float32``; the xLSTM gates and
    the sLSTM state), so float64 is not reached. The largest seen is 3.2e-6
    x scale in float32 and 2.1e-6 in float64 (xLSTM; 1.1e-6 and 3.6e-7
    for the others).
  * the port's decode against its own forward pass: 2e-4 x scale, the
    bound of ``tests/test_archs.py::test_decode_matches_train_forward``.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.ckpt import checkpoint as j_ckpt
from repro.models import lm as JL
import repro_torch.configs as TC
from repro_torch import convert
from repro_torch.ckpt import checkpoint as t_ckpt
from repro_torch.launch import steps as T_steps
from repro_torch.models import lm as TL
from repro_torch.models.config import ModelConfig
from test_torch_saif import _one_torch_thread  # noqa: F401

ARCHS = JC.ARCH_IDS
TOL_REF = 2e-5
TOL_SELF = 2e-4
DECODE_STEPS = 16


# ---------------------------------------------------------------------------
# shared inputs (also used by test_torch_lm_f64/_layers/_ssm)
# ---------------------------------------------------------------------------

def cfgs(arch, dtype="float32", **kw):
    """(reference config, port config): the SMOKE config in ``dtype``
    (float64 also keeps float64 master weights), remat off."""
    extra = dict(dtype=dtype, remat=False, **kw)
    if dtype == "float64":
        extra["param_dtype"] = "float64"
    return (JC.smoke_config(arch).scaled(**extra),
            TC.smoke_config(arch).scaled(**extra))


def np_params(cfg, seed=0):
    """A parameter tree of numpy arrays by ``init``'s rules, from a seed."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, shp in TL.leaf_paths(JL.param_shapes(cfg)):
        if len(shp) >= 2:
            a = rng.standard_normal(shp) * shp[-2] ** -0.5
        else:
            a = np.ones(shp)
        fixed = TL.fixed_value(path[-1])
        if fixed is not None:
            a = np.full(shp, fixed)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = a.astype(cfg.param_dtype)
    return out


def np_batch(cfg, B, S, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    b = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    if cfg.family == "vlm":
        b["img_embed"] = 0.02 * rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.d_model))
    if cfg.family == "encdec":
        b["frames"] = 0.02 * rng.standard_normal(
            (B, cfg.n_frames, cfg.d_model))
    for k in ("img_embed", "frames"):
        if k in b:
            b[k] = b[k].astype(cfg.dtype)
    return b


def both(tree_np, jcfg, tcfg):
    """The numpy tree as the reference's (jnp) and the port's (CPU)."""
    return (jax.tree.map(jnp.asarray, tree_np),
            convert.lm_params_from_numpy(tree_np, tcfg, device="cpu"))


def to_t(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def to_j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def flat(tree, prefix=()):
    """{path: leaf} of dicts / NamedTuples / tuples of arrays or tensors."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = list(zip(tree._fields, tree))
    elif isinstance(tree, (tuple, list)):
        items = list(enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flat(v, prefix + (k,)))
    return out


def as_np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def max_err(a, b):
    return float(np.max(np.abs(as_np(a).astype(np.float64)
                                - as_np(b).astype(np.float64))))


@functools.lru_cache(maxsize=None)
def ref_fns(arch, dtype, **kw):
    """The reference's jitted forward (logits, aux), loss, cross-cache fill
    and decode step for one config."""
    jc, _ = cfgs(arch, dtype, **kw)

    def fwd(p, b):
        h, aux = JL.backbone(p, b["tokens"], jc, img_embed=b.get("img_embed"),
                             frames=b.get("frames"))
        return JL.logits_fn(p, h, jc), aux

    def fill(p, s, b):
        return JL.fill_cross_cache(p, jc, s, img_embed=b.get("img_embed"),
                                   frames=b.get("frames"))

    return {"fwd": jax.jit(fwd),
            "loss": jax.jit(lambda p, b: JL.train_loss(p, b, jc)),
            "fill": jax.jit(fill),
            "step": jax.jit(lambda p, t, s: JL.decode_step(p, t, s, jc))}


def port_fwd(tp, tb, tc):
    h, aux = TL.backbone(tp, tb["tokens"], tc, img_embed=tb.get("img_embed"),
                         frames=tb.get("frames"))
    return TL.logits_fn(tp, h, tc), aux


# ---------------------------------------------------------------------------
# per-architecture checks (dtype-parametrized; f64 in test_torch_lm_f64.py)
# ---------------------------------------------------------------------------

def check_forward(arch, dtype):
    jc, tc = cfgs(arch, dtype)
    jp, tp = both(np_params(jc), jc, tc)
    b = np_batch(jc, 2, 32)
    jl, ja = ref_fns(arch, dtype)["fwd"](jp, to_j(b))
    tl, ta = port_fwd(tp, to_t(b), tc)
    assert tl.dtype == getattr(torch, dtype) and tl.shape == jl.shape
    scale = float(jnp.max(jnp.abs(jl))) + 1.0
    assert max_err(tl, jl) <= TOL_REF * scale
    assert ta.dtype == torch.float32 and ta.shape == ()
    assert abs(float(ta) - float(ja)) <= TOL_REF * (abs(float(ja)) + 1)
    if tc.family == "moe":
        assert float(ta) > 0.0
    assert bool(torch.isfinite(tl).all())


def check_loss(arch, dtype):
    jc, tc = cfgs(arch, dtype)
    jp, tp = both(np_params(jc), jc, tc)
    b = np_batch(jc, 2, 32)
    jloss = float(ref_fns(arch, dtype)["loss"](jp, to_j(b)))
    tloss = TL.train_loss(tp, to_t(b), tc)
    assert tloss.shape == () and tloss.dtype == torch.float32
    assert abs(float(tloss) - jloss) <= TOL_REF * abs(jloss)


def check_decode_state(arch, dtype):
    jc, tc = cfgs(arch, dtype)
    jp, tp = both(np_params(jc), jc, tc)
    b = np_batch(jc, 2, DECODE_STEPS)
    js = JL.init_decode_state(jp, jc, 2, DECODE_STEPS)
    ts = TL.init_decode_state(tp, tc, 2, DECODE_STEPS)
    assert ts.pos == 0 and isinstance(ts.pos, int)
    jf, tf = flat(js.caches), flat(ts.caches)
    assert jf.keys() == tf.keys()
    for k in jf:
        assert tuple(tf[k].shape) == jf[k].shape, k
        assert str(tf[k].dtype) == f"torch.{jf[k].dtype}", k
        assert not bool(tf[k].any()), k
    js = ref_fns(arch, dtype)["fill"](jp, js, to_j(b))
    tb = to_t(b)
    ts2 = TL.fill_cross_cache(tp, tc, ts, img_embed=tb.get("img_embed"),
                              frames=tb.get("frames"))
    if tc.family in ("vlm", "encdec"):
        jx, tx = flat(js.caches["cross"]), flat(ts2.caches["cross"])
        for k in jx:
            assert tuple(tx[k].shape) == jx[k].shape
            scale = float(jnp.max(jnp.abs(jx[k]))) + 1.0
            assert max_err(tx[k], jx[k]) <= TOL_REF * scale
    else:
        assert ts2 is ts


def check_decode_sequence(arch, dtype):
    jc, tc = cfgs(arch, dtype)
    jp, tp = both(np_params(jc), jc, tc)
    B, S = 2, DECODE_STEPS
    b = np_batch(jc, B, S)
    jb, tb = to_j(b), to_t(b)
    fns = ref_fns(arch, dtype)
    js = fns["fill"](jp, JL.init_decode_state(jp, jc, B, S), jb)
    ts = TL.fill_cross_cache(tp, tc, TL.init_decode_state(tp, tc, B, S),
                             img_embed=tb.get("img_embed"),
                             frames=tb.get("frames"))
    j_all, t_all = [], []
    for t in range(S):
        jl, js = fns["step"](jp, jb["tokens"][:, t], js)
        tl, ts = TL.decode_step(tp, tb["tokens"][:, t], ts, tc)
        assert tl.shape == (B, tc.vocab) and ts.pos == t + 1
        j_all.append(np.asarray(jl))
        t_all.append(tl)
    scale = float(np.max(np.abs(np.stack(j_all)))) + 1.0
    assert max_err(torch.stack(t_all), np.stack(j_all)) \
        <= TOL_REF * scale
    # the caches after the sequence
    jf, tf = flat(js.caches), flat(ts.caches)
    for k in jf:
        cs = float(jnp.max(jnp.abs(jf[k]))) + 1.0
        assert max_err(tf[k], jf[k]) <= TOL_REF * cs, k
    # decode against the port's own forward pass (no-drop MoE, as
    # test_archs.py does)
    tc64 = tc.scaled(capacity_factor=64.0)
    full, _ = port_fwd(tp, tb, tc64)
    st = TL.fill_cross_cache(tp, tc64, TL.init_decode_state(tp, tc64, B, S),
                             img_embed=tb.get("img_embed"),
                             frames=tb.get("frames"))
    worst = 0.0
    for t in range(S):
        lg, st = TL.decode_step(tp, tb["tokens"][:, t], st, tc64)
        worst = max(worst, float((lg - full[:, t]).abs().max()))
    assert worst <= TOL_SELF * (float(full.abs().max()) + 1.0)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    check_forward(arch, "float32")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_matches_reference(arch):
    check_loss(arch, "float32")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_state_and_cross_cache_match_reference(arch):
    check_decode_state(arch, "float32")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_sequence_matches_reference_and_forward(arch):
    check_decode_sequence(arch, "float32")


def test_sliding_window_ring_decode_past_the_window():
    """Hymba decodes 3 windows through its ring cache: logits against the
    reference's decode and the port's own windowed forward, and the cache
    is window-sized (tests/test_archs.py's ring test, held to both)."""
    arch = "hymba_1_5b"
    jc, tc = cfgs(arch, window=8, ssm_chunk=8)
    jp, tp = both(np_params(jc), jc, tc)
    toks = np_batch(jc, 1, 24)["tokens"]
    full, _ = port_fwd(tp, {"tokens": torch.from_numpy(toks)}, tc)
    step = ref_fns(arch, "float32", window=8, ssm_chunk=8)["step"]
    js = JL.init_decode_state(jp, jc, 1, 24)
    ts = TL.init_decode_state(tp, tc, 1, 24)
    worst_self = worst_ref = 0.0
    for t in range(24):
        jl, js = step(jp, jnp.asarray(toks[:, t]), js)
        tl, ts = TL.decode_step(tp, torch.from_numpy(toks[:, t]), ts, tc)
        worst_self = max(worst_self, float((tl - full[:, t]).abs().max()))
        worst_ref = max(worst_ref, max_err(tl, jl))
    scale = float(full.abs().max()) + 1.0
    assert worst_self <= TOL_SELF * scale
    assert worst_ref <= TOL_REF * scale
    assert ts.caches["kv"].k.shape[2] == tc.window


# ---------------------------------------------------------------------------
# whole-package checks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_equals_reference(arch):
    j, t = JC.get_config(arch), TC.get_config(arch)
    assert isinstance(t, ModelConfig)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for prop in ("hd", "sub_quadratic", "has_decoder"):
        assert getattr(t, prop) == getattr(j, prop), prop
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    assert TL.param_shapes(t) == JL.param_shapes(j)
    assert TL.n_slstm_layers(t) == JL.n_slstm_layers(j)
    assert dataclasses.asdict(TC.smoke_config(arch)) == \
        dataclasses.asdict(JC.smoke_config(arch))
    assert t.adtype == torch.bfloat16 and t.pdtype == torch.float32
    assert t.scaled(dtype="float32").adtype == torch.float32


def test_registry_equals_reference():
    assert TC.ARCH_IDS == JC.ARCH_IDS
    assert TC.ALIASES == JC.ALIASES
    assert {k: dataclasses.asdict(v) for k, v in TC.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JC.SHAPES.items()}
    assert TC.runnable_cells() == JC.runnable_cells()
    assert TC.get_config("hymba-1-5b") == TC.get_config("hymba_1_5b")
    with pytest.raises(ValueError, match="unknown arch"):
        TC.get_config("gpt-5")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_follows_the_reference_rules(arch):
    _, tc = cfgs(arch)
    p = TL.init(tc, seed=3, device="cpu")
    shapes = dict(TL.leaf_paths(TL.param_shapes(tc)))
    got = dict(TL.leaf_paths(p))
    assert got.keys() == shapes.keys()
    again = dict(TL.leaf_paths(TL.init(tc, seed=3, device="cpu")))
    other = dict(TL.leaf_paths(TL.init(tc, seed=4, device="cpu")))
    for path, shp in shapes.items():
        w = got[path]
        assert tuple(w.shape) == shp and w.dtype == torch.float32, path
        assert torch.equal(w, again[path]), path
        fixed = TL.fixed_value(path[-1])
        if fixed is not None or len(shp) < 2:
            assert bool((w == (1.0 if fixed is None else fixed)).all()), path
            continue
        assert not torch.equal(w, other[path]), path
        # N(0, 1) * fan_in^-0.5: the sample mean and std within 6 standard
        # errors (fan_in is the second-to-last dim, stacked leaves too)
        n, sd = w.numel(), shp[-2] ** -0.5
        assert abs(float(w.mean())) <= 6 * sd / n ** 0.5, path
        assert abs(float(w.std()) / sd - 1) <= 6 / (2 * n) ** 0.5 + 1e-3, \
            path


def test_init_draws_from_the_given_generator():
    _, tc = cfgs("stablelm_3b")
    g1 = torch.Generator().manual_seed(11)
    g2 = torch.Generator().manual_seed(11)
    a = dict(TL.leaf_paths(TL.init(tc, generator=g1, device="cpu")))
    b = dict(TL.leaf_paths(TL.init(tc, generator=g2, device="cpu")))
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_lm_params_from_numpy_refuses_a_wrong_tree():
    jc, tc = cfgs("hymba_1_5b", "float64")
    tree = np_params(jc)
    ok = convert.lm_params_from_numpy(tree, tc, device="cpu")
    assert ok["blocks"]["A_log"].dtype == torch.float64
    assert np.array_equal(ok["embed"].numpy(), tree["embed"])
    missing = {**tree, "blocks": {k: v for k, v in tree["blocks"].items()
                                  if k != "A_log"}}
    with pytest.raises(ValueError, match="missing.*blocks.A_log"):
        convert.lm_params_from_numpy(missing, tc, device="cpu")
    extra = {**tree, "blocks_s": {"wz": tree["embed"]}}
    with pytest.raises(ValueError, match="extra.*blocks_s.wz"):
        convert.lm_params_from_numpy(extra, tc, device="cpu")
    bad = {**tree, "lm_head": tree["lm_head"][:, :-1]}
    with pytest.raises(ValueError, match="lm_head has shape"):
        convert.lm_params_from_numpy(bad, tc, device="cpu")
    with pytest.raises(ValueError, match="missing.*cross_blocks"):
        convert.lm_params_from_numpy(tree, TC.smoke_config("whisper_tiny"),
                                     device="cpu")


def test_device_none_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jc, tc = cfgs("stablelm_3b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TL.init(tc)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.lm_params_from_numpy(np_params(jc), tc)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TL.CausalLM(tc)


def test_causal_lm_module_holds_the_tree():
    jc, tc = cfgs("whisper_tiny")
    tree = convert.lm_params_from_numpy(np_params(jc), tc, device="cpu")
    m = TL.CausalLM(tc, tree, device="cpu")
    keys = {".".join(p) for p, _ in TL.leaf_paths(TL.param_shapes(tc))}
    assert set(m.state_dict()) == keys
    assert sum(t.numel() for t in m.parameters()) == sum(
        int(np.prod(s)) for _, s in TL.leaf_paths(TL.param_shapes(tc)))
    b = to_t(np_batch(jc, 2, 8))
    with torch.inference_mode():
        want, _ = port_fwd(tree, b, tc)
        got = m(b["tokens"], frames=b["frames"])
    assert torch.equal(got, want)
    m64 = m.to(torch.float64)
    assert m64.params["enc_blocks"]["wq"].dtype == torch.float64
    assert TL.CausalLM(tc, seed=5, device="cpu").state_dict().keys() == \
        m.state_dict().keys()


@pytest.mark.parametrize("arch", ["glm4_9b", "llama_3_2_vision_11b"])
def test_serving_steps_are_the_model_functions(arch):
    jc, tc = cfgs(arch)
    _, tp = both(np_params(jc), jc, tc)
    b = to_t(np_batch(jc, 2, 12))
    prefill = T_steps.make_prefill(tc)
    serve = T_steps.make_serve_step(tc)
    last = prefill(tp, b)
    full, _ = port_fwd(tp, b, tc)
    assert last.is_inference() and last.shape == (2, tc.vocab)
    assert float((last - full[:, -1]).abs().max()) <= \
        TOL_SELF * (float(full.abs().max()) + 1.0)
    st_a = TL.fill_cross_cache(tp, tc, TL.init_decode_state(tp, tc, 2, 12),
                               img_embed=b.get("img_embed"))
    st_b = TL.fill_cross_cache(tp, tc, TL.init_decode_state(tp, tc, 2, 12),
                               img_embed=b.get("img_embed"))
    for t in range(3):
        la, st_a = serve(tp, b["tokens"][:, t], st_a)
        lb, st_b = TL.decode_step(tp, b["tokens"][:, t], st_b, tc)
        assert torch.equal(la, lb)
    assert st_a.pos == 3


def test_lm_tree_through_either_checkpoint(tmp_path):
    """A tree saved by the reference restores into the port's tree and back,
    leaf for leaf (the port's checkpoint carries LM trees unchanged)."""
    jc, tc = cfgs("xlstm_350m")
    tree = np_params(jc)
    jp, _ = both(tree, jc, tc)
    j_ckpt.save(str(tmp_path / "j"), 7, jp)
    like = TL.init(tc, seed=1, device="cpu")
    got, _ = t_ckpt.restore(str(tmp_path / "j"), 7, like)
    for path, leaf in TL.leaf_paths(got):
        assert leaf.dtype == torch.float32
        assert np.array_equal(leaf.numpy(), tree[path[0]][path[1]]
                              if len(path) == 2 else tree[path[0]])
    t_ckpt.save(str(tmp_path / "t"), 3, got)
    back, _ = j_ckpt.restore(str(tmp_path / "t"), 3, jp)
    for (pa, a), (pb, b) in zip(TL.leaf_paths(back), TL.leaf_paths(got)):
        assert pa == pb and np.array_equal(np.asarray(a), b.numpy())
