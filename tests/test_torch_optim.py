"""The LM scaffold's optimizer and gradient compression in the port
(``repro_torch.optim``) on the CPU, held against ``repro.optim`` on the
same numpy trees from a seed.

  * ``adamw.schedule`` inside and past warmup and ``adamw.update`` on
    float32 and float64 trees (nested dicts, several leaves, nonzero m and
    v), clipping on and off, steps inside and past warmup: params, m, v
    within rtol 1e-6 (and 1e-6 x the leaf's largest entry, for entries
    where b1 m and (1 - b1) g nearly cancel) and the step equal. Both
    packages compute in float32 whatever the leaf's dtype, in the same
    order; XLA's and torch's ``cos``, ``pow`` and the global norm's sums
    may round apart by an ulp.
  * the counterparts of tests/test_distribution.py's optimizer and
    compression tests (the quadratic, clipping, the error-feedback
    invariant, the quantization bound);
  * ``quantize`` and ``compress_tree``: the reference's int8 payloads and
    scales exactly (ties at half a step round to even in both), residuals
    within 1 ulp;
  * ``dp_allreduce_compressed`` on W = 2 spawned gloo ranks, against the
    reference's formula (int32 sum of q, max of the scales, / W) applied
    to each rank's ``quantize``.

The spawned ranks import this module, so it imports the reference (and
with it jax) only inside the tests.
"""
import os
import tempfile

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.optim import adamw, compress

SPAWN_TIMEOUT_S = 120


def _tree(rng, dtype):
    """A nested dict of numpy leaves (the LM trees' shape: stacked blocks
    and top-level leaves)."""
    return {"blocks": {"w1": rng.standard_normal((2, 5, 7)),
                       "ln": 1.0 + 0.1 * rng.standard_normal((2, 5))},
            "embed": rng.standard_normal((11, 5)),
            "final_ln": rng.standard_normal((5,))}


def _np_map(fn, t):
    return ({k: _np_map(fn, v) for k, v in t.items()} if isinstance(t, dict)
            else fn(t))


def _to_t(t):
    return _np_map(torch.from_numpy, t)


def _to_j(t):
    import jax.numpy as jnp
    return _np_map(jnp.asarray, t)


def _pairs(a, b, prefix=()):
    if isinstance(a, dict):
        for k in sorted(a):
            yield from _pairs(a[k], b[k], prefix + (k,))
    else:
        yield prefix, a, b


def _flat(t, prefix=()):
    """{path: leaf} of a nested dict (a leaf may be a (q, scale) pair)."""
    if not isinstance(t, dict):
        return {prefix: t}
    out = {}
    for k in sorted(t):
        out.update(_flat(t[k], prefix + (k,)))
    return out


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# AdamW against the reference
# ---------------------------------------------------------------------------

CFGS = {"warm10": dict(lr=1e-3, warmup_steps=10, total_steps=50),
        "no_warmup": dict(lr=3e-3, warmup_steps=0, total_steps=20,
                          min_lr_frac=0.2),
        "short": dict(lr=1e-2, warmup_steps=3, total_steps=4)}


@pytest.mark.parametrize("name", sorted(CFGS))
def test_schedule_matches_reference(name):
    """lr(step) for every step from 0 to past ``total_steps`` (warmup, the
    cosine, the floor): a 0-dim float32 tensor, within rtol 1e-6."""
    import jax.numpy as jnp
    from repro.optim import adamw as JA
    kw = CFGS[name]
    jc, tc = JA.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    for s in range(kw["total_steps"] + 6):
        got = adamw.schedule(tc, torch.tensor(s, dtype=torch.int32))
        want = float(JA.schedule(jc, jnp.asarray(s, jnp.int32)))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("clip", [0.5, 1e6], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("step0", [0, 4, 30], ids=["first", "warmup",
                                                   "past_warmup"])
def test_update_matches_reference(dtype, clip, step0):
    """One ``update`` from a state at ``step0`` with nonzero m and v (the
    first step from zeros too): params, m and v within rtol 1e-6 (atol 1e-6
    x the leaf's largest entry) of the reference's, in the leaves' dtype;
    the step advanced by one."""
    import jax.numpy as jnp
    from repro.optim import adamw as JA
    rng = np.random.default_rng(7 + step0)
    p = _np_map(lambda a: a.astype(dtype), _tree(rng, dtype))
    g = _np_map(lambda a: (0.3 * a).astype(dtype), _tree(rng, dtype))
    if step0:
        m = _np_map(lambda a: (0.05 * a).astype(dtype), _tree(rng, dtype))
        v = _np_map(lambda a: (0.01 * a * a).astype(dtype),
                    _tree(rng, dtype))
    else:
        m = v = _np_map(np.zeros_like, p)
    kw = dict(lr=1e-3, warmup_steps=10, total_steps=50, clip_norm=clip)
    jp, js = JA.update(_to_j(g), JA.AdamWState(
        step=jnp.asarray(step0, jnp.int32), m=_to_j(m), v=_to_j(v)),
        _to_j(p), JA.AdamWConfig(**kw))
    state = adamw.AdamWState(step=torch.tensor(step0, dtype=torch.int32),
                             m=_to_t(m), v=_to_t(v))
    tp, ts = adamw.update(_to_t(g), state, _to_t(p), adamw.AdamWConfig(**kw))
    assert ts.step.dtype == torch.int32 and int(ts.step) == step0 + 1
    assert int(js.step) == int(ts.step)
    for got, want in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
        for path, a, b in _pairs(got, want):
            assert a.dtype == getattr(torch, dtype), path
            b = _np(b)
            np.testing.assert_allclose(_np(a), b, rtol=1e-6,
                                       atol=1e-6 * np.abs(b).max(),
                                       err_msg=str(path))
    # out of place: the inputs are untouched
    for path, a, b in _pairs(state.m, m):
        assert np.array_equal(_np(a), b), path


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_global_norm_matches_reference(dtype):
    from repro.optim import adamw as JA
    t = _np_map(lambda a: a.astype(dtype), _tree(np.random.default_rng(3),
                                                 dtype))
    got = adamw.global_norm(_to_t(t))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(JA.global_norm(_to_j(t))),
                               rtol=1e-6, atol=0)


def test_init_zeros_on_the_leaves_device_and_dtype():
    p = _to_t(_np_map(lambda a: a.astype(np.float32),
                      _tree(np.random.default_rng(0), "float32")))
    st = adamw.init(p)
    assert st.step.dtype == torch.int32 and int(st.step) == 0
    for tree in (st.m, st.v):
        for path, a, b in _pairs(tree, p):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert not bool(a.any()), path


# ---------------------------------------------------------------------------
# the reference's optimizer tests (tests/test_distribution.py), ported
# ---------------------------------------------------------------------------

def test_adamw_descends_quadratic():
    cfg = adamw.AdamWConfig(lr=0.1, warmup_steps=1, total_steps=200,
                            weight_decay=0.0, clip_norm=100.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = adamw.init(params)
    for _ in range(150):
        grads = {"w": 2 * params["w"]}          # d/dw ||w||^2
        params, state = adamw.update(grads, state, params, cfg)
    assert float(params["w"].abs().max()) < 0.15


def test_adamw_clipping():
    cfg = adamw.AdamWConfig(clip_norm=1.0, lr=1.0, warmup_steps=0,
                            total_steps=10, weight_decay=0.0)
    g = {"w": torch.full((4,), 100.0)}
    p = {"w": torch.zeros(4)}
    p2, _ = adamw.update(g, adamw.init(p), p, cfg)
    # clipped step magnitude bounded by lr * 1/sqrt(vhat) ~ lr
    assert float(p2["w"].abs().max()) < 2.0


def test_error_feedback_invariant():
    """sum(applied) + residual == sum(true gradients)."""
    rng = np.random.default_rng(0)
    params = {"a": torch.zeros(64), "b": torch.zeros((8, 8))}
    ef = compress.init(params)
    applied = {k: np.zeros(v.shape) for k, v in params.items()}
    true = {k: np.zeros(v.shape) for k, v in params.items()}
    for _ in range(20):
        g = {"a": torch.from_numpy(rng.normal(size=64)),
             "b": torch.from_numpy(rng.normal(size=(8, 8)))}
        q, ef = compress.compress_tree(g, ef)
        deq = compress.decompress_tree(q)
        for k in params:
            applied[k] += deq[k].numpy()
            true[k] += g[k].numpy()
    for k in params:
        assert ef.residual[k].dtype == torch.float32
        np.testing.assert_allclose(applied[k] + ef.residual[k].numpy(),
                                   true[k], rtol=1e-5, atol=1e-5)


def test_quantize_roundtrip_bounds():
    x = torch.from_numpy(np.random.default_rng(1).normal(size=1000) * 5)
    q, s = compress.quantize(x)
    err = (compress.dequantize(q, s) - x).abs()
    assert q.dtype == torch.int8
    assert float(err.max()) <= float(s) * 0.5 + 1e-9


# ---------------------------------------------------------------------------
# compression against the reference
# ---------------------------------------------------------------------------

def _quant_inputs():
    rng = np.random.default_rng(11)
    ties = np.arange(-127, 128, dtype=np.float64) + 0.5   # half steps
    ties[-1] = 127.0                                       # amax = 127
    return {"normal_f32": (rng.normal(size=500) * 3).astype(np.float32),
            "normal_f64": rng.normal(size=(20, 30)),
            "ties_f32": ties.astype(np.float32),
            "ties_f64": ties,
            "zeros": np.zeros(16, np.float32),
            "one_spike": np.r_[np.full(9, 1e-3), 40.0].astype(np.float32)}


@pytest.mark.parametrize("name", sorted(_quant_inputs()))
def test_quantize_matches_reference(name):
    """int8 payload and scale exactly the reference's (round half to
    even; the 1e-30 floor on an all-zero tensor); dequantize in the
    reference's dtype and value."""
    import jax.numpy as jnp
    from repro.optim import compress as JC
    x = _quant_inputs()[name]
    jq, js = JC.quantize(jnp.asarray(x))
    tq, ts = compress.quantize(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.from_numpy(x).dtype
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert ts.item() == np.asarray(js).item()
    jd, td = JC.dequantize(jq, js), compress.dequantize(tq, ts)
    assert td.numpy().dtype == np.asarray(jd).dtype
    assert np.array_equal(td.numpy(), np.asarray(jd))


def test_compress_tree_matches_reference():
    """Three rounds of ``compress_tree`` with the residual carried: q and
    scales exactly the reference's, residuals within 1 ulp; the
    decompressed tree equal."""
    import jax.numpy as jnp
    from repro.optim import compress as JC
    rng = np.random.default_rng(5)
    p = _tree(rng, "float32")
    jef = JC.init(_to_j(_np_map(lambda a: a.astype(np.float32), p)))
    tef = compress.init(_to_t(_np_map(lambda a: a.astype(np.float32), p)))
    for r in range(3):
        g = _np_map(lambda a: (a * 10 ** (r - 1)).astype(np.float32),
                    _tree(rng, "float32"))
        jq, jef = JC.compress_tree(_np_map(jnp.asarray, g), jef)
        tq, tef = compress.compress_tree(_to_t(g), tef)
        for path, (q, s), (q_ref, s_ref) in _pairs(tq, jq):
            assert q.dtype == torch.int8, path
            assert np.array_equal(q.numpy(), np.asarray(q_ref)), path
            assert s.item() == np.asarray(s_ref).item(), path
        for path, e, e_ref in _pairs(tef.residual, jef.residual):
            e, e_ref = e.numpy(), np.asarray(e_ref)
            assert e.dtype == np.float32
            assert np.all(np.abs(e - e_ref) <= np.spacing(np.abs(e_ref))), \
                path
        for path, d, d_ref in _pairs(compress.decompress_tree(tq),
                                     JC.decompress_tree(jq)):
            assert np.array_equal(d.numpy(), np.asarray(d_ref)), path


# ---------------------------------------------------------------------------
# the compressed all-reduce on spawned gloo ranks
# ---------------------------------------------------------------------------

WORLD = 2
ROUNDS = 2


def _rank_grads(rank, r):
    rng = np.random.default_rng((rank, r))
    return _np_map(lambda a: (a * (rank + 1)).astype(np.float32),
                   _tree(rng, "float32"))


def _rank_main(rank, store, out_dir):
    """One rank: ROUNDS compressed all-reduces of its own gradients with
    the residual carried; writes the means, residuals and the collective
    counts."""
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.distributed import comm
    from repro_torch.launch.mesh import init_group, make_host_mesh
    init_group(WORLD, rank, store, timeout_s=60)
    try:
        fg = comm.feature_group(make_host_mesh())
        ef = compress.init(_to_t(_rank_grads(rank, 0)))
        outs = []
        for r in range(ROUNDS):
            comm.reset_calls()
            mean, ef = compress.dp_allreduce_compressed(
                _to_t(_rank_grads(rank, r)), ef, fg)
            outs.append((mean, ef.residual, dict(comm.CALLS)))
    finally:
        dist.destroy_process_group()
    torch.save(outs, os.path.join(out_dir, f"rank{rank}.pt"))


def test_dp_allreduce_compressed_spawned():
    """W = 2 gloo ranks, two rounds: every rank's mean is the reference's
    formula on each rank's ``quantize`` of g + e (an int32 sum of the
    payloads times the largest scale, over W), bit for bit, and its
    residual is its own ``compress_tree`` residual; one SUM and one MAX
    all-reduce a leaf."""
    import jax.numpy as jnp
    from repro.optim import compress as JC
    d = tempfile.mkdtemp(prefix="compress-w2-")
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, d, d))
             for r in range(WORLD)]
    for pr in procs:
        pr.start()
    for pr in procs:
        pr.join(SPAWN_TIMEOUT_S)
        if pr.is_alive():
            pr.kill()
            pr.join()
    assert [pr.exitcode for pr in procs] == [0] * WORLD
    outs = [torch.load(os.path.join(d, f"rank{r}.pt"))
            for r in range(WORLD)]
    # the reference's arithmetic on each rank's payload
    res = [JC.init(_to_j(_rank_grads(r, 0))).residual for r in range(WORLD)]
    n_leaves = len(tree.leaves(_rank_grads(0, 0)))
    for r in range(ROUNDS):
        qs = []
        for rank in range(WORLD):
            t = _np_map(jnp.asarray, _rank_grads(rank, r))
            q, ef = JC.compress_tree(t, JC.EFState(residual=res[rank]))
            res[rank] = ef.residual
            qs.append(q)
        fq = [_flat(q) for q in qs]
        for rank in range(WORLD):
            mean, resid, calls = outs[rank][r]
            assert calls == {"gather": 0, "sum": n_leaves, "max": n_leaves}
            for path, got in _flat(mean).items():
                acc = sum(np.asarray(f[path][0]).astype(np.int32)
                          for f in fq)
                s_max = max(np.asarray(f[path][1]) for f in fq)
                want = (jnp.asarray(acc).astype(jnp.float32) * s_max
                        / jnp.float32(WORLD))
                assert got.dtype == torch.float32
                assert np.array_equal(got.numpy(), np.asarray(want)), path
            for path, e, e_ref in _pairs(resid, res[rank]):
                e, e_ref = e.numpy(), np.asarray(e_ref)
                assert np.all(np.abs(e - e_ref)
                              <= np.spacing(np.abs(e_ref))), path
