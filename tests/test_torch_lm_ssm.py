"""The port's recurrent blocks (``repro_torch.models.ssm``) on the CPU, held
against ``repro.models.ssm`` on the same numpy inputs from a seed, in
float32 (the reference's test dtype) and float64 for the scans.

  * ``prefix_scan`` (the doubling scan that stands for
    ``lax.associative_scan``) against a sequential loop in float64 (1e-12
    relative) and against ``associative_scan`` itself in float32 (1e-6
    relative: both are float32 trees of the same combine, in other
    orders), lengths 1-17 and 128;
  * ``_ssm_chunk_scan`` against the reference's at chunk 8 and 16;
    ``mamba_block`` with S % chunk != 0 (the padded scan) and S < chunk;
  * ``mamba_decode``, ``mlstm_decode``, ``slstm_decode`` step by step
    against the reference's (outputs and states), and ``mlstm_block`` /
    ``slstm_block`` against the reference's; ``mlstm_block`` raises on
    S % chunk like the reference.

Tolerances: 1e-5 x (max|reference| + 1) in float32 (sums in other orders)
and 1e-12 in float64, for the blocks and steps; the mLSTM step keeps its
float32 gates in float64, so its float64 case keeps the float32 bound.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as JS
from repro_torch.models import ssm as TS
from test_torch_lm import as_np, cfgs, max_err, np_params
from test_torch_saif import _one_torch_thread  # noqa: F401

TOL = {"float32": 1e-5, "float64": 1e-12}


def _jit(fn, *static):
    """The reference function jitted with its config (or chunk) static:
    eager JAX compiles every op of a scan on its own."""
    return jax.jit(fn, static_argnums=static)


def _rel(a, b):
    return max_err(a, b) / (float(np.max(np.abs(as_np(b)))) + 1.0)


def _x(shape, seed, dtype="float32", scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(dtype)


def _block0(arch, name="blocks", dtype="float32", **kw):
    jc, tc = cfgs(arch, dtype, **kw)
    tree = np_params(jc)
    bp = {k: v[0] for k, v in tree[name].items()}
    return jc, tc, {k: jnp.asarray(v) for k, v in bp.items()}, \
        {k: torch.from_numpy(v) for k, v in bp.items()}


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 13, 17, 128])
def test_prefix_scan(n):
    a = np.exp(-np.abs(_x((3, n, 4), 1, "float64")))
    b = _x((3, n, 4), 2, "float64")
    pa, pb = TS.prefix_scan(torch.from_numpy(a), torch.from_numpy(b), dim=1)
    h, prod = np.zeros((3, 4)), np.ones((3, 4))
    for t in range(n):
        h = a[:, t] * h + b[:, t]
        prod = prod * a[:, t]
        assert np.allclose(pb[:, t].numpy(), h, rtol=1e-12, atol=1e-12)
        assert np.allclose(pa[:, t].numpy(), prod, rtol=1e-12, atol=1e-15)

    def combine(x, y):
        return x[0] * y[0], y[0] * x[1] + y[1]
    a32, b32 = a.astype(np.float32), b.astype(np.float32)
    ja, jb = jax.jit(lambda a, b: jax.lax.associative_scan(
        combine, (a, b), axis=1))(jnp.asarray(a32), jnp.asarray(b32))
    ta, tb = TS.prefix_scan(torch.from_numpy(a32), torch.from_numpy(b32), 1)
    assert _rel(ta, ja) <= 1e-6 and _rel(tb, jb) <= 1e-6


@pytest.mark.parametrize("dtype,chunk", [("float32", 8), ("float32", 16),
                                         ("float64", 8)])
def test_ssm_chunk_scan(dtype, chunk):
    B, S, Di, N = 2, 32, 12, 4
    u, dt = _x((B, S, Di), 3, dtype), np.abs(_x((B, S, Di), 4, dtype, 0.5))
    Bm, Cm = _x((B, S, N), 5, dtype), _x((B, S, N), 6, dtype)
    A = -np.exp(_x((Di, N), 7, dtype, 0.3))
    got = TS._ssm_chunk_scan(*map(torch.from_numpy, (u, dt, Bm, Cm, A)),
                             chunk)
    want = _jit(JS._ssm_chunk_scan, 5)(
        *map(jnp.asarray, (u, dt, Bm, Cm, A)), chunk)
    assert got.dtype == getattr(torch, dtype)
    assert _rel(got, want) <= TOL[dtype]


@pytest.mark.parametrize("S", [21, 16, 5])
def test_mamba_block(S):
    """hymba's SMOKE chunk is 16: S = 21 pads the scan to 32, S = 5 runs one
    short chunk."""
    jc, tc, jp, tp = _block0("hymba_1_5b")
    x = _x((2, S, tc.d_model), 8)
    got = TS.mamba_block(torch.from_numpy(x), tp, tc)
    want = _jit(JS.mamba_block, 2)(jnp.asarray(x), jp, jc)
    assert got.shape == (2, S, tc.d_model)
    assert _rel(got, want) <= TOL["float32"]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_mamba_decode(dtype):
    jc, tc, jp, tp = _block0("hymba_1_5b", dtype=dtype)
    js = JS.mamba_init_state(jc, 2, jnp.dtype(dtype))
    ts = TS.mamba_init_state(tc, 2, getattr(torch, dtype))
    assert ts.conv.shape == (2, 2 * tc.d_model, 3)
    xs = _x((6, 2, 1, tc.d_model), 9, dtype)
    step = _jit(JS.mamba_decode, 2)
    for t in range(6):
        jy, js = step(jnp.asarray(xs[t]), jp, jc, js)
        ty, ts = TS.mamba_decode(torch.from_numpy(xs[t]), tp, tc, ts)
        assert _rel(ty, jy) <= TOL[dtype]
        assert _rel(ts.h, js.h) <= TOL[dtype]
        assert _rel(ts.conv, js.conv) <= TOL[dtype]


def test_mlstm_block_and_its_chunk_rule():
    jc, tc, jp, tp = _block0("xlstm_350m", "blocks_m")
    x = _x((2, 32, tc.d_model), 10)
    got = TS.mlstm_block(torch.from_numpy(x), tp, tc)
    block = _jit(JS.mlstm_block, 2)
    want = block(jnp.asarray(x), jp, jc)
    assert _rel(got, want) <= TOL["float32"]
    short = TS.mlstm_block(torch.from_numpy(x[:, :9]), tp, tc)   # Q = S
    assert _rel(short, block(jnp.asarray(x[:, :9]), jp, jc)) \
        <= TOL["float32"]
    with pytest.raises(ValueError, match="not divisible by chunk 16"):
        TS.mlstm_block(torch.from_numpy(x[:, :20]), tp, tc)
    with pytest.raises(ValueError, match="not divisible by chunk 16"):
        block(jnp.asarray(x[:, :20]), jp, jc)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_mlstm_decode(dtype):
    jc, tc, jp, tp = _block0("xlstm_350m", "blocks_m", dtype=dtype)
    js = JS.mlstm_init_state(jc, 2, jnp.dtype(dtype))
    ts = TS.mlstm_init_state(tc, 2, getattr(torch, dtype))
    xs = _x((6, 2, 1, tc.d_model), 11, dtype)
    step = _jit(JS.mlstm_decode, 2)
    for t in range(6):
        jy, js = step(jnp.asarray(xs[t]), jp, jc, js)
        ty, ts = TS.mlstm_decode(torch.from_numpy(xs[t]), tp, tc, ts)
        assert _rel(ty, jy) <= TOL["float32"]
        assert _rel(ts.C, js.C) <= TOL["float32"]
        assert _rel(ts.n, js.n) <= TOL["float32"]


@pytest.mark.parametrize("S", [32, 7])
def test_slstm_block(S):
    jc, tc, jp, tp = _block0("xlstm_350m", "blocks_s")
    x = _x((2, S, tc.d_model), 12)
    got = TS.slstm_block(torch.from_numpy(x), tp, tc)
    want = _jit(JS.slstm_block, 2)(jnp.asarray(x), jp, jc)
    assert _rel(got, want) <= TOL["float32"]


def test_slstm_decode():
    jc, tc, jp, tp = _block0("xlstm_350m", "blocks_s")
    js = JS.slstm_init_state(jc, 2, jnp.float32)
    ts = TS.slstm_init_state(tc, 2)
    assert ts.c.dtype == torch.float32
    xs = _x((6, 2, 1, tc.d_model), 13)
    step = _jit(JS.slstm_decode, 2)
    for t in range(6):
        jy, js = step(jnp.asarray(xs[t]), jp, jc, js)
        ty, ts = TS.slstm_decode(torch.from_numpy(xs[t]), tp, tc, ts)
        assert _rel(ty, jy) <= TOL["float32"]
        assert _rel(ts.c, js.c) <= TOL["float32"]
        assert _rel(ts.n, js.n) <= TOL["float32"]
