"""Kernel K5 ``cm_epochs`` on the CPU: the wrapper given CPU tensors runs
its plain version, held against the reference's interpret-mode kernel
``repro.kernels.ops.cm_epochs`` (``cm_epochs_pallas``) and its oracle
``cm_epochs_ref`` at ``tests/test_kernels.py``'s tolerances (atol/rtol
1e-5 on beta, 1e-4 on the residual), with the reference's contract:
float32 in and out, an int epoch count, masked coordinates pinned at 0,
an objective that does not rise, a block past the budget refused."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import cm_epochs as j_cm_epochs
from repro.kernels.ops import cm_epochs_ref as j_cm_epochs_ref
from repro_torch.testing import given, settings, st
from repro_torch.kernels import ops
from test_torch_saif import _one_torch_thread  # noqa: F401


def _t(a):
    return torch.from_numpy(np.array(a))


@given(seed=st.integers(0, 10_000), n=st.integers(4, 200),
       k=st.integers(1, 40), n_epochs=st.integers(1, 4))
@settings(max_examples=25, deadline=None)
def test_cm_epochs_twin_matches_reference(seed, n, k, n_epochs):
    r = np.random.default_rng(seed)
    A = r.normal(size=(n, k)).astype(np.float32)
    y = r.normal(size=n).astype(np.float32)
    beta = (r.normal(size=k) * 0.1).astype(np.float32)
    csq = (A * A).sum(axis=0)
    mask = r.random(k) < 0.85
    lam = float(r.uniform(0.01, 2.0))
    ops.reset_launch_counts()
    b, res = ops.cm_epochs(_t(A), _t(y), _t(beta), _t(csq), _t(mask), lam,
                           n_epochs=n_epochs)
    assert ops.launch_counts()["cm_epochs"] == 0
    assert b.dtype == res.dtype == torch.float32
    bj, rj = j_cm_epochs(jnp.asarray(A), jnp.asarray(y), jnp.asarray(beta),
                         jnp.asarray(csq), jnp.asarray(mask), lam,
                         n_epochs=n_epochs)
    bo, ro = j_cm_epochs_ref(jnp.asarray(A), jnp.asarray(y),
                             jnp.asarray(beta), jnp.asarray(csq),
                             jnp.asarray(mask), jnp.float32(lam),
                             n_epochs=n_epochs)
    for bb, rr in ((bj, rj), (bo, ro)):
        np.testing.assert_allclose(b.numpy(), np.asarray(bb), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(res.numpy(), np.asarray(rr), atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("case", ["no_epochs", "one_slot", "dead_slot"])
def test_cm_epochs_edge_cases(case):
    """n_epochs = 0 (beta returned as it came, r = y - A beta), k = 1 (every
    step the same slot), and a dead slot with beta != 0 (zeroed on its
    first step, its column taken out of r): the twin against the
    reference's interpret-mode kernel and its oracle."""
    r = np.random.default_rng(7)
    n, k, n_epochs = 48, 6, 3
    if case == "no_epochs":
        n_epochs = 0
    if case == "one_slot":
        k = 1
    A = r.normal(size=(n, k)).astype(np.float32)
    y = r.normal(size=n).astype(np.float32)
    beta = (r.normal(size=k) * 0.5).astype(np.float32)
    csq = (A * A).sum(axis=0)
    mask = np.ones(k, bool)
    if case == "dead_slot":
        mask[2] = False
        beta[2] = 0.75
    lam = 0.4
    b, res = ops.cm_epochs(_t(A), _t(y), _t(beta), _t(csq), _t(mask), lam,
                           n_epochs=n_epochs)
    assert b.shape == (k,) and res.shape == (n,)
    if case == "no_epochs":
        assert torch.equal(b, _t(beta))
    if case == "dead_slot":
        assert b[2] == 0
    bj, rj = j_cm_epochs(jnp.asarray(A), jnp.asarray(y), jnp.asarray(beta),
                         jnp.asarray(csq), jnp.asarray(mask), lam,
                         n_epochs=n_epochs)
    bo, ro = j_cm_epochs_ref(jnp.asarray(A), jnp.asarray(y),
                             jnp.asarray(beta), jnp.asarray(csq),
                             jnp.asarray(mask), jnp.float32(lam),
                             n_epochs=n_epochs)
    for bb, rr in ((bj, rj), (bo, ro)):
        np.testing.assert_allclose(b.numpy(), np.asarray(bb), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(res.numpy(), np.asarray(rr), atol=1e-4,
                                   rtol=1e-4)


def test_cm_epochs_casts_to_float32_like_the_reference():
    """float64 inputs are computed in float32, as the TPU kernel does."""
    r = np.random.default_rng(3)
    A, y = r.normal(size=(50, 9)), r.normal(size=50)
    beta, csq, mask = np.zeros(9), (A * A).sum(axis=0), np.ones(9, bool)
    b64, r64 = ops.cm_epochs(_t(A), _t(y), _t(beta), _t(csq), _t(mask), 0.7,
                             n_epochs=np.int64(3))
    b32, r32 = ops.cm_epochs(_t(A).float(), _t(y).float(), _t(beta).float(),
                             _t(csq).float(), _t(mask), 0.7, n_epochs=3)
    assert b64.dtype == torch.float32
    assert torch.equal(b64, b32) and torch.equal(r64, r32)
    bj, rj = j_cm_epochs(jnp.asarray(A), jnp.asarray(y), jnp.asarray(beta),
                         jnp.asarray(csq), jnp.asarray(mask), 0.7,
                         n_epochs=3)
    np.testing.assert_allclose(b64.numpy(), np.asarray(bj), atol=1e-5,
                               rtol=1e-5)


def test_cm_epochs_masked_coords_stay_zero():
    r = np.random.default_rng(1)
    n, k = 64, 12
    A = _t(r.normal(size=(n, k)).astype(np.float32))
    y = _t(r.normal(size=n).astype(np.float32))
    mask = torch.zeros(k, dtype=torch.bool)
    mask[:5] = True
    beta = torch.full((k,), 0.3)
    b, _ = ops.cm_epochs(A, y, beta, (A * A).sum(0), mask, 0.1, n_epochs=5)
    assert (b[5:] == 0).all() and (b[:5] != 0).any()


def test_cm_epochs_decreases_objective():
    r = np.random.default_rng(2)
    n, k, lam = 100, 20, 0.3
    A = _t(r.normal(size=(n, k)).astype(np.float32))
    y = _t(r.normal(size=n).astype(np.float32))
    beta = _t(r.normal(size=k).astype(np.float32))
    csq, mask = (A * A).sum(0), torch.ones(k, dtype=torch.bool)

    def obj(b):
        res = y - A @ b
        return float(0.5 * res @ res + lam * b.abs().sum())

    prev = obj(beta)
    for _ in range(4):
        beta, res = ops.cm_epochs(A, y, beta, csq, mask, lam, n_epochs=1)
        torch.testing.assert_close(res, y - A @ beta, atol=1e-4, rtol=1e-4)
        cur = obj(beta)
        assert cur <= prev + 1e-4
        prev = cur


def test_cm_epochs_refuses_a_block_past_the_budget():
    from repro_torch.kernels.cm.cm import (CM_SMEM_BUDGET_BYTES,
                                           cm_epochs_smem_bytes,
                                           cm_epochs_smem_ok)
    assert cm_epochs_smem_ok(1000, 512)
    n = CM_SMEM_BUDGET_BYTES // 4
    assert cm_epochs_smem_bytes(n, 8) > CM_SMEM_BUDGET_BYTES
    A = torch.zeros(n, 8)
    with pytest.raises(ValueError, match="budget"):
        ops.cm_epochs(A, torch.zeros(n), torch.zeros(8), torch.ones(8),
                      torch.ones(8, dtype=torch.bool), 0.1)


def test_testing_fallback_draws_the_same_examples(monkeypatch):
    """With ``hypothesis`` hidden, ``repro_torch.testing``'s seeded
    fallback runs a test on the same examples every time (a fresh copy of
    the module, loaded with the import refused)."""
    import importlib.util
    import sys

    import repro_torch.testing as tt
    for name in ("hypothesis", "hypothesis.strategies"):
        monkeypatch.setitem(sys.modules, name, None)
    spec = importlib.util.spec_from_file_location("_testing_fallback",
                                                  tt.__file__)
    fb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fb)
    assert not fb.HAVE_HYPOTHESIS
    seen = []

    @fb.given(a=fb.st.integers(0, 1000), b=fb.st.floats(0.0, 1.0),
              c=fb.st.sampled_from("xyz"), d=fb.st.booleans())
    @fb.settings(max_examples=5, deadline=None)
    def drawn(a, b, c, d):
        seen.append((a, b, c, d))

    drawn()
    first, seen[:] = list(seen), []
    drawn()
    assert seen == first and len(first) == 5
    assert len(set(first)) > 1
