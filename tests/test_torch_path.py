"""repro_torch's lambda-path engine against repro on the same float64 inputs:
``fused_path`` at bench_fused.py's CI shape (n = 60, p = 200, 8 lambdas),
``saif_path`` and ``saif_path_naive`` on make_regression (n = 60, p = 300),
the warm entry points (``run_path`` from a carried warm state and
``seq_warm_entry``) and ``lambda_grid``. Pass criteria per grid point: the
reference's support and ``n_active``, gap <= eps."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch as rt
from conftest import make_regression
from repro.core import path as jpath
from repro.core.duality import lambda_max as j_lambda_max
from repro.core.losses import get_loss as j_get_loss
from repro_torch.convert import path_state_from_numpy, warm_state_from_numpy
from repro_torch.core import path as tpath
from test_torch_saif import _one_torch_thread  # noqa: F401


def _support(beta, tol=1e-8):
    return set(np.where(np.abs(np.asarray(beta)) > tol)[0].tolist())


def _check_path(mine, ref, eps):
    assert np.array_equal(mine.lams, np.asarray(ref.lams))
    for r, rr in zip(mine.results, ref.results):
        assert _support(r.beta) == _support(rr.beta)
        assert r.n_active == int(rr.n_active)
        assert float(r.gap) <= eps
        np.testing.assert_allclose(r.beta.numpy(), np.asarray(rr.beta),
                                   atol=1e-6)


def test_fused_path_matches_reference():
    """bench_fused.py's chain problem at its CI shape, its grid (0.7 to
    0.02 lambda_max, 8 points) and eps."""
    rng = np.random.default_rng(0)
    n, p = 60, 200
    X = rng.normal(size=(n, p))
    beta = np.zeros(p)
    beta[:p // 8] = 2.0
    beta[p // 8:p // 4] = -1.0
    y = X @ beta + 0.1 * rng.normal(size=n)
    parent = np.arange(p) - 1
    lams = np.geomspace(0.7, 0.02, 8) * J.fused_lambda_max(X, y, parent)
    eps = 1e-8
    ref = J.fused_path(X, y, parent, lams, J.SaifConfig(eps=eps))
    mine = rt.fused_path(X, y, parent, lams, rt.SaifConfig(eps=eps),
                         device="cpu")
    _check_path(mine.path, ref.path, eps)
    assert mine.path.n_compilations is None
    for b, bb in zip(mine.betas, ref.betas):
        np.testing.assert_allclose(b.numpy(), np.asarray(bb), atol=1e-5)


@pytest.fixture(scope="module")
def reg_problem():
    X, y, _ = make_regression(np.random.default_rng(1), n=60, p=300)
    lm = float(j_lambda_max(j_get_loss("least_squares"), X, y))
    return X, y, lm


@pytest.mark.parametrize("inner,rule", [("torch", "saif"),
                                        ("gram", "saif"),
                                        ("cuda", "saif"),
                                        ("gram", "hybrid"),
                                        ("torch", "gap_safe")])
def test_saif_path_matches_reference(reg_problem, inner, rule):
    X, y, lm = reg_problem
    lams = J.lambda_grid(lm, 6, 0.05)
    j_inner = {"torch": "jnp", "cuda": "pallas"}.get(inner, inner)
    ref = J.saif_path(X, y, lams, J.SaifConfig(inner_backend=j_inner,
                                               screen_rule=rule))
    mine = rt.saif_path(X, y, lams,
                        rt.SaifConfig(inner_backend=inner, screen_rule=rule),
                        device="cpu")
    _check_path(mine, ref, 1e-6)


def test_saif_path_naive_matches_reference(reg_problem):
    X, y, lm = reg_problem
    lams = J.lambda_grid(lm, 4, 0.1)
    ref = jpath.saif_path_naive(X, y, lams, J.SaifConfig())
    mine = rt.saif_path_naive(X, y, lams, rt.SaifConfig(), device="cpu")
    _check_path(mine, ref, 1e-6)


def test_lambda_grid():
    assert np.array_equal(rt.lambda_grid(3.0, 7, 0.01),
                          np.asarray(J.lambda_grid(3.0, 7, 0.01)))


def _ref_prep(X, y, cfg):
    prep = J.prepare_path(jnp.asarray(X), jnp.asarray(y), cfg)
    return prep, path_state_from_numpy(
        X, y, np.asarray(prep.c0), np.asarray(prep.col_norm), prep.lam_max,
        prep.c0_max, prep.c0_median, prep.b0, device="cpu")


@pytest.mark.parametrize("fused", [False, True])
def test_run_path_from_carried_warm_state(reg_problem, fused):
    """A reference solve's final slots, carried across as numpy, enter both
    engines' next grid identically; fused problems keep b pinned."""
    X, y, _ = reg_problem
    unpen = None
    if fused:
        # test_fused_device.py's chain problem: on make_regression's
        # uniform design the transformed columns are so collinear that
        # both packages crawl to max_outer uncertified
        rng = np.random.default_rng(11)
        X = rng.normal(size=(50, 60))
        y = X @ np.repeat([2.0, -1.0, 0.0], [10, 10, 40]) \
            + 0.1 * rng.normal(size=50)
        d = J.prepare_fused(X, np.arange(60) - 1, backend="scan")
        X, unpen = np.asarray(d.Xt), d.unpen_idx
    cfg_j = J.SaifConfig(inner_backend="jnp", unpen_idx=unpen)
    cfg_t = rt.SaifConfig(inner_backend="torch", unpen_idx=unpen)
    prep_j, prep_t = _ref_prep(X, y, cfg_j)
    lam0, lams = 0.5 * prep_j.lam_max, [0.3 * prep_j.lam_max,
                                        0.2 * prep_j.lam_max]
    first = J.solve_scalar(prep_j, lam0, cfg_j)
    k0 = first.active_idx.shape[0]
    warm_j = jpath._warm_state(first.active_idx, first.active_mask,
                               first.beta, first.inner,
                               unpen_idx=-1 if unpen is None else unpen)
    warm_t = warm_state_from_numpy(
        np.asarray(first.active_idx), np.asarray(first.active_mask),
        np.asarray(first.beta), unpen, device="cpu")
    assert np.array_equal(warm_t[2].numpy(), np.asarray(warm_j[2]))
    if fused:
        assert bool(warm_t[2][warm_t[0] == unpen].all())
    ref, _, k_ref = jpath.run_path(prep_j, lams, cfg_j, warm0=warm_j,
                                   k_max0=k0)
    mine, warm_out, k = tpath.run_path(prep_t, lams, cfg_t, warm0=warm_t,
                                       k_max0=k0)
    assert k == k_ref
    _check_path(mine, ref, 1e-6)
    assert warm_out[0].shape[0] == k


def test_seq_warm_entry_matches_reference(reg_problem):
    X, y, _ = reg_problem
    cfg_j, cfg_t = J.SaifConfig(inner_backend="jnp"), \
        rt.SaifConfig(inner_backend="torch")
    prep_j, prep_t = _ref_prep(X, y, cfg_j)
    lam0, lam = 0.4 * prep_j.lam_max, 0.3 * prep_j.lam_max
    first = J.solve_scalar(prep_j, lam0, cfg_j)
    warm_j = jpath._warm_state(first.active_idx, first.active_mask,
                               first.beta, first.inner)
    warm_t = warm_state_from_numpy(
        np.asarray(first.active_idx), np.asarray(first.active_mask),
        np.asarray(first.beta), device="cpu")
    k = 2 * first.active_idx.shape[0]
    (idx_j, vals_j, mask_j, _), k_j = jpath.seq_warm_entry(
        prep_j, warm_j, k, lam0, lam, cfg_j)
    (idx_t, vals_t, mask_t, _), k_t = tpath.seq_warm_entry(
        prep_t, warm_t, k, lam0, lam, cfg_t)
    assert k_t == k_j
    assert np.array_equal(mask_t.numpy(), np.asarray(mask_j))
    assert np.array_equal(idx_t[mask_t].numpy(),
                          np.asarray(idx_j)[np.asarray(mask_j)])
    np.testing.assert_allclose(vals_t.numpy(), np.asarray(vals_j),
                               atol=1e-12)
    assert int(mask_t.sum()) > int(warm_t[2].sum())     # it recruited
