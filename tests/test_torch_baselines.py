"""The paper's baselines in repro_torch against repro, float64, on the CPU
(the plain loop that K7 replaces on the card), at the shapes and seeds of
tests/test_baselines.py: ``dynamic_screening`` (least squares at two
lambdas, logistic at one), ``sequential_path``, ``homotopy_path`` (safe,
unsafe and ``greedy_cap=6``), ``support_metrics`` and ``dual_point``. The
integer outputs (survivor history, outer steps, screened fractions,
supports, coordinate updates) must be equal; coefficients agree to rtol
1e-8 (the same arithmetic, summed in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch as rt
from repro.core.duality import dual_point as j_dual_point
from repro.core.duality import lambda_max as j_lambda_max
from repro_torch.kernels import ops

from conftest import make_classification, make_regression


def _lmax(loss_name, X, y):
    return float(j_lambda_max(J.get_loss(loss_name), jnp.asarray(X),
                              jnp.asarray(y)))


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-8,
                               atol=1e-10)


@pytest.fixture(autouse=True)
def _no_launches():
    """A baseline given device="cpu" runs the plain loop: no kernel."""
    ops.reset_launch_counts()
    yield
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


@pytest.mark.parametrize("frac", [0.1, 0.05])
def test_dynamic_screening_matches_reference(frac):
    X, y, _ = make_regression(np.random.default_rng(12345), n=40, p=200)
    lam = frac * _lmax("least_squares", X, y)
    ref = J.dynamic_screening(X, y, lam, J.DynConfig(eps=1e-9))
    out = rt.dynamic_screening(X, y, lam, rt.DynConfig(eps=1e-9),
                               device="cpu")
    assert out.survivor_history == ref.survivor_history
    assert len(out.survivor_history) > 1        # it compacted
    assert out.n_outer == ref.n_outer
    assert out.coord_updates == ref.coord_updates
    _close(out.beta.numpy(), ref.beta)
    assert float(out.gap) <= 1e-9


def test_dynamic_screening_logistic_matches_reference():
    X, y, _ = make_classification(np.random.default_rng(12345))
    lam = 0.2 * _lmax("logistic", X, y)
    cfg = dict(eps=1e-8, loss="logistic")
    ref = J.dynamic_screening(X, y, lam, J.DynConfig(**cfg))
    out = rt.dynamic_screening(X, y, lam, rt.DynConfig(**cfg), device="cpu")
    assert out.survivor_history == ref.survivor_history
    assert (out.n_outer, out.coord_updates) == (ref.n_outer,
                                                ref.coord_updates)
    _close(out.beta.numpy(), ref.beta)


def test_sequential_path_matches_reference():
    X, y, _ = make_regression(np.random.default_rng(12345), n=40, p=180)
    lams = J.lambda_grid(_lmax("least_squares", X, y), 6, lo_frac=0.05)
    ref = J.sequential_path(X, y, lams)
    out = rt.sequential_path(X, y, np.asarray(lams), device="cpu")
    np.testing.assert_array_equal(out.lams, ref.lams)
    assert out.screened_frac == ref.screened_frac
    assert max(out.screened_frac) > 0.2
    assert out.coord_updates == ref.coord_updates
    for a, b in zip(out.betas, ref.betas):
        _close(a.numpy(), b)


def _check_homotopy(X, y, lams, **cfg):
    ref = J.homotopy_path(X, y, lams, J.HomotopyConfig(**cfg))
    out = rt.homotopy_path(X, y, np.asarray(lams), rt.HomotopyConfig(**cfg),
                           device="cpu")
    assert len(out.supports) == len(ref.supports)
    for a, b in zip(out.supports, ref.supports):
        np.testing.assert_array_equal(a, b)
    assert out.coord_updates == ref.coord_updates
    for a, b in zip(out.betas, ref.betas):
        _close(a.numpy(), b)
    return out


@pytest.mark.parametrize("kkt_check", [True, False])
def test_homotopy_path_matches_reference(kkt_check):
    X, y, _ = make_regression(np.random.default_rng(12345), n=40, p=200)
    lams = J.lambda_grid(0.8 * _lmax("least_squares", X, y), 8,
                         lo_frac=0.02)
    _check_homotopy(X, y, lams, eps=1e-9, kkt_check=kkt_check)


def test_greedy_homotopy_matches_reference():
    """The data of test_baselines.py::test_greedy_homotopy_actually_fails:
    the truncated variant misses features in both packages alike."""
    r = np.random.default_rng(7)
    n, p, k = 60, 300, 25
    F = r.normal(size=(p, 8))
    X = r.normal(size=(n, 8)) @ F.T + 0.3 * r.normal(size=(n, p))
    X = (X - X.mean(0)) / X.std(0)
    w = np.zeros(p)
    w[r.choice(p, k, replace=False)] = r.normal(size=k)
    y = X @ w + 0.5 * r.normal(size=n)
    lams = np.geomspace(0.5 * _lmax("least_squares", X, y),
                        0.005 * _lmax("least_squares", X, y), 4)
    _check_homotopy(X, y, lams, eps=1e-8, greedy_cap=6)


@pytest.mark.parametrize("est,true,want", [
    ([1, 2, 3], [2, 3, 4, 5], (0.5, 2 / 3)),
    ([], [1], (0.0, 1.0)),
    ([1], [], (1.0, 0.0)),
    ([], [], (1.0, 1.0)),
    ([4, 7], [7, 4], (1.0, 1.0)),
])
def test_support_metrics_exact(est, true, want):
    est, true = np.asarray(est, int), np.asarray(true, int)
    assert rt.support_metrics(est, true) == J.support_metrics(est, true)
    assert rt.support_metrics(est, true) == want


@pytest.mark.parametrize("loss_name", ["least_squares", "logistic"])
def test_dual_point_matches_reference(loss_name):
    r = np.random.default_rng(3)
    X = r.normal(size=(30, 12))
    y = (np.where(r.random(30) < 0.5, -1.0, 1.0) if loss_name == "logistic"
         else r.normal(size=30))
    beta = r.normal(size=12) * 0.1
    ref = j_dual_point(J.get_loss(loss_name), jnp.asarray(X), jnp.asarray(y),
                       jnp.asarray(beta), 0.7)
    out = rt.dual_point(rt.get_loss(loss_name), torch.from_numpy(X),
                        torch.from_numpy(y), torch.from_numpy(beta), 0.7)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12)


def test_baselines_refuse_to_fall_back(monkeypatch):
    """Without a card, only an explicit device="cpu" runs."""
    X, y, _ = make_regression(np.random.default_rng(0), n=10, p=20)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: rt.dynamic_screening(X, y, 1.0),
                 lambda: rt.sequential_path(X, y, [1.0]),
                 lambda: rt.homotopy_path(X, y, [1.0])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
