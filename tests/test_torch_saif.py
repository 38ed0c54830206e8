"""The port's main path end to end on the CPU: repro_torch.saif against
repro.saif on the same float64 inputs (least squares with the residual-update
inner backend; the Gram engine's cases are in test_torch_saif_gram.py,
logistic and the capacity-overflow case in test_torch_saif_logistic.py).

Pass criteria per case: the same support at 1e-8, the same final
``n_active``, coefficients allclose (rtol 1e-6, atol 1e-8), gap <= eps and
the KKT residual <= 1e-3 lam. lambda stays well below lambda_max, where the
oracle itself is noisy. The package-level checks are in
test_torch_package.py.
"""
import numpy as np
import pytest
import torch

import repro_torch as rt
from conftest import make_regression
from repro.core import SaifConfig as JConfig
from repro.core import saif as j_saif
from repro.core.duality import lambda_max as j_lambda_max
from repro.core.losses import get_loss as j_get_loss

RULES = ["saif", "gap_safe", "hybrid"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU path is a chain of tiny ops: intra-op threads only
    add overhead (and contend with the other test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _support(beta, tol=1e-8):
    return set(np.where(np.abs(np.asarray(beta)) > tol)[0].tolist())


def check_against_reference(X, y, lam, loss, j_cfg, t_cfg):
    ref = j_saif(X, y, lam, j_cfg)
    res = rt.saif(X, y, lam, t_cfg, device="cpu")
    b_ref, b = np.asarray(ref.beta), res.beta.numpy()
    assert _support(b) == _support(b_ref)
    assert res.n_active == int(ref.n_active)
    np.testing.assert_allclose(b, b_ref, rtol=1e-6, atol=1e-8)
    assert float(res.gap) <= t_cfg.eps
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    kkt = float(rt.kkt_residual(rt.get_loss(loss), Xt, yt, res.beta, lam))
    assert kkt <= 1e-3 * lam
    assert res.beta.dtype == torch.float64
    return res, ref


@pytest.fixture(scope="module")
def ls_problem():
    X, y, _ = make_regression(np.random.default_rng(0), n=50, p=300)
    lm = float(j_lambda_max(j_get_loss("least_squares"), X, y))
    return X, y, lm


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("frac", [0.5, 0.1, 0.02])
def test_least_squares_matches_reference(ls_problem, frac, rule):
    """The residual-update inner backend (the reference's ``jnp``)."""
    X, y, lm = ls_problem
    check_against_reference(
        X, y, frac * lm, "least_squares",
        JConfig(screen_rule=rule, inner_backend="jnp"),
        rt.SaifConfig(screen_rule=rule, inner_backend="torch"))
