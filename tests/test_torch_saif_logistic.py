"""The port's main path end to end on the CPU, continued: logistic loss,
the capacity-overflow regrowth, and the state carried across from the
reference (``repro_torch.convert``). Same pass criteria as
test_torch_saif.py."""
import jax
import numpy as np
import pytest

import repro_torch as rt
from conftest import make_classification, make_regression
from repro.core import SaifConfig as JConfig
from repro.core import prepare_path as j_prepare_path
from repro.core import saif as j_saif
from repro.core.duality import lambda_max as j_lambda_max
from repro.core.losses import get_loss as j_get_loss
from repro_torch.convert import path_state_from_numpy, warm_start_from_numpy
from test_torch_saif import _one_torch_thread  # noqa: F401
from test_torch_saif import check_against_reference


@pytest.fixture(scope="module")
def logit_problem():
    X, y, _ = make_classification(np.random.default_rng(1), n=60, p=250)
    lm = float(j_lambda_max(j_get_loss("logistic"), X, y))
    return X, y, lm


@pytest.mark.parametrize("rule", ["saif", "gap_safe", "hybrid"])
@pytest.mark.parametrize("frac", [0.3, 0.05])
def test_logistic_matches_reference(logit_problem, frac, rule):
    X, y, lm = logit_problem
    check_against_reference(
        X, y, frac * lm, "logistic",
        JConfig(loss="logistic", screen_rule=rule, inner_backend="jnp"),
        rt.SaifConfig(loss="logistic", screen_rule=rule,
                      inner_backend="torch"))


def test_capacity_overflow_regrows_like_reference():
    X, y, _ = make_regression(np.random.default_rng(2), n=50, p=300)
    lam = 0.05 * float(j_lambda_max(j_get_loss("least_squares"), X, y))
    res, ref = check_against_reference(X, y, lam, "least_squares",
                                       JConfig(k_max=32),
                                       rt.SaifConfig(k_max=32))
    assert res.n_active > 32                     # it did outgrow k_max
    assert res.active_idx.shape[0] == ref.active_idx.shape[0]
    assert not res.overflowed


def test_convert_round_trip_solves_alike():
    """The reference's preparation and final slots, carried across as numpy
    arrays, give the port's own preparation and a warm start that solves
    to the same result."""
    X, y, _ = make_regression(np.random.default_rng(3), n=50, p=300)
    cfg_j, cfg_t = JConfig(), rt.SaifConfig()
    prep_j = j_prepare_path(X, y, cfg_j)
    fields = {f: (np.asarray(getattr(prep_j, f))
                  if isinstance(getattr(prep_j, f), jax.Array)
                  else getattr(prep_j, f))
              for f in prep_j._fields}
    prep = path_state_from_numpy(**fields, device="cpu")
    own = rt.prepare_path(X, y, cfg_t, device="cpu")
    assert prep.lam_max == pytest.approx(own.lam_max, rel=1e-12)
    assert prep.c0_median == pytest.approx(own.c0_median, rel=1e-12)
    lam = 0.1 * own.lam_max
    a = rt.solve_scalar(prep, lam, cfg_t, device="cpu")
    b = rt.solve_scalar(own, lam, cfg_t, device="cpu")
    np.testing.assert_allclose(a.beta.numpy(), b.beta.numpy(), rtol=1e-6,
                               atol=1e-8)
    assert a.n_active == b.n_active
    # warm start from the reference's solve at a neighbouring lambda
    prev = j_saif(X, y, 0.15 * own.lam_max, cfg_j)
    warm_idx, warm_beta = warm_start_from_numpy(prev.active_idx,
                                                prev.active_mask, prev.beta)
    assert warm_idx.shape[0] == int(prev.n_active)
    w = rt.solve_scalar(prep, lam, cfg_t, warm_idx=warm_idx,
                        warm_beta=warm_beta, device="cpu")
    ref_w = j_saif(X, y, lam, cfg_j, warm_idx=np.asarray(warm_idx),
                   warm_beta=np.asarray(warm_beta))
    np.testing.assert_allclose(w.beta.numpy(), np.asarray(ref_w.beta),
                               rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(w.beta.numpy(), b.beta.numpy(), rtol=1e-5,
                               atol=1e-6)
