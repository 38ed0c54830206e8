"""Model selection on the CPU, float64: the port's ``select_solve`` (1-SE
CV, stability selection as one weighted fleet, the refit) against the
reference's on the same inputs, the subsample masks bitwise the
reference's, and the port's copy of the reference's ``Select`` checks
(``ValueError`` where the reference raises its ``RequestError``, itself a
``ValueError``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.core import SaifConfig as JConfig
from repro.core.select import Select as JSelect
from repro.core.select import select_solve as j_select_solve
from repro.core.select import stability_frequencies as j_stability
from repro.core.select import subsample_weights as j_subsample_weights
from test_torch_batch import _support
from test_torch_cv import _problem
from test_torch_saif import _one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def select_case():
    """One reference selection (its online test's sizes), shared."""
    X, y, lm = _problem(8, 60, 120, 6)
    lams = tuple(np.geomspace(0.8 * lm, 0.05 * lm, 5).tolist())
    req = dict(lams=lams, n_folds=4, n_subsamples=6, subsample_frac=0.5,
               pi_threshold=0.6, seed=3)
    ref = j_select_solve(X, y, JSelect(**req), JConfig(eps=1e-8))
    return X, y, req, ref


def test_select_solve_matches_reference(select_case):
    X, y, req, ref = select_case
    rep = rt.select_solve(X, y, rt.Select(**req), rt.SaifConfig(eps=1e-8),
                          device="cpu")
    np.testing.assert_array_equal(rep.lams, np.asarray(ref.lams))
    np.testing.assert_allclose(rep.cv_mean, ref.cv_mean, rtol=1e-9)
    np.testing.assert_allclose(rep.cv_se, ref.cv_se, rtol=1e-9)
    assert rep.lam_min == ref.lam_min and rep.lam_1se == ref.lam_1se
    assert rep.lam == ref.lam and rep.rule == "1se"
    assert rep.lam_1se >= rep.lam_min
    np.testing.assert_array_equal(rep.frequencies, np.asarray(
        ref.frequencies))
    np.testing.assert_array_equal(rep.stable_support, ref.stable_support)
    assert _support(rep.beta) == _support(np.asarray(ref.beta))
    np.testing.assert_allclose(rep.beta.numpy(), np.asarray(ref.beta),
                               rtol=1e-6, atol=1e-8)
    assert float(rep.best_result.gap) <= 1e-8
    assert rep.n_compilations is None and rep.fold_betas is None


def test_stability_fleet_matches_reference_and_certifies(select_case):
    X, y, req, ref = select_case
    cfg = rt.SaifConfig(eps=1e-8)
    freq, fl = rt.stability_frequencies(X, y, ref.lam, cfg, 6, 0.5, seed=4,
                                        device="cpu")
    j_freq, j_fl = j_stability(X, y, ref.lam, JConfig(eps=1e-8), 6, 0.5,
                               seed=4)
    np.testing.assert_array_equal(freq, np.asarray(j_freq))
    W = rt.subsample_weights(60, 6, 0.5, seed=4)
    loss = rt.get_loss("least_squares")
    for b in range(6):
        assert _support(fl.beta[b]) == _support(np.asarray(j_fl.beta[b]))
        assert float(fl.gap[b]) <= 1e-8
        kkt = rt.kkt_residual(loss, torch.from_numpy(X), torch.from_numpy(y),
                              fl.beta[b], ref.lam, sample_w=W[b])
        assert float(kkt) <= 1e-3 * ref.lam


def test_select_min_rule_no_stability_no_refit(select_case):
    X, y, req, _ = select_case
    rep = rt.select_solve(X, y, rt.Select(**dict(
        req, rule="min", stability=False, refit=False,
        keep_fold_betas=True)), rt.SaifConfig(eps=1e-8), device="cpu")
    assert rep.lam == rep.lam_min and rep.rule == "min"
    assert rep.frequencies is None and rep.stable_support is None
    assert rep.beta is None and rep.best_result is None
    assert len(rep.fold_betas) == 5 and rep.fold_betas[0].shape == (4, 120)


@pytest.mark.parametrize("n,b,frac,seed", [(60, 6, 0.5, 4), (48, 16, 0.5, 1),
                                           (31, 3, 0.3, 9)])
def test_subsample_weights_bitwise_reference(n, b, frac, seed):
    W = rt.subsample_weights(n, b, frac, seed=seed)
    assert W.dtype == torch.float64 and W.shape == (b, n)
    np.testing.assert_array_equal(W.numpy(), np.asarray(
        j_subsample_weights(n, b, frac, seed=seed, dtype=jnp.float64)))
    assert (W.sum(1) == int(frac * n)).all()


@pytest.mark.parametrize("bad", [
    dict(lams=()), dict(lams=(0.1, -1.0)), dict(lams=(np.nan,)),
    dict(lams=((0.1, 0.2),)), dict(lams=(0.1,), n_folds=1),
    dict(lams=(0.1,), rule="2se"), dict(lams=(0.1,), n_subsamples=1),
    dict(lams=(0.1,), subsample_frac=1.5), dict(lams=(0.1,),
                                                subsample_frac=0.0),
    dict(lams=(0.1,), pi_threshold=0.0), dict(lams=(0.1,),
                                              pi_threshold=1.5),
    dict(lams=(0.1,), deadline_s=-1.0), dict(lams=(0.1,), priority=True),
    dict(lams=(0.1,), priority=1.5)])
def test_select_validation_matches_reference(bad):
    with pytest.raises(ValueError):
        JSelect(**bad)
    with pytest.raises(ValueError):
        rt.Select(**bad)


def test_select_valid_requests_and_fields():
    ok = rt.Select(lams=(0.5, 0.1), n_subsamples=4)
    assert ok.rule == "1se" and ok.n_folds == 5 and ok.pi_threshold == 0.6
    assert rt.Select(lams=(0.1,), n_subsamples=1, stability=False)
    assert rt.SelectionReport._fields == tuple(
        f for f in __import__("repro.core.select", fromlist=["x"])
        .SelectionReport._fields)
    with pytest.raises(Exception):
        ok.rule = "min"                     # frozen, as the reference's
    with pytest.raises(ValueError):
        rt.subsample_weights(10, 4, 0.05)
