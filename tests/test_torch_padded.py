"""A bucket-padded ``PathState`` in the port's serial engine, against the
reference's padded solve and the port's unpadded one, on the CPU.

make_regression (n = 60, p = 300) is padded to 64 x 512 by the reference's
``pad_path_state`` (zero rows and columns; c0 pads at -inf, column-norm pads
at 1.0) and carried across with ``path_state_from_numpy(n_true=, p_true=)``.
The pad columns are born active without a slot, as in the reference, so a
pad is never scored, recruited or deleted. Pass criteria per case: the
reference's integer screening trace (``trace_screened``), outer steps,
``n_active`` and support, beta allclose (rtol 1e-6, atol 1e-8), gap <= eps,
no live slot on a pad, and the unpadded port's trace and outer steps.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from conftest import make_regression
from repro.core import path as jpath
from repro.core.saif import pad_path_state
from repro_torch import SaifConfig
from repro_torch.convert import path_state_from_numpy
from repro_torch.core import path as tpath
from repro_torch.core.saif import solve_scalar
from test_torch_saif import _one_torch_thread  # noqa: F401

N, P, N_PAD, P_PAD = 60, 300, 64, 512
RULES = ["saif", "gap_safe", "hybrid"]


def _support(beta, tol=1e-8):
    return set(np.where(np.abs(np.asarray(beta)) > tol)[0].tolist())


def _port_prep(prep, n_true=0, p_true=0):
    return path_state_from_numpy(
        np.asarray(prep.X), np.asarray(prep.y), np.asarray(prep.c0),
        np.asarray(prep.col_norm), prep.lam_max, prep.c0_max,
        prep.c0_median, prep.b0, n_true=n_true, p_true=p_true, device="cpu")


@pytest.fixture(scope="module")
def preps():
    X, y, _ = make_regression(np.random.default_rng(0), n=N, p=P)
    prep = J.prepare_path(jnp.asarray(X), jnp.asarray(y), J.SaifConfig())
    padded = pad_path_state(prep, N_PAD, P_PAD)
    assert (padded.n_true, padded.p_true) == (N, P)
    return prep, padded, _port_prep(prep), _port_prep(padded, N, P)


def _trace(res):
    t = np.asarray(res.trace_screened)
    return t[t >= 0].tolist()


def _check(mine, ref, plain, eps):
    """``mine`` (padded port) against ``ref`` (padded reference) and
    ``plain`` (unpadded port)."""
    beta = mine.beta.numpy()
    assert beta.shape == (P_PAD,)
    assert not beta[P:].any()
    live = mine.active_idx[mine.active_mask]
    assert bool((live < P).all()), "a pad column holds a live slot"
    assert _trace(mine) == _trace(ref)
    assert mine.n_outer == int(ref.n_outer)
    assert mine.n_active == int(ref.n_active)
    assert _support(beta) == _support(ref.beta)
    np.testing.assert_allclose(beta, np.asarray(ref.beta), rtol=1e-6,
                               atol=1e-8)
    assert float(mine.gap) <= eps
    assert _trace(mine) == _trace(plain)
    assert mine.n_outer == plain.n_outer
    assert _support(beta[:P]) == _support(plain.beta)
    np.testing.assert_allclose(beta[:P], plain.beta.numpy(), rtol=1e-6,
                               atol=1e-8)


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("frac", [0.5, 0.1])
def test_padded_solve_matches_reference(preps, frac, rule):
    prep_j, pad_j, prep_t, pad_t = preps
    lam = frac * prep_j.lam_max
    cfg_j, cfg_t = J.SaifConfig(screen_rule=rule), SaifConfig(screen_rule=rule)
    ref = J.solve_scalar(pad_j, lam, cfg_j)
    mine = solve_scalar(pad_t, lam, cfg_t, device="cpu")
    plain = solve_scalar(prep_t, lam, cfg_t, device="cpu")
    # the unpadded reference screens the same columns
    assert _trace(ref) == _trace(J.solve_scalar(prep_j, lam, cfg_j))
    _check(mine, ref, plain, cfg_t.eps)


@pytest.mark.parametrize("rule", RULES)
def test_padded_path_matches_reference(preps, rule):
    """``run_path`` (the engine of ``saif_path``) over a padded prep."""
    prep_j, pad_j, prep_t, pad_t = preps
    lams = [f * prep_j.lam_max for f in (0.6, 0.3, 0.1)]
    cfg_j, cfg_t = J.SaifConfig(screen_rule=rule), SaifConfig(screen_rule=rule)
    ref, _, k_ref = jpath.run_path(pad_j, lams, cfg_j)
    mine, _, k = tpath.run_path(pad_t, lams, cfg_t)
    plain, _, k_plain = tpath.run_path(prep_t, lams, cfg_t)
    assert k == k_ref == k_plain
    for r, rr, rp in zip(mine.results, ref.results, plain.results):
        _check(r, rr, rp, cfg_t.eps)


def test_pad_column_is_never_scored(preps):
    """The scan a padded solve's first ADD step sees: a pad scores 0 with
    norm 1, so ub = r and, unmasked, it would be a violating candidate at
    any radius >= 1; born active, it is masked to -inf."""
    _, _, _, pad_t = preps
    lam = 0.1 * pad_t.lam_max
    res = solve_scalar(pad_t, lam, SaifConfig(), device="cpu")
    screened = _trace(res)
    assert screened and max(screened) <= P
    assert torch.all(res.active_idx[res.active_mask] < P)
