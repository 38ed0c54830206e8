"""repro_torch's CM sweeps and the plain CM burst against repro, float64:
the plain ``cm_burst`` against ``cm_burst_pallas`` (interpret mode) for
least squares and logistic, and the Gram sweep (``ops.gram_sweep`` on CPU
tensors) / ``cm_epochs_compact`` against their references, all at rtol 1e-10 (the same arithmetic, summed
in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cm as jcm
from repro.core.active_set import compact_order as j_compact_order
from repro.core.losses import get_loss as j_get_loss
from repro.kernels.cm.cm import cm_burst_pallas
from repro_torch.core import cm as tcm
from repro_torch.core.losses import get_loss as t_get_loss
from repro_torch.kernels import ops

RTOL = 1e-10


def _t(a):
    return torch.from_numpy(np.array(a))


def _block(seed, n, k, count, loss_name):
    """An active block as the solver hands it over: ``count`` live slots
    scattered over k, dead columns zeroed, the compact order."""
    r = np.random.default_rng(seed)
    mask = np.zeros(k, bool)
    mask[r.choice(k, count, replace=False)] = True
    A = np.where(mask[None, :], r.normal(size=(n, k)), 0.0)
    if loss_name == "logistic":
        y = np.where(r.random(n) < 0.5, -1.0, 1.0)
    else:
        y = A @ np.where(mask, r.normal(size=k), 0.0) + r.normal(size=n)
    beta = np.where(mask & (r.random(k) < 0.5), r.normal(size=k) * 0.1, 0.0)
    order = np.asarray(j_compact_order(jnp.arange(k, dtype=jnp.int32),
                                       jnp.asarray(mask)))
    g0 = np.asarray(j_get_loss(loss_name).grad(jnp.zeros(n), y))
    lam = 0.3 * float(np.max(np.abs(A.T @ g0)))
    return A, y, beta, mask, order, lam


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                               atol=RTOL * max(np.abs(np.asarray(b)).max(),
                                               1.0))


@pytest.mark.parametrize("loss_name", ["least_squares", "logistic"])
@pytest.mark.parametrize("n,k,count", [(64, 16, 12), (100, 32, 25)])
def test_cm_burst_matches_pallas(loss_name, n, k, count):
    A, y, beta, mask, order, lam = _block(n + k, n, k, count, loss_name)
    col_sq = np.sum(A * A, axis=0)
    n_ep = 3
    bj, zj, thj, gj = cm_burst_pallas(
        jnp.asarray(A), jnp.asarray(y), jnp.asarray(beta),
        jnp.asarray(col_sq), jnp.asarray(mask), jnp.asarray(order), lam,
        n_ep, count, loss_name=loss_name, interpret=True)
    out = ops.cm_burst(_t(A), _t(y), _t(beta), _t(col_sq), _t(mask),
                       _t(order), lam, n_ep, count, loss_name=loss_name)
    assert ops.cm_burst_xt.launches == 0         # CPU: the plain version
    out_xt = ops.cm_burst_xt(_t(A.T.copy()), _t(y), _t(beta), _t(col_sq),
                             _t(mask), _t(order), lam, n_ep, count,
                             loss_name=loss_name)
    for o in (out, out_xt):
        for a, b in zip(o, (bj, zj, thj, gj)):
            _close(a.numpy(), b)
        assert (o[0].numpy()[~mask] == 0).all()


def test_cm_burst_pen_not_ported():
    """The pen branch is ported (its cases are in test_torch_fused.py): with
    every slot penalized it is the plain-LASSO burst, bit for bit."""
    A, y, beta, mask, order, lam = _block(0, 8, 4, 3, "least_squares")
    args = (_t(A), _t(y), _t(beta), _t(np.ones(4)), _t(mask), _t(order),
            lam, 1, 3)
    for a, b in zip(ops.cm_burst(*args, pen=_t(np.ones(4))),
                    ops.cm_burst(*args)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("loss_name", ["least_squares", "logistic"])
def test_cm_epochs_compact_matches(loss_name):
    A, y, beta, mask, order, lam = _block(7, 60, 20, 14, loss_name)
    z = A @ beta
    bj, zj = jcm.cm_epochs_compact(j_get_loss(loss_name), jnp.asarray(A),
                                   jnp.asarray(y), jnp.asarray(beta),
                                   jnp.asarray(z), jnp.asarray(mask), lam,
                                   jnp.asarray(order), 14, 4)
    bt, zt = tcm.cm_epochs_compact(t_get_loss(loss_name), _t(A), _t(y),
                                   _t(beta), _t(z), _t(mask), lam,
                                   _t(order), 14, 4)
    _close(bt.numpy(), bj)
    _close(zt.numpy(), zj)


def test_gram_epochs_matches():
    A, y, beta, mask, order, lam = _block(9, 60, 20, 14, "least_squares")
    G, rho = A.T @ A, A.T @ y
    bj = jcm.gram_epochs(jnp.asarray(G), jnp.asarray(rho), jnp.asarray(beta),
                         jnp.asarray(mask), lam, jnp.asarray(order), 14, 6)
    bt = ops.gram_sweep(_t(G), _t(rho), _t(beta), _t(mask), lam, _t(order),
                        14, 6)
    _close(bt.numpy(), bj)
    # the covariance form and the residual form are one sweep
    br, _ = tcm.cm_epochs_compact(t_get_loss("least_squares"), _t(A), _t(y),
                                  _t(beta), _t(A @ beta), _t(mask), lam,
                                  _t(order), 14, 6)
    np.testing.assert_allclose(bt.numpy(), br.numpy(), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("loss_name", ["least_squares", "logistic"])
def test_masked_slots_stay_zero(loss_name):
    """Dead slots swept by the schedule (mask False) end at exactly 0."""
    r = np.random.default_rng(11)
    n, k = 40, 12
    A = r.normal(size=(n, k))
    y = (np.where(r.random(n) < 0.5, -1.0, 1.0) if loss_name == "logistic"
         else r.normal(size=n))
    mask = np.zeros(k, bool)
    mask[:5] = True
    beta = np.zeros(k)
    order = np.arange(k)
    out = ops.cm_burst(_t(A), _t(y), _t(beta), _t(np.sum(A * A, 0)),
                       _t(mask), _t(order), 0.1, 5, k, loss_name=loss_name)
    assert (out[0].numpy()[5:] == 0).all()
    assert (out[0].numpy()[:5] != 0).any()
    bt, _ = tcm.cm_epochs_compact(t_get_loss(loss_name), _t(A), _t(y),
                                  _t(beta), _t(np.zeros(n)), _t(mask), 0.1,
                                  _t(order), k, 5)
    assert (bt.numpy()[5:] == 0).all()


def test_solve_lasso_cm_oracle_matches():
    r = np.random.default_rng(4)
    X = r.normal(size=(30, 20))
    y = r.normal(size=30)
    lam = 0.2 * float(np.max(np.abs(X.T @ y)))
    bj = jcm.solve_lasso_cm(j_get_loss("least_squares"), jnp.asarray(X),
                            jnp.asarray(y), lam, tol=1e-10)
    bt = tcm.solve_lasso_cm(t_get_loss("least_squares"), _t(X), _t(y), lam,
                            tol=1e-10)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-8,
                               atol=1e-10)
