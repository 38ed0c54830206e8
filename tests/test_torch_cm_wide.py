"""The wide CM sweep K7's plain version against repro, float64: the twin
``kernels/cm/ref.py::cm_sweep_wide_ref`` (reached through the wrapper
``ops.cm_sweep_wide`` with CPU tensors, and through ``core/cm.py``'s
``cm_epoch`` / ``cm_epochs_wide``) against ``repro.core.cm.cm_epoch`` for
least squares and logistic, with masked slots (beta nonzero on some) and
per-slot l1 weights, at rtol 1e-10 (the same arithmetic, summed in another
order); bit for bit the port's own ``cm_sweeps`` loop; the order the
callers hand it (masked slots at 0 left out); the shared-memory gate."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cm as jcm
from repro.core.losses import get_loss as j_get_loss
from repro_torch.core import cm as tcm
from repro_torch.core.losses import get_loss as t_get_loss
from repro_torch.kernels import ops
from repro_torch.kernels.cm.wide import cm_wide_smem_bytes, cm_wide_smem_ok

RTOL = 1e-10


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                               atol=RTOL * max(np.abs(np.asarray(b)).max(),
                                               1.0))


def _design(seed, n, k, loss_name, n_masked=0, pen=False):
    """A design as a baseline hands it to its sweep: every column real,
    ``n_masked`` slots masked (half of them with a nonzero beta, which the
    sweep must step to 0), beta nonzero on a third of the slots, z = X
    beta, and optionally l1 weights with one unpenalized slot."""
    r = np.random.default_rng(seed)
    X = r.normal(size=(n, k))
    if loss_name == "logistic":
        y = np.where(r.random(n) < 0.5, -1.0, 1.0)
    else:
        y = X[:, :5] @ r.normal(size=min(k, 5)) + r.normal(size=n)
    beta = np.where(r.random(k) < 1 / 3, 0.1 * r.normal(size=k), 0.0)
    mask = np.ones(k, bool)
    dead = r.choice(k, n_masked, replace=False)
    mask[dead] = False
    beta[dead[: n_masked // 2]] = 0.0
    beta[dead[n_masked // 2:]] = 0.05
    w = None
    if pen:
        w = np.ones(k)
        w[int(np.flatnonzero(mask)[0])] = 0.0
    g0 = np.asarray(j_get_loss(loss_name).grad(jnp.zeros(n), y))
    lam = 0.2 * float(np.max(np.abs(X.T @ g0)))
    return X, y, beta, X @ beta, mask, w, lam


CASES = [("least_squares", 0, False), ("least_squares", 10, False),
         ("least_squares", 0, True), ("logistic", 0, False),
         ("logistic", 10, True)]


@pytest.mark.parametrize("loss_name,n_masked,pen", CASES)
def test_cm_epoch_matches_reference(loss_name, n_masked, pen):
    """``cm_epoch`` (K7's twin on CPU tensors) against the reference's
    masked sweep, three epochs in a row; masked slots end at 0."""
    X, y, beta, z, mask, w, lam = _design(1 + n_masked, 50, 40, loss_name,
                                          n_masked, pen)
    jl, tl = j_get_loss(loss_name), t_get_loss(loss_name)
    jw = None if w is None else jnp.asarray(w)
    tw = None if w is None else _t(w)
    bj, zj = jnp.asarray(beta), jnp.asarray(z)
    bt, zt = _t(beta), _t(z)
    ops.reset_launch_counts()
    for _ in range(3):
        bj, zj = jcm.cm_epoch(jl, jnp.asarray(X), jnp.asarray(y), bj, zj,
                              jnp.asarray(mask), lam, pen=jw)
        bt, zt = tcm.cm_epoch(tl, _t(X), _t(y), bt, zt, _t(mask), lam,
                              pen=tw)
        _close(bt.numpy(), bj)
        _close(zt.numpy(), zj)
    assert (bt.numpy()[~mask] == 0).all()
    assert ops.launch_counts()["cm_sweep_wide"] == 0   # CPU: the twin


@pytest.mark.parametrize("loss_name,n_masked,pen", CASES)
def test_wrapper_is_the_ports_sweep_loop(loss_name, n_masked, pen):
    """``ops.cm_sweep_wide`` on the transposed design, from the order
    ``sweep_order`` builds (live and nonzero slots first, masked slots at
    0 left out), is bit for bit ``cm_sweeps`` over every slot in index
    order; its inputs are left as they were."""
    X, y, beta, z, mask, w, lam = _design(5 + n_masked, 60, 33, loss_name,
                                          n_masked, pen)
    loss = t_get_loss(loss_name)
    XT = _t(X.T.copy())
    col_sq = torch.sum(XT * XT, dim=1)
    tw = None if w is None else _t(w)
    order, count = tcm.sweep_order(_t(mask), _t(beta))
    assert count == int((mask | (beta != 0)).sum())
    assert order[:count].tolist() == np.flatnonzero(mask | (beta != 0)
                                                    ).tolist()
    b_in, z_in = _t(beta), _t(z)
    out = ops.cm_sweep_wide(XT, _t(y), b_in, z_in, col_sq, _t(mask), order,
                            lam, 4, count, tw, loss_name=loss_name)
    ref = tcm.cm_sweeps(loss, XT.T, _t(y), _t(beta), _t(z), _t(mask), lam,
                        col_sq, torch.arange(33), 33, 4, tw)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert torch.equal(b_in, _t(beta)) and torch.equal(z_in, _t(z))
    wide = tcm.cm_epochs_wide(loss, XT, _t(y), _t(beta), _t(z), _t(mask),
                              lam, col_sq, 4, tw)
    for a, b in zip(wide, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("loss_name", ["least_squares", "logistic"])
def test_edges(loss_name):
    """No epoch and no slot leave (beta, z) as they are; one slot (k = 1)
    and a count wrapping over a short order (the same slot twice in a row
    and two slots alternating) match the reference's sweeps."""
    X, y, beta, z, mask, _, lam = _design(3, 40, 2, loss_name)
    XT = _t(X.T.copy())
    cs = torch.sum(XT * XT, dim=1)
    args = (XT, _t(y), _t(beta), _t(z), cs, _t(mask), torch.arange(2), lam)
    for n_ep, count in ((0, 2), (3, 0)):
        b, zz = ops.cm_sweep_wide(*args, n_ep, count, loss_name=loss_name)
        assert torch.equal(b, _t(beta)) and torch.equal(zz, _t(z))
    jl = j_get_loss(loss_name)
    for count in (1, 2):
        bj, zj = jnp.asarray(beta), jnp.asarray(z)
        for _ in range(5):
            bj, zj = jcm.cm_epoch(jl, jnp.asarray(X[:, :count]),
                                  jnp.asarray(y), bj[:count], zj,
                                  jnp.asarray(mask[:count]), lam)
            bj = jnp.concatenate([bj, jnp.asarray(beta[count:])])
        b, zz = ops.cm_sweep_wide(*args, 5, count, loss_name=loss_name)
        _close(b.numpy(), bj)
        _close(zz.numpy(), zj)


def test_smem_gate_on_n_alone():
    """The gate counts y and z (n each) and the reduction slots, whatever
    the width: n = 12,792 rows fit in float64 (25,592 in float32), one
    more does not."""
    assert cm_wide_smem_bytes(1000, 8) == (2000 + 16) * 8
    assert cm_wide_smem_ok(12_792, 8) and not cm_wide_smem_ok(12_793, 8)
    assert cm_wide_smem_ok(25_592, 4) and not cm_wide_smem_ok(25_593, 4)
    assert "cm_sweep_wide" in ops.KERNELS
