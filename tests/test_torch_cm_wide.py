"""The wide CM sweep K7's plain version against repro, float64: the twin
``kernels/cm/ref.py::cm_sweep_wide_ref`` (reached through the wrapper
``ops.cm_sweep_wide`` with CPU tensors, and through ``core/cm.py``'s
``cm_epoch`` / ``cm_epochs_wide``) against ``repro.core.cm.cm_epoch`` for
least squares and logistic, with masked slots (beta nonzero on some) and
per-slot l1 weights, at rtol 1e-10 (the same arithmetic, summed in another
order); bit for bit the port's own ``cm_sweeps`` loop; the order the
callers hand it (masked slots at 0 left out); the twin at the kernel's
design boundaries (short orders around its read-ahead distances, the row
counts where its register forms change; ``chip_smoke.py::wide_cases``
holds the kernel itself there on the card); an order that repeats a slot
refused; the shared-memory gate."""
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


def _against_reference_and_loop(X, y, beta, z, mask, lam, loss_name, count,
                                n_ep):
    """K7's wrapper on CPU tensors over the first ``count`` slots for
    ``n_ep`` epochs: against the reference's sweeps of those columns
    (rtol 1e-10) and bit for bit ``cm_sweeps`` over them."""
    XT = _t(X.T.copy())
    cs = torch.sum(XT * XT, dim=1)
    k = X.shape[1]
    b, zz = ops.cm_sweep_wide(XT, _t(y), _t(beta), _t(z), cs, _t(mask),
                              torch.arange(k), lam, n_ep, count,
                              loss_name=loss_name)
    jl = j_get_loss(loss_name)
    bj, zj = jnp.asarray(beta), jnp.asarray(z)
    for _ in range(n_ep):
        bj, zj = jcm.cm_epoch(jl, jnp.asarray(X[:, :count]), jnp.asarray(y),
                              bj[:count], zj, jnp.asarray(mask[:count]), lam)
        bj = jnp.concatenate([bj, jnp.asarray(beta[count:])])
    _close(b.numpy(), bj)
    _close(zz.numpy(), zj)
    ref = tcm.cm_sweeps(t_get_loss(loss_name), XT.T, _t(y), _t(beta), _t(z),
                        _t(mask), lam, cs, torch.arange(count), count, n_ep)
    assert torch.equal(b, ref[0]) and torch.equal(zz, ref[1])


@pytest.mark.parametrize("loss_name", ["least_squares", "logistic"])
@pytest.mark.parametrize("count", [3, 4, 5, 6, 8, 9])
def test_short_orders(count, loss_name):
    """The twin on orders of 3-9 slots swept 7 times over: the counts at
    which the kernel's reads ahead wrap past its own writes (beta two
    steps ahead, in hand up to a count of 2, the slot five steps ahead);
    one masked slot with a nonzero beta. The kernel is held at the same
    counts on the card (``chip_smoke.py::WIDE_COUNTS``)."""
    X, y, beta, z, mask, _, lam = _design(7 + count, 30, 12, loss_name,
                                          n_masked=2)
    _against_reference_and_loop(X, y, beta, z, mask, 0.05 * lam, loss_name,
                                count, 7)


@pytest.mark.parametrize("n", [1024, 1025, 2048, 2049])
def test_row_boundaries(n):
    """The twin at the n where the kernel's forms change: 4 rows a thread
    in registers up to 1,024, 8 up to 2,048, past that z and y in shared
    memory (the kernel is held at the same n on the card by
    ``chip_smoke.py::wide_cases``)."""
    X, y, beta, z, mask, _, lam = _design(n, n, 6, "least_squares",
                                          n_masked=1)
    _against_reference_and_loop(X, y, beta, z, mask, lam, "least_squares",
                                6, 2)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_repeated_slot_refused(dtype):
    """The kernel carries beta by position, so ``order[:count]`` must list
    distinct slots: on CPU tensors an order that repeats one is refused
    (a slot past ``count`` may repeat)."""
    X, y, beta, z, mask, _, lam = _design(20, 8, 6, "least_squares")
    XT = _t(X.T.copy()).to(dtype)
    args = (XT, _t(y).to(dtype), _t(beta).to(dtype), _t(z).to(dtype),
            torch.sum(XT * XT, dim=1), _t(mask))
    with pytest.raises(ValueError, match="repeats a slot"):
        ops.cm_sweep_wide(*args, torch.tensor([0, 3, 0, 5]), lam, 1, 3)
    b, z1 = ops.cm_sweep_wide(*args, torch.tensor([0, 3, 5, 0]), lam, 1, 3)
    b2, z2 = ops.cm_sweep_wide(*args, torch.tensor([0, 3, 5, 1]), lam, 1, 3)
    assert b.dtype == dtype and torch.equal(b, b2) and torch.equal(z1, z2)
