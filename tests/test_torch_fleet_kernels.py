"""The plain twins of the fleet kernels K1b, K2b and K3b against repro,
float64, and against the port's serial twins (K1, K2, K3) problem by
problem:

  * K1b's twin against ``screen_fused_batch_pallas`` (interpret mode) and
    the reference's serial ``screen_fused_ref`` per problem: scores and
    bounds at rtol 1e-12, merged candidate ids equal on every finite
    candidate; and bitwise the port's serial K1 twin per problem;
  * K2b's twin exactly ``ub_histogram_batch_pallas``;
  * K3b's twin against the reference's SERIAL ``cm_burst_pallas`` per
    problem at 1e-12 relative (the reference's fleet burst kernel fails
    its own parity tests), and bitwise the port's serial K3 twin;
  * the fleet screens per problem against the serial screens, and the
    wrappers given CPU tensors launch nothing.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.active_set import compact_order as j_compact_order
from repro.core.losses import get_loss as j_get_loss
from repro.kernels.cm.cm import cm_burst_pallas
from repro.kernels.ops import screen_fused_ref as j_fused_ref
from repro.kernels.screen.screen import (screen_fused_batch_pallas,
                                         ub_histogram_batch_pallas)
from repro_torch.core.screen_backend import (make_batch_screen_cuda,
                                             make_batch_screen_distinct,
                                             make_batch_screen_matmul,
                                             make_batch_screen_torch,
                                             make_screen_cuda,
                                             make_screen_torch)
from repro_torch.kernels import ops

RTOL = 1e-12
SHAPES = [(64, 256, 3), (57, 513, 2), (33, 1000, 4)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _close_masked(a, b):
    a, b = np.asarray(a), np.asarray(b)
    fin = np.isfinite(b)
    np.testing.assert_allclose(a[fin], b[fin], rtol=RTOL,
                               atol=RTOL * np.abs(b[fin]).max())
    assert (a[~fin] == b[~fin]).all()


def _merge(tops, topi, h):
    """Global top-h of one problem's tile winners, ties to the lowest
    position."""
    cs, pos = jax.lax.top_k(jnp.asarray(tops).reshape(-1), h)
    return np.asarray(cs), np.asarray(jnp.asarray(topi).reshape(-1)[pos])


def _fleet_scan(seed, n, p, b):
    r = np.random.default_rng(seed)
    X = r.normal(size=(n, p))
    Theta = r.normal(size=(b, n))
    norm = np.linalg.norm(X, axis=0)
    active = r.random((b, p)) < 0.1
    radii = r.uniform(0.0, 0.5, b)
    return X, Theta, norm, active, radii


@pytest.mark.parametrize("n,p,b", SHAPES)
def test_fleet_scan_twin_matches_pallas_and_serial(n, p, b):
    h = 16
    X, Theta, norm, active, radii = _fleet_scan(n + p + b, n, p, b)
    cn = np.broadcast_to(norm, (b, p)).copy()
    ops.reset_launch_counts()
    out = ops.screen_fused_batch(_t(X), _t(Theta), _t(norm), _t(active),
                                 _t(radii), h=h)
    out_rows = ops.screen_fused_batch(_t(X), _t(Theta), _t(cn), _t(active),
                                      _t(radii), h=h)
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}
    twin = ops.screen_fused_batch_ref(_t(X), _t(Theta), _t(norm), _t(active),
                                      _t(radii), h=h)
    for a, c, t in zip(out, out_rows, twin):       # shared or per-row norms
        assert torch.equal(a, c) and torch.equal(a, t)
    pal = screen_fused_batch_pallas(X, Theta, cn, active, radii, h=h,
                                    interpret=True)
    for i in range(b):
        # per problem: bitwise the port's serial K1 twin
        ser = ops.screen_fused(_t(X), _t(Theta[i]), _t(norm), _t(active[i]),
                               float(radii[i]), h=h)
        for a, s in zip(out, ser):
            assert torch.equal(a[i], s)
        sr, ur, lr, ts_ref, ti_ref, mu_ref = j_fused_ref(
            X, Theta[i], norm, active[i], radii[i], h=h)
        for a, pb, rf in zip(out[:3], pal[:3], (sr, ur, lr)):
            _close_masked(a[i].numpy(), np.asarray(pb[i]))
            _close_masked(a[i].numpy(), rf)
        cs, ci = _merge(out[3][i].numpy(), out[4][i].numpy(), h)
        cs_p, ci_p = _merge(pal[3][i], pal[4][i], h)
        fin = np.isfinite(np.asarray(ts_ref))
        np.testing.assert_allclose(cs[fin], np.asarray(ts_ref)[fin],
                                   rtol=RTOL)
        assert (ci[fin] == np.asarray(ti_ref)[fin]).all()
        assert (ci[fin] == ci_p[fin]).all()
        assert float(out[5][i].max()) == pytest.approx(float(mu_ref),
                                                       rel=RTOL)


@pytest.mark.parametrize("p,h,b", [(777, 12, 3), (2048, 32, 2)])
def test_fleet_histogram_twin_exact(p, h, b):
    r = np.random.default_rng(p + h)
    ub = r.normal(size=(b, p))
    ub[r.random((b, p)) < 0.1] = -np.inf
    lb = np.abs(r.normal(size=(b, h)))
    lb[:, 1] = lb[:, h - 1]                  # a tied threshold
    ub[:, 0] = lb[:, 1]                      # an ub exactly on a bound
    lb_sorted = np.sort(lb, axis=1)
    hist = ops.ub_histogram_batch(_t(ub), _t(lb_sorted)).numpy()
    assert ops.ub_histogram_batch.launches == 0
    np.testing.assert_array_equal(
        hist, ops.ub_histogram_batch_ref(_t(ub), _t(lb_sorted)).numpy())
    hist_p = np.asarray(ub_histogram_batch_pallas(
        jnp.asarray(ub), jnp.asarray(lb_sorted), interpret=True))
    # the pallas kernel pads its last tile with -inf, which only bin 0
    # (never read by the suffix counts) absorbs
    np.testing.assert_array_equal(hist[:, 1:], hist_p[:, 1:])
    assert (hist.sum(axis=1) == p).all()
    for i in range(b):
        np.testing.assert_array_equal(
            hist[i], ops.ub_histogram(_t(ub[i]), _t(lb_sorted[i])).numpy())


def _blocks(seed, b, n, k, loss_name):
    """b active blocks as the fleet hands them over: dead columns zeroed,
    the compact order, different live counts, one frozen (0 epochs)."""
    r = np.random.default_rng(seed)
    A = np.zeros((b, n, k))
    Y, beta, mask, order, lam, count = [], [], [], [], [], []
    g = j_get_loss(loss_name)
    for i in range(b):
        c = k // 2 + i
        m = np.zeros(k, bool)
        m[r.choice(k, c, replace=False)] = True
        A[i] = np.where(m[None, :], r.normal(size=(n, k)), 0.0)
        if loss_name == "logistic":
            y = np.where(r.random(n) < 0.5, -1.0, 1.0)
        else:
            y = A[i] @ np.where(m, r.normal(size=k), 0.0) + r.normal(size=n)
        Y.append(y)
        beta.append(np.where(m & (r.random(k) < 0.5),
                             r.normal(size=k) * 0.1, 0.0))
        mask.append(m)
        order.append(np.asarray(j_compact_order(
            jnp.arange(k, dtype=jnp.int32), jnp.asarray(m))))
        g0 = np.asarray(g.grad(jnp.zeros(n), y))
        lam.append((0.2 + 0.1 * i) * float(np.max(np.abs(A[i].T @ g0))))
        count.append(c)
    n_ep = [3] * (b - 1) + [0]
    return (A, np.stack(Y), np.stack(beta), np.stack(mask), np.stack(order),
            np.asarray(lam), np.asarray(n_ep), np.asarray(count))


@pytest.mark.parametrize("loss_name", ["least_squares", "logistic"])
def test_fleet_burst_twin_matches_serial_pallas(loss_name):
    b, n, k = 3, 64, 16
    A, Y, beta, mask, order, lam, n_ep, count = _blocks(
        k + (loss_name == "logistic"), b, n, k, loss_name)
    col_sq = np.sum(A * A, axis=1)
    AT = np.ascontiguousarray(A.transpose(0, 2, 1))
    out = ops.cm_burst_batch_xt(_t(AT), _t(Y), _t(beta), _t(col_sq),
                                _t(mask), _t(order), _t(lam), _t(n_ep),
                                _t(count), loss_name=loss_name)
    assert ops.cm_burst_batch_xt.launches == 0
    for a, t in zip(out, ops.cm_burst_batch_ref(
            _t(AT).transpose(1, 2), _t(Y), _t(beta), _t(col_sq), _t(mask),
            _t(order), _t(lam), _t(n_ep), _t(count), loss_name=loss_name)):
        assert torch.equal(a, t)
    for i in range(b):
        bj, zj, thj, gj = cm_burst_pallas(
            jnp.asarray(A[i]), jnp.asarray(Y[i]), jnp.asarray(beta[i]),
            jnp.asarray(col_sq[i]), jnp.asarray(mask[i]),
            jnp.asarray(order[i]), lam[i], int(n_ep[i]), int(count[i]),
            loss_name=loss_name, interpret=True)
        for a, ref in zip((o[i] for o in out), (bj, zj, thj)):
            np.testing.assert_allclose(
                a.numpy(), np.asarray(ref), rtol=RTOL,
                atol=RTOL * max(np.abs(np.asarray(ref)).max(), 1.0))
        # the gap, P - D of two near-equal objectives, on the scale of D
        d_scale = 1.0 + abs(float(j_get_loss(loss_name).dual_objective(
            jnp.asarray(Y[i]), thj, lam[i])))
        assert abs(float(out[3][i]) - float(gj)) <= RTOL * d_scale
        # bitwise the port's serial K3 twin
        ser = ops.cm_burst_xt(_t(AT[i]), _t(Y[i]), _t(beta[i]),
                              _t(col_sq[i]), _t(mask[i]), _t(order[i]),
                              lam[i], int(n_ep[i]), int(count[i]),
                              loss_name=loss_name)
        for a, s in zip((o[i] for o in out), ser):
            assert torch.equal(a, s)
    # the frozen problem ran no epoch: beta comes back unchanged
    assert torch.equal(out[0][b - 1], _t(beta[b - 1]))


def test_fleet_screens_match_serial_screens():
    """Per problem, the torch and cuda fleet screens are the serial
    screens bit for bit (their candidate buffer is the fleet's h; each
    serial screen takes its own smaller h, a prefix); matmul and distinct
    agree on candidates and counts; a skipped problem gets the neutral
    ScreenOut."""
    n, p, b, h = 57, 513, 3, 16
    X, Theta, norm, active, radii = _fleet_scan(3, n, p, b)
    Theta = Theta / np.quantile(np.abs(Theta @ X), 0.97, axis=1)[:, None]
    Xt, cn = _t(X), _t(norm)
    thetas = [_t(t) for t in Theta]
    rs = [torch.tensor(r) for r in radii]
    acts = [_t(a) for a in active]
    do = [True, False, True]
    fleets = {"torch": make_batch_screen_torch(Xt, cn, h),
              "cuda": make_batch_screen_cuda(Xt, cn, h),
              "matmul": make_batch_screen_matmul(Xt, cn, h),
              "distinct": make_batch_screen_distinct(
                  Xt.expand(b, n, p), cn, h)}
    serial = {"torch": make_screen_torch, "cuda": make_screen_cuda}
    for name, fleet in fleets.items():
        outs = fleet(thetas, rs, acts, do)
        assert outs[1].max_ub == -np.inf
        assert not bool(torch.isfinite(outs[1].cand_score).any())
        for i in (0, 2):
            o = outs[i]
            s = serial.get(name, make_screen_torch)(Xt, cn, 8)(
                thetas[i], rs[i], acts[i])
            fin = torch.isfinite(s.cand_score)
            if name in serial:                # bitwise, h-prefix
                assert torch.equal(o.cand_score[:8], s.cand_score)
                assert torch.equal(o.cand_idx[:8], s.cand_idx)
                assert torch.equal(o.cand_lb[:8], s.cand_lb)
                assert torch.equal(o.max_ub, s.max_ub)
            else:
                assert torch.equal(o.cand_idx[:8][fin], s.cand_idx[fin])
                torch.testing.assert_close(o.cand_score[:8], s.cand_score,
                                           rtol=RTOL, atol=0)
            assert torch.equal(o.cand_ge[:8], s.cand_ge)
            assert int(o.n_surv) == int(s.n_surv)


def _tied_scan(b, n=40, p=777, seed=21):
    """Scores that tie bit for bit in any summation order: small-integer X
    and Theta (every sum exact), X's columns drawn from 40 distinct ones;
    per-problem masks, problem 0 with a fully active tile and problem 1
    with its partial last tile active."""
    r = np.random.default_rng(seed)
    base = r.integers(-3, 4, (n, 40)).astype(np.float64)
    X = base[:, r.integers(0, 40, p)]
    Theta = r.integers(-2, 3, (b, n)).astype(np.float64)
    active = r.random((b, p)) < 0.1
    active[0, 256:512] = True
    active[1, 768:] = True
    return X, Theta, np.linalg.norm(X, axis=0), active, r.uniform(0, .5, b)


@pytest.mark.parametrize("h", [3, 256])
def test_fleet_scan_twin_tied_scores_saturated_tiles(h):
    """The order K1b's warp sort must reproduce, on exact ties: the fleet
    twin's merged candidate ids are screen_fused_batch_pallas's, and each
    row is bitwise the serial twin."""
    b = 3
    X, Theta, norm, active, radii = _tied_scan(b)
    out = ops.screen_fused_batch(_t(X), _t(Theta), _t(norm), _t(active),
                                 _t(radii), h=h)
    pal = screen_fused_batch_pallas(X, Theta,
                                    np.broadcast_to(norm, (b, X.shape[1])),
                                    active, radii, h=h, interpret=True)
    for i in range(b):
        ser = ops.screen_fused(_t(X), _t(Theta[i]), _t(norm), _t(active[i]),
                               float(radii[i]), h=h)
        for a, s in zip(out, ser):
            assert torch.equal(a[i], s)
        cs, ci = _merge(out[3][i].numpy(), out[4][i].numpy(), h)
        cs_p, ci_p = _merge(pal[3][i], pal[4][i], h)
        fin = np.isfinite(cs_p)
        assert fin.sum() == min(h, int((~active[i]).sum()))
        assert len(np.unique(cs[fin])) < fin.sum()       # ties among them
        np.testing.assert_array_equal(cs[fin], cs_p[fin])
        np.testing.assert_array_equal(ci[fin], ci_p[fin])
