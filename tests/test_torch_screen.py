"""repro_torch's screening path against repro's, float64, at the shapes of
the reference's own parity tests (padded and unpadded tiles):

  * the plain fused scan against ``screen_fused_pallas`` (interpret mode)
    and ``screen_fused_ref``: scores and bounds at rtol 1e-12, merged
    candidate ids exact on every finite candidate;
  * the plain violation histogram against ``ub_histogram_pallas``: exact;
  * the torch and cuda ScreenFns (the latter runs its kernels' plain
    versions on CPU tensors) against the jnp and pallas ones: identical
    candidates, violation counts and survivor counts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.screen_backend import make_screen_jnp, make_screen_pallas
from repro.kernels.ops import screen_fused_ref as j_fused_ref
from repro.kernels.ops import ub_histogram_ref as j_hist_ref
from repro.kernels.screen.screen import (screen_fused_pallas,
                                         screen_scores_pallas,
                                         ub_histogram_pallas)
from repro_torch.core.screen_backend import (make_screen_cuda,
                                             make_screen_torch)
from repro_torch.kernels import ops

SHAPES = [(64, 256), (57, 513), (100, 100), (33, 1000), (128, 384)]
RTOL = 1e-12


def _t(a):
    return torch.from_numpy(np.array(a))


def _close_masked(a, b):
    a, b = np.asarray(a), np.asarray(b)
    fin = np.isfinite(b)
    np.testing.assert_allclose(a[fin], b[fin], rtol=RTOL,
                               atol=RTOL * np.abs(b[fin]).max())
    assert (a[~fin] == b[~fin]).all()


def _merge(tops, topi, h):
    """Global top-h of the tile winners, ties to the lowest position."""
    cs, pos = jax.lax.top_k(jnp.asarray(tops).reshape(-1), h)
    return np.asarray(cs), np.asarray(jnp.asarray(topi).reshape(-1)[pos])


def _problem(seed, n, p):
    r = np.random.default_rng(seed)
    X = r.normal(size=(n, p))
    theta = r.normal(size=n)
    norm = np.linalg.norm(X, axis=0)
    active = r.random(p) < 0.1
    return X, theta, norm, active


@pytest.mark.parametrize("n,p", SHAPES)
def test_fused_scan_matches_pallas(n, p):
    h, r = 16, 0.37
    X, theta, norm, active = _problem(n * 7 + p, n, p)
    s, u, lb, tops, topi, tmax = ops.screen_fused(
        _t(X), _t(theta), _t(norm), _t(active), r, h=h)
    assert ops.screen_fused.launches == 0        # CPU: the plain version
    sp, up, lp, tops_p, topi_p, tmax_p = screen_fused_pallas(
        X, theta, norm, active, r, h=h, interpret=True)
    sr, ur, lr, ts_ref, ti_ref, mu_ref = j_fused_ref(X, theta, norm, active,
                                                     r, h=h)
    for a, b, c in ((s, sp, sr), (u, up, ur), (lb, lp, lr)):
        _close_masked(a.numpy(), b)
        _close_masked(a.numpy(), c)
    cs, ci = _merge(tops.numpy(), topi.numpy(), h)
    cs_p, ci_p = _merge(tops_p, topi_p, h)
    fin = np.isfinite(np.asarray(ts_ref))
    np.testing.assert_allclose(cs[fin], np.asarray(ts_ref)[fin], rtol=RTOL)
    assert (ci[fin] == np.asarray(ti_ref)[fin]).all()
    assert (ci[fin] == ci_p[fin]).all()
    assert float(tmax.max()) == pytest.approx(float(mu_ref), rel=RTOL)
    assert float(tmax.max()) == pytest.approx(float(jnp.max(tmax_p)),
                                              rel=RTOL)
    # the unmasked mode is the reference's screen_scores
    for a, b in zip(ops.screen_scores(_t(X), _t(theta), _t(norm), r),
                    screen_scores_pallas(X.astype(np.float32),
                                         theta.astype(np.float32),
                                         norm.astype(np.float32), r,
                                         interpret=True)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4 * float(np.abs(b).max()))


def test_fused_scan_saturated_tile():
    """A fully active tile still emits distinct candidate ids, and the
    finite candidates are the global top-k's."""
    n, p, h = 32, 512, 8
    r = np.random.default_rng(5)
    X = r.normal(size=(n, p))
    theta = r.normal(size=n)
    norm = np.linalg.norm(X, axis=0)
    active = np.ones(p, bool)
    active[508:] = False                 # tile 0 saturated, 4 finite in 1
    _, _, _, tops, topi, _ = ops.screen_fused(_t(X), _t(theta), _t(norm),
                                              _t(active), 0.3, h=h)
    cs, ci = _merge(tops.numpy(), topi.numpy(), h)
    assert len(set(ci.tolist())) == h
    fin = np.isfinite(cs)
    assert sorted(ci[fin].tolist()) == [508, 509, 510, 511]
    _, _, _, ts_ref, ti_ref, _ = j_fused_ref(X, theta, norm, active, 0.3,
                                             h=h)
    assert (ci[fin] == np.asarray(ti_ref)[fin]).all()


@pytest.mark.parametrize("p,h", [(777, 12), (100, 3), (2048, 32)])
def test_histogram_exact(p, h):
    r = np.random.default_rng(p)
    ub = r.normal(size=p)
    ub[r.choice(p, p // 10, replace=False)] = -np.inf
    lb = np.abs(r.normal(size=h))
    lb[1] = lb[h - 1]                    # a tied threshold
    ub[0] = lb[1]                        # an ub exactly on a bound
    lb_sorted = np.sort(lb)
    hist = ops.ub_histogram(_t(ub), _t(lb_sorted)).numpy()
    assert ops.ub_histogram.launches == 0
    np.testing.assert_array_equal(hist, np.asarray(j_hist_ref(ub, lb_sorted)))
    hist_p = np.asarray(ub_histogram_pallas(jnp.asarray(ub),
                                            jnp.asarray(lb_sorted),
                                            interpret=True))
    # the pallas kernel pads its last tile with -inf, which only bin 0
    # (never read by the suffix counts) absorbs
    np.testing.assert_array_equal(hist[1:], hist_p[1:])
    assert hist.sum() == p


def _same_screen(out_t, out_j):
    fin = np.isfinite(np.asarray(out_j.cand_score))
    np.testing.assert_array_equal(out_t.cand_idx.numpy()[fin],
                                  np.asarray(out_j.cand_idx)[fin])
    np.testing.assert_array_equal(out_t.cand_ge.numpy(),
                                  np.asarray(out_j.cand_ge))
    assert int(out_t.n_surv) == int(out_j.n_surv)
    _close_masked(out_t.cand_score.numpy(), out_j.cand_score)
    _close_masked(out_t.cand_lb.numpy(), out_j.cand_lb)
    assert float(out_t.max_ub) == pytest.approx(float(out_j.max_ub),
                                                rel=RTOL)


@pytest.mark.parametrize("n,p", SHAPES)
def test_screen_backends_match(n, p):
    h = 16
    X, theta, norm, active = _problem(n + p, n, p)
    # scale theta so that a few scores cross 1 (ADD stop / survivors)
    theta = theta / np.quantile(np.abs(theta @ X), 0.97)
    jsc = make_screen_jnp(jnp.asarray(X), jnp.asarray(norm), h)
    psc = make_screen_pallas(jnp.asarray(X), jnp.asarray(norm), h,
                             interpret=True)
    tsc = make_screen_torch(_t(X), _t(norm), h)
    csc = make_screen_cuda(_t(X), _t(norm), h)
    for r in (0.0, 0.02, 0.3):
        rt_ = torch.tensor(r, dtype=torch.float64)
        out_j = jsc(jnp.asarray(theta), jnp.asarray(r), jnp.asarray(active))
        _same_screen(tsc(_t(theta), rt_, _t(active)), out_j)
        out_c = csc(_t(theta), rt_, _t(active))
        _same_screen(out_c, out_j)
        _same_screen(out_c, psc(jnp.asarray(theta), jnp.asarray(r),
                                jnp.asarray(active)))


@pytest.mark.parametrize("h", [3, 256])
def test_fused_scan_tied_scores_saturated_tile(h):
    """On scores that tie bit for bit (small-integer X and theta, X's
    columns drawn from 40 distinct ones; p = 777, a partial last tile), with
    a fully active tile: the serial twin's merged candidate ids are
    screen_fused_pallas's, ties to the lowest id."""
    n, p = 40, 777
    r = np.random.default_rng(22)
    base = r.integers(-3, 4, (n, 40)).astype(np.float64)
    X = base[:, r.integers(0, 40, p)]
    theta = r.integers(-2, 3, n).astype(np.float64)
    norm = np.linalg.norm(X, axis=0)
    active = r.random(p) < 0.1
    active[256:512] = True
    _, _, _, tops, topi, _ = ops.screen_fused(_t(X), _t(theta), _t(norm),
                                              _t(active), 0.2, h=h)
    _, _, _, tops_p, topi_p, _ = screen_fused_pallas(
        X, theta, norm, active, 0.2, h=h, interpret=True)
    cs, ci = _merge(tops.numpy(), topi.numpy(), h)
    cs_p, ci_p = _merge(tops_p, topi_p, h)
    fin = np.isfinite(cs_p)
    assert fin.sum() == min(h, int((~active).sum()))
    assert len(np.unique(cs[fin])) < fin.sum()           # ties among them
    np.testing.assert_array_equal(cs[fin], cs_p[fin])
    np.testing.assert_array_equal(ci[fin], ci_p[fin])
