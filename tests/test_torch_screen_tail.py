"""K2's tail entry (``screen_tail``, ``screen_tail_batch``) on the CPU, where
it runs its plain twin, float64:

  * after the port's K1 / K1b twins and the tile merge, against the
    reference's ``make_screen_pallas`` / ``make_batch_screen_pallas``
    (interpret mode): candidate ids, violation counts and survivors
    exact, bounds and max ub at rtol 1e-12; the fleet with shared and
    with per-problem column norms;
  * bit for bit the eager tail the ``cuda`` screens ran before K2 took it
    over (``_glue`` below), and equal to the counts by their definition,
    on inputs with ties among the bounds, ub exactly on a bound, -inf ub
    (active columns), a NaN ub, +inf bounds (padding candidates, id >= p),
    p = 777 (not a multiple of 256) and h from 1 to 1024;
  * the batch twin equal to B serial twins, with shared and with
    per-problem norms; CPU tensors launch nothing.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.screen_backend import (make_batch_screen_pallas,
                                       make_screen_pallas)
from repro_torch.kernels import ops

RTOL = 1e-12
SHAPES = [(64, 256), (57, 513), (33, 1000)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _close_masked(a, b):
    a, b = np.asarray(a), np.asarray(b)
    fin = np.isfinite(b)
    np.testing.assert_allclose(a[fin], b[fin], rtol=RTOL,
                               atol=RTOL * np.abs(b[fin]).max())
    assert (a[~fin] == b[~fin]).all()


def _same_bits(outs, refs):
    for a, b in zip(outs, refs):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.is_floating_point():
            nan = torch.isnan(b)
            assert torch.equal(torch.isnan(a), nan)
            assert torch.equal(a[~nan].view(torch.int64),
                               b[~nan].view(torch.int64))
        else:
            assert torch.equal(a, b)


def _glue(ub, tmax, cand_score, cand_idx, col_norm, r):
    """The serial ``cuda`` screen's eager tail before K2 took it over."""
    p = ub.shape[0]
    cand_lb = torch.abs(cand_score -
                        col_norm[torch.clamp(cand_idx, max=p - 1)] * r)
    lb_sorted = torch.sort(cand_lb).values
    hist = ops.ub_histogram(ub, lb_sorted)
    suffix = torch.cumsum(hist.flip(-1), -1).flip(-1)
    pos = torch.searchsorted(lb_sorted, cand_lb, right=False)
    cand_ge = torch.gather(suffix, -1, torch.clamp(
        pos + 1, max=hist.shape[-1] - 1)).to(torch.int32)
    return (torch.max(tmax), cand_lb, cand_ge,
            torch.sum(ub >= 1.0, dtype=torch.int32))


def _merged(outs, h):
    """The tile merge of the ``cuda`` screens: each problem's top-h tile
    winners (score, int64 id), ties to the lowest position."""
    tops, topi = outs[3], outs[4]
    m = tops.shape[0]
    vals, pos = torch.sort(tops.reshape(m, -1), dim=1, descending=True,
                           stable=True)
    return vals[:, :h], torch.gather(topi.reshape(m, -1), 1,
                                     pos[:, :h]).long()


def _edges(seed, b, h, per_problem, p=777):
    """Tail inputs (ub (b, p), tmax, scores, ids, norms, r) with every edge
    at once: -inf ub, a NaN ub, tied candidates, a padding candidate (score
    -inf, id >= p: bound +inf), ub exactly on two bounds (one of them +inf
    when h = 3)."""
    rng = np.random.default_rng(seed + h)
    ub = 2.0 * rng.normal(size=(b, p))
    ub[rng.random((b, p)) < 0.1] = -np.inf
    ub[:, 5] = np.nan
    score = np.abs(rng.normal(size=(b, h)))
    idx = rng.integers(0, p, (b, h))
    if h > 1:
        score[:, 1], idx[:, 1] = score[:, 0], idx[:, 0]
        score[:, h - 1], idx[:, h - 1] = -np.inf, p + 3
    cn = np.abs(rng.normal(size=(b, p) if per_problem else (p,)))
    r = rng.uniform(0.0, 0.5, b)
    cn_b = cn if per_problem else np.broadcast_to(cn, (b, p))
    lb = np.abs(score - np.take_along_axis(cn_b, np.minimum(idx, p - 1), 1)
                * r[:, None])
    ub[:, 7] = lb[:, 0]
    ub[:, 9] = lb[:, min(2, h - 1)]
    pb = -(-p // 256)
    pad = np.full((b, pb * 256 - p), -np.inf)
    tmax = np.concatenate([ub, pad], 1).reshape(b, pb, 256).max(2)
    return _t(ub), _t(tmax), _t(score), _t(idx), _t(cn), _t(r)


def _by_definition(ub, tmax, cand_lb):
    """max ub, #{i : ub_i >= lb_l} per candidate and #{i : ub_i >= 1}."""
    u, lb = ub.numpy(), cand_lb.numpy()
    ge = np.array([(u >= v).sum() for v in lb], dtype=np.int32)
    return np.max(tmax.numpy()), ge, int((u >= 1.0).sum())


@pytest.mark.parametrize("n,p", SHAPES)
def test_tail_twin_matches_reference_screen(n, p):
    h = 16
    r0 = np.random.default_rng(n + p)
    X = r0.normal(size=(n, p))
    norm = np.linalg.norm(X, axis=0)
    active = r0.random(p) < 0.1
    theta = r0.normal(size=n)
    theta = theta / np.quantile(np.abs(theta @ X), 0.97)
    psc = make_screen_pallas(jnp.asarray(X), jnp.asarray(norm), h,
                             interpret=True)
    for r in (0.0, 0.02, 0.3):
        rt_ = torch.tensor(r, dtype=torch.float64)
        outs = ops.screen_fused(_t(X), _t(theta), _t(norm), _t(active), rt_,
                                h=h)
        sc, ix = _merged([o[None] for o in outs], h)
        max_ub, lb, ge, ns = ops.screen_tail(outs[1], outs[5], sc[0], ix[0],
                                             _t(norm), rt_)
        out_j = psc(jnp.asarray(theta), jnp.asarray(r), jnp.asarray(active))
        fin = np.isfinite(np.asarray(out_j.cand_score))
        np.testing.assert_array_equal(ix[0].numpy()[fin],
                                      np.asarray(out_j.cand_idx)[fin])
        np.testing.assert_array_equal(ge.numpy(), np.asarray(out_j.cand_ge))
        assert int(ns) == int(out_j.n_surv)
        _close_masked(lb.numpy(), out_j.cand_lb)
        assert float(max_ub) == pytest.approx(float(out_j.max_ub), rel=RTOL)
    assert ops.ub_histogram.launches == 0


@pytest.mark.parametrize("per_problem", [False, True])
def test_tail_batch_twin_matches_reference_fleet_screen(per_problem):
    n, p, b, h = 57, 513, 3, 16
    r0 = np.random.default_rng(5)
    X = r0.normal(size=(n, p))
    if per_problem:              # each problem's own norms, as a weighted fleet
        W = r0.uniform(0.0, 2.0, (b, n))
        norm = np.sqrt(W @ (X * X))
    else:
        norm = np.linalg.norm(X, axis=0)
    active = r0.random((b, p)) < 0.1
    Theta = r0.normal(size=(b, n))
    Theta = Theta / np.quantile(np.abs(Theta @ X), 0.97, axis=1)[:, None]
    radii = np.array([0.0, 0.02, 0.3])
    outs = ops.screen_fused_batch(_t(X), _t(Theta), _t(norm), _t(active),
                                  _t(radii), h=h)
    sc, ix = _merged(outs, h)
    max_ub, lb, ge, ns = ops.screen_tail_batch(outs[1], outs[5], sc, ix,
                                               _t(norm), _t(radii))
    psc = make_batch_screen_pallas(jnp.asarray(X), jnp.asarray(norm), h,
                                   interpret=True)
    out_j = psc(jnp.asarray(Theta), jnp.asarray(radii), jnp.asarray(active),
                jnp.ones(b, bool))
    for i in range(b):
        fin = np.isfinite(np.asarray(out_j.cand_score[i]))
        np.testing.assert_array_equal(ix[i].numpy()[fin],
                                      np.asarray(out_j.cand_idx[i])[fin])
        np.testing.assert_array_equal(ge[i].numpy(),
                                      np.asarray(out_j.cand_ge[i]))
        assert int(ns[i]) == int(out_j.n_surv[i])
        _close_masked(lb[i].numpy(), out_j.cand_lb[i])
        assert float(max_ub[i]) == pytest.approx(float(out_j.max_ub[i]),
                                                 rel=RTOL)
    assert ops.ub_histogram_batch.launches == 0


@pytest.mark.parametrize("h", [1, 3, 12, 16, 64, 256, 1024])
def test_tail_twin_bitwise_the_eager_tail(h):
    ub, tmax, sc, ix, cn, r = _edges(41, 1, h, False)
    args = (ub[0], tmax[0], sc[0], ix[0], cn, r[0])
    out = ops.screen_tail(*args)
    _same_bits(out, _glue(*args))
    mx, ge, ns = _by_definition(ub[0], tmax[0], out[1])
    assert np.isnan(float(out[0])) and np.isnan(mx)      # the NaN ub's tile
    np.testing.assert_array_equal(out[2].numpy(), ge)
    assert int(out[3]) == ns
    if h > 1:
        assert float(out[1][h - 1]) == np.inf           # the padding lane
        assert int(out[2][0]) == int(out[2][1])          # tied bounds
    assert ops.ub_histogram.launches == 0


@pytest.mark.parametrize("per_problem", [False, True])
@pytest.mark.parametrize("h", [3, 64])
def test_tail_batch_twin_equals_serial_twins(h, per_problem):
    b = 4
    ub, tmax, sc, ix, cn, r = _edges(43, b, h, per_problem)
    out = ops.screen_tail_batch(ub, tmax, sc, ix, cn, r)
    for i in range(b):
        one = ops.screen_tail(ub[i], tmax[i], sc[i], ix[i],
                              cn[i] if per_problem else cn, r[i])
        _same_bits([o[i] for o in out], one)
        mx, ge, ns = _by_definition(ub[i], tmax[i], one[1])
        np.testing.assert_array_equal(one[2].numpy(), ge)
        assert int(one[3]) == ns
    # a strided score buffer (a prefix of each row of the merge's sort)
    wide = torch.cat([sc, torch.zeros(b, 5, dtype=sc.dtype)], 1)
    _same_bits(ops.screen_tail_batch(ub, tmax, wide[:, :h], ix, cn, r), out)
    assert ops.ub_histogram_batch.launches == 0
