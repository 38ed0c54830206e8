"""The port's Problem/Session API (``repro_torch.core.api``) on the CPU: the
port's edition of tests/test_api.py.

Two contracts, on the reference's CI shapes (make_regression n = 40,
p = 160, float64, ``device="cpu"``):

  * within the port, bit for bit: every cold session request equals the
    port's direct engine call (Scalar = ``saif``/``solve_scalar``, Path =
    ``run_path``, Fleet = ``fleet_solve``, CV = ``cv_solve``, Select =
    ``select_solve``, a fused Scalar or Path = the transform, the engine and
    the recovery called directly), and the legacy shims equal their
    engines;
  * against the reference's session (``repro.core.api``) on the same
    inputs: the same supports and integer outputs (outer steps, active
    counts), beta allclose (rtol 1e-6, atol 1e-8), gap <= eps and the KKT
    residual <= 1e-3 lambda.

Plus the hooks (``make_screen``, ``Fleet(screen_fn=)``, ``scan_fn``), the
warm handoff, an ``Update`` served, a group session opened, the refusals
(sharded: CV, and every kind without a mesh; a world-1 gloo mesh serves
the others bit for bit), the one-shot deprecation warnings, and the lazy
public surface in a fresh interpreter.
"""
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch as rt
from conftest import make_regression
from repro.core.api import fused as j_fused
from repro_torch.core import _compat
from repro_torch.core.api import fused, group
from test_torch_saif import _one_torch_thread  # noqa: F401
from test_torch_sharded import mesh1  # noqa: F401

EPS = 1e-7
INNER_REF = {"torch": "jnp", "gram": "gram", "cuda": "jnp"}


def _problem(seed=0, n=40, p=160):
    X, y, _ = make_regression(np.random.default_rng(seed), n=n, p=p)
    lm = float(np.abs(X.T @ y).max())
    return X, y, lm


def _support(beta, tol=1e-8):
    return set(np.flatnonzero(np.abs(np.asarray(beta)) > tol).tolist())


def _same(a, b):
    assert torch.equal(a, b)


def _same_result(a, b):
    """Two SaifResults bit for bit (every tensor field, the carry too)."""
    for f, x, y in zip(a._fields, a, b):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), f
        elif isinstance(x, tuple):
            for u, v in zip(x, y):
                assert torch.equal(u, v), f
        else:
            assert x == y, f


def _kkt(X, y, beta, lam, loss="least_squares"):
    return float(rt.kkt_residual(rt.get_loss(loss), torch.from_numpy(X),
                                 torch.from_numpy(y), beta, lam))


def _against_reference(mine, ref, X, y, lam, eps=EPS):
    assert _support(mine.beta) == _support(ref.beta)
    assert int(mine.n_outer) == int(ref.n_outer)
    assert int(mine.n_active) == int(ref.n_active)
    np.testing.assert_allclose(mine.beta.numpy(), np.asarray(ref.beta),
                               rtol=1e-6, atol=1e-8)
    assert float(mine.gap) <= eps
    assert _kkt(X, y, mine.beta, lam) <= 1e-3 * lam


def _open(X, y=None, cfg=None, **kw):
    return rt.open_session(rt.Problem(X=X, y=y), cfg or rt.SaifConfig(),
                           device="cpu", **kw)


# ---------------------------------------------------------------------------
# cold requests: bitwise the port's direct calls, and the reference's results
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("inner", ["torch", "gram", "cuda"])
@pytest.mark.parametrize("screen", ["torch", "cuda"])
def test_scalar_parity(screen, inner):
    """``cuda`` backends on CPU tensors run their kernels' plain versions."""
    X, y, lm = _problem()
    lam = 0.2 * lm
    cfg = rt.SaifConfig(eps=EPS, screen_backend=screen, inner_backend=inner)
    sess = _open(X, y, cfg)
    res = sess.solve(rt.Scalar(lam))
    _same_result(res, rt.saif(X, y, lam, cfg, device="cpu"))
    _same_result(res, rt.solve_scalar(rt.prepare_path(X, y, cfg, "cpu"),
                                      lam, cfg, device="cpu"))
    jcfg = J.SaifConfig(eps=EPS, inner_backend=INNER_REF[inner])
    ref = J.open_session(J.Problem(X=X, y=y), jcfg).solve(J.Scalar(lam))
    _against_reference(res, ref, X, y, lam)


def test_path_parity():
    X, y, lm = _problem(1)
    cfg = rt.SaifConfig(eps=EPS)
    lams = np.geomspace(0.8 * lm, 0.1 * lm, 5)
    pr = _open(X, y, cfg).solve(rt.Path(tuple(lams)))
    direct, _, _ = rt.run_path(rt.prepare_path(X, y, cfg, "cpu"), lams, cfg)
    assert (pr.lams == direct.lams).all()
    for a, b in zip(pr.results, direct.results):
        _same_result(a, b)
    ref = J.open_session(J.Problem(X=X, y=y), J.SaifConfig(eps=EPS)).solve(
        J.Path(tuple(lams)))
    for lam, r, rr in zip(lams, pr.results, ref.results):
        _against_reference(r, rr, X, y, lam)


def _fleet_problem(seed=2):
    X, y, lm = _problem(seed)
    rng = np.random.default_rng(7)
    Y = np.stack([y, X @ rng.normal(0, 0.1, X.shape[1])
                  + rng.normal(0, 1, X.shape[0])])
    lams = np.array([0.3 * lm, 0.2 * lm])
    return X, Y, lams


@pytest.mark.parametrize("inner", ["torch", "gram"])
def test_fleet_parity(inner):
    X, Y, lams = _fleet_problem()
    cfg = rt.SaifConfig(eps=1e-6, inner_backend=inner)
    res = _open(X, None, cfg).solve(rt.Fleet(Y=Y, lams=lams))   # no y
    _same_result(res, rt.fleet_solve(X, Y, lams, cfg, device="cpu"))
    ref = J.open_session(J.Problem(X=X), J.SaifConfig(
        eps=1e-6, inner_backend=INNER_REF[inner])).solve(
        J.Fleet(Y=Y, lams=lams))
    for i in range(2):
        assert _support(res.beta[i]) == _support(ref.beta[i])
        assert int(res.n_outer[i]) == int(ref.n_outer[i])
        np.testing.assert_allclose(res.beta[i].numpy(),
                                   np.asarray(ref.beta[i]), rtol=1e-6,
                                   atol=1e-8)
        assert float(res.gap[i]) <= 1e-6
        assert _kkt(X, Y[i], res.beta[i], lams[i]) <= 1e-3 * lams[i]


def test_cv_parity():
    X, y, lm = _problem(3)
    cfg = rt.SaifConfig(eps=1e-6)
    lams = tuple(np.geomspace(0.7 * lm, 0.1 * lm, 4))
    res = _open(X, y, cfg).solve(rt.CV(n_folds=3, lams=lams))
    direct = rt.cv_solve(X, y, lams, 3, cfg, device="cpu")
    np.testing.assert_array_equal(res.cv_mean, direct.cv_mean)
    np.testing.assert_array_equal(res.cv_se, direct.cv_se)
    assert res.best_lam == direct.best_lam
    _same_result(res.best_result, direct.best_result)
    ref = J.open_session(J.Problem(X=X, y=y), J.SaifConfig(eps=1e-6)).solve(
        J.CV(n_folds=3, lams=lams))
    assert res.best_lam == ref.best_lam
    np.testing.assert_allclose(res.cv_mean, ref.cv_mean, rtol=1e-8)
    _against_reference(res.best_result, ref.best_result, X, y, res.best_lam,
                       eps=1e-6)


def test_select_parity():
    X, y, lm = _problem(4, n=60)
    cfg = rt.SaifConfig(eps=1e-7)
    req = rt.Select(lams=tuple(np.geomspace(0.5, 0.05, 5) * lm), n_folds=3,
                    n_subsamples=4)
    rep = _open(X, y, cfg).solve(req)
    direct = rt.select_solve(X, y, req, cfg, device="cpu")
    assert rep.lam == direct.lam
    np.testing.assert_array_equal(rep.frequencies, direct.frequencies)
    np.testing.assert_array_equal(rep.stable_support, direct.stable_support)
    _same(rep.beta, direct.beta)
    jreq = J.Select(lams=req.lams, n_folds=3, n_subsamples=4)
    ref = J.open_session(J.Problem(X=X, y=y), J.SaifConfig(eps=1e-7)).select(
        jreq)
    assert rep.lam == ref.lam
    np.testing.assert_array_equal(rep.stable_support, ref.stable_support)
    assert _support(rep.beta) == _support(ref.beta)


def _fused_problem():
    rng = np.random.default_rng(5)
    n, p = 40, 60
    X = rng.normal(size=(n, p))
    beta = np.zeros(p)
    beta[:20] = 2.0
    beta[20:35] = -1.0
    y = X @ beta + 0.1 * rng.normal(size=n)
    return X, y, np.arange(p) - 1


def test_fused_parity():
    """A fused session transforms once at open; its Scalar and Path are
    bitwise the transform, engine and recovery called directly, and match
    the reference's fused session."""
    from repro_torch.core.fused import prepare_fused, recover_from_transformed
    X, y, parent = _fused_problem()
    cfg = rt.SaifConfig(eps=1e-8)
    sess = rt.open_session(rt.Problem(X=X, y=y, penalty=fused(parent)), cfg,
                           device="cpu")
    b1, r1 = sess.solve(rt.Scalar(4.0))
    pr1 = sess.solve(rt.Path((5.0, 3.0, 1.5)))

    design = prepare_fused(X, parent, "auto", "cpu")
    tcfg = rt.SaifConfig(eps=1e-8, unpen_idx=design.unpen_idx)
    prep = rt.prepare_path(design.Xt, torch.from_numpy(y), tcfg, "cpu")
    r0 = rt.solve_scalar(prep, 4.0, tcfg, device="cpu")
    _same_result(r1, r0)
    _same(b1, recover_from_transformed(r0.beta, design))
    pr0, _, _ = rt.run_path(prep, (5.0, 3.0, 1.5), tcfg)
    for a, b in zip(pr1.betas, pr0.betas):
        _same(a, recover_from_transformed(b, design))

    jsess = J.open_session(J.Problem(X=X, y=y, penalty=j_fused(parent)),
                           J.SaifConfig(eps=1e-8))
    jb1, jr1 = jsess.solve(J.Scalar(4.0))
    jpr1 = jsess.solve(J.Path((5.0, 3.0, 1.5)))
    np.testing.assert_allclose(b1.numpy(), np.asarray(jb1), rtol=1e-6,
                               atol=1e-6)
    assert int(r1.n_active) == int(jr1.n_active)
    for a, b in zip(pr1.betas, jpr1.betas):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


def test_weighted_scalar_rides_fleet_engine():
    X, y, lm = _problem(6)
    w = (np.random.default_rng(3).random(X.shape[0]) > 0.3).astype(float)
    cfg = rt.SaifConfig(eps=1e-6)
    sess = rt.open_session(rt.Problem(X=X, y=y, weights=w), cfg,
                           device="cpu")
    res = sess.solve(rt.Scalar(0.3 * lm))
    fl = rt.fleet_solve(X, y[None], 0.3 * lm, cfg, device="cpu",
                        weights=w[None])
    assert res.beta.ndim == 1          # the B=1 axis is dropped
    _same(res.beta, fl.beta[0])
    _same(res.gap, fl.gap[0])
    _same(res.inner.G, fl.inner.G[0])
    ref = J.open_session(J.Problem(X=X, y=y, weights=w),
                         J.SaifConfig(eps=1e-6)).solve(J.Scalar(0.3 * lm))
    assert _support(res.beta) == _support(ref.beta)
    np.testing.assert_allclose(res.beta.numpy(), np.asarray(ref.beta),
                               rtol=1e-6, atol=1e-8)
    with pytest.raises(NotImplementedError, match="warm weighted"):
        sess.solve(rt.Scalar(0.3 * lm, warm=True))
    with pytest.raises(NotImplementedError, match="weighted lambda paths"):
        sess.solve(rt.Path((0.3 * lm,)))


# ---------------------------------------------------------------------------
# a served stream: one preparation, the cold bits repeated, the warm handoff
# ---------------------------------------------------------------------------

def test_mixed_stream_served_twice(monkeypatch):
    import repro_torch.core.saif  # noqa: F401  (the module, for patching)
    saif_mod = sys.modules["repro_torch.core.saif"]
    calls = []
    real = saif_mod.prepare_path

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(saif_mod, "prepare_path", counted)

    X, y, lm = _problem(7)
    cfg = rt.SaifConfig(eps=1e-6)
    sess = _open(X, y, cfg)
    Y = np.stack([y, y[::-1].copy()])
    grid = tuple(np.geomspace(0.6 * lm, 0.15 * lm, 4))
    mix = [rt.Scalar(0.3 * lm), rt.Scalar(0.29 * lm), rt.Path(grid),
           rt.Fleet(Y=Y, lams=np.array([0.3 * lm, 0.2 * lm])),
           rt.Scalar(0.3 * lm, warm=True),
           rt.CV(n_folds=3, lams=grid, refit=False)]
    first = [sess.solve(r) for r in mix]
    assert len(calls) == 1                      # prepared once, at open
    second = [sess.solve(r) for r in mix]
    assert len(calls) == 1
    for req, a, b in zip(mix, first, second):
        if isinstance(req, rt.Scalar) and req.warm:
            continue                            # entered from other states
        if isinstance(req, rt.Path):
            for u, v in zip(a.results, b.results):
                _same_result(u, v)
        elif isinstance(req, rt.CV):
            np.testing.assert_array_equal(a.cv_mean, b.cv_mean)
        else:
            _same_result(a, b)
    stats = sess.compile_stats()
    assert stats.requests == 2 * len(mix)
    assert (stats.serial, stats.fleet, stats.group, stats.total,
            stats.since_open) == (0, 0, 0, 0, 0)
    assert rt.unified_compile_count() == 0


def test_warm_stream_matches_cold_support():
    X, y, lm = _problem(8)
    sess = _open(X, y, rt.SaifConfig(eps=EPS))
    lam = 0.25 * lm
    assert sess.warm_state is None and sess.warm_capacity is None
    cold = sess.solve(rt.Scalar(lam))
    k = sess.warm_capacity
    assert k == cold.active_idx.shape[0]
    warm = sess.solve(rt.Scalar(lam, warm=True))
    assert float(warm.gap) <= EPS
    assert _support(warm.beta, 1e-9) == _support(cold.beta, 1e-9)
    np.testing.assert_allclose(warm.beta.numpy(), cold.beta.numpy(),
                               atol=1e-6)
    # a warm Path from an installed state, as a restored checkpoint would
    state = sess.warm_state
    other = _open(X, y, rt.SaifConfig(eps=EPS))
    other.set_warm_state(state, k)
    pr = other.solve(rt.Path((lam, 0.2 * lm), warm=True))
    for r, l in zip(pr.results, pr.lams):
        assert float(r.gap) <= EPS
        assert _kkt(X, y, r.beta, l) <= 1e-3 * l


# ---------------------------------------------------------------------------
# the screen hooks
# ---------------------------------------------------------------------------

def test_make_screen_hook_serves_scalars_and_paths():
    from repro_torch.core.screen_backend import make_screen_torch
    X, y, lm = _problem(9)
    cfg = rt.SaifConfig(eps=1e-6)
    Xd = torch.from_numpy(X)
    cn = torch.linalg.vector_norm(Xd, dim=0)
    calls = []

    def hook(h):
        calls.append(h)
        return make_screen_torch(Xd, cn, h)

    sess = _open(X, y, cfg, make_screen=hook)
    res = sess.solve(rt.Scalar(0.3 * lm))
    assert calls, "make_screen hook ignored for a cold Scalar"
    _same_result(res, rt.saif(X, y, 0.3 * lm, cfg, device="cpu"))
    sess.solve(rt.Scalar(0.3 * lm))
    assert len(calls) == 1                      # memoized per h
    lams = (0.5 * lm, 0.3 * lm)
    pr = sess.solve(rt.Path(lams))
    direct, _, _ = rt.run_path(rt.prepare_path(X, y, cfg, "cpu"), lams, cfg)
    for a, b in zip(pr.results, direct.results):
        _same_result(a, b)
    # the cache skips sessions with a custom screen
    cached = _open(X, y, cfg, make_screen=hook, warm_cache=rt.WarmCache())
    cached.solve(rt.Scalar(0.3 * lm))
    assert len(cached._warm_cache) == 0


def test_scan_fn_through_make_screen_from_scan():
    X, y, lm = _problem(10)
    cfg = rt.SaifConfig(eps=1e-6)
    Xd = torch.from_numpy(X)
    seen = []

    def scan(theta):
        seen.append(1)
        return torch.abs(theta @ Xd)

    res = rt.saif(X, y, 0.3 * lm, cfg, device="cpu", scan_fn=scan)
    assert seen
    plain = rt.saif(X, y, 0.3 * lm, cfg, device="cpu")
    _same_result(res, plain)
    prep = rt.prepare_path(X, y, cfg, "cpu")
    from repro_torch.core.saif import add_batch_size_static
    h = add_batch_size_static(cfg.c, 0.3 * lm, prep.c0_max, prep.c0_median,
                              X.shape[1])
    screen = rt.make_screen_from_scan(scan, prep.col_norm, h)
    _same_result(rt.solve_scalar(prep, 0.3 * lm, cfg, device="cpu",
                                 screen_fn=screen), plain)


@pytest.mark.parametrize("parity", ["bitwise", "fast"])
def test_fleet_screen_fn_hook(parity):
    """A Fleet's own screen: called, bitwise the built-in one; under
    ``parity="fast"`` it forces the bitwise engine, as in the reference."""
    from repro_torch.core.batch import fleet_batch_sizes, prepare_fleet
    from repro_torch.core.screen_backend import make_batch_screen_torch
    X, Y, lams = _fleet_problem(11)
    cfg = rt.SaifConfig(eps=1e-6, parity=parity)
    _, h = fleet_batch_sizes(prepare_fleet(X, Y, cfg, device="cpu"),
                             lams.tolist(), cfg)
    inner = make_batch_screen_torch(torch.from_numpy(X), torch.linalg.
                                    vector_norm(torch.from_numpy(X), dim=0),
                                    h)
    calls = []

    def screen_fn(*a):
        calls.append(1)
        return inner(*a)

    res = _open(X, None, cfg).solve(rt.Fleet(Y=Y, lams=lams,
                                             screen_fn=screen_fn))
    assert calls
    bitwise = rt.fleet_solve(X, Y, lams, rt.SaifConfig(eps=1e-6),
                             device="cpu")
    if parity == "bitwise":
        _same_result(res, bitwise)
    else:
        # the fast preparation's c0, then the bitwise engine
        for i in range(2):
            assert _support(res.beta[i]) == _support(bitwise.beta[i])
            assert int(res.n_outer[i]) == int(bitwise.n_outer[i])
            assert float(res.gap[i]) <= 1e-6


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_group_penalty_opens_a_group_session():
    """A group penalty opens a group session (tests/test_torch_group.py
    holds it against the reference): a ``SaifConfig`` maps onto the group
    config, and a cold Scalar is bit for bit its direct ``group_solve``."""
    X, y, lm = _problem(12)
    assert rt.GroupPenalty(gsize=4) == group(4)
    sess = rt.open_session(rt.Problem(X=X, y=y, penalty=group(4)),
                           rt.SaifConfig(eps=1e-7), device="cpu")
    assert isinstance(sess.config, rt.GroupSaifConfig)
    assert sess.config.eps == 1e-7
    res = sess.solve(rt.Scalar(0.5 * lm))
    direct = rt.group_solve(rt.prepare_group(X, y, 4, sess.config,
                                             device="cpu"), 0.5 * lm,
                            sess.config)
    _same(res.beta, direct.beta)
    assert res.n_outer == direct.n_outer and float(res.gap) <= 1e-7


@pytest.mark.parametrize("kind", ["Scalar", "Path", "Fleet", "CV"])
def test_sharded_requests(kind, mesh1):
    """Without a mesh every kind raises (CV with the reference's
    refusal, which comes first); with a gloo mesh of one rank CV raises
    the reference's refusal, and Scalar, Path and Fleet return the
    unsharded answer bit for bit (tests/test_torch_sharded.py holds them
    at 2 and 4 ranks)."""
    X, y, lm = _problem(13)
    reqs = {"Scalar": rt.Scalar(0.3 * lm, sharded=True),
            "Path": rt.Path((0.3 * lm,), sharded=True),
            "Fleet": rt.Fleet(Y=y, lams=0.3 * lm, sharded=True),
            "CV": rt.CV(n_folds=3, lams=(0.3 * lm,), sharded=True)}
    if kind == "CV":
        for mesh in (None, mesh1):
            with pytest.raises(NotImplementedError,
                               match="sharded CV fleets: per-fold column "
                                     "norms live on the replicated path"):
                _open(X, y, mesh=mesh).solve(reqs[kind])
        return
    with pytest.raises(ValueError, match="mesh"):
        _open(X, y).solve(reqs[kind])
    sess = _open(X, y, mesh=mesh1)
    plain = {"Scalar": rt.Scalar(0.3 * lm), "Path": rt.Path((0.3 * lm,)),
             "Fleet": rt.Fleet(Y=y, lams=0.3 * lm)}[kind]
    a, b = sess.solve(plain), sess.solve(reqs[kind])
    if kind == "Path":
        assert all(torch.equal(u, v) for u, v in zip(a.betas, b.betas))
        for u, v in zip(a.results, b.results):
            _same_result(u, v)
    else:
        _same_result(a, b)


def test_update_is_served_by_the_session():
    """``solve(Update)`` and the ``update`` verb stream rows into the
    session: the warm re-solve is the reference session's, and
    ``update(rows, responses)`` re-solves at the last lambda."""
    X, y, lm = _problem(14)
    cfg = rt.SaifConfig(eps=EPS, inner_backend="gram")
    sess = _open(X, y, cfg)
    jsess = J.open_session(J.Problem(X=X, y=y),
                           J.SaifConfig(eps=EPS, inner_backend="gram"))
    lam = 0.3 * lm
    res = sess.solve(rt.Update(rows=X[:2], responses=y[:2], lam=lam))
    jres = jsess.solve(J.Update(rows=X[:2], responses=y[:2], lam=lam))
    Xs, ys = np.vstack([X, X[:2]]), np.r_[y, y[:2]]
    _against_reference(res, jres, Xs, ys, lam)
    res2 = sess.update(X[2:4], y[2:4])
    jres2 = jsess.update(X[2:4], y[2:4])
    Xs, ys = np.vstack([Xs, X[2:4]]), np.r_[ys, y[2:4]]
    _against_reference(res2, jres2, Xs, ys, lam)
    assert sess._online.filled == 44 and sess.compile_stats().requests == 2


def test_unknown_request_penalty_and_kwargs():
    with pytest.raises(TypeError, match="penalty"):
        rt.open_session(rt.Problem(X=np.eye(4), y=np.ones(4),
                                   penalty="ridge"), device="cpu")
    sess = rt.open_session(rt.Problem(X=np.eye(4), y=np.ones(4)),
                           device="cpu")
    with pytest.raises(TypeError, match="request"):
        sess.solve(("not", "a", "request"))
    with pytest.raises(TypeError, match="session kwargs"):
        rt.open_session(rt.Problem(X=np.eye(4)), device="cpu", bogus=1)
    with pytest.raises(ValueError, match="Problem.X is required"):
        rt.open_session(rt.Problem(X=None), device="cpu")
    with pytest.raises(ValueError, match="fleet-only"):
        rt.open_session(rt.Problem(X=np.eye(4)), device="cpu").solve(
            rt.Scalar(0.1))


def test_session_refuses_to_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.open_session(rt.Problem(X=np.eye(4), y=np.ones(4)))


# ---------------------------------------------------------------------------
# the legacy shims: warn once, bitwise their engines
# ---------------------------------------------------------------------------

def _shim_cases():
    X, y, lm = _problem(15)
    Xf, yf, parent = _fused_problem()
    cfg = rt.SaifConfig(eps=1e-6)
    lams = (0.5 * lm, 0.3 * lm)
    Y = np.stack([y, y[::-1].copy()])

    def fused_direct(path):
        from repro_torch.core.fused import (prepare_fused,
                                            recover_from_transformed)
        design = prepare_fused(Xf, parent, "auto", "cpu")
        tcfg = rt.SaifConfig(eps=1e-6, unpen_idx=design.unpen_idx)
        prep = rt.prepare_path(design.Xt, torch.from_numpy(yf), tcfg, "cpu")
        if path:
            pr, _, _ = rt.run_path(prep, (5.0, 2.0), tcfg)
            return [recover_from_transformed(b, design) for b in pr.betas]
        return [recover_from_transformed(
            rt.solve_scalar(prep, 4.0, tcfg, device="cpu").beta, design)]

    return {
        "saif_path": (
            lambda: rt.saif_path(X, y, lams, cfg, device="cpu").betas,
            lambda: rt.run_path(rt.prepare_path(X, y, cfg, "cpu"), lams,
                                cfg)[0].betas),
        "saif_batch": (
            lambda: [rt.saif_batch(X, Y, lams, cfg, device="cpu").beta],
            lambda: [rt.fleet_solve(X, Y, lams, cfg, device="cpu").beta]),
        "cv_path": (
            lambda: [rt.cv_path(X, y, lams, 3, cfg, device="cpu").beta],
            lambda: [rt.cv_solve(X, y, lams, 3, cfg, device="cpu").beta]),
        "saif_fused": (
            lambda: [rt.saif_fused(Xf, yf, parent, 4.0, cfg,
                                   device="cpu")[0]],
            lambda: fused_direct(False)),
        "fused_path": (
            lambda: rt.fused_path(Xf, yf, parent, (5.0, 2.0), cfg,
                                  device="cpu").betas,
            lambda: fused_direct(True)),
    }


@pytest.mark.parametrize("name", ["saif_path", "saif_batch", "cv_path",
                                  "saif_fused", "fused_path"])
def test_legacy_shims_warn_once_and_match_engines(name):
    shim, direct = _shim_cases()[name]
    _compat.reset_deprecation_warnings()
    try:
        with pytest.warns(DeprecationWarning,
                          match=r"use repro_torch\.open_session"):
            got = shim()
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            shim()                               # one-shot: silent
        assert not [w for w in rec
                    if issubclass(w.category, DeprecationWarning)
                    and "open_session" in str(w.message)]
    finally:
        _compat.reset_deprecation_warnings()
    for a, b in zip(got, direct()):
        _same(a, b)


# ---------------------------------------------------------------------------
# the lazy public surface
# ---------------------------------------------------------------------------

def test_lazy_public_surface_subprocess():
    code = (
        "import sys\n"
        "from repro_torch import (Problem, Scalar, Path, Fleet, CV, Update,\n"
        "    Select, SelectionReport, WarmCache, WarmCacheConfig,\n"
        "    ScreenRule, resolve_screen_rule, open_session, fused, group)\n"
        "light = {'repro_torch', 'repro_torch.core', "
        "'repro_torch.core.api', 'repro_torch.core.serving', "
        "'repro_torch.core.screen_rule', 'repro_torch.core.online', "
        "'repro_torch.core.select', 'repro_torch.core.warm_cache'}\n"
        "p = Problem(X=[[1.0, 2.0], [3.0, 4.0]], y=[1.0, 2.0])\n"
        "Problem(X=None)\n"
        "Scalar(0.5); Path((0.5, 0.1)); CV(n_folds=3, lams=(0.5,))\n"
        "Fleet(Y=[[1.0, 2.0]], lams=0.5)\n"
        "Update(rows=[[1.0, 2.0]], responses=[1.0])\n"
        "sel = Select(lams=(0.5, 0.1), n_subsamples=4)\n"
        "assert sel.rule == '1se' and SelectionReport._fields\n"
        "rule = resolve_screen_rule('hybrid')\n"
        "assert isinstance(rule, ScreenRule) and rule.post_check\n"
        "cache = WarmCache(WarmCacheConfig(capacity=2, band=2.0))\n"
        "assert len(cache) == 0 and cache.stats().hits == 0\n"
        "fused([-1, 0]); group(2)\n"
        "heavy = [m for m in sys.modules if m.startswith('repro_torch')\n"
        "         and m not in light]\n"
        "assert not heavy, f'engine modules imported: {heavy}'\n"
        "assert 'torch' not in sys.modules, 'torch imported eagerly'\n"
        "assert not [m for m in sys.modules if m == 'jax' or "
        "m.startswith('repro.')]\n"
        "import repro_torch\n"
        "assert callable(repro_torch.saif) and 'torch' in sys.modules\n"
        "print('ok')\n"
    )
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(rt.__file__), os.pardir)
    env["PYTHONPATH"] = os.path.abspath(src)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "ok" in out.stdout


def test_core_saif_is_the_function():
    import repro_torch.core as core
    import repro_torch.core.saif  # noqa: F401  (load the submodule)
    from repro_torch.core import saif
    from repro_torch.core.saif import saif as saif_fn
    assert saif is saif_fn and core.saif is saif_fn
    from repro_torch.core import fused as fused_module
    assert hasattr(fused_module, "prepare_fused")      # the submodule
    assert rt.fused is fused and callable(rt.group)
    assert "fused" not in core.__all__ and "fused" in rt.__all__
    for name in core.__all__:
        assert getattr(core, name) is not None, name
    for name in rt.__all__:
        assert getattr(rt, name) is not None, name
