"""The port's async serving front end (``repro_torch.core.server``) on the
CPU: the port's edition of tests/test_server.py, on the same problems and
scripts, with ``device="cpu"``.

Against the reference's server on the same script: the bucket picks and
keys, the stats (all but ``stragglers``, which depend on timing), each
rider's verdict flags and events, and its supports with betas allclose.
Within the port: coalesced riders are bit for bit the port's serial
session solves. Every wait is bounded (``result(timeout=...)``) and every
server is closed in a ``finally`` by :func:`_close`, whose join of the
worker is bounded too, so a hung worker fails its test instead of
holding the suite. The reference's
``test_deprecated_solve_deadline_kwarg_warns_once`` has no counterpart:
the port's ``solve`` takes no ``deadline_s``.
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import repro_torch as rt
from conftest import make_regression
from repro.core import api as J
from repro.core import server as JSrv
from repro.core.saif import SaifConfig as JConfig
from repro.core.serving import ServingConfig as JServingConfig
from repro.runtime.inject import FaultInjector as JInjector
from repro_torch.core import server as S
from repro_torch.kernels import _build
from repro_torch.runtime.inject import FaultInjector
from test_torch_saif import _one_torch_thread  # noqa: F401

WAIT = 120          # seconds: the bound on every wait


def _data(seed, n=60, p=37):
    X, y, _ = make_regression(np.random.default_rng(seed), n=n, p=p,
                              uniform=False)
    return X, y


def _close(srv):
    """``srv.close()`` with a bound: stop the worker, wait for it at most
    WAIT seconds (a hung worker fails the test), then close."""
    t = srv._thread
    with srv._cond:
        srv._stop = True
        srv._cond.notify_all()
    if t is not None:
        t.join(WAIT)
        assert not t.is_alive(), "the server's worker hung"
    srv.close()


def _stats(st):
    """Stats without the timing-dependent field."""
    d = st._asdict()
    d.pop("stragglers")
    return d


def _serve_both(script, cfg):
    """Run ``script(server, mod)`` through the port's server and the
    reference's, each opened with its dispatcher off (the script starts
    it with ``run(timeout=0)``, after its submissions where they must
    coalesce); returns (results, stats) of each."""
    out = []
    for mod, make, kw in ((rt, rt.open_server, {"device": "cpu"}),
                          (J, JSrv.open_server, {})):
        srv = make(autostart=False, **cfg(mod), **kw)
        try:
            res = script(srv, mod)
            srv.drain(timeout=WAIT)
        finally:
            _close(srv)
        out.append((res, srv.stats()))
    return out


def _port_cfg(mod, **kw):
    return dict(solver=(rt.SaifConfig() if mod is rt else JConfig()), **kw)


# ---------------------------------------------------------------------------
# bucketing and identity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid", [None, (16, 64, 256), (100,)])
def test_pick_bucket_and_keys_equal_reference(grid):
    for v in (1, 2, 3, 7, 8, 9, 37, 64, 65, 100, 101, 1000, 100_000):
        for floor in (1, 8):
            assert S._pick_bucket(v, grid, floor) == \
                JSrv._pick_bucket(v, grid, floor)
        assert S._next_pow2(v) == JSrv._next_pow2(v)
    cfg = dict(p_buckets=grid, n_buckets=grid)
    mine = rt.open_server(autostart=False, device="cpu", **cfg)
    ref = JSrv.open_server(autostart=False, **cfg)
    try:
        for n, p in ((40, 24), (60, 37), (17, 200), (3, 1)):
            X, y = _data(n * p, n=n, p=p)
            for kw in ({}, {"weights": np.ones(n)},
                       {"loss": "logistic", "y": np.sign(y) + (y == 0)}):
                yy = kw.pop("y", y)
                pm, pj = rt.Problem(X=X, y=yy, **kw), J.Problem(X=X, y=yy,
                                                                **kw)
                req, jreq = rt.Scalar(0.1), J.Scalar(0.1)
                assert mine._bucket_key(pm, req) == ref._bucket_key(pj, jreq)
                assert mine._coalescible(pm, req) == \
                    ref._coalescible(pj, jreq)
                assert mine._digest(pm) == ref._digest(pj)
        assert _stats(mine.stats()) == _stats(ref.stats())
    finally:
        _close(mine)
        _close(ref)


def test_design_digest_memo_hashes_a_design_once(monkeypatch):
    """B riders with their own responses over one design object hash that
    design once; the digests are the reference's, and a tensor design
    hashes as its numpy array."""
    X, y = _data(1)
    Xt = torch.from_numpy(X)
    calls = []
    real = S._host

    def counted(a):
        calls.append(a is X or a is Xt)
        return real(a)
    monkeypatch.setattr(S, "_host", counted)
    srv = rt.open_server(autostart=False, device="cpu")
    try:
        ys = [y + i for i in range(4)]
        keys = [srv._bucket_key(rt.Problem(X=Xt, y=torch.from_numpy(yy)),
                                rt.Scalar(0.1)) for yy in ys]
        assert len(set(keys)) == 1 and sum(calls) == 1
        full = [srv._digest(rt.Problem(X=Xt, y=torch.from_numpy(yy)))
                for yy in ys]
        assert sum(calls) == 1
        for yy, d in zip(ys, full):
            assert d == JSrv._problem_digest(J.Problem(X=X, y=yy))
        assert keys[0][0] == JSrv._problem_digest(J.Problem(X=X, y=y),
                                                  design_only=True)
    finally:
        _close(srv)


# ---------------------------------------------------------------------------
# coalescing
# ---------------------------------------------------------------------------

def test_server_coalesces_and_matches_direct_bitwise():
    X, y = _data(12345)
    lams = [0.09, 0.06, 0.045, 0.03]

    def script(srv, mod):
        pb = mod.Problem(X=X, y=y)
        futs = [srv.submit(pb, mod.Scalar(lam)) for lam in lams]
        srv.run(timeout=0)
        return [f.result(timeout=WAIT) for f in futs]
    (res, st), (jres, jst) = _serve_both(
        script, cfg=lambda mod: _port_cfg(mod, max_batch=8,
                                          max_wait_ms=100.0))
    assert st.served == 4 and st.coalesced_batches == 1
    assert _stats(st) == _stats(jst)
    direct = rt.open_session(rt.Problem(X=X, y=y), rt.SaifConfig(),
                             device="cpu")
    for lam, r, jr in zip(lams, res, jres):
        assert r.verdict.ok and jr.verdict.ok
        assert r.verdict.unit_ok == jr.verdict.unit_ok == (True,)
        d = direct.solve(rt.Scalar(lam))
        assert torch.equal(r.value.beta, d.beta)
        assert torch.equal(r.value.gap, d.gap)
        assert int(r.value.n_outer) == d.n_outer
        jb = np.asarray(jr.value.beta)
        np.testing.assert_array_equal(np.flatnonzero(r.value.beta.numpy()),
                                      np.flatnonzero(jb))
        np.testing.assert_allclose(r.value.beta.numpy(), jb, rtol=1e-6,
                                   atol=1e-9)


def test_server_coalesces_cross_user_same_design():
    """Different users (their own Problem, y and lambda) over ONE design
    coalesce into one fleet, each rider the bits of its own direct solve;
    a padded batch (3 riders -> 4) duplicates rider 0."""
    X, y0 = _data(7)
    rng = np.random.default_rng(8)
    ys = [y0 + rng.normal(0, 0.3, size=y0.shape) for _ in range(3)]
    lams = (0.09, 0.06, 0.03)

    def script(srv, mod):
        futs = [srv.submit(mod.Problem(X=X, y=yu), mod.Scalar(lam))
                for yu, lam in zip(ys, lams)]
        srv.run(timeout=0)
        return [f.result(timeout=WAIT) for f in futs]
    (res, st), (jres, jst) = _serve_both(
        script, cfg=lambda mod: _port_cfg(mod, max_batch=8,
                                          max_wait_ms=100.0))
    assert st.coalesced_requests == 3 and st.sessions_opened == 1
    assert _stats(st) == _stats(jst)
    for yu, lam, r, jr in zip(ys, lams, res, jres):
        assert r.verdict.ok
        d = rt.open_session(rt.Problem(X=X, y=yu), rt.SaifConfig(),
                            device="cpu").solve(rt.Scalar(lam))
        assert torch.equal(r.value.beta, d.beta)
        assert torch.equal(r.value.gap, d.gap)
        np.testing.assert_allclose(r.value.beta.numpy(),
                                   np.asarray(jr.value.beta), rtol=1e-6,
                                   atol=1e-9)


def test_priority_orders_dispatch():
    """With the dispatcher started late, the priority-5 request on a
    second design is served before the priority-0 one submitted first
    (the done callbacks record the order)."""
    (X1, y1), (X2, y2) = _data(21, 40, 24), _data(22, 40, 24)
    srv = rt.open_server(autostart=False, max_wait_ms=0.0,
                         solver=rt.SaifConfig(), device="cpu")
    order = []
    try:
        f1 = srv.submit(rt.Problem(X=X1, y=y1), rt.Scalar(0.05, priority=0))
        f2 = srv.submit(rt.Problem(X=X2, y=y2), rt.Scalar(0.05, priority=5))
        f1.add_done_callback(lambda f: order.append("p0"))
        f2.add_done_callback(lambda f: order.append("p5"))
        srv.run(timeout=0.1)        # starts the dispatcher, returns
        for f in (f1, f2):
            assert f.result(timeout=WAIT).verdict.ok
        assert order == ["p5", "p0"]
        late = []
        f2.add_done_callback(lambda f: late.append(f is f2))
        assert late == [True]       # an already-resolved future calls back
    finally:
        _close(srv)


def test_future_timeout_and_deadline_in_the_queue():
    X, y = _data(31, 40, 24)
    fut = rt.ServingFuture()
    with pytest.raises(rt.DeadlineExceeded):
        fut.result(timeout=0.01)
    with pytest.raises(rt.DeadlineExceeded):
        fut.exception(timeout=0.01)
    srv = rt.open_server(autostart=False, solver=rt.SaifConfig(),
                         device="cpu")
    try:
        f = srv.submit(rt.Problem(X=X, y=y), rt.Scalar(0.05,
                                                       deadline_s=0.02))
        time.sleep(0.05)            # expires in the queue, dispatcher off
        srv.run(timeout=0.2)
        exc = f.exception(timeout=WAIT)
        assert isinstance(exc, rt.DeadlineExceeded)
        st = srv.stats()
        assert st.deadline_misses == 1 and st.failed == 1
        assert st.sessions_opened == 0      # nothing ran for it
        with pytest.raises(rt.RequestError, match="deadline_s"):
            srv.submit(rt.Problem(X=X, y=y), rt.Scalar(0.1, deadline_s=-3))
    finally:
        _close(srv)
    with pytest.raises(rt.RequestError, match="closed"):
        srv.submit(rt.Problem(X=X, y=y), rt.Scalar(0.1))


def test_close_rejects_the_queue():
    X, y = _data(32, 40, 24)
    srv = rt.open_server(autostart=False, solver=rt.SaifConfig(),
                         device="cpu")
    f = srv.submit(rt.Problem(X=X, y=y), rt.Scalar(0.05))
    srv._start()
    _close(srv)
    assert f.done()
    if f.exception(timeout=WAIT) is not None:
        assert isinstance(f.exception(), rt.RequestError)
    st = srv.stats()
    assert st.served + st.failed == 1 and st.pending == 0


# ---------------------------------------------------------------------------
# the session LRU
# ---------------------------------------------------------------------------

def test_lru_eviction_readmission_equals_reference(monkeypatch):
    """Two problems of one shape ping-pong through an LRU of one: every
    request reopens a session (its preparation once) and evicts the other;
    the counts are the reference's, and no kernel is built."""
    probs = [_data(41), _data(42)]
    saif_mod = sys.modules["repro_torch.core.saif"]
    real = saif_mod.prepare_path
    prepares = []

    def counted(*a, **k):
        prepares.append(1)
        return real(*a, **k)

    def no_kernel(*a, **k):
        raise AssertionError("a kernel was built")
    monkeypatch.setattr(saif_mod, "prepare_path", counted)
    monkeypatch.setattr(_build, "build", no_kernel)
    monkeypatch.setattr(_build, "library", no_kernel)

    def script(srv, mod):
        pbs = [mod.Problem(X=X, y=y) for X, y in probs]
        srv.run(timeout=0)
        for pb in pbs:
            srv.submit(pb, mod.Scalar(0.05)).result(timeout=WAIT)
        opened0 = srv.stats().sessions_opened
        n0 = len(prepares)
        out = []
        for pb in (pbs[0], pbs[1], pbs[0]):
            out.append(srv.submit(pb, mod.Scalar(0.05)).result(
                timeout=WAIT).verdict.ok)
        return out, opened0, len(prepares) - n0
    (res, st), (jres, jst) = _serve_both(
        script, cfg=lambda mod: _port_cfg(mod, max_sessions=1,
                                          max_wait_ms=0.0))
    assert res[0] == jres[0] == [True] * 3
    assert res[1] == jres[1] == 2
    assert st.sessions_opened == res[1] + 3 and st.evictions == 4
    assert res[2] == 3                   # one preparation per readmission
    assert _stats(st) == _stats(jst)


def test_tripped_session_stays_and_refuses(monkeypatch):
    """A session whose breaker opened on the card stays in the LRU and
    rejects its riders with its BackendFault: it is never re-opened. (The
    card is faked by the session's device; the launch error is
    ``_build``'s.)"""
    X, y = _data(51, 40, 24)
    pb = rt.Problem(X=X, y=y)
    srv = rt.open_server(max_wait_ms=0.0, solver=rt.SaifConfig(),
                         serving=rt.ServingConfig(backoff_base_s=0.0),
                         device="cpu")
    try:
        assert srv.submit(pb, rt.Scalar(0.05)).result(
            timeout=WAIT).verdict.ok
        (sess,) = srv._lru.values()
        monkeypatch.setattr(sess.session, "device", torch.device("cuda"))

        def launch_fails(req):
            _build.check(700, "screen_fused")
        monkeypatch.setattr(sess.session, "solve", launch_fails)
        e1 = srv.submit(pb, rt.Scalar(0.04)).exception(timeout=WAIT)
        e2 = srv.submit(pb, rt.Scalar(0.03)).exception(timeout=WAIT)
        assert isinstance(e1, rt.BackendFault) and "retries" in str(e1)
        assert isinstance(e2, rt.BackendFault) and "breaker is open" in \
            str(e2)
        st = srv.stats()
        assert st.sessions_opened == 1 and st.failed == 2
        assert list(srv._lru.values()) == [sess] and sess.breaker_open
    finally:
        _close(srv)


def test_dispatch_failure_reaches_every_rider_and_the_loop_lives(
        monkeypatch):
    X, y = _data(61, 40, 24)
    srv = rt.open_server(autostart=False, max_wait_ms=50.0,
                         solver=rt.SaifConfig(), device="cpu")
    real = srv._dispatch_coalesced
    calls = []

    def once(sess, batch):
        calls.append(len(batch))
        if len(calls) == 1:
            raise RuntimeError("boom")
        return real(sess, batch)
    monkeypatch.setattr(srv, "_dispatch_coalesced", once)
    try:
        pb = rt.Problem(X=X, y=y)
        futs = [srv.submit(pb, rt.Scalar(lam)) for lam in (0.05, 0.04)]
        srv.run(timeout=0.05)
        for f in futs:
            e = f.exception(timeout=WAIT)
            assert isinstance(e, RuntimeError) and str(e) == "boom"
        assert srv.submit(pb, rt.Scalar(0.05)).result(
            timeout=WAIT).verdict.ok
        st = srv.stats()
        assert (st.failed, st.served) == (2, 1) and calls == [2, 1]
    finally:
        _close(srv)


# ---------------------------------------------------------------------------
# chaos: one poisoned rider
# ---------------------------------------------------------------------------

def _poisoned(mod, inj, X, y, lams, poisoned, ladder):
    serving = (rt.ServingConfig if mod is rt else JServingConfig)(
        max_retries=0, **({} if ladder else {"ladder": ()}))
    kw = {"device": "cpu"} if mod is rt else {}
    srv = (rt.open_server if mod is rt else JSrv.open_server)(
        max_batch=8, max_wait_ms=500.0, autostart=False, serving=serving,
        solver=rt.SaifConfig() if mod is rt else JConfig(), **kw)
    try:
        pb = mod.Problem(X=X, y=y)
        futs = [srv.submit(pb, mod.Scalar(lam)) for lam in lams]
        with inj(nan_at={1}, nan_unit=poisoned, tags={"fleet"}) as i:
            srv.run(timeout=0.05)
            results = [f.result(timeout=WAIT) for f in futs]
        srv.drain(timeout=WAIT)
    finally:
        _close(srv)
    return results, i.log, srv.stats()


def test_poisoned_rider_is_contained():
    X, y = _data(71)
    lams = [0.09, 0.06, 0.045, 0.03]
    res, log, st = _poisoned(rt, FaultInjector, X, y, lams, 2, False)
    jres, jlog, jst = _poisoned(J, JInjector, X, y, lams, 2, False)
    assert log == jlog and _stats(st) == _stats(jst)
    direct = rt.open_session(rt.Problem(X=X, y=y), rt.SaifConfig(),
                             device="cpu")
    for i, (lam, r, jr) in enumerate(zip(lams, res, jres)):
        v, jv = r.verdict, jr.verdict
        assert (v.ok, v.degraded, v.unit_ok, v.unit_degraded, v.events) == \
            (jv.ok, jv.degraded, jv.unit_ok, jv.unit_degraded, jv.events)
        if i == 2:
            assert not v.ok and "nonfinite" in v.events
        else:
            assert v.ok and v.unit_ok == (True,)
            assert torch.equal(r.value.beta,
                               direct.solve(rt.Scalar(lam)).beta)


def test_poisoned_rider_recovered_by_the_ladder():
    X, y = _data(72, 40, 24)
    lams = [0.08, 0.05]
    res, log, st = _poisoned(rt, FaultInjector, X, y, lams, 0, True)
    jres, jlog, jst = _poisoned(J, JInjector, X, y, lams, 0, True)
    assert log == jlog and _stats(st) == _stats(jst)
    for r, jr in zip(res, jres):
        v, jv = r.verdict, jr.verdict
        assert (v.ok, v.degraded, v.unit_ok, v.unit_degraded, v.events,
                [(g.name, g.ok) for g in v.rungs]) == \
            (jv.ok, jv.degraded, jv.unit_ok, jv.unit_degraded, jv.events,
             [(g.name, g.ok) for g in jv.rungs])
        np.testing.assert_allclose(r.value.beta.numpy(),
                                   np.asarray(jr.value.beta), rtol=1e-6,
                                   atol=1e-9)
    assert res[0].verdict.ok and res[0].verdict.degraded
    assert res[1].verdict.ok and not res[1].verdict.degraded


# ---------------------------------------------------------------------------
# the config surface
# ---------------------------------------------------------------------------

def test_grid_fallback_and_pad_to_refused():
    X, y = _data(81, 40, 24)

    def script(srv, mod):
        f = srv.submit(mod.Problem(X=X, y=y), mod.Scalar(0.05))
        srv.run(timeout=0)
        return f.result(timeout=WAIT).verdict.ok
    (ok, st), (jok, jst) = _serve_both(
        script, cfg=lambda mod: _port_cfg(mod, p_buckets=(16,),
                                          max_wait_ms=0.0))
    assert ok and jok and st.bucket_fallbacks == 1   # p = 24 > 16
    assert _stats(st) == _stats(jst)
    with pytest.raises(TypeError, match="pad_to"):
        rt.open_server(pad_to=(64, 64), device="cpu")
    with pytest.raises(TypeError, match="unknown session kwargs"):
        rt.open_server(bogus=1)


def test_surface_and_lazy_import():
    import dataclasses
    for name in ("open_server", "Server", "ServerConfig", "ServerStats",
                 "ServingFuture"):
        assert getattr(rt, name) is getattr(S, name)
        assert getattr(rt.core, name) is getattr(S, name)
    assert set(S.__all__) == set(JSrv.__all__)
    assert rt.ServerStats._fields == JSrv.ServerStats._fields
    # the reference's options in its order, but for cache_dir (ROADMAP
    # section C: the port compiles nothing per shape)
    jfields = [f.name for f in dataclasses.fields(JSrv.ServerConfig)]
    jfields.remove("cache_dir")
    assert [f.name for f in dataclasses.fields(rt.ServerConfig)] == jfields
    code = ("import sys\n"
            "from repro_torch import (open_server, ServerConfig,\n"
            "    ServingFuture, Update, online_compile_count)\n"
            "ServerConfig(max_batch=4); ServingFuture()\n"
            "assert online_compile_count() == 0\n"
            "assert 'torch' not in sys.modules\n"
            "assert not [m for m in sys.modules if m == 'jax' or "
            "m.startswith('repro.')]\n"
            "print('ok')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(
        os.path.join(os.path.dirname(rt.__file__), os.pardir))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "ok" in out.stdout
