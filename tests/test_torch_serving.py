"""The port's fault-tolerant serving runtime (``repro_torch.core.serving``)
on the CPU: the port's edition of tests/test_serving_chaos.py and of the
serving cases of tests/test_fault.py, on the same seeds, streams and
fault schedules, with ``device="cpu"``.

For every request the contract is exactly one of: a ``ServingResult``
whose verdict is ok (and whose value then passes an independent KKT check
here), a ``ServingResult`` with a failed verdict that carries its ladder
trail, or a typed ``ServingError``. Against the reference's runtime on the
same inputs and schedules: the injector's log, each request's outcome
class, ``verdict.ok``, its events, its rungs (name and ok), ``unit_ok`` and
``unit_degraded`` are equal, and ok values are allclose (rtol 1e-8) with
the same support. One deliberate difference (ROADMAP section C): the
breaker pins the port's backends to ``"torch"``, where the reference pins
them to ``"jnp"``, so its event reads ``breaker_open:..=torch``.
"""
import dataclasses
import sys

import numpy as np
import pytest
import torch

import repro_torch as rt
from conftest import kkt_violation, make_regression
from repro.core import api as J
from repro.core import serving as JS
from repro.core.losses import get_loss as j_loss
from repro.core.saif import SaifConfig as JConfig
from repro.runtime.inject import FaultInjector as JInjector
from repro_torch.core import serving as S
from repro_torch.core.api import fused, group
from repro_torch.kernels import _build
from repro_torch.runtime.fault import PreemptionGuard
from repro_torch.runtime.inject import FaultInjector
from test_torch_saif import _one_torch_thread  # noqa: F401

EPS = 1e-7
LS = rt.get_loss("least_squares")


def _problem(rng, n=40, p=120):
    X, y, _ = make_regression(rng, n=n, p=p)
    return X, y, float(np.abs(X.T @ y).max())


def _stream(mod, lmax, y, rng):
    """The reference chaos suite's mixed stream, in package ``mod``."""
    return [
        mod.Scalar(0.3 * lmax),
        mod.Scalar(0.2 * lmax, warm=True),
        mod.Path([0.5 * lmax, 0.3 * lmax, 0.2 * lmax]),
        mod.Scalar(0.3 * lmax),
        mod.Fleet(Y=np.stack([y, y + 0.05 * rng.normal(size=y.shape)]),
                  lams=0.3 * lmax),
        mod.Scalar(0.2 * lmax, warm=True),
    ]


def _serve(X, y, cfg=None, **kw):
    return rt.open_serving(rt.Problem(X=X, y=y), cfg or rt.SaifConfig(
        eps=EPS), device="cpu", **kw)


def _support(beta, tol=1e-8):
    return set(np.flatnonzero(np.abs(np.asarray(beta)) > tol).tolist())


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


def _betas(value):
    """A served value's coefficient vectors (one per unit)."""
    if hasattr(value, "betas"):
        return [np.asarray(b) for b in value.betas]
    beta = np.asarray(value.beta)
    return list(beta) if beta.ndim == 2 else [beta]


def _kkt(X, y, beta, lam):
    return float(rt.kkt_residual(LS, torch.as_tensor(X),
                                 torch.as_tensor(y), torch.as_tensor(beta),
                                 lam))


# ---------------------------------------------------------------------------
# the happy path: certification changes no bit
# ---------------------------------------------------------------------------

def test_happy_path_bitwise_a_plain_session():
    X, y, lmax = _problem(np.random.default_rng(11))
    prob = rt.Problem(X=X, y=y)
    cfg = rt.SaifConfig(eps=EPS)
    plain = rt.open_session(prob, cfg, device="cpu")
    srv = rt.open_serving(prob, cfg, device="cpu")
    stream = _stream(rt, lmax, y, np.random.default_rng(0))
    for rnd in range(2):
        for req in stream:
            want, got = plain.solve(req), srv.solve(req)
            v = got.verdict
            assert v.ok and v.converged and not v.degraded, (rnd, req)
            assert v.retries == 0 and not v.rungs and v.events == ()
            assert v.kkt_residual <= v.kkt_tol and v.kkt_check_ms > 0.0
            if isinstance(req, rt.Path):
                assert len(v.unit_ok) == 3
                for a, b in zip(want.results, got.value.results):
                    _same_result(a, b)
            else:
                _same_result(want, got.value)
    st = srv.stats()
    assert st.requests == 12 and st.degraded == 0 and st.retries == 0
    assert not st.breaker_open and not st.restored
    assert srv.compile_stats().total == 0


# ---------------------------------------------------------------------------
# the chaos sweep against the reference
# ---------------------------------------------------------------------------

# (the port's screen, inner) -> the reference's
GRID = {("torch", "torch"): ("jnp", "jnp"), ("torch", "gram"): ("jnp", "gram"),
        ("auto", "auto"): ("auto", "auto")}
# the reference suite's schedule, then two NaN-heavy ones that walk the
# ladder
SCHEDULES = [(2024, 0.18, 0.12), (2, 0.2, 0.4), (3, 0.2, 0.4)]


def _chaos(which, screen, inner, schedule):
    """Serve the mixed stream under a seeded schedule; returns the
    injector's log, each request's outcome and the served values."""
    X, y, lmax = _problem(np.random.default_rng(11))
    seed, p_fail, p_nan = schedule
    if which == "port":
        srv = _serve(X, y, rt.SaifConfig(eps=EPS, screen_backend=screen,
                                         inner_backend=inner),
                     serving=rt.ServingConfig(backoff_base_s=0.0))
        mod, inj, err = rt, FaultInjector, rt.ServingError
    else:
        srv = JS.open_serving(J.Problem(X=X, y=y), JConfig(
            eps=EPS, screen_backend=screen, inner_backend=inner),
            serving=JS.ServingConfig(backoff_base_s=0.0))
        mod, inj, err = J, JInjector, JS.ServingError
    inj = inj.from_seed(seed, n_calls=40, p_fail=p_fail, p_nan=p_nan)
    outcomes, values = [], []
    stream = _stream(mod, lmax, y, np.random.default_rng(1))
    with inj:
        for req in stream:
            try:
                out = srv.solve(req)
            except err as e:
                outcomes.append(("typed", type(e).__name__))
                values.append(None)
                continue
            v = out.verdict
            outcomes.append((
                "ok" if v.ok else "degraded_verdict", v.events,
                tuple((r.name, r.ok) for r in v.rungs), v.unit_ok,
                v.unit_degraded))
            values.append(_betas(out.value) if v.ok else None)
    return inj.log, outcomes, values, (X, y, stream)


def _as_reference_events(events):
    """The deliberate difference: the port's breaker pins "torch"."""
    return tuple(e.replace("=torch", "=jnp") if e.startswith("breaker_open")
                 else e for e in events)


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("screen,inner", list(GRID))
def test_chaos_sweep_equals_reference(screen, inner, schedule):
    log, outs, vals, (X, y, stream) = _chaos("port", screen, inner, schedule)
    jlog, jouts, jvals, _ = _chaos("ref", *GRID[(screen, inner)], schedule)
    assert log and log == jlog
    breaker = False
    for req, out, jout, val, jval in zip(stream, outs, jouts, vals, jvals):
        if out[0] != "typed":
            breaker |= any(e.startswith("breaker_open") for e in out[1])
            out = (out[0], _as_reference_events(out[1]), *out[2:])
            if out[0] == "degraded_verdict":
                assert out[1] and out[2]     # never silent: the trail
        assert out == jout, req
        if val is None:
            continue
        # green verdict: the reference's values, then certified here
        lams = ([float(req.lam)] if isinstance(req, rt.Scalar) else
                [float(l) for l in req.lams] if isinstance(req, rt.Path)
                else [float(req.lams)] * 2)
        ys = [y, y] if not isinstance(req, rt.Fleet) else list(req.Y)
        assert len(val) == len(jval) == len(lams)
        for b, jb, lam, yy in zip(val, jval, lams, ys):
            assert _support(b) == _support(jb)
            np.testing.assert_allclose(b, jb, rtol=1e-8, atol=1e-12)
            assert np.all(np.isfinite(b))
            assert kkt_violation(j_loss("least_squares"), X, yy, b, lam) \
                <= max(1e-3 * lam, 1e-8)
    assert any(o[0] == "ok" for o in outs)
    if schedule != SCHEDULES[0] and (screen, inner) != ("torch", "torch"):
        assert breaker      # the NaN-heavy schedules trip it here


# ---------------------------------------------------------------------------
# the failure cases
# ---------------------------------------------------------------------------

def test_nan_storm_every_result_still_certified():
    """Every engine call poked: the screening-free oracle rung still
    delivers a KKT-certified solution (the reference's result), the warm
    state is scrubbed, and the next warm request is clean."""
    X, y, lmax = _problem(np.random.default_rng(11), n=30, p=80)
    srv = _serve(X, y)
    lam = 0.25 * lmax
    with FaultInjector(nan_at=set(range(1, 30))) as inj:
        out = srv.solve(rt.Scalar(lam))
    v = out.verdict
    assert v.ok and v.degraded and srv.stats().degraded == 1
    assert [(r.name, r.ok) for r in v.rungs] == [("grow", False),
                                                 ("oracle", True)]
    assert "warm_state_reset" in v.events and "degraded:oracle" in v.events
    assert v.unit_degraded == (True,) and v.unit_ok == (True,)
    assert _kkt(X, y, out.value.beta, lam) <= 1e-3 * lam
    res = out.value
    assert res.n_active == int((res.beta != 0).sum())
    assert torch.equal(res.active_idx[res.active_mask],
                       torch.nonzero(res.beta).flatten())
    assert bool((res.active_idx[~res.active_mask] == -1).all())
    jsrv = JS.open_serving(J.Problem(X=X, y=y), JConfig(eps=EPS))
    with JInjector(nan_at=set(range(1, 30))) as jinj:
        jout = jsrv.solve(J.Scalar(lam))
    assert inj.log == jinj.log and v.events == jout.verdict.events
    np.testing.assert_allclose(res.beta.numpy(), np.asarray(jout.value.beta),
                               rtol=1e-8, atol=1e-12)
    out2 = srv.solve(rt.Scalar(lam, warm=True))
    assert out2.verdict.ok and not out2.verdict.degraded


@pytest.mark.parametrize("screen,inner,pinned", [
    ("auto", "auto", "inner_backend=torch,screen_backend=torch"),
    ("cuda", "cuda", "inner_backend=torch,screen_backend=torch"),
    ("torch", "gram", "inner_backend=torch"),
    ("torch", "torch", None)])
def test_breaker_pins_the_plain_path(screen, inner, pinned):
    """Exhausted retries open the breaker: every backend that is not
    "torch" is pinned to it for the session's life, recorded in the
    verdict and in stats(); with nothing left to pin, the fault is a
    typed BackendFault."""
    X, y, lmax = _problem(np.random.default_rng(11), n=30, p=80)
    srv = _serve(X, y, rt.SaifConfig(eps=EPS, screen_backend=screen,
                                     inner_backend=inner),
                 serving=rt.ServingConfig(backoff_base_s=0.0))
    if pinned is None:
        with FaultInjector(fail_at={1, 2, 3}):
            with pytest.raises(rt.BackendFault, match="retries exhausted"):
                srv.solve(rt.Scalar(0.3 * lmax))
        assert not srv.breaker_open and srv.stats().retries == 0
        return
    with FaultInjector(fail_at={1, 2, 3}) as inj:
        out = srv.solve(rt.Scalar(0.3 * lmax))
    v = out.verdict
    assert v.ok and v.retries == 2 and inj.calls == 4
    assert v.events[:4] == ("retry:1:RuntimeError", "retry:2:RuntimeError",
                            "backend_fault", "breaker_open:" + pinned)
    assert srv.breaker_open and srv.stats().breaker_open
    cfg = srv.session.config
    assert cfg.screen_backend == "torch" and cfg.inner_backend == "torch"
    _same_result(out.value, rt.saif(X, y, 0.3 * lmax, cfg, device="cpu"))
    out2 = srv.solve(rt.Scalar(0.2 * lmax))     # still pinned, still ok
    assert out2.verdict.ok and srv.breaker_open
    with FaultInjector(fail_at=set(range(1, 12))):
        with pytest.raises(rt.BackendFault, match="breaker already open"):
            srv.solve(rt.Scalar(0.3 * lmax))


def test_breaker_on_a_card_raises_and_refuses(monkeypatch):
    """On a card the breaker never pins the plain path: exhausted retries
    open it with a typed BackendFault, recorded in stats(), the session
    and its backends untouched, and every later request is refused before
    anything runs. (A deliberate difference from the reference, whose
    breaker pins "jnp" on any device; ROADMAP section C.) The card is
    faked by the session's device; the launch error is ``_build``'s."""
    X, y, lmax = _problem(np.random.default_rng(11), n=30, p=80)
    srv = _serve(X, y, rt.SaifConfig(eps=EPS, screen_backend="auto",
                                     inner_backend="auto"),
                 serving=rt.ServingConfig(backoff_base_s=0.0))
    sess = srv.session
    monkeypatch.setattr(sess, "device", torch.device("cuda"))
    calls = []

    def launch_fails(req):
        calls.append(req)
        _build.check(700, "screen_fused")
    monkeypatch.setattr(sess, "solve", launch_fails)
    with pytest.raises(rt.BackendFault, match="retries exhausted"):
        srv.solve(rt.Scalar(0.3 * lmax))
    assert len(calls) == 3
    assert srv.breaker_open and srv.stats().breaker_open
    assert srv.stats().retries == 0     # the request never completed
    assert srv.session is sess
    assert (sess.config.screen_backend, sess.config.inner_backend) == \
        ("auto", "auto")
    with pytest.raises(rt.BackendFault, match="breaker is open"):
        srv.solve(rt.Scalar(0.2 * lmax))
    assert len(calls) == 3 and srv.session is sess


def test_deadline_is_typed():
    X, y, lmax = _problem(np.random.default_rng(11), n=30, p=80)
    srv = _serve(X, y)
    srv.solve(rt.Scalar(0.3 * lmax))
    with FaultInjector(fail_at={1, 2, 3}, delay_at={1, 2, 3},
                       delay_s=0.2):
        with pytest.raises(rt.DeadlineExceeded):
            srv.solve(rt.Scalar(0.3 * lmax, deadline_s=0.05))
    # the session's default budget, when the request sets none
    srv = _serve(X, y, serving=rt.ServingConfig(deadline_s=0.05))
    with FaultInjector(fail_at={1, 2, 3}, delay_at={1, 2, 3},
                       delay_s=0.2):
        with pytest.raises(TimeoutError):
            srv.solve(rt.Scalar(0.3 * lmax))


def test_strict_raises_a_failed_verdict():
    X, y, lmax = _problem(np.random.default_rng(11), n=30, p=80)
    srv = _serve(X, y, serving=rt.ServingConfig(strict=True,
                                                ladder=("x64",)))
    with FaultInjector(nan_at={1}):
        with pytest.raises(rt.NumericalError, match="ladder"):
            srv.solve(rt.Scalar(0.3 * lmax))
    out = srv.solve(rt.Scalar(0.3 * lmax))      # clean: served
    assert out.verdict.ok


def test_x64_rung_recasts_a_float32_problem():
    """torch has no x64 switch: the rung runs whenever X or y is not
    float64 (ROADMAP section C), and is skipped when both are."""
    X, y, lmax = _problem(np.random.default_rng(11), n=30, p=80)
    X32, y32 = X.astype(np.float32), y.astype(np.float32)
    cfg = rt.SaifConfig(eps=1e-5)
    srv = rt.open_serving(rt.Problem(X=X32, y=y32), cfg,
                          serving=rt.ServingConfig(ladder=("x64",)),
                          device="cpu")
    with FaultInjector(nan_at={1}) as inj:
        out = srv.solve(rt.Scalar(0.3 * lmax))
    v = out.verdict
    assert inj.calls == 2 and v.ok and v.degraded
    assert [(r.name, r.ok) for r in v.rungs] == [("x64", True)]
    assert out.value.beta.dtype == torch.float64
    _same_result(out.value, rt.saif(X32.astype(np.float64),
                                    y32.astype(np.float64), 0.3 * lmax, cfg,
                                    device="cpu"))
    srv64 = _serve(X, y, serving=rt.ServingConfig(ladder=("x64",)))
    with FaultInjector(nan_at={1}):
        out = srv64.solve(rt.Scalar(0.3 * lmax))
    assert not out.verdict.ok and "ladder_exhausted" in out.verdict.events
    assert [(r.name, r.ok, r.note) for r in out.verdict.rungs] == [
        ("x64", False, "skipped")]


# ---------------------------------------------------------------------------
# the request kinds
# ---------------------------------------------------------------------------

def test_fused_requests_get_verdicts():
    """The reference suite's chain problem (n = 30, p = 64) at 0.5 and 0.3
    fused lambda_max, where the chain's CM converges (at its lambda = 2,
    0.001 lambda_max, both packages crawl to max_outer)."""
    rng = np.random.default_rng(11)
    X, y, _ = make_regression(rng, n=30, p=64)
    parent = np.arange(-1, 63)                  # chain tree
    lm = rt.fused_lambda_max(X, y, parent, device="cpu")
    lam, lams = 0.3 * lm, [0.5 * lm, 0.3 * lm]
    fsrv = rt.open_serving(rt.Problem(X=X, y=y, penalty=fused(parent)),
                           rt.SaifConfig(eps=EPS), device="cpu")
    out = fsrv.solve(rt.Scalar(lam))
    assert out.verdict.ok and out.verdict.kkt_residual <= 1e-3 * lam
    beta_rec, res = out.value
    assert bool(torch.isfinite(beta_rec).all())
    outp = fsrv.solve(rt.Path(lams))
    assert outp.verdict.ok and len(outp.value.betas) == 2
    assert outp.verdict.unit_ok == (True, True)
    jsrv = JS.open_serving(J.Problem(X=X, y=y, penalty=J.fused(parent)),
                           JConfig(eps=EPS))
    for mine, req in ((out, J.Scalar(lam)), (outp, J.Path(lams))):
        ref = jsrv.solve(req).verdict
        assert (mine.verdict.ok, mine.verdict.events, mine.verdict.unit_ok) \
            == (ref.ok, ref.events, ref.unit_ok)
    # a poked fused Scalar: the oracle on the transformed design (b
    # unpenalized), recovered to node space
    fsrv2 = rt.open_serving(rt.Problem(X=X, y=y, penalty=fused(parent)),
                            rt.SaifConfig(eps=EPS), device="cpu",
                            serving=rt.ServingConfig(ladder=("oracle",)))
    with FaultInjector(nan_at={1}):
        out2 = fsrv2.solve(rt.Scalar(lam))
    assert out2.verdict.ok and out2.verdict.degraded
    assert _support(out2.value[1].beta) == _support(res.beta)
    np.testing.assert_allclose(out2.value[0].numpy(), beta_rec.numpy(),
                               rtol=1e-4, atol=1e-6)
    # a poked fused Path: the grow rung re-solves it, and only the poked
    # lambda owes its value to the ladder
    with FaultInjector(nan_at={2}) as inj:
        out3 = fsrv.solve(rt.Path(lams))
    assert inj.log == [(2, "path", "nan")]
    v = out3.verdict
    assert v.ok and v.degraded and v.unit_degraded == (False, True)
    assert [(r.name, r.ok) for r in v.rungs] == [("grow", True)]
    for a, b in zip(out3.value.path.results, outp.value.path.results):
        assert _support(a.beta) == _support(b.beta)


def test_weighted_scalar_cv_and_select_verdicts():
    X, y, lmax = _problem(np.random.default_rng(11), n=36, p=90)
    w = np.random.default_rng(5).uniform(0.5, 2.0, size=36)
    srv = rt.open_serving(rt.Problem(X=X, y=y, weights=w),
                          rt.SaifConfig(eps=EPS), device="cpu")
    out = srv.solve(rt.Scalar(0.3 * lmax))
    assert out.verdict.ok and out.verdict.kkt_residual <= out.verdict.kkt_tol
    jsrv = JS.open_serving(J.Problem(X=X, y=y, weights=w), JConfig(eps=EPS))
    jout = jsrv.solve(J.Scalar(0.3 * lmax))
    assert out.verdict.events == jout.verdict.events
    np.testing.assert_allclose(out.value.beta.numpy(),
                               np.asarray(jout.value.beta), rtol=1e-8,
                               atol=1e-12)
    # a poked weighted Scalar: the oracle on the sqrt-weight rescaling
    srvw = rt.open_serving(rt.Problem(X=X, y=y, weights=w),
                           rt.SaifConfig(eps=EPS), device="cpu",
                           serving=rt.ServingConfig(ladder=("oracle",)))
    with FaultInjector(nan_at={1}) as inj:
        outw = srvw.solve(rt.Scalar(0.3 * lmax))
    assert inj.log == [(1, "fleet", "nan")]
    assert outw.verdict.ok and outw.verdict.degraded
    assert _support(outw.value.beta) == _support(out.value.beta)

    srv2 = _serve(X, y)
    req = rt.CV(n_folds=3, lams=[0.5 * lmax, 0.3 * lmax])
    outcv = srv2.solve(req)
    assert outcv.verdict.ok and outcv.verdict.unit_ok == (True,)
    jcv = JS.open_serving(J.Problem(X=X, y=y), JConfig(eps=EPS)).solve(
        J.CV(n_folds=3, lams=[0.5 * lmax, 0.3 * lmax])).verdict
    assert (outcv.verdict.ok, outcv.verdict.events) == (jcv.ok, jcv.events)
    scores = srv2.solve(rt.CV(n_folds=3, lams=[0.5 * lmax, 0.3 * lmax],
                              refit=False))
    assert scores.verdict.ok and scores.verdict.kkt_residual == 0.0
    # the refit is the serial seam's only call: poke it, the oracle
    # re-solves at the chosen lambda
    srv3 = _serve(X, y, serving=rt.ServingConfig(ladder=("oracle",)))
    with FaultInjector(nan_at={1}) as inj:
        outcv3 = srv3.solve(req)
    assert inj.log == [(1, "serial", "nan")]
    assert outcv3.verdict.ok and outcv3.verdict.degraded
    assert _support(outcv3.value.beta) == _support(outcv.value.beta)

    sel = rt.Select(lams=[0.5 * lmax, 0.3 * lmax, 0.2 * lmax], n_folds=3,
                    stability=False)
    outs = srv2.solve(sel)
    assert outs.verdict.ok and outs.verdict.unit_ok == (True,)
    with FaultInjector(nan_at={1}):
        outs3 = srv3.solve(sel)
    assert outs3.verdict.ok and outs3.verdict.degraded
    assert _support(outs3.value.beta) == _support(outs.value.beta)


@pytest.mark.parametrize("ladder", [("grow", "oracle", "x64"), ("oracle",)])
def test_fleet_nan_unit_degrades_that_unit_only(ladder):
    X, y, lmax = _problem(np.random.default_rng(11))
    Y = np.stack([y, y + 0.05 * np.random.default_rng(1).normal(size=40),
                  y - X[:, 3]])
    srv = _serve(X, y, serving=rt.ServingConfig(ladder=ladder))
    clean = srv.solve(rt.Fleet(Y=Y, lams=0.3 * lmax)).value
    with FaultInjector(nan_at={1}, nan_unit=1) as inj:
        out = srv.solve(rt.Fleet(Y=Y, lams=0.3 * lmax))
    v = out.verdict
    assert inj.log == [(1, "fleet", "nan")]
    assert v.ok and v.degraded
    assert v.unit_degraded == (False, True, False)
    assert v.unit_ok == (True, True, True)
    assert v.rungs[0].name == ladder[0] and v.rungs[0].ok
    for b in (0, 2):
        assert torch.equal(out.value.beta[b], clean.beta[b])
    assert _support(out.value.beta[1]) == _support(clean.beta[1])
    assert _kkt(X, Y[1], out.value.beta[1], 0.3 * lmax) <= 1e-3 * 0.3 * lmax
    jsrv = JS.open_serving(J.Problem(X=X, y=y), JConfig(eps=EPS),
                           serving=JS.ServingConfig(ladder=ladder))
    with JInjector(nan_at={1}, nan_unit=1):
        jv = jsrv.solve(J.Fleet(Y=Y, lams=0.3 * lmax)).verdict
    assert (v.events, v.unit_ok, v.unit_degraded) == (
        jv.events, jv.unit_ok, jv.unit_degraded)
    assert [(r.name, r.ok) for r in v.rungs] == [(r.name, r.ok)
                                                 for r in jv.rungs]


def test_provenance_fast_fleet_and_screen_rule():
    X, y, lmax = _problem(np.random.default_rng(11))
    Y = np.stack([y, y + X[:, 1]])
    srv = _serve(X, y, rt.SaifConfig(eps=EPS, parity="fast",
                                     screen_dtype="float32"))
    v = srv.solve(rt.Fleet(Y=Y, lams=0.3 * lmax)).verdict
    assert v.ok and (v.parity, v.screen_dtype, v.screen_rule) == (
        "fast", "float32", "saif")
    srv = _serve(X, y, rt.SaifConfig(eps=EPS, screen_rule="gap_safe"))
    v = srv.solve(rt.Scalar(0.3 * lmax)).verdict
    assert v.ok and (v.parity, v.screen_dtype, v.screen_rule) == (
        "bitwise", "working", "gap_safe")


# ---------------------------------------------------------------------------
# refusals: typed, unretried, never the breaker
# ---------------------------------------------------------------------------

def test_group_session_opens_and_is_served():
    """A group problem opens through ``open_serving`` and its Scalar and
    Path are served gap-certified (no scalar KKT), with no retry and the
    breaker shut (tests/test_torch_group.py holds the values against the
    reference)."""
    X, y, lmax = _problem(np.random.default_rng(11), n=30, p=64)
    srv = rt.open_serving(rt.Problem(X=X, y=y, penalty=group(8)),
                          rt.GroupSaifConfig(eps=1e-6), device="cpu")
    for req in (rt.Scalar(2.0), rt.Scalar(1.5, warm=True),
                rt.Path([4.0, 2.0])):
        v = srv.solve(req).verdict
        assert v.ok and not v.degraded and not v.rungs
        assert v.kkt_residual == 0.0 and v.gap <= 1e-6
    assert srv.stats().retries == 0 and not srv.breaker_open


def test_group_and_update_refusals():
    X, y, lmax = _problem(np.random.default_rng(11), n=30, p=64)
    gsrv = rt.open_serving(rt.Problem(X=X, y=y, penalty=group(8)),
                           device="cpu")
    # what a group session does not serve is a typed refusal, unretried
    for req, msg in ((rt.Update(rows=X[:2], responses=y[:2]),
                      "plain-LASSO sessions"),
                     (rt.Fleet(Y=np.stack([y, y]), lams=1.0),
                      "group fleets")):
        with pytest.raises(NotImplementedError, match=msg):
            gsrv.solve(req)
    assert gsrv.stats().retries == 0 and not gsrv.breaker_open
    srv = _serve(X, y)
    # an Update is served; with no lambda anywhere it is a typed refusal
    with pytest.raises(rt.RequestError, match="first resolving update"):
        srv.solve(rt.Update(rows=X[:2], responses=y[:2]))
    assert srv.stats().retries == 0 and not srv.breaker_open
    out = srv.solve(rt.Update(rows=X[2:4], responses=y[2:4],
                              lam=0.3 * lmax))
    v = out.verdict
    assert v.ok and not v.degraded and not v.rungs and v.unit_ok == (True,)
    assert v.kkt_residual <= v.kkt_tol
    Xs, ys = np.vstack([X, X[:4]]), np.r_[y, y[:4]]
    assert _kkt(Xs, ys, out.value.beta, 0.3 * lmax) <= v.kkt_tol
    # resolve=False ingests only: nothing to certify
    v = srv.solve(rt.Update(rows=X[4:6], responses=y[4:6],
                            resolve=False)).verdict
    assert v.ok and v.unit_ok is None and srv.session._online.filled == 36
    assert srv.stats().retries == 0 and not srv.breaker_open


# ---------------------------------------------------------------------------
# streamed sessions: certified on the resident rows
# ---------------------------------------------------------------------------

def _stream_problem(seed=0, n0=40, p=120, k=5, noise=0.1):
    """tests/test_online.py's stream."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n0, p))
    beta = np.zeros(p)
    beta[:k] = rng.uniform(0.8, 1.6, k)
    y = X @ beta + noise * rng.normal(size=n0)
    return X, y, beta, rng


def test_streamed_scalar_is_certified_on_the_resident_rows():
    """The reference certifies a streamed session's Scalar against the
    ORIGINAL design: it fails KKT and its grow rung re-opens the original
    problem, whose answer it serves as ok (degraded), 0.09 away from the
    cold solve of the streamed rows. The port certifies the resident rows:
    ok with no rung, the cold concatenated solve's answer (ROADMAP
    section C)."""
    X, y, bt, rng = _stream_problem(seed=0)
    lam = 0.2 * float(np.abs(X.T @ y).max())
    Xn = rng.normal(size=(8, X.shape[1]))
    yn = Xn @ bt + 0.1 * rng.normal(size=8)
    Xs, ys = np.vstack([X, Xn]), np.r_[y, yn]
    cfg = dict(eps=1e-8, inner_backend="gram")
    jsrv = JS.open_serving(J.Problem(X=X, y=y), JConfig(**cfg))
    jsrv.solve(J.Update(rows=Xn, responses=yn, lam=lam))
    jout = jsrv.solve(J.Scalar(lam))
    srv = _serve(X, y, rt.SaifConfig(**cfg))
    srv.solve(rt.Update(rows=Xn, responses=yn, lam=lam))
    out = srv.solve(rt.Scalar(lam))
    cold = rt.open_session(rt.Problem(X=Xs, y=ys), rt.SaifConfig(**cfg),
                           device="cpu").solve(rt.Scalar(lam))
    jv, v = jout.verdict, out.verdict
    assert jv.ok and jv.degraded
    assert jv.events == ("kkt_violation", "warm_state_reset",
                         "degraded:grow")
    jerr = float(np.abs(np.asarray(jout.value.beta) - cold.beta.numpy())
                 .max())
    assert 0.09 < jerr < 0.1
    assert v.ok and not v.degraded and not v.rungs and v.events == ()
    b = out.value.beta.numpy()
    assert _support(b) == _support(cold.beta)
    np.testing.assert_allclose(b, cold.beta.numpy(), rtol=0, atol=1e-6)
    assert _kkt(Xs, ys, b, lam) <= 1e-3 * lam
    # a Path too, and the grow / x64 rungs never re-open the original
    pr = srv.solve(rt.Path([0.3 * lam / 0.2, lam]))
    assert pr.verdict.ok and not pr.verdict.rungs
    assert srv._rung_grow(rt.Scalar(lam)) is None
    assert srv._rung_x64(rt.Path([lam])) is None


def test_update_ladder_equals_reference():
    """NaN poked into an Update's re-solve: the grow rung is skipped (it
    would replay the rows on the original problem), the oracle re-solves
    the resident rows (K7's twin here) and certifies; the events, rungs
    and unit flags are the reference's, the value its value."""
    X, y, bt, rng = _stream_problem(seed=1)
    lam = 0.25 * float(np.abs(X.T @ y).max())
    Xn = rng.normal(size=(8, X.shape[1]))
    yn = Xn @ bt + 0.1 * rng.normal(size=8)
    srv = _serve(X, y)
    jsrv = JS.open_serving(J.Problem(X=X, y=y), JConfig(eps=EPS))
    srv.solve(rt.Scalar(lam))
    jsrv.solve(J.Scalar(lam))
    with FaultInjector(nan_at={1}) as inj:
        out = srv.solve(rt.Update(rows=Xn, responses=yn))
    with JInjector(nan_at={1}) as jinj:
        jout = jsrv.solve(J.Update(rows=Xn, responses=yn))
    v, jv = out.verdict, jout.verdict
    assert inj.log == jinj.log == [(1, "path", "nan")]
    assert v.ok and v.degraded
    assert v.events == jv.events and "warm_state_reset" in v.events
    assert [(r.name, r.ok, r.note) for r in v.rungs] == \
        [(r.name, r.ok, r.note) for r in jv.rungs] == \
        [("grow", False, "skipped"), ("oracle", True, "")]
    assert (v.unit_ok, v.unit_degraded) == (jv.unit_ok, jv.unit_degraded)
    np.testing.assert_allclose(out.value.beta.numpy(),
                               np.asarray(jout.value.beta), rtol=1e-8,
                               atol=1e-12)
    Xs, ys = np.vstack([X, Xn]), np.r_[y, yn]
    assert _kkt(Xs, ys, out.value.beta, lam) <= 1e-3 * lam
    assert srv.session.warm_state is None       # scrubbed
    assert srv.solve(rt.Scalar(lam, warm=True)).verdict.ok


def test_update_retry_applies_the_rows_once():
    """A transient fault in an Update's re-solve retries the re-solve
    only: the rows are in once, the answer is the unfaulted stream's.
    (The reference's retry replays the whole Update and applies the rows
    twice; ROADMAP section C.) A persistent one opens the breaker as a
    typed BackendFault: a streaming session is never re-opened from the
    original problem."""
    X, y, bt, rng = _stream_problem(seed=2)
    lam = 0.25 * float(np.abs(X.T @ y).max())
    Xn = rng.normal(size=(8, X.shape[1]))
    yn = Xn @ bt + 0.1 * rng.normal(size=8)
    sc = rt.ServingConfig(backoff_base_s=0.0)
    want = _serve(X, y).solve(rt.Update(rows=Xn, responses=yn, lam=lam))
    srv = _serve(X, y, serving=sc)
    with FaultInjector(fail_at={1}) as inj:
        out = srv.solve(rt.Update(rows=Xn, responses=yn, lam=lam))
    assert inj.log == [(1, "path", "fail")] and out.verdict.retries == 1
    assert srv.session._online.filled == 48
    assert srv.session._online.updates == 1
    _same_result(out.value, want.value)
    jsrv = JS.open_serving(J.Problem(X=X, y=y), JConfig(eps=EPS),
                           serving=JS.ServingConfig(backoff_base_s=0.0))
    with JInjector(fail_at={1}):
        jsrv.solve(J.Update(rows=Xn, responses=yn, lam=lam))
    assert jsrv.session._online.filled == 56        # the rows twice
    with FaultInjector(fail_at={1, 2, 3}):
        with pytest.raises(rt.BackendFault, match="retries exhausted"):
            srv.solve(rt.Scalar(lam))
    assert srv.breaker_open and srv.session._online.filled == 48
    with pytest.raises(rt.BackendFault, match="breaker is open"):
        srv.solve(rt.Scalar(lam))


def test_kernel_build_error_passes_up_unretried(monkeypatch, tmp_path):
    """A kernel that fails to build is not a transient fault: it leaves
    ``solve`` on its first attempt, and the breaker stays closed (no
    plain-path fallback hides a broken kernel). A launch-time
    RuntimeError, by contrast, is retried."""
    X, y, lmax = _problem(np.random.default_rng(11), n=30, p=80)
    srv = _serve(X, y, serving=rt.ServingConfig(backoff_base_s=0.0))
    # _build's own raise: nvcc hidden, nothing built yet
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    calls = []

    def broken(req):
        calls.append(req)
        return _build.library("screen")
    monkeypatch.setattr(srv.session, "solve", broken)
    with pytest.raises(_build.KernelBuildError, match="nvcc"):
        srv.solve(rt.Scalar(0.3 * lmax))
    assert len(calls) == 1
    assert issubclass(_build.KernelBuildError, RuntimeError)
    st = srv.stats()
    assert st.retries == 0 and not st.breaker_open and not srv.breaker_open

    def launch_fails(req):
        calls.append(req)
        _build.check(700, "screen_fused")
    monkeypatch.setattr(srv.session, "solve", launch_fails)
    out = srv.solve(rt.Scalar(0.3 * lmax))  # the breaker's fresh session
    assert len(calls) == 1 + 3              # 3 attempts, then the breaker
    assert out.verdict.ok and out.verdict.retries == 2 and srv.breaker_open
    assert "breaker_open:inner_backend=torch,screen_backend=torch" in \
        out.verdict.events


# ---------------------------------------------------------------------------
# warm checkpoints
# ---------------------------------------------------------------------------

def _ckpt_problem(seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(30, 80))
    y = X[:, 0] - X[:, 3] + 0.1 * rng.normal(size=30)
    return X, y


def test_serving_checkpoint_restore_resumes_warm(tmp_path):
    """SIGTERM drill: solve warm, checkpoint through the PreemptionGuard
    path, restart (a fresh ServingSession on the same dir) and resume:
    the continued stream is bit for bit the uninterrupted one."""
    X, y = _ckpt_problem(3)
    prob = rt.Problem(X=X, y=y)
    lams = [6.0, 4.0, 2.5]
    ref = rt.open_serving(prob, device="cpu")
    want = [ref.solve(rt.Scalar(l, warm=True)).value for l in lams]

    d = str(tmp_path / "warm")
    a = rt.open_serving(prob, serving=rt.ServingConfig(ckpt_dir=d),
                        guard=PreemptionGuard(install=False), device="cpu")
    assert not a.restored and a.checkpoint() is None     # nothing warm
    a.solve(rt.Scalar(lams[0], warm=True))
    a.guard.trigger()                       # the SIGTERM moment
    r = a.solve(rt.Scalar(lams[1], warm=True))  # drain: checkpoints first
    assert "preempted_checkpointed" in r.verdict.events
    from repro_torch.ckpt import checkpoint as ck
    extra = ck.load_meta(d, ck.latest_step(d))["extra"]
    assert extra["kind"] == "saif-warm-state"
    assert set(extra["leaves"]) == {"idx", "beta", "mask", "G", "rho",
                                    "gidx"}

    b = rt.open_serving(prob, serving=rt.ServingConfig(ckpt_dir=d),
                        device="cpu")
    assert b.restored and b.stats().restored
    for k, l in enumerate(lams[1:], 1):
        _same_result(b.solve(rt.Scalar(l, warm=True)).value, want[k])
    b.close()                               # final snapshot
    assert ck.latest_step(d) == 2


def test_checkpoint_every_and_digest_gate(tmp_path):
    """``ckpt_every`` snapshots after every N ok requests; a checkpoint
    of a different problem is ignored (cold start), not restored."""
    X, y1 = _ckpt_problem(4)
    y2 = X[:, 1] + 0.1 * np.random.default_rng(9).normal(size=30)
    d = str(tmp_path / "gate")
    a = rt.open_serving(rt.Problem(X=X, y=y1), device="cpu",
                        serving=rt.ServingConfig(ckpt_dir=d, ckpt_every=2))
    a.solve(rt.Scalar(3.0, warm=True))
    from repro_torch.ckpt import checkpoint as ck
    assert ck.latest_step(d) is None
    a.solve(rt.Scalar(2.5, warm=True))
    assert ck.latest_step(d) == 1
    b = rt.open_serving(rt.Problem(X=X, y=y2), device="cpu",
                        serving=rt.ServingConfig(ckpt_dir=d))
    assert not b.restored and b.session.warm_state is None
    c = rt.open_serving(rt.Problem(X=X, y=y1), device="cpu",
                        serving=rt.ServingConfig(ckpt_dir=d))
    assert c.restored
    idx, beta, mask, inner = c.session.warm_state
    w = a.session.warm_state
    for u, v in zip((idx, beta, mask, *inner), (*w[:3], *w[3])):
        assert torch.equal(u, v)
    # the digest covers the weights, the loss and the penalty too
    wts = np.ones(30)
    dw = rt.open_serving(rt.Problem(X=X, y=y1, weights=wts), device="cpu")
    assert dw._digest() != c._digest()
    assert c._digest() == a._digest()


# ---------------------------------------------------------------------------
# the certificate against the reference's
# ---------------------------------------------------------------------------

def test_kkt_certificate_equals_reference():
    """Per-unit KKT residuals, serial and batched (plain, weighted,
    penalty-weighted), against the reference's ``_kkt_fn`` /
    ``_kkt_fleet_fn`` on the same betas."""
    import jax.numpy as jnp
    X, y, lmax = _problem(np.random.default_rng(11))
    rng = np.random.default_rng(2)
    Y = np.stack([y, y + X[:, 2], y - X[:, 7]])
    lams = np.array([0.3, 0.5, 0.2]) * lmax
    fl = rt.fleet_solve(X, Y, lams, rt.SaifConfig(eps=EPS), device="cpu")
    beta = fl.beta + torch.as_tensor(rng.normal(size=fl.beta.shape) * 1e-3)
    beta[1, :5] = 0.0                         # inactive coordinates too
    Xt, Yt = torch.as_tensor(X), torch.as_tensor(Y)
    lt = torch.as_tensor(lams)
    pen = torch.ones(X.shape[1], dtype=torch.float64)
    pen[-1] = 0.0
    W = torch.as_tensor(rng.uniform(0.0, 2.0, size=Y.shape))
    jfleet = JS._kkt_fleet_fn("least_squares")
    jser = JS._kkt_fn("least_squares")
    for p in (None, pen):
        mine = S._kkt_fleet(LS, Xt, Yt, beta, lt, p).numpy()
        ref = np.asarray(jfleet(jnp.asarray(X), jnp.asarray(Y),
                                jnp.asarray(beta.numpy()), jnp.asarray(lams),
                                None if p is None else jnp.asarray(p.numpy())))
        np.testing.assert_allclose(mine, ref, rtol=1e-10, atol=1e-12)
        for b in range(3):
            one = float(rt.kkt_residual(LS, Xt, Yt[b], beta[b], lams[b],
                                        pen=p))
            np.testing.assert_allclose(one, mine[b], rtol=1e-10, atol=1e-12)
    mine = S._kkt_fleet(LS, Xt, Yt, beta, lt, None, W).numpy()
    for b in range(3):
        ref = float(jser(jnp.asarray(X), jnp.asarray(Y[b]),
                         jnp.asarray(beta[b].numpy()),
                         jnp.asarray(lams[b]), None,
                         jnp.asarray(W[b].numpy())))
        np.testing.assert_allclose(mine[b], ref, rtol=1e-10, atol=1e-12)
    # the fleet verdict reports the worst of these for the served betas
    srv = _serve(X, y)
    v = srv.solve(rt.Fleet(Y=Y, lams=lams)).verdict
    served = S._kkt_fleet(LS, Xt, Yt, srv.session.solve(
        rt.Fleet(Y=Y, lams=lams)).beta, lt).numpy()
    assert v.kkt_residual == served.max()
    assert v.kkt_tol == 1e-3 * lams.max()


def test_open_serving_surface_and_admission():
    X, y, lmax = _problem(np.random.default_rng(11), n=20, p=40)
    for name in ("open_serving", "ServingSession", "ServingConfig",
                 "ServingResult", "ServingStats", "Verdict", "Rung",
                 "ServingError", "RequestError", "NumericalError",
                 "BackendFault", "DeadlineExceeded"):
        assert getattr(rt, name) is getattr(S, name)
        assert getattr(rt.core, name) is getattr(S, name)
    assert set(S.__all__) == set(JS.__all__)
    assert rt.Verdict._fields == JS.Verdict._fields
    assert rt.Rung._fields == JS.Rung._fields
    assert rt.ServingStats._fields == JS.ServingStats._fields
    # the reference's options in its order, but for two constants
    # (ROADMAP section C): the oracle's tol is the session's eps and one
    # exhausted-retry failure trips the breaker, the reference's defaults
    fixed = {"oracle_tol": None, "breaker_threshold": 1}
    jcfg = dataclasses.asdict(JS.ServingConfig())
    assert {k: jcfg.pop(k) for k in fixed} == fixed
    assert [f.name for f in dataclasses.fields(rt.ServingConfig)] == \
        list(jcfg)
    assert rt.ServingConfig() == rt.ServingConfig(**jcfg)
    with pytest.raises(rt.NumericalError):
        rt.Problem(X=X, y=np.r_[y[:-1], np.nan])
    with pytest.raises(rt.RequestError):
        rt.Scalar(lam=0.0)
    with pytest.raises(TypeError, match="unknown session kwargs"):
        rt.open_serving(rt.Problem(X=X, y=y), device="cpu", bogus=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        if torch.cuda.is_available():
            raise RuntimeError("CUDA available: nothing to refuse")
        rt.open_serving(rt.Problem(X=X, y=y))
    g = PreemptionGuard(install=False)
    srv = rt.open_serving(rt.Problem(X=X, y=y), device="cpu", guard=g)
    assert srv.guard is g and srv.config is srv.session.config
    assert srv.solve(rt.Scalar(0.5 * lmax)).verdict.ok
    assert sys.modules["repro_torch.core.serving"] is S
