"""Fault-tolerant serving runtime over the Session API (port of
``repro.core.serving``).

A :class:`~repro_torch.core.api.Session` makes SAIF fast to serve; this
module makes it safe to serve. Safe screening sells on a machine-checkable
certificate, the duality gap, and the runtime extends that discipline to
every failure between the request and the result:

* **Admission control**: :func:`validate_problem` / :func:`validate_request`
  reject non-finite data, degenerate zero-norm columns, lam <= 0 and shape
  mismatches with a typed error taxonomy (:class:`RequestError`,
  :class:`NumericalError`, :class:`BackendFault`,
  :class:`DeadlineExceeded`) before anything reaches an engine. Each type
  also IS the builtin it historically surfaced as (``ValueError``,
  ``ArithmeticError``, ``RuntimeError``, ``TimeoutError``). Data may be
  numpy arrays or tensors; a tensor is checked on its own device (a design
  on the card is never copied to the host), with the same errors and
  messages.
* **Certified results**: every ``ServingSession.solve`` returns a
  :class:`ServingResult` ``(value, verdict)``. The :class:`Verdict` carries
  the worst duality gap, a converged flag, h-overflow / precision-floor /
  retry events, and a post-hoc KKT residual of the returned value
  (:func:`repro_torch.core.duality.kkt_residual`) checked against
  ``max(kkt_rtol * lam, kkt_atol)``. The check runs on the session's
  device against its device-resident design: two products over X for one
  solution, two for a whole fleet.
* **Certified degradation**: a failed verdict walks a ladder: ``grow``
  (re-solve with grown capacity and outer budget), ``oracle`` (the
  unscreened CM solve, K7 on a card: screening-free, so a screening bug
  cannot survive it), ``x64`` (re-solve in float64). Each rung is
  re-verified and recorded in ``verdict.rungs``. A streaming session's
  answers (``Update`` and the Scalar, Path and Select after one) are
  certified against the rows it holds; the grow and x64 rungs, which
  re-open the original problem, skip them.
* **Fault containment**: transient ``RuntimeError``s (a failed kernel
  launch) are retried with jittered exponential backoff under a
  per-request deadline (:func:`repro_torch.runtime.fault.retry_step`);
  a :class:`~repro_torch.runtime.fault.StragglerMonitor` per bucket flags
  slow requests; after exhausted retries a circuit breaker opens,
  recorded in :meth:`ServingSession.stats`. On a card it raises a typed
  :class:`BackendFault` and the session refuses every later request: the
  plain path never stands in for a kernel there. On the CPU it pins the
  session's screen and inner backends to ``"torch"`` for the rest of its
  life, as the reference pins them to ``"jnp"``, recorded in the verdict's
  events too.
  A kernel that fails to *build*
  (:class:`~repro_torch.kernels._build.KernelBuildError`) is not transient:
  it passes up unretried and never reaches the breaker.
* **Warm checkpoint/restore**: the session's device-resident warm state
  (slot idx / beta / mask and the inner carry) snapshots through
  :mod:`repro_torch.ckpt.checkpoint`'s atomic writes, gated by a problem
  digest; a SIGTERM'd (``PreemptionGuard``) or restarted server resumes
  warm.

Module scope imports only stdlib and numpy, so constructing a
:class:`~repro_torch.core.api.Problem` (which validates here) keeps the
lazy public surface of ``repro_torch/__init__.py``; torch is imported
where a tensor is seen or a session is opened.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import random
import sys
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

__all__ = [
    "ServingError", "RequestError", "NumericalError", "BackendFault",
    "DeadlineExceeded", "validate_problem", "validate_request",
    "Rung", "Verdict", "ServingResult", "ServingConfig", "ServingStats",
    "ServingSession", "open_serving",
]


# ---------------------------------------------------------------------------
# typed error taxonomy
# ---------------------------------------------------------------------------

class ServingError(Exception):
    """Root of the serving error taxonomy. Each subtype also IS the
    builtin it historically surfaced as, so ``except ValueError`` call
    sites keep working."""


class RequestError(ServingError, ValueError):
    """The request itself is malformed: bad shapes, lam <= 0, unknown
    loss, degenerate (zero-norm) columns. Client-side; never retried."""


class NumericalError(ServingError, ArithmeticError):
    """Non-finite data in, or a result that failed numerical
    certification."""


class BackendFault(ServingError, RuntimeError):
    """A backend faulted persistently."""


class DeadlineExceeded(ServingError, TimeoutError):
    """The per-request wall-clock budget ran out."""


class _NonRetriable(Exception):
    """Internal carrier: an exception the retry loop must not eat
    (NotImplementedError, a kernel build failure and typed serving errors
    pass straight up)."""

    def __init__(self, cause: BaseException):
        super().__init__(cause)
        self.cause = cause


# ---------------------------------------------------------------------------
# arrays: numpy on the host, tensors where they lie
# ---------------------------------------------------------------------------

_KNOWN_LOSSES = ("least_squares", "logistic")


def _is_tensor(x) -> bool:
    torch = sys.modules.get("torch")      # no torch loaded, no tensor
    return torch is not None and isinstance(x, torch.Tensor)


def _arr(x):
    """A tensor as it is (on its device), anything else as numpy."""
    return x if _is_tensor(x) else np.asarray(x)


def _shape(a) -> tuple:
    return tuple(a.shape)


def _finite(a):
    if _is_tensor(a):
        import torch
        return torch.isfinite(a)
    return np.isfinite(a)


def _require_finite(name: str, arr) -> None:
    ok = _finite(arr)
    if not bool(ok.all()):
        bad = int((~ok).sum())
        raise NumericalError(
            f"{name} has {bad} non-finite entr{'y' if bad == 1 else 'ies'} "
            f"(NaN/Inf): admission control rejects it before it can reach "
            f"a compiled program")


def _dead_columns(X) -> np.ndarray:
    """Ids of the zero-norm columns, norms taken in float64 (a tensor's
    on its device)."""
    if _is_tensor(X):
        import torch
        norms = torch.linalg.vector_norm(X.to(torch.float64), dim=0)
        return torch.nonzero(norms == 0.0).flatten().cpu().numpy()
    norms = np.linalg.norm(X.astype(np.float64, copy=False), axis=0)
    return np.flatnonzero(norms == 0.0)


def _require_lam(lam, what: str = "lam") -> None:
    arr = np.asarray(lam, dtype=np.float64)
    if arr.ndim > 1:
        raise RequestError(f"{what} must be a scalar or 1-D grid, got "
                           f"shape {arr.shape}")
    if not np.all(np.isfinite(arr)):
        raise RequestError(f"{what} must be finite, got {lam!r}")
    if not np.all(arr > 0.0):
        raise RequestError(
            f"{what} must be > 0 (lam = 0 is an unregularized fit the "
            f"screening certificate does not cover), got {lam!r}")


def _lams(lams) -> np.ndarray:
    """A lambda grid as float64 numpy (a tensor's values read back: they
    are a handful of host numbers)."""
    if _is_tensor(lams):
        lams = lams.detach().cpu().numpy()
    return np.asarray(lams, dtype=np.float64)


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------

def validate_problem(problem) -> None:
    """Admission control for :class:`~repro_torch.core.api.Problem`: runs
    at construction, so a malformed spec fails with a typed error before
    a session sees it."""
    if problem.X is None:
        # a spec without a design is legal to construct; open_session
        # rejects it at serve time
        return
    X = _arr(problem.X)
    if X.ndim != 2:
        raise RequestError(
            f"Problem.X must be 2-D (n, p), got shape {_shape(X)}")
    if X.shape[0] < 1 or X.shape[1] < 1:
        raise RequestError(f"Problem.X must be non-empty, got {_shape(X)}")
    _require_finite("Problem.X", X)
    dead = _dead_columns(X)
    if dead.size:
        raise RequestError(
            f"Problem.X has {dead.size} zero-norm (degenerate) column"
            f"{'s' if dead.size > 1 else ''} (e.g. {dead[:5].tolist()}): "
            f"a dead column has no screening statistic and can never "
            f"enter the support — drop it before building the Problem")
    if problem.loss not in _KNOWN_LOSSES:
        raise RequestError(
            f"unknown loss {problem.loss!r}; options: "
            f"{sorted(_KNOWN_LOSSES)}")
    n = X.shape[0]
    if problem.y is not None:
        y = _arr(problem.y)
        if _shape(y) != (n,):
            raise RequestError(
                f"Problem.y must have shape ({n},) to match X "
                f"{_shape(X)}, got {_shape(y)}")
        _require_finite("Problem.y", y)
    if problem.weights is not None:
        w = _arr(problem.weights)
        if _shape(w) != (n,):
            raise RequestError(
                f"Problem.weights must have shape ({n},), got {_shape(w)}")
        _require_finite("Problem.weights", w)
        if bool((w < 0.0).any()):
            raise RequestError("Problem.weights must be non-negative")
        if not bool((w > 0.0).any()):
            raise RequestError("Problem.weights must not be all zero")


def _validate_fleet(req) -> None:
    Y = _arr(req.Y)
    if Y.ndim not in (1, 2):
        raise RequestError(
            f"Fleet.Y must be (n,) or (B, n), got shape {_shape(Y)}")
    _require_finite("Fleet.Y", Y)
    B = 1 if Y.ndim == 1 else Y.shape[0]
    lams = _lams(req.lams)
    if lams.ndim == 1 and lams.shape[0] != B:
        raise RequestError(
            f"Fleet.lams must be a scalar or shape ({B},) to match "
            f"Y, got {lams.shape}")
    _require_lam(lams, "Fleet.lams")
    if req.weights is not None:
        w = _arr(req.weights)
        if _shape(w) != _shape(Y):
            raise RequestError(
                f"Fleet.weights must match Y's shape {_shape(Y)}, "
                f"got {_shape(w)}")
        _require_finite("Fleet.weights", w)
        if bool((w < 0.0).any()):
            raise RequestError("Fleet.weights must be non-negative")
        w2 = w if w.ndim == 2 else w[None, :]
        if not bool((w2 > 0.0).any(1).all()):
            raise RequestError(
                "every Fleet.weights row needs a positive entry")


def _validate_update(req) -> None:
    rows = _arr(req.rows)
    if rows.ndim != 2 or rows.shape[0] < 1 or rows.shape[1] < 1:
        raise RequestError(
            f"Update.rows must be a non-empty (m, p) row block, got "
            f"shape {_shape(rows)}")
    _require_finite("Update.rows", rows)
    resp = _arr(req.responses)
    if _shape(resp) != (rows.shape[0],):
        raise RequestError(
            f"Update.responses must have shape ({rows.shape[0]},) to "
            f"match rows {_shape(rows)}, got {_shape(resp)}")
    _require_finite("Update.responses", resp)
    if req.lam is not None:
        if np.asarray(req.lam, dtype=np.float64).ndim != 0:
            raise RequestError(
                f"Update.lam must be a scalar (or None to re-solve at "
                f"the session's last lambda), got shape "
                f"{np.asarray(req.lam).shape}")
        _require_lam(req.lam, "Update.lam")
    if req.window is not None:
        w = int(req.window)
        if w < 1:
            raise RequestError(
                f"Update.window must be a positive row count (or None "
                f"for an append-only stream), got {req.window!r}")
        if w < rows.shape[0]:
            raise RequestError(
                f"Update.window ({w}) must be >= the update batch "
                f"({rows.shape[0]} rows); a single batch may not "
                f"overflow the sliding window")


def _validate_select(req) -> None:
    lams = _lams(req.lams)
    if lams.size == 0:
        raise RequestError("Select.lams must be a non-empty grid")
    _require_lam(lams, "Select.lams")
    if int(req.n_folds) < 2:
        raise RequestError(
            f"Select.n_folds must be >= 2, got {req.n_folds}")
    if req.rule not in ("1se", "min"):
        raise RequestError(
            f"Select.rule must be '1se' or 'min', got {req.rule!r}")
    if req.stability:
        if int(req.n_subsamples) < 2:
            raise RequestError(
                f"Select.n_subsamples must be >= 2 (selection "
                f"frequencies need >= 2 subsamples), got "
                f"{req.n_subsamples}")
        frac = float(req.subsample_frac)
        if not (0.0 < frac < 1.0):
            raise RequestError(
                f"Select.subsample_frac must lie in (0, 1), got "
                f"{req.subsample_frac!r}")
    pi = float(req.pi_threshold)
    if not (0.0 < pi <= 1.0):
        raise RequestError(
            f"Select.pi_threshold must lie in (0, 1], got "
            f"{req.pi_threshold!r}")


def validate_request(req) -> None:
    """Admission control for Scalar/Path/Fleet/CV/Update/Select,
    duck-typed on the request's class name so that this module never
    imports the api module."""
    kind = type(req).__name__
    if kind == "Scalar":
        _require_lam(req.lam, "Scalar.lam")
        if np.asarray(req.lam, dtype=np.float64).ndim != 0:
            raise RequestError(
                f"Scalar.lam must be a scalar, got shape "
                f"{np.asarray(req.lam).shape}; submit a Path for a grid")
    elif kind in ("Path", "CV"):
        lams = _lams(req.lams)
        if kind == "CV" and int(req.n_folds) < 2:
            raise RequestError(
                f"CV.n_folds must be >= 2, got {req.n_folds}")
        if lams.size == 0:
            raise RequestError(f"{kind}.lams must be a non-empty grid")
        _require_lam(lams, f"{kind}.lams")
    elif kind == "Fleet":
        _validate_fleet(req)
    elif kind == "Update":
        _validate_update(req)
    elif kind == "Select":
        _validate_select(req)
    # the serving knobs every request kind carries
    deadline = getattr(req, "deadline_s", None)
    if deadline is not None:
        d = float(deadline)
        if not math.isfinite(d) or d <= 0.0:
            raise RequestError(
                f"{kind}.deadline_s must be a finite positive number of "
                f"seconds (or None), got {deadline!r}")
    priority = getattr(req, "priority", 0)
    if not isinstance(priority, (int, np.integer)) or isinstance(
            priority, bool):
        raise RequestError(
            f"{kind}.priority must be an int (higher dequeues first), "
            f"got {priority!r}")


# ---------------------------------------------------------------------------
# verdicts
# ---------------------------------------------------------------------------

class Rung(NamedTuple):
    """One attempted degradation-ladder rung."""
    name: str                   # "grow" | "oracle" | "x64"
    ok: bool                    # did the rung's result pass verification
    gap: float                  # worst duality gap of the rung's result
    kkt_residual: float         # worst KKT residual of the rung's result
    note: str = ""              # "skipped" / "error:..." / ""


class Verdict(NamedTuple):
    """The certificate attached to every served result.

    ``ok`` is the serving guarantee: the returned value passed numerical
    certification (finite + post-hoc KKT residual within tolerance; where
    no scalar KKT check applies, duality gap <= eps). ``converged`` is the
    stricter engine criterion ``gap <= eps``: a result can be ``ok`` but
    not ``converged`` when the gap bottomed out at its arithmetic
    precision floor yet the KKT residual certifies it. ``events`` is the
    de-duplicated trail (retries, h-overflow, warm-state resets, breaker
    trips); ``rungs`` records every degradation attempt, in order."""
    ok: bool
    converged: bool
    gap: float
    kkt_residual: float
    kkt_tol: float
    events: Tuple[str, ...] = ()
    rungs: Tuple[Rung, ...] = ()
    degraded: bool = False
    retries: int = 0
    kkt_check_ms: float = 0.0
    # execution-mode provenance: which parity contract and screening
    # precision produced the value. The KKT check behind ``ok`` always
    # runs in working precision, whatever these say.
    parity: str = "bitwise"
    screen_dtype: str = "working"
    # screening-rule provenance: "saif" | "gap_safe" | "hybrid" | a custom
    # ScreenRule's name. The certification behind ``ok`` checks the
    # returned value, not the rule.
    screen_rule: str = "saif"
    # Per-unit breakdown (one entry per lambda / fleet member), so a
    # failed certificate is attributed to the one poisoned member of a
    # batch. ``unit_ok[i]`` is unit i's final certification;
    # ``unit_degraded[i]`` marks units that failed the FIRST certification
    # pass and owe their final state to the ladder. None when the request
    # produced no certification units.
    unit_ok: Optional[Tuple[bool, ...]] = None
    unit_degraded: Optional[Tuple[bool, ...]] = None


class ServingResult(NamedTuple):
    value: Any                  # the engine result (type per request kind)
    verdict: Verdict


class ServingStats(NamedTuple):
    """Session-lifetime counters."""
    requests: int
    degraded: int               # requests that needed >= 1 ladder rung
    retries: int                # transient-fault retries issued
    stragglers: int             # requests flagged by the monitors
    breaker_open: bool          # tripped: pinned to "torch" / refusing
    restored: bool              # warm state came from a checkpoint
    kkt_check_ms: float         # cumulative certification time


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Policy knobs of the fault-tolerant runtime."""
    max_retries: int = 2          # transient-fault retries per request
    backoff_base_s: float = 0.01  # first retry's nominal backoff
    backoff_mult: float = 2.0
    jitter: float = 0.5           # +- fraction on each backoff delay
    deadline_s: Optional[float] = None    # per-request wall-clock budget
    check_kkt: bool = True
    kkt_rtol: float = 1e-3        # tol = max(kkt_rtol * lam, kkt_atol)
    kkt_atol: float = 1e-8
    ladder: Tuple[str, ...] = ("grow", "oracle", "x64")
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 0           # checkpoint every N ok requests (0=off)
    seed: int = 0                 # backoff-jitter rng seed
    straggler_factor: float = 3.0
    strict: bool = False          # raise NumericalError on a failed verdict


# ---------------------------------------------------------------------------
# the KKT certificate: plain functions on the session's device, outside
# the engines
# ---------------------------------------------------------------------------

def _kkt_fleet(loss, X, Y, beta, lams, pen=None, W=None):
    """Per-row KKT residuals of a fleet over one design in one batched
    pass: Z = beta X^T, the loss gradient (weighted by ``W``'s rows), C =
    G X, and the worst violation per row; two products over X for all B
    members. Each row is :func:`~repro_torch.core.duality.kkt_residual`
    of its member."""
    import torch
    G = loss.grad(beta @ X.T, Y)
    if W is not None:
        G = G * W
    C = G @ X
    lam_i = lams[:, None] * pen if pen is not None else lams[:, None]
    active = torch.abs(beta) > 0.0
    viol = torch.where(active, torch.abs(C + lam_i * torch.sign(beta)),
                       torch.clamp(torch.abs(C) - lam_i, min=0.0))
    return torch.amax(viol, dim=1)


def _all_finite(a) -> bool:
    if _is_tensor(a):
        import torch
        return bool(torch.isfinite(a).all())
    return bool(np.all(np.isfinite(np.asarray(a))))


def _wmax(a: float, b: float) -> float:
    """NaN-propagating max: a non-finite entry must dominate the
    verdict's worst-case fields, never be masked by a healthy one."""
    if math.isnan(a) or math.isnan(b):
        return float("nan")
    return max(a, b)


def _torch_dtype(name: str):
    """The torch dtype of a numpy dtype name (a checkpoint's meta)."""
    import torch
    return torch.from_numpy(np.zeros(0, np.dtype(name))).dtype


# ---------------------------------------------------------------------------
# the serving session
# ---------------------------------------------------------------------------

class ServingSession:
    """A :class:`~repro_torch.core.api.Session` wrapped in the
    fault-tolerant runtime: every ``solve`` admits, retries, certifies,
    degrades and (optionally) checkpoints. Construct via
    :func:`open_serving`."""

    def __init__(self, problem, config=None, *, serving=None, guard=None,
                 **kwargs):
        from repro_torch.core.api import open_session, session_kwargs
        self.serving = serving if serving is not None else ServingConfig()
        self.problem = problem
        # the one shared passthrough spec (api.SESSION_KWARG_DEFAULTS)
        self._opts = session_kwargs(**kwargs)
        self.session = open_session(problem, config, **self._opts)
        self.guard = guard
        self._rng = random.Random(self.serving.seed)
        self._monitors: Dict[tuple, Any] = {}
        self.breaker_open = False
        self._refusing = False          # the breaker opened by refusing
        self.restored = False
        self._preempt_ckpt = False
        self._requests = 0
        self._degraded = 0
        self._retries_total = 0
        self._stragglers = 0
        self._kkt_ms = 0.0
        self._step = 0
        self._last_unit_ok: List[bool] = []
        if self.serving.ckpt_dir:
            self.restored = self._maybe_restore()

    # -- passthrough surface -------------------------------------------

    def compile_stats(self):
        return self.session.compile_stats()

    @property
    def config(self):
        return self.session.config

    def stats(self) -> ServingStats:
        return ServingStats(
            requests=self._requests, degraded=self._degraded,
            retries=self._retries_total, stragglers=self._stragglers,
            breaker_open=self.breaker_open, restored=self.restored,
            kkt_check_ms=self._kkt_ms)

    # ------------------------------------------------------------------
    # the one entry point
    # ------------------------------------------------------------------

    def solve(self, request) -> ServingResult:
        """Serve one request under the full runtime: admission already
        ran at request construction; here the request is dispatched with
        retry/backoff and a deadline, the result is certified, and a
        failed certificate walks the degradation ladder. Returns
        ``(value, verdict)``; a typed error (the taxonomy above) is the
        only other way out."""
        ser = self.serving
        t0 = time.monotonic()
        deadline = getattr(request, "deadline_s", None)
        if deadline is None:
            deadline = ser.deadline_s
        self._requests += 1
        events: List[str] = []
        self._drain_preemption(events)

        retries = 0

        def on_retry(attempt: int, e: Exception) -> None:
            nonlocal retries
            retries += 1
            events.append(f"retry:{attempt}:{type(e).__name__}")

        value = self._primary(request, t0, deadline, on_retry, events)
        drain = getattr(self.session, "drain_events", None)
        if drain is not None:
            events += list(drain())
        self._retries_total += retries

        kkt_ms0 = self._kkt_ms
        ok, converged, gap, kkt, tol, ev = self._verify(request, value)
        events += ev
        first_unit = tuple(self._last_unit_ok)
        final_unit = first_unit
        rungs: List[Rung] = []
        degraded = False
        if not ok:
            self._scrub_warm(request, events)
            best_value, best_score = value, _score(kkt, gap)
            best_unit = first_unit
            for name in ser.ladder:
                self._check_deadline(t0, deadline, f"ladder rung {name!r}")
                try:
                    cand = self._run_rung(name, request, value)
                except ServingError:
                    raise
                except Exception as e:   # noqa: BLE001 - a rung crashing
                    # must surface in the verdict, not mask it
                    rungs.append(Rung(name, False, float("nan"),
                                      float("nan"),
                                      f"error:{type(e).__name__}: {e}"))
                    continue
                if cand is None:
                    rungs.append(Rung(name, False, float("nan"),
                                      float("nan"), "skipped"))
                    continue
                value2, sess2 = cand
                degraded = True
                ok2, conv2, gap2, kkt2, _, ev2 = self._verify(
                    request, value2, sess=sess2)
                rungs.append(Rung(name, ok2, gap2, kkt2))
                if _score(kkt2, gap2) < best_score:
                    best_value, best_score = value2, _score(kkt2, gap2)
                    best_unit = tuple(self._last_unit_ok)
                if ok2:
                    ok, converged, gap, kkt = True, conv2, gap2, kkt2
                    value = value2
                    final_unit = tuple(self._last_unit_ok)
                    events += [f"degraded:{name}"] + ev2
                    break
            else:
                value = best_value
                final_unit = best_unit
                events.append("ladder_exhausted")
        if degraded:
            self._degraded += 1

        cfg = self.session.config
        rule = getattr(cfg, "screen_rule", "saif")   # str or ScreenRule
        verdict = Verdict(
            ok=ok, converged=converged, gap=gap, kkt_residual=kkt,
            kkt_tol=tol, events=tuple(dict.fromkeys(events)),
            rungs=tuple(rungs), degraded=degraded, retries=retries,
            kkt_check_ms=self._kkt_ms - kkt_ms0,
            parity=getattr(cfg, "parity", "bitwise"),
            screen_dtype=getattr(cfg, "screen_dtype", "working"),
            screen_rule=getattr(rule, "name", rule),
            unit_ok=final_unit or None,
            unit_degraded=(tuple(not u for u in first_unit)
                           if first_unit else None))
        if ok and ser.ckpt_every and self._requests % ser.ckpt_every == 0:
            self.checkpoint()
        if ser.strict and not ok:
            raise NumericalError(
                f"result failed certification after the full degradation "
                f"ladder: gap={gap:g}, kkt_residual={kkt:g} (tol {tol:g}), "
                f"events={verdict.events}")
        return ServingResult(value=value, verdict=verdict)

    # ------------------------------------------------------------------
    # primary dispatch: retry / backoff / deadline / breaker / straggler
    # ------------------------------------------------------------------

    def _primary(self, request, t0, deadline, on_retry, events):
        from repro_torch.kernels._build import KernelBuildError
        from repro_torch.runtime.fault import (RetryDeadlineExceeded,
                                               StepFailed, StragglerMonitor,
                                               retry_step)
        if self._refusing:
            raise BackendFault(
                f"the breaker is open on {self.session.device}: the session "
                f"refuses requests after a persistent backend fault")
        ser = self.serving
        bucket = self._bucket(request)
        mon = self._monitors.get(bucket)
        if mon is None:
            mon = self._monitors[bucket] = StragglerMonitor(
                factor=ser.straggler_factor)

        updates0 = self._online_updates()

        def attempt():
            tA = time.monotonic()
            try:
                if self._online_updates() != updates0:
                    # an Update's rows were committed before the fault:
                    # the retry re-solves, it never applies them twice
                    out = self._resolve_committed(request)
                else:
                    out = self.session.solve(request)
            except (NotImplementedError, ServingError,
                    KernelBuildError) as e:
                raise _NonRetriable(e) from e
            if mon.record(time.monotonic() - tA):
                self._stragglers += 1
                events.append("straggler")
            return out

        remaining = None
        if deadline is not None:
            remaining = max(deadline - (time.monotonic() - t0), 0.0)
        try:
            return retry_step(
                attempt, max_retries=ser.max_retries,
                retriable=(RuntimeError,), on_retry=on_retry,
                backoff_base_s=ser.backoff_base_s,
                backoff_mult=ser.backoff_mult, jitter=ser.jitter,
                deadline_s=remaining, rng=self._rng)
        except _NonRetriable as e:
            raise e.cause
        except RetryDeadlineExceeded as e:
            raise DeadlineExceeded(
                f"request deadline ({deadline:g}s) exceeded while "
                f"retrying a transient backend fault: {e}") from e
        except StepFailed as e:
            return self._trip_breaker(request, e, events)

    def _online_updates(self) -> int:
        st = getattr(self.session, "_online", None)
        return 0 if st is None else st.updates

    def _resolve_committed(self, request):
        """The warm re-solve of an Update whose rows are in already."""
        from repro_torch.core.online import _resolve
        lam = request.lam if request.lam is not None \
            else self.session._last_lam
        return _resolve(self.session, float(lam))

    def _trip_breaker(self, request, err, events):
        """Retries exhausted. On a card, and on a streaming session (an
        Update's engine faults come after its rows are in), the breaker
        opens and the fault is a typed BackendFault: the session refuses
        every later request rather than serve it on the plain path or on
        the original rows. Elsewhere the backends are durably pinned to
        the plain path and the degraded session gets one clean shot;
        anything else is a typed BackendFault."""
        events.append("backend_fault")
        if self.session.device.type == "cuda" or \
                self._streamed(self.session):
            self.breaker_open = self._refusing = True
            raise BackendFault(
                f"persistent backend fault on {self.session.device} "
                f"(retries exhausted); the breaker is open and the session "
                f"refuses further requests: {err}") from err
        if self._open_degraded(events):
            try:
                return self.session.solve(request)
            except Exception as e2:
                raise BackendFault(
                    f"backend fault persisted on the degraded (torch) "
                    f"backend: {e2}") from e2
        raise BackendFault(
            f"persistent backend fault (retries exhausted"
            f"{', breaker already open' if self.breaker_open else ''}): "
            f"{err}") from err

    def _open_degraded(self, events) -> bool:
        """Pin the screen and inner backends to ``"torch"`` (the plain
        path) for the session's remaining lifetime: wherever they are not
        ``"torch"`` already, so ``"auto"``, ``"cuda"`` and ``"gram"`` all
        trip. Never on a card, and never silent: the events say
        ``breaker_open:...`` and ``stats().breaker_open`` is True. Returns
        False when there is nothing left to pin."""
        if self.breaker_open:
            return False
        cfg = self.session.config
        repl = {}
        if getattr(cfg, "screen_backend", "torch") != "torch":
            repl["screen_backend"] = "torch"
        if getattr(cfg, "inner_backend", "torch") != "torch":
            repl["inner_backend"] = "torch"
        if not repl:
            return False
        from repro_torch.core.api import open_session
        cfg2 = dataclasses.replace(cfg, **repl)
        self.session = open_session(self.problem, cfg2, **self._opts)
        self.breaker_open = True
        events.append("breaker_open:" + ",".join(
            f"{k}=torch" for k in sorted(repl)))
        return True

    def _bucket(self, request) -> tuple:
        """Bucket key for the straggler monitors: requests that share a
        static signature (kind, and a Scalar's h) share a latency
        distribution."""
        name = type(request).__name__.lower()
        cfg = self.session.config
        prep = getattr(self.session, "_prep", None)
        if name == "scalar" and prep is not None and hasattr(cfg, "c"):
            from repro_torch.core.saif import add_batch_size_static
            h = add_batch_size_static(
                cfg.c, float(request.lam), float(prep.c0_max),
                float(prep.c0_median), int(prep.p_true or prep.X.shape[1]))
            return (name, h)
        return (name, 0)

    def _check_deadline(self, t0, deadline, where: str) -> None:
        if deadline is not None and time.monotonic() - t0 > deadline:
            raise DeadlineExceeded(
                f"request deadline ({deadline:g}s) exceeded before "
                f"{where}")

    def _drain_preemption(self, events) -> None:
        g = self.guard
        if g is not None and g.preempted and not self._preempt_ckpt:
            self._preempt_ckpt = True
            if self.checkpoint() is not None:
                events.append("preempted_checkpointed")

    # ------------------------------------------------------------------
    # certification
    # ------------------------------------------------------------------

    def _verify(self, request, value, sess=None):
        """Certify ``value``: finiteness, gap convergence and, where the
        scalar KKT conditions apply, the post-hoc KKT residual. Returns
        ``(ok, converged, gap, kkt, tol, events)`` worst-cased over the
        request's units (one per lambda / fleet member). The time of the
        whole pass (the fleet's batched residuals included) adds to
        ``kkt_check_ms``."""
        sess = self.session if sess is None else sess
        ser = self.serving
        events: List[str] = []
        eps = float(getattr(sess.config, "eps", 1e-6))
        max_outer = int(getattr(sess.config, "max_outer", 0))
        t_k0 = time.perf_counter()
        units = self._units(request, value, sess)
        loss = None
        ok, converged = True, True
        gap_w, kkt_w, tol_w = 0.0, 0.0, 0.0
        unit_ok: List[bool] = []
        for u in units:
            finite = u["finite"] if "finite" in u else _all_finite(u["beta"])
            g = float(u["gap"])
            finite = finite and math.isfinite(g)
            u_ok = finite
            if not finite:
                events.append("nonfinite")
            if u.get("overflowed"):
                events.append("h_overflow")
            if max_outer and u.get("n_outer", -1) >= max_outer:
                events.append("max_outer_exhausted")
            gap_w = _wmax(gap_w, g if math.isfinite(g) else float("nan"))
            if not (g <= eps):
                converged = False
                if finite:
                    # the engine stops at max(eps, precision floor): a
                    # finite gap above eps means the floor (or the outer
                    # budget) cut it short; the KKT check arbitrates
                    events.append("precision_floor"
                                  if u.get("n_outer", -1) < max_outer
                                  or not max_outer
                                  else "gap_above_eps")
            if u["kkt"] and ser.check_kkt:
                lam = float(u["lam"])
                tol = max(ser.kkt_rtol * lam, ser.kkt_atol)
                tol_w = max(tol_w, tol)
                if u.get("kkt_r") is not None:   # batched fleet cert
                    r = u["kkt_r"]
                else:
                    from repro_torch.core.duality import kkt_residual
                    from repro_torch.core.losses import get_loss
                    loss = loss or get_loss(sess.config.loss)
                    r = float(kkt_residual(loss, u["X"], u["y"], u["beta"],
                                           lam, pen=u["pen"],
                                           sample_w=u["sample_w"]))
                kkt_w = _wmax(kkt_w, r)
                if not (r <= tol):           # NaN residual fails too
                    u_ok = False
                    events.append("kkt_violation")
            else:
                # no scalar KKT conditions (group penalty, CV scores) or
                # checking disabled: the duality gap is the certificate
                u_ok = u_ok and (g <= eps)
            ok = ok and u_ok
            unit_ok.append(u_ok)
        self._kkt_ms += (time.perf_counter() - t_k0) * 1e3
        self._last_unit_ok = unit_ok
        return ok, converged, gap_w, kkt_w, tol_w, events

    @staticmethod
    def _streamed(sess) -> bool:
        return getattr(sess, "_online", None) is not None

    @classmethod
    def _solved_design(cls, sess):
        """The (X, y, pen) a serial request (Scalar, Path, Select) was
        solved on: a streaming session's resident rows (``_prep``; its
        zero capacity-padding rows are exact for least squares), else
        :meth:`_device_design`. Fleet and CV requests solve on the
        session's original design, as in the reference."""
        if cls._streamed(sess):
            return sess._prep.X, sess._prep.y, None
        return cls._device_design(sess)

    @staticmethod
    def _device_design(sess):
        """The session's device-resident (X, y, pen) the certificate and
        the oracle use: the transformed design with b's l1 weight 0 for a
        fused session, else the real design (never ``problem.X``, which
        may be a host array)."""
        if sess._design is not None:
            import torch
            Xt = sess._design.Xt
            pen = torch.ones(Xt.shape[1], dtype=Xt.dtype, device=Xt.device)
            pen[sess._design.unpen_idx] = 0.0
            return Xt, sess._y, pen
        return sess._X, sess._y, None

    def _units(self, request, value, sess) -> List[dict]:
        """Decompose a result into per-solution certification units.
        Each unit: beta/gap to check (or a precomputed ``finite`` flag and
        ``kkt_r`` residual for a fleet), the (X, y, lam, pen, sample_w)
        the KKT residual needs, and whether scalar KKT applies."""
        from repro_torch.core import api
        from repro_torch.core.saif import as_tensor
        # a group unit is certified by its gap only: its KKT conditions
        # are blockwise, as in the reference
        grouped = isinstance(sess.penalty, api.GroupPenalty)
        fusedp = isinstance(sess.penalty, api.FusedPenalty)

        if isinstance(request, api.Scalar):
            if grouped:
                return [dict(beta=value.beta, gap=value.gap,
                             lam=request.lam, kkt=False,
                             n_outer=int(value.n_outer))]
            X, y, pen = self._solved_design(sess)
            res = value[1] if fusedp else value
            sw = None if sess.problem.weights is None \
                else as_tensor(sess.problem.weights, X.device, X.dtype)
            return [dict(beta=res.beta, gap=res.gap, lam=request.lam,
                         kkt=True, X=X, y=y, pen=pen, sample_w=sw,
                         overflowed=bool(res.overflowed),
                         n_outer=int(res.n_outer))]

        if isinstance(request, api.Path):
            if grouped:
                return [dict(beta=r.beta, gap=r.gap, lam=float(lam),
                             kkt=False, n_outer=int(r.n_outer))
                        for lam, r in zip(value.lams, value.results)]
            X, y, pen = self._solved_design(sess)
            pr = value.path if fusedp else value
            return [dict(beta=b, gap=r.gap, lam=float(lam), kkt=True,
                         X=X, y=y, pen=pen, sample_w=None,
                         overflowed=bool(r.overflowed),
                         n_outer=int(r.n_outer))
                    for lam, b, r in zip(pr.lams, pr.betas, pr.results)]

        if isinstance(request, api.Fleet):
            import torch
            X, _, pen = self._device_design(sess)
            Y = as_tensor(request.Y, X.device, X.dtype)
            Y = Y[None, :] if Y.ndim == 1 else Y
            B = Y.shape[0]
            lams = np.broadcast_to(_lams(request.lams).reshape(-1), (B,)).copy()
            W = None
            if request.weights is not None:
                W = as_tensor(request.weights, X.device, X.dtype)
                W = W[None, :] if W.ndim == 1 else W
            # one host read per batched field, then free numpy slicing:
            # per-unit device reads would cost a sync each
            finite = torch.isfinite(value.beta).all(dim=-1).cpu().numpy()
            gap = torch.as_tensor(value.gap).cpu().numpy()
            ovf = torch.as_tensor(value.overflowed).cpu().numpy()
            nout = torch.as_tensor(value.n_outer).cpu().numpy()
            kkt_r = None
            if self.serving.check_kkt:
                from repro_torch.core.losses import get_loss
                kkt_r = _kkt_fleet(
                    get_loss(sess.config.loss), X, Y, value.beta,
                    torch.as_tensor(lams, dtype=X.dtype, device=X.device),
                    pen, W).cpu().numpy()
            return [dict(finite=bool(finite[b]), gap=gap[b],
                         lam=float(lams[b]), kkt=True,
                         kkt_r=None if kkt_r is None else float(kkt_r[b]),
                         overflowed=bool(ovf[b]), n_outer=int(nout[b]))
                    for b in range(B)]

        if isinstance(request, api.CV):
            X, y, pen = self._device_design(sess)
            if value.beta is None:
                # scores-only CV: certify the score table's finiteness
                return [dict(beta=np.asarray(value.cv_mean), gap=0.0,
                             lam=float(value.best_lam), kkt=False)]
            res = value.best_result
            return [dict(beta=value.beta,
                         gap=(0.0 if res is None else res.gap),
                         lam=float(value.best_lam), kkt=True, X=X, y=y,
                         pen=pen, sample_w=None,
                         overflowed=False if res is None
                         else bool(res.overflowed),
                         n_outer=0 if res is None else int(res.n_outer))]

        if isinstance(request, api.Select):
            if value.beta is None:
                # no refit requested: certify the CV score table's
                # finiteness at the chosen lambda (the CV idiom above)
                return [dict(beta=np.asarray(value.cv_mean), gap=0.0,
                             lam=float(value.lam), kkt=False)]
            X, y, pen = self._solved_design(sess)
            res = value.best_result
            return [dict(beta=value.beta,
                         gap=(0.0 if res is None else res.gap),
                         lam=float(value.lam), kkt=True, X=X, y=y,
                         pen=pen, sample_w=None,
                         overflowed=False if res is None
                         else bool(res.overflowed),
                         n_outer=0 if res is None else int(res.n_outer))]

        if isinstance(request, api.Update):
            if value is None:        # resolve=False: ingest only, nothing
                return []            # to certify until the next solve
            X, y, _ = self._solved_design(sess)
            return [dict(beta=value.beta, gap=value.gap,
                         lam=float(sess._last_lam), kkt=True, X=X, y=y,
                         pen=None, sample_w=None,
                         overflowed=bool(value.overflowed),
                         n_outer=int(value.n_outer))]

        raise RequestError(f"unknown request {request!r}")

    def _scrub_warm(self, request, events) -> None:
        """A failed solve may have harvested corrupt warm state (NaN
        coefficients in the slot buffers); reset the warm surface so later
        warm=True requests re-enter cold."""
        from repro_torch.core import api
        if not isinstance(request, (api.Scalar, api.Path, api.Update)):
            return
        s = self.session
        if getattr(request, "sharded", False):
            s._sharded_warm, s._sharded_warm_k = None, None
        elif isinstance(s.penalty, api.GroupPenalty):
            s._gwarm = None          # the group engine's warm state
        else:
            s.set_warm_state(None, None)
            # a result seeded from the cross-request cache failed its
            # certificate: drop the seeding entry so repeat traffic
            # re-enters cold
            drop = getattr(s, "drop_cache_entry", None)
            if drop is not None and drop():
                events.append("warm_cache_invalidated")
        events.append("warm_state_reset")

    # ------------------------------------------------------------------
    # the degradation ladder
    # ------------------------------------------------------------------

    def _run_rung(self, name, request, value):
        if name == "grow":
            return self._rung_grow(request)
        if name == "oracle":
            return self._rung_oracle(request, value)
        if name == "x64":
            return self._rung_x64(request)
        return None

    def _temp_session(self, problem, config):
        """A one-off session for a rung, on this session's device, bucket
        and path-engine options."""
        from repro_torch.core import api
        return api.open_session(problem, config, mesh=self._opts["mesh"],
                                segment_len=self._opts["segment_len"],
                                pad_to=self._opts["pad_to"],
                                device=self.session.device)

    def _rung_grow(self, request):
        """Re-solve with grown active-set capacity and a 4x outer budget:
        the rung that keeps the safe guarantee (it still screens, so the
        gap certificate's meaning is unchanged)."""
        from repro_torch.core import api
        sess = self.session
        if isinstance(sess.penalty, api.GroupPenalty):
            return None              # the reference has no group rung
        if self._reopens_another_problem(request):
            return None
        if getattr(request, "sharded", False):
            return None
        if isinstance(request, api.Fleet) and request.screen_fn is not None:
            return None
        cfg = sess.config
        p = int(self.problem.X.shape[1])
        k2 = min(p, max(2 * (cfg.k_max or 0), 256))
        cfg2 = dataclasses.replace(cfg, k_max=k2,
                                   max_outer=cfg.max_outer * 4)
        tmp = self._temp_session(self.problem, cfg2)
        req2 = dataclasses.replace(request, warm=False) \
            if isinstance(request, (api.Scalar, api.Path)) else request
        return tmp.solve(req2), tmp

    def _rung_oracle(self, request, value):
        """Re-solve the failed units with the unscreened CM oracle
        (``solve_lasso_cm``, K7 on a card): screening-free, so even a
        screening bug cannot survive it; the cost is the full O(np) sweep
        per epoch that SAIF exists to avoid."""
        from repro_torch.core import api
        sess = self.session
        if isinstance(sess.penalty, api.GroupPenalty):
            return None              # the reference has no group rung
        fusedp = isinstance(sess.penalty, api.FusedPenalty)
        failed = self._last_unit_ok
        X, y, _ = self._device_design(sess)
        Xs, ys, _ = self._solved_design(sess)

        if isinstance(request, api.Update):
            lam = getattr(sess, "_last_lam", None)
            if value is None or lam is None:
                return None
            # the streamed problem lives in the session's padded
            # preparation; zero pad rows make the unscreened LS oracle
            # exact there
            out = self._oracle_solve(Xs, ys, float(lam), None)
            if out is None:
                return None
            beta, gap = out
            return _result_like(value, beta, gap), sess

        if isinstance(request, api.Scalar):
            w = None if fusedp else self.problem.weights
            out = self._oracle_solve(Xs, ys, float(request.lam), w)
            if out is None:
                return None
            beta, gap = out
            if fusedp:
                from repro_torch.core.fused import recover_from_transformed
                rec, res = value
                return (recover_from_transformed(beta, sess._design),
                        _result_like(res, beta, gap)), sess
            return _result_like(value, beta, gap), sess

        if isinstance(request, api.Path):
            pr = value.path if fusedp else value
            betas, results = list(pr.betas), list(pr.results)
            for i, lam in enumerate(pr.lams):
                if i < len(failed) and failed[i]:
                    continue
                out = self._oracle_solve(Xs, ys, float(lam), None)
                if out is None:
                    return None
                b, g = out
                betas[i] = b
                results[i] = _result_like(results[i], b, g)
            from repro_torch.core.path import SaifPathResult
            pr2 = SaifPathResult(lams=pr.lams, betas=betas,
                                 results=results,
                                 n_compilations=pr.n_compilations)
            if fusedp:
                from repro_torch.core.fused import (FusedPathResult,
                                                    recover_from_transformed)
                rec = [recover_from_transformed(b, sess._design)
                       for b in betas]
                return FusedPathResult(lams=pr.lams, betas=rec,
                                       path=pr2), sess
            return pr2, sess

        if isinstance(request, api.Fleet):
            from repro_torch.core.saif import as_tensor
            Y = as_tensor(request.Y, X.device, X.dtype)
            Y = Y[None, :] if Y.ndim == 1 else Y
            B = Y.shape[0]
            lams = np.broadcast_to(_lams(request.lams).reshape(-1), (B,)).copy()
            W = request.weights
            if W is not None:
                W = as_tensor(W, X.device, X.dtype)
            beta, gap = value.beta.clone(), value.gap.clone()
            n_act = value.n_active.clone()
            ovf = value.overflowed.clone()
            for b in range(B):
                if b < len(failed) and failed[b]:
                    continue
                w_b = None if W is None else (W if W.ndim == 1 else W[b])
                out = self._oracle_solve(X, Y[b], float(lams[b]), w_b)
                if out is None:
                    return None
                ob, og = out
                beta[b] = ob
                gap[b] = og
                n_act[b] = (ob.abs() > 0).sum()
                ovf[b] = False
            return value._replace(beta=beta, gap=gap, n_active=n_act,
                                  overflowed=ovf), sess

        if isinstance(request, (api.CV, api.Select)):
            if value.beta is None:
                return None
            if isinstance(request, api.CV):
                lam, Xo, yo = value.best_lam, X, y
            else:
                lam, Xo, yo = value.lam, Xs, ys
            out = self._oracle_solve(Xo, yo, float(lam), None)
            if out is None:
                return None
            beta, gap = out
            res = value.best_result
            if res is not None:
                res = _result_like(res, beta, gap)
            return value._replace(beta=beta, best_result=res), sess

        return None

    def _reopens_another_problem(self, request) -> bool:
        """The grow and x64 rungs re-open ``self.problem``. Replaying an
        Update there would apply its rows to the original design, and a
        streaming session's Scalar, Path or Select answers its resident
        rows, not the original ones: neither rung applies (the oracle
        rung re-solves the resident rows instead)."""
        from repro_torch.core import api
        return isinstance(request, api.Update) or (
            self._streamed(self.session)
            and isinstance(request, (api.Scalar, api.Path, api.Select)))

    def _oracle_solve(self, X, y, lam: float, sample_w):
        """One unscreened CM solve to the serving tolerance, plus its own
        duality-gap certificate. Weighted least squares rides the
        sqrt-weight row rescaling; weighted non-quadratic losses have no
        oracle here (the rung reports 'skipped')."""
        import torch
        from repro_torch.core.cm import solve_lasso_cm
        from repro_torch.core.duality import duality_gap, feasible_dual
        from repro_torch.core.losses import get_loss
        from repro_torch.core.saif import as_tensor
        cfg = self.session.config
        loss = get_loss(cfg.loss)
        if sample_w is not None:
            if cfg.loss != "least_squares":
                return None
            sw = torch.sqrt(as_tensor(sample_w, X.device, X.dtype))
            X, y = X * sw[:, None], y * sw
        tol = float(getattr(cfg, "eps", 1e-6))
        unpen = getattr(cfg, "unpen_idx", None)
        beta = solve_lasso_cm(loss, X, y, float(lam), tol=tol,
                              unpen_idx=unpen)
        pen = x_unpen = None
        if unpen is not None:
            pen = torch.ones(X.shape[1], dtype=X.dtype, device=X.device)
            pen[unpen] = 0.0
            x_unpen = X[:, unpen]
        hat = -loss.grad(X @ beta, y) / lam
        theta = feasible_dual(loss, X, y, hat, lam, pen=pen,
                              x_unpen=x_unpen)
        gap = duality_gap(loss, X, y, beta, theta, lam, pen=pen)
        return beta, gap

    def _rung_x64(self, request):
        """Last rung: the whole problem re-cast to float64, for
        precision-floor failures where the certificate bottomed out above
        the verdict tolerance in float32. torch has no x64 switch: the
        rung is skipped only when X and y are float64 already."""
        from repro_torch.core import api
        if isinstance(self.session.penalty, api.GroupPenalty):
            return None              # the reference has no group rung
        if self._reopens_another_problem(request):
            return None
        pb = self.problem

        def f64(a):
            if a is None:
                return None
            if _is_tensor(a):
                import torch
                return a.to(torch.float64)
            return np.asarray(a, np.float64)

        def is_f64(a):
            return a is None or str(_arr(a).dtype) in ("float64",
                                                       "torch.float64")
        if is_f64(pb.X) and is_f64(pb.y):
            return None
        p64 = api.Problem(f64(pb.X), f64(pb.y), loss=pb.loss,
                          penalty=pb.penalty, weights=f64(pb.weights))
        tmp = self._temp_session(p64, self.session.config)
        req2 = dataclasses.replace(request, warm=False) \
            if isinstance(request, (api.Scalar, api.Path)) else request
        return tmp.solve(req2), tmp

    # ------------------------------------------------------------------
    # warm checkpoint / restore
    # ------------------------------------------------------------------

    def checkpoint(self) -> Optional[str]:
        """Atomically snapshot the session's device-resident warm state.
        Layout: the ckpt module's one-.npy-per-leaf directory (the
        reference's leaf names ``idx``, ``beta``, ``mask``, ``G``, ``rho``,
        ``gidx``) with the leaf shapes/dtypes and the problem digest in
        meta ``extra``: restore needs no caller-supplied structure. No-op
        (None) without a ckpt_dir or before the first warm harvest."""
        ser = self.serving
        warm = self.session.warm_state
        if ser.ckpt_dir is None or warm is None:
            return None
        idx, beta, mask, inner = warm
        tree = {"idx": idx, "beta": beta, "mask": mask,
                "G": inner.G, "rho": inner.rho, "gidx": inner.gidx}
        leaves = {k: {"shape": list(v.shape),
                      "dtype": str(v.dtype).replace("torch.", "")}
                  for k, v in tree.items()}
        extra = {"kind": "saif-warm-state",
                 "k_max": self.session.warm_capacity,
                 "digest": self._digest(), "leaves": leaves,
                 "requests": self._requests}
        from repro_torch.ckpt import checkpoint as ck
        self._step += 1
        return ck.save(ser.ckpt_dir, self._step, tree, extra=extra)

    def _maybe_restore(self) -> bool:
        """Resume warm from the latest matching checkpoint: digest-gated
        (a checkpoint of a different problem is ignored, not an error),
        structure rebuilt from the recorded shapes/dtypes, the leaves on
        the session's device."""
        from repro_torch.ckpt import checkpoint as ck
        ser = self.serving
        step = ck.latest_step(ser.ckpt_dir)
        if step is None:
            return False
        try:
            meta = ck.load_meta(ser.ckpt_dir, step)
        except (OSError, ValueError):    # torn/garbage dir: stay cold
            return False
        extra = meta.get("extra", {})
        if extra.get("kind") != "saif-warm-state" \
                or extra.get("digest") != self._digest():
            return False
        import torch
        from repro_torch.core.inner_backend import InnerCarry
        dev = self.session.device
        like = {k: torch.zeros(tuple(v["shape"]),
                               dtype=_torch_dtype(v["dtype"]), device=dev)
                for k, v in extra["leaves"].items()}
        tree, _ = ck.restore(ser.ckpt_dir, step, like)
        warm = (tree["idx"], tree["beta"], tree["mask"],
                InnerCarry(G=tree["G"], rho=tree["rho"],
                           gidx=tree["gidx"]))
        self.session.set_warm_state(warm, extra["k_max"])
        self._step = step
        return True

    def _digest(self) -> str:
        """Problem identity for checkpoint gating: the session's memoized
        content digest of the (design, response) it solves, plus the
        weights, the loss, the penalty spec and the unpenalized slot.
        Backend knobs are deliberately excluded: warm state survives a
        breaker's backend swap."""
        h = hashlib.sha256()
        h.update(self.session.content_digest().encode())
        w = self.problem.weights
        if w is None:
            h.update(b"<none>")
        else:
            a = np.ascontiguousarray(
                w.detach().cpu().numpy() if _is_tensor(w) else np.asarray(w))
            h.update(str(a.shape).encode())
            h.update(str(a.dtype).encode())
            h.update(a.tobytes())
        h.update(self.problem.loss.encode())
        h.update(repr(self.session.penalty).encode())
        h.update(str(getattr(self.session.config,
                             "unpen_idx", None)).encode())
        return h.hexdigest()

    def close(self) -> None:
        """Flush pending async checkpoint writes, take a final warm
        snapshot and release the SIGTERM hook."""
        from repro_torch.ckpt import checkpoint as ck
        ck.wait_pending()
        self.checkpoint()
        if self.guard is not None:
            self.guard.uninstall()


def _score(kkt: float, gap: float) -> float:
    """Ladder candidate ranking: lower is better, NaN is worst."""
    s = kkt if math.isfinite(kkt) else float("inf")
    g = gap if math.isfinite(gap) else float("inf")
    return s if s < float("inf") else g + 1e30


def _result_like(like, beta, gap):
    """Wrap an oracle solution in the engine's result type: beta/gap
    replaced, support fields recomputed (the nonzero ids padded to the
    active capacity with -1), traces left as the failed solve's (the
    verdict's rung record is the authority on provenance)."""
    import torch
    k = like.active_idx.shape[-1]
    beta = torch.as_tensor(beta).to(like.beta.dtype)
    nz = torch.nonzero(torch.abs(beta) > 0).flatten()[:k]
    nz = torch.nn.functional.pad(nz, (0, k - nz.shape[0]), value=-1)
    nz = nz.to(like.active_idx.dtype)
    return like._replace(
        beta=beta, gap=torch.as_tensor(gap).to(like.gap.dtype),
        n_active=int((torch.abs(beta) > 0).sum()),
        overflowed=False, active_idx=nz, active_mask=nz >= 0)


def open_serving(problem, config=None, *, serving=None, guard=None,
                 install_sigterm: bool = False,
                 **session_kwargs) -> ServingSession:
    """Open a fault-tolerant serving session.

    Same signature as :func:`repro_torch.core.api.open_session` (the
    passthrough ``session_kwargs`` are the one shared spec
    ``repro_torch.core.api.SESSION_KWARG_DEFAULTS``: ``device``, ``mesh``,
    ``segment_len``, ``make_screen``, ``pad_to``, ``warm_cache``) plus
    ``serving`` (a :class:`ServingConfig`) and preemption wiring:
    ``install_sigterm=True`` installs a
    :class:`~repro_torch.runtime.fault.PreemptionGuard` whose SIGTERM flag
    makes the next ``solve`` checkpoint the warm state; passing an existing
    ``guard`` reuses one. With ``serving.ckpt_dir`` set, a matching
    checkpoint is restored at open."""
    if guard is None and install_sigterm:
        from repro_torch.runtime.fault import PreemptionGuard
        guard = PreemptionGuard(install=True)
    return ServingSession(problem, config, serving=serving, guard=guard,
                          **session_kwargs)
