"""Admission control for the Session API (port of the admission part of
``repro.core.serving``, its lines 72-315).

:func:`validate_problem` and :func:`validate_request` reject non-finite
data, degenerate zero-norm columns, lam <= 0 and shape mismatches with a
typed error taxonomy before anything reaches an engine. Each type also
IS the builtin it historically surfaced as (``ValueError``,
``ArithmeticError``, ``RuntimeError``, ``TimeoutError``), so callers that
catch those keep working.

Data may be numpy arrays (or anything ``np.asarray`` takes) or torch
tensors. A tensor is checked on its own device: a design on the card is
never copied to the host (``np.asarray`` of a CUDA tensor raises, and a
full-size design is most of a gigabyte). The errors and their messages
are the same either way.

Module scope imports only stdlib and numpy, so constructing a
:class:`~repro_torch.core.api.Problem` (which validates here) keeps the
lazy public surface of ``repro_torch/__init__.py``; torch is imported only
where a tensor is seen. The rest of the reference module (``Verdict``,
``ServingSession``, the grow -> oracle -> x64 ladder, the fault runtime)
is the next slice of the Session port (ROADMAP A6.2).
"""
from __future__ import annotations

import math
import sys

import numpy as np

__all__ = [
    "ServingError", "RequestError", "NumericalError", "BackendFault",
    "DeadlineExceeded", "validate_problem", "validate_request",
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
