"""The Problem/Session serving API: one declarative spec, one long-lived
session for every SAIF workload (port of ``repro.core.api``).

Safe screening sells best as a reusable pre-solve service, not a one-shot
call, and the engines price their economics that way: preparation (c0,
the column norms, the Theorem-6 transform) is one-time, and the warm slot
buffers hand device-resident state from one solve to the next. The
session is the object that owns that state across calls:

  * :class:`Problem`: the declarative spec: design ``X``, response(s)
    ``y``, ``loss``, penalty in {:func:`lasso` (default), :func:`fused`
    (tree ``parent``), :func:`group` (``gsize``)}, optional sample
    ``weights``. Admission control runs at construction
    (``core/serving.py``).
  * :func:`open_session`: prepares exactly once, on the session's device,
    resolves the screen backend and rule (a group session has neither),
    and returns a :class:`Session`.
  * ``session.solve(request)``: ONE entry point for every workload:
    :class:`Scalar`, :class:`Path`, :class:`Fleet`, :class:`CV`,
    :class:`~repro_torch.core.select.Select` and
    :class:`~repro_torch.core.online.Update` (online row updates).

Dispatch lands on the port's engines (``solve_scalar``, ``run_path``,
``fleet_solve``, ``cv_solve``, ``select_solve``, ``group_solve``), so a
cold request is bit for bit the direct call on the same device. The
legacy frontends (``saif_path``, ``saif_batch``, ``cv_path``,
``saif_fused``, ``fused_path``, ``group_saif``) are deprecated shims over
one-shot sessions.

Default requests are cold (bitwise-reproducible); ``Scalar(lam,
warm=True)`` / ``Path(lams, warm=True)`` enter from the session's warm
state: the previous serial solve's slot layout and inner (Gram) carry.
A session opened with a :class:`~repro_torch.core.warm_cache.WarmCache`
serves cold plain-LASSO requests through the cross-request homotopy
cache.

Where the port differs from the reference:

  * ``device`` is a session kwarg (the shared spec's one extra knob):
    ``None`` means the card, and opening raises without one; ``"cpu"``
    runs the plain path. The session prepares once there, and every
    request runs there.
  * ``sharded`` requests (a mesh from ``repro_torch.launch.mesh``) take
    the sharded design's c0 and norms from the session's own preparation
    and read the real p in every policy formula, so each is bit for bit
    the session's unsharded answer; a cold sharded Scalar refreshes the
    sharded warm state as an unsharded one refreshes its own.
  * :meth:`Session.content_digest` is reset by every committed
    ``Update``, so a digest never names rows the session no longer
    holds.
  * The port is eager: it has no compilation cache per static key, so
    :class:`CompileStats` reads 0 compilations and
    :func:`unified_compile_count` returns 0.

This module imports no torch and no engine at module scope: ``from
repro_torch import Problem, Scalar, open_session`` stays cheap, and the
engines load on first use.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple, Optional, Tuple

import numpy as np

# import-light request types, re-exported
from repro_torch.core.online import Update
from repro_torch.core.select import Select, SelectionReport

__all__ = [
    "Problem", "Session", "open_session",
    "Scalar", "Path", "Fleet", "CV", "Update", "Select", "SelectionReport",
    "lasso", "fused", "group",
    "LassoPenalty", "FusedPenalty", "GroupPenalty",
    "GroupPathResult", "CompileStats", "unified_compile_count",
    "SESSION_KWARG_DEFAULTS", "session_kwargs",
]


# ---------------------------------------------------------------------------
# penalty specs (plain data, no engine imports)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LassoPenalty:
    """Plain l1 penalty (the paper's Sections 2-3 problem)."""


@dataclasses.dataclass(frozen=True)
class FusedPenalty:
    """Tree fused-LASSO penalty ``lam * ||D beta||_1`` over the tree
    encoded by ``parent`` (Sec 4). The session performs the Theorem-6
    transform exactly once at ``open_session``."""
    parent: Any                       # (p,) parent ids, -1 at the root
    transform_backend: str = "auto"   # "auto" | "torch" | "cuda"


@dataclasses.dataclass(frozen=True)
class GroupPenalty:
    """Disjoint equal-size group-LASSO penalty (the paper's proposed
    extension; its engine is :mod:`repro_torch.core.group`)."""
    gsize: int


def lasso() -> LassoPenalty:
    """Penalty spec: plain LASSO (also the default, spelled ``"lasso"``)."""
    return LassoPenalty()


def fused(parent, transform_backend: str = "auto") -> FusedPenalty:
    """Penalty spec: tree fused LASSO over ``parent`` (-1 marks the root)."""
    return FusedPenalty(parent=np.asarray(parent),
                        transform_backend=transform_backend)


def group(gsize: int) -> GroupPenalty:
    """Penalty spec: group LASSO with consecutive groups of size ``gsize``."""
    return GroupPenalty(gsize=int(gsize))


def _coerce_penalty(pen) -> Any:
    if pen is None or (isinstance(pen, str) and pen == "lasso"):
        return LassoPenalty()
    if isinstance(pen, (LassoPenalty, FusedPenalty, GroupPenalty)):
        return pen
    raise TypeError(
        f"unknown penalty spec {pen!r}: use 'lasso', lasso(), "
        f"fused(parent) or group(gsize)")


# ---------------------------------------------------------------------------
# the declarative problem spec + requests
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class Problem:
    """What to solve, independent of how and how often it is served.

    ``X`` and ``y`` are numpy arrays or tensors (a tensor on the card
    stays there). ``y`` may be omitted for a fleet-only session (every
    :class:`Fleet` request carries its own responses). ``weights`` are
    optional sample weights for the default response; weighted problems
    ride the fleet engine, the one place the weighted algebra lives.
    """
    X: Any
    y: Any = None
    loss: str = "least_squares"
    penalty: Any = "lasso"
    weights: Any = None

    def __post_init__(self):
        # admission control: non-finite data, zero-norm columns and shape
        # mismatches fail here with a typed error, before any engine
        from repro_torch.core.serving import validate_problem
        validate_problem(self)


@dataclasses.dataclass(frozen=True)
class Scalar:
    """One solve at ``lam``. ``warm=True`` seeds from the session's warm
    state (slot layout and inner carry of the previous serial solve); the
    default is a cold, bitwise-reproducible solve. ``deadline_s`` and
    ``priority`` are the serving knobs every request carries (read by
    :class:`~repro_torch.core.serving.ServingSession`)."""
    lam: float
    warm: bool = False
    sharded: bool = False
    deadline_s: Optional[float] = None
    priority: int = 0

    def __post_init__(self):
        from repro_torch.core.serving import validate_request
        validate_request(self)


@dataclasses.dataclass(frozen=True, eq=False)
class Path:
    """A descending lambda grid on the path engine. ``warm=True`` enters
    the grid from the session's warm state instead of the cold top-h
    start."""
    lams: Any
    warm: bool = False
    sharded: bool = False
    deadline_s: Optional[float] = None
    priority: int = 0

    def __post_init__(self):
        from repro_torch.core.serving import validate_request
        validate_request(self)


@dataclasses.dataclass(frozen=True, eq=False)
class Fleet:
    """B solves over the shared design: responses ``Y`` ((B, n); an (n,)
    vector is a fleet of 1), scalar-or-(B,) ``lams``, optional (B, n)
    sample ``weights``. ``screen_fn`` is the hook for a custom fleet
    screen (a :data:`~repro_torch.core.screen_backend.BatchScreenFn`
    sized for the fleet's h); it runs on the bitwise engine."""
    Y: Any
    lams: Any
    weights: Any = None
    sharded: bool = False
    screen_fn: Any = None
    deadline_s: Optional[float] = None
    priority: int = 0

    def __post_init__(self):
        from repro_torch.core.serving import validate_request
        validate_request(self)


@dataclasses.dataclass(frozen=True, eq=False)
class CV:
    """K-fold cross-validation over a lambda grid (the fold fleet),
    scored by mean held-out loss, optionally refit at the winner."""
    n_folds: int
    lams: Any
    seed: int = 0
    keep_fold_betas: bool = False
    refit: bool = True
    sharded: bool = False
    deadline_s: Optional[float] = None
    priority: int = 0

    def __post_init__(self):
        from repro_torch.core.serving import validate_request
        validate_request(self)


class GroupPathResult(NamedTuple):
    """Lambda path over a group-LASSO problem (a session-only workload:
    the legacy surface had no group path)."""
    lams: np.ndarray
    betas: List[Any]
    results: List[Any]
    n_compilations: Optional[int] = None


# ---------------------------------------------------------------------------
# the shared session-kwargs spec
# ---------------------------------------------------------------------------

SESSION_KWARG_DEFAULTS = {
    "mesh": None,          # device mesh enabling sharded=True requests
    "segment_len": 16,     # path-engine overflow-check segment length
    "make_screen": None,   # custom ScreenFn factory (h -> ScreenFn)
    "pad_to": None,        # (n_bucket, p_bucket) bucket padding
    "warm_cache": None,    # shared cross-request homotopy WarmCache
    "device": None,        # the port's: None = the card, "cpu" = plain path
}


def session_kwargs(**kw) -> dict:
    """Validate and normalize the shared session passthrough kwargs."""
    unknown = sorted(set(kw) - set(SESSION_KWARG_DEFAULTS))
    if unknown:
        raise TypeError(
            f"unknown session kwargs {unknown}; the shared spec accepts "
            f"{sorted(SESSION_KWARG_DEFAULTS)}")
    out = dict(SESSION_KWARG_DEFAULTS)
    out.update(kw)
    return out


# ---------------------------------------------------------------------------
# compile accounting
# ---------------------------------------------------------------------------

class CompileStats(NamedTuple):
    """The reference's unified view of its jit caches. The port is eager
    and compiles nothing per static key, so ``serial``, ``fleet``,
    ``group``, ``total`` and ``since_open`` are 0; ``requests`` counts the
    requests the session served."""
    serial: int
    fleet: int
    group: int
    total: int
    since_open: int
    requests: int


def unified_compile_count() -> int:
    """Solver compilations alive in this process: 0, the port is eager."""
    return 0


# ---------------------------------------------------------------------------
# the session
# ---------------------------------------------------------------------------

def _row(res, i: int):
    """Row ``i`` of a fleet's stacked SaifResult (its inner carry too)."""
    return type(res)(*[type(f)(*[t[i] for t in f]) if isinstance(f, tuple)
                       else f[i] for f in res])


class Session:
    """A long-lived solver for one :class:`Problem`.

    Owns, for its whole lifetime: the one-time preparation on its device
    (the ``PathState`` statistics, the Theorem-6 ``FusedDesign``), the
    resolved screen backend and rule, the per-h memo of a ``make_screen``
    hook, the device-resident warm state of the last serial solve (used
    by ``warm=True`` requests), and the request count behind
    :meth:`compile_stats`.

    Construct via :func:`open_session`. Results are the engines' own
    types (``SaifResult``, ``SaifPathResult``, ``FusedPathResult``,
    ``CVPathResult``, ``SelectionReport``, ``GroupSaifResult``,
    ``GroupPathResult``), and a cold request is bit for bit the direct
    engine call.
    """

    def __init__(self, problem: Problem, config=None, **kwargs):
        kw = session_kwargs(**kwargs)
        self.problem = problem
        self.penalty = _coerce_penalty(problem.penalty)
        self.mesh = kw["mesh"]
        self._segment_len = kw["segment_len"]
        self._make_screen = kw["make_screen"]
        self._pad_to = kw["pad_to"]
        self._p_real = None             # real width when pad_to is set
        self._screen_memo = {}          # h -> ScreenFn (make_screen hook)
        self._warm = None               # serial WarmState handoff
        self._warm_k = None
        self._gprep = None              # GroupPrep of a group session
        self._gwarm = None              # group (gidx, gmask, beta_slots)
        self._requests = 0
        self._warm_cache = kw["warm_cache"]  # shared WarmCache or None
        self._online = None             # OnlineState once streaming
        self._last_lam = None           # last solved lambda (Update default)
        self._pending_events = []       # provenance, drained by serving
        self._cache_last = None         # (digest, lam) of last cache store
        self._digest_memo = None        # problem digest, reset per Update
        self._sharded = None            # ShardedDesign, placed lazily
        self._sharded_prep = None       # PathState over it
        self._sharded_screen_memo = {}  # h -> sharded ScreenFn
        self._sharded_warm = None       # the sharded warm handoff
        self._sharded_warm_k = None
        self._sharded_fleet = None      # the Fleet's, sharing X_local
        self._sharded_fleet_screens = {}  # h -> sharded BatchScreenFn

        if problem.X is None:
            raise ValueError("Problem.X is required")

        if self._pad_to is not None:
            # bucket padding: the session holds a bucket-shaped
            # preparation whose statistics were computed on the real
            # problem; results are sliced back to the real width
            nb, pb = (int(self._pad_to[0]), int(self._pad_to[1]))
            n0, p0 = np.shape(problem.X)
            if nb < n0 or pb < p0:
                raise ValueError(
                    f"pad_to={self._pad_to} must dominate the problem "
                    f"shape ({n0}, {p0}) — buckets only pad, never crop")
            if problem.loss == "logistic" and nb > n0:
                raise NotImplementedError(
                    "row padding a logistic problem shifts the primal by "
                    "log(2) per pad row (the zero-row trick is exact for "
                    "least squares only); bucket logistic requests on "
                    "exact n (p-only padding)")
            if problem.weights is not None:
                raise NotImplementedError(
                    "pad_to with sample weights: weighted problems ride "
                    "the fleet engine with per-problem column norms; "
                    "serve them from an unpadded session")
            if self._make_screen is not None:
                raise NotImplementedError(
                    "pad_to with a custom make_screen: the built-in "
                    "screens mask pad columns through the active mask; a "
                    "custom backend would need its own masking")
            if not isinstance(self.penalty, LassoPenalty):
                raise NotImplementedError(
                    "pad_to serves plain-LASSO problems (the fused "
                    "transform and group layout are shape-coupled)")
            self._pad_to = (nb, pb)
            self._p_real = p0

        from repro_torch.core.saif import (SaifConfig, as_tensor,
                                           pad_path_state, prepare_path,
                                           resolve_device)
        if isinstance(self.penalty, GroupPenalty):
            self._open_group(problem, config, resolve_device(kw["device"]))
            return

        from repro_torch.core.screen_backend import (resolve_backend,
                                                     resolve_batch_screen,
                                                     resolve_screen_rule)
        self.device = dev = resolve_device(kw["device"])
        cfg = config if config is not None else SaifConfig()
        if cfg.loss != problem.loss:
            cfg = dataclasses.replace(cfg, loss=problem.loss)

        if isinstance(self.penalty, FusedPenalty):
            from repro_torch.core.fused import prepare_fused
            if problem.weights is not None:
                raise NotImplementedError(
                    "weighted fused problems are not supported")
            # the one-time Theorem-6 transform (K4 on a chain on the
            # card), the preparation a fused session amortizes
            self._design = prepare_fused(problem.X, self.penalty.parent,
                                         self.penalty.transform_backend, dev)
            cfg = dataclasses.replace(cfg, unpen_idx=self._design.unpen_idx)
            self.config = cfg
            self._X = self._design.Xt
            if problem.y is not None:
                self._y = as_tensor(problem.y, dev, self._X.dtype)
                self._prep = prepare_path(self._X, self._y, cfg, dev)
            else:
                self._y = self._prep = None
        else:
            self._design = None
            self.config = cfg
            if problem.weights is not None and self._make_screen is not None:
                raise NotImplementedError(
                    "make_screen with a weighted problem: the fleet "
                    "engine serving weighted problems takes per-request "
                    "Fleet(..., screen_fn=...) hooks instead")
            # the design on the session's device, once (no copy when it
            # already lies there)
            self._X = as_tensor(problem.X, dev)
            self._y = (None if problem.y is None
                       else as_tensor(problem.y, dev, self._X.dtype))
            if problem.y is not None and problem.weights is None:
                self._prep = prepare_path(self._X, self._y, cfg, dev)
                if self._pad_to is not None:
                    self._prep = pad_path_state(self._prep, *self._pad_to)
            else:
                self._prep = None
        try:
            self.screen_backend = resolve_backend(cfg.screen_backend, dev)
        except ValueError:
            # fleet-only screen modes (the opt-in "matmul") resolve through
            # the fleet policy; serial requests on such a session fail at
            # the engine. An unknown name raises here.
            self.screen_backend = resolve_batch_screen(cfg.screen_backend,
                                                       dev)
        # the certificate geometry, validated at open
        self.screen_rule = resolve_screen_rule(cfg.screen_rule)

    def _open_group(self, problem: Problem, config, device) -> None:
        """The group arm of the open: a ``SaifConfig`` is mapped onto a
        ``GroupSaifConfig`` (the shared fields), and ``prepare_group``
        runs once on the session's device."""
        from repro_torch.core.group import GroupSaifConfig, prepare_group
        self.device = device
        cfg = config if config is not None else GroupSaifConfig()
        if not isinstance(cfg, GroupSaifConfig):
            cfg = GroupSaifConfig(
                eps=cfg.eps, inner_epochs=cfg.inner_epochs,
                polish_factor=cfg.polish_factor, k_max=cfg.k_max,
                max_outer=cfg.max_outer, loss=cfg.loss)
        if cfg.loss != problem.loss:
            cfg = dataclasses.replace(cfg, loss=problem.loss)
        self.config = cfg
        if problem.y is None:
            raise ValueError("group sessions need Problem.y")
        if problem.weights is not None:
            raise NotImplementedError(
                "weighted group problems are not supported")
        self._gprep = prepare_group(problem.X, problem.y,
                                    self.penalty.gsize, cfg, self.device)
        self._design = self._prep = None
        self._X, self._y = self._gprep.X, self._gprep.y
        self.screen_backend = None   # the group engine has no pluggable
        self.screen_rule = None      # screen backend (nor rule)

    # ------------------------------------------------------------------
    # the one entry point
    # ------------------------------------------------------------------

    def solve(self, request):
        """Serve one request; see :class:`Scalar` / :class:`Path` /
        :class:`Fleet` / :class:`CV` / ``Select`` for the workloads."""
        self._requests += 1
        if isinstance(request, Scalar):
            return self._solve_scalar(request)
        if isinstance(request, Path):
            return self._solve_path(request)
        if isinstance(request, Fleet):
            return self._solve_fleet(request)
        if isinstance(request, CV):
            return self._solve_cv(request)
        if isinstance(request, Update):
            return self._solve_update(request)
        if isinstance(request, Select):
            return self._solve_select(request)
        raise TypeError(f"unknown request {request!r}: expected Scalar, "
                        f"Path, Fleet, CV, Update or Select")

    def update(self, rows=None, responses=None, request=None, **kw):
        """Streaming verb: ``solve(Update(rows, responses, ...))``."""
        if isinstance(rows, Update):
            request = rows
        if request is None:
            request = Update(rows=rows, responses=responses, **kw)
        return self.solve(request)

    def select(self, request=None, **kw):
        """Auto-lambda verb: ``solve(Select(...))``; returns a
        :class:`~repro_torch.core.select.SelectionReport`."""
        if request is None:
            request = Select(**kw)
        return self.solve(request)

    # ------------------------------------------------------------------
    # warm boundary state
    # ------------------------------------------------------------------

    @property
    def warm_state(self):
        """The device-resident serial warm state, the ``(idx, beta, mask,
        InnerCarry)`` tuple ``run_path`` hands across requests, or None
        before the first serial solve."""
        return self._warm

    @property
    def warm_capacity(self):
        """Capacity (k_max) the warm state was built at, or None."""
        return self._warm_k

    def set_warm_state(self, warm, k_max) -> None:
        """Install a warm state (e.g. restored from a checkpoint); the next
        ``Scalar/Path(warm=True)`` request enters from it as if the
        previous solve had produced it."""
        self._warm = warm
        self._warm_k = None if k_max is None else int(k_max)

    def compile_stats(self) -> CompileStats:
        """See :class:`CompileStats`: 0 compilations, the request count."""
        return CompileStats(serial=0, fleet=0, group=0, total=0,
                            since_open=0, requests=self._requests)

    # ------------------------------------------------------------------
    # provenance events + cross-request homotopy cache
    # ------------------------------------------------------------------

    def _push_event(self, name: str) -> None:
        self._pending_events.append(name)

    def drain_events(self) -> Tuple[str, ...]:
        """Hand back (and clear) the provenance events of the warm-cache
        path (``warm_cache_hit:lam0=..``, ``warm_cache_miss``)."""
        events, self._pending_events = tuple(self._pending_events), []
        return events

    def content_digest(self) -> str:
        """Content digest of the (design, response) the session solves
        (:func:`~repro_torch.core.warm_cache.problem_digest` of its
        preparation: the padded arrays of a bucket-padded session, the
        transformed design of a fused one, the resident rows of a
        streaming one), memoized until an ``Update`` changes the rows: a
        design on the card costs one host copy and its SHA-256. The warm
        cache's key and the serving checkpoints' gate."""
        if self._digest_memo is None:
            from repro_torch.core.warm_cache import problem_digest
            src = self._prep
            self._digest_memo = (problem_digest(self._X, self._y)
                                 if src is None
                                 else problem_digest(src.X, src.y))
        return self._digest_memo

    def drop_cache_entry(self) -> int:
        """Invalidate the warm-cache entry stored by the most recent
        cache-routed solve (for a result that failed certification)."""
        if self._warm_cache is None or self._cache_last is None:
            return 0
        digest, lam = self._cache_last
        self._cache_last = None
        return self._warm_cache.invalidate(digest, lam)

    def _cache_eligible(self, req) -> bool:
        """The homotopy cache serves cold plain-LASSO requests on a
        static (non-streaming), unweighted design with the built-in
        screens; everything else keeps its path."""
        return (self._warm_cache is not None and not req.warm
                and self._make_screen is None and self._design is None
                and self._online is None
                and self.problem.weights is None
                and isinstance(self.penalty, LassoPenalty))

    def _cached_entry_solve(self, lams: List[float]):
        """Solve through the homotopy cache: on a band hit, enter via the
        Theorem-2 sequential-ball seed (``path.seq_warm_entry``); on a
        miss, run the bitwise cold path. Either way the exit warm state is
        stored for the next request."""
        from repro_torch.core.path import run_path, seq_warm_entry
        cache = self._warm_cache
        digest = self.content_digest()
        lam_hi = max(lams)
        entry = cache.lookup(digest, lam_hi)
        if entry is not None:
            warm0, k0 = seq_warm_entry(self._prep, entry.warm, entry.k_max,
                                       entry.lam0, lam_hi, self.config)
            self._push_event(f"warm_cache_hit:lam0={entry.lam0:.6g}")
        else:
            warm0, k0 = None, None
            self._push_event("warm_cache_miss")
        pr, warm, k_max = run_path(self._prep, lams, self.config,
                                   segment_len=self._segment_len,
                                   warm0=warm0, k_max0=k0)
        self._warm, self._warm_k = warm, k_max
        lam_lo = min(lams)
        cache.store(digest, lam_lo, warm, k_max)
        self._cache_last = (digest, lam_lo)
        return pr

    # ------------------------------------------------------------------
    # dispatch arms
    # ------------------------------------------------------------------

    def _require_y(self):
        if self.problem.y is None:
            raise ValueError(
                "this request needs a response: the session was opened "
                "without Problem.y (fleet-only)")

    def _memo_make_screen(self, h: int):
        if h not in self._screen_memo:
            self._screen_memo[h] = self._make_screen(h)
        return self._screen_memo[h]

    def _hook(self):
        return None if self._make_screen is None else self._memo_make_screen

    def _run_path(self, lams, warm: bool):
        """The path engine from the session's preparation, entered from
        its warm state (``warm``) or cold; refreshes the warm state."""
        from repro_torch.core.path import run_path
        pr, self._warm, self._warm_k = run_path(
            self._prep, lams, self.config, make_screen=self._hook(),
            segment_len=self._segment_len,
            warm0=self._warm if warm else None,
            k_max0=self._warm_k if warm else None)
        return pr

    def _warm_of(self, res):
        """The (warm state, capacity) a serial result hands on."""
        from repro_torch.core.path import _warm_state
        unpen = self.config.unpen_idx
        return (_warm_state(res.active_idx, res.active_mask, res.beta,
                            res.inner,
                            unpen_idx=-1 if unpen is None else unpen),
                int(res.active_idx.shape[0]))

    def _harvest_warm(self, res):
        self._warm, self._warm_k = self._warm_of(res)

    def _refuse_group_sharded(self, req) -> None:
        if req.sharded:
            raise NotImplementedError(
                "sharded group screening is not implemented")

    def _solve_scalar(self, req: Scalar):
        if self._gprep is not None:
            self._refuse_group_sharded(req)
            from repro_torch.core.group import group_solve
            res = group_solve(self._gprep, float(req.lam), self.config,
                              warm=self._gwarm if req.warm else None)
            self._gwarm = (res.gidx, res.gmask, res.beta_slots)
            return res
        self._require_y()
        lam = float(req.lam)
        if self.problem.weights is not None:
            if req.sharded:
                raise NotImplementedError(
                    "weighted sharded solves: per-problem column norms "
                    "live on the replicated path for now")
            if req.warm:
                raise NotImplementedError(
                    "warm weighted solves: the fleet engine serving "
                    "weighted problems has no cross-request warm handoff")
            return self._weighted_scalar(lam)
        if req.sharded:
            res = self._scalar_sharded(lam, req.warm)
        elif self._cache_eligible(req):
            # band hits enter via the Theorem-2 seed, misses run the
            # bitwise cold path; the exit warm state is cached
            res = self._cached_entry_solve([lam]).results[0]
        elif req.warm or self._make_screen is not None:
            # a single-lambda run of the path engine: bitwise the cold
            # solve_scalar when entered cold, and the engine that threads
            # the warm handoff and the make_screen hook
            res = self._run_path([lam], req.warm).results[0]
        else:
            from repro_torch.core.saif import solve_scalar
            res = solve_scalar(self._prep, lam, self.config,
                               device=self.device)
            self._harvest_warm(res)
        self._last_lam = lam
        if self._design is not None:
            from repro_torch.core.fused import recover_from_transformed
            return recover_from_transformed(res.beta, self._design), res
        if self._p_real is not None:
            res = res._replace(beta=res.beta[:self._p_real])
        return res

    def _weighted_scalar(self, lam: float):
        from repro_torch.core.batch import fleet_solve
        from repro_torch.core.saif import as_tensor
        w = as_tensor(self.problem.weights, self.device, self._X.dtype)
        res = fleet_solve(self._X, self._y[None], lam, self.config,
                          device=self.device, weights=w[None])
        return _row(res, 0)                 # drop the B=1 axis

    def _solve_path(self, req: Path):
        lams = [float(l) for l in req.lams]
        if self._gprep is not None:
            self._refuse_group_sharded(req)
            return self._group_path(lams, warm=req.warm)
        self._require_y()
        if self.problem.weights is not None:
            raise NotImplementedError(
                "weighted lambda paths: submit a Fleet (one lambda per "
                "weighted problem) or a CV request instead")
        if req.sharded:
            pr = self._path_sharded(lams, req.warm)
        elif self._cache_eligible(req):
            pr = self._cached_entry_solve(lams)
        else:
            pr = self._run_path(lams, req.warm)
        self._last_lam = min(lams)
        if self._p_real is not None:
            pr = pr._replace(betas=[b[:self._p_real] for b in pr.betas])
        if self._design is not None:
            from repro_torch.core.fused import (FusedPathResult,
                                                recover_from_transformed)
            betas = [recover_from_transformed(b, self._design)
                     for b in pr.betas]
            return FusedPathResult(lams=pr.lams, betas=betas, path=pr)
        return pr

    def _group_path(self, lams, warm: bool) -> GroupPathResult:
        """The group engine over ``lams`` sorted descending, each solve
        entered from the previous one's slots (the first from the
        session's warm state when ``warm``)."""
        from repro_torch.core.group import group_solve
        lams_np = np.asarray(sorted(lams, reverse=True))
        cur = self._gwarm if warm else None
        results = []
        for lam in lams_np:
            res = group_solve(self._gprep, float(lam), self.config,
                              warm=cur)
            cur = (res.gidx, res.gmask, res.beta_slots)
            results.append(res)
        self._gwarm = cur
        return GroupPathResult(lams=lams_np,
                               betas=[r.beta for r in results],
                               results=results, n_compilations=0)

    def _solve_fleet(self, req: Fleet):
        if self._gprep is not None:
            raise NotImplementedError("group fleets are not implemented")
        if self._design is not None:
            raise NotImplementedError(
                "fused fleets are serial-only, as in the reference")
        if self.problem.weights is not None:
            raise NotImplementedError(
                "Problem-level weights serve Scalar requests; fleets take "
                "per-request Fleet(..., weights=...) instead")
        if req.sharded:
            return self._fleet_sharded(req)
        from repro_torch.core.batch import fleet_solve
        if self._pad_to is not None:
            res = fleet_solve(None, None, req.lams, self.config,
                              device=self.device, prep=self._fleet_prep(req),
                              screen_fn=req.screen_fn)
            return res._replace(beta=res.beta[:, :self._p_real])
        return fleet_solve(self._X, req.Y, req.lams, self.config,
                           device=self.device, weights=req.weights,
                           screen_fn=req.screen_fn)

    def _fleet_prep(self, req: Fleet):
        """The Fleet's preparation, as ``fleet_solve`` makes it, padded to
        the session's bucket."""
        from repro_torch.core.batch import pad_fleet_prep, prepare_fleet
        fprep = prepare_fleet(self._X, req.Y, self.config,
                              weights=req.weights, device=self.device)
        if self._pad_to is not None:
            fprep = pad_fleet_prep(fprep, *self._pad_to)
        return fprep

    def _solve_cv(self, req: CV):
        if not isinstance(self.penalty, LassoPenalty):
            raise NotImplementedError(
                "cross-validation serves plain-LASSO problems")
        if req.sharded:
            raise NotImplementedError(
                "sharded CV fleets: per-fold column norms live on the "
                "replicated path for now")
        if self.problem.weights is not None:
            raise NotImplementedError(
                "weighted cross-validation is not supported: CV builds "
                "its own binary fold weights")
        self._require_y()
        from repro_torch.core.cv import cv_solve
        return cv_solve(self._X, self._y, tuple(float(l) for l in req.lams),
                        req.n_folds, self.config, seed=req.seed,
                        keep_fold_betas=req.keep_fold_betas,
                        refit=req.refit, device=self.device)

    def _solve_update(self, req: Update):
        if not isinstance(self.penalty, LassoPenalty):
            raise NotImplementedError(
                "online row updates serve plain-LASSO sessions")
        from repro_torch.core.online import apply_update
        return apply_update(self, req)

    def _solve_select(self, req: Select) -> SelectionReport:
        if not isinstance(self.penalty, LassoPenalty):
            raise NotImplementedError(
                "Session.select serves plain-LASSO problems")
        if self.problem.weights is not None:
            raise NotImplementedError(
                "weighted selection is not supported: CV and stability "
                "selection build their own binary row weights")
        self._require_y()
        from repro_torch.core.select import select_solve
        if self._online is not None:
            # a streaming session selects on its CURRENT resident rows
            # (the first `filled` buffer rows hold exactly the live data)
            n = self._prep.n_true or self._prep.X.shape[0]
            X, y = self._prep.X[:n], self._prep.y[:n]
        else:
            X, y = self._X, self._y
        report = select_solve(X, y, req, self.config, device=self.device)
        self._last_lam = float(report.lam)
        return report

    # ------------------------------------------------------------------
    # the sharded arm (built lazily, at the first sharded request; every
    # rank of the mesh must make the same requests)
    # ------------------------------------------------------------------

    def _require_mesh(self):
        if self.mesh is None:
            raise ValueError(
                "sharded=True needs a device mesh: open_session(problem, "
                "config, mesh=mesh)")

    def _place(self, prep):
        """A sharded design over ``prep`` (the session's ``PathState`` or a
        Fleet's ``FleetPrep``) with the preparation's norms, padded. X_local
        is sliced once a session, by the first placement (a view at W = 1),
        and the other shares it."""
        self._require_mesh()
        from repro_torch.distributed.saif_sharded import design_from_prep
        return design_from_prep(prep, self.mesh,
                                placed=self._sharded or self._sharded_fleet)

    def _sharded_design(self):
        """The placement over the session's preparation and the
        ``PathState`` over it."""
        if self._sharded is None:
            from repro_torch.distributed.saif_sharded import sharded_prep
            self._sharded = self._place(self._prep)
            self._sharded_prep = sharded_prep(self._prep, self._sharded)
        return self._sharded

    def _memo_sharded_screen(self, h: int):
        if h not in self._sharded_screen_memo:
            from repro_torch.distributed.saif_sharded import (
                make_sharded_screen)
            self._sharded_screen_memo[h] = make_sharded_screen(
                self._sharded, h)
        return self._sharded_screen_memo[h]

    def _scalar_sharded(self, lam: float, warm: bool):
        """The sharded Scalar, beta cut to the real width: cold,
        ``solve_scalar_sharded`` over the placement, which refreshes the
        sharded warm state; warm, a single-lambda run of the path engine
        entered from it."""
        design = self._sharded_design()
        if warm:
            res = self._path_sharded([lam], True).results[0]
            return res._replace(beta=res.beta[:design.p])
        from repro_torch.distributed.saif_sharded import solve_scalar_sharded
        res = solve_scalar_sharded(None, None, lam, self.mesh, self.config,
                                   prep=self._sharded_prep,
                                   screen_cache=self._sharded_screen_memo)
        self._sharded_warm, self._sharded_warm_k = self._warm_of(res)
        return res

    def _path_sharded(self, lams, warm: bool):
        """The path engine over the placement with the sharded screen,
        entered from (and refreshing) the sharded warm state when
        ``warm``; betas cut to the real width."""
        from repro_torch.core.path import run_path
        design = self._sharded_design()
        pr, self._sharded_warm, self._sharded_warm_k = run_path(
            self._sharded_prep, lams, self.config,
            make_screen=self._memo_sharded_screen,
            segment_len=self._segment_len,
            warm0=self._sharded_warm if warm else None,
            k_max0=self._sharded_warm_k if warm else None)
        # the unsharded arm's widths: betas the real p, results the
        # preparation's (a bucket-padded session keeps its bucket there)
        w = self._prep.X.shape[1]
        return pr._replace(betas=[b[:design.p] for b in pr.betas],
                           results=[r._replace(beta=r.beta[:w])
                                    for r in pr.results])

    def _fleet_sharded(self, req: Fleet):
        """The sharded Fleet over the unsharded Fleet's preparation (its c0
        and norms, padded) and the session's X_local: bit for bit the
        unsharded Fleet by construction. The placement is made at the
        first sharded Fleet and reused after."""
        self._require_mesh()
        if req.weights is not None:
            raise NotImplementedError(
                "weighted sharded fleets: per-fold column norms live on "
                "the replicated path for now")
        from repro_torch.distributed.saif_sharded import (
            fleet_solve_sharded, sharded_prep)
        fprep = self._fleet_prep(req)
        if self._sharded_fleet is None:
            self._sharded_fleet = self._place(fprep)
        return fleet_solve_sharded(
            None, None, req.lams, self.mesh, self.config,
            prep=sharded_prep(fprep, self._sharded_fleet),
            screen_cache=self._sharded_fleet_screens)


def open_session(problem: Problem, config=None, **kwargs) -> Session:
    """Open a long-lived solving session for ``problem``.

    Preparation (c0, the column norms, the Theorem-6 transform) runs HERE,
    exactly once, on the session's device; every later
    ``session.solve(request)`` reuses it with the session's warm buffers.
    ``config`` is a :class:`~repro_torch.core.saif.SaifConfig`.

    Keyword arguments are the shared session spec
    (:data:`SESSION_KWARG_DEFAULTS`): ``device`` (None = the card, raising
    without one; ``"cpu"`` the plain path), ``make_screen`` /
    ``segment_len`` (the path engine's hooks), ``pad_to=(n_bucket,
    p_bucket)`` (serve every request from a bucket-padded preparation),
    ``warm_cache`` (a shared :class:`~repro_torch.core.warm_cache.WarmCache`)
    and ``mesh`` (a ``DeviceMesh`` for ``sharded=True`` requests; see
    ``repro_torch.launch.mesh``).
    """
    return Session(problem, config, **kwargs)
