"""Async serving front end: queue -> shape bucket -> microbatch -> fleet
(port of ``repro.core.server``).

A :class:`~repro_torch.core.api.Session` makes one request cheap and a
:class:`~repro_torch.core.serving.ServingSession` makes it safe; this
module makes a traffic stream cheap:

* **Shape buckets**: a request's problem lands in the smallest
  ``(n_bucket, p_bucket)`` of a static grid that dominates its shape (by
  default p goes up to its next power of two, rows are never padded) and
  is served by a session opened with that ``pad_to``. Column padding is
  bit for bit inert, so a padded solve returns the unpadded solve's
  coefficients; row padding (least squares only) is exact in real
  arithmetic and certified in floats.
* **Microbatch coalescing**: cold :class:`~repro_torch.core.api.Scalar`
  requests over the same design (each with its own response and lambda,
  many users of one shared design) that wait in one bucket's queue are
  coalesced, under a ``max_wait_ms`` / ``max_batch`` policy, into one
  :class:`~repro_torch.core.api.Fleet` solved by the fleet engine in one
  dispatch (K1b, K2b and K6b or K3b on a card), whose rows are bit for
  bit the serial solves. Each rider's future resolves to its own
  :class:`~repro_torch.core.serving.ServingResult` with a per-unit
  verdict: one poisoned member fails only its own future.
* **Warm-session LRU**: dispatch goes through an LRU of
  ``ServingSession``s keyed by problem digest and bucket. The port
  compiles nothing per shape, so a readmission costs the session's
  preparation and nothing else; its kernels were built once per process
  (and persist across processes in ``build/repro_torch_kernels/``, keyed
  by source hash), which is why :class:`ServerConfig` has no
  ``cache_dir``.

Where the port differs from the reference:

* ``_problem_digest`` hashes a design once per design object: the
  SHA-256 state after the design's bytes is memoized by the object's
  identity (holding a reference, so an id is never recycled), so B
  riders with their own responses over one design on the card cost one
  host copy of it, not B. The digests are the reference's.
* A session whose breaker opened on the card stays in the LRU and rejects
  its riders with that ``BackendFault``; the server never re-opens it,
  which would hide a broken kernel.
* A failure inside a dispatch reaches every rider's future; it never
  kills the worker and is never swallowed.

The worker is one thread; it launches kernels on the sessions' device,
and the launch counters and an armed ``FaultInjector`` (module globals)
see its calls. Module scope imports only stdlib and numpy (the lazy
public surface); torch and the engines load on first dispatch.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

__all__ = ["ServerConfig", "ServerStats", "ServingFuture", "Server",
           "open_server"]


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """Policy knobs of the async front end.

    ``p_buckets`` / ``n_buckets`` define the static bucket grid: a
    request lands in the smallest bucket that dominates its shape. With
    ``p_buckets=None`` the column bucket is the next power of two of
    ``p`` (floored at ``min_p_bucket``); with ``n_buckets=None`` rows are
    never padded (the bitwise tier; row padding is opt-in because it is
    exact in real arithmetic but only support-parity in floats, and wrong
    for the logistic loss, whose pad rows would shift the primal by
    log 2 each). A shape beyond the grid falls back to its power-of-two
    bucket (counted in ``stats().bucket_fallbacks``) instead of failing.
    """
    p_buckets: Optional[Tuple[int, ...]] = None
    n_buckets: Optional[Tuple[int, ...]] = None
    min_p_bucket: int = 8
    max_batch: int = 8            # coalesced microbatch size cap
    max_wait_ms: float = 5.0      # coalescing window per microbatch
    max_sessions: int = 8         # warm-session LRU capacity
    solver: Any = None            # solver config shared by every session
    serving: Any = None           # ServingConfig shared by every session
    warm_cache: Any = None        # shared cross-request WarmCache
    autostart: bool = True        # start the dispatch thread at open


class ServerStats(NamedTuple):
    """Server-lifetime counters."""
    submitted: int
    served: int                  # futures resolved with a result
    failed: int                  # futures rejected with a typed error
    deadline_misses: int         # expired in the queue, never dispatched
    coalesced_batches: int       # microbatches with >= 2 riders
    coalesced_requests: int      # requests served inside those batches
    sessions_opened: int         # LRU misses (readmissions included)
    evictions: int
    bucket_fallbacks: int        # shapes beyond the configured grid
    stragglers: int              # dispatches flagged by the monitors
    pending: int                 # queued + in flight right now


# ---------------------------------------------------------------------------
# futures
# ---------------------------------------------------------------------------

class ServingFuture:
    """Resolves to the request's
    :class:`~repro_torch.core.serving.ServingResult`; a typed serving error
    propagates out of :meth:`result` as it would from the synchronous
    ``ServingSession.solve``."""

    __slots__ = ("_event", "_result", "_exc", "_callbacks", "_cb_lock")

    def __init__(self):
        self._event = threading.Event()
        self._result = None
        self._exc: Optional[BaseException] = None
        self._callbacks: List[Any] = []
        self._cb_lock = threading.Lock()

    def done(self) -> bool:
        return self._event.is_set()

    def add_done_callback(self, fn) -> None:
        """Call ``fn(self)`` when the future resolves (at once if it has
        already)."""
        with self._cb_lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            from repro_torch.core.serving import DeadlineExceeded
            raise DeadlineExceeded(
                f"future not resolved within {timeout!r}s")
        if self._exc is not None:
            raise self._exc
        return self._result

    def exception(self, timeout: Optional[float] = None
                  ) -> Optional[BaseException]:
        if not self._event.wait(timeout):
            from repro_torch.core.serving import DeadlineExceeded
            raise DeadlineExceeded(
                f"future not resolved within {timeout!r}s")
        return self._exc

    # -- producer side (the Server only) ---------------------------------
    def _resolve(self, result) -> None:
        self._result = result
        self._fire()

    def _reject(self, exc: BaseException) -> None:
        self._exc = exc
        self._fire()

    def _fire(self) -> None:
        with self._cb_lock:
            self._event.set()
            cbs, self._callbacks = self._callbacks, []
        for fn in cbs:
            fn(self)


# ---------------------------------------------------------------------------
# bucketing and identity
# ---------------------------------------------------------------------------

def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def _pick_bucket(v: int, grid: Optional[Tuple[int, ...]],
                 floor: int = 1) -> Tuple[int, bool]:
    """Smallest grid entry >= v, else the power-of-two fallback
    (flagged)."""
    if grid:
        fits = [g for g in grid if g >= v]
        if fits:
            return min(fits), False
        return max(_next_pow2(v), floor), True
    return max(_next_pow2(v), floor), False


def _shape(a) -> tuple:
    return tuple(a.shape) if hasattr(a, "shape") else np.shape(a)


def _host(a) -> np.ndarray:
    """An array's values on the host as contiguous numpy (a tensor on
    the card is copied once)."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(a))


def _hash_array(h, arr) -> None:
    if arr is None:
        h.update(b"<none>")
        return
    a = _host(arr)
    h.update(str(a.shape).encode())
    h.update(str(a.dtype).encode())
    h.update(a.tobytes())


def _problem_digest(problem, *, design_only: bool = False,
                    design_states: Optional[dict] = None) -> str:
    """Problem identity for session keying: the data bytes, the loss and
    the penalty spec (the serving checkpoints' digest). With
    ``design_only`` the response is left out, so requests of different
    users over the SAME design share one coalescing queue, while
    per-problem sessions key on the full identity. ``design_states``
    (id(X) -> (X, hash state after X)) memoizes the design's share of the
    hash by the design object's identity; the digest is the same with or
    without it."""
    X = problem.X
    hit = None if design_states is None else design_states.get(id(X))
    if hit is not None and hit[0] is X:
        h = hit[1].copy()
    else:
        h = hashlib.sha256()
        _hash_array(h, X)
        if design_states is not None:
            design_states[id(X)] = (X, h.copy())
    if not design_only:
        _hash_array(h, problem.y)
    _hash_array(h, problem.weights)
    h.update(problem.loss.encode())
    h.update(repr(problem.penalty).encode())
    return h.hexdigest()


def _is_lasso(problem) -> bool:
    pen = problem.penalty
    return pen == "lasso" or type(pen).__name__ == "LassoPenalty"


# ---------------------------------------------------------------------------
# queue entries
# ---------------------------------------------------------------------------

class _Entry:
    __slots__ = ("seq", "priority", "t_submit", "problem", "request",
                 "future", "coalesce")

    def __init__(self, seq, priority, problem, request, future, coalesce):
        self.seq = seq
        self.priority = priority
        self.t_submit = time.monotonic()
        self.problem = problem
        self.request = request
        self.future = future
        self.coalesce = coalesce


def _rank(e: _Entry):
    # higher priority first; FIFO within a priority class
    return (-e.priority, e.seq)


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------

class Server:
    """Queue -> shape bucket -> microbatch -> fleet. Construct via
    :func:`open_server`; submit with :meth:`submit`; every future resolves
    to a :class:`~repro_torch.core.serving.ServingResult`."""

    def __init__(self, config: Optional[ServerConfig] = None, *,
                 guard=None, **kwargs):
        from repro_torch.core.api import session_kwargs
        self.config = config if config is not None else ServerConfig()
        opts = session_kwargs(**kwargs)
        if opts.get("pad_to") is not None:
            raise TypeError(
                "open_server() owns bucket padding; configure "
                "ServerConfig.p_buckets/n_buckets instead of pad_to")
        opts.pop("pad_to", None)
        self._opts = opts
        self._guard = guard
        self._cond = threading.Condition()
        self._queues: Dict[tuple, List[_Entry]] = {}
        self._inflight = 0
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self._seq = itertools.count()
        # LRU of warm sessions, most recently used last
        self._lru: Dict[tuple, Any] = {}
        self._design_states: Dict[int, tuple] = {}
        self._monitors: Dict[tuple, Any] = {}
        # counters (read under _cond)
        self._submitted = 0
        self._served = 0
        self._failed = 0
        self._deadline_misses = 0
        self._coalesced_batches = 0
        self._coalesced_requests = 0
        self._sessions_opened = 0
        self._evictions = 0
        self._bucket_fallbacks = 0
        self._stragglers = 0
        if self.config.autostart:
            self._start()

    # -- lifecycle --------------------------------------------------------

    def _start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._worker_loop, name="repro-torch-server",
                daemon=True)
            self._thread.start()

    def run(self, timeout: Optional[float] = None) -> None:
        """Start the dispatcher and block the calling thread until
        :meth:`close` (from another thread) or ``timeout``."""
        self._start()
        self._thread.join(timeout)

    def drain(self, timeout: Optional[float] = None) -> None:
        """Block until every submitted request has resolved."""
        end = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._pending_locked():
                rem = None if end is None else end - time.monotonic()
                if rem is not None and rem <= 0:
                    from repro_torch.core.serving import DeadlineExceeded
                    raise DeadlineExceeded(
                        f"drain() timed out with "
                        f"{self._pending_locked()} requests pending")
                self._cond.wait(0.2 if rem is None else min(rem, 0.2))

    def close(self) -> None:
        """Stop the dispatcher; queued but unserved futures reject with a
        ``RequestError``. The warm sessions are closed."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        for sess in self._lru.values():
            sess.close()
        self._lru.clear()

    def __enter__(self) -> "Server":
        return self

    def __exit__(self, *exc_info):
        self.close()
        return False

    # -- submission -------------------------------------------------------

    def submit(self, problem, request) -> ServingFuture:
        """Validate, bucket and enqueue one request. Returns at once with
        a :class:`ServingFuture`; admission errors raise here,
        synchronously, with the typed taxonomy of the synchronous path."""
        from repro_torch.core.serving import RequestError, validate_request
        validate_request(request)
        with self._cond:
            if self._stop:
                raise RequestError("server is closed")
        key = self._bucket_key(problem, request)
        fut = ServingFuture()
        entry = _Entry(next(self._seq),
                       int(getattr(request, "priority", 0)),
                       problem, request, fut,
                       self._coalescible(problem, request))
        with self._cond:
            self._submitted += 1
            self._queues.setdefault(key, []).append(entry)
            self._cond.notify_all()
        return fut

    def stats(self) -> ServerStats:
        with self._cond:
            return ServerStats(
                submitted=self._submitted, served=self._served,
                failed=self._failed,
                deadline_misses=self._deadline_misses,
                coalesced_batches=self._coalesced_batches,
                coalesced_requests=self._coalesced_requests,
                sessions_opened=self._sessions_opened,
                evictions=self._evictions,
                bucket_fallbacks=self._bucket_fallbacks,
                stragglers=self._stragglers,
                pending=self._pending_locked())

    # -- bucketing --------------------------------------------------------

    def _digest(self, problem, *, design_only: bool = False) -> str:
        return _problem_digest(problem, design_only=design_only,
                               design_states=self._design_states)

    def _bucket_key(self, problem, request) -> tuple:
        cfg = self.config
        n, p = _shape(problem.X)
        # padding is the LASSO fleet substrate's contract; other penalties
        # and weighted problems serve at their exact shape
        pad_ok = _is_lasso(problem) and problem.weights is None
        if pad_ok:
            p_b, fb_p = _pick_bucket(p, cfg.p_buckets, cfg.min_p_bucket)
            fb_n = False
            if cfg.n_buckets and problem.loss == "least_squares":
                n_b, fb_n = _pick_bucket(n, cfg.n_buckets)
            else:
                n_b = n
            if fb_p or fb_n:
                with self._cond:
                    self._bucket_fallbacks += 1
        else:
            n_b, p_b = n, p
        # queues key on the DESIGN digest, so same-design requests of
        # different users land in one coalescing pool
        return (self._digest(problem, design_only=True), n_b, p_b)

    def _coalescible(self, problem, request) -> bool:
        """Same-design Scalars (each with its own response and lambda)
        ride one fleet solve. Warm or sharded Scalars and non-LASSO
        problems stay serial."""
        return (type(request).__name__ == "Scalar"
                and not getattr(request, "warm", False)
                and not getattr(request, "sharded", False)
                and _is_lasso(problem)
                and problem.weights is None
                and problem.y is not None)

    # -- the dispatch loop ------------------------------------------------

    def _pending_locked(self) -> int:
        return sum(len(q) for q in self._queues.values()) + self._inflight

    def _worker_loop(self) -> None:
        from repro_torch.core.serving import RequestError
        while True:
            with self._cond:
                while not self._stop and not any(self._queues.values()):
                    self._cond.wait(0.2)
                if self._stop:
                    err = RequestError(
                        "server closed before the request was served")
                    for q in self._queues.values():
                        for e in q:
                            e.future._reject(err)
                            self._failed += 1
                    self._queues.clear()
                    self._cond.notify_all()
                    return
                key, batch = self._claim_batch_locked()
                if not batch:
                    continue
                self._inflight += len(batch)
            try:
                self._dispatch(key, batch)
            finally:
                with self._cond:
                    self._inflight -= len(batch)
                    self._cond.notify_all()

    def _claim_batch_locked(self) -> Tuple[tuple, List[_Entry]]:
        """Pick the queue whose head outranks all others; a coalescible
        head holds the microbatch window open for riders."""
        best_key, best_rank = None, None
        for k, q in self._queues.items():
            if not q:
                continue
            r = min(_rank(e) for e in q)
            if best_rank is None or r < best_rank:
                best_key, best_rank = k, r
        if best_key is None:
            return (), []
        q = self._queues[best_key]
        head = min(q, key=_rank)
        if head.coalesce:
            window = self.config.max_wait_ms / 1e3
            deadline = head.t_submit + window
            while (not self._stop
                   and len([e for e in q if e.coalesce])
                   < self.config.max_batch
                   and time.monotonic() < deadline):
                self._cond.wait(max(deadline - time.monotonic(), 1e-4))
            q = self._queues.get(best_key, [])
            batch = sorted((e for e in q if e.coalesce),
                           key=_rank)[: self.config.max_batch]
        else:
            batch = [head]
        for e in batch:
            q.remove(e)
        if not q:
            self._queues.pop(best_key, None)
        return best_key, batch

    # -- sessions ---------------------------------------------------------

    def _session(self, problem, key: tuple):
        from repro_torch.core.serving import open_serving
        sess = self._lru.get(key)
        if sess is not None:
            # refresh recency (a session whose breaker refuses stays: its
            # riders get its BackendFault, it is never re-opened)
            self._lru.pop(key)
            self._lru[key] = sess
            return sess
        n_b, p_b = key[-2], key[-1]
        n, p = _shape(problem.X)
        pad_to = (n_b, p_b) if (n_b, p_b) != (n, p) else None
        opts = self._opts
        if self.config.warm_cache is not None \
                and opts.get("warm_cache") is None:
            # every session the server opens shares the configured
            # cross-request cache, so a readmission re-enters warm
            opts = dict(opts, warm_cache=self.config.warm_cache)
        sess = open_serving(problem, self.config.solver,
                            serving=self.config.serving,
                            guard=self._guard, pad_to=pad_to, **opts)
        with self._cond:
            self._sessions_opened += 1
        self._lru[key] = sess
        while len(self._lru) > max(self.config.max_sessions, 1):
            old_key = next(iter(self._lru))
            self._lru.pop(old_key).close()
            with self._cond:
                self._evictions += 1
        return sess

    def _monitor(self, key: tuple):
        mon = self._monitors.get(key)
        if mon is None:
            from repro_torch.runtime.fault import StragglerMonitor
            factor = getattr(self.config.serving, "straggler_factor", 3.0)
            mon = self._monitors[key] = StragglerMonitor(factor=factor)
        return mon

    # -- dispatch ---------------------------------------------------------

    def _expire_locked(self, batch: List[_Entry]) -> List[_Entry]:
        from repro_torch.core.serving import DeadlineExceeded
        now = time.monotonic()
        live = []
        for e in batch:
            dl = getattr(e.request, "deadline_s", None)
            if dl is not None and now - e.t_submit >= dl:
                e.future._reject(DeadlineExceeded(
                    f"request deadline ({dl:g}s) expired in the queue "
                    f"after {now - e.t_submit:.3g}s"))
                with self._cond:
                    self._deadline_misses += 1
                    self._failed += 1
            else:
                live.append(e)
        return live

    def _dispatch(self, key: tuple, batch: List[_Entry]) -> None:
        batch = self._expire_locked(batch)
        if not batch:
            return
        _, n_b, p_b = key
        # fleet sessions serve every same-design user (the requests carry
        # their own Y), so they key on the design digest; single-request
        # sessions are bound to the problem's y and key on the full one
        if batch[0].coalesce:
            skey = ("fleet",) + key
        else:
            skey = ("single", self._digest(batch[0].problem), n_b, p_b)
        try:
            sess = self._session(batch[0].problem, skey)
        except BaseException as exc:  # noqa: BLE001 - a session that
            # fails to open must reach every rider, not kill the loop
            self._reject_batch(batch, exc)
            return
        mon = self._monitor(key)
        t0 = time.monotonic()
        try:
            if len(batch) == 1 and not batch[0].coalesce:
                res = sess.solve(batch[0].request)
                batch[0].future._resolve(res)
                with self._cond:
                    self._served += 1
            else:
                self._dispatch_coalesced(sess, batch)
        except BaseException as exc:  # noqa: BLE001 - typed serving
            # errors (and anything else) resolve the futures
            self._reject_batch(batch, exc)
        if mon.record(time.monotonic() - t0):
            with self._cond:
                self._stragglers += 1

    def _reject_batch(self, batch: List[_Entry], exc: BaseException):
        for e in batch:
            if not e.future.done():
                e.future._reject(exc)
        with self._cond:
            self._failed += len(batch)

    def _dispatch_coalesced(self, sess, batch: List[_Entry]) -> None:
        """B same-design Scalars (their own y and lambda) -> one fleet
        microbatch. The batch axis is padded to a power of two with copies
        of rider 0; the fleet engine solves each member on its own, bit
        for bit its serial solve, so riders cannot perturb each other and
        the per-unit verdicts attribute any failure to its member."""
        import torch

        from repro_torch.core.api import Fleet
        from repro_torch.core.saif import as_tensor
        from repro_torch.core.serving import ServingResult
        b_real = len(batch)
        b_pad = _next_pow2(b_real)
        X = sess.session._X
        # every rider brings its OWN response row; the bucket key
        # guarantees the shared design
        Y = torch.stack([as_tensor(e.problem.y, X.device, X.dtype)
                         for e in batch])
        lams = [float(e.request.lam) for e in batch]
        lams += [lams[0]] * (b_pad - b_real)
        if b_pad > b_real:
            Y = torch.cat([Y, Y[:1].expand(b_pad - b_real, -1)])
        deadlines = [e.request.deadline_s for e in batch
                     if e.request.deadline_s is not None]
        fleet = Fleet(Y=Y, lams=np.asarray(lams),
                      deadline_s=min(deadlines) if deadlines else None,
                      priority=max(e.priority for e in batch))
        res = sess.solve(fleet)
        verdict = res.verdict
        unit_ok = verdict.unit_ok or (verdict.ok,) * b_pad
        unit_deg = verdict.unit_degraded or (False,) * b_pad
        value = _to_host(res.value)     # one copy per field, then
        for i, e in enumerate(batch):   # per-rider views
            v_i = verdict._replace(
                ok=bool(unit_ok[i]), degraded=bool(unit_deg[i]),
                unit_ok=(bool(unit_ok[i]),),
                unit_degraded=(bool(unit_deg[i]),))
            e.future._resolve(
                ServingResult(value=_unit_view(value, i), verdict=v_i))
        with self._cond:
            self._served += b_real
            if b_real > 1:
                self._coalesced_batches += 1
                self._coalesced_requests += b_real


def _tree_map(fn, value):
    """``fn`` over the leaves of NamedTuples and tuples of tensors (the
    port's results); other leaves pass through ``fn`` too."""
    if isinstance(value, tuple):
        items = [_tree_map(fn, v) for v in value]
        return type(value)(*items) if hasattr(value, "_fields") \
            else type(value)(items)
    return fn(value)


def _to_host(value):
    """Every tensor of a batched result on the host: one copy per field
    per microbatch, so the per-rider slices below are views."""
    return _tree_map(lambda a: a.cpu() if hasattr(a, "cpu") else a, value)


def _unit_view(value, i: int):
    """Fleet member ``i`` of a batched result: every array field carries
    a leading problem axis."""
    return _tree_map(lambda a: a[i] if getattr(a, "ndim", 0) else a, value)


def open_server(config: Optional[ServerConfig] = None, *, guard=None,
                **kwargs) -> Server:
    """Open the async serving front end.

    ``config`` is a :class:`ServerConfig` (None for the defaults); its
    fields may also be passed as keyword overrides (``open_server(
    max_batch=16)``). The remaining keywords are the shared session spec
    ``repro_torch.core.api.SESSION_KWARG_DEFAULTS`` (``device``, ``mesh``,
    ``segment_len``, ``make_screen``) handed to every warm
    :class:`~repro_torch.core.serving.ServingSession` the server opens;
    ``pad_to`` is the bucket grid's.

    ::

        server = open_server(max_batch=8, max_wait_ms=5.0)
        fut = server.submit(Problem(X=X, y=y), Scalar(lam, priority=1))
        value, verdict = fut.result(timeout=30)
    """
    field_names = {f.name for f in dataclasses.fields(ServerConfig)}
    overrides = {k: kwargs.pop(k) for k in list(kwargs)
                 if k in field_names}
    if config is None:
        config = ServerConfig(**overrides)
    elif overrides:
        config = dataclasses.replace(config, **overrides)
    return Server(config, guard=guard, **kwargs)
