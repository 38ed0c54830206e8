"""Fault-tolerance runtime: step retries, straggler detection, preemption
(port of ``repro.runtime.fault``; the port keeps its own copy).

The policies are host-side and hardware-agnostic, so they are unit-testable
on the CPU with injected fakes:

* ``retry_step`` re-executes a step closure on a transient failure (a
  ``RuntimeError`` from a kernel launch, a timeout) with jittered
  exponential backoff, up to ``max_retries`` and an optional wall-clock
  ``deadline_s`` cap; on persistent failure it raises ``StepFailed``
  (``RetryDeadlineExceeded`` when the deadline, not the retry budget, ran
  out), so the caller restores a checkpoint or walks its degradation
  ladder.
* ``StragglerMonitor`` tracks per-step wall times and flags a step that
  exceeds ``factor`` x the trailing median of the *non-straggling* recent
  steps (a flagged outlier leaves the median, so one straggler cannot
  inflate the threshold its successors are judged against).
* ``PreemptionGuard``: cooperative SIGTERM handling, a flag the serving
  loop polls to checkpoint and exit cleanly.

For the same seeded ``random.Random`` and the same sequences, the delays
and flags are the reference's.
"""
from __future__ import annotations

import random
import signal
import statistics
import time
from typing import Callable, List, Optional, Tuple

__all__ = ["StepFailed", "RetryDeadlineExceeded", "backoff_delay",
           "retry_step", "StragglerMonitor", "PreemptionGuard"]


class StepFailed(RuntimeError):
    pass


class RetryDeadlineExceeded(StepFailed):
    """The retry loop's wall-clock budget ran out before the step
    succeeded (distinct from exhausting ``max_retries``, so callers can
    map it onto a deadline-typed serving error)."""


def backoff_delay(attempt: int, base_s: float, mult: float, jitter: float,
                  rng: Optional[random.Random] = None) -> float:
    """Jittered exponential backoff: ``base * mult**(attempt-1)`` scaled
    by a uniform factor in ``[1-jitter, 1+jitter]`` (attempt counts from
    1). Deterministic under a seeded ``rng``."""
    if base_s <= 0.0:
        return 0.0
    delay = base_s * mult ** max(attempt - 1, 0)
    if jitter > 0.0:
        u = (rng.random() if rng is not None else random.random())
        delay *= 1.0 + jitter * (2.0 * u - 1.0)
    return max(delay, 0.0)


def retry_step(fn: Callable[[], object], *, max_retries: int = 2,
               retriable: tuple = (RuntimeError,),
               on_retry: Optional[Callable[[int, Exception], None]] = None,
               backoff_base_s: float = 0.0, backoff_mult: float = 2.0,
               jitter: float = 0.5, deadline_s: Optional[float] = None,
               rng: Optional[random.Random] = None,
               sleep: Callable[[float], None] = time.sleep,
               clock: Callable[[], float] = time.monotonic):
    """Run ``fn``; retry on transient device errors with jittered
    exponential backoff and a wall-clock deadline cap.

    ``backoff_base_s`` is the first retry's nominal delay (0.0 = retry at
    once); each further retry multiplies it by ``backoff_mult`` and
    jitters it by ±``jitter`` (fraction). A seeded ``rng``
    (``random.Random``) makes the schedule deterministic. ``deadline_s``
    caps the whole attempt loop: a retry is only issued if wall time
    remains, and the pre-retry sleep never overshoots the budget;
    exhaustion raises :class:`RetryDeadlineExceeded`. ``sleep``/``clock``
    are injectable for tests.
    """
    t0 = clock()
    attempt = 0
    while True:
        try:
            return fn()
        except retriable as e:  # noqa: PERF203
            attempt += 1
            if attempt > max_retries:
                raise StepFailed(
                    f"step failed after {max_retries} retries: {e}") from e
            delay = backoff_delay(attempt, backoff_base_s, backoff_mult,
                                  jitter, rng)
            if deadline_s is not None:
                remaining = deadline_s - (clock() - t0)
                if remaining <= 0.0:
                    raise RetryDeadlineExceeded(
                        f"retry deadline ({deadline_s:g}s) exhausted "
                        f"after {attempt - 1} retries: {e}") from e
                delay = min(delay, remaining)
            if on_retry:
                on_retry(attempt, e)
            if delay > 0.0:
                sleep(delay)


class StragglerMonitor:
    def __init__(self, factor: float = 3.0, window: int = 20,
                 min_samples: int = 5,
                 on_straggler: Optional[Callable[[int, float, float], None]]
                 = None):
        self.factor = factor
        self.window = window
        self.min_samples = min_samples
        self.on_straggler = on_straggler
        self.times: List[float] = []            # every recorded duration
        self.flagged: List[int] = []            # 1-based straggling steps
        self._samples: List[Tuple[float, bool]] = []  # (seconds, flagged)
        self._step = 0

    def record(self, seconds: float) -> bool:
        """Record a step duration; returns True if it straggled.

        The threshold is ``factor`` x the median of the trailing
        ``window`` *non-flagged* samples: an already-flagged straggler is
        excluded, so a single slow step cannot inflate the baseline its
        successors are compared against.
        """
        self._step += 1
        hist = [t for t, fl in self._samples[-self.window:] if not fl]
        is_straggler = False
        if len(hist) >= self.min_samples:
            med = statistics.median(hist)
            if seconds > self.factor * med:
                is_straggler = True
                self.flagged.append(self._step)
                if self.on_straggler:
                    self.on_straggler(self._step, seconds, med)
        self.times.append(seconds)
        self._samples.append((seconds, is_straggler))
        return is_straggler

    def timed(self, fn: Callable[[], object]):
        t0 = time.monotonic()
        out = fn()
        self.record(time.monotonic() - t0)
        return out


class PreemptionGuard:
    """Cooperative SIGTERM -> checkpoint-and-exit flag."""

    def __init__(self, install: bool = True):
        self.preempted = False
        self._prev = None
        if install:
            self._prev = signal.signal(signal.SIGTERM, self._handler)

    def _handler(self, signum, frame):
        self.preempted = True

    def trigger(self):          # for tests / manual drills
        self.preempted = True

    def uninstall(self):
        if self._prev is not None:
            signal.signal(signal.SIGTERM, self._prev)
