"""Deterministic fault injection for the serving runtime (port of
``repro.runtime.inject``).

Chaos testing a solver needs a seam the injector can reach without
perturbing the engine: the host-side boundary where one engine call is
dispatched. The engine call sites (``core/saif.py::solve_scalar``'s
capacity loop, ``core/path.py::run_path``'s per-lambda solve,
``core/batch.py::fleet_solve``'s fleet dispatch) route through
:func:`seam`, which is a single module-global ``is None`` check when
disarmed: no extra launch, no synchronization, the same results bit for
bit. They are the reference's engine boundaries, so one schedule hits the
same calls in both packages.

Armed (``with FaultInjector(...):``), the injector keys on a global call
counter and deterministically

  * raises a transient ``RuntimeError`` *before* dispatch on chosen call
    indices, as a failed kernel launch surfaces on the host
    (``fail_at``);
  * sleeps an artificial per-call delay, a straggling step
    (``delay_at`` / ``delay_s``);
  * pokes NaN into the returned result's ``beta``/``gap``, as a NaN born
    inside a faulty kernel surfaces at the host boundary (``nan_at``).
    The poke works on copies, outside the engine.

Schedules are explicit index sets or derived from a seed with
:meth:`FaultInjector.from_seed` (the reference's draws for the same
seed). No torch at module scope: the NaN poke imports it.
"""
from __future__ import annotations

import time
from typing import Iterable, List, Optional, Tuple

import numpy as np

__all__ = ["armed", "seam", "FaultInjector"]

_ACTIVE: Optional["FaultInjector"] = None


def armed() -> Optional["FaultInjector"]:
    """The currently armed injector, or None (the steady state)."""
    return _ACTIVE


def seam(tag: str, fn):
    """Run one engine dispatch through the active injector.

    ``tag`` names the engine boundary (``"serial"`` / ``"path"`` /
    ``"fleet"``). Identity (one global None-check) when disarmed.
    """
    inj = _ACTIVE
    if inj is None:
        return fn()
    return inj.run(tag, fn)


def _poke_nan(out, unit: Optional[int] = None):
    """Corrupt a solver result the way an in-kernel NaN surfaces: NaN in
    the coefficients and the gap, on copies on their device. Works on any
    result NamedTuple with tensor ``beta``/``gap`` fields (the serial
    SaifResult and a fleet's stacked one); anything else is returned
    untouched. With ``unit`` set and a stacked result (leading problem
    axis), only that one fleet member is poisoned."""
    if not (hasattr(out, "_replace") and hasattr(out, "beta")
            and hasattr(out, "gap")):
        return out
    import torch
    beta = torch.as_tensor(out.beta).clone()
    gap = torch.as_tensor(out.gap).clone()
    if unit is not None and beta.ndim >= 2 and gap.ndim >= 1:
        beta[unit, ..., 0] = float("nan")
        gap[unit] = float("nan")
    else:
        beta[..., 0] = float("nan")
        gap.fill_(float("nan"))
    return out._replace(beta=beta, gap=gap)


class FaultInjector:
    """Seeded, deterministic fault schedule over the engine-call counter.

    ``fail_at`` / ``nan_at`` / ``delay_at`` are 1-based engine-call
    indices (the counter spans every seam, in dispatch order). ``tags``
    optionally restricts injection to specific seams (calls at other
    seams still advance the counter, keeping schedules stable when a
    request mixes engines). Use as a context manager::

        with FaultInjector(fail_at={1}):
            serving.solve(Scalar(lam))   # first engine call faults,
                                         # the retry path recovers
    """

    def __init__(self, *, fail_at: Iterable[int] = (),
                 nan_at: Iterable[int] = (),
                 delay_at: Iterable[int] = (), delay_s: float = 0.0,
                 nan_unit: Optional[int] = None,
                 tags: Optional[Iterable[str]] = None,
                 exc: type = RuntimeError,
                 message: str = "injected transient backend fault"):
        self.fail_at = {int(i) for i in fail_at}
        self.nan_at = {int(i) for i in nan_at}
        self.delay_at = {int(i) for i in delay_at}
        self.delay_s = float(delay_s)
        self.nan_unit = None if nan_unit is None else int(nan_unit)
        self.tags = None if tags is None else set(tags)
        self.exc = exc
        self.message = message
        self.calls = 0
        self.log: List[Tuple[int, str, str]] = []   # (call#, tag, action)

    @classmethod
    def from_seed(cls, seed: int, n_calls: int, *, p_fail: float = 0.0,
                  p_nan: float = 0.0, p_delay: float = 0.0,
                  delay_s: float = 0.0, **kw) -> "FaultInjector":
        """Derive a schedule over ``n_calls`` engine calls from a seed:
        the chaos suite's reproducible random sweep."""
        rng = np.random.default_rng(seed)
        draws = rng.random((3, n_calls))
        idx = np.arange(1, n_calls + 1)
        return cls(fail_at=idx[draws[0] < p_fail],
                   nan_at=idx[draws[1] < p_nan],
                   delay_at=idx[draws[2] < p_delay], delay_s=delay_s, **kw)

    def run(self, tag: str, fn):
        if self.tags is not None and tag not in self.tags:
            self.calls += 1
            return fn()
        self.calls += 1
        k = self.calls
        if k in self.delay_at and self.delay_s > 0.0:
            self.log.append((k, tag, "delay"))
            time.sleep(self.delay_s)
        if k in self.fail_at:
            self.log.append((k, tag, "fail"))
            raise self.exc(f"{self.message} (engine call {k}, {tag})")
        out = fn()
        if k in self.nan_at:
            self.log.append((k, tag, "nan"))
            out = _poke_nan(out, unit=self.nan_unit)
        return out

    # -- arming ---------------------------------------------------------
    def __enter__(self) -> "FaultInjector":
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError("a FaultInjector is already armed")
        _ACTIVE = self
        return self

    def __exit__(self, *exc_info):
        global _ACTIVE
        _ACTIVE = None
        return False
