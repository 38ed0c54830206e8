"""Property-testing compatibility layer (port of ``repro.testing``; the port
keeps its own copy).

Re-exports ``hypothesis`` (``given``/``settings``/``st``) when the package is
installed. When it is not (minimal CI images, hermetic containers), a small
deterministic fallback implements the subset of the strategy API this repo's
tests use — ``st.integers``, ``st.floats``, ``st.sampled_from``,
``st.booleans`` — by drawing a fixed number of seeded examples per test.

This keeps the tier-1 suite runnable everywhere: with hypothesis the tests
get real shrinking/coverage, without it they degrade to a deterministic
multi-example sweep instead of aborting collection with ImportError.
"""
from __future__ import annotations

try:  # pragma: no cover - exercised implicitly when hypothesis is present
    from hypothesis import given, settings
    from hypothesis import strategies as st

    HAVE_HYPOTHESIS = True
except ModuleNotFoundError:
    HAVE_HYPOTHESIS = False

    import functools
    import zlib

    import numpy as _np

    # Cap fallback examples: without shrinking, very large sweeps only cost
    # time; a dozen seeded draws keeps the property signal at CI speed.
    _FALLBACK_MAX_EXAMPLES = 12

    class _Strategy:
        def __init__(self, draw):
            self._draw = draw

        def example(self, rng):
            return self._draw(rng)

    class _StrategiesModule:
        @staticmethod
        def integers(min_value, max_value):
            return _Strategy(
                lambda rng: int(rng.integers(min_value, max_value + 1)))

        @staticmethod
        def floats(min_value=-1e6, max_value=1e6, allow_nan=False,
                   allow_infinity=False, **_ignored):
            return _Strategy(
                lambda rng: float(rng.uniform(min_value, max_value)))

        @staticmethod
        def sampled_from(elements):
            seq = list(elements)
            return _Strategy(lambda rng: seq[int(rng.integers(len(seq)))])

        @staticmethod
        def booleans():
            return _Strategy(lambda rng: bool(rng.integers(2)))

    st = _StrategiesModule()

    def settings(max_examples=10, deadline=None, **_ignored):
        def deco(fn):
            fn._compat_max_examples = max_examples
            return fn
        return deco

    def given(**strategies):
        def deco(fn):
            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                n = min(getattr(fn, "_compat_max_examples", 10),
                        _FALLBACK_MAX_EXAMPLES)
                seed = zlib.crc32(fn.__qualname__.encode("utf-8"))
                rng = _np.random.default_rng(seed)
                for _ in range(n):
                    draw = {k: s.example(rng) for k, s in strategies.items()}
                    fn(*args, **draw, **kwargs)
            # pytest must not unwrap to fn and see the strategy params as
            # missing fixtures
            del wrapper.__wrapped__
            return wrapper
        return deco


__all__ = ["given", "settings", "st", "HAVE_HYPOTHESIS"]
