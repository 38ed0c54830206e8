"""Cross-request homotopy cache (port of ``repro.core.warm_cache``).

Repeat traffic to a feature-selection service clusters: the same design
is queried at nearby lambdas (a user sweeping regularization, a client
retrying, CV followed by a refit). A :class:`WarmCache` is a host-side
LRU of device-resident exit warm states — ``(problem digest, lambda) ->
(WarmState, k_max)`` — that Sessions may share. On a hit, the session
enters the solve through :func:`repro_torch.core.path.seq_warm_entry`:
the paper's Theorem-2 sequential ball, seeded from the cached dual and
widened by the propagated gap radius, certifies which features can be
active at the requested lambda and pre-recruits them, skipping the cold
active-set growth that dominates cold-entry latency.

Hit/miss semantics: a cached entry at ``lam0`` serves a request at
``lam`` when ``lam <= lam0 <= band * lam``, entering *downward* along
the regularization path, the direction Theorem 2 certifies; among
eligible entries the closest (smallest ``lam0/lam``) wins. Safety does
NOT rest on the band: the entry only *seeds* the active set, SAIF's own
ADD loop and stop test still run (under every screen rule the final
stop is gated by a full-safe-radius screen: the delta-ramped ADD stop
of the ``saif`` rule, the explicit safe post-check of ``hybrid``). A
result that fails a later certification invalidates its entry
(:meth:`WarmCache.invalidate`, through ``Session.drop_cache_entry``).

Module scope stays numpy and stdlib only (the lazy public surface); the
device work happens in ``path.seq_warm_entry`` at solve time.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
from collections import OrderedDict
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np

__all__ = ["WarmCacheConfig", "WarmCache", "WarmCacheStats",
           "problem_digest"]


@dataclasses.dataclass(frozen=True)
class WarmCacheConfig:
    """Policy knobs for a :class:`WarmCache`.

    ``capacity`` — max resident entries (device memory per entry is a
    few (k_max,) buffers plus the (k_max, k_max) gram block).
    ``band`` — continuation band: an entry at lam0 serves lam when
    ``lam <= lam0 <= band * lam``. Wider bands trade entry-ball
    tightness for hit rate; safety is independent of the band (see the
    module docstring).
    """
    capacity: int = 32
    band: float = 4.0

    def __post_init__(self):
        if int(self.capacity) < 1:
            raise ValueError(
                f"WarmCacheConfig.capacity must be >= 1, got "
                f"{self.capacity!r}")
        if not float(self.band) >= 1.0:
            raise ValueError(
                f"WarmCacheConfig.band must be >= 1, got {self.band!r}")


class WarmCacheStats(NamedTuple):
    hits: int = 0
    misses: int = 0
    puts: int = 0
    evictions: int = 0
    invalidations: int = 0


class _Entry(NamedTuple):
    lam0: float
    warm: Any          # path.WarmState (device tensors)
    k_max: int


def problem_digest(X, y) -> str:
    """Content digest of a (design, response) pair, the cache key's
    problem half. Hashes the exact bytes the session solves (for a
    bucket-padded session, the padded arrays): dtype, shape and contents,
    so hits can only occur between sessions whose problems are identical.
    A tensor hashes as its numpy copy (one device-to-host copy of a design
    on the card), so a CPU tensor and its numpy array share a digest."""
    h = hashlib.sha256()
    for arr in (X, y):
        if arr is None:                     # a fleet-only session's y
            h.update(b"<none>")
            continue
        if hasattr(arr, "detach"):          # a torch tensor
            arr = arr.detach().cpu().numpy()
        a = np.asarray(arr)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


class WarmCache:
    """Thread-safe LRU of exit warm states keyed by (digest, lambda).

    One instance may be shared across Sessions and threads; every state
    transition holds an internal lock. The stored values are tuples of
    device tensors that no solve writes to, so readers never observe a
    torn entry.
    """

    def __init__(self, config: Optional[WarmCacheConfig] = None):
        self.config = config or WarmCacheConfig()
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Tuple[str, str], _Entry]" = \
            OrderedDict()
        self._hits = self._misses = self._puts = 0
        self._evictions = self._invalidations = 0

    @staticmethod
    def _key(digest: str, lam: float) -> Tuple[str, str]:
        return (digest, f"{float(lam):.12g}")

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> WarmCacheStats:
        with self._lock:
            return WarmCacheStats(self._hits, self._misses, self._puts,
                                  self._evictions, self._invalidations)

    def lookup(self, digest: str, lam: float) -> Optional[_Entry]:
        """Closest cached entry whose continuation band covers ``lam``
        (None on miss). Counts a hit/miss and refreshes LRU order."""
        lam = float(lam)
        band = float(self.config.band)
        best_key = None
        best = None
        with self._lock:
            for key, entry in self._entries.items():
                if key[0] != digest:
                    continue
                # downward continuation only: lam <= lam0 <= band * lam
                # (1e-12 slack keeps exact repeats on the hit path)
                if not (entry.lam0 >= lam * (1.0 - 1e-12)
                        and entry.lam0 <= band * lam):
                    continue
                if best is None or entry.lam0 < best.lam0:
                    best_key, best = key, entry
            if best is None:
                self._misses += 1
                return None
            self._hits += 1
            self._entries.move_to_end(best_key)
            return best

    def store(self, digest: str, lam: float, warm: Any,
              k_max: int) -> None:
        """Insert/refresh the exit warm state of a solve at ``lam``."""
        key = self._key(digest, lam)
        with self._lock:
            self._entries[key] = _Entry(float(lam), warm, int(k_max))
            self._entries.move_to_end(key)
            self._puts += 1
            while len(self._entries) > int(self.config.capacity):
                self._entries.popitem(last=False)
                self._evictions += 1

    def invalidate(self, digest: str,
                   lam: Optional[float] = None) -> int:
        """Drop one entry (``lam`` given) or every entry of a problem,
        for a result that failed certification. Returns the number of
        entries removed."""
        with self._lock:
            if lam is not None:
                removed = self._entries.pop(self._key(digest, lam),
                                            None)
                n = 0 if removed is None else 1
            else:
                keys = [k for k in self._entries if k[0] == digest]
                for k in keys:
                    del self._entries[k]
                n = len(keys)
            self._invalidations += n
            return n

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
