"""Pluggable screening backends for the SAIF ADD phase (port of the serial
parts of ``repro.core.screen_backend``).

Per outer iteration the ADD decision needs, from the full feature set R_t:
the ADD-stop reduction max ub, the top-h candidates (score, feature id),
their lower bounds lb_l = |score_l - ||x_l|| r| and their violation counts
|V_l| = #{i in R_t : ub_i >= lb_l}. A :data:`ScreenFn` returns all of them
as one :class:`ScreenOut`. Two backends:

  * ``torch`` — one matvec, a stable descending sort for the top-h, and
                searchsorted/bincount counts (the reference's ``jnp``);
  * ``cuda``  — kernels K1 (masked scan + tile top-h + tile max-ub) and K2
                (ub histogram against the sorted candidate bounds), the
                reference's ``pallas``.

Both give the same candidates and the same integer counts: top-h ties go
to the lowest feature id (``jax.lax.top_k``'s order), which ``torch.topk``
does not promise, so every top-h here is a stable sort.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

# the rule/backend seam: re-exported so rule consumers import one module
from repro_torch.core.screen_rule import (SCREEN_RULES,  # noqa: F401
                                          ScreenRule, resolve_screen_rule)

Tensor = torch.Tensor


class ScreenOut(NamedTuple):
    max_ub: Tensor      # scalar: max over R_t of ub (−inf if R_t empty)
    cand_score: Tensor  # (h,) top-h scores over R_t (−inf padded)
    cand_idx: Tensor    # (h,) int64 global feature ids
    cand_lb: Tensor     # (h,) |score − ||x|| r| per candidate
    cand_ge: Tensor     # (h,) int32 #{i in R_t : ub_i >= cand_lb}
    n_surv: Tensor      # int32 #{i in R_t : ub_i >= 1}


# signature: (theta (n,), r scalar, in_active (p,) bool) -> ScreenOut
ScreenFn = Callable[[Tensor, Tensor, Tensor], ScreenOut]


def _top(x: Tensor, h: int):
    """Top-h of a 1-D tensor, ties to the lowest index (lax.top_k order)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:h], idx[:h]


def ge_counts_from_hist(hist: Tensor, lb_sorted: Tensor,
                        lb_cand: Tensor) -> Tensor:
    """Per-candidate #{i : ub_i >= lb} from the c-histogram (exact)."""
    suffix = torch.cumsum(hist.flip(0), 0).flip(0)     # suffix[m] = Σ_{t>=m}
    pos = torch.searchsorted(lb_sorted, lb_cand, right=False)
    return suffix[torch.clamp(pos + 1, max=hist.shape[0] - 1)].to(torch.int32)


def violation_ge_counts(ub: Tensor, lb_cand: Tensor) -> Tensor:
    """Plain counts #{i : ub_i >= lb_l} per candidate, sort-free in p."""
    h = lb_cand.shape[0]
    lb_sorted = torch.sort(lb_cand).values
    c = torch.searchsorted(lb_sorted, ub, right=True)
    hist = torch.bincount(c, minlength=h + 1)
    return ge_counts_from_hist(hist, lb_sorted, lb_cand)


def survivor_count(ub: Tensor) -> Tensor:
    """#{i : ub_i >= 1}; -inf entries (active/skipped) never count."""
    return torch.sum(ub >= 1.0, dtype=torch.int32)


def _candidate_out(scores_masked, ub, col_norm, r, h) -> ScreenOut:
    """Shared tail: top-h + bounds + counts from masked scores and ub."""
    cand_score, cand_idx = _top(scores_masked, h)
    cand_lb = torch.abs(cand_score - col_norm[cand_idx] * r)
    cand_ge = violation_ge_counts(ub, cand_lb)
    return ScreenOut(max_ub=torch.max(ub), cand_score=cand_score,
                     cand_idx=cand_idx, cand_lb=cand_lb, cand_ge=cand_ge,
                     n_surv=survivor_count(ub))


def make_screen_torch(X: Tensor, col_norm: Tensor, h: int) -> ScreenFn:
    """Plain backend: one matvec (``theta @ X``) + cheap reductions."""
    def screen(theta, r, in_active):
        score = torch.abs(theta @ X)
        masked = torch.where(in_active, -torch.inf, score)
        ub = masked + col_norm * r
        return _candidate_out(masked, ub, col_norm, r, h)
    return screen


def make_screen_cuda(X: Tensor, col_norm: Tensor, h: int) -> ScreenFn:
    """Kernel backend: K1 scans, the (p/BP) h tile winners merge into the
    global top-h, K2 histograms ub against the candidates' bounds."""
    from repro_torch.kernels.screen.screen import screen_fused, ub_histogram

    p = X.shape[1]

    def screen(theta, r, in_active):
        _, ub, _, tops, topi, tmax = screen_fused(X, theta, col_norm,
                                                  in_active, r, h=h)
        # merge tile winners: O((p/BP) h) candidates, not O(p)
        cand_score, pos = _top(tops.reshape(-1), h)
        cand_idx = topi.reshape(-1)[pos].long()
        # a saturated tile can name a padding lane (id >= p) with score
        # -inf; such a candidate is never kept, its gathers are clamped
        cand_lb = torch.abs(cand_score -
                            col_norm[torch.clamp(cand_idx, max=p - 1)] * r)
        lb_sorted = torch.sort(cand_lb).values
        hist = ub_histogram(ub, lb_sorted)
        cand_ge = ge_counts_from_hist(hist, lb_sorted, cand_lb)
        return ScreenOut(max_ub=torch.max(tmax), cand_score=cand_score,
                         cand_idx=cand_idx, cand_lb=cand_lb, cand_ge=cand_ge,
                         n_surv=survivor_count(ub))
    return screen


def resolve_backend(name: str, device: torch.device) -> str:
    """Backend policy: an explicit name wins; ``auto`` takes the kernels
    when the data lies on a CUDA device and the plain path elsewhere."""
    if name == "auto":
        return "cuda" if torch.device(device).type == "cuda" else "torch"
    if name not in ("torch", "cuda"):
        raise ValueError(f"unknown screen backend {name!r}")
    return name
