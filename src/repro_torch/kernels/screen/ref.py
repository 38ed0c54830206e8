"""Plain PyTorch versions of the screening kernels.

They compute what the CUDA kernels in ``screen.py`` compute, output for
output: the CPU path runs them, the tests hold them against the reference
package, and ``chip_smoke.py`` holds the kernels against them on the card.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor

# columns per CTA of the fused scan kernel = lanes of one top-h tile
BP = 256


def screen_scores_ref(X: Tensor, theta: Tensor, col_norm: Tensor, r):
    """score = |X^T theta|, ub = score + ||x||r, lb = |score - ||x||r|."""
    score = torch.abs(theta @ X)
    nr = col_norm * r
    return score, score + nr, torch.abs(score - nr)


def screen_fused_ref(X: Tensor, theta: Tensor, col_norm: Tensor,
                     active: Tensor, r, *, h: int, guard: float = 1.0):
    """The fused ADD-phase scan, tile for tile as the kernel lays it out.

    Returns (score, ub, lb) (p,) with active features masked to
    score = ub = -inf and lb = +inf; per BP-column tile its top
    ``min(h, BP)`` (score, global id) with ties to the lowest lane, padding
    lanes counting as active; and per tile the max ub. ``guard``
    multiplies ub (and so the tile maxima). The mixed mode reaches it with
    X and theta already rounded to the input type and held in the sums'
    type.
    """
    p = X.shape[1]
    score = torch.abs(theta @ X)
    nr = col_norm * r
    masked = torch.where(active, -torch.inf, score)
    ub = masked + nr
    if guard != 1.0:
        ub = ub * guard
    lb = torch.abs(masked - nr)
    p_blocks = -(-p // BP)
    pad = p_blocks * BP - p
    h_tile = max(1, min(h, BP))
    ms_t = torch.nn.functional.pad(masked, (0, pad), value=-torch.inf)
    ub_t = torch.nn.functional.pad(ub, (0, pad), value=-torch.inf)
    ms_t = ms_t.reshape(p_blocks, BP)
    tops, lane = torch.sort(ms_t, dim=1, descending=True, stable=True)
    base = torch.arange(p_blocks, device=X.device)[:, None] * BP
    topi = (lane[:, :h_tile] + base).to(torch.int32)
    tmax = ub_t.reshape(p_blocks, BP).amax(dim=1)
    return masked, ub, lb, tops[:, :h_tile].contiguous(), topi, tmax


def screen_fused_batch_ref(X: Tensor, Theta: Tensor, col_norm: Tensor,
                           active: Tensor, r, *, h: int, guard: float = 1.0):
    """:func:`screen_fused_ref` per row of Theta (m, n), stacked; col_norm
    (p,) shared or (m, p), active (m, p), r (m,). Each row works on its own
    copy of its theta, as a serial scan would."""
    outs = [screen_fused_ref(
        X, Theta[b].clone(), col_norm if col_norm.ndim == 1 else col_norm[b],
        active[b], r[b], h=h, guard=guard) for b in range(Theta.shape[0])]
    return tuple(torch.stack(t) for t in zip(*outs))


def ub_histogram_ref(ub: Tensor, lb_sorted: Tensor) -> Tensor:
    """hist[m] = #{i : #{l : lb_sorted[l] <= ub_i} = m}, m = 0..h, int32.

    The count is the kernel's: a sum of ``<=`` comparisons (-inf counts 0,
    NaN compares false), which equals searchsorted(lb_sorted, ub, 'right')
    for every non-NaN ub.
    """
    h = lb_sorted.shape[0]
    c = (lb_sorted[None, :] <= ub[:, None]).sum(dim=1)
    return torch.bincount(c, minlength=h + 1).to(torch.int32)


def ub_histogram_batch_ref(ub: Tensor, lb_sorted: Tensor) -> Tensor:
    """:func:`ub_histogram_ref` per row: ub (m, p), lb_sorted (m, h)."""
    return torch.stack([ub_histogram_ref(u, l) for u, l in zip(ub, lb_sorted)])


def ge_counts_from_hist(hist: Tensor, lb_sorted: Tensor,
                        lb_cand: Tensor) -> Tensor:
    """Per-candidate #{i : ub_i >= lb} from the c-histogram (exact); rows
    of 2-D arguments are problems of a fleet."""
    suffix = torch.cumsum(hist.flip(-1), -1).flip(-1)  # suffix[m] = Σ_{t>=m}
    pos = torch.searchsorted(lb_sorted, lb_cand, right=False)
    return torch.gather(suffix, -1, torch.clamp(
        pos + 1, max=hist.shape[-1] - 1)).to(torch.int32)


def survivor_count(ub: Tensor) -> Tensor:
    """#{i : ub_i >= 1}; -inf entries (active/skipped) never count."""
    return torch.sum(ub >= 1.0, dtype=torch.int32)


def screen_tail_ref(ub: Tensor, tmax: Tensor, cand_score: Tensor,
                    cand_idx: Tensor, col_norm: Tensor, r):
    """The serial screen's tail, from the scan's ub (p,) and tile maxima
    tmax and the merged candidates' scores and ids (h,): returns max ub,
    the candidates' lower bounds lb_l = |score_l - ||x_l|| r|, their
    violation counts #{i : ub_i >= lb_l} (int32) and the survivors
    #{i : ub_i >= 1} (int32). A padding candidate (id >= p, score -inf)
    reads column p - 1 and gets lb = +inf."""
    p = ub.shape[0]
    cand_lb = torch.abs(cand_score -
                        col_norm[torch.clamp(cand_idx, max=p - 1)] * r)
    lb_sorted = torch.sort(cand_lb).values
    hist = ub_histogram_ref(ub, lb_sorted)
    cand_ge = ge_counts_from_hist(hist, lb_sorted, cand_lb)
    return torch.max(tmax), cand_lb, cand_ge, survivor_count(ub)


def screen_tail_batch_ref(ub: Tensor, tmax: Tensor, cand_score: Tensor,
                          cand_idx: Tensor, col_norm: Tensor, r: Tensor):
    """:func:`screen_tail_ref` per row: ub (m, p), tmax (m, p/BP), scores
    and ids (m, h), col_norm (p,) shared or (m, p), r (m,)."""
    m, p = ub.shape
    cn = col_norm.expand(m, -1) if col_norm.ndim == 1 else col_norm
    cand_lb = torch.abs(cand_score - torch.gather(
        cn, 1, torch.clamp(cand_idx, max=p - 1)) * r[:, None])
    lb_sorted = torch.sort(cand_lb, dim=1).values
    hist = ub_histogram_batch_ref(ub, lb_sorted)
    return (torch.amax(tmax, dim=1), cand_lb,
            ge_counts_from_hist(hist, lb_sorted, cand_lb),
            torch.sum(ub >= 1.0, dim=1, dtype=torch.int32))
