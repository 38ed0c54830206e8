"""Gap-safe dynamic screening baseline, in torch (port of
``repro.core.dynamic``; Ndiaye et al. 2015, Fercoq et al. 2015).

Starts from the full feature set, interleaves ``inner_epochs`` CM sweeps
with gap-safe screening, and physically compacts the design when the
surviving fraction falls under ``compact_ratio``. The design is kept
transposed only, ``XT`` (k, n): one (k, n) copy per compaction, which the
sweeps (K7 on the card), the screen's X^T c and the dual point's X^T hat
all read. A stage is a host loop with two host reads per outer step (the
sweep's visit count, then the gap and the survivor count), against
``inner_epochs`` sweeps of k columns.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.cm import cm_epochs_wide
from repro_torch.core.duality import duality_gap, feasible_dual, gap_ball
from repro_torch.core.losses import Loss, get_loss
from repro_torch.core.saif import as_tensor, resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class DynConfig:
    eps: float = 1e-6
    inner_epochs: int = 5
    max_outer: int = 20000
    compact_ratio: float = 0.7   # compact when surviving fraction < this
    loss: str = "least_squares"


class DynResult(NamedTuple):
    beta: Tensor
    gap: Tensor
    n_outer: int
    coord_updates: int      # total coordinate-update count (complexity proxy)
    survivor_history: list  # feature count after each stage


def _stage(loss: Loss, XT: Tensor, y: Tensor, col_sq: Tensor, beta: Tensor,
           mask: Tensor, lam, eps: float, frac_target: float,
           inner_epochs: int, max_outer: int):
    """Outer steps until gap <= eps, or ``max_outer`` steps, or the
    survivors fall under ``frac_target`` of the k columns. Returns (beta,
    mask, gap, steps)."""
    k = XT.shape[0]
    X = XT.T
    col_norm = torch.sqrt(col_sq)
    gap = torch.tensor(float("inf"), dtype=XT.dtype, device=XT.device)
    gap_f, n_live, t = float("inf"), int(mask.sum()), 0
    while gap_f > eps and t < max_outer and n_live / k >= frac_target:
        beta, z = cm_epochs_wide(loss, XT, y, beta, X @ beta, mask, lam,
                                 col_sq, inner_epochs)
        hat = -loss.grad(z, y) / lam
        theta = feasible_dual(loss, X, y, hat, lam, mask)
        gap = duality_gap(loss, X, y, beta, theta, lam, mask)
        ball = gap_ball(loss, theta, gap, lam)
        corr = torch.abs(XT @ ball.center)
        mask = mask & ~(corr + col_norm * ball.radius < 1.0)
        beta = torch.where(mask, beta, 0.0)
        t += 1
        gap_f, live_f = torch.stack([gap, mask.sum().to(gap.dtype)]).tolist()
        n_live = int(live_f)
    return beta, mask, gap, t


def dynamic_screening(X, y, lam: float, config: DynConfig = DynConfig(),
                      device=None) -> DynResult:
    """Dynamic gap-safe screening to duality gap <= eps at ``lam``.
    ``device=None`` runs on the card (every sweep one launch of K7); pass
    ``device="cpu"`` for the plain loop on the CPU."""
    dev = resolve_device(device)
    loss = get_loss(config.loss)
    X = as_tensor(X, dev)
    y = as_tensor(y, dev, X.dtype)
    p = X.shape[1]
    lam = float(torch.tensor(lam, dtype=X.dtype))

    live_idx = np.arange(p)              # global ids of current columns
    XT = X.T.contiguous()
    beta_c = torch.zeros(p, dtype=X.dtype, device=dev)
    mask = torch.ones(p, dtype=torch.bool, device=dev)
    total_outer = 0
    coord_updates = 0
    history = [p]

    while True:
        beta_c, mask, gap, t = _stage(
            loss, XT, y, torch.sum(XT * XT, dim=1), beta_c, mask, lam,
            config.eps, config.compact_ratio, config.inner_epochs,
            config.max_outer - total_outer)
        total_outer += t
        coord_updates += t * config.inner_epochs * XT.shape[0]
        if float(gap) <= config.eps or total_outer >= config.max_outer:
            break
        # compact: keep the surviving columns only
        keep_np = mask.cpu().numpy()
        if keep_np.sum() == 0 or keep_np.sum() == len(keep_np):
            # nothing screened this stage but gap not reached: continue as-is
            if keep_np.sum() == len(keep_np):
                continue
            break
        live_idx = live_idx[keep_np]
        XT = XT[mask]
        beta_c = beta_c[mask]
        mask = torch.ones(len(live_idx), dtype=torch.bool, device=dev)
        history.append(len(live_idx))

    beta_full = torch.zeros(p, dtype=X.dtype, device=dev)
    beta_full[torch.from_numpy(live_idx).to(dev)] = torch.where(
        mask, beta_c, 0.0)
    return DynResult(beta=beta_full, gap=gap, n_outer=total_outer,
                     coord_updates=coord_updates, survivor_history=history)
