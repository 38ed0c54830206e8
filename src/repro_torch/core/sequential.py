"""Sequential (DPP-style) screening baseline over a lambda path, in torch
(port of ``repro.core.sequential``; paper Sec 5.3).

Given the solution at lambda_0 > lambda, Theorem 2 yields a ball for
theta*(lambda); features with |x_i^T c| + ||x_i|| r < 1 are screened
before the reduced problem is solved with CM (K7 on the card), along a
descending lambda path with warm starts. The design is kept transposed,
``XT`` (p, n), so a reduced design is a gather of its rows.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.cm import cm_epochs_wide
from repro_torch.core.duality import (duality_gap, feasible_dual,
                                      sequential_ball)
from repro_torch.core.losses import Loss, get_loss
from repro_torch.core.saif import as_tensor, resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SeqConfig:
    eps: float = 1e-6
    inner_epochs: int = 10
    max_outer: int = 20000
    loss: str = "least_squares"


class PathResult(NamedTuple):
    lams: np.ndarray
    betas: List[Tensor]         # one (p,) vector per lambda
    screened_frac: List[float]  # fraction screened before each solve
    coord_updates: int


def _solve_reduced(loss: Loss, XTr: Tensor, y: Tensor, lam, beta0: Tensor,
                   eps: float, inner_epochs: int, max_outer: int):
    """CM to duality gap <= eps on the reduced design, given transposed
    (k, n): outer steps of ``inner_epochs`` sweeps (one K7 launch on the
    card) and a gap, with two host reads each (the sweep's visit count
    and the gap). Returns (beta, z, gap, steps)."""
    k = XTr.shape[0]
    Xr = XTr.T
    mask = torch.ones(k, dtype=torch.bool, device=XTr.device)
    col_sq = torch.sum(XTr * XTr, dim=1)
    beta, z = beta0, Xr @ beta0
    gap = torch.tensor(float("inf"), dtype=XTr.dtype, device=XTr.device)
    t = 0
    while float(gap) > eps and t < max_outer:
        beta, z = cm_epochs_wide(loss, XTr, y, beta, z, mask, lam, col_sq,
                                 inner_epochs)
        hat = -loss.grad(z, y) / lam
        theta = feasible_dual(loss, Xr, y, hat, lam)
        gap = duality_gap(loss, Xr, y, beta, theta, lam)
        t += 1
    return beta, z, gap, t


def sequential_path(X, y, lams: Sequence[float],
                    config: SeqConfig = SeqConfig(),
                    device=None) -> PathResult:
    """Solve LASSO along a descending lambda path with DPP-style
    screening. ``device=None`` runs on the card; ``device="cpu"`` the
    plain loop on the CPU."""
    dev = resolve_device(device)
    loss = get_loss(config.loss)
    X = as_tensor(X, dev)
    y = as_tensor(y, dev, X.dtype)
    p = X.shape[1]
    XT = X.T.contiguous()
    col_norm = torch.sqrt(torch.sum(XT * XT, dim=1))
    g0 = loss.grad(torch.zeros_like(y), y)
    lam_max = float(torch.max(torch.abs(XT @ g0)))

    def as_dtype(v: float) -> float:
        return float(torch.tensor(v, dtype=X.dtype))

    lams = np.asarray(sorted([float(l) for l in lams], reverse=True))
    betas, fracs = [], []
    coord_updates = 0

    # state of the previous solve (starts at lambda_max, beta = 0)
    lam_prev = lam_max
    theta_prev = -g0 / lam_max
    beta_prev_full = torch.zeros(p, dtype=X.dtype, device=dev)

    for lam_f in lams:
        lam = as_dtype(min(lam_f, lam_max * (1 - 1e-12)))
        ball = sequential_ball(loss, y, theta_prev, as_dtype(lam_prev), lam)
        corr = torch.abs(XT @ ball.center)
        keep = ~(corr + col_norm * ball.radius < 1.0)
        keep_np = keep.cpu().numpy()
        fracs.append(1.0 - keep_np.mean())

        XTr = XT[keep]
        beta_r, z, gap, t = _solve_reduced(
            loss, XTr, y, lam, beta_prev_full[keep], config.eps,
            config.inner_epochs, config.max_outer)
        coord_updates += t * config.inner_epochs * XTr.shape[0]

        beta_full = torch.zeros(p, dtype=X.dtype, device=dev)
        beta_full[keep] = beta_r
        betas.append(beta_full)

        hat = -loss.grad(z, y) / lam
        theta_prev = feasible_dual(loss, XTr.T, y, hat, lam)
        lam_prev = lam
        beta_prev_full = beta_full

    return PathResult(lams=lams, betas=betas, screened_frac=fracs,
                      coord_updates=coord_updates)
