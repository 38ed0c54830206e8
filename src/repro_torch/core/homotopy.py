"""Unsafe strong-rule homotopy baseline, in torch (port of
``repro.core.homotopy``; Tibshirani et al. 2012, Zhao 2017).

The paper's Table-1 antagonist: pathwise coordinate descent whose active
set is initialized per lambda by the strong rule
    |x_i^T f'(X beta(lam_prev))| >= 2 lam - lam_prev
plus the warm support, with no safe convergence check on the discarded
set, so it can miss true features (recall < 1) and keep spurious ones
(precision < 1). ``kkt_check`` makes it safe: KKT violators re-enter the
set until none remain. ``greedy_cap`` truncates the candidates to the
top-scoring few (Zhao 2017-style). The reduced solves are
:func:`repro_torch.core.sequential._solve_reduced` (K7 on the card).
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.losses import get_loss
from repro_torch.core.saif import as_tensor, resolve_device
from repro_torch.core.sequential import _solve_reduced

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class HomotopyConfig:
    eps: float = 1e-6
    inner_epochs: int = 10
    max_outer: int = 5000
    kkt_check: bool = False   # False = paper's unsafe baseline
    # 0 = off (pure strong rule); k > 0 caps the set at warm support + k
    # candidates
    greedy_cap: int = 0
    loss: str = "least_squares"


class HomotopyResult(NamedTuple):
    lams: np.ndarray
    betas: List[Tensor]
    supports: List[np.ndarray]
    coord_updates: int


def homotopy_path(X, y, lams: Sequence[float],
                  config: HomotopyConfig = HomotopyConfig(),
                  device=None) -> HomotopyResult:
    """The strong-rule homotopy along a descending lambda path.
    ``device=None`` runs on the card; ``device="cpu"`` the plain loop on
    the CPU."""
    dev = resolve_device(device)
    loss = get_loss(config.loss)
    X = as_tensor(X, dev)
    y = as_tensor(y, dev, X.dtype)
    p = X.shape[1]
    XT = X.T.contiguous()
    g0 = loss.grad(torch.zeros_like(y), y)
    lam_max = float(torch.max(torch.abs(XT @ g0)))

    def correlations(beta):
        return torch.abs(XT @ loss.grad(XT.T @ beta, y))

    lams = np.asarray(sorted([float(l) for l in lams], reverse=True))
    betas, supports = [], []
    coord_updates = 0

    lam_prev = lam_max
    beta_full = torch.zeros(p, dtype=X.dtype, device=dev)

    for lam_f in lams:
        lam = float(torch.tensor(min(lam_f, lam_max * (1 - 1e-12)),
                                 dtype=X.dtype))
        # strong rule on the residual correlations at the previous solution
        corr = correlations(beta_full)
        corr_np = corr.cpu().numpy()
        strong = corr_np >= 2.0 * lam - lam_prev
        if config.greedy_cap > 0:
            # truncated pathwise variant: keep only the top-`cap` strong
            # candidates by correlation (plus the warm support)
            cand = np.where(strong)[0]
            if len(cand) > config.greedy_cap:
                order = np.argsort(-corr_np[cand])
                keep = cand[order[:config.greedy_cap]]
                strong[:] = False
                strong[keep] = True
        strong |= (torch.abs(beta_full) > 0).cpu().numpy()  # warm support
        if not strong.any():
            strong[int(torch.argmax(corr))] = True

        while True:
            idx = torch.from_numpy(np.where(strong)[0]).to(dev)
            beta_r, z, gap, t = _solve_reduced(
                loss, XT[idx], y, lam, beta_full[idx], config.eps,
                config.inner_epochs, config.max_outer)
            coord_updates += t * config.inner_epochs * len(idx)
            beta_full = torch.zeros(p, dtype=X.dtype, device=dev)
            beta_full[idx] = beta_r
            if not config.kkt_check:
                break
            # safe variant: re-admit KKT violators among discarded features
            viol = (correlations(beta_full) > lam * (1 + 1e-9)).cpu().numpy()
            viol &= ~strong
            if not viol.any():
                break
            strong |= viol

        betas.append(beta_full)
        supports.append(np.where((torch.abs(beta_full) > 1e-8).cpu()
                                 .numpy())[0])
        lam_prev = lam

    return HomotopyResult(lams=lams, betas=betas, supports=supports,
                          coord_updates=coord_updates)


def support_metrics(est_support: np.ndarray, true_support: np.ndarray):
    """Recall / precision of a recovered support vs the safe ground truth."""
    est, true = set(est_support.tolist()), set(true_support.tolist())
    tp = len(est & true)
    recall = tp / len(true) if true else 1.0     # vacuous: nothing to recall
    precision = tp / len(est) if est else 1.0    # vacuous: nothing spurious
    return recall, precision
