"""Cyclic coordinate minimization, in torch (port of ``repro.core.cm``).

The coordinate step of every sweep is the reference's
prox-Newton-majorized step with per-coordinate Lipschitz L_j = alpha ||x_j||^2
    beta_j <- S(beta_j - x_j^T f'(z) / L_j,  lam / L_j)
(for least squares the exact minimizer), with the model vector z = Xa beta
maintained by rank-1 updates. The covariance-update form for least squares
(qr = G beta - rho on the active-block Gram matrix, O(k_max) per step) is
kernel K6 in ``kernels/gram``, with its plain loop beside it.

:func:`cm_epoch` is the reference's masked sweep over every column, and
:func:`cm_epochs_wide` the same sweeps on a transposed design of any width
(the inner solver of the baselines and of :func:`solve_lasso_cm`): K7
``kernels/cm/wide.py::cm_sweep_wide`` on the card, its plain loop on the
CPU.

The residual-form loops are the plain versions the CUDA burst kernel is
held against, and they run on whichever device holds the tensors. A
cyclic sweep is a chain of dependent scalar steps, so each step here reads
its one scalar (the correlation) to the host, does the soft-threshold in
Python floats (IEEE double, the arithmetic of a float64 tensor op), and
applies the rank-1 update as one tensor op. On a card that is one
synchronisation per coordinate step, which is why the solver reaches for
the kernel there.

``sample_w`` (n,) weights the loss per sample, sum_i w_i f(z_i, y_i) (the
K-fold CV row-mask trick): the gradient picks up the weight while z and
the design stay unweighted, so X is shared across a weighted fleet; the
squared column norms become sum_i w_i x_ij^2.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import torch

from repro_torch.core.losses import Loss

Tensor = torch.Tensor


def soft_threshold(x: Tensor, t) -> Tensor:
    return torch.sign(x) * torch.clamp(torch.abs(x) - t, min=0.0)


def _soft_threshold_f(u: float, t: float) -> float:
    """Scalar :func:`soft_threshold`: sign(u) * max(|u| - t, 0)."""
    a = abs(u) - t
    return math.copysign(a, u) if a > 0.0 else 0.0


def _coordinate_step(loss: Loss, Xa: Tensor, y: Tensor, live: bool,
                     lam_j: float, lj: float, j: int, beta: List[float],
                     z: Tensor, sample_w: Tensor | None = None) -> None:
    """One prox coordinate update of slot ``j``, in place: ``beta`` is a
    host list of coefficients, ``z`` the model vector on the device.
    ``lam_j`` is slot j's l1 weight times lambda (0 = unpenalized, an
    unthresholded step); ``sample_w`` the optional per-sample weights."""
    xj = Xa[:, j]
    g_vec = loss.grad(z, y)
    if sample_w is not None:
        g_vec = sample_w * g_vec
    g = float(torch.dot(xj, g_vec))
    bj = beta[j]
    b_new = _soft_threshold_f(bj - g / lj, lam_j / lj) if live else 0.0
    if b_new != bj:
        z.add_(xj, alpha=b_new - bj)
    beta[j] = b_new


def _slot_lams(lam, pen: Tensor | None, k: int) -> List[float]:
    """lambda times each slot's l1 weight, as host floats."""
    lam_f = float(lam)
    if pen is None:
        return [lam_f] * k
    return [lam_f * w for w in pen.tolist()]


def cm_sweeps(loss: Loss, Xa: Tensor, y: Tensor, beta: Tensor, z: Tensor,
              mask: Tensor, lam, col_sq: Tensor, order: Tensor, count: int,
              n_epochs: int, pen: Tensor | None = None,
              sample_w: Tensor | None = None) -> Tuple[Tensor, Tensor]:
    """``n_epochs`` compact sweeps over the ``count`` live slots listed
    first in ``order``, with the per-slot squared norms ``col_sq`` given
    (weighted ones under ``sample_w``) and the optional per-slot l1 weights
    ``pen``. Shared by :func:`cm_epochs_compact` and the plain CM burst."""
    sched = order[:int(count)].tolist()
    live = mask.tolist()
    lj = torch.clamp(loss.smoothness * col_sq, min=1e-30).tolist()
    lams = _slot_lams(lam, pen, len(live))
    b = beta.tolist()
    z = z.clone()
    for _ in range(int(n_epochs)):
        for j in sched:
            _coordinate_step(loss, Xa, y, live[j], lams[j], lj[j], j, b, z,
                             sample_w)
    return torch.tensor(b, dtype=beta.dtype, device=beta.device), z


def cm_epochs_compact(loss: Loss, Xa: Tensor, y: Tensor, beta: Tensor,
                      z: Tensor, mask: Tensor, lam, order: Tensor, count,
                      n_epochs, pen: Tensor | None = None,
                      sample_w: Tensor | None = None
                      ) -> Tuple[Tensor, Tensor]:
    """``n_epochs`` compact sweeps (the reference's jnp inner burst);
    ``sample_w`` weights the loss per sample."""
    if sample_w is None:
        col_sq = torch.sum(Xa * Xa, dim=0)
    else:
        col_sq = torch.sum(sample_w[:, None] * Xa * Xa, dim=0)
    return cm_sweeps(loss, Xa, y, beta, z, mask, lam, col_sq, order, count,
                     n_epochs, pen, sample_w)


def sweep_order(mask: Tensor, beta: Tensor) -> Tuple[Tensor, int]:
    """The slots a masked sweep must visit, first and in index order: the
    live ones and the masked ones whose beta is not 0 (a masked slot at 0
    steps to 0, a no-op). Returns (order, their number), the number at one
    host read."""
    visit = mask | (beta != 0)
    order = torch.argsort((~visit).to(torch.int8), stable=True)
    return order, int(visit.sum())


def cm_epochs_wide(loss: Loss, XT: Tensor, y: Tensor, beta: Tensor,
                   z: Tensor, mask: Tensor, lam, col_sq: Tensor,
                   n_epochs: int, pen: Tensor | None = None
                   ) -> Tuple[Tensor, Tensor]:
    """``n_epochs`` of the reference's masked cyclic sweeps over every
    column of the design, given transposed, ``XT`` (k, n), with its squared
    column norms ``col_sq`` (k,): K7 on a card, its plain loop on the CPU.
    Returns (beta, z)."""
    from repro_torch.kernels.cm.wide import cm_sweep_wide
    order, count = sweep_order(mask, beta)
    return cm_sweep_wide(XT, y, beta, z, col_sq, mask, order, lam, n_epochs,
                         count, pen, loss_name=loss.name)


def cm_epoch(loss: Loss, Xa: Tensor, y: Tensor, beta: Tensor, z: Tensor,
             mask: Tensor, lam, pen: Tensor | None = None
             ) -> Tuple[Tensor, Tensor]:
    """One full cyclic sweep over the (masked) coordinates of the (n, k)
    block ``Xa`` from (beta, z = Xa beta), with optional per-column l1
    weights ``pen`` (0 = unpenalized). Returns (beta, z)."""
    XT = Xa.T.contiguous()
    return cm_epochs_wide(loss, XT, y, beta, z, mask, lam,
                          torch.sum(XT * XT, dim=1), 1, pen)


def solve_lasso_cm(loss: Loss, X: Tensor, y: Tensor, lam: float,
                   tol: float = 1e-9, max_epochs: int = 100_000,
                   unpen_idx: int | None = None) -> Tensor:
    """Unscreened full LASSO solve to duality gap <= tol (the "No Scr."
    baseline and the oracle of the tests). ``unpen_idx`` exempts one
    coordinate from the l1 penalty (fused LASSO's ``b``): its step is
    unthresholded, for a general loss it is Newton-polished after every
    sweep, and the dual point is projected onto its equality constraint.
    Every sweep is one call of :func:`cm_epochs_wide` on X^T: a launch of
    K7 on a card, the plain loop on the CPU."""
    from repro_torch.core.duality import (duality_gap, feasible_dual,
                                          polish_unpen)

    p = X.shape[1]
    mask = torch.ones(p, dtype=torch.bool, device=X.device)
    pen = x_unpen = None
    if unpen_idx is not None:
        pen = torch.ones(p, dtype=X.dtype, device=X.device)
        pen[unpen_idx] = 0.0
        x_unpen = X[:, unpen_idx]
    beta = torch.zeros(p, dtype=X.dtype, device=X.device)
    z = torch.zeros_like(y)
    XT = X.T.contiguous()
    col_sq = torch.sum(XT * XT, dim=1)
    for _ in range(max_epochs):
        beta, z = cm_epochs_wide(loss, XT, y, beta, z, mask, lam, col_sq, 1,
                                 pen)
        if unpen_idx is not None and loss.name != "least_squares":
            b_new, z = polish_unpen(loss, x_unpen, y, z, beta[unpen_idx])
            beta[unpen_idx] = b_new
        hat = -loss.grad(z, y) / lam
        theta = feasible_dual(loss, X, y, hat, lam, pen=pen, x_unpen=x_unpen)
        if float(duality_gap(loss, X, y, beta, theta, lam, pen=pen)) <= tol:
            break
    return beta
