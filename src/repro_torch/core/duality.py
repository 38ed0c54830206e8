"""Dual-variable machinery, in torch (port of ``repro.core.duality``).

  * the scaled feasibility projection (Lemma 2's theta_k)
  * the gap-safe ball   B(theta, r),  r^2 = 2*alpha*gap/lam^2        (Eq. 6/11)
  * the sequential-style ball from lambda_max(t)                     (Thm 2)
  * the covering ball of the intersection of two balls               (Eq. 12)
  * the post-hoc KKT residual, lambda_max and the null-model gradient

Every function works on a sub-problem given by an explicit design block
``Xa`` (n x k, the gathered active columns). Only the plain-LASSO branch is
ported: the unpenalized-slot machinery (``pen``, ``x_unpen``,
``polish_unpen``) belongs to the fused-LASSO slice.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.losses import Loss

Tensor = torch.Tensor


class Ball(NamedTuple):
    center: Tensor  # (n,)
    radius: Tensor  # scalar


def feasible_dual(loss: Loss, X_for_constraints: Tensor, y: Tensor,
                  hat_theta: Tensor, lam, mask: Tensor | None = None
                  ) -> Tensor:
    """Scale hat_theta into Omega = {theta : |x_i^T theta| <= 1 for i in set}.

    Lemma 2 scaling by 1 / max_i |x_i^T hat_theta| (when that exceeds 1);
    for least squares the DPP-style optimal scaling
    tau* = y^T hat_theta / (lam ||hat_theta||^2), clipped into the feasible
    range. ``mask`` marks valid columns of ``X_for_constraints``.
    """
    corr = X_for_constraints.T @ hat_theta
    if mask is not None:
        corr = torch.where(mask, corr, 0.0)
    max_corr = torch.max(torch.abs(corr))
    denom = torch.clamp(max_corr, min=1.0)
    bound = 1.0 / torch.clamp(max_corr, min=1e-30)

    if loss.name == "least_squares":
        sq = torch.sum(hat_theta * hat_theta)
        tau_star = torch.dot(y, hat_theta) / (lam * torch.clamp(sq, min=1e-30))
        tau = torch.minimum(torch.maximum(tau_star, -bound), bound)
        tau = torch.where(torch.isfinite(tau), tau, 1.0 / denom)
        return tau * hat_theta
    theta = hat_theta / denom
    return -loss.dual_clip(-lam * theta, y) / lam


def duality_gap(loss: Loss, Xa: Tensor, y: Tensor, beta: Tensor,
                theta: Tensor, lam, mask: Tensor | None = None) -> Tensor:
    """P_t(beta) - D_t(theta) for the sub-problem restricted to ``Xa``."""
    if mask is not None:
        beta = torch.where(mask, beta, 0.0)
    return (loss.primal_objective(Xa, y, beta, lam)
            - loss.dual_objective(y, theta, lam))


def gap_ball(loss: Loss, theta: Tensor, gap: Tensor, lam,
             floor=0.0) -> Ball:
    """Gap-safe ball: r^2 = 2*alpha*max(gap, floor) / lam^2."""
    gap = torch.clamp(gap, min=floor)
    r = torch.sqrt(2.0 * loss.smoothness * gap) / lam
    return Ball(center=theta, radius=r)


def gap_precision_floor(theta: Tensor, lam) -> Tensor:
    """Arithmetic-precision scale of a duality-gap estimate at ``theta``:
    8 eps_dtype * max(0.5 lam^2 ||theta||^2, 1) (see the reference)."""
    eps_m = torch.finfo(theta.dtype).eps
    scale = torch.clamp(0.5 * lam * lam * torch.sum(theta * theta, dim=-1),
                        min=1.0)
    return 8.0 * eps_m * scale


def sequential_ball(loss: Loss, y: Tensor, theta0: Tensor, lam0: Tensor,
                    lam) -> Ball:
    """Theorem 2 ball around (lam0/lam) * theta0, for lam < lam0.

    r^2 = (2 alpha / lam^2) [ f*(-(lam^2/lam0) theta0) - f*(-lam0 theta0)
                              + (lam - lam0) <f*'(-lam0 theta0), theta0> ].
    """
    alpha = loss.smoothness
    u0 = -lam0 * theta0
    fstar_grad = loss.conj_grad(u0, y)
    term = (torch.sum(loss.conj(-(lam * lam / lam0) * theta0, y))
            - torch.sum(loss.conj(u0, y))
            + (lam - lam0) * torch.dot(fstar_grad, theta0))
    r2 = torch.clamp(2.0 * alpha / (lam * lam) * term, min=0.0)
    return Ball(center=(lam0 / lam) * theta0, radius=torch.sqrt(r2))


def intersect_balls(b1: Ball, b2: Ball) -> Ball:
    """Smallest ball covering B1 ∩ B2 (paper Eq. 12), with the reference's
    signed radical-plane form and its fallback to the smaller input ball."""
    d = torch.linalg.vector_norm(b1.center - b2.center)
    r1, r2 = b1.radius, b2.radius
    safe_d = torch.clamp(d, min=1e-30)
    d1 = (d * d + r1 * r1 - r2 * r2) / (2.0 * safe_d)
    rt = torch.sqrt(torch.clamp(r1 * r1 - d1 * d1, min=0.0))
    center_t = (1.0 - d1 / safe_d) * b1.center + (d1 / safe_d) * b2.center

    intersects = (d <= r1 + r2) & (d >= torch.abs(r1 - r2))
    between = (d1 >= 0.0) & (d1 <= d)
    use_lens = intersects & between & (rt < torch.minimum(r1, r2))

    small_is_1 = r1 <= r2
    fallback_c = torch.where(small_is_1, b1.center, b2.center)
    fallback_r = torch.minimum(r1, r2)
    center = torch.where(use_lens, center_t, fallback_c)
    radius = torch.where(use_lens, rt, fallback_r)
    return Ball(center=center, radius=radius)


def kkt_residual(loss: Loss, X: Tensor, y: Tensor, beta: Tensor, lam,
                 active_tol: float = 0.0) -> Tensor:
    """Max KKT violation of a candidate LASSO solution over all p
    coordinates (0 at the exact optimum): with g = X^T f'(X beta),
    |g_i| <= lam off the support and g_i = -lam sign(beta_i) on it."""
    g = loss.grad(X @ beta, y)
    c = X.T @ g
    active = torch.abs(beta) > active_tol
    inactive_viol = torch.clamp(torch.abs(c) - lam, min=0.0)
    active_viol = torch.abs(c + lam * torch.sign(beta))
    return torch.max(torch.where(active, active_viol, inactive_viol))


def lambda_max(loss: Loss, X: Tensor, y: Tensor) -> Tensor:
    """Smallest lam with beta* = 0:  max_i |x_i^T f'(0)|   (paper Sec 2.2)."""
    g0 = loss.grad(torch.zeros_like(y), y)
    return torch.max(torch.abs(X.T @ g0))


def null_gradient(loss: Loss, X: Tensor, y: Tensor):
    """(g0, c0, b0) of the penalized-null model of a plain LASSO:
    g0 = f'(0), c0 = |X^T g0|, b0 = 0."""
    g0 = loss.grad(torch.zeros_like(y), y)
    return g0, torch.abs(X.T @ g0), 0.0
