"""Dual-variable machinery, in torch (port of ``repro.core.duality``).

  * the primal->dual map (the unscaled dual candidate)
  * the scaled feasibility projection (Lemma 2's theta_k)
  * the gap-safe ball   B(theta, r),  r^2 = 2*alpha*gap/lam^2        (Eq. 6/11)
  * the sequential-style ball from lambda_max(t)                     (Thm 2)
  * the covering ball of the intersection of two balls               (Eq. 12)
  * the post-hoc KKT residual, lambda_max and the null-model gradient
  * the certified rounding bounds of a mixed-precision screen (the
    reference's DESIGN.md §11): a gap-safe ball widened by a bound on the
    float error of its correlations is still safe

Every function works on a sub-problem given by an explicit design block
``Xa`` (n x k, the gathered active columns). An unpenalized coordinate
(fused LASSO's ``b``, Thm 7) enters through ``pen`` (per-column l1 weight,
0 on it) and ``x_unpen`` (its column): its dual constraint is the equality
x_b^T theta = 0, and :func:`polish_unpen` drives b to stationarity.
Without an unpenalized coordinate, the dual point, the gap and the balls
also take a stack of problems (the fast fleet's; see ``losses``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.active_set import columns
from repro_torch.core.losses import Loss, dot_last, mv_last, per_problem

Tensor = torch.Tensor


class Ball(NamedTuple):
    center: Tensor  # (n,)
    radius: Tensor  # scalar


def dual_point(loss: Loss, Xa: Tensor, y: Tensor, beta: Tensor,
               lam) -> Tensor:
    """hat_theta = -f'(Xa beta) / lam  (the unscaled dual candidate)."""
    return -loss.grad(Xa @ beta, y) / lam


def feasible_dual(loss: Loss, X_for_constraints: Tensor, y: Tensor,
                  hat_theta: Tensor, lam, mask: Tensor | None = None,
                  pen: Tensor | None = None,
                  x_unpen: Tensor | None = None) -> Tensor:
    """Scale hat_theta into Omega = {theta : |x_i^T theta| <= 1 for i in set}.

    Lemma 2 scaling by 1 / max_i |x_i^T hat_theta| (when that exceeds 1);
    for least squares the DPP-style optimal scaling
    tau* = y^T hat_theta / (lam ||hat_theta||^2), clipped into the feasible
    range. ``mask`` marks valid columns of ``X_for_constraints``. With an
    unpenalized column ``x_unpen`` (weight 0 in ``pen``), hat_theta is first
    projected onto the hyperplane x_unpen^T theta = 0 and the scaling sees
    only the penalized columns.
    """
    if x_unpen is not None:
        sq_b = torch.sum(x_unpen * x_unpen)
        hat_theta = hat_theta - x_unpen * (
            torch.dot(x_unpen, hat_theta) / torch.clamp(sq_b, min=1e-30))
    corr = mv_last(X_for_constraints.mT, hat_theta)
    if mask is not None:
        corr = torch.where(mask, corr, 0.0)
    if pen is not None:
        corr = corr * pen
    max_corr = torch.amax(torch.abs(corr), dim=-1)
    denom = torch.clamp(max_corr, min=1.0)
    bound = 1.0 / torch.clamp(max_corr, min=1e-30)

    if loss.name == "least_squares":
        sq = torch.sum(hat_theta * hat_theta, dim=-1)
        tau_star = dot_last(y, hat_theta) / (lam * torch.clamp(sq, min=1e-30))
        tau = torch.minimum(torch.maximum(tau_star, -bound), bound)
        tau = torch.where(torch.isfinite(tau), tau, 1.0 / denom)
        return per_problem(tau) * hat_theta
    theta = hat_theta / per_problem(denom)
    lam_c = per_problem(lam)
    return -loss.dual_clip(-lam_c * theta, y) / lam_c


def duality_gap(loss: Loss, Xa: Tensor, y: Tensor, beta: Tensor,
                theta: Tensor, lam, mask: Tensor | None = None,
                pen: Tensor | None = None) -> Tensor:
    """P_t(beta) - D_t(theta) for the sub-problem restricted to ``Xa``;
    ``pen`` weights the l1 term per column (0 = unpenalized)."""
    if mask is not None:
        beta = torch.where(mask, beta, 0.0)
    return (loss.primal_objective(Xa, y, beta, lam, weights=pen)
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
    l0, lc = per_problem(lam0), per_problem(lam)
    u0 = -l0 * theta0
    fstar_grad = loss.conj_grad(u0, y)
    term = (torch.sum(loss.conj(-(lc * lc / l0) * theta0, y), dim=-1)
            - torch.sum(loss.conj(u0, y), dim=-1)
            + (lam - lam0) * dot_last(fstar_grad, theta0))
    r2 = torch.clamp(2.0 * alpha / (lam * lam) * term, min=0.0)
    return Ball(center=(l0 / lc) * theta0, radius=torch.sqrt(r2))


def intersect_balls(b1: Ball, b2: Ball) -> Ball:
    """Smallest ball covering B1 ∩ B2 (paper Eq. 12), with the reference's
    signed radical-plane form and its fallback to the smaller input ball."""
    d = torch.linalg.vector_norm(b1.center - b2.center, dim=-1)
    r1, r2 = b1.radius, b2.radius
    safe_d = torch.clamp(d, min=1e-30)
    d1 = (d * d + r1 * r1 - r2 * r2) / (2.0 * safe_d)
    rt = torch.sqrt(torch.clamp(r1 * r1 - d1 * d1, min=0.0))
    center_t = (per_problem(1.0 - d1 / safe_d) * b1.center
                + per_problem(d1 / safe_d) * b2.center)

    intersects = (d <= r1 + r2) & (d >= torch.abs(r1 - r2))
    between = (d1 >= 0.0) & (d1 <= d)
    use_lens = intersects & between & (rt < torch.minimum(r1, r2))

    small_is_1 = r1 <= r2
    fallback_c = torch.where(per_problem(small_is_1), b1.center, b2.center)
    fallback_r = torch.minimum(r1, r2)
    center = torch.where(per_problem(use_lens), center_t, fallback_c)
    radius = torch.where(use_lens, rt, fallback_r)
    return Ball(center=center, radius=radius)


def kkt_residual(loss: Loss, X: Tensor, y: Tensor, beta: Tensor, lam,
                 pen: Tensor | None = None,
                 sample_w: Tensor | None = None,
                 active_tol: float = 0.0) -> Tensor:
    """Max KKT violation of a candidate LASSO solution over all p
    coordinates (0 at the exact optimum): with g = X^T f'(X beta),
    |g_i| <= lam off the support, g_i = -lam sign(beta_i) on it, and
    g_i = 0 on an unpenalized coordinate (``pen`` weights lam per column;
    0 = unpenalized). ``sample_w`` (n,) weights the gradient per sample
    (a weighted fleet's problem)."""
    g = loss.grad(X @ beta, y)
    if sample_w is not None:
        g = g * sample_w
    c = X.T @ g
    lam_i = lam * pen if pen is not None else lam
    active = torch.abs(beta) > active_tol
    inactive_viol = torch.clamp(torch.abs(c) - lam_i, min=0.0)
    active_viol = torch.abs(c + lam_i * torch.sign(beta))
    return torch.max(torch.where(active, active_viol, inactive_viol))


def lambda_max(loss: Loss, X: Tensor, y: Tensor) -> Tensor:
    """Smallest lam with beta* = 0:  max_i |x_i^T f'(0)|   (paper Sec 2.2)."""
    g0 = loss.grad(torch.zeros_like(y), y)
    return torch.max(torch.abs(X.T @ g0))


def polish_unpen(loss: Loss, x: Tensor, y: Tensor, z: Tensor, b,
                 iters: int = 4):
    """``iters`` exact 1-D Newton steps on the unpenalized coordinate ``b``
    along its column ``x`` from the model vector ``z`` (which includes
    x b). Returns (b, z) with x^T f'(z) ~ 0, so the dual point meets the
    equality constraint through the gradient itself. The Hessian is floored
    and the step clipped to 1e3 / max|x|, so separable logistic data cannot
    send b to infinity."""
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-30)
    lim = 1e3 / scale
    for _ in range(iters):
        g = torch.dot(x, loss.grad(z, y))
        H = torch.dot(x * x, loss.hess(z, y))
        d = torch.clamp(g / torch.clamp(H, min=1e-30), -lim, lim)
        b = b - d
        z = z - d * x
    return b, z


def fit_unpenalized(loss: Loss, x: Tensor, y: Tensor,
                    iters: int = 30) -> Tensor:
    """1-D Newton for min_b sum_j f(x_j b, y_j): the unpenalized slot's
    value in the penalized-null model."""
    b0 = torch.zeros((), dtype=x.dtype, device=x.device)
    b, _ = polish_unpen(loss, x, y, torch.zeros_like(y), b0, iters=iters)
    return b


def null_gradient(loss: Loss, X: Tensor, y: Tensor,
                  unpen_idx: int | None = None):
    """(g0, c0, b0) of the penalized-null model. Plain LASSO: g0 = f'(0),
    c0 = |X^T g0|, b0 = 0. With an unpenalized coordinate the null model is
    its partial optimum b0: g0 = f'(x_b b0), and c0[unpen_idx] = 0 (the slot
    is always resident and must not set lambda_max)."""
    g0, b0 = null_point(loss, None if unpen_idx is None
                        else columns(X, unpen_idx), y)
    c0 = torch.abs(X.T @ g0)
    if unpen_idx is not None:
        c0[unpen_idx] = 0.0
    return g0, c0, b0


def null_point(loss: Loss, xb: Tensor | None, y: Tensor):
    """(g0, b0) of the penalized-null model from the unpenalized column
    ``xb`` alone (None: plain LASSO, g0 = f'(0), b0 = 0): what a
    feature-sharded design needs before it scores its own columns."""
    if xb is None:
        return loss.grad(torch.zeros_like(y), y), 0.0
    b0 = fit_unpenalized(loss, xb, y)
    return loss.grad(xb * b0, y), b0


# ---------------------------------------------------------------------------
# certified mixed-precision screening: rigorous rounding-error bounds (port
# of repro/core/duality.py:244-306). Every bound is the reference's float.
# ---------------------------------------------------------------------------

def unit_roundoff(dtype) -> float:
    """u = eps/2 for the dtype (a torch dtype or its name):
    |fl(x op y) - (x op y)| <= u |x op y|."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return float(torch.finfo(dtype).eps) / 2.0


def dot_error_gamma(n: int, u: float) -> float:
    """gamma_n = n u / (1 - n u) (Higham, ASNA Lemma 3.1): a length-n inner
    product in precision u, in any summation order, is within gamma_n
    |x|.|y| <= gamma_n ||x|| ||y|| of the exact one. +inf when n u >= 1
    (the bound is vacuous)."""
    nu = float(n) * u
    if nu >= 1.0:
        return float("inf")
    return nu / (1.0 - nu)


def mixed_precision_gamma(n: int, in_dtype, acc_dtype,
                          u_acc: float | None = None) -> float:
    """Forward-error factor of a dot with inputs rounded to ``in_dtype``
    and sums in ``acc_dtype``: |fl(x.y) - x.y| <= gamma_total ||x|| ||y||,
    gamma_total = (1 + u_in)^2 (1 + gamma_n(u_acc)) - 1 (a re-associated
    working-precision contraction with in = acc). ``u_acc``: the sums' unit
    roundoff where their adder is not ``acc_dtype``'s round-to-nearest (a
    truncating one: 2 u)."""
    u_in = unit_roundoff(in_dtype)
    if u_acc is None:
        u_acc = unit_roundoff(acc_dtype)
    return (1.0 + u_in) ** 2 * (1.0 + dot_error_gamma(n, u_acc)) - 1.0


def widened_radius(r, theta: Tensor, gamma: float):
    """Safe-ball radius widened to absorb the screening dot's rounding:
    r' = r + gamma ||theta||_2 (the rules multiply the radius by each
    column's norm), with the computed norm inflated by 1 + 2
    gamma_{n+2}(u_work) so that r' bounds the true widening. ``theta``
    (..., n) is the ball center; r broadcasts."""
    n = theta.shape[-1]
    u_w = unit_roundoff(theta.dtype)
    slack = 1.0 + 2.0 * dot_error_gamma(n + 2, u_w)
    norm = torch.sqrt(torch.sum(theta * theta, dim=-1))
    return r + gamma * slack * norm
