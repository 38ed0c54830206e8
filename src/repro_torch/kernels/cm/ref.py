"""Plain PyTorch version of the CM burst kernel.

The reference package has no plain twin of ``cm_burst_pallas``; this one
repeats its arithmetic for the plain-LASSO specialisation (every slot
penalized): the compact prox-Newton sweeps of ``core/cm.py``, then a fresh
z = A beta, the feasible dual point and the primal-dual gap.
"""
from __future__ import annotations

import torch

from repro_torch.core.cm import cm_sweeps
from repro_torch.core.losses import get_loss

Tensor = torch.Tensor


def cm_burst_ref(A: Tensor, y: Tensor, beta: Tensor, col_sq: Tensor,
                 mask: Tensor, order: Tensor, lam, n_epochs, count, *,
                 loss_name: str = "least_squares"):
    """One "CM burst + gap" on the (n, k) active block ``A``.

    Returns (beta (k,), z (n,), theta (n,), gap scalar) like the kernel.
    """
    loss = get_loss(loss_name)
    beta, _ = cm_sweeps(loss, A, y, beta, A @ beta, mask, lam, col_sq,
                        order, count, n_epochs)
    z = A @ beta                                   # fresh, drift-free
    hat = -loss.grad(z, y) / lam
    max_corr = torch.max(torch.abs(hat @ A))
    if loss.name == "least_squares":
        bound = 1.0 / torch.clamp(max_corr, min=1e-30)
        sq = torch.sum(hat * hat)
        tau_star = torch.dot(y, hat) / (lam * torch.clamp(sq, min=1e-30))
        tau = torch.minimum(torch.maximum(tau_star, -bound), bound)
        tau = torch.where(torch.isfinite(tau), tau,
                          1.0 / torch.clamp(max_corr, min=1.0))
        theta = tau * hat
    else:
        theta = hat / torch.clamp(max_corr, min=1.0)
        theta = -loss.dual_clip(-lam * theta, y) / lam
    p_val = torch.sum(loss.value(z, y)) + lam * torch.sum(torch.abs(beta))
    d_val = -torch.sum(loss.conj(-lam * theta, y))
    return beta, z, theta, p_val - d_val
