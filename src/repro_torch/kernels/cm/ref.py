"""Plain PyTorch version of the CM burst kernel.

The reference package has no plain twin of ``cm_burst_pallas``; this one
repeats its arithmetic: the compact prox-Newton sweeps of ``core/cm.py``,
then a fresh z = A beta, the feasible dual point and the primal-dual gap.
With ``pen`` (per-slot l1 weights, 0 on fused LASSO's unpenalized slot) it
is the ``has_unpen=True`` branch: the unpenalized column
ab = A (mask (1 - pen)), for a general loss a Newton polish of b along it
before the dual point, the projection of the dual point onto ab's
orthogonal complement, the scaling over the penalized columns only and the
pen-weighted l1 term in the primal.

:func:`cm_epochs_ref` is the plain version of K5 ``cm_epochs``, the
reference's ``kernels/cm/ref.py::cm_epochs_ref`` in torch: residual-form
least-squares sweeps over every slot, in float32.

:func:`cm_sweep_wide_ref` is the plain version of K7 ``cm_sweep_wide``:
the compact sweeps of ``core/cm.py::cm_sweeps`` on a transposed design of
any width, with no tail.
"""
from __future__ import annotations

import torch

from repro_torch.core.cm import cm_sweeps
from repro_torch.core.duality import polish_unpen
from repro_torch.core.losses import get_loss

Tensor = torch.Tensor


def cm_burst_ref(A: Tensor, y: Tensor, beta: Tensor, col_sq: Tensor,
                 mask: Tensor, order: Tensor, lam, n_epochs, count,
                 pen: Tensor | None = None, *,
                 loss_name: str = "least_squares"):
    """One "CM burst + gap" on the (n, k) active block ``A``.

    Returns (beta (k,), z (n,), theta (n,), gap scalar) like the kernel.
    """
    loss = get_loss(loss_name)
    beta, _ = cm_sweeps(loss, A, y, beta, A @ beta, mask, lam, col_sq,
                        order, count, n_epochs, pen)
    z = A @ beta                                   # fresh, drift-free
    if pen is not None:
        w = torch.where(mask, 1.0 - pen, 0.0).to(A.dtype)
        ab = A @ w                                 # the unpenalized column
        if loss.name != "least_squares":
            b_new, z = polish_unpen(loss, ab, y, z, torch.dot(beta, w))
            beta = torch.where(w > 0.5, b_new, beta)
    hat = -loss.grad(z, y) / lam
    if pen is not None:
        sq_b = torch.dot(ab, ab)
        hat = hat - ab * (torch.dot(ab, hat) / torch.clamp(sq_b, min=1e-30))
    corr = torch.abs(hat @ A)
    max_corr = torch.max(corr if pen is None else corr * pen)
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
    l1 = torch.abs(beta) if pen is None else pen * torch.abs(beta)
    p_val = torch.sum(loss.value(z, y)) + lam * torch.sum(l1)
    d_val = -torch.sum(loss.conj(-lam * theta, y))
    return beta, z, theta, p_val - d_val


def cm_sweep_wide_ref(XT: Tensor, y: Tensor, beta: Tensor, z: Tensor,
                      col_sq: Tensor, mask: Tensor, order: Tensor, lam,
                      n_epochs, count, pen: Tensor | None = None, *,
                      loss_name: str = "least_squares"):
    """``n_epochs`` sweeps over the first ``count`` slots of ``order`` on
    the transposed design ``XT`` (k, n) from (beta, z = X beta). Returns
    (beta (k,), z (n,))."""
    return cm_sweeps(get_loss(loss_name), XT.T, y, beta, z, mask, lam,
                     col_sq, order, count, n_epochs, pen)


def cm_burst_batch_ref(A: Tensor, Y: Tensor, beta: Tensor, col_sq: Tensor,
                       mask: Tensor, order: Tensor, lam, n_epochs, count, *,
                       loss_name: str = "least_squares"):
    """:func:`cm_burst_ref` per problem of a fleet: A (m, n, k), Y (m, n),
    beta/col_sq/mask/order (m, k), lam/n_epochs/count (m,). Each problem
    works on its own copies, as a serial burst would. Returns (beta (m, k),
    z (m, n), theta (m, n), gap (m,))."""
    outs = [cm_burst_ref(A[b].clone(), Y[b].clone(), beta[b].clone(),
                         col_sq[b].clone(), mask[b], order[b], float(lam[b]),
                         int(n_epochs[b]), int(count[b]),
                         loss_name=loss_name)
            for b in range(A.shape[0])]
    return tuple(torch.stack(t) for t in zip(*outs))


def cm_epochs_ref(A: Tensor, y: Tensor, beta: Tensor, col_sq: Tensor,
                  mask: Tensor, lam, n_epochs: int = 1):
    """Cyclic least-squares CM sweeps over every slot of the (n, k) block
    ``A``, in residual form, in float32 (the kernel's type): r = y - A beta
    once, then per step g = a_j . r, c = max(col_sq_j, 1e-30),
    beta_j <- S(beta_j + g / c, lam / c) (0 where ``mask`` is false) and
    r += (beta_j_old - beta_j) a_j. Every step stays on the tensors' device
    (no host read). Returns (beta (k,), r (n,)) in float32."""
    f32 = torch.float32
    A, y, col_sq = A.to(f32), y.to(f32), col_sq.to(f32)
    beta = beta.to(f32).clone()
    lam = torch.as_tensor(lam, dtype=f32, device=A.device)
    r = y - A @ beta
    live = mask.to(torch.bool)
    for _ in range(int(n_epochs)):
        for j in range(beta.shape[0]):
            aj = A[:, j]
            csq = torch.clamp(col_sq[j], min=1e-30)
            u = beta[j] + torch.dot(aj, r) / csq
            b_new = torch.sign(u) * torch.clamp(torch.abs(u) - lam / csq,
                                                min=0.0)
            b_new = torch.where(live[j], b_new, 0.0)
            r = r + (beta[j] - b_new) * aj
            beta[j] = b_new
    return beta, r
