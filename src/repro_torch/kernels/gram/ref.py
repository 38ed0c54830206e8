"""Plain PyTorch version of the Gram-sweep kernel K6 (and K6b, its fleet
form): the covariance-update CM sweeps of least squares.

It is the port's plain covariance-update loop, unchanged from before K6
existed, so CPU results stay what they were. On a card each
step reads one scalar to the host, which is why the card runs K6.
"""
from __future__ import annotations

import torch

from repro_torch.core.cm import _soft_threshold_f

Tensor = torch.Tensor


def gram_sweep_ref(G: Tensor, rho: Tensor, beta: Tensor, mask: Tensor, lam,
                   order: Tensor, count, n_epochs, smoothness: float = 1.0,
                   pen: Tensor | None = None) -> Tensor:
    """Covariance-update CM sweeps (least squares): every step reads
    qr_j = (G beta - rho)_j and updates qr by one Gram-column axpy.
    ``G`` must hold x_s^T x_t for every pair of live slots; ``pen`` is the
    optional per-slot l1 weight (0 = unpenalized). Returns the updated beta
    (the caller rebuilds z once per burst)."""
    inv_l = 1.0 / torch.clamp(smoothness * torch.diagonal(G), min=1e-30)
    thr = (lam * inv_l if pen is None else lam * pen * inv_l).tolist()
    inv_l = inv_l.tolist()
    qr = G @ beta - rho
    sched = order[:int(count)].tolist()
    live = mask.tolist()
    b = beta.tolist()
    for _ in range(int(n_epochs)):
        for j in sched:
            bj = b[j]
            b_new = (_soft_threshold_f(bj - float(qr[j]) * inv_l[j], thr[j])
                     if live[j] else 0.0)
            if b_new != bj:
                qr.add_(G[:, j], alpha=b_new - bj)
            b[j] = b_new
    return torch.tensor(b, dtype=beta.dtype, device=beta.device)


def gram_sweep_batch_ref(G: Tensor, rho: Tensor, beta: Tensor, mask: Tensor,
                         lam, order: Tensor, count, n_epochs,
                         smoothness: float = 1.0,
                         pen: Tensor | None = None) -> Tensor:
    """:func:`gram_sweep_ref` per problem: G (m, k, k), rho/beta/mask/order
    (and ``pen``) (m, k), lam/count/n_epochs (m,). Returns beta (m, k).
    Each problem's G, rho and beta are copied out first: a CPU matvec's
    summation order follows its operand's memory alignment, and a fresh
    tensor is aligned as the serial sweep's own carry is, so each row is
    bit for bit the serial sweep whatever its index in the stack."""
    return torch.stack([gram_sweep_ref(
        G[b].clone(), rho[b].clone(), beta[b].clone(), mask[b], lam[b],
        order[b], int(count[b]), int(n_epochs[b]), smoothness,
        None if pen is None else pen[b])
        for b in range(G.shape[0])])
