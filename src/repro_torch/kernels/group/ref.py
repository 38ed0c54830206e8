"""Plain PyTorch version of the group block-CD kernel B-n3.

The reference package has no plain twin of its group burst (it is an XLA
loop, ``repro/core/group.py:165-172``); this one repeats its arithmetic on
the live slots only: z = sum_j X_j beta_j, then ``n_epochs`` cyclic sweeps
of the group soft-threshold step over the live slots in slot order. A
masked slot's beta is zeroed when any epoch runs, as the reference's step
writes 0 there; its (zero) block moves nothing else.
"""
from __future__ import annotations

import torch

from repro_torch.core.losses import get_loss

Tensor = torch.Tensor


def group_soft_threshold(v: Tensor, t) -> Tensor:
    """S_t(v) = v max(0, 1 - t / max(||v||, 1e-30)); ``t`` a float or a
    0-d tensor (divided, not multiplied by a reciprocal)."""
    nrm = torch.linalg.vector_norm(v)
    return v * torch.clamp(1.0 - t / torch.clamp(nrm, min=1e-30), min=0.0)


def group_blocks(X: Tensor, groups: Tensor, gsize: int) -> Tensor:
    """The blocks of ``groups`` gathered from the row-major design ``X``
    (n, p) as (len(groups), gsize, n), each column a contiguous row."""
    n = X.shape[0]
    return X.view(n, -1, gsize).index_select(1, groups).permute(
        1, 2, 0).contiguous()


def group_bcd_ref(A: Tensor, y: Tensor, slot: Tensor, beta: Tensor,
                  L: Tensor, lam, n_epochs: int, *,
                  loss_name: str = "least_squares"):
    """``n_epochs`` block-CD sweeps over the live slots of a group active
    set: ``A`` (live, gsize, n) their blocks (:func:`group_blocks`),
    ``slot`` (live,) their slot ids in ascending order, ``beta`` (k, gsize)
    and ``L`` (k,) every slot's coefficients and block Lipschitz constant.
    Returns (beta (k, gsize), z (n,) = sum_j X_j beta_j over the live
    slots); the inputs are left as they were."""
    loss = get_loss(loss_name)
    n_epochs = int(n_epochs)
    out = beta.clone()
    if n_epochs > 0:                  # a masked slot's step writes 0
        out.zero_()
    out[slot] = beta[slot]
    bs = list(out[slot].unbind(0))
    Ls = L.to(A.dtype)[slot]
    # lam / L_j and L_j as host floats: exact in either type, and one
    # host read for the whole burst
    t = (torch.full_like(Ls, lam) / Ls).tolist()
    Lf = Ls.tolist()
    z = torch.zeros(A.shape[2], dtype=A.dtype, device=A.device)
    for s, b in enumerate(bs):
        z = torch.addmv(z, A[s].T, b)
    for _ in range(n_epochs):
        for s in range(len(bs)):
            grad = torch.mv(A[s], loss.grad(z, y))
            b = group_soft_threshold(bs[s] - grad / Lf[s], t[s])
            z = torch.addmv(z, A[s].T, b - bs[s])
            bs[s] = b
    if bs:
        out[slot] = torch.stack(bs)
    return out, z
