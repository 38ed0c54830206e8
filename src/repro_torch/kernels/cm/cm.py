"""CM burst kernel K3: wrappers and shared-memory gate.

The CUDA source is ``csrc/cm_burst.cu``; the plain version is
``ref.py::cm_burst_ref``. A wrapper given CPU tensors returns the plain
version; given CUDA tensors it launches the kernel or raises.

K3 replaces ``repro/kernels/cm/cm.py:355 cm_burst_pallas``: without
``pen`` (every slot penalized) it launches the plain-LASSO entries and
counts in ``cm_burst_xt.launches``; with ``pen`` (fused LASSO's
unpenalized slot, the reference's ``has_unpen=True`` branch at
``cm.py:184-206``) it launches the ``_pen`` entries and counts in
``cm_burst_pen_xt.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.cm.ref import cm_burst_ref
from repro_torch.kernels.screen.screen import _ptr, _require, _stream

Tensor = torch.Tensor

# Dynamic shared memory one CTA may take on Hopper is 227 KB; keep headroom.
CM_SMEM_BUDGET_BYTES = 200 * 1024
_NW = 8                      # warps of the kernel's one CTA (NT = 256)
_ENTRY = {("least_squares", torch.float32): "cm_burst_ls_f32",
          ("least_squares", torch.float64): "cm_burst_ls_f64",
          ("logistic", torch.float32): "cm_burst_logit_f32",
          ("logistic", torch.float64): "cm_burst_logit_f64"}


def cm_smem_bytes(n: int, k: int, itemsize: int, pen: bool = False) -> int:
    """Shared memory of one burst: y, z, the dual workspace (n each), beta
    and col_sq (k each), the reduction slots, order (int32) and mask, and
    with ``pen`` the (k,) weights. The unpenalized column is read from the
    block itself."""
    return ((3 * n + (3 if pen else 2) * k + 4 * _NW) * itemsize + k * 5)


def cm_smem_ok(n: int, k: int, itemsize: int = 8, pen: bool = False) -> bool:
    """Does an (n, k) burst fit one CTA's shared memory? Replaces the
    reference's VMEM gate ``cm_vmem_ok``."""
    return cm_smem_bytes(n, k, itemsize, pen) <= CM_SMEM_BUDGET_BYTES


def _launch(AT, y, beta, col_sq, mask, order, pen, lam, n_epochs, count,
            loss_name):
    k, n = AT.shape
    dt = AT.dtype
    entry = _ENTRY.get((loss_name, dt))
    if entry is None:
        raise ValueError(f"cm_burst: no kernel for loss {loss_name!r} in "
                         f"{dt}")
    if not cm_smem_ok(n, k, AT.element_size(), pen is not None):
        raise ValueError(f"cm_burst: a {n}x{k} block ({dt}) exceeds the "
                         f"kernel's shared-memory budget")
    dev = AT.device
    _require(AT, "AT", dt, (k, n), dev)
    _require(y, "y", dt, (n,), dev)
    _require(col_sq, "col_sq", dt, (k,), dev)
    _require(mask, "mask", torch.bool, (k,), dev)
    order32 = order.to(torch.int32).contiguous()
    _require(order32, "order", torch.int32, (k,), dev)
    beta_out = beta.to(dt).clone().contiguous()
    _require(beta_out, "beta", dt, (k,), dev)
    z = torch.empty(n, dtype=dt, device=dev)
    theta = torch.empty(n, dtype=dt, device=dev)
    gap = torch.empty(1, dtype=dt, device=dev)
    lib = _build.library("cm_burst")
    args = [_ptr(AT), _ptr(y), _ptr(beta_out), _ptr(col_sq), _ptr(mask),
            _ptr(order32)]
    if pen is not None:
        pen = pen.to(dt).contiguous()
        _require(pen, "pen", dt, (k,), dev)
        args.append(_ptr(pen))
        entry += "_pen"
    rc = getattr(lib, entry)(*args, float(lam), int(n_epochs), int(count),
                             n, k, _ptr(z), _ptr(theta), _ptr(gap),
                             _stream())
    _build.check(rc, "cm_burst")
    return beta_out, z, theta, gap[0]


def cm_burst_xt(AT: Tensor, y: Tensor, beta: Tensor, col_sq: Tensor,
                mask: Tensor, order: Tensor, lam, n_epochs, count, *,
                loss_name: str = "least_squares"):
    """K3 on the transposed active block ``AT`` (k, n), dead rows zeroed,
    every slot penalized.

    beta/col_sq (k,), mask (k,) bool, order (k,) the slot permutation with
    the ``count`` live slots first. Returns (beta, z, theta, gap) — the
    updated coefficients, z = A beta, the feasible dual point and the
    sub-problem duality gap (a 0-d tensor).
    """
    if AT.device.type == "cpu":
        return cm_burst_ref(AT.T, y, beta, col_sq, mask, order, lam,
                            n_epochs, count, loss_name=loss_name)
    out = _launch(AT, y, beta, col_sq, mask, order, None, lam, n_epochs,
                  count, loss_name)
    cm_burst_xt.launches += 1
    return out


def cm_burst_pen_xt(AT: Tensor, y: Tensor, beta: Tensor, col_sq: Tensor,
                    mask: Tensor, order: Tensor, pen: Tensor, lam, n_epochs,
                    count, *, loss_name: str = "least_squares"):
    """K3 with per-slot l1 weights ``pen`` (k,): 0 on at most one live slot,
    the unpenalized one, 1 elsewhere. The kernel takes the first live slot
    with weight 0 as the unpenalized column; the other arguments and the
    result are those of :func:`cm_burst_xt`, the result's beta carrying the
    Newton-polished b for a general loss."""
    if AT.device.type == "cpu":
        return cm_burst_ref(AT.T, y, beta, col_sq, mask, order, lam,
                            n_epochs, count, pen, loss_name=loss_name)
    out = _launch(AT, y, beta, col_sq, mask, order, pen, lam, n_epochs,
                  count, loss_name)
    cm_burst_pen_xt.launches += 1
    return out


def cm_burst(A: Tensor, y: Tensor, beta: Tensor, col_sq: Tensor,
             mask: Tensor, order: Tensor, lam, n_epochs, count, pen=None, *,
             loss_name: str = "least_squares"):
    """One fused "CM burst + gap" on the (n, k) active block ``A``, with
    ``cm_burst_pallas``'s signature; dead columns must be zero."""
    if A.device.type == "cpu":
        return cm_burst_ref(A, y, beta, col_sq, mask, order, lam, n_epochs,
                            count, pen, loss_name=loss_name)
    AT = A.T.contiguous()
    if pen is None:
        return cm_burst_xt(AT, y, beta, col_sq, mask, order, lam, n_epochs,
                           count, loss_name=loss_name)
    return cm_burst_pen_xt(AT, y, beta, col_sq, mask, order, pen, lam,
                           n_epochs, count, loss_name=loss_name)


cm_burst_xt.launches = 0
cm_burst_pen_xt.launches = 0
