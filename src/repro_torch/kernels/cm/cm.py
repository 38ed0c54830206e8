"""CM burst kernel K3: wrappers and shared-memory gate.

The CUDA source is ``csrc/cm_burst.cu``; the plain version is
``ref.py::cm_burst_ref``. A wrapper given CPU tensors returns the plain
version; given CUDA tensors it launches the kernel or raises.

K3 replaces ``repro/kernels/cm/cm.py:355 cm_burst_pallas``: without
``pen`` (every slot penalized) it launches the plain-LASSO entries and
counts in ``cm_burst_xt.launches``; with ``pen`` (fused LASSO's
unpenalized slot, the reference's ``has_unpen=True`` branch at
``cm.py:184-206``) it launches the ``_pen`` entries and counts in
``cm_burst_pen_xt.launches``. K3b (:func:`cm_burst_batch_xt`) replaces
``cm.py:296 cm_burst_batch_pallas``: K3 for a fleet, one CTA per problem,
counted in ``cm_burst_batch_xt.launches``. K5 (:func:`cm_epochs`, source
``csrc/cm_epochs.cu``) replaces ``cm.py:106 cm_epochs_pallas``, the
least-squares residual-form epochs that ``ops.cm_epochs`` exposes, counted
in ``cm_epochs.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.cm.ref import (cm_burst_batch_ref, cm_burst_ref,
                                        cm_epochs_ref)
from repro_torch.kernels.screen.screen import (_FLOATS, _ptr, _require,
                                               _stream)

Tensor = torch.Tensor

# Dynamic shared memory one CTA may take on Hopper is 227 KB; keep headroom.
CM_SMEM_BUDGET_BYTES = 200 * 1024
_NW = 8                      # warps of the kernel's one CTA (NT = 256)
_LOSS = {"least_squares": "ls", "logistic": "logit"}
_ENTRY = {("least_squares", torch.float32): "cm_burst_ls_f32",
          ("least_squares", torch.float64): "cm_burst_ls_f64",
          ("logistic", torch.float32): "cm_burst_logit_f32",
          ("logistic", torch.float64): "cm_burst_logit_f64"}


def cm_smem_bytes(n: int, k: int, itemsize: int, pen: bool = False) -> int:
    """Shared memory of one burst: y, z, the dual workspace (n each), beta
    and col_sq (k each), the reduction slots, order (int32) and mask, and
    with ``pen`` the (k,) weights. The unpenalized column is read from the
    block itself. Up to n = 2048 the kernel keeps a thread's rows of y and
    z in registers and leaves their regions unused, so one gate serves
    both of its forms."""
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


def cm_burst_batch_xt(AT: Tensor, Y: Tensor, beta: Tensor, col_sq: Tensor,
                      mask: Tensor, order: Tensor, lam, n_epochs, count, *,
                      loss_name: str = "least_squares"):
    """K3b: K3 for m problems at once, one CTA each, every slot penalized.

    AT (m, k, n) the transposed active blocks (dead rows zeroed), Y (m, n),
    beta/col_sq (m, k), mask (m, k) bool, order (m, k); lam, n_epochs and
    count (m,) per problem (tensors on the card, or sequences). Returns
    (beta (m, k), z (m, n), theta (m, n), gap (m,)): per problem bitwise
    what K3 returns. The shared-memory gate is K3's, for one problem.
    """
    if AT.device.type == "cpu":
        return cm_burst_batch_ref(AT.transpose(1, 2), Y, beta, col_sq, mask,
                                  order, lam, n_epochs, count,
                                  loss_name=loss_name)
    m, k, n = AT.shape
    dt, dev = AT.dtype, AT.device
    if dt not in _FLOATS or loss_name not in _LOSS:
        raise ValueError(f"cm_burst_batch: no kernel for loss {loss_name!r}"
                         f" in {dt}")
    if not cm_smem_ok(n, k, AT.element_size()):
        raise ValueError(f"cm_burst_batch: a {n}x{k} block ({dt}) exceeds "
                         f"the kernel's shared-memory budget")
    _require(AT, "AT", dt, (m, k, n), dev)
    _require(Y, "Y", dt, (m, n), dev)
    _require(col_sq, "col_sq", dt, (m, k), dev)
    _require(mask, "mask", torch.bool, (m, k), dev)
    order32 = order.to(torch.int32).contiguous()
    _require(order32, "order", torch.int32, (m, k), dev)
    beta_out = beta.to(dt).clone().contiguous()
    _require(beta_out, "beta", dt, (m, k), dev)
    lam = torch.as_tensor(lam, dtype=dt, device=dev).contiguous()
    nep = torch.as_tensor(n_epochs, dtype=torch.int32, device=dev
                          ).contiguous()
    cnt = torch.as_tensor(count, dtype=torch.int32, device=dev).contiguous()
    for t, what in ((lam, "lam"), (nep, "n_epochs"), (cnt, "count")):
        if tuple(t.shape) != (m,):
            raise ValueError(f"{what} has shape {tuple(t.shape)}, "
                             f"expected ({m},)")
    z = torch.empty((m, n), dtype=dt, device=dev)
    theta = torch.empty((m, n), dtype=dt, device=dev)
    gap = torch.empty(m, dtype=dt, device=dev)
    dts = "f64" if dt == torch.float64 else "f32"
    fn = getattr(_build.library("cm_burst"),
                 f"cm_burst_batch_{_LOSS[loss_name]}_{dts}")
    rc = fn(_ptr(AT), _ptr(Y), _ptr(beta_out), _ptr(col_sq), _ptr(mask),
            _ptr(order32), _ptr(lam), _ptr(nep), _ptr(cnt), m, n, k, _ptr(z),
            _ptr(theta), _ptr(gap), _stream())
    _build.check(rc, "cm_burst_batch")
    cm_burst_batch_xt.launches += 1
    return beta_out, z, theta, gap


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


def cm_epochs_smem_bytes(n: int, k: int) -> int:
    """Shared memory of K5 (float32): r (n), beta and max(col_sq, 1e-30)
    (k each), the reduction slots and the mask. Up to n = 2048 the kernel
    keeps a thread's rows of r in registers and leaves their region
    unused, so one gate serves both of its forms."""
    return (n + 2 * k + 2 * _NW) * 4 + k


def cm_epochs_smem_ok(n: int, k: int) -> bool:
    """Does an (n, k) K5 sweep fit one CTA's shared memory? Takes the place
    of the reference's ``n * k * 4 <= CM_VMEM_BUDGET_BYTES`` assert."""
    return cm_epochs_smem_bytes(n, k) <= CM_SMEM_BUDGET_BYTES


def cm_epochs(A: Tensor, y: Tensor, beta: Tensor, col_sq: Tensor,
              mask: Tensor, lam, *, n_epochs: int = 1):
    """K5: ``n_epochs`` cyclic least-squares sweeps over every slot of the
    (n, k) block ``A``, residual form, with ``cm_epochs_pallas``'s
    contract: the inputs are cast to float32, ``n_epochs`` is an int, and
    the result (beta (k,), r (n,)) is float32. A block past the
    shared-memory gate raises, as the reference asserts its VMEM budget."""
    n, k = A.shape
    if not cm_epochs_smem_ok(n, k):
        raise ValueError(f"cm_epochs: active block {n}x{k} exceeds the "
                         f"kernel's shared-memory budget; shrink k_max")
    n_epochs = int(n_epochs)
    if A.device.type == "cpu":
        return cm_epochs_ref(A, y, beta, col_sq, mask, lam, n_epochs)
    f32, dev = torch.float32, A.device
    AT = A.to(f32).T.contiguous()
    yf = y.to(f32).contiguous()
    cs = col_sq.to(f32).contiguous()
    m8 = mask.to(torch.bool).contiguous()
    beta_out = beta.to(f32).clone().contiguous()
    _require(yf, "y", f32, (n,), dev)
    _require(cs, "col_sq", f32, (k,), dev)
    _require(m8, "mask", torch.bool, (k,), dev)
    _require(beta_out, "beta", f32, (k,), dev)
    r = torch.empty(n, dtype=f32, device=dev)
    lib = _build.library("cm_epochs")
    rc = lib.cm_epochs_f32(_ptr(AT), _ptr(yf), _ptr(beta_out), _ptr(cs),
                           _ptr(m8), float(lam), n_epochs, n, k, _ptr(r),
                           _stream())
    _build.check(rc, "cm_epochs")
    cm_epochs.launches += 1
    return beta_out, r


cm_burst_xt.launches = 0
cm_burst_pen_xt.launches = 0
cm_burst_batch_xt.launches = 0
cm_epochs.launches = 0
