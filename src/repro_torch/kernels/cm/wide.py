"""Wide-design CM sweep kernel K7: wrapper and shared-memory gate.

The CUDA source is ``csrc/cm_wide.cu``; the plain version is
``ref.py::cm_sweep_wide_ref``. A wrapper given CPU tensors returns the
plain version; given CUDA tensors it launches the kernel or raises.

K7 replaces ``repro/core/cm.py:66 cm_epoch``, the XLA loop that the
baselines (dynamic screening, the sequential path, the homotopy path and
the unscreened CM) sweep with: K3's sweep (``kernels/cm/cm.py``) without
K3's tail, on a design of any width, counted in ``cm_sweep_wide.launches``.
Only the rows of z and y share one CTA's shared memory (past n = 2048),
so the gate is on n alone (a launch is a cluster of two CTAs: the sweep
and, on another SM, the warp that prefetches its columns into L2). The
kernel packs one record a position of the order into a scratch buffer the
wrapper allocates (``REC_WORDS`` words a record): the order must list
distinct slots, as ``core/cm.py::sweep_order`` does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.cm.cm import _LOSS, _NW, CM_SMEM_BUDGET_BYTES
from repro_torch.kernels.cm.ref import cm_sweep_wide_ref
from repro_torch.kernels.screen.screen import (_FLOATS, _ptr, _require,
                                               _stream)

Tensor = torch.Tensor


def cm_wide_smem_bytes(n: int, itemsize: int) -> int:
    """Shared memory of K7: the reduction slots and, past n = 2048, y and
    z (n each). Counted for every n, so one gate serves both forms."""
    return (2 * n + 2 * _NW) * itemsize


# words of the sweep's type in one record of K7's scratch (csrc/cm_wide.cu,
# Rec): L_j, the threshold, the slot (an int32 in a word) and beta; one
# record a position of the order, 32 bytes in float64, 16 in float32
REC_WORDS = 4


def cm_wide_smem_ok(n: int, itemsize: int = 8) -> bool:
    """Do a sweep's rows fit one CTA's shared memory? (n <= 12,792 in
    float64, 25,592 in float32.)"""
    return cm_wide_smem_bytes(n, itemsize) <= CM_SMEM_BUDGET_BYTES


def cm_sweep_wide(XT: Tensor, y: Tensor, beta: Tensor, z: Tensor,
                  col_sq: Tensor, mask: Tensor, order: Tensor, lam,
                  n_epochs: int, count: int, pen: Tensor | None = None, *,
                  loss_name: str = "least_squares"):
    """K7: ``n_epochs`` cyclic sweeps over the first ``count`` slots of
    ``order`` on the transposed design ``XT`` (k, n), from ``beta`` (k,)
    and the model vector ``z`` = X beta (n,), with the squared column
    norms ``col_sq`` (k,), the validity ``mask`` (k,) bool (a masked slot
    steps to 0) and optional per-slot l1 weights ``pen`` (k,), 0 on an
    unpenalized slot. ``order[:count]`` lists distinct slots (the kernel
    carries beta by position; checked on CPU tensors, where it is free).
    Returns the updated (beta, z); the inputs are left as they were."""
    if XT.device.type == "cpu":
        if torch.unique(order[:int(count)]).numel() != int(count):
            raise ValueError("cm_sweep_wide: order[:count] repeats a slot")
        return cm_sweep_wide_ref(XT, y, beta, z, col_sq, mask, order, lam,
                                 n_epochs, count, pen, loss_name=loss_name)
    k, n = XT.shape
    dt, dev = XT.dtype, XT.device
    if dt not in _FLOATS or loss_name not in _LOSS:
        raise ValueError(f"cm_sweep_wide: no kernel for loss {loss_name!r} "
                         f"in {dt}")
    if not cm_wide_smem_ok(n, XT.element_size()):
        raise ValueError(f"cm_sweep_wide: n = {n} rows ({dt}) exceed the "
                         f"kernel's shared-memory budget")
    count, n_epochs = int(count), int(n_epochs)
    if not 0 <= count <= order.shape[0] or n_epochs < 0:
        raise ValueError(f"cm_sweep_wide: count {count} of {order.shape[0]}"
                         f" slots, n_epochs {n_epochs}")
    _require(XT, "XT", dt, (k, n), dev)
    _require(y, "y", dt, (n,), dev)
    _require(col_sq, "col_sq", dt, (k,), dev)
    _require(mask, "mask", torch.bool, (k,), dev)
    order32 = order.to(torch.int32).contiguous()
    _require(order32, "order", torch.int32, (order.shape[0],), dev)
    beta_out = beta.to(dt).clone().contiguous()
    _require(beta_out, "beta", dt, (k,), dev)
    z_out = z.to(dt).clone().contiguous()
    _require(z_out, "z", dt, (n,), dev)
    if pen is not None:
        pen = pen.to(dt).contiguous()
        _require(pen, "pen", dt, (k,), dev)
    rec = torch.empty((max(count, 1), REC_WORDS), dtype=dt, device=dev)
    dts = "f64" if dt == torch.float64 else "f32"
    fn = getattr(_build.library("cm_wide"),
                 f"cm_sweep_wide_{_LOSS[loss_name]}_{dts}")
    rc = fn(_ptr(XT), _ptr(y), _ptr(beta_out), _ptr(z_out), _ptr(col_sq),
            _ptr(mask), None if pen is None else _ptr(pen), _ptr(order32),
            _ptr(rec), float(lam), n_epochs, count, n, k, _stream())
    _build.check(rc, "cm_sweep_wide")
    cm_sweep_wide.launches += 1
    return beta_out, z_out


cm_sweep_wide.launches = 0
