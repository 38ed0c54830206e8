"""Screening kernels K1 (fused scan) and K2 (violation histogram): wrappers.

The CUDA sources are ``csrc/screen.cu``; the plain versions are in
``ref.py``. A wrapper given CPU tensors returns the plain version; given
CUDA tensors it launches the kernel or raises. Each wrapper counts its
launches in its ``launches`` attribute.

K1 replaces ``repro/kernels/screen/screen.py:271 screen_fused_pallas``
(and, unmasked, ``:124 screen_scores_pallas``); K2 replaces
``:512 ub_histogram_pallas``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.screen.ref import (BP, screen_fused_ref,
                                            screen_scores_ref,
                                            ub_histogram_ref)

Tensor = torch.Tensor
_FLOATS = (torch.float32, torch.float64)
# K2 keeps lb_sorted and the (h+1) bins in shared memory
HIST_SMEM_BUDGET = 200 * 1024


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _ptr(t: Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _require(t: Tensor, what: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{what} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _scan(X, theta, col_norm, active, r, h_tile, masked):
    n, p = X.shape
    dt = X.dtype
    if dt not in _FLOATS:
        raise ValueError(f"X has dtype {dt}; the kernel takes float32/64")
    _require(X, "X", dt, (n, p), X.device)
    _require(theta, "theta", dt, (n,), X.device)
    _require(col_norm, "col_norm", dt, (p,), X.device)
    if active is not None:
        _require(active, "active", torch.bool, (p,), X.device)
    p_blocks = -(-p // BP)
    score = torch.empty(p, dtype=dt, device=X.device)
    ub = torch.empty_like(score)
    lb = torch.empty_like(score)
    tops = torch.empty((p_blocks, h_tile), dtype=dt, device=X.device)
    topi = torch.empty((p_blocks, h_tile), dtype=torch.int32, device=X.device)
    tmax = torch.empty(p_blocks, dtype=dt, device=X.device)
    lib = _build.library("screen")
    fn = lib.screen_fused_f64 if dt == torch.float64 else lib.screen_fused_f32
    rc = fn(_ptr(X), _ptr(theta), _ptr(col_norm),
            _ptr(active) if active is not None else None, float(r),
            n, p, h_tile, int(masked), _ptr(score), _ptr(ub), _ptr(lb),
            _ptr(tops), _ptr(topi), _ptr(tmax), _stream())
    _build.check(rc, "screen_fused")
    screen_fused.launches += 1
    return score, ub, lb, tops, topi, tmax


def screen_fused(X: Tensor, theta: Tensor, col_norm: Tensor, active: Tensor,
                 r, *, h: int):
    """Fused ADD-phase scan (K1).

    Args: X (n, p) row-major, theta (n,), col_norm (p,), active (p,) bool
    (the features to exclude), r the ball radius, h the candidate count.
    Returns score, ub, lb (p,) masked as in the reference; per tile of
    ``BP`` columns its top ``min(h, BP)`` scores and global ids (int32),
    ties to the lowest lane; and per tile the max ub.
    """
    if X.device.type == "cpu":
        return screen_fused_ref(X, theta, col_norm, active, r, h=h)
    return _scan(X, theta, col_norm, active, r, max(1, min(h, BP)), True)


def screen_scores(X: Tensor, theta: Tensor, col_norm: Tensor, r):
    """Unmasked scan: (score, ub, lb) per feature — K1 without the mask
    and the top-h (its launches count in ``screen_fused.launches``)."""
    if X.device.type == "cpu":
        return screen_scores_ref(X, theta, col_norm, r)
    return _scan(X, theta, col_norm, None, r, 1, False)[:3]


def ub_histogram(ub: Tensor, lb_sorted: Tensor) -> Tensor:
    """K2: hist[m] = #{i : #{l : lb_sorted[l] <= ub_i} = m}, (h+1,) int32."""
    if ub.device.type == "cpu":
        return ub_histogram_ref(ub, lb_sorted)
    (p,) = ub.shape
    h = lb_sorted.shape[0]
    dt = ub.dtype
    if dt not in _FLOATS:
        raise ValueError(f"ub has dtype {dt}; the kernel takes float32/64")
    _require(ub, "ub", dt, (p,), ub.device)
    _require(lb_sorted, "lb_sorted", dt, (h,), ub.device)
    if h * ub.element_size() + (h + 1) * 4 > HIST_SMEM_BUDGET:
        raise ValueError(f"ub_histogram: h={h} candidates exceed the "
                         f"kernel's shared-memory budget")
    hist = torch.zeros(h + 1, dtype=torch.int32, device=ub.device)
    lib = _build.library("screen")
    fn = lib.ub_histogram_f64 if dt == torch.float64 else lib.ub_histogram_f32
    rc = fn(_ptr(ub), _ptr(lb_sorted), p, h, _ptr(hist), _stream())
    _build.check(rc, "ub_histogram")
    ub_histogram.launches += 1
    return hist


screen_fused.launches = 0
ub_histogram.launches = 0
