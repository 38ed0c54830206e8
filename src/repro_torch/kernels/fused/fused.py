"""Chain suffix-sum kernel K4: wrapper.

The CUDA source is ``csrc/chain_suffix.cu``; the plain version is
``ref.py::chain_suffix_sums_ref``. Given a CPU tensor the wrapper returns
the plain version; given a CUDA tensor it launches the kernel or raises.
Launches are counted in ``chain_suffix_sums.launches``.

K4 replaces ``repro/kernels/fused/fused.py:76 chain_suffix_sums_pallas``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused.ref import chain_suffix_sums_ref
from repro_torch.kernels.screen.screen import _ptr, _require, _stream

Tensor = torch.Tensor
_ENTRY = {torch.float32: "chain_suffix_sums_f32",
          torch.float64: "chain_suffix_sums_f64"}


def chain_suffix_sums(X: Tensor) -> Tensor:
    """S[:, v] = sum_{u >= v} X[:, u] of the (n, p) design, by the exact
    right fold (bitwise the plain version)."""
    if X.device.type == "cpu":
        return chain_suffix_sums_ref(X)
    entry = _ENTRY.get(X.dtype)
    if entry is None:
        raise ValueError(f"chain_suffix_sums: X has dtype {X.dtype}; the "
                         f"kernel takes float32/64")
    n, p = X.shape
    _require(X, "X", X.dtype, (n, p), X.device)
    S = torch.empty_like(X)
    rc = getattr(_build.library("chain_suffix"), entry)(
        _ptr(X), _ptr(S), n, p, _stream())
    _build.check(rc, "chain_suffix_sums")
    chain_suffix_sums.launches += 1
    return S


def add_latency_cycles(dtype, n_adds: int = 1 << 20) -> float:
    """Clock cycles per dependent add of ``dtype`` on the card, from one
    thread's chain of ``n_adds`` adds between two clock64() reads (a
    measuring aid; on no path and counted nowhere)."""
    dev = torch.device("cuda")
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    buf = torch.tensor([1e-8, 1.0], dtype=dtype, device=dev)
    entry = "add_latency_f64" if dtype == torch.float64 else "add_latency_f32"
    rc = getattr(_build.library("chain_suffix"), entry)(
        ctypes.c_int(n_adds), _ptr(cycles), _ptr(buf), _stream())
    _build.check(rc, "add_latency")
    return float(cycles) / n_adds


chain_suffix_sums.launches = 0
