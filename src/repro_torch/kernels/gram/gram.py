"""Gram-sweep kernels K6 (one problem) and K6b (a fleet): wrappers and the
shared-memory gate.

The CUDA source is ``csrc/gram_sweep.cu``; the plain versions are in
``ref.py``. A wrapper given CPU tensors returns the plain version; given
CUDA tensors it launches the kernel or raises. K6 and K6b replace the
device loop of ``repro/core/cm.py:126 gram_epochs`` (an XLA ``fori_loop``);
K6 is K6b's one-problem launch, so a fleet sweep is bitwise a serial one.
They count their launches in ``gram_sweep.launches`` and
``gram_sweep_batch.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gram.ref import gram_sweep_batch_ref, gram_sweep_ref
from repro_torch.kernels.screen.screen import (_FLOATS, _ptr, _require,
                                               _stream)

Tensor = torch.Tensor

# Dynamic shared memory one CTA may take on Hopper is 227 KB; keep headroom
GRAM_SMEM_BUDGET_BYTES = 200 * 1024
SMEM_MAX_BYTES = 232_448     # the card's limit, which the ring may fill
_RING = 16                   # rows of G in the kernel's ring
_WARP_K = 1024               # capacity up to which one warp sweeps


def gram_smem_bytes(k: int, itemsize: int) -> int:
    """Shared memory of one sweep's state, the gate's measure: qr, beta,
    inv_l and thr (k each), the two update slots, order (int32) and
    mask."""
    return (4 * k + 2) * itemsize + 5 * k


def gram_sweep_form(k: int, itemsize: int):
    """How the kernel sweeps a capacity-``k`` block: (threads of the sweep,
    rows of G in its ring, shared memory in bytes). Up to k = 1024, when a
    row is a whole number of 16-byte words, one warp sweeps with a ring of
    G rows (filled by bulk copies, two barriers a row) 16-byte aligned
    after the state; else 256 threads read G from L2."""
    ring_off = -(-gram_smem_bytes(k, itemsize) // 16) * 16
    ring_bytes = _RING * (k * itemsize + 16)
    if (k <= _WARP_K and (k * itemsize) % 16 == 0
            and ring_off + ring_bytes <= SMEM_MAX_BYTES):
        return 32, _RING, ring_off + ring_bytes
    return 256, 0, gram_smem_bytes(k, itemsize)


def gram_smem_ok(k: int, itemsize: int = 8) -> bool:
    """Does a capacity-``k`` sweep fit one CTA's shared memory (k up to
    5,534 in f64, 9,752 in f32)?"""
    return gram_smem_bytes(k, itemsize) <= GRAM_SMEM_BUDGET_BYTES


def _launch(G, rho, beta, mask, order, pen, lam, n_epochs, count, smoothness,
            batched: bool):
    m, k = beta.shape
    dt, dev = G.dtype, G.device
    if dt not in _FLOATS:
        raise ValueError(f"gram_sweep: no kernel for {dt}")
    if not gram_smem_ok(k, G.element_size()):
        raise ValueError(f"gram_sweep: capacity {k} ({dt}) exceeds the "
                         f"kernel's shared-memory budget")
    _require(G, "G", dt, (m, k, k), dev)
    _require(rho, "rho", dt, (m, k), dev)
    _require(mask, "mask", torch.bool, (m, k), dev)
    order32 = order.to(torch.int32).contiguous()
    _require(order32, "order", torch.int32, (m, k), dev)
    beta_out = beta.to(dt).clone().contiguous()
    _require(beta_out, "beta", dt, (m, k), dev)
    lam = torch.as_tensor(lam, dtype=dt, device=dev).reshape(m).contiguous()
    if pen is not None:
        pen = pen.to(dt).contiguous()
        _require(pen, "pen", dt, (m, k), dev)
    nep = cnt = None
    if batched:
        nep = torch.as_tensor(n_epochs, dtype=torch.int32, device=dev
                              ).contiguous()
        cnt = torch.as_tensor(count, dtype=torch.int32, device=dev
                              ).contiguous()
        for t, what in ((nep, "n_epochs"), (cnt, "count")):
            if tuple(t.shape) != (m,):
                raise ValueError(f"{what} has shape {tuple(t.shape)}, "
                                 f"expected ({m},)")
        n_epochs = count = 0
    fn = getattr(_build.library("gram_sweep"),
                 f"gram_sweep_{'f64' if dt == torch.float64 else 'f32'}")
    rc = fn(_ptr(G), _ptr(rho), _ptr(beta_out), _ptr(mask), _ptr(order32),
            None if pen is None else _ptr(pen), _ptr(lam), int(n_epochs),
            int(count), None if nep is None else _ptr(nep),
            None if cnt is None else _ptr(cnt), float(smoothness), m, k,
            _stream())
    _build.check(rc, "gram_sweep")
    return beta_out


def gram_sweep(G: Tensor, rho: Tensor, beta: Tensor, mask: Tensor, lam,
               order: Tensor, count, n_epochs, smoothness: float = 1.0,
               pen: Tensor | None = None) -> Tensor:
    """K6: ``n_epochs`` covariance-update sweeps over the ``count`` live
    slots listed first in ``order``, on G (k, k) and rho (k,) (see
    :func:`~repro_torch.kernels.gram.ref.gram_sweep_ref`). ``lam`` may be
    a 0-d tensor on the card (no host read to launch). Returns beta."""
    if G.device.type == "cpu":
        return gram_sweep_ref(G, rho, beta, mask, lam, order, count,
                              n_epochs, smoothness, pen)
    out = _launch(G[None], rho[None], beta[None], mask[None], order[None],
                  None if pen is None else pen[None], lam, n_epochs, count,
                  smoothness, batched=False)
    gram_sweep.launches += 1
    return out[0]


def gram_sweep_batch(G: Tensor, rho: Tensor, beta: Tensor, mask: Tensor, lam,
                     order: Tensor, count, n_epochs, smoothness: float = 1.0,
                     pen: Tensor | None = None) -> Tensor:
    """K6b: K6 for m problems, one CTA each. G (m, k, k), rho/beta/mask/
    order (and ``pen``) (m, k); lam, count and n_epochs (m,) per problem
    (tensors on the card, or sequences). Returns beta (m, k), per problem
    bitwise what K6 returns."""
    if G.device.type == "cpu":
        return gram_sweep_batch_ref(G, rho, beta, mask, lam, order, count,
                                    n_epochs, smoothness, pen)
    out = _launch(G, rho, beta, mask, order, pen, lam, n_epochs, count,
                  smoothness, batched=True)
    gram_sweep_batch.launches += 1
    return out


gram_sweep.launches = 0
gram_sweep_batch.launches = 0
