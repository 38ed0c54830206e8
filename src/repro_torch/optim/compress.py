"""Int8 error-feedback gradient compression for the data-parallel
all-reduce (port of ``repro.optim.compress``).

The EF-SGD scheme: quantize (g + e) to int8 with a per-tensor scale,
all-reduce the int8 payload, keep the quantization residual e locally. The
running sum of applied compressed gradients equals the running sum of
true gradients minus the current residual, which makes the scheme
convergent.

Rounding is the reference's: ``torch.round`` rounds half to even, as
``jnp.round`` does, and the scale is ``max(amax / 127, 1e-30)``. Trees are
nested dicts of tensors (``repro_torch.tree.tree_map``). The trainer does not call
this module: compression is a library function here, as in the reference.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch
from torch import Tensor

from repro_torch.tree import tree_map


class EFState(NamedTuple):
    residual: Any   # params-shaped tree of float32


def init(params) -> EFState:
    return EFState(residual=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def quantize(x: Tensor) -> Tuple[Tensor, Tensor]:
    """Symmetric per-tensor int8 quantization. Returns (q, scale)."""
    amax = torch.max(torch.abs(x))
    scale = torch.clamp(amax / 127.0, min=1e-30)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: Tensor, scale: Tensor) -> Tensor:
    """q x scale in float32, or in the scale's dtype where that is wider
    (the reference's promotion of an int8 array cast to float32)."""
    return q.to(torch.promote_types(torch.float32, scale.dtype)) * scale


def _is_pair(t) -> bool:
    return isinstance(t, tuple) and len(t) == 2


def compress_tree(grads, ef: EFState):
    """Per leaf: c = Q(g + e); new e = (g + e) - deq(c). Returns
    (quantized tree of (q, scale) pairs, new EFState)."""
    def one(g, e):
        t = g.to(torch.float32) + e
        q, s = quantize(t)
        return (q, s), t - dequantize(q, s)

    pairs = tree_map(one, grads, ef.residual)
    return (tree_map(lambda t: t[0], pairs),
            EFState(residual=tree_map(lambda t: t[1], pairs)))


def decompress_tree(qtree):
    return tree_map(lambda qs: dequantize(*qs), qtree)


def dp_allreduce_compressed(grads, ef: EFState, group):
    """The mean over the ranks of ``group`` (a
    :class:`~repro_torch.distributed.comm.FeatureGroup`) of the
    int8-compressed gradients: an int32 SUM all-reduce of each leaf's q, a
    MAX all-reduce of its scale, then acc x max scale / W. Returns (mean
    tree, new EFState)."""
    from repro_torch.distributed import comm

    def one(g, e):
        t = g.to(torch.float32) + e
        q, s = quantize(t)
        new_e = t - dequantize(q, s)
        acc = comm.all_reduce_sum(group, q.to(torch.int32))
        s_max = comm.all_reduce_max(group, s)
        g_hat = acc.to(torch.float32) * s_max / float(group.size)
        return g_hat, new_e

    pairs = tree_map(one, grads, ef.residual)
    return (tree_map(lambda t: t[0], pairs),
            EFState(residual=tree_map(lambda t: t[1], pairs)))
