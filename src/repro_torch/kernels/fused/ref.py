"""Plain PyTorch version of the chain suffix-sum kernel K4.

S[:, v] = X[:, v] + S[:, v+1], S[:, p-1] = X[:, p-1]: the exact right fold
of the reference's ``chain_suffix_sums_ref`` and of the numpy
``transform_design`` on a chain, one IEEE add per column in that order, so
its result is bitwise theirs. One tensor op per column: the twin the kernel
is held against, not a fast path.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def chain_suffix_sums_ref(X: Tensor) -> Tensor:
    """Suffix sums of the columns of the (n, p) design ``X``."""
    p = X.shape[1]
    S = torch.empty_like(X)
    if p == 0:
        return S
    S[:, p - 1] = X[:, p - 1]
    for v in range(p - 2, -1, -1):
        torch.add(X[:, v], S[:, v + 1], out=S[:, v])
    return S
