"""State carried across from the reference package, as numpy arrays.

``repro``'s ``PathState`` and a solve's final slots, read out with
``np.asarray`` on each field, become the port's ``PathState`` and the
``(warm_idx, warm_beta)`` pair that :func:`~repro_torch.core.saif.solve_scalar`
takes. Nothing here imports the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.saif import PathState, as_tensor, resolve_device


def path_state_from_numpy(X, y, c0, col_norm, lam_max, c0_max, c0_median,
                          b0=0.0, n_true=0, p_true=0,
                          device=None) -> PathState:
    """A port :class:`PathState` from the fields of the reference's, on
    ``device`` (None = the card). The dtype follows ``X``."""
    dev = resolve_device(device)
    X = as_tensor(np.asarray(X), dev)
    return PathState(X=X, y=as_tensor(np.asarray(y), dev, X.dtype),
                     c0=as_tensor(np.asarray(c0), dev, X.dtype),
                     col_norm=as_tensor(np.asarray(col_norm), dev, X.dtype),
                     lam_max=float(lam_max), c0_max=float(c0_max),
                     c0_median=float(c0_median), b0=float(b0),
                     n_true=int(n_true), p_true=int(p_true))


def warm_start_from_numpy(active_idx, active_mask, beta):
    """(warm_idx, warm_beta) from a solve's final slot map ``active_idx``
    (k_max,), its validity ``active_mask`` and the full solution ``beta``
    (p,): the live slots' feature ids, in slot order, and their
    coefficients (CPU tensors; ``solve_scalar`` moves them)."""
    idx = np.asarray(active_idx)[np.asarray(active_mask, bool)]
    vals = np.asarray(beta)[idx]
    return torch.from_numpy(idx.astype(np.int64)), torch.from_numpy(vals)
