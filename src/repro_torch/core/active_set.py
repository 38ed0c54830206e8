"""Fixed-capacity active-set state (port of ``repro.core.active_set``).

The active set is a capacity-``k_max`` buffer of feature indices plus a
validity mask, with the compact sweep order (``order``: live slots first,
in insertion-stable order) maintained incrementally by ADD/DEL. Slot
arithmetic is integer-exact, so the port's slots equal the reference's.

Index tensors are int64 (torch's native index type); the reference keeps
them int32. Out-of-range scatters, which the reference drops with
``mode="drop"``, are filtered out before they are written here.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor


class ActiveSet(NamedTuple):
    idx: Tensor         # int64 (k_max,) feature ids; padding slots hold 0
    mask: Tensor        # bool  (k_max,) slot validity
    beta: Tensor        # float (k_max,) coefficients (0 on padding)
    in_active: Tensor   # bool  (p,)     global membership mask
    overflowed: bool    # an ADD ran out of slots
    order: Tensor       # int64 (k_max,) slot permutation, live slots first
    count: int          # number of live slots (= sum(mask))


def compact_order(order: Tensor, mask: Tensor) -> Tensor:
    """Stable partition of ``order`` by slot liveness — live slots first."""
    live = mask[order]
    live_i = live.long()
    dead_i = 1 - live_i
    n_live = live_i.sum()
    rank_live = torch.cumsum(live_i, 0) - live_i
    rank_dead = torch.cumsum(dead_i, 0) - dead_i
    pos = torch.where(live, rank_live, n_live + rank_dead)
    return torch.zeros_like(order).index_put_((pos,), order)


def init_active_set(p: int, k_max: int, init_idx: Tensor, dtype,
                    init_beta: Tensor | None = None,
                    live_mask: Tensor | None = None) -> ActiveSet:
    """Seed the buffer with ``init_idx``: either (m,) ids in the first m
    slots (``live_mask`` None) or (k_max,) slot buffers whose live slots
    ``live_mask`` flags in place."""
    dev = init_idx.device
    if live_mask is None:
        m = init_idx.shape[0]
        idx = torch.zeros(k_max, dtype=torch.long, device=dev)
        idx[:m] = init_idx
        mask = torch.zeros(k_max, dtype=torch.bool, device=dev)
        mask[:m] = True
        beta = torch.zeros(k_max, dtype=dtype, device=dev)
        if init_beta is not None:
            beta[:m] = init_beta.to(dtype)
        in_active = torch.zeros(p, dtype=torch.bool, device=dev)
        in_active[init_idx.long()] = True
        order = torch.arange(k_max, device=dev)
        count = m
    else:
        mask = live_mask.to(torch.bool)
        idx = torch.where(mask, init_idx.long(), 0)
        beta = (torch.where(mask, init_beta.to(dtype), 0.0)
                if init_beta is not None
                else torch.zeros(k_max, dtype=dtype, device=dev))
        in_active = torch.zeros(p, dtype=torch.bool, device=dev)
        in_active[idx[mask]] = True
        order = compact_order(torch.arange(k_max, device=dev), mask)
        count = int(mask.sum())
    return ActiveSet(idx, mask, beta, in_active, overflowed=False,
                     order=order, count=count)


def columns(X, ids):
    """The design's columns ``ids`` (an int, or a tensor of ids of any
    shape: (n, *ids.shape)), the one seam through which the engine reads
    design columns. A tensor is indexed as ``X[:, ids]``; a feature-sharded
    design (:class:`~repro_torch.distributed.saif_sharded.ShardedDesign`)
    fetches each column from the rank that owns it, an exact copy."""
    if isinstance(X, Tensor):
        return X[:, ids]
    return X.columns(ids)


def columns_t(X, ids: Tensor) -> Tensor:
    """:func:`columns` transposed, (*ids.shape, n), each column a
    contiguous row (the kernel bursts' layout); a tensor is read through
    its transposed view."""
    if isinstance(X, Tensor):
        if ids.ndim == 1:
            return torch.index_select(X.T, 0, ids)
        return X.T[ids]
    return X.columns_t(ids)


def gather_columns(X: Tensor, aset: ActiveSet) -> Tensor:
    """(n, k_max) active design block; padded columns zeroed."""
    return torch.where(aset.mask[None, :], columns(X, aset.idx), 0.0)


def pen_weights(aset: ActiveSet, unpen_idx: int, dtype) -> Tensor:
    """(k_max,) per-slot l1 weight: 0 on the slot that holds the
    unpenalized feature ``unpen_idx`` (fused LASSO's ``b``; -1 = none), 1
    everywhere else. The weight follows the slot the feature occupies, so
    it survives ADD/DEL churn and capacity growth."""
    if unpen_idx < 0:
        return torch.ones_like(aset.beta, dtype=dtype)
    unpen_slot = aset.mask & (aset.idx == unpen_idx)
    return torch.where(unpen_slot, 0.0, 1.0).to(dtype)


def host_read(values) -> list:
    """Host copies of same-dtype 0-d device values, in one read."""
    return torch.stack(values).tolist() if values else []


def delete_features_batch(asets, drop_slot_masks) -> list:
    """DEL on several active sets at once (one per problem of a fleet):
    each clears the slots flagged in its bool (k_max,) mask. The counts
    are read back together; every set's slot arithmetic is the serial
    one."""
    drops = [m & a.mask for a, m in zip(asets, drop_slot_masks)]
    out = []
    for aset, drop, n_drop in zip(asets, drops,
                                  host_read([d.sum() for d in drops])):
        new_mask = aset.mask & ~drop
        new_in_active = aset.in_active.clone()
        new_in_active[aset.idx[drop]] = False
        out.append(aset._replace(
            mask=new_mask, beta=torch.where(drop, 0.0, aset.beta),
            in_active=new_in_active,
            order=compact_order(aset.order, new_mask),
            count=aset.count - n_drop))
    return out


def delete_features(aset: ActiveSet, drop_slot_mask: Tensor) -> ActiveSet:
    """DEL: clear slots flagged in ``drop_slot_mask`` (bool (k_max,))."""
    return delete_features_batch([aset], [drop_slot_mask])[0]


def add_features_batch(asets, cand_idxs, cand_keeps) -> list:
    """ADD on several active sets at once (one per problem of a fleet):
    each scatters its kept candidates (descending score order) into its
    free slots, the c-th kept candidate into the c-th free slot. The
    counts are read back together."""
    staged, counts = [], []
    for aset, cand_idx, cand_keep in zip(asets, cand_idxs, cand_keeps):
        k_max = aset.mask.shape[0]
        free = ~aset.mask
        free_i = free.long()
        free_rank = torch.cumsum(free_i, 0) - free_i
        n_free = free_i.sum()
        keep_i = cand_keep.long()
        cand_rank = torch.cumsum(keep_i, 0) - keep_i
        n_want = keep_i.sum()
        placed = cand_keep & (cand_rank < n_free)
        order_key = torch.where(free, free_rank, k_max + 1)
        slot_of_rank = torch.argsort(order_key, stable=True)
        target_slot = slot_of_rank[torch.clamp(cand_rank, 0, k_max - 1)]
        staged.append((target_slot[placed], cand_idx[placed].long()))
        counts.append(torch.stack(((n_want > n_free).long(), placed.sum())))
    out = []
    for aset, (slots, ids), (over, n_placed) in zip(asets, staged,
                                                    host_read(counts)):
        new_idx = aset.idx.clone()
        new_idx[slots] = ids
        new_mask = aset.mask.clone()
        new_mask[slots] = True
        new_beta = aset.beta.clone()
        new_beta[slots] = 0.0
        new_in_active = aset.in_active.clone()
        new_in_active[ids] = True
        out.append(ActiveSet(new_idx, new_mask, new_beta, new_in_active,
                             overflowed=aset.overflowed or bool(over),
                             order=compact_order(aset.order, new_mask),
                             count=aset.count + n_placed))
    return out


def add_features(aset: ActiveSet, cand_idx: Tensor,
                 cand_keep: Tensor) -> ActiveSet:
    """ADD: scatter kept candidates (descending score order) into free
    slots, the c-th kept candidate into the c-th free slot."""
    return add_features_batch([aset], [cand_idx], [cand_keep])[0]


def scatter_beta(aset: ActiveSet, p: int) -> Tensor:
    """Inflate the compact beta back to (p,) (Algorithm 1 last line)."""
    out = torch.zeros(p, dtype=aset.beta.dtype, device=aset.beta.device)
    return out.index_add_(0, aset.idx[aset.mask], aset.beta[aset.mask])


# --------------------------------------------------------------------------
# fleet views (core/batch.py): a fleet's active sets are a list of serial
# ActiveSets, one per problem, so each problem's slot arithmetic is the
# serial one (the reference vmaps the serial functions for the same reason)
# --------------------------------------------------------------------------

def init_active_set_batch(p: int, k_max: int, init_idx: Tensor, dtype,
                          init_beta: Tensor, live_mask: Tensor) -> list:
    """Slots-mode :func:`init_active_set` per row of the (B, k_max)
    buffers."""
    return [init_active_set(p, k_max, i, dtype, b, m)
            for i, b, m in zip(init_idx, init_beta, live_mask)]


def gather_columns_batch(X: Tensor, asets) -> list:
    """The (n, k_max) active block of each active set, from a shared (n, p)
    design, each its own tensor."""
    return [gather_columns(X, a) for a in asets]


# --------------------------------------------------------------------------
# stacked fleet views (core/batch_fast.py): one ActiveSet whose every field
# has a leading problem axis B (idx/mask/beta/order (B, k_max), in_active
# (B, p), overflowed/count (B,) device tensors), the reference's batched
# ActiveSet. The fast engine updates it with batch-axis ops and no host read.
# --------------------------------------------------------------------------

def init_active_set_stacked(p: int, k_max: int, init_idx: Tensor, dtype,
                            init_beta: Tensor, live_mask: Tensor) -> ActiveSet:
    """Slots-mode :func:`init_active_set` per row of the (B, k_max)
    buffers, stacked (the reference's ``init_active_set_batch``)."""
    b = init_idx.shape[0]
    mask = live_mask.to(torch.bool)
    idx = torch.where(mask, init_idx.long(), 0)
    beta = torch.where(mask, init_beta.to(dtype), 0.0)
    in_active = torch.zeros((b, p), dtype=torch.int32,
                            device=idx.device).scatter_add_(
        1, idx, mask.to(torch.int32)) > 0
    count = mask.sum(dim=1, dtype=torch.int32)
    order = torch.arange(k_max, device=idx.device).expand(b, -1)
    return ActiveSet(idx, mask, beta, in_active,
                     overflowed=torch.zeros(b, dtype=torch.bool,
                                            device=idx.device),
                     order=order, count=count)


def gather_columns_stacked(X: Tensor, aset: ActiveSet) -> Tensor:
    """(B, n, k_max) active blocks from a shared (n, p) design, dead slots
    zeroed (the reference's ``gather_columns_batch``)."""
    b, k = aset.idx.shape
    Xa = columns(X, aset.idx.reshape(-1)).reshape(-1, b, k)
    return torch.where(aset.mask[:, None, :], Xa.permute(1, 0, 2), 0.0)


def scatter_beta_stacked(aset: ActiveSet, p: int) -> Tensor:
    """(B, p) full solutions (the reference's ``scatter_beta_batch``)."""
    out = torch.zeros((aset.idx.shape[0], p), dtype=aset.beta.dtype,
                      device=aset.beta.device)
    return out.scatter_add_(1, aset.idx, torch.where(aset.mask, aset.beta,
                                                     0.0))
