"""The collectives of the feature-sharded solve, over the ranks of a device
mesh flattened in row-major order (the reference lets XLA insert them).

Three operations, each on a :class:`FeatureGroup`:

  * :func:`all_gather_rows` — every rank's (rows, cols) block, stacked in
    mesh order: the screen's candidate pairs (each rank's max ub rides
    along, so no max-reduce is needed), the design's statistics;
  * :func:`all_reduce_sum` — an elementwise sum: the violation histograms
    and survivor counts, and the owner fetch of design columns (each rank
    fills the columns it owns and -0.0 elsewhere, so the sum is an exact
    copy of every entry, signed zeros included);
  * :func:`all_reduce_max` — an elementwise max: the per-tensor scales of
    the int8-compressed gradient all-reduce (``optim/compress.py``).

A sharded mesh covers every rank of the default group. Its device type
picks the collective route and nothing else (the tensors' device says
where the work runs): NCCL on ``cuda`` meshes runs on the card's tensors;
gloo on ``cpu`` meshes runs on host tensors, and a CUDA tensor given to a
gloo group is copied to the host before the collective and back after, a
route chosen by the backend (two processes can share one card only under
gloo). The group carries the timeout it was created with
(``launch/mesh.py::init_group``), so a rank that waits on a diverged peer
fails instead of hanging.

``CALLS`` counts the collectives by operation (the chip smoke reads it as
collectives per outer step) and ``BYTES`` the bytes of their output
buffers, the quantity the reference's dry-run sums from the HLO of its
collectives (``launch/dryrun.py`` reckons the same for its rows);
:func:`reset_calls` zeroes both.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor

CALLS = {"gather": 0, "sum": 0, "max": 0}
BYTES = {"gather": 0, "sum": 0, "max": 0}


def reset_calls() -> None:
    for k in CALLS:
        CALLS[k] = 0
        BYTES[k] = 0


def _nbytes(t: Tensor) -> int:
    return t.numel() * t.element_size()


class FeatureGroup(NamedTuple):
    """The flattened mesh: ``pg`` the default process group, ``ranks`` its
    ranks in mesh (row-major) order, ``index`` this rank's position in it
    (its shard), ``host`` whether CUDA tensors go through the host
    (gloo)."""
    pg: object
    ranks: tuple
    index: int
    host: bool

    @property
    def size(self) -> int:
        return len(self.ranks)


def feature_group(mesh) -> FeatureGroup:
    """The :class:`FeatureGroup` of a ``DeviceMesh`` of any shape over
    every rank of the default group (whose timeout its collectives keep).
    The mesh's device type must match the group's backend: NCCL for
    ``cuda``, gloo for ``cpu``."""
    import torch.distributed as dist
    ranks = tuple(int(r) for r in mesh.mesh.flatten().tolist())
    if sorted(ranks) != list(range(dist.get_world_size())):
        raise ValueError(f"a sharded mesh covers every rank of the default "
                         f"group ({dist.get_world_size()}); this one holds "
                         f"{list(ranks)}")
    backend = dist.get_backend()
    want = "nccl" if mesh.device_type == "cuda" else "gloo"
    if want not in backend:
        raise ValueError(f"a {mesh.device_type} mesh needs a {want} process "
                         f"group; the group's backend is {backend!r}")
    return FeatureGroup(pg=dist.group.WORLD, ranks=ranks,
                        index=ranks.index(dist.get_rank()),
                        host=want == "gloo")


def all_gather_rows(fg: FeatureGroup, block: Tensor) -> Tensor:
    """(W, *block.shape): every rank's ``block`` (the same shape and dtype
    on each), in mesh order, on ``block``'s device. One output buffer, in
    rank order (gathering into a list of W outputs cost the card four
    times a small all-reduce)."""
    import torch.distributed as dist
    CALLS["gather"] += 1
    src = block.to("cpu") if fg.host else block.contiguous()
    out = src.new_empty((fg.size * src.shape[0], *src.shape[1:]))
    BYTES["gather"] += _nbytes(out)
    dist.all_gather_into_tensor(out, src, group=fg.pg)
    out = out.reshape(fg.size, *src.shape)
    if fg.ranks != tuple(range(fg.size)):
        out = out[list(fg.ranks)]
    return out.to(block.device)


def _all_reduce(fg: FeatureGroup, t: Tensor, op, kind: str) -> Tensor:
    import torch.distributed as dist
    CALLS[kind] += 1
    BYTES[kind] += _nbytes(t)
    # a private copy where the collective runs (it reduces in place)
    buf = (t.to("cpu", copy=True) if fg.host
           else t.clone(memory_format=torch.contiguous_format))
    dist.all_reduce(buf, op=op, group=fg.pg)
    return buf.to(t.device)


def all_reduce_sum(fg: FeatureGroup, t: Tensor) -> Tensor:
    """The elementwise sum of every rank's ``t`` (a new tensor)."""
    import torch.distributed as dist
    return _all_reduce(fg, t, dist.ReduceOp.SUM, "sum")


def all_reduce_max(fg: FeatureGroup, t: Tensor) -> Tensor:
    """The elementwise max of every rank's ``t`` (a new tensor)."""
    import torch.distributed as dist
    return _all_reduce(fg, t, dist.ReduceOp.MAX, "max")
