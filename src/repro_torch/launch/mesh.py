"""Process groups and device meshes over ``torch.distributed`` (port of
``repro.launch.mesh``).

Functions, not module-level constants: importing this module initialises
no process group and touches no device. Every rank runs the same program
(SPMD) and calls these with its own rank.

    init_group(world_size=2, rank=r, store_dir=tmp, backend="gloo")
    mesh = make_host_mesh()               # (data=2, model=1)
    sess = open_session(problem, config, mesh=mesh)
    sess.solve(Scalar(lam, sharded=True))

The mesh's device type picks the collectives' backend: NCCL on ``cuda``,
gloo on ``cpu``; where the work runs is the session's device (or the
inputs'), so a gloo mesh over CUDA tensors stays on the card. A sharded
session flattens every mesh dimension, in row-major order, into its
feature axis (``distributed/comm.py``).

``make_production_mesh`` gives the reference's production mesh over a
default group of 256 or 512 ranks. For the dry-run, one process stands in
for the whole cluster: ``init_fake_group(256)`` creates that group on
torch's fake backend (every collective returns at once and moves nothing),
and ``destroy_group()`` ends it. The fake group is a model of a cluster
for the dry-run's placements only: no solve or step runs on it.
"""
from __future__ import annotations

import datetime
import os

# collectives that wait longer than this fail with an error instead of
# hanging (a rank that diverged, or died)
TIMEOUT_S = 120.0


def init_group(world_size: int, rank: int, store_dir: str,
               backend: str = "gloo", timeout_s: float = TIMEOUT_S) -> None:
    """Initialise the default process group from a ``file://`` store in
    ``store_dir`` (a directory every rank can read; no network), with a
    timeout on every collective. ``backend``: "nccl" (CUDA tensors) or
    "gloo" (CPU tensors, and CUDA tensors through the host)."""
    import torch.distributed as dist
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(store_dir, "store"),
        world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))


def init_fake_group(world_size: int) -> None:
    """Initialise the default process group as rank 0 of ``world_size``
    ranks on torch's fake backend (no process, no network; collectives
    are no-ops). End it with :func:`destroy_group`."""
    import torch.distributed as dist
    # registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def destroy_group() -> None:
    """Destroy the default process group (and the mesh groups made from
    it), if there is one."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def _device_type() -> str:
    import torch.distributed as dist
    return "cuda" if "nccl" in dist.get_backend() else "cpu"


def make_production_mesh(*, multi_pod: bool = False):
    """(data=16, model=16) single pod; (pod=2, data=16, model=16) two pods:
    a ``DeviceMesh`` over a default group of exactly 256 (512) ranks,
    which it raises without."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    want = 512 if multi_pod else 256
    have = dist.get_world_size() if dist.is_initialized() else None
    if have != want:
        raise RuntimeError(
            f"the production mesh {dict(zip(axes, shape))} needs a default "
            f"process group of {want} ranks; "
            + ("there is none" if have is None else f"it has {have}")
            + " (init_fake_group(n) makes one for the dry-run)")
    return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)


def make_host_mesh(model: int = 1):
    """A (data, model) ``DeviceMesh`` over the default group's ranks, in
    rank order (the tests' and examples' mesh), of the group's device
    type: ``cuda`` under NCCL, ``cpu`` under gloo."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"model={model} does not divide the {n} ranks")
    return DeviceMesh(_device_type(),
                      torch.arange(n).reshape(n // model, model),
                      mesh_dim_names=("data", "model"))


def dp_axes(mesh) -> tuple:
    """The data-parallel dimensions of a mesh (everything but 'model')."""
    return tuple(a for a in mesh.mesh_dim_names if a != "model")
