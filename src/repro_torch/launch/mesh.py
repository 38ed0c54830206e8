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
``make_production_mesh`` is not ported yet.
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
    device_type = "cuda" if "nccl" in dist.get_backend() else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(n // model, model),
                      mesh_dim_names=("data", "model"))


def dp_axes(mesh) -> tuple:
    """The data-parallel dimensions of a mesh (everything but 'model')."""
    return tuple(a for a in mesh.mesh_dim_names if a != "model")
