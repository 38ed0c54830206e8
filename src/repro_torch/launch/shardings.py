"""Sharding rules (port of ``repro.launch.shardings``): parameters (TP/EP),
optimizer state (ZeRO-1), batches (DP), decode caches. All rules are
name+shape driven and divisibility-checked, so one rule set covers all 10
architectures on any mesh, and they read only the mesh's shape and dim
names.

The port's rules give DTensor placements: a tuple with one ``Shard(d)`` or
``Replicate()`` for each mesh dim. The reference's ``PartitionSpec`` names,
for each tensor dim, the mesh axes that split it; where it puts two axes
on one tensor dim (``("pod", "data")`` on a batch, ``("data", "model")``
on a cache's sequence), the port puts ``Shard(d)`` on each of those mesh
dims. DTensor splits a tensor dim over its mesh dims in mesh order, the
reference over the tuple's order, so the two agree only while every tuple
is in mesh order: :func:`placements` raises on one that is not.
:func:`axes_by_dim` reads placements back as the reference's per-dim axes
and :func:`local_shape` gives one rank's shard.
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.launch.mesh import dp_axes
from repro_torch.models.config import ModelConfig


def _sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axis_size(mesh, name) -> int:
    return _sizes(mesh)[name]


def _fits(dim: int, mesh, axis: str) -> bool:
    return dim % _axis_size(mesh, axis) == 0


def _prod(mesh, axes) -> int:
    out = 1
    for a in axes:
        out *= _axis_size(mesh, a)
    return out


def placements(spec, mesh) -> tuple:
    """The placements of a reference-style spec: entry d is None, a mesh
    dim name or a tuple of names (in mesh order) splitting tensor dim d."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx) or len(set(idx)) != len(idx):
            raise ValueError(f"mesh dims {axes} on tensor dim {d} are not in "
                             f"the mesh's order {tuple(names)}")
        for i in idx:
            if isinstance(out[i], Shard):
                raise ValueError(f"mesh dim {names[i]!r} splits two tensor "
                                 f"dims in {spec}")
            out[i] = Shard(d)
    return tuple(out)


def axes_by_dim(plc, mesh, ndim: int) -> tuple:
    """For each of ``ndim`` tensor dims, the mesh dim names (mesh order)
    whose placement in ``plc`` shards it: () where none does."""
    from torch.distributed.tensor import Shard
    by = [[] for _ in range(ndim)]
    for name, pl in zip(mesh.mesh_dim_names, plc):
        if isinstance(pl, Shard):
            by[pl.dim].append(name)
    return tuple(tuple(b) for b in by)


def _spec(plc, mesh, ndim: int) -> list:
    return [None if not a else (a[0] if len(a) == 1 else a)
            for a in axes_by_dim(plc, mesh, ndim)]


def local_shape(shape, plc, mesh) -> tuple:
    """One rank's shard of a tensor of ``shape`` under ``plc`` (the rules
    shard only dims their mesh axes divide)."""
    out = list(shape)
    for d, axes in enumerate(axes_by_dim(plc, mesh, len(shape))):
        k = _prod(mesh, axes)
        if out[d] % k:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"over {axes} ({k})")
        out[d] //= k
    return tuple(out)


# parameter name -> which logical dim prefers the model axis.
# Index is into the *unstacked* (per-layer) shape; the stacked L dim is
# prepended for block params, handled by offset detection below.
_MODEL_DIM_RULES: Dict[str, int] = {
    # attention
    "wq": 1, "wk": 1, "wv": 1, "wo": 0,
    # dense mlp
    "w1": 1, "w3": 1, "w2": 0,
    # moe (E is dim 0 of the per-layer shape) — expert parallelism
    "router": 1,
    # mamba
    "in_proj": 1, "conv": 1, "x_proj": 0, "dt_proj": 1, "A_log": 0,
    "Dskip": 0, "out_proj": 0,
    # mlstm / slstm
    "wi": 1, "wf": 1, "wo_gate": 1, "out": 0, "wz": 1,
    # vlm
    "img_proj": 1,
}

_MOE_PARAMS = {"w1", "w3", "w2"}   # (E, D, F)/(E, F, D): shard E

STACKED = ("blocks", "blocks_m", "blocks_s", "cross_blocks", "enc_blocks")


def param_spec(path, shape, cfg: ModelConfig, mesh) -> tuple:
    name = path[-1]
    ndim = len(shape)
    none = (None,) * ndim

    def with_model(dim):
        if dim < ndim and _fits(shape[dim], mesh, "model"):
            spec = list(none)
            spec[dim] = "model"
            return placements(spec, mesh)
        return placements(none, mesh)

    stacked = path[-2] in STACKED if len(path) >= 2 else False
    off = 1 if stacked else 0

    if name == "embed":
        if _fits(shape[0], mesh, "model"):
            return placements(("model", None), mesh)
        if _fits(shape[1], mesh, "model"):
            return placements((None, "model"), mesh)
        return placements((None, None), mesh)
    if name == "lm_head":
        return with_model(1)
    if name in ("final_ln", "enc_ln") or name.startswith("ln"):
        return placements(none, mesh)
    if cfg.family == "moe" and name in _MOE_PARAMS and ndim == 3 + off:
        return with_model(off + 0)      # shard experts (EP)
    if name in _MODEL_DIM_RULES:
        return with_model(off + _MODEL_DIM_RULES[name])
    return placements(none, mesh)


def fsdp_spec(plc, shape, mesh) -> tuple:
    """FSDP: additionally shard parameters over the data axis on the first
    free, divisible dim: an all-gather of the shard for every use, for an
    n_data-fold cut in parameter + gradient + optimizer residency."""
    return zero1_spec(plc, shape, mesh)


def param_shardings(shapes_tree, cfg: ModelConfig, mesh, *,
                    fsdp: bool = False):
    """shapes_tree: tree of shape tuples (``models.lm.param_shapes``);
    returns the same tree with a placements tuple at each leaf."""
    def walk(path, node):
        if isinstance(node, tuple):
            plc = param_spec(path, node, cfg, mesh)
            if fsdp:
                plc = fsdp_spec(plc, node, mesh)
            return plc
        return {k: walk(path + (k,), v) for k, v in node.items()}
    return walk((), shapes_tree)


def zero1_spec(plc, shape, mesh) -> tuple:
    """ZeRO-1: additionally shard optimizer moments over the data axis on
    the first dim that is free and divisible (usually the stacked L dim)."""
    dp = dp_axes(mesh)
    if not dp:
        return plc
    axis = dp[-1]   # the largest dp axis ('data')
    entries = _spec(plc, mesh, len(shape))
    used = {a for e in entries if e is not None
            for a in (e if isinstance(e, tuple) else (e,))}
    if axis in used:
        return plc
    for d, (e, s) in enumerate(zip(entries, shape)):
        if e is None and s % _axis_size(mesh, axis) == 0:
            entries[d] = axis
            return placements(entries, mesh)
    return plc


def opt_shardings(param_sh, shapes_tree, mesh):
    """Placements for AdamW m/v (params-shaped), ZeRO-1 (the reference's
    default ``zero1=True``; nothing in the port holds the moments
    otherwise). step is replicated."""
    def walk(sh_node, shape_node):
        if isinstance(shape_node, tuple):
            return zero1_spec(sh_node, shape_node, mesh)
        return {k: walk(sh_node[k], shape_node[k]) for k in shape_node}
    return walk(param_sh, shapes_tree)


def batch_spec(mesh, batch_size: int) -> tuple:
    """Placements of a tensor whose dim 0 is a batch of ``batch_size``."""
    dp = dp_axes(mesh)
    if batch_size % _prod(mesh, dp) == 0:
        return placements((dp,), mesh)
    # small batches (long_500k B=1): replicate batch, shard elsewhere
    return placements((None,), mesh)


def batch_shardings(mesh, batch: Dict[str, Any]):
    return {k: batch_spec(mesh, v.shape[0]) for k, v in batch.items()}


def cache_sharding(mesh, shape) -> tuple:
    """Decode-cache rule (the reference's with its defaults: the batch on
    dim 1, after the stacked layers, and the KV sequence sharded): batch
    dim -> dp axes if divisible.

    KV caches (rank-5: L, B, S, Hkv, hd): the SEQUENCE dim takes the model
    axis ("context parallelism"): contracting over a sequence-sharded cache
    reduces only the small (B, H) partials, where sharding hd would gather
    the whole cache for the attention products.

    Lower-rank recurrent states (mLSTM/mamba) shard their feature dim on
    model when divisible.
    """
    dp = dp_axes(mesh)
    total = _prod(mesh, dp)
    spec = [None] * len(shape)
    batch_ok = len(shape) > 1 and shape[1] % total == 0
    if batch_ok:
        spec[1] = dp
    if len(shape) >= 5:
        # KV cache: shard sequence over model (+ data when batch can't)
        axes = ("model",) if batch_ok else (dp[-1], "model")
        if shape[2] % _prod(mesh, axes) == 0:
            spec[2] = axes if len(axes) > 1 else axes[0]
            return placements(spec, mesh)
    # fallback / recurrent states: last dim on model
    if not batch_ok and len(shape) > 2 \
            and shape[2] % _axis_size(mesh, dp[-1]) == 0:
        spec[2] = dp[-1]
    last = len(shape) - 1
    if last > 1 and shape[last] % _axis_size(mesh, "model") == 0:
        spec[last] = "model"
    return placements(spec, mesh)


def map_cache(fn, tree):
    """``fn`` over the tensors of a cache tree (dicts of NamedTuples of
    tensors, as ``lm.init_decode_state`` builds ``DecodeState.caches``)."""
    if isinstance(tree, dict):
        return {k: map_cache(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(map_cache(fn, v) for v in tree))
    return fn(tree)


def cache_shardings(mesh, cache_tree):
    """cache_sharding leaf-wise over a ``DecodeState.caches`` tree (leaves
    are tensors, meta or real). The port's ``DecodeState.pos`` is a host
    int, so only the caches are placed."""
    def one(leaf):
        if leaf.ndim == 0:
            return placements((), mesh)
        return cache_sharding(mesh, tuple(leaf.shape))
    return map_cache(one, cache_tree)
