"""The LM scaffold's sharding rules and shape specs in the port
(``launch/shardings.py``, the spec builders of ``launch/steps.py``) held
rule for rule against ``repro.launch.shardings`` / ``repro.launch.steps``.

The reference's rules run on a ``jax.sharding.AbstractMesh`` of the
production shape (no devices); the port's on ``make_production_mesh``
over a fake process group of 256 or 512 ranks in this process. For every
leaf of the ten configs at full size, on (data 16, model 16) and (pod 2,
data 16, model 16): the same mesh axes on each tensor dim and the same
shard shape, for ``param_spec`` with and without ``fsdp``,
``opt_shardings`` (ZeRO-1), ``batch_spec`` at every ``SHAPES`` cell and
``cache_shardings`` on ``decode_state_specs`` at decode_32k and
long_500k. The port's spec builders (meta tensors) give the reference's
``ShapeDtypeStruct`` shapes and dtypes leaf for leaf (the reference's
``DecodeState.pos`` is a spec, the port's a host int). A spec whose axes
on one tensor dim break the mesh's order raises.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import repro.configs as JC
from repro.launch import shardings as JS
from repro.launch import steps as JST
from repro.models import lm as JL
import repro_torch.configs as TC
from repro_torch.launch import mesh as TM
from repro_torch.launch import shardings as TS
from repro_torch.launch import steps as TST
from repro_torch.models import lm as TL
from repro_torch.tree import leaf_paths

MESHES = {"1pod": ((16, 16), ("data", "model")),
          "2pod": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(scope="module", params=sorted(MESHES))
def meshes(request):
    """(reference AbstractMesh, port DeviceMesh over a fake group)."""
    shape, names = MESHES[request.param]
    TM.init_fake_group(int(np.prod(shape)))
    try:
        yield (AbstractMesh(shape, names),
               TM.make_production_mesh(multi_pod=len(shape) == 3))
    finally:
        TM.destroy_group()


def _ref_axes(spec, ndim):
    """A PartitionSpec as, per tensor dim, the tuple of its mesh axes."""
    out = []
    for d in range(ndim):
        e = spec[d] if d < len(spec) else None
        out.append(() if e is None else (tuple(e) if isinstance(e, tuple)
                                          else (e,)))
    return tuple(out)


def _same(jsh, plc, shape, tmesh):
    want = (_ref_axes(jsh.spec, len(shape)), tuple(jsh.shard_shape(shape)))
    got = (TS.axes_by_dim(plc, tmesh, len(shape)),
           TS.local_shape(shape, plc, tmesh))
    return want == got, (want, got)


def _flat(tree, prefix=()):
    """(path, leaf) of nested dicts and NamedTuples: dict keys sorted,
    NamedTuple fields in order (``jax.tree``'s order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f, v in zip(tree._fields, tree):
            yield from _flat(v, prefix + (f,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_param_and_opt_shardings(meshes, arch, fsdp):
    jmesh, tmesh = meshes
    jcfg, tcfg = JC.get_config(arch), TC.get_config(arch)
    shapes = TL.param_shapes(tcfg)
    assert shapes == JL.param_shapes(jcfg)
    j_p = JS.param_shardings(shapes, jcfg, jmesh, fsdp=fsdp)
    t_p = TS.param_shardings(shapes, tcfg, tmesh, fsdp=fsdp)
    j_o = JS.opt_shardings(j_p, shapes, jmesh, zero1=True)
    t_o = TS.opt_shardings(t_p, shapes, tmesh)
    t_p, t_o = dict(leaf_paths(t_p)), dict(leaf_paths(t_o))
    j_p, j_o = dict(leaf_paths(j_p)), dict(leaf_paths(j_o))
    bad = []
    for path, shape in leaf_paths(shapes):
        for what, j, t in (("param", j_p, t_p), ("opt", j_o, t_o)):
            ok, detail = _same(j[path], t[path], shape, tmesh)
            if not ok:
                bad.append((what, path, detail))
    assert not bad, bad[:5]
    # ZeRO-1 shards the moments of most leaves on the data axis
    data = [p for p, s in leaf_paths(shapes)
            if any("data" in a for a in TS.axes_by_dim(t_o[p], tmesh,
                                                       len(s)))]
    assert len(data) > len(t_o) // 2


@pytest.mark.parametrize("shape_name", sorted(JC.SHAPES))
def test_batch_spec(meshes, shape_name):
    jmesh, tmesh = meshes
    B = JC.SHAPES[shape_name].global_batch
    for b in (B, 1, 3):
        want = _ref_axes(JS.batch_spec(jmesh, b), 1)
        assert TS.axes_by_dim(TS.batch_spec(tmesh, b), tmesh, 1) == want


@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_cache_shardings(meshes, arch, shape_name):
    jmesh, tmesh = meshes
    j_st = JST.decode_state_specs(JC.get_config(arch),
                                  JC.SHAPES[shape_name])
    t_st = TST.decode_state_specs(TC.get_config(arch),
                                  TC.SHAPES[shape_name])
    j_sh = jax.tree.leaves(JS.cache_shardings(jmesh, j_st.caches))
    j_lv = jax.tree.leaves(j_st.caches)
    # a placements tuple is a leaf (a plain tuple, not a NamedTuple)
    t_sh = [plc for _, plc in _flat(TS.cache_shardings(tmesh,
                                                        t_st.caches))]
    t_lv = list(_flat(t_st.caches))
    assert len(j_lv) == len(t_lv) == len(j_sh) == len(t_sh)
    for jl, (_, tl), jsh, plc in zip(j_lv, t_lv, j_sh, t_sh):
        shape = tuple(tl.shape)
        assert tuple(jl.shape) == shape
        ok, detail = _same(jsh, plc, shape, tmesh)
        assert ok, (arch, shape, detail)
    assert isinstance(t_st.pos, int) and t_st.pos == 0


def _dtype_name(d):
    return str(d).replace("torch.", "")


@pytest.mark.parametrize("shape_name", sorted(JC.SHAPES))
@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_input_specs_match_reference(arch, shape_name):
    j = JST.input_specs(JC.get_config(arch), JC.SHAPES[shape_name])
    t = TST.input_specs(TC.get_config(arch), TC.SHAPES[shape_name])
    j_leaves = [(tuple(str(getattr(k, "key", getattr(k, "name", k)))
                       for k in path), leaf)
                for path, leaf in jax.tree_util.tree_flatten_with_path(j)[0]]
    if "state" in j and hasattr(j["state"], "pos"):
        j_leaves = [(p, v) for p, v in j_leaves if p != ("state", "pos")]
    t_leaves = list(_flat(t))
    if JC.SHAPES[shape_name].kind == "decode":
        t_leaves = [(p, v) for p, v in t_leaves if p != ("state", "pos")]
    assert [p for p, _ in t_leaves] == [p for p, _ in j_leaves]
    for (path, jl), (_, tl) in zip(j_leaves, t_leaves):
        assert tl.device.type == "meta", path
        assert tuple(tl.shape) == tuple(jl.shape), path
        assert _dtype_name(tl.dtype) == str(np.dtype(jl.dtype)), path


def test_placements_refuse_out_of_order_axes(meshes):
    _, tmesh = meshes
    names = tmesh.mesh_dim_names
    with pytest.raises(ValueError, match="order"):
        TS.placements(((names[-1], names[0]),), tmesh)
    with pytest.raises(ValueError, match="splits two"):
        TS.placements(("model", "model"), tmesh)
    plc = TS.placements((None, names[:-1]), tmesh)
    assert TS.axes_by_dim(plc, tmesh, 2) == ((), tuple(names[:-1]))
    shape = (3, int(np.prod(tmesh.shape[:-1])) * 2)
    assert TS.local_shape(shape, plc, tmesh) == (3, 2)
    assert all(torch.distributed.tensor.Replicate() == p
               for p in TS.placements((None, None), tmesh))
