"""Dry-run cost model of the LM scaffold on a production mesh of H100s
(the port's counterpart of ``repro.launch.dryrun``): for each
(architecture x input shape x mesh) cell, one record of what a rank
computes, moves and holds in one step, priced against one H100.

The reference lowers and compiles each cell for 512 placeholder TPU
devices and reads XLA's cost and memory analyses and the collectives of
its HLO. The port has no lowering, so this is a roofline, not a
translation:

* The per-rank program is the port's own (``launch/steps.py``:
  ``value_and_grad`` for a train cell, ``make_prefill``, or
  ``make_serve_step``), run under ``FakeTensorMode`` on tensors that have
  shapes and no storage, at the per-rank batch: the global batch over the
  data ranks where ``batch_spec`` shards it, the whole batch where it does
  not (long_500k, B = 1). The optimizer's elementwise update is not run.
* ``flops``: ``FlopCounterMode``'s count over the ``model`` axis, which
  assumes perfect tensor parallelism. FlopCounterMode counts matrix
  products and attention, not elementwise work (norms, activations, the
  recurrent scans' adds and products), so ``flops`` is a lower bound.
  ``raw_flops`` equals ``flops`` and ``scan_corrected`` is False: the
  port's layers are a Python loop and every layer is counted (the
  reference extrapolates the layers that its ``lax.scan`` counts once).
* ``bytes``: the input and output bytes of every aten op the program runs
  (views excluded), over the ``model`` axis: the counterpart of XLA's
  "bytes accessed", an upper bound on the HBM traffic of a fused program.
* ``argument_bytes``: exact, each argument's shard under the placements of
  ``launch/shardings.py`` (parameters by ``param_shardings``, AdamW's
  moments by ``opt_shardings`` with ZeRO-1, the batch by
  ``batch_shardings``, decode caches by ``cache_shardings``).
* ``temp_bytes``: the peak of live bytes above the arguments under
  ``MemTracker`` in fake mode, for the per-rank batch on unsharded
  weights: an upper bound on one rank's temporaries.
* ``collectives``: reckoned from the placements, per device and per step
  (no collective is traced), with ring factors: ``2(k-1)/k x bytes`` for
  an all-reduce over k ranks, ``(k-1)/k x bytes`` for an all-gather or a
  reduce-scatter. ``b`` is the per-rank batch, ``T`` the tokens a
  sequence runs (the sequence length; 1 in decode; ``n_frames`` in the
  encoder), activations in the compute dtype:

  =====================  ==============================================
  tensor parallelism     per layer, one all-reduce of the (b, T, width)
  (``model`` axis k_m)   output of each row-parallel product whose
                         contraction dim is on ``model``: ``wo``, ``w2``
                         (with MoE experts on ``model``: the combine),
                         ``out_proj``, ``x_proj``, mLSTM/sLSTM ``out``;
                         the same again in the backward of a train step
                         (remat's recomputed forward is not counted)
  embedding              vocab on ``model``: one all-reduce of
                         (b, T, D); d_model on ``model``: an all-gather
  vocab-sharded head     prefill and decode: the last position's logits
                         (b, V) all-gathered; train: the loss's max and
                         sum, two all-reduces of (b, T) float32, and the
                         hidden's gradient, an all-reduce of (b, T, D)
  data parallelism       train only, over the axes that shard the batch:
  (k_d ranks)            a leaf's gradient all-reduce; a leaf ZeRO-1
                         shards on ``data``: a reduce-scatter over
                         ``data``, an all-reduce of the shard over the
                         other data axes (``pod``) and the parameters'
                         all-gather over ``data``; with ``fsdp`` a leaf's
                         all-gather over ``data`` for every use (forward
                         and backward), then the gradient's reduce-scatter
  decode, sequence-      each attention layer's partial (b, H) max and
  sharded KV cache       sum (float32) and (b, H, hd) output, all-reduced
                         over the axes that shard the cache's sequence
  =====================  ==============================================

  The data-parallel row prices the ZeRO-1 program that the reference's
  placements describe. The port's trainer (``launch/train.py``) differs:
  it all-reduces the whole gradients (2(k-1)/k x bytes, not a
  reduce-scatter's (k-1)/k) before each rank updates its slice.
* One H100 SXM prices the terms (NVIDIA's data sheet, dense rates, as the
  repository's kernel bounds use them): 989e12 FLOP/s in bf16 (67e12 for
  float32 work), 3.35e12 B/s of HBM, 450e9 B/s of NVLink each way. A
  mesh wider than one host's 8 cards crosses a slower network between
  hosts, which the row does not price: ``collective_s`` is a lower bound.

``lower_saif_screen`` is the row of the port's feature-sharded screening
collective (``distributed/saif_sharded.py::make_fused_screen``): K1 over
each rank's n x p/W block and one gather of every rank's top-h.

    python -m repro_torch.launch.dryrun --arch whisper_tiny \\
        --shape prefill_32k --out r.jsonl [--multi-pod | --both-meshes]
    python -m repro_torch.launch.dryrun --saif-screen --both-meshes

The CLI stands one process in for the whole mesh through torch's fake
process group (``launch/mesh.py::init_fake_group``). No record is a
measurement: every number is counted or reckoned.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
import traceback
from typing import Dict

import torch

from repro_torch.launch import shardings, steps
from repro_torch.launch.shardings import (STACKED, axes_by_dim, batch_spec,
                                          local_shape)
from repro_torch.launch.mesh import (destroy_group, dp_axes,
                                     init_fake_group, make_production_mesh)
from repro_torch.models import lm
from repro_torch.tree import leaf_paths

# one H100 SXM (NVIDIA's data sheet, dense, 700 W)
PEAK_FLOPS = 989e12         # bf16 tensor cores
PEAK_FLOPS_F32 = 67e12      # float32 outside the tensor cores
HBM_BW = 3.35e12            # bytes/s
NVLINK_BW = 450e9           # bytes/s each way, to the host's other cards

_ALL_REDUCE, _ALL_GATHER, _REDUCE_SCATTER = ("all-reduce", "all-gather",
                                             "reduce-scatter")
# row-parallel products: (per-layer) contraction dim 0, output its last dim
_ROW_PARALLEL = ("wo", "w2", "out_proj", "x_proj", "out")


def _mesh_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _mesh_name(mesh) -> str:
    return "x".join(f"{k}={v}" for k, v in _mesh_sizes(mesh).items())


def _n_chips(mesh) -> int:
    return math.prod(mesh.shape)


def roofline_terms(flops: float, bytes_hbm: float, coll: Dict[str, float],
                   peak_flops: float = PEAK_FLOPS) -> Dict[str, float]:
    """All inputs are per-device quantities of one step; each term is the
    least time that subsystem of one H100 takes for it."""
    compute_t = flops / peak_flops
    memory_t = bytes_hbm / HBM_BW
    coll_bytes = sum(coll.values())
    collective_t = coll_bytes / NVLINK_BW
    dom = max(("compute", compute_t), ("memory", memory_t),
              ("collective", collective_t), key=lambda kv: kv[1])[0]
    return {"compute_s": compute_t, "memory_s": memory_t,
            "collective_s": collective_t, "collective_bytes": coll_bytes,
            "dominant": dom}


def _ring(op: str, k: int, nbytes: float) -> float:
    if k <= 1:
        return 0.0
    return (2.0 if op == _ALL_REDUCE else 1.0) * (k - 1) / k * nbytes


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def _op_bytes_mode():
    """A ``TorchDispatchMode`` whose ``total`` sums the input and output
    tensor bytes of every aten op run under it (views move nothing and are
    skipped)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class OpBytes(TorchDispatchMode):
        total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not func.is_view:
                self.total += sum(t.numel() * t.element_size()
                                  for t in tree_leaves((args, kwargs, out))
                                  if isinstance(t, torch.Tensor))
            return out
    return OpBytes()


def _fake_like(tree):
    """Storage-less tensors of the meta ``tree``'s shapes and dtypes (call
    under a FakeTensorMode)."""
    return shardings.map_cache(
        lambda t: torch.empty(t.shape, dtype=t.dtype), tree)


def count_program(fn, args) -> Dict[str, float]:
    """Run ``fn(*args)`` (on fake tensors) under FlopCounterMode, the op
    byte counter and MemTracker: its flops, op bytes, peak of live bytes
    above ``args``'s, and the seconds the count took."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils._pytree import tree_leaves
    from torch.utils.flop_counter import FlopCounterMode
    ext = [t for t in tree_leaves(args) if isinstance(t, torch.Tensor)]
    held = sum(t.numel() * t.element_size() for t in ext)
    flops, nbytes, mt = (FlopCounterMode(display=False), _op_bytes_mode(),
                         MemTracker())
    mt.track_external(*ext)
    t0 = time.perf_counter()
    with mt, flops, nbytes:
        fn(*args)
    secs = time.perf_counter() - t0
    peak = sum(snap["Total"]
               for snap in mt.get_tracker_snapshot("peak").values())
    return {"flops": float(flops.get_total_flops()),
            "bytes": float(nbytes.total), "temp_bytes": max(peak - held, 0),
            "count_s": secs}


def _local_bytes(tree, plc_tree, mesh) -> int:
    """Bytes of one rank's shards of the meta ``tree`` (dicts and
    NamedTuples of tensors) under ``plc_tree``, of the same structure."""
    if isinstance(tree, torch.Tensor):
        return _nbytes(local_shape(tuple(tree.shape), plc_tree, mesh),
                       tree.dtype)
    if isinstance(tree, dict):
        return sum(_local_bytes(tree[k], plc_tree[k], mesh) for k in tree)
    return sum(_local_bytes(t, plc, mesh) for t, plc in zip(tree, plc_tree))


def per_rank_batch(mesh, global_batch: int) -> int:
    """The rows of the global batch one rank runs, by ``batch_spec``."""
    return local_shape((global_batch,), batch_spec(mesh, global_batch),
                       mesh)[0]


def collectives(cfg, shape, mesh, b: int, p_sh, o_sh, *, fsdp=False,
                caches=None, cache_sh=None) -> Dict[str, float]:
    """Per-device bytes of one step's collectives, by the rules of the
    module docstring. ``b``: the per-rank batch; ``p_sh`` / ``o_sh``: the
    parameters' and moments' placements; ``caches`` / ``cache_sh``: a
    decode cell's meta caches and their placements."""
    sizes = _mesh_sizes(mesh)
    km = sizes.get("model", 1)
    kind = shape.kind
    T = 1 if kind == "decode" else shape.seq_len
    isz = torch.empty((), dtype=cfg.adtype).element_size()
    D, V = cfg.d_model, cfg.vocab
    out = {_ALL_REDUCE: 0.0, _ALL_GATHER: 0.0, _REDUCE_SCATTER: 0.0}

    def add(op, k, nbytes, times=1):
        out[op] += times * _ring(op, k, nbytes)

    shapes = dict(leaf_paths(lm.param_shapes(cfg)))
    plcs = dict(leaf_paths(p_sh))

    def on_model(path, dim):
        return "model" in axes_by_dim(plcs[path], mesh,
                                      len(shapes[path]))[dim]

    passes = 2 if kind == "train" else 1        # forward, backward
    # tensor parallelism: the row-parallel products of every stack
    for path, shp in shapes.items():
        if len(path) != 2 or path[0] not in STACKED \
                or path[1] not in _ROW_PARALLEL or not on_model(path, 1):
            continue
        if path[0] == "enc_blocks":
            if kind == "decode":
                continue                        # the encoder ran before
            tokens = cfg.n_frames
        else:
            tokens = T
        add(_ALL_REDUCE, km, b * tokens * shp[-1] * isz, shp[0] * passes)
    if ("embed",) in shapes:
        if on_model(("embed",), 0):
            add(_ALL_REDUCE, km, b * T * D * isz)
        elif on_model(("embed",), 1):
            add(_ALL_GATHER, km, b * T * D * isz)
    head, vdim = (("embed",), 0) if cfg.tie_embeddings else (("lm_head",), 1)
    if on_model(head, vdim):
        if kind == "train":
            add(_ALL_REDUCE, km, b * T * 4, 2)      # the loss's max, sum
            add(_ALL_REDUCE, km, b * T * D * isz)   # the hidden's gradient
        else:
            add(_ALL_GATHER, km, b * V * isz)       # last position's logits

    # data parallelism: the gradients (train)
    dp = dp_axes(mesh)
    batch_axes = axes_by_dim(batch_spec(mesh, shape.global_batch), mesh,
                             1)[0]
    if kind == "train" and batch_axes:
        k_d = math.prod(sizes[a] for a in batch_axes)
        k_data = sizes[dp[-1]]
        moments = dict(leaf_paths(o_sh))
        for path, shp in shapes.items():
            here = _nbytes(local_shape(shp, plcs[path], mesh), cfg.pdtype)
            p_axes = {a for ax in axes_by_dim(plcs[path], mesh, len(shp))
                      for a in ax}
            o_axes = {a for ax in axes_by_dim(moments[path], mesh,
                                              len(shp))
                      for a in ax}
            if fsdp and dp[-1] in p_axes:
                whole = here * k_data           # the leaf before fsdp
                add(_ALL_GATHER, k_data, whole, passes)
                add(_REDUCE_SCATTER, k_data, whole)
                add(_ALL_REDUCE, k_d // k_data, here)
            elif dp[-1] in o_axes:              # ZeRO-1
                add(_REDUCE_SCATTER, k_data, here)
                add(_ALL_REDUCE, k_d // k_data, here / k_data)
                add(_ALL_GATHER, k_data, here)
            else:
                add(_ALL_REDUCE, k_d, here)
    elif fsdp:                                  # inference: one use
        k_data = sizes[dp[-1]]
        for path, shp in shapes.items():
            here = _nbytes(local_shape(shp, plcs[path], mesh), cfg.pdtype)
            p_axes = axes_by_dim(plcs[path], mesh, len(shp))
            if any(dp[-1] in ax for ax in p_axes):
                add(_ALL_GATHER, k_data, here * k_data)

    # decode: attention over a sequence-sharded cache
    if caches is not None:
        from repro_torch.models.layers import KVCache
        for name, c in caches.items():
            if not isinstance(c, KVCache):
                continue
            seq_axes = axes_by_dim(cache_sh[name].k, mesh, 5)[2]
            k_s = math.prod(sizes[a] for a in seq_axes)
            b_loc = local_shape(tuple(c.k.shape), cache_sh[name].k,
                                mesh)[1]
            H = cfg.n_heads
            partial = 2 * b_loc * H * 4 + b_loc * H * cfg.hd * isz
            add(_ALL_REDUCE, k_s, partial, c.k.shape[0])
    return {k: v for k, v in out.items() if v}


def lower_cell(arch: str, shape_name, mesh, microbatch: int = 1,
               fsdp: bool = False) -> Dict:
    """The record of one cell: the port's per-rank program counted in fake
    mode, its arguments' shards, its collectives reckoned, the roofline
    terms of one H100 (module docstring). ``shape_name``: a ``SHAPES``
    name, or a ``ShapeCfg`` of another size."""
    import dataclasses

    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import SHAPES, get_config
    cfg = get_config(arch)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    kind = shape.kind
    km = _mesh_sizes(mesh).get("model", 1)
    b = per_rank_batch(mesh, shape.global_batch)
    shapes_tree = lm.param_shapes(cfg)
    p_sh = shardings.param_shardings(shapes_tree, cfg, mesh, fsdp=fsdp)
    o_sh = shardings.opt_shardings(p_sh, shapes_tree, mesh)

    # the arguments' shards, from the global specs (meta)
    specs = steps.input_specs(cfg, shape)
    caches = cache_sh = None
    if kind == "train":
        opt = specs["state"].opt
        args_bytes = (_local_bytes(specs["state"].params, p_sh, mesh)
                      + _local_bytes(opt.m, o_sh, mesh)
                      + _local_bytes(opt.v, o_sh, mesh)
                      + _nbytes((), opt.step.dtype))
    else:
        args_bytes = _local_bytes(specs["params"], p_sh, mesh)
    if kind == "decode":
        caches = specs["state"].caches
        cache_sh = shardings.cache_shardings(mesh, caches)
        tok_sh = shardings.batch_spec(mesh, shape.global_batch)
        args_bytes += (_local_bytes(caches, cache_sh, mesh)
                       + _local_bytes(specs["tok"], tok_sh, mesh))
    else:
        args_bytes += _local_bytes(
            specs["batch"], shardings.batch_shardings(mesh, specs["batch"]),
            mesh)

    # the per-rank program, counted on fake tensors
    local = steps.input_specs(cfg, dataclasses.replace(shape,
                                                       global_batch=b))
    with FakeTensorMode():
        params = _fake_like(steps.param_specs(cfg))
        if kind == "train":
            counted = count_program(
                lambda p, bt: steps.value_and_grad(p, bt, cfg, microbatch),
                (params, _fake_like(local["batch"])))
        elif kind == "prefill":
            counted = count_program(steps.make_prefill(cfg),
                                    (params, _fake_like(local["batch"])))
        else:
            serve = steps.make_serve_step(cfg)
            counted = count_program(
                lambda p, t, c: serve(p, t, lm.DecodeState(c, 0)),
                (params, torch.zeros((b,), dtype=torch.int32),
                 _fake_like(local["state"].caches)))

    flops = counted["flops"] / km
    bytes_hbm = counted["bytes"] / km
    coll = collectives(cfg, shape, mesh, b, p_sh, o_sh, fsdp=fsdp,
                       caches=caches, cache_sh=cache_sh)
    peak = PEAK_FLOPS if cfg.adtype == torch.bfloat16 else PEAK_FLOPS_F32
    tokens = shape.global_batch * (shape.seq_len if kind != "decode" else 1)
    model_flops = ((6.0 if kind == "train" else 2.0)
                   * cfg.active_param_count() * tokens)
    n_chips = _n_chips(mesh)
    return {
        "arch": arch, "shape": shape.name, "mesh": _mesh_name(mesh),
        "n_chips": n_chips, "compile_s": round(counted["count_s"], 1),
        "per_rank_batch": b,
        "flops": flops, "bytes": bytes_hbm,
        "raw_flops": flops, "raw_bytes": bytes_hbm,
        "scan_corrected": False,
        "microbatch": microbatch, "fsdp": fsdp,
        "peak_memory_per_device": args_bytes + counted["temp_bytes"],
        "argument_bytes": args_bytes,
        "temp_bytes": counted["temp_bytes"],
        "collectives": coll,
        "model_flops": model_flops,
        "useful_flops_frac": (model_flops / (flops * n_chips)
                              if flops else None),
        **roofline_terms(flops, bytes_hbm, coll, peak),
    }


def saif_screen_gather_bytes(world: int, h: int, m: int = 1) -> int:
    """The output buffer of the screen's one gather (``_merge``): world x
    ``merge_payload_shape(m, h)`` int64."""
    from repro_torch.distributed.saif_sharded import merge_payload_shape
    return world * math.prod(merge_payload_shape(m, h)) * 8


def lower_saif_screen(mesh, *, n: int = 4096, log2_p: int = 26,
                      h: int = 64, dtype: str = "float32") -> Dict:
    """The paper-technique row: ``make_fused_screen`` with p = 2^log2_p
    features sharded over every mesh dim (each rank's n x p/W block): K1
    reads the block and its p/W column norms once (2 n p / W flops), and
    the ranks' top-h meet in one gather."""
    from repro_torch.kernels.screen.ref import BP
    W = _n_chips(mesh)
    p = 2 ** log2_p
    if p % W:
        raise ValueError(f"2^{log2_p} features do not split over {W} ranks")
    pl = p // W
    isz = torch.empty((), dtype=getattr(torch, dtype)).element_size()
    flops = 2.0 * n * pl
    bytes_hbm = float(isz * (n * pl + pl))
    coll = {_ALL_GATHER: float(saif_screen_gather_bytes(W, h))}
    peak = PEAK_FLOPS if dtype == "bfloat16" else PEAK_FLOPS_F32
    terms = roofline_terms(flops, bytes_hbm, coll, peak)
    # X block, norms, pad mask, theta, r; K1's outputs
    args = isz * (n * pl + pl + n + 1) + pl
    tiles = -(-pl // BP)
    temp = 3 * pl * isz + tiles * min(h, BP) * (isz + 4) + tiles * isz
    return {
        "arch": f"saif_screen_p2^{log2_p}_{dtype}", "shape": f"n{n}_h{h}",
        "mesh": _mesh_name(mesh), "n_chips": W, "compile_s": 0.0,
        "flops": flops, "bytes": bytes_hbm, "collectives": coll,
        "raw_flops": flops, "raw_bytes": bytes_hbm, "scan_corrected": False,
        "peak_memory_per_device": args + temp, "argument_bytes": args,
        "temp_bytes": temp, "local_shape": [n, pl],
        "model_flops": 2.0 * n * p,
        "useful_flops_frac": 2.0 * n * p / (flops * W),
        **terms,
    }


def _with_mesh(multi: bool, fn):
    """``fn`` on the production mesh over a fake group made for it."""
    init_fake_group(512 if multi else 256)
    try:
        return fn(make_production_mesh(multi_pod=multi))
    finally:
        destroy_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true",
                    help="run single-pod AND multi-pod for each cell")
    ap.add_argument("--out", default=None, help="write JSONL records here")
    ap.add_argument("--saif-screen", action="store_true",
                    help="only the SAIF screening-collective row")
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--no-corrected", action="store_true",
                    help="accepted for the reference's CLI; the port "
                         "counts every layer, so it changes nothing")
    args = ap.parse_args(argv)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    if args.saif_screen:
        records = []
        for multi in meshes:
            rec = _with_mesh(multi, lower_saif_screen)
            rec["status"] = "ok"
            records.append(rec)
            print(f"OK    saif_screen x {rec['mesh']}: "
                  f"dominant={rec['dominant']} "
                  f"compute={rec['compute_s']:.2e}s "
                  f"memory={rec['memory_s']:.2e}s "
                  f"coll={rec['collective_s']:.2e}s")
        if args.out:
            with open(args.out, "w") as f:
                for r in records:
                    f.write(json.dumps(r) + "\n")
        return 0

    from repro_torch.configs import ARCH_IDS, SHAPES, runnable_cells
    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shape_filter = list(SHAPES) if args.shape == "all" else [args.shape]
    cells = [(a, s, st) for a, s, st in runnable_cells()
             if a in archs and s in shape_filter]
    records = []

    def flush(rec):
        records.append(rec)
        if args.out:                      # incremental append (crash-safe)
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")

    n_fail = 0

    def run(mesh):
        nonlocal n_fail
        for arch, shape_name, status in cells:
            tag = f"{arch} x {shape_name} x {_mesh_name(mesh)}"
            if status != "run":
                print(f"SKIP  {tag}: {status}")
                flush({"arch": arch, "shape": shape_name,
                       "mesh": _mesh_name(mesh), "status": status})
                continue
            try:
                rec = lower_cell(arch, shape_name, mesh,
                                 microbatch=args.microbatch, fsdp=args.fsdp)
            except Exception as e:  # noqa: BLE001 - one cell's failure
                n_fail += 1
                print(f"FAIL  {tag}: {type(e).__name__}: {e}")
                traceback.print_exc()
                flush({"arch": arch, "shape": shape_name,
                       "mesh": _mesh_name(mesh), "status": f"fail: {e}"})
                continue
            rec["status"] = "ok"
            flush(rec)
            print(f"OK    {tag}: dominant={rec['dominant']} "
                  f"compute={rec['compute_s']:.2e}s "
                  f"memory={rec['memory_s']:.2e}s "
                  f"coll={rec['collective_s']:.2e}s "
                  f"peak_mem/dev="
                  f"{rec['peak_memory_per_device'] / 2**30:.2f}GiB "
                  f"(counted in {rec['compile_s']}s)")

    for multi in meshes:
        _with_mesh(multi, run)
    print(f"\n{len(records)} cells, {n_fail} failures")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
