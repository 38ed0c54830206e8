"""The port's dry-run (``launch/dryrun.py``) and production mesh
(``launch/mesh.py::make_production_mesh``) on the CPU.

  * ``make_production_mesh`` over fake groups of 256 and 512 ranks gives
    the reference's mesh shapes and axis names, and raises without that
    group (none, or one of another size).
  * The reference's tests/test_dryrun.py::test_dryrun_whisper_prefill,
    adapted: ``python -m repro_torch.launch.dryrun --arch whisper_tiny
    --shape prefill_32k`` (``main`` in this process), single pod and
    multi-pod, writes one ``ok`` record with 256 / 512 chips, a dominant
    term, collective bytes (tensor parallelism communicates), a useful
    flop fraction in (0, 1.5), and ``flops == raw_flops > 0`` with
    ``scan_corrected`` False (the port counts every layer).
  * The screen row (the reference's ``test_saif_screen_row``):
    ``collective_s < 0.01 memory_s``; the same collective bytes at
    log2_p 20 and 26 (O(W h), not O(p)); and its gather bytes equal
    ``comm.BYTES`` of ``make_fused_screen`` on 2 spawned gloo ranks.
  * The collectives by a cell's kind: a train cell reduce-scatters and
    gathers (ZeRO-1), a decode cell over a sequence-sharded cache does
    not.
"""
import json
import os
import tempfile

import pytest
import torch

from repro_torch.distributed import comm
from repro_torch.launch import dryrun as TD
from repro_torch.launch import mesh as TM


@pytest.mark.parametrize("multi", [False, True], ids=["1pod", "2pod"])
def test_production_mesh(multi):
    n = 512 if multi else 256
    TM.init_fake_group(n)
    try:
        m = TM.make_production_mesh(multi_pod=multi)
        assert m.shape == ((2, 16, 16) if multi else (16, 16))
        assert m.mesh_dim_names == (("pod", "data", "model") if multi
                                    else ("data", "model"))
        assert m.size() == n and m.device_type == "cpu"
        with pytest.raises(RuntimeError, match=f"{768 - n} ranks"):
            TM.make_production_mesh(multi_pod=not multi)
    finally:
        TM.destroy_group()
    with pytest.raises(RuntimeError, match="there is none"):
        TM.make_production_mesh(multi_pod=multi)


@pytest.mark.parametrize("multi", [False, True], ids=["1pod", "2pod"])
def test_dryrun_whisper_prefill(tmp_path, multi):
    out = tmp_path / "rec.jsonl"
    argv = ["--arch", "whisper_tiny", "--shape", "prefill_32k",
            "--out", str(out)] + (["--multi-pod"] if multi else [])
    assert TD.main(argv) == 0
    recs = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert len(recs) == 1 and recs[0]["status"] == "ok"
    rec = recs[0]
    assert rec["n_chips"] == (512 if multi else 256)
    assert not rec["scan_corrected"]
    assert rec["flops"] == rec["raw_flops"] > 0
    assert rec["dominant"] in ("compute", "memory", "collective")
    assert rec["collective_bytes"] > 0      # TP really communicates
    assert 0 < rec["useful_flops_frac"] < 1.5
    assert rec["per_rank_batch"] == (1 if multi else 2)
    assert 0 < rec["argument_bytes"] < rec["peak_memory_per_device"]
    assert not torch.distributed.is_initialized()


def test_saif_screen_row(tmp_path):
    out = tmp_path / "rec.jsonl"
    assert TD.main(["--saif-screen", "--both-meshes", "--out",
                    str(out)]) == 0
    recs = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert [r["n_chips"] for r in recs] == [256, 512]
    for rec in recs:
        assert rec["status"] == "ok"
        # the screening collective is tiny by design (O(devs * h) wire
        # bytes, not O(p))
        assert rec["collective_s"] < 0.01 * rec["memory_s"]
        assert rec["collective_bytes"] == TD.saif_screen_gather_bytes(
            rec["n_chips"], 64)
    assert recs[0]["collective_bytes"] == 266_240
    assert recs[0]["local_shape"] == [4096, 2 ** 26 // 256]
    TM.init_fake_group(256)
    try:
        mesh = TM.make_production_mesh()
        small = TD.lower_saif_screen(mesh, log2_p=20)
        big = TD.lower_saif_screen(mesh, log2_p=26)
    finally:
        TM.destroy_group()
    assert small["collectives"] == big["collectives"]
    assert big["memory_s"] == pytest.approx(64 * small["memory_s"],
                                            rel=1e-3)


H, N, P = 8, 16, 64


def _screen_rank(rank, world, store, out_dir):
    """One spawned rank: a (N, P) design sharded over ``world`` ranks, one
    ``make_fused_screen`` call, its collectives' bytes."""
    torch.set_num_threads(1)
    from repro_torch.distributed import saif_sharded as ss
    TM.init_group(world, rank, store, timeout_s=60)
    try:
        g = torch.Generator().manual_seed(0)
        X = torch.randn(N, P, generator=g, dtype=torch.float64)
        y = torch.randn(N, generator=g, dtype=torch.float64)
        design = ss.shard_design(X, y, TM.make_host_mesh(), "cpu")
        screen = ss.make_fused_screen(design, H)
        comm.reset_calls()
        res = screen(y / N, 0.1)
        torch.save({"calls": dict(comm.CALLS), "bytes": dict(comm.BYTES),
                    "top": res.top_idx},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        TM.destroy_group()


def test_screen_gather_bytes_match_a_run():
    world = 2
    ctx = torch.multiprocessing.get_context("spawn")
    d = tempfile.mkdtemp(prefix="dryrun-screen-")
    procs = [ctx.Process(target=_screen_rank, args=(r, world, d, d))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(120)
    assert [p.exitcode for p in procs] == [0] * world
    outs = [torch.load(os.path.join(d, f"rank{r}.pt"))
            for r in range(world)]
    for o in outs:
        assert o["calls"] == {"gather": 1, "sum": 0, "max": 0}
        assert o["bytes"] == {"gather": TD.saif_screen_gather_bytes(
            world, H), "sum": 0, "max": 0}
    assert torch.equal(outs[0]["top"], outs[1]["top"])


def test_collectives_by_cell_kind():
    """A train cell's ZeRO-1 data parallelism reduce-scatters and gathers
    (2 pods: the batch over pod x data, 8 rows a rank); a decode cell over
    a sequence-sharded cache only all-reduces (no optimizer state)."""
    TM.init_fake_group(512)
    try:
        mesh = TM.make_production_mesh(multi_pod=True)
        train = TD.lower_cell("whisper_tiny", "train_4k", mesh)
        decode = TD.lower_cell("whisper_tiny", "decode_32k", mesh)
    finally:
        TM.destroy_group()
    assert train["per_rank_batch"] == 8 and decode["per_rank_batch"] == 4
    assert set(train["collectives"]) == {"all-reduce", "all-gather",
                                         "reduce-scatter"}
    assert "reduce-scatter" not in decode["collectives"]
    assert decode["collectives"]["all-reduce"] > 0
    assert train["argument_bytes"] > 0 and decode["argument_bytes"] > 0
