"""The trainer's data parallelism with ZeRO-1 (``launch/train.py``:
``DataParallel``, ``make_train_step(..., dp=)``, the checkpoints,
preemption, the CLI) on two spawned gloo ranks, held against one
process.

  * stablelm_3b SMOKE, a global batch of 8 x 32, 3 steps: the ranks'
    losses within 1e-6 relative of one process's, and their parameters
    within 1e-6 relative of its, leaf by leaf. In float32 the measure is
    each leaf's norm of the difference over its norm: the ranks' averaged
    gradient differs from the one-process gradient in its last bits, and
    Adam's first step divides each entry by its own magnitude plus eps, so
    an entry whose gradient is near zero moves by up to 2 lr on such a
    difference (1.7e-5 of a leaf's largest entry here, in a few entries of
    thousands). With float64 weights and compute the gradients round to
    the same float32 update, and every entry is held to 1e-6 of its leaf's
    largest.
  * each rank's moments have ``zero1_spec``'s shard shape (the dims that
    the ranks divide), and the gathered moments are the one process's
    (same tolerances);
  * a checkpoint written under the 2 ranks (gathered, by rank 0) restores
    in one process (``train.resume``) to the ranks' parameters, gathered
    moments and data cursor, bit for bit;
  * SIGTERM sent to one rank alone, inside its second step: both ranks
    stop after that step and rank 0 writes the checkpoint (a rank that
    stopped alone would leave its peer in the next gradient all-reduce);
  * a step that raises over ranks is not retried (``StepFailed`` at
    once);
  * the CLI's ``main`` under the ranks' group trains and checkpoints, and
    a one-process ``main`` resumes from that checkpoint;
  * ``--model-parallel 2`` raises, naming the head-misaligned shards.
"""
import io
import os
import signal
import tempfile
import types
from contextlib import redirect_stdout

import pytest
import torch

from repro_torch.ckpt import checkpoint as t_ckpt
from repro_torch.configs import smoke_config
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch import mesh as TM
from repro_torch.launch import shardings as TS
from repro_torch.launch import train as T_train
from repro_torch.launch.steps import init_train_state, make_train_step
from repro_torch.models import lm as TL
from repro_torch.optim import adamw
from repro_torch.runtime.fault import StepFailed
from repro_torch.tree import leaf_paths

WORLD, STEPS, BATCH, SEQ = 2, 3, 8, 32
DTYPES = ("float32", "float64")
CLI = ["--arch", "stablelm_3b", "--smoke", "--batch", str(BATCH), "--seq",
       str(SEQ), "--lr", "1e-3", "--log-every", "1", "--device", "cpu"]


def _cfg(dtype):
    return smoke_config("stablelm_3b").scaled(dtype=dtype,
                                              param_dtype=dtype)


def _opt():
    return adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=STEPS)


def _data():
    return TokenPipeline(DataConfig(vocab=_cfg("float32").vocab,
                                    seq_len=SEQ, global_batch=BATCH,
                                    seed=0))


def _sigterm_at(step_fn, at):
    """``step_fn`` that sends this process SIGTERM as its call ``at``
    starts."""
    calls = [0]

    def step(state, batch):
        if calls[0] == at:
            os.kill(os.getpid(), signal.SIGTERM)
        calls[0] += 1
        return step_fn(state, batch)
    return step


def _fails_once(state, batch):
    raise RuntimeError("a transient fault")


def _rank_main(rank, store, out_dir):
    """One spawned rank: both dtypes through ``train_loop`` (float32 with
    a checkpoint at the last step), SIGTERM to rank 1 alone, a failing
    step, then the CLI's ``main``."""
    torch.set_num_threads(1)
    TM.init_group(WORLD, rank, store, timeout_s=60)
    try:
        out = {}
        for dtype in DTYPES:
            cfg = _cfg(dtype)
            dp = T_train.DataParallel(TM.make_host_mesh(), cfg)
            state = dp.shard_state(init_train_state(cfg, seed=0,
                                                    device="cpu"))
            ck = os.path.join(out_dir, "ckpt") if dtype == "float32" \
                else None
            run = T_train.train_loop(
                make_train_step(cfg, _opt(), dp=dp), state, _data(),
                start=0, steps=STEPS, ckpt_dir=ck, ckpt_every=STEPS,
                log_every=0, dp=dp)
            t_ckpt.wait_pending()
            full = dp.full_state(run.state)
            out[dtype] = {"losses": run.losses, "params": full.params,
                          "m": full.opt.m, "v": full.opt.v,
                          "m_local": {k: tuple(t.shape) for k, t in
                                      leaf_paths(run.state.opt.m)}}
        cfg = _cfg("float32")
        dp = T_train.DataParallel(TM.make_host_mesh(), cfg)
        state = dp.shard_state(init_train_state(cfg, seed=0, device="cpu"))
        step = make_train_step(cfg, _opt(), dp=dp)
        buf = io.StringIO()
        with redirect_stdout(buf):
            run = T_train.train_loop(
                _sigterm_at(step, 1) if rank == 1 else step, state, _data(),
                start=0, steps=STEPS, ckpt_dir=os.path.join(out_dir,
                                                            "preempt"),
                log_every=0, dp=dp)
        out["preempt"] = (run.preempted, len(run.losses), buf.getvalue())
        try:
            T_train.train_loop(_fails_once, state, _data(), start=0,
                               steps=1, log_every=0, dp=dp)
            out["retry"] = "returned"
        except StepFailed as e:
            out["retry"] = str(e)
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = T_train.main(CLI + ["--steps", "2", "--ckpt-dir",
                                     os.path.join(out_dir, "cli"),
                                     "--ckpt-every", "1"])
        out["cli"] = (rc, buf.getvalue())
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        TM.destroy_group()


@pytest.fixture(scope="module")
def ranks():
    ctx = torch.multiprocessing.get_context("spawn")
    d = tempfile.mkdtemp(prefix="train-dp-")
    procs = [ctx.Process(target=_rank_main, args=(r, d, d))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(240)
    codes = [p.exitcode for p in procs]
    assert codes == [0] * WORLD, codes
    return d, [torch.load(os.path.join(d, f"rank{r}.pt"))
               for r in range(WORLD)]


@pytest.fixture(scope="module")
def single():
    torch.set_num_threads(1)
    out = {}
    for dtype in DTYPES:
        cfg = _cfg(dtype)
        run = T_train.train_loop(make_train_step(cfg, _opt()),
                                 init_train_state(cfg, seed=0, device="cpu"),
                                 _data(), start=0, steps=STEPS, log_every=0)
        out[dtype] = {"losses": run.losses, "params": run.state.params,
                      "m": run.state.opt.m, "v": run.state.opt.v}
    return out


def _rel(got, want, dtype):
    """The worst leaf's relative difference (module docstring)."""
    worst = 0.0
    for (k, a), (_, b) in zip(leaf_paths(got), leaf_paths(want)):
        a, b = a.double(), b.double()
        if dtype == "float32":
            r = float((a - b).norm() / max(float(b.norm()), 1e-300))
        else:
            r = float((a - b).abs().max() / max(float(b.abs().max()),
                                                1e-300))
        worst = max(worst, r)
    return worst


@pytest.mark.parametrize("dtype", DTYPES)
def test_ranks_match_one_process(ranks, single, dtype):
    _, outs = ranks
    want = single[dtype]
    for o in outs:
        got = o[dtype]
        assert len(got["losses"]) == STEPS
        assert max(abs(a - b) / abs(b) for a, b in
                   zip(got["losses"], want["losses"])) <= 1e-6
        assert _rel(got["params"], want["params"], dtype) <= 1e-6
        for k in ("m", "v"):
            assert _rel(got[k], want[k], dtype) <= 1e-6, k
    # the ranks hold the same state
    for k in ("params", "m", "v"):
        for (_, a), (_, b) in zip(leaf_paths(outs[0]["float32"][k]),
                                  leaf_paths(outs[1]["float32"][k])):
            assert torch.equal(a, b)


def test_moments_have_zero1_shards(ranks):
    _, outs = ranks
    cfg = _cfg("float32")
    # the rules read only a mesh's shape and dim names: the ranks' mesh
    mesh = types.SimpleNamespace(shape=(WORLD, 1),
                                 mesh_dim_names=("data", "model"))
    shapes = TL.param_shapes(cfg)
    o_sh = dict(leaf_paths(TS.opt_shardings(
        TS.param_shardings(shapes, cfg, mesh), shapes, mesh)))
    split = 0
    for path, shape in leaf_paths(shapes):
        want = TS.local_shape(shape, o_sh[path], mesh)
        split += want != shape
        for o in outs:
            assert o["float32"]["m_local"][path] == want, path
    assert split > 0


def test_checkpoint_restores_in_one_process(ranks):
    d, outs = ranks
    cfg = _cfg("float32")
    data = _data()
    state, start = T_train.resume(os.path.join(d, "ckpt"),
                                  init_train_state(cfg, seed=1,
                                                   device="cpu"), data)
    assert start == STEPS and data.step == STEPS
    want = outs[0]["float32"]
    for got, ref in ((state.params, want["params"]),
                     (state.opt.m, want["m"]), (state.opt.v, want["v"])):
        for (k, a), (_, b) in zip(leaf_paths(got), leaf_paths(ref)):
            assert torch.equal(a, b), k
    assert int(state.opt.step) == STEPS


def test_sigterm_on_one_rank_stops_both(ranks):
    d, outs = ranks
    for o in outs:
        preempted, n_steps, log = o["preempt"]
        assert preempted and n_steps == 2
        assert "[preempt] SIGTERM received" in log
    assert t_ckpt.latest_step(os.path.join(d, "preempt")) == 2


def test_no_retry_over_ranks(ranks):
    _, outs = ranks
    for o in outs:
        assert o["retry"].startswith("step failed after 0 retries"), \
            o["retry"]


def _steps(out):
    return [ln for ln in out.splitlines() if ln.startswith("step ")]


def test_cli_under_ranks_then_one_process(ranks):
    d, outs = ranks
    (rc0, out0), (rc1, out1) = outs[0]["cli"], outs[1]["cli"]
    assert rc0 == rc1 == 0
    assert len(_steps(out0)) == 2 and "final loss" in out0
    assert out1 == ""                       # rank 0 logs
    assert t_ckpt.latest_step(os.path.join(d, "cli")) == 2
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert T_train.main(CLI + ["--steps", "4", "--ckpt-dir",
                                   os.path.join(d, "cli")]) == 0
    assert "[resume] restored step 2" in buf.getvalue()
    assert len(_steps(buf.getvalue())) == 2


def test_model_parallel_refused_names_the_reason():
    with pytest.raises(ValueError, match="head boundaries"):
        T_train.main(CLI + ["--steps", "1", "--model-parallel", "2"])
