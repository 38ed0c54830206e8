"""End-to-end trainer (port of ``repro.launch.train``): a
fault-tolerant train loop over any zoo architecture (reduced or full
config), on the card unless given ``--device cpu``.

  * checkpoint/resume: atomic, an async flush every ``--ckpt-every``
    steps, the data cursor in the checkpoint's ``extra`` (replay);
  * preemption: SIGTERM -> checkpoint -> clean exit;
  * straggler monitoring and step retry (``retry_step``, two retries: the
    train step is out of place, so a retry starts from the same state;
    none over ranks, where a rank that failed after a collective would
    issue it again while its peers wait in the next one).

The straggler monitor times a step to the host read of its loss (the
reference's timer stops at dispatch). On the CPU the config is scaled to
float32, as the reference does. Gradient compression
(``optim/compress.py``) is a library function; the trainer has no flag for
it.

Data parallelism (the reference places the parameters and AdamW's moments
by ``param_shardings`` / ``opt_shardings`` on its host mesh): when the
default process group holds more than one rank, the trainer runs over
``make_host_mesh(model=1)`` (:class:`DataParallel`). Each rank takes its
rows of the global batch by ``batch_spec``, the gradients are summed over
the ranks (``distributed/comm.py``, one all-reduce a step) and divided by
their count, the clip norm is taken over those full gradients, and AdamW's
``m`` and ``v`` are held ZeRO-1 by ``opt_shardings``: each rank updates
its slice of each leaf (on the first free dim the ranks divide) and the
parameters are all-gathered. (The dry-run's record reckons ZeRO-1 as a
reduce-scatter of the gradients; this trainer all-reduces them whole.)
A checkpoint gathers the whole state and rank 0 writes it, so a restore
fits any rank count. Preemption is decided together: each rank's SIGTERM
flag rides in the gradients' all-reduce, and every rank stops after the
step in which any rank had one, so the gathers of the checkpoint meet. The group comes from
the caller (``launch/mesh.py::init_group``, as the tests make it) or, for
the CLI, from ``torchrun``'s environment (``WORLD_SIZE`` > 1: an
``env://`` group, NCCL on the card with one card a rank by
``LOCAL_RANK``, gloo with ``--device cpu``). One rank runs exactly the
single-process trainer. ``--model-parallel`` above 1 raises: eager tensor
parallelism is not ported (:data:`MODEL_PARALLEL_REFUSED`).

Example (CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm_3b \\
      --smoke --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ck --device cpu
  PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \\
      -m repro_torch.launch.train --arch stablelm_3b --smoke --steps 50 \\
      --device cpu
"""
from __future__ import annotations

import argparse
import os
import time
from typing import List, NamedTuple, Optional

import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.data.pipeline import TokenPipeline, to_device
from repro_torch.distributed import comm
from repro_torch.launch import shardings
from repro_torch.launch.steps import TrainState, value_and_grad
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.runtime.fault import (PreemptionGuard, StragglerMonitor,
                                       retry_step)
from repro_torch.tree import leaves, tree_map

MODEL_PARALLEL_REFUSED = (
    "--model-parallel above 1 needs eager tensor parallelism, which is not "
    "ported: the reference's rules shard H*hd wherever the model axis "
    "divides it, not on head boundaries (hymba's 25 heads of 64 split into "
    "16 shards of 100 columns), which XLA reshards and DTensor's eager "
    "reshapes refuse")


class TrainRun(NamedTuple):
    state: TrainState
    losses: List[float]
    grad_norms: List[float]  # each step's gradient norm before clipping
    step_s: List[float]      # each step's seconds, to its loss's host read
    preempted: bool


class DataParallel:
    """ZeRO-1 data parallelism over a (data=W, model=1) host mesh covering
    every rank of the default group (module docstring). ``dims`` holds,
    for each parameter leaf, the dim ``opt_shardings`` splits its moments
    on over the ranks (None: the leaf's moments stay whole and every rank
    updates all of it)."""

    def __init__(self, mesh, cfg):
        self.mesh = mesh
        self.group = comm.feature_group(mesh)
        self.world, self.index = self.group.size, self.group.index
        self.guard = None       # train_loop's PreemptionGuard while it runs
        self._stop = None       # the ranks' summed flags, from :meth:`mean`
        shapes = lm.param_shapes(cfg)
        o_sh = shardings.opt_shardings(
            shardings.param_shardings(shapes, cfg, mesh), shapes, mesh)

        def dim(plc, shape):
            axes = shardings.axes_by_dim(plc, mesh, len(shape))
            return next((d for d, a in enumerate(axes) if "data" in a),
                        None)
        self.dims = tree_map(dim, o_sh, shapes)

    def rows(self, batch):
        """This rank's rows of a global batch, by ``batch_spec``."""
        B = next(iter(batch.values())).shape[0]
        b = shardings.local_shape((B,), shardings.batch_spec(self.mesh, B),
                                  self.mesh)[0]
        if b == B:
            return batch
        return {k: v[self.index * b:(self.index + 1) * b]
                for k, v in batch.items()}

    def shard(self, tree):
        """This rank's slice of each leaf of a parameter-shaped tree."""
        def one(t, d):
            return t if d is None else t.chunk(self.world, d)[self.index]
        return tree_map(one, tree, self.dims)

    def gather(self, tree):
        """The whole leaves of a tree of this rank's slices: one gather of
        every rank's slices, flattened in leaf order (the slices of a leaf
        have one shape on every rank)."""
        dims = leaves(self.dims)
        parts = leaves(tree)
        split = [i for i, d in enumerate(dims) if d is not None]
        if not split:
            return tree
        flat = torch.cat([parts[i].reshape(-1) for i in split])
        every = comm.all_gather_rows(self.group, flat[None])[:, 0]
        whole, at = list(parts), 0
        for i in split:
            n = parts[i].numel()
            whole[i] = torch.cat([every[r, at:at + n].view(parts[i].shape)
                                  for r in range(self.world)], dims[i])
            at += n
        it = iter(whole)
        return tree_map(lambda _: next(it), tree)

    def mean(self, loss, grads):
        """Every rank's loss and gradients, summed in one all-reduce and
        divided by the rank count. The same buffer carries this rank's
        preemption flag (``guard``), read back by :meth:`stopping`."""
        parts = leaves(grads)
        dt = parts[0].dtype
        flag = float(self.guard is not None and self.guard.preempted)
        flat = torch.cat([loss.to(dt).reshape(1)]
                         + [g.to(dt).reshape(-1) for g in parts]
                         + [loss.new_full((1,), flag, dtype=dt)])
        flat = comm.all_reduce_sum(self.group, flat).div_(self.world)
        self._stop = flat[-1].clone()   # not a view: the buffer goes
        out, at = [], 1
        for g in parts:
            out.append(flat[at:at + g.numel()].view(g.shape).to(g.dtype))
            at += g.numel()
        it = iter(out)
        return flat[0].to(loss.dtype), tree_map(lambda _: next(it), grads)

    def stopping(self) -> bool:
        """Whether any rank had been sent SIGTERM when the last step's
        gradients were reduced: the same answer on every rank."""
        return self._stop is not None and bool(self._stop > 0)

    def shard_state(self, state: TrainState) -> TrainState:
        """A whole state with its moments cut to this rank's slices."""
        opt = state.opt._replace(m=self.shard(state.opt.m),
                                 v=self.shard(state.opt.v))
        return TrainState(state.params, opt)

    def full_state(self, state: TrainState) -> TrainState:
        """The whole state: the moments gathered from every rank (a
        collective: every rank calls it)."""
        opt = state.opt._replace(m=self.gather(state.opt.m),
                                 v=self.gather(state.opt.v))
        return TrainState(state.params, opt)


def resume(ckpt_dir: str, state: TrainState, data: TokenPipeline
           ) -> tuple[TrainState, int]:
    """The latest checkpoint under ``ckpt_dir`` restored into ``state``'s
    structure, devices and dtypes, with the data cursor restored into
    ``data``: (state, step to start from). Without one: (state, 0)."""
    last = ckpt.latest_step(ckpt_dir)
    if last is None:
        return state, 0
    state, extra = ckpt.restore(ckpt_dir, last, state)
    data.restore(extra["data"])
    start = int(extra["train_step"])
    print(f"[resume] restored step {start} from {ckpt_dir}", flush=True)
    return state, start


def _save(save, ckpt_dir, step, state, data, dp=None):
    """Checkpoint ``state`` (under ``dp``, every rank gathers the whole
    state and rank 0 writes it)."""
    if dp is not None:
        state = dp.full_state(state)
        if dp.index != 0:
            return
    save(ckpt_dir, step, state,
         extra={"train_step": step, "data": data.state()})


def train_loop(train_step, state: TrainState, data: TokenPipeline, *,
               start: int, steps: int, ckpt_dir: Optional[str] = None,
               ckpt_every: int = 25, log_every: int = 10,
               dp: Optional[DataParallel] = None) -> TrainRun:
    """Steps ``start`` .. ``steps - 1`` of ``train_step`` on ``data``'s
    batches, on the device of ``state``'s parameters: each step retried
    twice on a ``RuntimeError``, timed to its loss's host read, an async
    checkpoint after every ``ckpt_every``-th step, and on SIGTERM a
    synchronous checkpoint and an early return (``preempted``). Under
    ``dp`` (with ``make_train_step(..., dp=dp)``) a step is not retried,
    a checkpoint holds the gathered state, written by rank 0, and every
    rank returns after the step in which any rank was preempted
    (:meth:`DataParallel.stopping`). The loop
    holds two states at most (the current one and a step's new one): a
    caller that keeps a reference to ``state`` holds a third."""
    device = leaves(state.params)[0].device
    guard = PreemptionGuard()
    monitor = StragglerMonitor(
        on_straggler=lambda s, t, m: print(
            f"[straggler] step {s}: {t:.2f}s vs median {m:.2f}s"))
    losses, norms, step_s = [], [], []
    if dp is not None:
        dp.guard, dp._stop = guard, None
    try:
        for step in range(start, steps):
            batch = to_device(data.next_batch(), device)

            def run(state=state, batch=batch):
                return train_step(state, batch)

            t0 = time.monotonic()
            state, loss, norm = retry_step(
                run, max_retries=2 if dp is None else 0)
            loss = float(loss)
            step_s.append(time.monotonic() - t0)
            monitor.record(step_s[-1])
            losses.append(loss)
            norms.append(float(norm))

            if log_every and step % log_every == 0:
                print(f"step {step:5d} loss {loss:.4f}", flush=True)
            if ckpt_dir and (step + 1) % ckpt_every == 0:
                _save(ckpt.save_async, ckpt_dir, step + 1, state, data, dp)
            if guard.preempted if dp is None else dp.stopping():
                print("[preempt] SIGTERM received: checkpoint + exit",
                      flush=True)
                if ckpt_dir:
                    _save(ckpt.save, ckpt_dir, step + 1, state, data, dp)
                return TrainRun(state, losses, norms, step_s, True)
    finally:
        guard.uninstall()
        if dp is not None:
            dp.guard = None
    return TrainRun(state, losses, norms, step_s, False)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain path (default: the card)")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core.saif import resolve_device
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.mesh import destroy_group, make_host_mesh
    from repro_torch.launch.steps import init_train_state, make_train_step

    if args.model_parallel != 1:
        raise ValueError(MODEL_PARALLEL_REFUSED)
    dev = resolve_device(args.device)
    own_group = (not dist.is_initialized()
                 and int(os.environ.get("WORLD_SIZE", "1")) > 1)
    if own_group:                           # torchrun's environment
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    try:
        cfg = smoke_config(args.arch) if args.smoke \
            else get_config(args.arch)
        if dev.type == "cpu":
            cfg = cfg.scaled(dtype="float32")
        dp = (DataParallel(make_host_mesh(model=1), cfg)
              if dist.is_initialized() and dist.get_world_size() > 1
              else None)
        opt_cfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=10,
                                    total_steps=args.steps)
        data = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                        global_batch=args.batch,
                                        seed=args.seed))
        state, start = init_train_state(cfg, seed=args.seed, device=dev), 0
        if args.ckpt_dir:
            state, start = resume(args.ckpt_dir, state, data)
        if dp is not None:
            state = dp.shard_state(state)
        step = make_train_step(cfg, opt_cfg, dp=dp)
        # hand the state over: kept here too, it would be a third copy
        hand = [state]
        del state
        log_every = args.log_every if dp is None or dp.index == 0 else 0
        out = train_loop(step, hand.pop(), data, start=start,
                         steps=args.steps, ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every, log_every=log_every,
                         dp=dp)
        ckpt.wait_pending()
        if out.preempted:
            return 0
        if args.ckpt_dir:
            _save(ckpt.save, args.ckpt_dir, args.steps, out.state, data, dp)
        if out.losses and (dp is None or dp.index == 0):
            print(f"final loss {out.losses[-1]:.4f} "
                  f"(first {out.losses[0]:.4f}) over {len(out.losses)} "
                  f"steps")
        return 0
    finally:
        if own_group:
            destroy_group()


if __name__ == "__main__":
    raise SystemExit(main())
