"""End-to-end trainer (port of ``repro.launch.train``): a
fault-tolerant train loop over any zoo architecture (reduced or full
config), on the card unless given ``--device cpu``.

  * checkpoint/resume: atomic, an async flush every ``--ckpt-every``
    steps, the data cursor in the checkpoint's ``extra`` (replay);
  * preemption: SIGTERM -> checkpoint -> clean exit;
  * straggler monitoring and step retry (``retry_step``, two retries: the
    train step is out of place, so a retry starts from the same state).

The straggler monitor times a step to the host read of its loss (the
reference's timer stops at dispatch). ``--model-parallel`` above 1 raises
until the shardings are ported. On the CPU the config is scaled to
float32, as the reference does. Gradient compression
(``optim/compress.py``) is a library function; the trainer has no flag for
it.

Example (CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm_3b \\
      --smoke --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ck --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import List, NamedTuple, Optional

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.data.pipeline import TokenPipeline, to_device
from repro_torch.launch.steps import TrainState
from repro_torch.optim import adamw
from repro_torch.runtime.fault import (PreemptionGuard, StragglerMonitor,
                                       retry_step)
from repro_torch.tree import leaves


class TrainRun(NamedTuple):
    state: TrainState
    losses: List[float]
    grad_norms: List[float]  # each step's gradient norm before clipping
    step_s: List[float]      # each step's seconds, to its loss's host read
    preempted: bool


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


def _save(save, ckpt_dir, step, state, data):
    save(ckpt_dir, step, state,
         extra={"train_step": step, "data": data.state()})


def train_loop(train_step, state: TrainState, data: TokenPipeline, *,
               start: int, steps: int, ckpt_dir: Optional[str] = None,
               ckpt_every: int = 25, log_every: int = 10) -> TrainRun:
    """Steps ``start`` .. ``steps - 1`` of ``train_step`` on ``data``'s
    batches, on the device of ``state``'s parameters: each step retried
    twice on a ``RuntimeError``, timed to its loss's host read, an async
    checkpoint after every ``ckpt_every``-th step, and on SIGTERM a
    synchronous checkpoint and an early return (``preempted``). The loop
    holds two states at most (the current one and a step's new one): a
    caller that keeps a reference to ``state`` holds a third."""
    device = leaves(state.params)[0].device
    guard = PreemptionGuard()
    monitor = StragglerMonitor(
        on_straggler=lambda s, t, m: print(
            f"[straggler] step {s}: {t:.2f}s vs median {m:.2f}s"))
    losses, norms, step_s = [], [], []
    try:
        for step in range(start, steps):
            batch = to_device(data.next_batch(), device)

            def run(state=state, batch=batch):
                return train_step(state, batch)

            t0 = time.monotonic()
            state, loss, norm = retry_step(run, max_retries=2)
            loss = float(loss)
            step_s.append(time.monotonic() - t0)
            monitor.record(step_s[-1])
            losses.append(loss)
            norms.append(float(norm))

            if log_every and step % log_every == 0:
                print(f"step {step:5d} loss {loss:.4f}", flush=True)
            if ckpt_dir and (step + 1) % ckpt_every == 0:
                _save(ckpt.save_async, ckpt_dir, step + 1, state, data)
            if guard.preempted:
                print("[preempt] SIGTERM received: checkpoint + exit",
                      flush=True)
                if ckpt_dir:
                    _save(ckpt.save, ckpt_dir, step + 1, state, data)
                return TrainRun(state, losses, norms, step_s, True)
    finally:
        guard.uninstall()
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

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core.saif import resolve_device
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.steps import init_train_state, make_train_step

    if args.model_parallel != 1:
        raise ValueError("--model-parallel above 1 needs the parameter "
                         "shardings (launch/shardings.py), not ported yet")
    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if dev.type == "cpu":
        cfg = cfg.scaled(dtype="float32")
    opt_cfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=10,
                                total_steps=args.steps)
    data = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                    global_batch=args.batch, seed=args.seed))
    state, start = init_train_state(cfg, seed=args.seed, device=dev), 0
    if args.ckpt_dir:
        state, start = resume(args.ckpt_dir, state, data)
    # hand the state over: kept here too, it would be a third copy
    hand = [state]
    del state
    out = train_loop(make_train_step(cfg, opt_cfg), hand.pop(), data,
                     start=start, steps=args.steps, ckpt_dir=args.ckpt_dir,
                     ckpt_every=args.ckpt_every, log_every=args.log_every)
    ckpt.wait_pending()
    if out.preempted:
        return 0
    if args.ckpt_dir:
        _save(ckpt.save, args.ckpt_dir, args.steps, out.state, data)
    if out.losses:
        print(f"final loss {out.losses[-1]:.4f} "
              f"(first {out.losses[0]:.4f}) over {len(out.losses)} steps")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
