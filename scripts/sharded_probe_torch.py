#!/usr/bin/env python3
"""Where a sharded request's time goes, on one NVIDIA card: the host cost
of the collectives and the host ops of the sharded solve against the
unsharded one, on the least-squares cell of ``chip_smoke.py`` (the paper's
Sec 5.1.1 simulation, n = 1000, p = 100,000, float64, 0.3 lambda_max,
``auto``).

    python3 scripts/sharded_probe_torch.py [--p 100000] [--pairs 3]

In one process: an NCCL group of one rank from a ``file://`` store in a
temporary directory, a 1-D mesh and one session. It prints
  * ``[pair i]``: the hot wall of the unsharded and of the sharded Scalar,
    in turns (each ends in a synchronize), and their outer steps; then
    the same for the smoke's 16-response Fleet (0.8 -> 0.3 lambda_max);
  * ``[comm ..]``: microseconds a call of each collective at the shapes
    an outer step gives it (the owner fetch of a (1000, 512) float64
    block, the screen's (1, 2, 65) int64 gather, its (1, 66) int32
    histogram sum), host time over 200 calls and with a synchronize;
  * ``[host ..]``: the host ops with the most self CPU time in one
    profiled Scalar of each kind, and the device's busy time.
"""
from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--p", type=int, default=100_000)
    ap.add_argument("--pairs", type=int, default=3)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("sharded_probe_torch: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.distributed.device_mesh import DeviceMesh
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    import repro_torch as rt
    from repro_torch.distributed import comm
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import init_group

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {cs.nvidia_smi_line()}; torch {torch.__version__}",
          flush=True)
    _build.build()
    Xn, yn = cs.simulation_data(cs.N, args.p)
    X = torch.from_numpy(Xn).cuda()
    y = torch.from_numpy(yn).cuda()
    del Xn
    ls = rt.get_loss("least_squares")
    lam = cs.LS_LAM * float(rt.lambda_max(ls, X, y))
    cfg = rt.SaifConfig(eps=1e-6)
    init_group(1, 0, tempfile.mkdtemp(prefix="sharded-probe-"),
               backend="nccl")
    try:
        sess = rt.open_session(rt.Problem(X=X, y=y), cfg,
                               mesh=DeviceMesh("cuda", torch.arange(1)))
        reqs = {"unsharded": rt.Scalar(lam),
                "sharded": rt.Scalar(lam, sharded=True)}
        Yf = cs.fleet_responses(X, cs.FLEET_LS[2], seed=100)
        fracs = np.geomspace(*cs.FLEET_LS).tolist()
        fl_lams = [f * float(rt.lambda_max(ls, X, yy))
                   for f, yy in zip(fracs, Yf)]
        fleets = {"fleet_unsharded": rt.Fleet(Y=Yf, lams=fl_lams),
                  "fleet_sharded": rt.Fleet(Y=Yf, lams=fl_lams,
                                            sharded=True)}
        for req in [*reqs.values(), *fleets.values()]:  # loads, NCCL
            sess.solve(req)
        for kind in (reqs, fleets):
            for i in range(args.pairs):
                order = list(kind) if i % 2 == 0 else list(kind)[::-1]
                line = []
                for name in order:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    res = sess.solve(kind[name])
                    torch.cuda.synchronize()
                    line.append(f"{name}_s={time.perf_counter() - t0:.4f} "
                                f"{name}_outer="
                                f"{int(torch.as_tensor(res.n_outer).max())}")
                print(f"[pair {i}] " + " ".join(line), flush=True)
        fg = sess._sharded.group
        k = sess.warm_capacity or 512
        shapes = {"sum_block": torch.randn(cs.N, k, dtype=torch.float64,
                                           device="cuda"),
                  "gather_payload": torch.zeros(1, 2, 65, dtype=torch.int64,
                                                device="cuda"),
                  "sum_hist": torch.zeros(1, 66, dtype=torch.int32,
                                          device="cuda")}
        for name, t in shapes.items():
            fn = ((lambda t=t: comm.all_gather_rows(fg, t))
                  if name.startswith("gather")
                  else (lambda t=t: comm.all_reduce_sum(fg, t)))
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            host = (time.perf_counter() - t0) / 200
            torch.cuda.synchronize()
            synced = (time.perf_counter() - t0) / 200
            print(f"[comm {name}] shape={tuple(t.shape)} host_us="
                  f"{host * 1e6:.1f} synced_us={synced * 1e6:.1f}",
                  flush=True)
        for name, req in reqs.items():
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                sess.solve(req)
                torch.cuda.synchronize()
            busy = sum(e.device_time_total for e in prof.events()
                       if e.device_type == DeviceType.CUDA) / 1e6
            top = sorted(prof.key_averages(),
                         key=lambda a: -a.self_cpu_time_total)
            rows = "; ".join(f"{a.key} {a.self_cpu_time_total / 1e3:.1f} ms "
                             f"x{a.count}" for a in top[:8])
            print(f"[host {name}] device_busy_s={busy:.4f} top self CPU: "
                  f"{rows}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
