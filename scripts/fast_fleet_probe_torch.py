#!/usr/bin/env python3
"""Time the fast-parity fleet (``parity="fast"``) at ``chip_smoke.py``'s
``[fleet-fast/..]`` cell on one NVIDIA card, so that two source trees
can be compared in one call:

    python3 scripts/fast_fleet_probe_torch.py                  # this tree
    python3 scripts/fast_fleet_probe_torch.py --src OTHER/src --tag other

The cell: the least-squares design of the smoke (n = 1000, p = 100,000,
float64), its 16 fleet responses and lambda_b from 0.8 down to 0.3 of
each lambda_max. Per screen dtype (working, float32, bfloat16) the fleet
is solved twice to warm up, then ``--reps`` times, each timed to
``torch.cuda.synchronize()``; the line gives the median, the quartiles
and the least wall, the outer steps and host reads of the last solve,
and every row's gap. One line a dtype, then the card's name and power
limit.
"""
import argparse
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="this")
    ap.add_argument("--reps", type=int, default=15)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    import chip_smoke as smoke
    import repro_torch as rt
    from repro_torch.core.batch_fast import solve_fleet_fast

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    X, _ = smoke.simulation_data(smoke.N, 100_000)
    X = torch.from_numpy(X).cuda()
    first, last, b = smoke.FLEET_LS
    Y = smoke.fleet_responses(X, b, seed=100)
    ls = rt.get_loss("least_squares")
    fracs = np.geomspace(first, last, b)
    lams = [float(f) * float(rt.lambda_max(ls, X, y))
            for f, y in zip(fracs, Y)]
    for mode in ("working", "float32", "bfloat16"):
        cfg = rt.SaifConfig(eps=1e-6, parity="fast", screen_dtype=mode)
        for _ in range(2):
            rt.fleet_solve(X, Y, lams, cfg)
        walls = []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = rt.fleet_solve(X, Y, lams, cfg)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        q1, med, q3 = statistics.quantiles(walls, n=4)
        st = solve_fleet_fast.stats
        print(f"[fast-fleet-probe {args.tag} {mode}] reps={args.reps} "
              f"median_s={med:.5f} q1_s={q1:.5f} q3_s={q3:.5f} "
              f"min_s={min(walls):.5f} outer_steps={st['steps']} "
              f"host_reads={st['host_reads']} escalated_rows="
              f"{st['escalated_rows']} max_gap={float(res.gap.max()):.3e}",
              flush=True)
    print(smoke.nvidia_smi_line(), flush=True)


if __name__ == "__main__":
    main()
