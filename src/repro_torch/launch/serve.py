"""CLI over the async serving front end (port of ``repro.launch.serve``).

A thin argparse layer that opens :func:`repro_torch.open_server` and
drives it with a small seeded synthetic request mix: the smoke-test entry
point of the queue -> shape bucket -> microbatch -> fleet pipeline. It runs
on the card unless given ``--device cpu``. Exits 0 when every request was
served with a certified verdict.

Example:
  PYTHONPATH=src python -m repro_torch.launch.serve --requests 32 \\
      --max-batch 8 --max-wait-ms 5 --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="SAIF async serving smoke driver")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--problems", type=int, default=3,
                    help="distinct problem shapes in the mix")
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--p", type=int, default=96)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    ap.add_argument("--max-sessions", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain path (default: the card)")
    args = ap.parse_args(argv)

    from repro_torch import Problem, SaifConfig, Scalar, open_server

    server = open_server(
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        max_sessions=args.max_sessions, solver=SaifConfig(),
        device=args.device)

    rng = np.random.default_rng(args.seed)
    problems = []
    for k in range(args.problems):
        n = args.n - 8 * k
        p = args.p - 8 * k
        X = rng.normal(size=(n, p))
        y = rng.normal(size=n)
        problems.append(Problem(X=X, y=y))

    t0 = time.monotonic()
    futs = []
    for _ in range(args.requests):
        prob = problems[int(rng.integers(len(problems)))]
        lam = float(rng.uniform(0.03, 0.12))
        futs.append(server.submit(prob, Scalar(lam)))
    results = [f.result(timeout=600) for f in futs]
    dt = time.monotonic() - t0
    server.drain()
    stats = server.stats()
    server.close()

    ok = sum(1 for r in results if r.verdict.ok)
    print(f"served {stats.served}/{stats.submitted} requests in "
          f"{dt:.2f}s ({stats.served / dt:.1f} req/s); "
          f"{ok} certified ok")
    print(f"coalesced {stats.coalesced_requests} requests into "
          f"{stats.coalesced_batches} microbatches; "
          f"{stats.sessions_opened} sessions opened "
          f"({stats.evictions} evicted)")
    return 0 if ok == len(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
