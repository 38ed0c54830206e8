#!/usr/bin/env python3
"""Outer steps, support, certificates and wall time of the port's
least-squares solve on one NVIDIA card, on the paper's Sec 5.1.1
simulation at n = 1000 and full p, for a few lambda fractions.

    python3 scripts/ls_lambda_probe_torch.py --fracs 0.1 0.2 0.3 \
        --ways cuda-inner auto plain

Each (fraction, way) pair runs one ``saif`` with the default SaifConfig
(eps = 1e-6, max_outer = 2000); a solve counts as certified when its gap
is <= eps and its KKT residual over all p is <= 1e-3 lambda, both on the
card. Ways: ``cuda-inner`` (K1/K2 screen + K3 burst), ``auto`` (the
default backends) and ``plain`` (torch screen and inner, on the card).
The ways after the first run at a fraction only if the first took under
``--max-first`` seconds (the plain way takes about 15 times as long as
``cuda-inner``), and none runs once one has failed to certify. It shows
how far down the lambda path the port certifies within ``max_outer``,
which sets the lambda of the least-squares phase of ``chip_smoke.py``.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

WAYS = {"cuda-inner": {"inner_backend": "cuda"},
        "auto": {},
        "plain": {"screen_backend": "torch", "inner_backend": "torch"}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--p", type=int, default=100_000)
    ap.add_argument("--fracs", type=float, nargs="+",
                    default=[0.1, 0.2, 0.3])
    ap.add_argument("--ways", nargs="+", default=["cuda-inner"],
                    choices=list(WAYS))
    ap.add_argument("--max-first", type=float, default=10.0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("ls_lambda_probe_torch: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import repro_torch as rt
    from chip_smoke import N, nvidia_smi_line, simulation_data, support
    from repro_torch.core.duality import gap_precision_floor
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {nvidia_smi_line()}; torch {torch.__version__}",
          flush=True)
    _build.build()
    dev = torch.device("cuda")
    Xn, yn = simulation_data(N, args.p)
    X, y = torch.from_numpy(Xn).to(dev), torch.from_numpy(yn).to(dev)
    del Xn
    loss = rt.get_loss("least_squares")
    lm = float(rt.lambda_max(loss, X, y))
    cfg = rt.SaifConfig(eps=1e-6)
    for frac in args.fracs:
        lam = frac * lm
        sups = {}
        for way in args.ways:
            c = dataclasses.replace(cfg, **WAYS[way])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = rt.saif(X, y, lam, c)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            gap = float(res.gap)
            kkt = float(rt.kkt_residual(loss, X, y, res.beta, lam))
            ok = gap <= c.eps and kkt <= 1e-3 * lam
            sups[way] = support(res.beta)
            # the scale of the gap: the solver's own arithmetic floor of a
            # gap (8 eps_dtype 0.5 ||y - X beta||^2, the reference's
            # gap_precision_floor), and ||beta||_1, which turns a KKT
            # residual into a gap (gap <~ ||beta||_1 kkt)
            half_r2 = 0.5 * float(torch.sum((y - X @ res.beta) ** 2))
            floor = float(gap_precision_floor(
                (y - X @ res.beta) / lam, lam))
            tr = res.trace_gap[:res.n_outer]
            below = torch.nonzero(tr <= 1e-5).flatten()
            print(f"n={N} p={args.p} lam/lam_max={frac} way={way} "
                  f"outer={res.n_outer} max_outer={c.max_outer} "
                  f"n_active={res.n_active} k_max={res.active_idx.shape[0]}"
                  f" support={len(sups[way])} gap={gap:.3e} "
                  f"min_gap={float(tr.min()):.3e} first_outer_gap<=1e-5="
                  f"{int(below[0]) if below.numel() else None} "
                  f"half_resid_sq={half_r2:.6e} gap_floor={floor:.3e} "
                  f"beta_l1={float(res.beta.abs().sum()):.6e} "
                  f"kkt={kkt:.3e} kkt_limit={1e-3 * lam:.3e} certified={ok}"
                  f" wall_s={wall:.3f}", flush=True)
            if not ok or (way == args.ways[0] and wall > args.max_first):
                break
        if len(sups) > 1:
            first = next(iter(sups.values()))
            print(f"lam/lam_max={frac} supports identical across "
                  f"{list(sups)}: {all(s == first for s in sups.values())}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
