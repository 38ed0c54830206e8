#!/usr/bin/env python3
"""Outer steps, support, certificates and wall time of the port's fused
LASSO solve on one NVIDIA card, on the chain problem of
benchmarks/bench_fused.py at n = 1000, for a few p and lambda fractions.

    python3 scripts/fused_lambda_probe_torch.py --p 5000 10000 \
        --fracs 0.5 0.3 0.1 --losses least_squares logistic --path

Each (loss, p, fraction, way) runs one ``saif_fused`` with the default
SaifConfig (eps = 1e-6, max_outer = 2000) on the chain tree; least squares
uses y = X beta + 0.1 noise, logistic the labels sign(X beta + 0.3 noise)
(chip_smoke.fused_chain_data). A solve counts as certified when its gap is
<= eps and its KKT residual over all p transformed coordinates, with b's
l1 weight 0, is <= 1e-3 lambda, both on the card. Ways: ``auto`` (K4
transform, K1/K2 screen, K3-pen burst) and ``plain`` (torch transform,
screen and inner, on the card). ``--path`` also runs ``fused_path`` over
chip_smoke.FUSED_PATH on each least-squares problem and prints the support
per lambda. It shows where the port certifies fused chains, which sets
the size and lambdas of the fused phases of ``chip_smoke.py``.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

WAYS = {"auto": ({}, "auto"),
        "plain": ({"screen_backend": "torch", "inner_backend": "torch"},
                  "torch")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--p", type=int, nargs="+", default=[5000, 10000])
    ap.add_argument("--fracs", type=float, nargs="+", default=[0.3, 0.1])
    ap.add_argument("--losses", nargs="+",
                    default=["least_squares", "logistic"],
                    choices=["least_squares", "logistic"])
    ap.add_argument("--ways", nargs="+", default=["auto"],
                    choices=list(WAYS))
    ap.add_argument("--path", action="store_true")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("fused_lambda_probe_torch: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import repro_torch as rt
    from chip_smoke import FUSED_PATH, fused_chain_data, nvidia_smi_line
    from chip_smoke import support
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {nvidia_smi_line()}; torch {torch.__version__}",
          flush=True)
    _build.build()
    dev = torch.device("cuda")
    cfg0 = rt.SaifConfig(eps=1e-6)
    for p in args.p:
        parent = np.arange(p) - 1
        Xn, _ = fused_chain_data(args.n, p)
        X = torch.from_numpy(Xn).to(dev)
        del Xn
        Xt = rt.prepare_fused(X, parent).Xt
        pen = torch.ones(p, dtype=X.dtype, device=dev)
        pen[p - 1] = 0.0
        for loss_name in args.losses:
            y = torch.from_numpy(fused_chain_data(
                args.n, p, logistic=loss_name == "logistic")[1]).to(dev)
            loss = rt.get_loss(loss_name)
            lm = rt.fused_lambda_max(X, y, parent, loss=loss_name)
            for frac in args.fracs:
                lam = frac * lm
                sups = {}
                for way in args.ways:
                    over, tb = WAYS[way]
                    c = dataclasses.replace(cfg0, loss=loss_name, **over)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    _, res = rt.saif_fused(X, y, parent, lam, c,
                                           transform_backend=tb)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    gap = float(res.gap)
                    kkt = float(rt.kkt_residual(loss, Xt, y, res.beta, lam,
                                                pen))
                    ok = gap <= c.eps and kkt <= 1e-3 * lam
                    sups[way] = support(res.beta)
                    tr = res.trace_gap[:res.n_outer]
                    marks = {t: float(tr[t - 1]) for t in (500, 1000, 2000)
                             if t <= res.n_outer}
                    print(f"loss={loss_name} n={args.n} p={p} "
                          f"lam/lam_max={frac} way={way} outer={res.n_outer}"
                          f" max_outer={c.max_outer} n_active={res.n_active}"
                          f" k_max={res.active_idx.shape[0]} "
                          f"support={sorted(sups[way])[:8]}"
                          f"{'...' if len(sups[way]) > 8 else ''} "
                          f"({len(sups[way])}) gap={gap:.3e} "
                          f"gap_at_outer={marks} kkt={kkt:.3e} "
                          f"kkt_limit={1e-3 * lam:.3e} certified={ok} "
                          f"wall_s={wall:.3f}", flush=True)
                if len(sups) > 1:
                    first = next(iter(sups.values()))
                    print(f"lam/lam_max={frac} supports identical across "
                          f"{list(sups)}: "
                          f"{all(s == first for s in sups.values())}",
                          flush=True)
            if args.path and loss_name == "least_squares":
                hi, lo, m = FUSED_PATH
                lams = np.geomspace(hi * lm, lo * lm, m)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fp = rt.fused_path(X, y, parent, lams, cfg0)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                for lam, r in zip(fp.lams, fp.path.results):
                    kkt = float(rt.kkt_residual(loss, Xt, y, r.beta, lam,
                                                pen))
                    print(f"path p={p} lam/lam_max={lam / lm:.4f} "
                          f"outer={r.n_outer} support={len(support(r.beta))}"
                          f" gap={float(r.gap):.3e} kkt={kkt:.3e} "
                          f"kkt_limit={1e-3 * lam:.3e}", flush=True)
                print(f"path p={p} wall_s={wall:.3f}", flush=True)
        del X, Xt
    return 0


if __name__ == "__main__":
    sys.exit(main())
