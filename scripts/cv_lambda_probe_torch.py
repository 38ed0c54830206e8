#!/usr/bin/env python3
"""How far down the lambda grid the port's cross-validation certifies on
one NVIDIA card, and where its CV minimum lies, on the design and response
of the ``[cv-ls]`` phase of ``chip_smoke.py`` (the Sec 5.1.1 simulation at
n = 1000, p = 100,000, float64; a response with 15 true features in
[-1, 1] and N(0, 1) noise).

    python3 scripts/cv_lambda_probe_torch.py --lo 0.01 --points 20

One ``cv_solve`` (5 folds, ``inner_backend="auto"``, eps = 1e-6) runs over
the geometric grid from 0.9 down to ``--lo`` lambda_max. For every lambda
it prints each fold's outer steps, active count, gap and weighted KKT
residual (a cell counts as certified when gap <= eps and KKT <= 1e-3
lambda), the held-out error and its standard error; then the wall, the
minimum and 1-SE lambdas and the refit's certificate. With ``--select`` it
also runs the stability fleet (16 half subsamples) at the 1-SE lambda, as
``select_solve`` does, and prints each subsample's gap and active count. The lowest fraction at which every
cell certifies, and the place of the CV minimum, set ``CV_GRID`` in
``chip_smoke.py``.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--p", type=int, default=100_000)
    ap.add_argument("--lo", type=float, default=0.01)
    ap.add_argument("--points", type=int, default=20)
    ap.add_argument("--select", action="store_true")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("cv_lambda_probe_torch: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import repro_torch as rt
    from chip_smoke import (CV_FOLDS, N, SELECT_SUBSAMPLES, fleet_responses,
                            nvidia_smi_line, simulation_data, support,
                            weighted_cert)
    from repro_torch.kernels import _build, ops

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {nvidia_smi_line()}; torch {torch.__version__}",
          flush=True)
    _build.build()
    dev = torch.device("cuda")
    Xn, _ = simulation_data(N, args.p)
    X = torch.from_numpy(Xn).to(dev)
    del Xn
    y = fleet_responses(X, 1, seed=300)[0]
    ls = rt.get_loss("least_squares")
    lm = float(rt.lambda_max(ls, X, y))
    lams = (np.geomspace(0.9, args.lo, args.points) * lm).tolist()
    cfg = rt.SaifConfig(eps=1e-6)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cv = rt.cv_solve(X, y, lams, n_folds=CV_FOLDS, config=cfg,
                     keep_fold_betas=True, refit=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    W = rt.kfold_weights(N, CV_FOLDS).to(X)
    lowest_all_ok = None
    for lam, fr, mean, se in zip(cv.lams, cv.fold_results, cv.cv_mean,
                                 cv.cv_se):
        cells = []
        for k in range(CV_FOLDS):
            gap = float(fr.gap[k])
            _, kkt = weighted_cert("least_squares", X, y, W[k], fr.beta[k],
                                   float(lam))
            cells.append(gap <= cfg.eps and kkt <= 1e-3 * lam)
        if all(cells):
            lowest_all_ok = lam / lm
        print(f"[cv-probe] lam/lam_max={lam / lm:.4f} outer="
              f"{fr.n_outer.tolist()} n_active={fr.n_active.tolist()} "
              f"max_gap={float(fr.gap.max()):.3e} certified={cells} "
              f"cv_mean={mean:.6f} cv_se={se:.6f}", flush=True)
    i_min = int(np.argmin(cv.cv_mean))
    lam_1se = rt.one_se_lambda(cv.lams, cv.cv_mean, cv.cv_se)
    print(f"[cv-probe] wall_s={wall:.3f} k_max="
          f"{cv.fold_results[0].active_idx.shape[1]} lam_min/lam_max="
          f"{cv.lams[i_min] / lm:.4f} (index {i_min} of {len(lams)}) "
          f"lam_1se/lam_max={lam_1se / lm:.4f} lowest fraction with every "
          f"fold certified={lowest_all_ok} launches={ops.launch_counts()}",
          flush=True)
    t0 = time.perf_counter()
    refit = rt.saif(X, y, cv.lams[i_min], cfg)
    torch.cuda.synchronize()
    kkt = float(rt.kkt_residual(ls, X, y, refit.beta, cv.lams[i_min]))
    print(f"[cv-probe] refit at lam_min: outer={refit.n_outer} "
          f"gap={float(refit.gap):.3e} kkt={kkt:.3e} support="
          f"{len(support(refit.beta))} wall_s={time.perf_counter() - t0:.3f}",
          flush=True)
    if args.select:
        b, frac = SELECT_SUBSAMPLES
        t0 = time.perf_counter()
        freq, st = rt.stability_frequencies(X, y, lam_1se, cfg, b, frac)
        torch.cuda.synchronize()
        print(f"[select-probe] at lam_1se/lam_max={lam_1se / lm:.4f}: "
              f"wall_s={time.perf_counter() - t0:.3f} subsample_outer="
              f"{st.n_outer.tolist()} n_active={st.n_active.tolist()} "
              f"max_gap={float(st.gap.max()):.3e} features with frequency "
              f">= 0.6: {int((freq >= 0.6).sum())}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
