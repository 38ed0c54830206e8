"""Outer steps, final gap and support of the reference solver (``repro``,
JAX on the CPU) on the chain fused-LASSO problem of
benchmarks/bench_fused.py, for a few n, p and lambda fractions. Counts and
gaps only, no times.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python scripts/ref_fused_probe.py \
        --n 1000 --p 5000 10000 --fracs 0.3 0.1 --losses least_squares

Least squares uses y = X beta + 0.1 noise; logistic the labels
sign(X beta + 0.3 noise) on the same X (as chip_smoke.fused_chain_data).
It shows where the reference certifies fused chains within max_outer: the
counts that the port's probe on the card,
``scripts/fused_lambda_probe_torch.py``, is held against.
"""
import argparse
import warnings

import jax
import numpy as np

jax.config.update("jax_enable_x64", True)

from chip_smoke import fused_chain_data  # noqa: E402
from repro.core import SaifConfig, fused_lambda_max, saif_fused  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--p", type=int, nargs="+", default=[5000])
    ap.add_argument("--fracs", type=float, nargs="+", default=[0.3, 0.1])
    ap.add_argument("--losses", nargs="+",
                    default=["least_squares", "logistic"],
                    choices=["least_squares", "logistic"])
    args = ap.parse_args()
    warnings.simplefilter("ignore", DeprecationWarning)
    for p in args.p:
        parent = np.arange(p) - 1
        for loss in args.losses:
            X, y = fused_chain_data(args.n, p, logistic=loss == "logistic")
            lm = fused_lambda_max(X, y, parent, loss=loss)
            cfg = SaifConfig(loss=loss)
            for f in args.fracs:
                _, r = saif_fused(X, y, parent, f * lm, cfg)
                beta = np.asarray(r.beta)
                sup = np.where(np.abs(beta) > 1e-8)[0]
                print(f"loss={loss} n={args.n} p={p} lam/lam_max={f} "
                      f"outer={int(r.n_outer)} max_outer={cfg.max_outer} "
                      f"gap={float(r.gap):.3e} eps={cfg.eps:.0e} "
                      f"certified={float(r.gap) <= cfg.eps} "
                      f"n_active={int(r.n_active)} "
                      f"support={sup[:8].tolist()}"
                      f"{'...' if len(sup) > 8 else ''} ({len(sup)})",
                      flush=True)


if __name__ == "__main__":
    main()
