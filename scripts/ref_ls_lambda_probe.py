"""Outer steps and support size of the reference solver (``repro``, JAX on
the CPU) on the paper's Sec 5.1.1 least-squares simulation at n = 1000 and
a cut p, for a few lambda fractions. Counts only, no times.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python scripts/ref_ls_lambda_probe.py \
        --p 10000 30000 --fracs 0.1 0.3 0.5

It shows how far down the lambda path the default SaifConfig converges
within ``max_outer`` on this protocol: the counts that the port's own
probe on the card, ``scripts/ls_lambda_probe_torch.py --p 30000``, is
held against.
"""
import argparse

import jax
import numpy as np

jax.config.update("jax_enable_x64", True)

from benchmarks.common import simulation_data  # noqa: E402
from repro.core import SaifConfig, saif  # noqa: E402
from repro.core.duality import lambda_max  # noqa: E402
from repro.core.losses import get_loss  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--p", type=int, nargs="+", default=[10000, 30000])
    ap.add_argument("--fracs", type=float, nargs="+",
                    default=[0.1, 0.3, 0.5])
    args = ap.parse_args()
    cfg = SaifConfig()
    for p in args.p:
        X, y, _ = simulation_data(args.n, p)
        lm = float(lambda_max(get_loss("least_squares"), X, y))
        for f in args.fracs:
            r = saif(X, y, f * lm, cfg)
            beta = np.asarray(r.beta)
            print(f"n={args.n} p={p} lam/lam_max={f} outer={int(r.n_outer)}"
                  f" max_outer={cfg.max_outer} gap={float(r.gap):.3e} "
                  f"eps={cfg.eps:.0e} support={int((abs(beta) > 1e-8).sum())}"
                  f" k_max={r.active_idx.shape[0]}", flush=True)


if __name__ == "__main__":
    main()
