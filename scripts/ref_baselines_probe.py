"""Counts of the reference's baselines (``repro``, JAX on the CPU) on the
paper's Sec 5.1.1 simulation at n = 1000, 0.3 lambda_max, eps = 1e-6, for
a few p: the epochs of the unscreened CM to gap <= eps, dynamic
screening's outer steps, coordinate updates and survivor history, the
sequential path's screened fractions and the homotopy paths' supports and
updates over 0.95 -> 0.3 lambda_max in 5 points. Counts and gaps only,
no times.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python scripts/ref_baselines_probe.py \
        --p 10000 30000

The data is ``chip_smoke.simulation_data``, as the port's
``scripts/baselines_probe_torch.py`` makes it on the card; these counts
are what that probe's are held against, and what the smoke's walls are
predicted from. ``--gaps`` runs the two paths only and prints, for each
reduced solve, its outer steps with every gap and the gap's precision
floor (``duality.gap_precision_floor``), to show where a stop decision
sits against eps.
"""
import argparse
import warnings

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_enable_x64", True)

from chip_smoke import BASE_PATH, LS_LAM, simulation_data  # noqa: E402
from repro.core import (DynConfig, HomotopyConfig, SeqConfig,  # noqa: E402
                        dynamic_screening, get_loss, homotopy_path,
                        sequential_path)
import repro.core.sequential as seq_mod  # noqa: E402
from repro.core.cm import cm_epoch  # noqa: E402
from repro.core.duality import (duality_gap, feasible_dual,  # noqa: E402
                                gap_precision_floor)


@jax.jit
def _epoch_gap(X, y, beta, z, lam):
    loss = get_loss("least_squares")
    beta, z = cm_epoch(loss, X, y, beta, z, jnp.ones(X.shape[1], bool), lam)
    theta = feasible_dual(loss, X, y, -loss.grad(z, y) / lam, lam)
    return beta, z, duality_gap(loss, X, y, beta, theta, lam)


def record_gaps(out):
    """Make every reduced solve of the paths append (gap, floor) to
    ``out`` from inside its while loop (``jax.debug.callback``)."""
    def gap(loss, X, y, beta, theta, lam, *a, **k):
        g = duality_gap(loss, X, y, beta, theta, lam, *a, **k)
        jax.debug.callback(lambda g, f: out.append((float(g), float(f))),
                           g, gap_precision_floor(theta, lam), ordered=True)
        return g
    seq_mod.duality_gap = gap


def print_gaps(tag, gaps):
    """One line per reduced solve (a run of gaps ending at <= 1e-6)."""
    solve = []
    for g, f in gaps:
        solve.append(g)
        if g <= 1e-6:
            print(f"[gaps {tag}] steps={len(solve)} gaps="
                  f"{[float(f'{x:.4g}') for x in solve[-3:]]} floor={f:.3e}",
                  flush=True)
            solve = []


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--p", type=int, nargs="+", default=[10000])
    ap.add_argument("--max-epochs", type=int, default=2000)
    ap.add_argument("--gaps", action="store_true",
                    help="the two paths only, with every reduced solve's "
                         "gaps")
    args = ap.parse_args()
    warnings.simplefilter("ignore", DeprecationWarning)
    for p in args.p:
        X, y = simulation_data(args.n, p)
        Xj, yj = jnp.asarray(X), jnp.asarray(y)
        lm = float(jnp.max(jnp.abs(Xj.T @ yj)))
        lam = LS_LAM * lm
        lams = np.geomspace(BASE_PATH[0], BASE_PATH[1], BASE_PATH[2]) * lm
        if args.gaps:
            gaps = []
            record_gaps(gaps)
            s = sequential_path(X, y, lams, SeqConfig(eps=1e-6))
            print(f"[sequential p={p}] coord_updates={s.coord_updates}")
            print_gaps(f"sequential p={p}", gaps)
            gaps.clear()
            h = homotopy_path(X, y, lams,
                              HomotopyConfig(eps=1e-6, kkt_check=True))
            print(f"[homotopy kkt_check=True p={p}] coord_updates="
                  f"{h.coord_updates}")
            print_gaps(f"homotopy p={p}", gaps)
            continue
        beta, z = jnp.zeros(p), jnp.zeros(args.n)
        for epoch in range(1, args.max_epochs + 1):
            beta, z, gap = _epoch_gap(Xj, yj, beta, z, lam)
            if float(gap) <= 1e-6:
                break
        print(f"[cm p={p}] epochs={epoch} gap={float(gap):.3e} support="
              f"{int((jnp.abs(beta) > 1e-8).sum())}", flush=True)
        r = dynamic_screening(X, y, lam, DynConfig(eps=1e-6))
        print(f"[dynamic p={p}] outer={r.n_outer} coord_updates="
              f"{r.coord_updates} survivors={r.survivor_history} gap="
              f"{float(r.gap):.3e}", flush=True)
        s = sequential_path(X, y, lams, SeqConfig(eps=1e-6))
        print(f"[sequential p={p}] screened="
              f"{[round(float(f), 4) for f in s.screened_frac]} "
              f"coord_updates={s.coord_updates}", flush=True)
        for kkt in (True, False):
            h = homotopy_path(X, y, lams,
                              HomotopyConfig(eps=1e-6, kkt_check=kkt))
            print(f"[homotopy kkt_check={kkt} p={p}] supports="
                  f"{[len(a) for a in h.supports]} coord_updates="
                  f"{h.coord_updates}", flush=True)


if __name__ == "__main__":
    main()
