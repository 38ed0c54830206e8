"""A group solve whose support outgrows its capacity k_max, served by the
reference (``repro``, JAX on the CPU) and by the port (``repro_torch``,
``device="cpu"``) on the same inputs: outer steps, live groups, the
sub-problem gap, the serving verdict, and max_g ||X_g^T hat|| at
hat = -f'(X beta) / lam over every group (above 1: not the optimum), beside
the group support of the unscreened oracle. Counts and gaps only.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python \
        scripts/ref_group_capacity_probe.py --k-max 4 32

The design is gaussian, n = 40, p = 120 in groups of 4, with 40 true
features; lambda is 0.1 of the group lambda_max, eps 1e-8, max_outer 200.
"""
import argparse

import jax
import numpy as np

jax.config.update("jax_enable_x64", True)

import repro_torch as rt  # noqa: E402
from repro.core import api as JA  # noqa: E402
from repro.core import group as JG  # noqa: E402
from repro.core.losses import get_loss  # noqa: E402
from repro.core.serving import open_serving  # noqa: E402


def max_group_corr(X, y, beta, lam, gsize):
    hat = -(X @ beta - y) / lam
    return float(np.linalg.norm((X.T @ hat).reshape(-1, gsize), axis=1).max())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--k-max", type=int, nargs="+", default=[4, 32])
    args = ap.parse_args()
    rng = np.random.default_rng(0)
    X = rng.normal(size=(40, 120))
    y = X[:, :40] @ rng.normal(size=40) + 0.3 * rng.normal(size=40)
    gs = 4
    lam = 0.1 * JG.group_lambda_max(get_loss("least_squares"), X, y, gs)
    ref = np.asarray(JG.solve_group_lasso_bcd(get_loss("least_squares"), X,
                                              y, lam, gs, tol=1e-10))
    n_true = int((np.linalg.norm(ref.reshape(-1, gs), axis=1) > 1e-7).sum())
    print(f"oracle: {n_true} groups in the support")
    for k in args.k_max:
        for name, mod, cfg, kw in (
                ("repro", JA, JG.GroupSaifConfig, {}),
                ("repro_torch", rt, rt.GroupSaifConfig, {"device": "cpu"})):
            c = cfg(eps=1e-8, k_max=k, max_outer=200)
            srv = (open_serving if name == "repro" else rt.open_serving)(
                mod.Problem(X=X, y=y, penalty=mod.group(gs)), c, **kw)
            out = srv.solve(mod.Scalar(lam))
            r = out.value
            beta = np.asarray(r.beta)
            print(f"{name} k_max={k}: outer={int(r.n_outer)} live_groups="
                  f"{int(r.n_active_groups)} gap={float(r.gap):.3e} "
                  f"verdict_ok={out.verdict.ok} events={out.verdict.events}"
                  f" max_group_corr={max_group_corr(X, y, beta, lam, gs):.4f}")


if __name__ == "__main__":
    main()
