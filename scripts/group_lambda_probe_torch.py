#!/usr/bin/env python3
"""Outer steps, group support, certificates and wall time of the port's
group-LASSO solve on one NVIDIA card, on ``chip_smoke.py``'s group
problems (phase 2's and phase 3's designs at n = 1000 and full p, groups
of 10 consecutive columns, 50 true groups), for a few lambda fractions.

    python3 scripts/group_lambda_probe_torch.py --fracs 0.3 0.2 0.1 \
        --logit-fracs 0.3 0.2 --plain

First it prints ``nvcc -Xptxas -v`` for ``csrc/group_bcd.cu`` and holds one
burst of kernel B-n3 against its plain version (float64 and float32, a
block of 2,000 columns with masked slots). Then each fraction runs one
``group_solve`` under ``auto`` (B-n3) with ``GroupSaifConfig(eps=1e-6)``;
a solve counts as certified when its gap is <= eps and
max_g ||X_g^T theta|| <= 1 + 1e-3 at its final dual point, both on the
card. Fractions are tried from the first down and stop at the first that
does not certify. With ``--plain`` the first fraction of each loss is also
solved with ``backend="torch"`` (the plain burst, on the card), for its
wall. It shows how far down the group lambda path the port certifies
within ``max_outer``, which sets ``GROUP_LAM`` and ``GROUP_LOGIT_LAM`` of
``chip_smoke.py``.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def ptxas_report() -> str:
    from repro_torch.kernels import _build
    out = ROOT / "build" / "group_bcd_ptxas.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
           str(out), str(_build.CSRC / "group_bcd.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
    return (res.stdout + res.stderr).strip()


def burst_check(X, y, dt, gsize):
    """One 5-epoch burst of B-n3 against its plain version on 200 groups of
    ``X``'s first 2,000 columns, every fifth slot masked, from a small
    nonzero beta. Returns the relative errors of beta and z."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.group.ref import group_blocks
    g = torch.Generator().manual_seed(5)
    Xc = X[:, :2000].contiguous().to(dt)
    k = 200
    gidx = torch.randperm(k, generator=g).to(X.device)
    gmask = (torch.arange(k) % 5 != 4).to(X.device)
    beta = (0.01 * torch.randn(k, gsize, generator=g, dtype=torch.float64)
            ).to(X.device, dt)
    gfro = torch.linalg.vector_norm(Xc.view(Xc.shape[0], -1, gsize),
                                    dim=(0, 2))
    L = torch.where(gmask, gfro[gidx] ** 2, 1.0)
    lam = 0.3 * float(torch.linalg.vector_norm(
        (Xc.T @ y.to(dt)).view(-1, gsize), dim=1).max())
    live = torch.nonzero(gmask).flatten()
    a = (group_blocks(Xc, gidx[live], gsize), y.to(dt), live, beta, L, lam,
         5)
    b1, z1 = ops.group_bcd(*a)
    b2, z2 = ops.group_bcd_ref(*a)
    torch.cuda.synchronize()
    rb = float((b1 - b2).abs().max() / b2.abs().max())
    rz = float((z1 - z2).abs().max() / z2.abs().max())
    return rb, rz


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--p", type=int, default=100_000)
    ap.add_argument("--fracs", type=float, nargs="+",
                    default=[0.3, 0.2, 0.1])
    ap.add_argument("--logit-fracs", type=float, nargs="+",
                    default=[0.3, 0.2, 0.1])
    ap.add_argument("--plain", action="store_true")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("group_lambda_probe_torch: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import repro_torch as rt
    from chip_smoke import (GROUP_EPS, GROUP_SIZE, N, group_kkt,
                            group_response, group_support, logistic_data,
                            nvidia_smi_line, simulation_data)
    from repro_torch.core.group import group_solve, prepare_group
    from repro_torch.kernels import _build, ops

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {nvidia_smi_line()}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    print(ptxas_report(), flush=True)
    t0 = time.perf_counter()
    _build.library("group_bcd")
    print(f"[build] group_bcd {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    gs = GROUP_SIZE
    Xn, _ = simulation_data(N, args.p)
    X = torch.from_numpy(Xn).to(dev)
    del Xn
    y = group_response(X, seed=400)
    for dt in (torch.float64, torch.float32):
        rb, rz = burst_check(X, y, dt, gs)
        print(f"[burst {dt}] rel_err beta={rb:.3e} z={rz:.3e}", flush=True)
        if not max(rb, rz) <= (1e-12 if dt == torch.float64 else 1e-5):
            raise RuntimeError("group_bcd disagrees with its plain version")
    Ln, _ = logistic_data(N, args.p)
    XL = torch.from_numpy(Ln).to(dev)
    del Ln
    yL = group_response(XL, seed=401, logistic=True)

    for loss_name, Xd, yd, fracs in (("least_squares", X, y, args.fracs),
                                     ("logistic", XL, yL,
                                      args.logit_fracs)):
        loss = rt.get_loss(loss_name)
        cfg = rt.GroupSaifConfig(eps=GROUP_EPS, loss=loss_name)
        t0 = time.perf_counter()
        prep = prepare_group(Xd, yd, gs, cfg)
        torch.cuda.synchronize()
        print(f"[{loss_name}] prepare_group {time.perf_counter() - t0:.3f} "
              f"s h={prep.h} k_max={prep.k_max}", flush=True)
        glm = rt.group_lambda_max(loss, Xd, yd, gs)
        for i, frac in enumerate(fracs):
            lam = frac * glm
            for backend in (("auto", "torch") if args.plain and i == 0
                            else ("auto",)):
                ops.reset_launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = group_solve(prep, lam, cfg, backend=backend)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                gap = float(res.gap)
                kkt = group_kkt(loss, Xd, yd, res, lam)
                ok = gap <= cfg.eps and kkt <= 1 + 1e-3
                print(f"[{loss_name}] frac={frac} backend={backend} "
                      f"outer={res.n_outer} max_outer={cfg.max_outer} "
                      f"active_groups={res.n_active_groups} support_groups="
                      f"{len(group_support(res.beta))} gap={gap:.3e} "
                      f"kkt={kkt:.6f} certified={ok} wall_s={wall:.3f} "
                      f"launches={ops.launch_counts()['group_bcd']}",
                      flush=True)
            if not ok:
                break
    return 0


if __name__ == "__main__":
    sys.exit(main())
