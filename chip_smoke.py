#!/usr/bin/env python3
"""Drive repro_torch's main paths on one NVIDIA card and hold its kernels
against their plain PyTorch versions.

    python3 chip_smoke.py            # from the repository root

Phases (each one fails the run by raising):

1. build the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, one process
   per source, in parallel) and print the seconds;
2. least squares at full size: the paper's Sec 5.1.1 simulation (X ~
   U[-10, 10], 20% of the betas nonzero in [-1, 1], N(0, 1) noise) at
   n = 1000, p = 100,000, float64, solved three ways — ``auto`` (K1/K2
   screen + K3 burst), ``inner_backend="gram"`` (the Gram engine on the
   card) and ``torch``/``torch`` (the plain path, on the card). Each solve
   must be certified on the card (gap <= eps, KKT residual <= 1e-3 lam) and
   all three must find the same support;
3. logistic at full size: gaussian design, 40 true features, labels from
   their sign (n = 1000, p = 100,000, float64); ``auto`` must route the
   burst through K3; the same certificates;
4. the fused transform at full width: phase 2's X through ``prepare_fused``
   on a chain under ``auto`` launches K4 exactly once, and K4 equals its
   plain version bit for bit in float64 and float32;
5. fused least squares: the chain problem of benchmarks/bench_fused.py at
   n = 1000, p = 5,000, float64, at FUSED_LS_LAM lambda_max, through
   ``saif_fused`` under ``auto`` (K4, K1, K2 and K3-pen) and plain; each
   certified (gap <= eps and the KKT residual with b's weight 0 <= 1e-3
   lam), one support;
6. fused logistic on the same design, labels sign(X beta + 0.3 noise), at
   FUSED_LOGIT_LAM lambda_max, the same two ways and certificates;
7. ``fused_path`` over 4 lambdas from 0.7 to 0.3 lambda_max (geometric) on
   phase 5's problem: every point certified, supports growing;
8. every kernel against its plain version on the card, in float64 and
   float32, at the shapes the solves gave it: max error against a stated
   tolerance, the kernel's time, the plain version's time, the time of a
   PyTorch call computing the same function where one exists, and the
   least time the card could take (bytes or operations, whichever bounds);
9. the least-squares fleet at full width: phase 2's X with B = 16
   responses built as benchmarks/bench_batch.py's ``_fleet_problem``
   builds them (15 true features in [-1, 1], N(0, 1) noise, a seed per
   response), lambda_b spread geometrically from 0.8 down to 0.3 of each
   problem's lambda_max, through ``fleet_solve`` under ``auto`` (K1b, K2b,
   K3b and no serial kernel); every problem certified (gap <= eps, KKT
   <= 1e-3 lambda_b) and its row bit for bit the port's serial ``saif``
   on the card (K1/K2/K3); the fleet's wall against the sum of the 16
   serial walls, and the fleet profiled;
10. the logistic fleet: B = 8 label vectors over phase 3's design (40 true
   features each, a seed per vector), lambda from 0.5 down to 0.2
   lambda_max, the same checks;
11. the plain fleet on the card: ``torch`` screen and inner on 2 problems
   of phase 9 (its largest and smallest lambda): the kernel fleet's
   support, beta within rtol 1e-6, gap <= eps;
12. K1b, K2b and K3b against their plain versions at the fleet's shapes
   (B = 16, n = 1000, p = 100,000, its h and k_max), in float64 and
   float32, and each against B launches of its serial kernel (K1, K2,
   K3), bit for bit.

Launch counters are zeroed just before each solve (and the transform of
phase 4) and read just after; the kernel launches of phases 8 and 12, of
the comparisons of phase 4, of the serial solves that phases 9-10 compare
with, of the lambda_max helpers and of one extra solve
under torch.profiler (the device's busy time and idle share) do not
count. The last two lines are the card's name and power limit and
``{"ok": true, "device": {...}}``; the line before them is the per-kernel
JSON record.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and dense non-tensor peaks
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}
N = 1000
# lambda / lambda_max. Least squares sits at 0.3, the lowest fraction the
# port certifies within max_outer at this size: at 0.2 and below the
# duality gap stalls above eps = 1e-6 (PERF.md, section 4, from
# scripts/ls_lambda_probe_torch.py).
LS_LAM = 0.3
LOGIT_LAM = 0.2
# The fused phases run where the solve certifies. On the chain problem
# cyclic CM crawls on the nearly collinear suffix-sum columns and ends
# max_outer uncertified, in the reference as in the port: least squares
# past p of about 10,000, logistic at p = 5,000 below about 0.6
# lambda_max (PERF.md, section 4, from scripts/ref_fused_probe.py and
# scripts/fused_lambda_probe_torch.py).
FUSED_P = 5000
FUSED_LS_LAM = 0.3
FUSED_LOGIT_LAM = 0.7
FUSED_PATH = (0.7, 0.3, 4)       # first, last lambda / lambda_max, points
# fleets: first and last lambda / lambda_max (geometric), problems
FLEET_LS = (0.8, 0.3, 16)
FLEET_LOGIT = (0.5, 0.2, 8)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def simulation_data(n, p, seed=0):
    """Paper Sec 5.1.1: X ~ U[-10,10], 20% active betas in [-1,1], N(0,1)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    X = rng.uniform(-10, 10, (n, p))
    beta = np.zeros(p)
    idx = rng.choice(p, int(0.2 * p), replace=False)
    beta[idx] = rng.uniform(-1, 1, len(idx))
    y = X @ beta + rng.normal(0, 1, n)
    return X, y


def logistic_data(n, p, seed=2, k=40):
    """Gaussian design, k true features, labels sign(X w + 0.3 noise)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p))
    w = np.zeros(p)
    w[rng.choice(p, k, replace=False)] = rng.uniform(-2, 2, k)
    y = np.sign(X @ w + 0.3 * rng.normal(size=n))
    y[y == 0] = 1.0
    return X, y


def fused_chain_data(n, p, seed=0, logistic=False):
    """benchmarks/bench_fused.py's chain problem: X ~ N(0, 1), beta = 2 on
    the first p/8 and -1 on the next p/8, y = X beta + 0.1 noise; with
    ``logistic`` the labels are sign(X beta + 0.3 noise) instead."""
    import numpy as np
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p))
    beta = np.zeros(p)
    beta[: p // 8] = 2.0
    beta[p // 8: p // 4] = -1.0
    if not logistic:
        return X, X @ beta + 0.1 * rng.normal(size=n)
    y = np.sign(X @ beta + 0.3 * rng.normal(size=n))
    y[y == 0] = 1.0
    return X, y


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the card (CUDA events, one warm-up)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def support(beta, tol=1e-8):
    import torch
    return set(torch.nonzero(beta.abs() > tol).flatten().tolist())


def profile_solve(tag, solve, wall):
    """Run ``solve`` once more under torch.profiler and print the device's
    busy time (the sum of kernel times, one stream) against the unprofiled
    wall time ``wall``, and the kernels that take most of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        solve()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_s = sum(e.self_device_time_total for e in ev) / 1e6
    if busy_s == 0.0:
        print(f"[profile {tag}] device time: not measured (the profiler "
              f"recorded no device activity)", flush=True)
        return
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:5]
    tops = "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.2f} ms"
                     f" x{e.count}" for e in top)
    print(f"[profile {tag}] device_busy_s={busy_s:.4f} wall_s={wall:.4f} "
          f"idle_share={1 - busy_s / wall:.3f} top: {tops}", flush=True)


def solve_phase(name, lam, cfg, runs, expect, solve, kkt, profiled=()):
    """Run ``solve(config)`` once per entry of ``runs`` (label -> config
    overrides), certify each solve on the card (gap <= eps and
    ``kkt(result) <= 1e-3 lam``) and check the launch counts; the labels
    in ``profiled`` are then profiled in one more, uncounted solve."""
    import dataclasses
    import torch
    from repro_torch.kernels import ops

    results, launches = {}, {}
    for label, over in runs.items():
        c = dataclasses.replace(cfg, **over)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = solve(c)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        kkt_v = float(kkt(res))
        gap = float(res.gap)
        print(f"[{name}/{label}] outer={res.n_outer} n_active="
              f"{res.n_active} k_max={res.active_idx.shape[0]} gap={gap:.3e}"
              f" eps={c.eps:.1e} kkt={kkt_v:.3e} kkt_limit={1e-3 * lam:.3e} "
              f"wall_s={wall:.3f} launches={counts}", flush=True)
        if not (gap <= c.eps and kkt_v <= 1e-3 * lam):
            raise RuntimeError(f"{name}/{label}: solve not certified")
        check_launches(f"{name}/{label}", counts, expect[label])
        results[label] = res
        launches[label] = counts
        if label in profiled:
            profile_solve(f"{name}/{label}", lambda: solve(c), wall)
    sups = {label: support(r.beta) for label, r in results.items()}
    first = next(iter(sups.values()))
    if any(s != first for s in sups.values()):
        raise RuntimeError(f"{name}: supports differ across runs: "
                           f"{ {k: len(v) for k, v in sups.items()} }")
    print(f"[{name}] support size {len(first)} identical across "
          f"{list(sups)}", flush=True)
    return results, launches


def check_launches(tag, counts, expect):
    """``expect``: kernel -> True (launched at least once), False (never)
    or an int (exactly that many times)."""
    for kname, must in expect.items():
        got = counts[kname]
        if must is True and got == 0:
            raise RuntimeError(f"{tag}: kernel {kname} was never launched "
                               f"on the main path")
        if must is False and got != 0:
            raise RuntimeError(f"{tag}: kernel {kname} launched {got} times "
                               f"where it has no place")
        if not isinstance(must, bool) and got != must:
            raise RuntimeError(f"{tag}: kernel {kname} launched {got} times,"
                               f" expected {must}")


def errs(pairs):
    """(max abs error, max error over each reference's own scale) on the
    finite entries; a different non-finite pattern is inf."""
    import torch
    worst_abs = worst_rel = 0.0
    for a, b in pairs:
        fin = torch.isfinite(b)
        if not bool((a[~fin] == b[~fin]).all()):
            return float("inf"), float("inf")
        if bool(fin.any()):
            d = float((a[fin] - b[fin]).abs().max())
            worst_abs = max(worst_abs, d)
            worst_rel = max(worst_rel,
                            d / max(float(b[fin].abs().max()), 1e-300))
    return worst_abs, worst_rel


def burst_error(loss_name, out, ref, ys, lam_s):
    """K3's error against its plain twin: beta, z, theta against their own
    scale; the gap, a difference P - D of two near-equal objectives,
    against the scale of D."""
    import repro_torch as rt
    abs3, err3 = errs(zip(out[:3], ref[:3]))
    d_scale = 1.0 + abs(float(rt.get_loss(loss_name).dual_objective(
        ys, ref[2], lam_s)))
    gap_err = abs(float(out[3]) - float(ref[3]))
    return max(abs3, gap_err), max(err3, gap_err / d_scale)


def check_kernels(dtype, X, y, lam, h, ls_res, logit, logit_res, fused,
                  records):
    """Hold K1, K2, K3 and K3-pen against their plain versions at the
    solves' shapes; ``fused`` holds (loss, Xt, y, lam, result) of the
    fused solves."""
    import torch
    import repro_torch as rt
    from repro_torch.core.active_set import compact_order
    from repro_torch.kernels import ops

    dt = getattr(torch, dtype)
    isz = torch.finfo(dt).bits // 8
    # scan: one length-n dot per column, summed in another order than the
    # plain matvec; burst: thousands of dependent steps, each rounding
    tol = {"float64": 1e-10, "float32": 1e-4}[dtype]
    tol3 = {"float64": 1e-9, "float32": 1e-3}[dtype]
    Xd, yd = X.to(dt), y.to(dt)
    n, p = Xd.shape
    g = torch.Generator(device="cpu").manual_seed(0)
    theta = (torch.randn(n, generator=g, dtype=torch.float64) / n).to(
        Xd.device, dt)
    col_norm = torch.linalg.vector_norm(Xd, dim=0)
    active = torch.zeros(p, dtype=torch.bool, device=Xd.device)
    active[ls_res.active_idx[ls_res.active_mask]] = True
    r = 0.05

    # K1 masked (the main path's mode) and unmasked
    k1 = ops.screen_fused(Xd, theta, col_norm, active, r, h=h)
    k1_ref = ops.screen_fused_ref(Xd, theta, col_norm, active, r, h=h)
    abs1, err1 = errs(zip((k1[0], k1[1], k1[2], k1[3], k1[5]),
                          (k1_ref[0], k1_ref[1], k1_ref[2], k1_ref[3],
                           k1_ref[5])))
    # candidate ids: equal wherever the plain scores are told apart; where
    # two plain scores tie within the tolerance, the sum order may swap them
    fin = torch.isfinite(k1_ref[3])
    ids_k, ids_p = k1[4][fin].long(), k1_ref[4][fin].long()
    swapped = ids_k != ids_p
    s_ref = k1_ref[0]
    scale1 = float(k1_ref[3][fin].abs().max())
    tie = ((s_ref[ids_k[swapped]] - s_ref[ids_p[swapped]]).abs()
           <= tol * scale1)
    ids_ok = bool(tie.all())
    n_swapped = int(swapped.sum())
    k1u = ops.screen_scores(Xd, theta, col_norm, r)
    k1u_ref = ops.screen_scores_ref(Xd, theta, col_norm, r)
    err1u = errs(zip(k1u, k1u_ref))[1]
    ms1 = time_ms(lambda: ops.screen_fused(Xd, theta, col_norm, active, r,
                                           h=h), 20)
    plain1 = time_ms(lambda: ops.screen_fused_ref(Xd, theta, col_norm,
                                                  active, r, h=h), 5)
    lib1 = time_ms(lambda: torch.abs(theta @ Xd), 20)
    ms1u = time_ms(lambda: ops.screen_scores(Xd, theta, col_norm, r), 20)
    plain1u = time_ms(lambda: ops.screen_scores_ref(Xd, theta, col_norm, r),
                      5)
    h_tile = min(h, 256)
    pb = -(-p // 256)
    b1, by1 = bound_ms(n * p * isz + n * isz + p * isz + p + 3 * p * isz
                       + pb * h_tile * (isz + 4) + pb * isz,
                       2 * n * p, dtype)
    print(f"[kernel screen_fused {dtype}] n={n} p={p} h={h} "
          f"max_abs_err={abs1:.3e} rel_err={err1:.3e} tol={tol:.0e} "
          f"ids_ok={ids_ok} "
          f"(ids differing at near-ties: {n_swapped} of {int(fin.sum())}) "
          f"unmasked_rel_err={err1u:.3e} ms={ms1:.4f} unmasked_ms={ms1u:.4f}"
          f" plain_ms={plain1:.4f} unmasked_plain_ms={plain1u:.4f} "
          f"library_ms(abs(theta@X))={lib1:.4f} "
          f"bound_ms={b1:.4f} ({by1})", flush=True)
    if not (err1 <= tol and err1u <= tol and ids_ok):
        raise RuntimeError(f"screen_fused {dtype} disagrees with its plain "
                           f"version")

    # K2 at the screen's candidate count, on the scan's ub
    ub = k1_ref[1]
    lb_sorted = torch.sort(k1_ref[2][torch.isfinite(k1_ref[2])][:h]).values
    hist = ops.ub_histogram(ub, lb_sorted)
    hist_ref = ops.ub_histogram_ref(ub, lb_sorted)
    err2 = int((hist - hist_ref).abs().max())
    ms2 = time_ms(lambda: ops.ub_histogram(ub, lb_sorted), 50)
    plain2 = time_ms(lambda: ops.ub_histogram_ref(ub, lb_sorted), 5)
    hh = lb_sorted.shape[0]
    b2, by2 = bound_ms(p * isz + hh * isz + (hh + 1) * 4, p * hh, dtype)
    print(f"[kernel ub_histogram {dtype}] p={p} h={hh} max_abs_err={err2} "
          f"tol=0 ms={ms2:.4f} plain_ms={plain2:.4f} bound_ms={b2:.6f} "
          f"({by2})", flush=True)
    if err2 != 0:
        raise RuntimeError(f"ub_histogram {dtype} disagrees")

    # K3 on both losses, at each solve's final active block, from beta = 0,
    # one polish burst (the main path's longest)
    k3 = {}
    for loss_name, Xs, ys, lam_s, res in (
            ("least_squares", Xd, yd, lam, ls_res),
            ("logistic", logit[0].to(dt), logit[1].to(dt), logit[2],
             logit_res)):
        mask = res.active_mask
        k = mask.shape[0]
        count = int(mask.sum())
        order = compact_order(torch.arange(k, device=mask.device), mask)
        A = torch.where(mask[None, :], Xs[:, res.active_idx], 0.0)
        AT = A.T.contiguous()
        cn = torch.where(mask, torch.linalg.vector_norm(A, dim=0), 0.0)
        col_sq = cn * cn
        beta0 = torch.zeros(k, dtype=dt, device=A.device)
        n_ep = 40

        def run_k(AT=AT, ys=ys, col_sq=col_sq, mask=mask, order=order,
                  lam_s=lam_s, count=count, loss_name=loss_name,
                  beta0=beta0):
            return ops.cm_burst_xt(AT, ys, beta0, col_sq, mask, order, lam_s,
                                   n_ep, count, loss_name=loss_name)

        def run_p(A=A, ys=ys, col_sq=col_sq, mask=mask, order=order,
                  lam_s=lam_s, count=count, loss_name=loss_name,
                  beta0=beta0):
            return ops.cm_burst_ref(A, ys, beta0, col_sq, mask, order, lam_s,
                                    n_ep, count, loss_name=loss_name)

        out, ref = run_k(), run_p()
        abs3, err3 = burst_error(loss_name, out, ref, ys, lam_s)
        ms3 = time_ms(run_k, 3)
        plain3 = time_ms(run_p, 1)
        steps = n_ep * count
        flops = steps * 4 * Xs.shape[0] + 4 * Xs.shape[0] * k
        b3, by3 = bound_ms(k * Xs.shape[0] * isz + 3 * Xs.shape[0] * isz
                           + 3 * k * isz + 5 * k + isz, flops, dtype)
        print(f"[kernel cm_burst {dtype} {loss_name}] n={Xs.shape[0]} k={k} "
              f"count={count} n_epochs={n_ep} max_abs_err={abs3:.3e} "
              f"rel_err={err3:.3e} "
              f"tol={tol3:.0e} ms={ms3:.4f} plain_ms={plain3:.4f} "
              f"bound_ms={b3:.6f} ({by3})", flush=True)
        if not err3 <= tol3:
            raise RuntimeError(f"cm_burst {dtype} {loss_name} disagrees")
        k3[loss_name] = (abs3, ms3, plain3, b3, by3)

    # K3-pen at each fused solve's final block, pen from its slot map
    k3p = {}
    for loss_name, Xt, ys, lam_s, res in fused:
        Xs, ys = Xt.to(dt), ys.to(dt)
        mask = res.active_mask
        k = mask.shape[0]
        count = int(mask.sum())
        order = compact_order(torch.arange(k, device=mask.device), mask)
        A = torch.where(mask[None, :], Xs[:, res.active_idx], 0.0)
        AT = A.T.contiguous()
        cn = torch.where(mask, torch.linalg.vector_norm(A, dim=0), 0.0)
        col_sq = cn * cn
        pen = torch.where(mask & (res.active_idx == Xs.shape[1] - 1), 0.0,
                          1.0).to(dt)
        beta0 = torch.zeros(k, dtype=dt, device=A.device)
        n_ep = 40

        def run_k(AT=AT, ys=ys, col_sq=col_sq, mask=mask, order=order,
                  pen=pen, lam_s=lam_s, count=count, loss_name=loss_name,
                  beta0=beta0):
            return ops.cm_burst_pen_xt(AT, ys, beta0, col_sq, mask, order,
                                       pen, lam_s, n_ep, count,
                                       loss_name=loss_name)

        def run_p(A=A, ys=ys, col_sq=col_sq, mask=mask, order=order,
                  pen=pen, lam_s=lam_s, count=count, loss_name=loss_name,
                  beta0=beta0):
            return ops.cm_burst_ref(A, ys, beta0, col_sq, mask, order, lam_s,
                                    n_ep, count, pen, loss_name=loss_name)

        out, ref = run_k(), run_p()
        abs4, err4 = burst_error(loss_name, out, ref, ys, lam_s)
        ms4 = time_ms(run_k, 3)
        plain4 = time_ms(run_p, 1)
        n_s = Xs.shape[0]
        # the sweep's steps, and the tail: fresh z, 4 x 2 polish dots for
        # logistic, 2 projection dots, the dual correlations
        flops = (n_ep * count * 4 * n_s + 4 * n_s * k
                 + (16 * n_s if loss_name == "logistic" else 0) + 4 * n_s)
        b4, by4 = bound_ms(k * n_s * isz + 3 * n_s * isz + 4 * k * isz
                           + 5 * k + isz, flops, dtype)
        print(f"[kernel cm_burst_pen {dtype} {loss_name}] n={n_s} k={k} "
              f"count={count} n_epochs={n_ep} max_abs_err={abs4:.3e} "
              f"rel_err={err4:.3e} tol={tol3:.0e} ms={ms4:.4f} "
              f"plain_ms={plain4:.4f} bound_ms={b4:.6f} ({by4})",
              flush=True)
        if not err4 <= tol3:
            raise RuntimeError(f"cm_burst_pen {dtype} {loss_name} "
                               f"disagrees")
        k3p[loss_name] = (abs4, ms4, plain4, b4, by4)

    if dtype == "float64":
        e3, m3, pl3, bb3, bby3 = k3["least_squares"]
        records["screen_fused"].update(
            max_abs_err=abs1, ms=ms1, plain_ms=plain1, bound_ms=b1,
            bound_by=by1, library_ms=lib1)
        records["ub_histogram"].update(
            max_abs_err=err2, ms=ms2, plain_ms=plain2, bound_ms=b2,
            bound_by=by2, library_ms=None)
        records["cm_burst"].update(
            max_abs_err=max(e3, k3["logistic"][0]), ms=m3, plain_ms=pl3,
            bound_ms=bb3, bound_by=bby3, library_ms=None)
        e4, m4, pl4, bb4, bby4 = k3p["least_squares"]
        records["cm_burst_pen"].update(
            max_abs_err=max(e4, k3p["logistic"][0]), ms=m4, plain_ms=pl4,
            bound_ms=bb4, bound_by=bby4, library_ms=None)


def transform_phase(X, records):
    """Phase 4: ``prepare_fused`` on a chain at full width launches K4 once;
    K4 equals its plain version bit for bit in float64 and float32; times
    against the bound, the latency floor and the cumsum yardstick."""
    import numpy as np
    import torch
    import repro_torch as rt
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused.fused import add_latency_cycles

    n, p = X.shape
    parent = np.arange(p) - 1
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    design = rt.prepare_fused(X, parent)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    t0 = time.perf_counter()         # the host part, timed once more alone
    rt.build_schedule(rt.build_tree(parent))
    host = time.perf_counter() - t0
    print(f"[fused-transform] n={n} p={p} float64 prepare_fused "
          f"wall_s={wall:.3f} (build_tree + build_schedule on the host "
          f"alone: {host:.3f} s) launches={counts}", flush=True)
    check_launches("fused-transform", counts,
                   {k: (1 if k == "chain_suffix_sums" else False)
                    for k in counts})
    launches = counts["chain_suffix_sums"]

    def bits(t):
        return t.view(torch.int64 if t.dtype == torch.float64
                      else torch.int32)

    def yardstick(A):
        return torch.flip(torch.cumsum(torch.flip(A, [1]), 1), [1])

    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    rec = None
    for dtype in ("float64", "float32"):
        dt = getattr(torch, dtype)
        Xd = X.to(dt)
        S = ops.chain_suffix_sums(Xd)
        S_ref = ops.chain_suffix_sums_ref(Xd)
        torch.cuda.synchronize()
        same = bool(torch.equal(bits(S), bits(S_ref)))
        if dtype == "float64":
            same = same and bool(torch.equal(
                bits(design.Xt), bits(torch.cat([S_ref[:, 1:],
                                                 S_ref[:, :1]], 1))))
            del design
        err = float((S - S_ref).abs().max())
        ycut = float((yardstick(Xd) - S_ref).abs().max())
        del S, S_ref
        ms = time_ms(lambda: ops.chain_suffix_sums(Xd), 10)
        plain = time_ms(lambda: ops.chain_suffix_sums_ref(Xd), 1)
        lib = time_ms(lambda: yardstick(Xd), 10)
        isz = Xd.element_size()
        bnd, by = bound_ms(2 * n * p * isz, n * (p - 1), dtype)
        cyc = add_latency_cycles(dt)
        floor = (p - 1) * cyc / (clock * 1e6) * 1e3
        print(f"[kernel chain_suffix_sums {dtype}] n={n} p={p} "
              f"bitwise_equal={same} max_abs_err={err:.3e} tol=0 (bits) "
              f"ms={ms:.4f} plain_ms={plain:.4f} "
              f"library_ms(flip-cumsum-flip)={lib:.4f} "
              f"library_max_abs_dev={ycut:.3e} bound_ms={bnd:.4f} ({by}) "
              f"add_latency_cycles={cyc:.2f} max_sm_clock_mhz={clock:.0f} "
              f"latency_floor_ms={floor:.4f}", flush=True)
        if not same:
            raise RuntimeError(f"chain_suffix_sums {dtype} is not bitwise "
                               f"its plain version")
        if rec is None:
            rec = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                       bound_by=by, library_ms=lib)
        del Xd
    records["chain_suffix_sums"].update(rec)
    return launches


def fused_phases():
    """Phases 5-7: fused least squares and logistic at FUSED_P, and the
    fused path. Returns the kernel-path results, the problems and the
    summed launch counts."""
    import numpy as np
    import torch
    import repro_torch as rt

    dev = torch.device("cuda")
    p = FUSED_P
    parent = np.arange(p) - 1
    pen = torch.ones(p, dtype=torch.float64, device=dev)
    pen[p - 1] = 0.0
    Xn, yn = fused_chain_data(N, p)
    X = torch.from_numpy(Xn).to(dev)
    Xt = rt.prepare_fused(X, parent).Xt
    on = {"screen_fused": True, "ub_histogram": True, "cm_burst": False,
          "cm_burst_pen": True, "chain_suffix_sums": 1,
          "screen_fused_batch": False, "ub_histogram_batch": False,
          "cm_burst_batch": False}
    off = {k: False for k in on}
    out, launches, fused = {}, [], []
    for loss_name, frac, logistic in (("least_squares", FUSED_LS_LAM, False),
                                      ("logistic", FUSED_LOGIT_LAM, True)):
        y = torch.from_numpy(fused_chain_data(N, p, logistic=logistic)[1]
                             ).to(dev)
        loss = rt.get_loss(loss_name)
        lam = frac * rt.fused_lambda_max(X, y, parent, loss=loss_name)
        cfg = rt.SaifConfig(eps=1e-6, loss=loss_name)
        res, counts = solve_phase(
            f"fused-{loss_name}", lam, cfg,
            {"auto": {},
             "plain": {"screen_backend": "torch", "inner_backend": "torch"}},
            {"auto": on, "plain": off},
            lambda c: rt.saif_fused(
                X, y, parent, lam, c, transform_backend=(
                    "torch" if c.inner_backend == "torch" else "auto"))[1],
            lambda r: rt.kkt_residual(loss, Xt, y, r.beta, lam, pen),
            profiled=("auto",) if loss_name == "least_squares" else ())
        launches.append(counts["auto"])
        fused.append((loss_name, Xt, y, lam, res["auto"]))
        out[loss_name] = (y, lam)

    # the path, on the least-squares problem
    y, _ = out["least_squares"]
    loss = rt.get_loss("least_squares")
    lm = rt.fused_lambda_max(X, y, parent)
    hi, lo, m = FUSED_PATH
    lams = np.geomspace(hi * lm, lo * lm, m)
    cfg = rt.SaifConfig(eps=1e-6)
    torch.cuda.synchronize()
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    fp = rt.fused_path(X, y, parent, lams, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    sizes = []
    for lam, r in zip(fp.lams, fp.path.results):
        kkt = float(rt.kkt_residual(loss, Xt, y, r.beta, lam, pen))
        sizes.append(len(support(r.beta)))
        print(f"[fused-path] lam/lam_max={lam / lm:.4f} outer={r.n_outer} "
              f"n_active={r.n_active} support={sizes[-1]} "
              f"gap={float(r.gap):.3e} kkt={kkt:.3e} "
              f"kkt_limit={1e-3 * lam:.3e}", flush=True)
        if not (float(r.gap) <= cfg.eps and kkt <= 1e-3 * lam):
            raise RuntimeError("fused-path: a point is not certified")
    print(f"[fused-path] {m} lambdas wall_s={wall:.3f} launches={counts}",
          flush=True)
    check_launches("fused-path", counts, on)
    if sizes != sorted(sizes):
        raise RuntimeError(f"fused-path: supports shrink down the path: "
                           f"{sizes}")
    launches.append(counts)
    return fused, launches


def fleet_responses(X, b, seed, logistic=False, k=15):
    """B responses over the design X on the card: per response (its own
    seed) k true features, in [-1, 1] with N(0, 1) noise
    (bench_batch.py's ``_fleet_problem``), or, for ``logistic``, in
    [-2, 2] with labels sign(X w + 0.3 noise) (phase 3's protocol)."""
    import numpy as np
    import torch
    n, p = X.shape
    ys = []
    for i in range(b):
        rng = np.random.default_rng(seed + i)
        w = np.zeros(p)
        lo = 2.0 if logistic else 1.0
        w[rng.choice(p, k, replace=False)] = rng.uniform(-lo, lo, k)
        noise = rng.normal(0, 1, n) * (0.3 if logistic else 1.0)
        y = X @ torch.from_numpy(w).to(X.device) + torch.from_numpy(
            noise).to(X.device)
        if logistic:
            y = torch.where(y >= 0, 1.0, -1.0).to(X.dtype)
        ys.append(y)
    return torch.stack(ys)


def fleet_phase(name, X, Y, fracs, loss_name, serial_expect, fleet_expect):
    """Solve the fleet under ``auto`` (counted) and certify each problem;
    solve each problem serially (uncounted) and hold the fleet's row
    against it bit for bit; print the walls and profile the fleet.
    Returns (result, lams, launch counts, the fleet's h)."""
    import torch
    import repro_torch as rt
    from repro_torch.kernels import ops

    loss = rt.get_loss(loss_name)
    lms = [float(rt.lambda_max(loss, X, y)) for y in Y]
    lams = [f * lm for f, lm in zip(fracs, lms)]
    cfg = rt.SaifConfig(eps=1e-6, loss=loss_name)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = rt.fleet_solve(X, Y, lams, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    print(f"[{name}] B={Y.shape[0]} n={X.shape[0]} p={X.shape[1]} "
          f"k_max={res.active_idx.shape[1]} wall_s={wall:.3f} "
          f"launches={counts}", flush=True)
    check_launches(name, counts, fleet_expect)
    walls, bad = [], []
    for i, lam in enumerate(lams):
        kkt = float(rt.kkt_residual(loss, X, Y[i], res.beta[i], lam))
        gap = float(res.gap[i])
        t0 = time.perf_counter()
        s = rt.saif(X, Y[i], lam, cfg)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        same = (torch.equal(res.beta[i], s.beta)
                and torch.equal(res.gap[i], s.gap)
                and int(res.n_outer[i]) == s.n_outer
                and int(res.n_active[i]) == s.n_active
                and bool(res.overflowed[i]) == s.overflowed
                and all(torch.equal(getattr(res, f)[i], getattr(s, f))
                        for f in ("trace_gap", "trace_dual",
                                  "trace_n_active", "trace_screened",
                                  "trace_survivors", "trace_post_viol")))
        print(f"[{name}/{i}] lam/lam_max={fracs[i]:.4f} "
              f"outer={int(res.n_outer[i])} n_active={int(res.n_active[i])} "
              f"support={len(support(res.beta[i]))} gap={gap:.3e} "
              f"kkt={kkt:.3e} kkt_limit={1e-3 * lam:.3e} "
              f"serial_k_max={s.active_idx.shape[0]} serial_wall_s="
              f"{walls[-1]:.3f} bitwise_serial={same}", flush=True)
        if not (gap <= cfg.eps and kkt <= 1e-3 * lam and same):
            bad.append(i)
    # the serial solves' own kernels (uncounted above)
    ops.reset_launch_counts()
    rt.saif(X, Y[0], lams[0], cfg)
    check_launches(f"{name}/serial", ops.launch_counts(), serial_expect)
    print(f"[{name}] fleet_wall_s={wall:.3f} serial_walls_sum_s="
          f"{sum(walls):.3f} outer_per_problem="
          f"{res.n_outer.tolist()}", flush=True)
    if bad:
        raise RuntimeError(f"{name}: problems {bad} not certified or not "
                           f"bitwise their serial solves")
    profile_solve(name, lambda: rt.fleet_solve(X, Y, lams, cfg), wall)
    from repro_torch.core.batch import fleet_batch_sizes, prepare_fleet
    _, h = fleet_batch_sizes(prepare_fleet(X, Y, cfg), lams, cfg)
    return res, lams, counts, h


def plain_fleet_phase(X, Y, lams, kres):
    """The plain fleet (``torch`` screen and inner) on the card against the
    kernel fleet's rows ``kres``."""
    import torch
    import repro_torch as rt
    from repro_torch.kernels import ops

    cfg = rt.SaifConfig(eps=1e-6, screen_backend="torch",
                        inner_backend="torch")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = rt.fleet_solve(X, Y, lams, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_launches("fleet-plain", ops.launch_counts(),
                   {k: False for k in ops.KERNELS})
    for i in range(Y.shape[0]):
        ok = (support(res.beta[i]) == support(kres[i])
              and bool(torch.allclose(res.beta[i], kres[i], rtol=1e-6,
                                      atol=1e-8))
              and float(res.gap[i]) <= cfg.eps)
        print(f"[fleet-plain/{i}] outer={int(res.n_outer[i])} "
              f"support={len(support(res.beta[i]))} "
              f"gap={float(res.gap[i]):.3e} max_abs_dev_vs_kernel_fleet="
              f"{float((res.beta[i] - kres[i]).abs().max()):.3e} ok={ok}",
              flush=True)
        if not ok:
            raise RuntimeError("fleet-plain disagrees with the kernel fleet")
    print(f"[fleet-plain] B={Y.shape[0]} wall_s={wall:.3f}", flush=True)


def check_fleet_kernels(dtype, X, Y, lams, h, res, loss_name, records):
    """K1b, K2b and K3b against their plain versions and against B
    launches of K1, K2 and K3, at the fleet's shapes."""
    import torch
    from repro_torch.core.active_set import compact_order
    from repro_torch.kernels import ops

    dt = getattr(torch, dtype)
    isz = torch.finfo(dt).bits // 8
    tol = {"float64": 1e-10, "float32": 1e-4}[dtype]
    Xd = X.to(dt)
    n, p = Xd.shape
    b = Y.shape[0]
    g = torch.Generator(device="cpu").manual_seed(1)
    Theta = (torch.randn(b, n, generator=g, dtype=torch.float64) / n).to(
        Xd.device, dt)
    col_norm = torch.linalg.vector_norm(Xd, dim=0)
    active = torch.zeros(b, p, dtype=torch.bool, device=Xd.device)
    for i in range(b):
        active[i, res.active_idx[i][res.active_mask[i]]] = True
    r = torch.linspace(0.01, 0.1, b, dtype=dt, device=Xd.device)
    h_tile = min(h, 256)
    pb = -(-p // 256)

    # K1b against its twin; candidate ids as K1's (near ties reported)
    k1 = ops.screen_fused_batch(Xd, Theta, col_norm, active, r, h=h)
    ref = ops.screen_fused_batch_ref(Xd, Theta, col_norm, active, r, h=h)
    abs1, err1 = errs(zip((k1[0], k1[1], k1[2], k1[3], k1[5]),
                          (ref[0], ref[1], ref[2], ref[3], ref[5])))
    fin = torch.isfinite(ref[3])
    ids_k, ids_p = k1[4][fin].long(), ref[4][fin].long()
    swapped = ids_k != ids_p
    rows = torch.nonzero(fin)[:, 0][swapped]
    s_ref = ref[0]
    scale1 = float(ref[3][fin].abs().max())
    tie = ((s_ref[rows, ids_k[swapped]] - s_ref[rows, ids_p[swapped]]).abs()
           <= tol * scale1)
    ids_ok = bool(tie.all()) and (dtype == "float32" or
                                  int(swapped.sum()) == 0)
    # bitwise B launches of K1
    same1 = True
    for i in range(b):
        one = ops.screen_fused(Xd, Theta[i].contiguous(), col_norm,
                               active[i].contiguous(), r[i], h=h)
        same1 = same1 and all(torch.equal(a[i], o) for a, o in zip(k1, one))
    ms1 = time_ms(lambda: ops.screen_fused_batch(Xd, Theta, col_norm, active,
                                                 r, h=h), 10)
    plain1 = time_ms(lambda: ops.screen_fused_batch_ref(
        Xd, Theta, col_norm, active, r, h=h), 2)
    lib1 = time_ms(lambda: torch.abs(Theta @ Xd), 10)
    b1, by1 = bound_ms(n * p * isz + b * n * isz + p * isz + b * p + b
                       * isz + 3 * b * p * isz + b * pb * h_tile * (isz + 4)
                       + b * pb * isz, 2 * n * p * b, dtype)
    print(f"[kernel screen_fused_batch {dtype}] B={b} n={n} p={p} h={h} "
          f"max_abs_err={abs1:.3e} rel_err={err1:.3e} tol={tol:.0e} "
          f"ids_ok={ids_ok} (ids differing at near-ties: "
          f"{int(swapped.sum())} of {int(fin.sum())}) bitwise_B_x_K1="
          f"{same1} ms={ms1:.4f} plain_ms={plain1:.4f} "
          f"library_ms(abs(Theta@X))={lib1:.4f} bound_ms={b1:.4f} ({by1})",
          flush=True)
    if not (err1 <= tol and ids_ok and same1):
        raise RuntimeError(f"screen_fused_batch {dtype} disagrees")

    # K2b on the scan's ub against each problem's h smallest finite lb
    ub = ref[1]
    lb_sorted = torch.stack([torch.sort(ref[2][i][torch.isfinite(
        ref[2][i])][:h]).values for i in range(b)])
    hist = ops.ub_histogram_batch(ub, lb_sorted)
    err2 = int((hist - ops.ub_histogram_batch_ref(ub, lb_sorted)).abs().max())
    same2 = all(torch.equal(hist[i], ops.ub_histogram(ub[i], lb_sorted[i]))
                for i in range(b))
    ms2 = time_ms(lambda: ops.ub_histogram_batch(ub, lb_sorted), 20)
    plain2 = time_ms(lambda: ops.ub_histogram_batch_ref(ub, lb_sorted), 2)
    b2, by2 = bound_ms(b * p * isz + b * h * isz + b * (h + 1) * 4,
                       b * p * h, dtype)
    print(f"[kernel ub_histogram_batch {dtype}] B={b} p={p} h={h} "
          f"max_abs_err={err2} tol=0 bitwise_B_x_K2={same2} ms={ms2:.4f} "
          f"plain_ms={plain2:.4f} bound_ms={b2:.6f} ({by2})", flush=True)
    if err2 != 0 or not same2:
        raise RuntimeError(f"ub_histogram_batch {dtype} disagrees")

    # K3b at each problem's final active block, from beta = 0, one polish
    # burst; the last problem frozen (0 epochs), as the fleet does
    mask = res.active_mask
    k = mask.shape[1]
    count = mask.sum(dim=1).to(torch.int32)
    order = torch.stack([compact_order(torch.arange(k, device=mask.device),
                                       m) for m in mask])
    AT = torch.where(mask[:, :, None], Xd.T[res.active_idx], 0.0)
    cn = torch.where(mask, col_norm[res.active_idx], 0.0)
    col_sq = cn * cn
    Yd = Y.to(dt)
    lam_t = torch.tensor(lams, dtype=dt, device=Xd.device)
    n_ep = torch.full((b,), 40, dtype=torch.int32, device=Xd.device)
    n_ep[-1] = 0
    beta0 = torch.zeros(b, k, dtype=dt, device=Xd.device)

    def run_k():
        return ops.cm_burst_batch_xt(AT, Yd, beta0, col_sq, mask, order,
                                     lam_t, n_ep, count, loss_name=loss_name)

    def run_p():
        return ops.cm_burst_batch_ref(AT.transpose(1, 2), Yd, beta0, col_sq,
                                      mask, order, lam_t, n_ep, count,
                                      loss_name=loss_name)

    out, pout = run_k(), run_p()
    abs3 = err3 = 0.0
    same3 = True
    for i in range(b):
        a_i, e_i = burst_error(loss_name, [o[i] for o in out],
                               [o[i] for o in pout], Yd[i], lams[i])
        abs3, err3 = max(abs3, a_i), max(err3, e_i)
        one = ops.cm_burst_xt(AT[i].contiguous(), Yd[i].contiguous(),
                              beta0[i], col_sq[i].contiguous(), mask[i],
                              order[i], float(lam_t[i]), int(n_ep[i]),
                              int(count[i]),
                              loss_name=loss_name)
        same3 = same3 and all(torch.equal(o[i], s) for o, s in zip(out, one))
    tol3 = {"float64": 1e-12, "float32": 1e-3}[dtype]
    ms3 = time_ms(run_k, 3)
    plain3 = time_ms(run_p, 1)
    steps = int((n_ep.long() * count.long()).sum())
    flops = steps * 4 * n + b * 4 * n * k
    b3, by3 = bound_ms(b * (k * n * isz + 3 * n * isz + 3 * k * isz + 5 * k
                            + isz), flops, dtype)
    print(f"[kernel cm_burst_batch {dtype} {loss_name}] B={b} n={n} k={k} "
          f"live={count.tolist()} n_epochs=40 (last problem 0) "
          f"max_abs_err={abs3:.3e} rel_err={err3:.3e} tol={tol3:.0e} "
          f"bitwise_B_x_K3={same3} ms={ms3:.4f} plain_ms={plain3:.4f} "
          f"bound_ms={b3:.6f} ({by3})", flush=True)
    if not (err3 <= tol3 and same3):
        raise RuntimeError(f"cm_burst_batch {dtype} disagrees")
    if dtype == "float64":
        records["screen_fused_batch"].update(
            max_abs_err=abs1, ms=ms1, plain_ms=plain1, bound_ms=b1,
            bound_by=by1, library_ms=lib1)
        records["ub_histogram_batch"].update(
            max_abs_err=err2, ms=ms2, plain_ms=plain2, bound_ms=b2,
            bound_by=by2, library_ms=None)
        records["cm_burst_batch"].update(
            max_abs_err=abs3, ms=ms3, plain_ms=plain3, bound_ms=b3,
            bound_by=by3, library_ms=None)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--p", type=int, default=100_000,
                    help="features of phases 2-4; cut it for a quick "
                         "shakedown")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch as rt
        from repro_torch.kernels import _build, ops
    except ImportError as e:
        print(f"chip_smoke: repro_torch not found beside this script ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)

    secs = _build.build()
    print(f"[build] nvcc, {len(_build.SOURCES)} sources in parallel: "
          f"{secs:.1f} s", flush=True)

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    Xn, yn = simulation_data(N, args.p)
    X = torch.from_numpy(Xn).to(dev)
    y = torch.from_numpy(yn).to(dev)
    Ln, yl = logistic_data(N, args.p)
    XL = torch.from_numpy(Ln).to(dev)
    yL = torch.from_numpy(yl).to(dev)
    del Xn, Ln
    print(f"[data] LS and logistic X ({N}, {args.p}) float64 on the "
          f"card in {time.perf_counter() - t0:.1f} s", flush=True)

    plain_lasso = {"cm_burst_pen": False, "chain_suffix_sums": False,
                   "screen_fused_batch": False, "ub_histogram_batch": False,
                   "cm_burst_batch": False}
    on = {"screen_fused": True, "ub_histogram": True, **plain_lasso}
    ls = rt.get_loss("least_squares")
    lm = float(rt.lambda_max(ls, X, y))
    lam = LS_LAM * lm
    cfg = rt.SaifConfig(eps=1e-6)
    ls_res, ls_counts = solve_phase(
        "ls", lam, cfg,
        {"auto": {},
         "gram": {"inner_backend": "gram"},
         "plain": {"screen_backend": "torch", "inner_backend": "torch"}},
        {"auto": {**on, "cm_burst": True},
         "gram": {**on, "cm_burst": False},
         "plain": {k: False for k in ops.KERNELS}},
        lambda c: rt.saif(X, y, lam, c),
        lambda r: rt.kkt_residual(ls, X, y, r.beta, lam),
        profiled=("auto",))

    lg = rt.get_loss("logistic")
    lmL = float(rt.lambda_max(lg, XL, yL))
    lamL = LOGIT_LAM * lmL
    cfgL = rt.SaifConfig(eps=1e-6, loss="logistic")
    lg_res, lg_counts = solve_phase(
        "logistic", lamL, cfgL, {"auto": {}},
        {"auto": {**on, "cm_burst": True}},
        lambda c: rt.saif(XL, yL, lamL, c),
        lambda r: rt.kkt_residual(lg, XL, yL, r.beta, lamL),
        profiled=("auto",))

    records = {
        "screen_fused": {"name": "screen_fused", "route": "cuda",
                         "source": "src/repro_torch/csrc/screen.cu",
                         "replaces": "src/repro/kernels/screen/screen.py:271"},
        "ub_histogram": {"name": "ub_histogram", "route": "cuda",
                         "source": "src/repro_torch/csrc/screen.cu",
                         "replaces": "src/repro/kernels/screen/screen.py:512"},
        "cm_burst": {"name": "cm_burst", "route": "cuda",
                     "source": "src/repro_torch/csrc/cm_burst.cu",
                     "replaces": "src/repro/kernels/cm/cm.py:355"},
        "cm_burst_pen": {"name": "cm_burst_pen", "route": "cuda",
                         "source": "src/repro_torch/csrc/cm_burst.cu",
                         "replaces": "src/repro/kernels/cm/cm.py:184"},
        "chain_suffix_sums": {"name": "chain_suffix_sums", "route": "cuda",
                              "source": "src/repro_torch/csrc/chain_suffix.cu",
                              "replaces": "src/repro/kernels/fused/fused.py:76"},
        "screen_fused_batch": {
            "name": "screen_fused_batch", "route": "cuda",
            "source": "src/repro_torch/csrc/screen.cu",
            "replaces": "src/repro/kernels/screen/screen.py:394"},
        "ub_histogram_batch": {
            "name": "ub_histogram_batch", "route": "cuda",
            "source": "src/repro_torch/csrc/screen.cu",
            "replaces": "src/repro/kernels/screen/screen.py:562"},
        "cm_burst_batch": {
            "name": "cm_burst_batch", "route": "cuda",
            "source": "src/repro_torch/csrc/cm_burst.cu",
            "replaces": "src/repro/kernels/cm/cm.py:296"},
    }

    k4_launches = transform_phase(X, records)
    fused, fused_counts = fused_phases()

    import numpy as np
    serial_only = {"screen_fused": True, "ub_histogram": True,
                   "cm_burst": True, "screen_fused_batch": False,
                   "ub_histogram_batch": False, "cm_burst_batch": False}
    fleet_only = {"screen_fused": False, "ub_histogram": False,
                  "cm_burst": False, "cm_burst_pen": False,
                  "chain_suffix_sums": False, "screen_fused_batch": True,
                  "ub_histogram_batch": True, "cm_burst_batch": True}
    Yf = fleet_responses(X, FLEET_LS[2], seed=100)
    fracs = np.geomspace(FLEET_LS[0], FLEET_LS[1], FLEET_LS[2]).tolist()
    fl_res, fl_lams, fl_counts, fl_h = fleet_phase(
        "fleet-ls", X, Yf, fracs, "least_squares", serial_only, fleet_only)
    YL = fleet_responses(XL, FLEET_LOGIT[2], seed=200, logistic=True, k=40)
    fracsL = np.geomspace(FLEET_LOGIT[0], FLEET_LOGIT[1],
                          FLEET_LOGIT[2]).tolist()
    _, _, flg_counts, _ = fleet_phase(
        "fleet-logistic", XL, YL, fracsL, "logistic", serial_only,
        fleet_only)
    pick = [0, FLEET_LS[2] - 1]
    plain_fleet_phase(X, Yf[pick], [fl_lams[i] for i in pick],
                      fl_res.beta[pick])

    runs = [ls_counts["auto"], ls_counts["gram"], lg_counts["auto"],
            *fused_counts, fl_counts, flg_counts]
    for k, rec in records.items():
        rec["launches"] = sum(c[k] for c in runs) + (
            k4_launches if k == "chain_suffix_sums" else 0)

    from repro_torch.core.saif import add_batch_size_static, prepare_path
    prep = prepare_path(X, y, cfg)
    h = add_batch_size_static(cfg.c, lam, prep.c0_max, prep.c0_median,
                              args.p)
    del prep
    for dtype in ("float64", "float32"):
        check_kernels(dtype, X, y, lam, h, ls_res["auto"], (XL, yL, lamL),
                      lg_res["auto"], fused, records)
        check_fleet_kernels(dtype, X, Yf, fl_lams, fl_h, fl_res,
                            "least_squares", records)

    print(json.dumps({"kernels": list(records.values())}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
