#!/usr/bin/env python3
"""Drive repro_torch's main path on one NVIDIA card and hold its kernels
against their plain PyTorch versions.

    python3 chip_smoke.py            # from the repository root

Phases (each one fails the run by raising):

1. build the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, one process
   per source, in parallel) and print the seconds;
2. least squares at full size: the paper's Sec 5.1.1 simulation (X ~
   U[-10, 10], 20% of the betas nonzero in [-1, 1], N(0, 1) noise) at
   n = 1000, p = 100,000, float64, solved three ways — ``auto`` (K1/K2
   screen + gram inner), ``inner_backend="cuda"`` (K3 on least squares) and
   ``torch``/``torch`` (the plain path, on the card). Each solve must be
   certified on the card (gap <= eps, KKT residual <= 1e-3 lam) and all
   three must find the same support;
3. logistic at full size: gaussian design, 40 true features, labels from
   their sign (n = 1000, p = 100,000, float64); ``auto`` must route the
   burst through K3; the same certificates;
4. every kernel against its plain version on the card, in float64 and
   float32, at the shapes the solves gave it: max error against a stated
   tolerance, the kernel's time, the plain version's time, the time of a
   PyTorch call computing the same function where one exists, and the
   least time the card could take (bytes or operations, whichever bounds).

Launch counters are zeroed just before each solve and read just after;
the kernel launches of phase 4, and of one extra solve of the K3 runs
under torch.profiler (the device's busy time and idle share), do not
count. The last two lines are the
card's name and power limit and ``{"ok": true, "device": {...}}``; the
line before them is the per-kernel JSON record.
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


def solve_phase(name, X, y, lam, cfg, runs, expect, profiled=()):
    """Run ``saif`` once per entry of ``runs`` (label -> config overrides),
    certify each solve on the card and check the launch counts; the labels
    in ``profiled`` are then profiled in one more, uncounted solve."""
    import dataclasses
    import torch
    import repro_torch as rt
    from repro_torch.kernels import ops

    loss = rt.get_loss(cfg.loss)
    results, launches = {}, {}
    for label, over in runs.items():
        c = dataclasses.replace(cfg, **over)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = rt.saif(X, y, lam, c)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        kkt = float(rt.kkt_residual(loss, X, y, res.beta, lam))
        gap = float(res.gap)
        print(f"[{name}/{label}] outer={res.n_outer} n_active="
              f"{res.n_active} k_max={res.active_idx.shape[0]} gap={gap:.3e}"
              f" eps={c.eps:.1e} kkt={kkt:.3e} kkt_limit={1e-3 * lam:.3e} "
              f"wall_s={wall:.3f} launches={counts}", flush=True)
        if not (gap <= c.eps and kkt <= 1e-3 * lam):
            raise RuntimeError(f"{name}/{label}: solve not certified")
        for kname, must in expect[label].items():
            if must and counts[kname] == 0:
                raise RuntimeError(f"{name}/{label}: kernel {kname} was "
                                   f"never launched on the main path")
            if not must and counts[kname] != 0:
                raise RuntimeError(f"{name}/{label}: kernel {kname} "
                                   f"launched on a plain run")
        results[label] = res
        launches[label] = counts
        if label in profiled:
            profile_solve(f"{name}/{label}",
                          lambda: rt.saif(X, y, lam, c), wall)
    sups = {label: support(r.beta) for label, r in results.items()}
    first = next(iter(sups.values()))
    if any(s != first for s in sups.values()):
        raise RuntimeError(f"{name}: supports differ across runs: "
                           f"{ {k: len(v) for k, v in sups.items()} }")
    print(f"[{name}] support size {len(first)} identical across "
          f"{list(sups)}", flush=True)
    return results, launches


def check_kernels(dtype, X, y, lam, h, ls_res, logit, logit_res, records):
    """Hold K1, K2, K3 against their plain versions at the solves' shapes."""
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

    def errs(pairs):
        """(max abs error, max error over each reference's own scale) on
        the finite entries; a different non-finite pattern is inf."""
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
        # beta, z, theta against their own scale; the gap, a difference
        # P - D of two near-equal objectives, against the scale of D
        abs3, err3 = errs(zip(out[:3], ref[:3]))
        d_scale = 1.0 + abs(float(rt.get_loss(loss_name).dual_objective(
            ys, ref[2], lam_s)))
        gap_err = abs(float(out[3]) - float(ref[3]))
        abs3, err3 = max(abs3, gap_err), max(err3, gap_err / d_scale)
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--p", type=int, default=100_000,
                    help="features; cut it for a quick shakedown")
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

    on = {"screen_fused": True, "ub_histogram": True}
    lm = float(rt.lambda_max(rt.get_loss("least_squares"), X, y))
    lam = LS_LAM * lm
    cfg = rt.SaifConfig(eps=1e-6)
    ls_res, ls_counts = solve_phase(
        "ls", X, y, lam, cfg,
        {"auto": {},
         "cuda-inner": {"inner_backend": "cuda"},
         "plain": {"screen_backend": "torch", "inner_backend": "torch"}},
        {"auto": {**on, "cm_burst": False},
         "cuda-inner": {**on, "cm_burst": True},
         "plain": {"screen_fused": False, "ub_histogram": False,
                   "cm_burst": False}},
        profiled=("cuda-inner",))

    lmL = float(rt.lambda_max(rt.get_loss("logistic"), XL, yL))
    lamL = LOGIT_LAM * lmL
    cfgL = rt.SaifConfig(eps=1e-6, loss="logistic")
    lg_res, lg_counts = solve_phase(
        "logistic", XL, yL, lamL, cfgL, {"auto": {}},
        {"auto": {**on, "cm_burst": True}}, profiled=("auto",))

    launches = {k: ls_counts["auto"][k] + ls_counts["cuda-inner"][k]
                + lg_counts["auto"][k] for k in ops.KERNELS}
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
    }
    for k, rec in records.items():
        rec["launches"] = launches[k]

    from repro_torch.core.saif import add_batch_size_static, prepare_path
    prep = prepare_path(X, y, cfg)
    h = add_batch_size_static(cfg.c, lam, prep.c0_max, prep.c0_median,
                              args.p)
    del prep
    for dtype in ("float64", "float32"):
        check_kernels(dtype, X, y, lam, h, ls_res["cuda-inner"],
                      (XL, yL, lamL), lg_res["auto"], records)

    print(json.dumps({"kernels": list(records.values())}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
