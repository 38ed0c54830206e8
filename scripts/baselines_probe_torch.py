#!/usr/bin/env python3
"""The paper's baselines on one NVIDIA card at the least-squares cell's
size, beside SAIF, and the wide CM sweep K7 that runs them.

    python3 scripts/baselines_probe_torch.py --p 100000 20000 --cap 300

Builds ``csrc/cm_wide.cu`` with ``-Xptxas -v`` (registers, spills), holds
K7 against its plain version on the card at the cases of
``chip_smoke.wide_cases`` (float64 and float32, the smoke's tolerances)
and times it from beta = 0 over the full LS design (one epoch, device ms
from torch.profiler, microseconds per step). Then, at each ``--p``, on
the paper's Sec 5.1.1 simulation (n = 1000, float64, 0.3 lambda_max,
eps = 1e-6): SAIF ``auto``, then the five runs of ``chip_smoke.py``'s
``[baselines-ls]`` (dynamic screening, the sequential path and the
KKT-checked homotopy over 0.95 -> 0.3 lambda_max in 5 points, the unsafe
homotopy, the unscreened CM), each with its wall, the wall over SAIF's,
K7 launches, outer steps and coordinate updates, its KKT residual over
all p and whether it finds SAIF's support. A run longer than ``--cap``
seconds is stopped and printed as such. The walls at full p, and the cut
p that keeps the smoke's five runs inside its budget, come from here.
``--gaps`` runs the two paths only, after the K7 checks, and prints each
reduced solve's outer steps, its last gaps and the gap's precision floor,
as ``scripts/ref_baselines_probe.py --gaps`` does for the reference.

Two source trees are held bit for bit against each other as
``scripts/cm_probe_torch.py`` does it:

    python3 scripts/baselines_probe_torch.py --src OTHER/src \
        --save-hashes a.json                                   # another tree
    python3 scripts/baselines_probe_torch.py --compare-hashes a.json

Every K7 output is fingerprinted (sha256 of its bytes): beta and z at
every case of ``wide_cases`` and at the three timing shapes (k = 2,000,
20,000 and the full width, one epoch from 0) in float64 and float32, and
at the warm full-width case of ``chip_smoke.check_cm_wide_warm`` (5
epochs from one epoch's beta, float64); and at the largest ``--p`` every
baseline's betas and its integer outputs (outer steps, coordinate
updates, K7 launches, survivor history, screened fractions or support
sizes). ``--compare-hashes`` fails the run when one differs from the
saved ones. ``--sass DIR`` writes ``cuobjdump -sass`` of ``cm_wide.cu``.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import signal
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


class _Cap(Exception):
    pass


def _alarm(signum, frame):
    raise _Cap()


def print_path_gaps(X, y, lm):
    """The sequential path and the KKT-checked homotopy over BASE_PATH,
    printing for each reduced solve its outer steps, its last three gaps
    and the gap's precision floor at its last dual point."""
    import numpy as np
    import repro_torch as rt
    import repro_torch.core.sequential as seq_mod
    from chip_smoke import BASE_PATH
    from repro_torch.core.duality import duality_gap, gap_precision_floor
    gaps = []

    def gap(loss, Xa, yy, beta, theta, lam, *a, **k):
        g = duality_gap(loss, Xa, yy, beta, theta, lam, *a, **k)
        gaps.append((float(g), float(gap_precision_floor(theta, lam))))
        return g

    seq_mod.duality_gap = gap
    lams = (np.geomspace(BASE_PATH[0], BASE_PATH[1], BASE_PATH[2])
            * lm).tolist()
    for tag, run in (("sequential", lambda: rt.sequential_path(
            X, y, lams, rt.SeqConfig(eps=1e-6))),
                     ("homotopy", lambda: rt.homotopy_path(
            X, y, lams, rt.HomotopyConfig(eps=1e-6, kkt_check=True)))):
        gaps.clear()
        r = run()
        print(f"[{tag} p={X.shape[1]}] coord_updates={r.coord_updates}",
              flush=True)
        solve = []
        for g, f in gaps:
            solve.append(g)
            if g <= 1e-6:
                print(f"[gaps {tag} p={X.shape[1]}] steps={len(solve)} gaps="
                      f"{[float(f'{x:.4g}') for x in solve[-3:]]} "
                      f"floor={f:.3e}", flush=True)
                solve = []


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--p", type=int, nargs="+", default=[100_000])
    ap.add_argument("--cap", type=int, default=300,
                    help="seconds one baseline run may take")
    ap.add_argument("--gaps", action="store_true",
                    help="the two paths only, with every reduced solve's "
                         "gaps")
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the source tree whose repro_torch is probed")
    ap.add_argument("--sass", default=None,
                    help="write cuobjdump -sass of cm_wide.cu here")
    ap.add_argument("--save-hashes", default=None)
    ap.add_argument("--compare-hashes", default=None)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("baselines_probe_torch: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(0, str(ROOT))
    import repro_torch as rt
    from chip_smoke import (BASE_PATH, LOGIT_LAM, LS_LAM, N, baseline_runs,
                            errs, kernel_ms, logistic_data, nvidia_smi_line,
                            simulation_data, support, wide_cases)
    from repro_torch.kernels import _build, ops

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {nvidia_smi_line()}; torch {torch.__version__}; "
          f"src {rt.__file__}", flush=True)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
           str(_build._lib_path("cm_wide")), str(_build.CSRC / "cm_wide.cu")]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, capture_output=True, text=True)
    print(f"[ptxas cm_wide.cu] {time.perf_counter() - t0:.1f} s\n"
          f"{out.stdout}{out.stderr}", flush=True)
    if out.returncode != 0:
        return 1
    if args.sass:
        d = Path(args.sass)
        d.mkdir(parents=True, exist_ok=True)
        sass = subprocess.run(
            [str(Path(_build.nvcc()).parent / "cuobjdump"), "-sass",
             str(_build._lib_path("cm_wide"))], capture_output=True,
            text=True).stdout
        (d / "cm_wide.sass").write_text(sass)
        print(f"[sass cm_wide.cu] {len(sass.splitlines())} lines in {d}",
              flush=True)
    _build.build()                # the other kernels, outside SAIF's wall
    hashes = {}

    def fp(tag, outs):
        for i, t in enumerate(outs):
            if f"{tag}/{i}" in hashes:
                raise KeyError(f"fingerprint {tag}/{i} taken twice")
            hashes[f"{tag}/{i}"] = hashlib.sha256(
                t.contiguous().cpu().numpy().tobytes()).hexdigest()

    dev = torch.device("cuda")
    ls = rt.get_loss("least_squares")
    lg = rt.get_loss("logistic")
    signal.signal(signal.SIGALRM, _alarm)

    p0 = max(args.p)
    Xn, yn = simulation_data(N, p0)
    X, y = torch.from_numpy(Xn).to(dev), torch.from_numpy(yn).to(dev)
    Ln, yl = logistic_data(N, 2000)
    XL, yL = torch.from_numpy(Ln).to(dev), torch.from_numpy(yl).to(dev)
    del Xn, Ln
    lm = float(rt.lambda_max(ls, X, y))
    lamL = LOGIT_LAM * float(rt.lambda_max(lg, XL, yL))
    for dtype, tol in (("float64", 1e-9), ("float32", 1e-3)):
        dt = getattr(torch, dtype)
        parts, worst = [], 0.0
        for name, a, loss_name in wide_cases(X, y, LS_LAM * lm, XL, yL, lamL,
                                             dt):
            b1, z1 = ops.cm_sweep_wide(*a, loss_name=loss_name)
            torch.cuda.synchronize()
            fp(f"k7 {dtype} {name}", (b1, z1))
            b2, z2 = ops.cm_sweep_wide_ref(*a, loss_name=loss_name)
            _, r = errs([(b1, b2), (z1, z2)])
            dead = bool((b1[~a[5]] == 0).all())
            worst = max(worst, r if dead else float("inf"))
            parts.append(f"{name}: rel_err={r:.3e} dead_ok={dead};")
        print(f"[k7 {dtype}] " + " ".join(parts) + f" tol={tol:.0e}",
              flush=True)
        if not worst <= tol:
            print(f"[k7 {dtype}] disagrees with its plain version",
                  flush=True)
            return 1
        for label, k in (("k=2000", 2000), ("k=20000", 20_000),
                         ("full width", p0)):
            XT = X[:, :k].T.contiguous().to(dt)
            a = (XT, y.to(dt), torch.zeros(k, dtype=dt, device=dev),
                 torch.zeros(N, dtype=dt, device=dev), (XT * XT).sum(1),
                 torch.ones(k, dtype=torch.bool, device=dev),
                 torch.arange(k, device=dev), LS_LAM * lm, 1, k)
            out = ops.cm_sweep_wide(*a)
            fp(f"k7 {dtype} timing {label}", out)
            ms, call = kernel_ms(lambda: ops.cm_sweep_wide(*a), 3,
                                 "cm_wide_kernel")
            print(f"[k7 {dtype}] {label} n={N} k={k} one epoch from 0: "
                  f"ms={ms:.4f} call_ms={call:.4f} us_per_step="
                  f"{ms * 1e3 / k:.4f}", flush=True)
            if label == "full width" and dtype == "float64":
                # chip_smoke.check_cm_wide_warm's launch, without its twin
                warm = (XT, a[1], out[0], XT.T @ out[0]) + a[4:8] + (5, k)
                fp("k7 float64 timing full width warm 5 epochs",
                   ops.cm_sweep_wide(*warm))
                del warm
            del XT, a, out

    if args.gaps:
        print_path_gaps(X, y, lm)
        return finish(hashes, args)
    for p in sorted(args.p, reverse=True):
        if p != p0:
            Xn, yn = simulation_data(N, p)
            X, y = torch.from_numpy(Xn).to(dev), torch.from_numpy(yn).to(dev)
            del Xn
            lm = float(rt.lambda_max(ls, X, y))
        lam = LS_LAM * lm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = rt.saif(X, y, lam, rt.SaifConfig(eps=1e-6))
        torch.cuda.synchronize()
        saif_wall = time.perf_counter() - t0
        truth = support(res.beta)
        print(f"[saif p={p}] wall_s={saif_wall:.3f} outer={res.n_outer} "
              f"support={len(truth)} gap={float(res.gap):.3e}", flush=True)
        lams = (np.geomspace(BASE_PATH[0], BASE_PATH[1], BASE_PATH[2])
                * lm).tolist()
        total = 0.0
        for name, call, _ in baseline_runs(X, y, lam, lams):
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            signal.alarm(args.cap)
            try:
                beta, betas, outer, updates, summary = call()
                torch.cuda.synchronize()
            except _Cap:
                torch.cuda.synchronize()
                print(f"[{name} p={p}] stopped at the cap of {args.cap} s, "
                      f"k7_launches={ops.launch_counts()['cm_sweep_wide']}",
                      flush=True)
                total += args.cap
                continue
            finally:
                signal.alarm(0)
            wall = time.perf_counter() - t0
            total += wall
            k7 = ops.launch_counts()["cm_sweep_wide"]
            if p == p0:
                fp(f"{name} betas", [beta] + list(betas or []))
                hashes[f"{name} counts"] = json.dumps(
                    [outer, updates, k7, summary])
            kkt = float(rt.kkt_residual(ls, X, y, beta, lam)) / lam
            print(f"[{name} p={p}] wall_s={wall:.3f} wall_over_saif="
                  f"{wall / saif_wall:.2f} k7_launches={k7} outer={outer} "
                  f"coord_updates={updates} kkt_over_lam={kkt:.3e} "
                  f"saif_support={support(beta) == truth} summary={summary}",
                  flush=True)
        print(f"[baselines p={p}] five runs {total:.1f} s", flush=True)
    return finish(hashes, args)


def finish(hashes, args) -> int:
    """Save or compare the fingerprints; 1 when one differs."""
    if args.save_hashes:
        Path(args.save_hashes).parent.mkdir(parents=True, exist_ok=True)
        Path(args.save_hashes).write_text(json.dumps(hashes, indent=0))
    if args.compare_hashes:
        ref = json.loads(Path(args.compare_hashes).read_text())
        diff = sorted(k for k in ref if hashes.get(k) != ref[k])
        print(f"[bitwise] {len(ref) - len(diff)} of {len(ref)} outputs "
              f"equal bit for bit; differing: {diff}", flush=True)
        if diff:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
