#!/usr/bin/env python3
"""Time the screening scans K1 (``screen_fused``) and K1b
(``screen_fused_batch``) on one NVIDIA card at ``chip_smoke.py``'s shapes,
with the top-h epilogue (masked) and without it (unmasked), and the
screen's tail (K2 and K2b, and whatever else a screen call launches after
the scan), and fingerprint their outputs so that two source trees can be
held bit for bit against each other.

    python3 scripts/screen_probe_torch.py                      # this tree
    python3 scripts/screen_probe_torch.py --src OTHER/src \\
        --save-hashes a.json                                   # another tree
    python3 scripts/screen_probe_torch.py --compare-hashes a.json
    python3 scripts/screen_probe_torch.py --solves             # and solves

The design is the smoke's least-squares X (the Sec 5.1.1 simulation,
n = 1000, p = 100,000, float64, and its float32 copy). The candidate
counts are the smoke's: the serial LS solve's h at 0.3 lambda_max, the
16-problem LS fleet's h, and the largest h of the 5-fold CV grid. Theta,
radii and active masks (500 random features per problem, as the solves
leave about 500 active) come from fixed seeds. It prints nvcc's
``-Xptxas -v`` report for ``csrc/screen.cu``, then one line per timing
(CUDA events, mean of ``--reps`` launches after a warm-up) beside the
PyTorch call for the same product, ``abs(theta @ X)``, and each scan's byte
bound (X read once per chunk of 16 problems at 3.35 TB/s), then a JSON
line. The tail: per screen call of the ``cuda`` backend (serial at the LS
h, the 16-problem fleet, the 5-fold CV shape with per-fold norms) every
output is fingerprinted, ``[screen-step]`` prints the device activities
torch.profiler counts in one call and the host microseconds per call, and
K2 / K2b's device time per launch (the histogram entry, which both trees
have, and the tail entry where the tree has one) is read from the
profiler beside the time of a call. ``--solves`` also runs the smoke's
least-squares and logistic ``auto`` solves, the 16-problem LS fleet and
the CV fold fleets (``cv_solve(refit=False)``), fingerprints their
results (beta, gap, outer steps, traces) and prints each one's wall (the
second of two runs) and, from one more profiled run, its device busy time
and idle share. Every output tensor of every probed launch is
fingerprinted (sha256 of its bytes); ``--compare-hashes`` fails the run
when one differs from the saved ones.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the source tree whose repro_torch is probed")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--save-hashes", default=None)
    ap.add_argument("--compare-hashes", default=None)
    ap.add_argument("--solves", action="store_true",
                    help="also fingerprint and time the smoke's solves")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("screen_probe_torch: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(0, str(ROOT))
    import repro_torch as rt
    from chip_smoke import (CV_FOLDS, CV_GRID, FLEET_LS, LS_LAM, N,
                            bound_ms, fleet_responses, nvidia_smi_line,
                            simulation_data, time_ms)
    from repro_torch.core.batch import fleet_batch_sizes, prepare_fleet
    from repro_torch.core.saif import add_batch_size_static, prepare_path
    from repro_torch.kernels import _build
    from repro_torch.kernels.screen import screen as sc

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {nvidia_smi_line()}; torch {torch.__version__}; "
          f"src {rt.__file__}", flush=True)
    so = _build.BUILD_DIR / "ptxas_screen.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    out = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                          "-o", str(so), str(_build.CSRC / "screen.cu")],
                         capture_output=True, text=True)
    print("[ptxas]\n" + out.stdout + out.stderr, flush=True)
    _build.build()

    dev = torch.device("cuda")
    Xn, yn = simulation_data(N, 100_000)
    X64 = torch.from_numpy(Xn).to(dev)
    y = torch.from_numpy(yn).to(dev)
    del Xn
    n, p = X64.shape
    cfg = rt.SaifConfig(eps=1e-6)
    ls = rt.get_loss("least_squares")
    lam = LS_LAM * float(rt.lambda_max(ls, X64, y))
    prep = prepare_path(X64, y, cfg)
    h1 = add_batch_size_static(cfg.c, lam, prep.c0_max, prep.c0_median, p)
    del prep
    Yf = fleet_responses(X64, FLEET_LS[2], seed=100)
    fracs = np.geomspace(FLEET_LS[0], FLEET_LS[1], FLEET_LS[2])
    lms = [float(rt.lambda_max(ls, X64, yy)) for yy in Yf]
    _, h16 = fleet_batch_sizes(prepare_fleet(X64, Yf, cfg),
                               [f * lm for f, lm in zip(fracs, lms)], cfg)
    ycv = fleet_responses(X64, 1, seed=300)[0]
    W = rt.kfold_weights(n, CV_FOLDS).to(X64)
    cprep = prepare_fleet(X64, ycv.expand(CV_FOLDS, n).contiguous(), cfg,
                          weights=W)
    lm_cv = float(rt.lambda_max(ls, X64, ycv))
    hcv = max(add_batch_size_static(cfg.c, f * lm_cv, mx, md, p)
              for f in np.geomspace(*CV_GRID)
              for mx, md in zip(cprep.c0_max, cprep.c0_median))
    del cprep
    print(f"[h] serial LS {h1}, LS fleet {h16}, CV grid max {hcv}",
          flush=True)

    g = torch.Generator(device="cpu").manual_seed(7)
    active = torch.zeros(16, p, dtype=torch.bool)
    for i in range(16):
        active[i, torch.randperm(p, generator=g)[:500]] = True
    active = active.to(dev)
    theta_all = (torch.randn(16, n, generator=g, dtype=torch.float64)
                 / n).to(dev)
    radii = torch.linspace(0.01, 0.1, 16, dtype=torch.float64, device=dev)
    XX = X64 * X64
    cn_rows = torch.stack([torch.sqrt(w @ XX) for w in W])
    del XX

    hashes, record = {}, {}

    def fp(tag, outs):
        for k, t in enumerate(outs):
            hashes[f"{tag}/{k}"] = hashlib.sha256(
                t.contiguous().cpu().numpy().tobytes()).hexdigest()

    for dtype in ("float64", "float32"):
        dt = getattr(torch, dtype)
        isz = torch.finfo(dt).bits // 8
        X = X64.to(dt)
        cn = torch.linalg.vector_norm(X, dim=0)
        Th = theta_all.to(dt)
        r = radii.to(dt)
        cnr = cn_rows.to(dt)
        pb = -(-p // 256)
        rows = {}

        def scan(entry, T, norms, act, rr, h, masked):
            return sc._scan(entry, X, T, norms, act, rr, max(1, min(h, 256)),
                            masked)

        def probe(tag, entry, b, h, norms, masked=True):
            T = Th[:b].contiguous()
            act = active[:b].contiguous() if masked else None
            rr = r[:b].contiguous()
            outs = scan(entry, T, norms, act, rr, h, masked)
            torch.cuda.synchronize()
            fp(f"{dtype}/{tag}", outs if masked else outs[:3])
            ms = time_ms(lambda: scan(entry, T, norms, act, rr, h, masked),
                         args.reps)
            h_tile = min(h, 256)
            nbytes = (n * p * isz * -(-b // 16) + b * n * isz
                      + (norms.numel()) * isz + b * isz + 3 * b * p * isz
                      + (b * p + b * pb * (h_tile * (isz + 4) + isz)
                         if masked else 0))
            bnd, by = bound_ms(nbytes, 2 * n * p * b, dtype)
            rows[tag] = {"ms": ms, "bound_ms": bnd, "bound_by": by}
            print(f"[probe {dtype}] {tag}: B={b} h={h} masked={masked} "
                  f"ms={ms:.4f} bound_ms={bnd:.4f} ({by}) "
                  f"at {bnd / ms:.1%} of the bound", flush=True)

        probe("K1 masked", "screen_fused", 1, h1, cn)
        probe("K1 unmasked", "screen_fused", 1, 1, cn, masked=False)
        probe("K1b B=16 masked", "screen_fused_batch", 16, h16, cn)
        probe("K1b B=16 unmasked", "screen_fused_batch", 16, 1, cn,
              masked=False)
        for hh in (1, 16, 64, 256):
            probe(f"K1b B=16 masked h={hh}", "screen_fused_batch", 16, hh, cn)
        probe("K1b B=5 cv norms masked", "screen_fused_batch", 5, hcv, cnr)
        probe("K1b B=5 cv norms unmasked", "screen_fused_batch", 5, 1, cnr,
              masked=False)
        th1 = Th[0].contiguous()
        rows["library K1 abs(theta@X)"] = time_ms(
            lambda: torch.abs(th1 @ X), args.reps)
        rows["library K1b abs(Theta@X) B=16"] = time_ms(
            lambda: torch.abs(Th @ X), args.reps)
        T5 = Th[:5].contiguous()
        rows["library K1b abs(Theta@X) B=5"] = time_ms(
            lambda: torch.abs(T5 @ X), args.reps)
        for k in ("library K1 abs(theta@X)", "library K1b abs(Theta@X) B=16",
                  "library K1b abs(Theta@X) B=5"):
            print(f"[probe {dtype}] {k}: ms={rows[k]:.4f}", flush=True)
        tail_probe(dtype, X, cn, cnr, Th, r, active, (h1, h16, hcv), rows,
                   fp, args.reps)
        record[dtype] = rows
        del X
    if args.solves:
        record["solves"] = solve_probe(X64, y, lam, Yf, fracs, lms, ycv,
                                       lm_cv, fp)

    print(json.dumps({"h": {"serial": h1, "fleet": h16, "cv": hcv},
                      "card": nvidia_smi_line(), "probe": record}))
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


def tail_probe(dtype, X, cn, cnr, Th, r, active, hs, rows, fp, reps):
    """The screen's tail at the smoke's three screen shapes: fingerprints
    of the ``cuda`` screen's outputs, ``[screen-step]``, and K2 / K2b's
    device and call times (histogram entry; tail entry where present)."""
    import torch
    from chip_smoke import kernel_ms, screen_step
    from repro_torch.core.screen_backend import (make_batch_screen_cuda,
                                                 make_screen_cuda)
    from repro_torch.kernels import ops
    from repro_torch.kernels.screen import screen as sc
    new = hasattr(sc, "screen_tail")
    k2 = "screen_tail_kernel" if new else "ub_hist_kernel"
    h1, h16, hcv = hs
    for tag, b, h, norms in (("serial", 1, h1, cn), ("fleet B=16", 16, h16, cn),
                             ("cv B=5", 5, hcv, cnr)):
        T, act, rr = Th[:b].contiguous(), active[:b].contiguous(), r[:b]
        if b == 1:
            sfn = make_screen_cuda(X, norms, h)

            def call():
                return [sfn(T[0], rr[0], act[0])]
        else:
            sfn = make_batch_screen_cuda(X, norms, h)
            ths, rs, acts = list(T), list(rr), list(act)

            def call():
                return sfn(ths, rs, acts, [True] * b)
        outs = call()
        torch.cuda.synchronize()
        fp(f"{dtype}/tail {tag}", [torch.stack([getattr(o, f) for o in outs])
                                   for f in outs[0]._fields])
        step = screen_step(f"{dtype} {tag}", call)
        # the histogram entry on the scan's ub against the sorted bounds
        _, ub, _, _, _, tmax = sc._scan(
            "screen_fused" if b == 1 else "screen_fused_batch", X, T, norms,
            act, rr.contiguous(), max(1, min(h, 256)), True)
        lbs = torch.sort(torch.stack([o.cand_lb for o in outs]), dim=1).values
        if b == 1:
            hist = lambda: ops.ub_histogram(ub[0], lbs[0])  # noqa: E731
        else:
            hist = lambda: ops.ub_histogram_batch(ub, lbs)  # noqa: E731
        fp(f"{dtype}/hist {tag}", [hist()])
        hdev, hcall = kernel_ms(hist, reps, k2)
        row = dict(step, hist_device_ms=hdev, hist_call_ms=hcall)
        line = (f"[probe {dtype}] K2 {tag}: h={h} histogram entry "
                f"device_ms={hdev:.5f} call_ms={hcall:.5f}")
        if new:
            sco = torch.stack([q.cand_score for q in outs])
            idx = torch.stack([q.cand_idx for q in outs])
            if b == 1:
                tail = lambda: ops.screen_tail(  # noqa: E731
                    ub[0], tmax[0], sco[0], idx[0], norms, rr[0])
            else:
                tail = lambda: ops.screen_tail_batch(  # noqa: E731
                    ub, tmax, sco, idx, norms, rr.contiguous())
            tdev, tcall = kernel_ms(tail, reps, k2)
            row.update(tail_device_ms=tdev, tail_call_ms=tcall)
            line += f"; tail entry device_ms={tdev:.5f} call_ms={tcall:.5f}"
        rows[f"K2 {tag}"] = row
        print(line, flush=True)


def solve_probe(X, y, lam, Yf, fracs, lms, ycv, lm_cv, fp):
    """The smoke's LS and logistic ``auto`` solves, the LS fleet and the CV
    fold fleets: fingerprints, walls (second of two runs), busy/idle."""
    import time

    import numpy as np
    import torch
    import repro_torch as rt
    from chip_smoke import (CV_FOLDS, CV_GRID, LOGIT_LAM, N, logistic_data,
                            profile_solve)
    cfg = rt.SaifConfig(eps=1e-6)
    Ln, yl = logistic_data(N, X.shape[1])
    XL = torch.from_numpy(Ln).to(X.device)
    yL = torch.from_numpy(yl).to(X.device)
    del Ln
    lamL = LOGIT_LAM * float(rt.lambda_max(rt.get_loss("logistic"), XL, yL))
    cfgL = rt.SaifConfig(eps=1e-6, loss="logistic")
    cv_lams = (np.geomspace(*CV_GRID[:2], CV_GRID[2]) * lm_cv).tolist()
    runs = {
        "ls/auto": lambda: rt.saif(X, y, lam, cfg),
        "logistic/auto": lambda: rt.saif(XL, yL, lamL, cfgL),
        "fleet-ls": lambda: rt.fleet_solve(
            X, Yf, [f * m for f, m in zip(fracs, lms)], cfg),
        "cv-ls": lambda: rt.cv_solve(X, ycv, cv_lams, n_folds=CV_FOLDS,
                                     config=cfg, keep_fold_betas=True,
                                     refit=False),
    }
    fields = ("beta", "gap", "n_outer", "n_active", "active_idx",
              "active_mask", "trace_gap", "trace_dual", "trace_n_active",
              "trace_screened", "trace_survivors", "trace_post_viol")
    out = {}
    for tag, solve in runs.items():
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = solve()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        results = res.fold_results if tag == "cv-ls" else [res]
        for k, rr in enumerate(results):
            fp(f"solve {tag}/{k}", [torch.as_tensor(getattr(rr, f)).cpu()
                                    for f in fields if hasattr(rr, f)])
        outer = [torch.as_tensor(rr.n_outer).tolist() for rr in results]
        print(f"[solve {tag}] wall_s={wall:.4f} outer={outer}", flush=True)
        profile_solve(tag, solve, wall)
        out[tag] = {"wall_s": wall}
    return out


if __name__ == "__main__":
    sys.exit(main())
