#!/usr/bin/env python3
"""Time the CM burst K3 (least squares, logistic), its unpenalized-slot
form K3-pen, its fleet form K3b, the Gram sweep K6 / K6b and the
least-squares epochs K5 on one NVIDIA card at ``chip_smoke.py``'s shapes,
per dependent coordinate step, and fingerprint their outputs so that two
source trees can be held bit for bit against each other.

    python3 scripts/cm_probe_torch.py                          # this tree
    python3 scripts/cm_probe_torch.py --src OTHER/src \\
        --save-hashes a.json                                   # another tree
    python3 scripts/cm_probe_torch.py --compare-hashes a.json

The blocks are the smoke's, from beta = 0 and 40 epochs: the final active
block of the least-squares solve at 0.3 lambda_max (K3; K6 on the Gram
solve's), of the logistic solve (K3), of the fused least-squares and
logistic solves (K3-pen), of the 16-problem LS fleet (K3b, its last
problem frozen) and the 5 fold carries of the CV grid at its last lambda
(K6b). Beside them, shapes the smoke's solves never reach, each also held
against its plain twin: K3 at n = 2,000 (8 rows a thread in registers)
and n = 7,900 (z and y in shared memory; with the logistic K3-pen tail
at k = 512, 96 bytes under the shared-memory gate), K6 at k = 200 and
1,000 (one warp, k not a multiple of its 32 lanes' vectors), 999 (a row
not a whole number of 16-byte words), 2,048 and 4,096 (past one warp's
1,024; the last three in the 256-thread form). K5 (float32 only, its
type) runs on the least-squares solve's final block as ``chip_smoke.py``
hands it over (A (n, k) with its dead columns zeroed) for 1 and 40 epochs
from beta = 0, for 0, 1 and 40 epochs from a nonzero beta (dead slots
included), and on synthetic blocks past the smoke's: n = 2,048 (8 rows a
thread in registers), 2,049 and 7,900 (r in shared memory), and k = 1,
each also held against its plain twin. Every case runs in two regimes:
with updates (the solve's lambda) and with every step a no-op (lambda at
twice max |gradient| at beta = 0; K3-pen's unpenalized slot still moves,
and K5 from a nonzero beta zeroes it).

The first run solves the problems on the card and saves the blocks under
``--inputs`` (in the git-ignored ``build/``); later runs, from either
tree, load them, so both trees see the same inputs. It prints nvcc's
``-Xptxas -v`` report for ``csrc/cm_burst.cu``, ``csrc/gram_sweep.cu`` and
``csrc/cm_epochs.cu`` (from the one build the kernels use), with
``--sass DIR`` writes ``cuobjdump -sass`` of them, then one line per
timing (CUDA events, mean of ``--reps`` launches after a warm-up): ms and
microseconds per dependent step (a fleet's problems run side by side, so
its steps are its longest problem's; K5's lines also give the kernel's
device time per launch from torch.profiler), then a JSON line. Every output tensor of every probed
launch is fingerprinted (sha256 of its bytes); ``--compare-hashes`` fails
the run when one differs from the saved ones.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
N_EP = 40
SOURCES = ("cm_burst", "gram_sweep", "cm_epochs")


def build_with_report(_build, sass_dir, sources=SOURCES):
    """Build the sources (in parallel) with ``-Xptxas -v`` into the paths
    the wrappers load; print the report; optionally dump SASS."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in sources:
        out = _build._lib_path(name)
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
               str(out), str(_build.CSRC / f"{name}.cu")]
        jobs.append((name, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    for name, out, proc in jobs:
        text, _ = proc.communicate()
        print(f"[ptxas {name}.cu]\n{text}", flush=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu")
        if sass_dir:
            d = Path(sass_dir)
            d.mkdir(parents=True, exist_ok=True)
            sass = subprocess.run(
                [str(Path(_build.nvcc()).parent / "cuobjdump"), "-sass",
                 str(out)], capture_output=True, text=True).stdout
            (d / f"{name}.sass").write_text(sass)
            local = sum(1 for ln in sass.splitlines()
                        if " LDL" in ln or " STL" in ln)
            print(f"[sass {name}.cu] {len(sass.splitlines())} lines, "
                  f"{local} local-memory loads/stores, in {d}", flush=True)


def make_inputs(path, dev):
    """Solve the smoke's problems on the card and save every probed
    block (float64, on the CPU)."""
    import numpy as np
    import torch
    import repro_torch as rt
    from chip_smoke import (CV_FOLDS, CV_GRID, FLEET_LS, FUSED_LOGIT_LAM,
                            FUSED_LS_LAM, FUSED_P, LOGIT_LAM, LS_LAM, N,
                            burst_inputs, cm_epochs_block, fleet_responses,
                            fused_chain_data, gram_slots, logistic_data,
                            simulation_data)

    cases = {}

    def burst(name, loss, Xs, ys, res, lam, pen=None):
        A, AT, col_sq, order, count, _ = burst_inputs(
            Xs, res.active_idx, res.active_mask)
        cases[name] = dict(kind="K3", loss=loss, AT=AT.cpu(), y=ys.cpu(),
                           col_sq=col_sq.cpu(), mask=res.active_mask.cpu(),
                           order=order.cpu(), count=count, lam=float(lam),
                           pen=None if pen is None else pen.cpu())

    Xn, yn = simulation_data(N, 100_000)
    X = torch.from_numpy(Xn).to(dev)
    y = torch.from_numpy(yn).to(dev)
    del Xn
    cfg = rt.SaifConfig(eps=1e-6)
    ls = rt.get_loss("least_squares")
    lm = float(rt.lambda_max(ls, X, y))
    lam = LS_LAM * lm
    res = rt.saif(X, y, lam, cfg)
    burst("K3 LS", "least_squares", X, y, res, lam)
    A5, y5, csq5, mask5, _ = cm_epochs_block(X, y, lam, res)
    k5 = A5.shape[1]
    b5 = 0.01 * torch.randn(k5, generator=torch.Generator().manual_seed(9))
    for n_ep, beta0, tag in ((1, None, "ep=1"), (40, None, "ep=40"),
                             (0, b5, "ep=0 beta!=0"),
                             (1, b5, "ep=1 beta!=0 dead slots"),
                             (40, b5, "ep=40 beta!=0 dead slots")):
        cases[f"K5 LS {tag}"] = dict(
            kind="K5", A=A5.cpu(), y=y5.cpu(), col_sq=csq5.cpu(),
            mask=mask5.cpu(), lam=float(lam), beta0=beta0, n_ep=n_ep)
    gres = rt.saif(X, y, lam, rt.SaifConfig(eps=1e-6, inner_backend="gram"))
    G, rho, _, mask, order, count = gram_slots(
        X, y, gres.active_idx, gres.active_mask, torch.float64)
    cases["K6 LS"] = dict(kind="K6", G=G.cpu(), rho=rho.cpu(),
                          mask=mask.cpu(), order=order.cpu(), count=count,
                          lam=lam)

    Yf = fleet_responses(X, FLEET_LS[2], seed=100)
    fracs = np.geomspace(FLEET_LS[0], FLEET_LS[1], FLEET_LS[2])
    lams = [float(f) * float(rt.lambda_max(ls, X, yy))
            for f, yy in zip(fracs, Yf)]
    fl = rt.fleet_solve(X, Yf, lams, cfg)
    m = fl.active_mask
    parts = [burst_inputs(X, fl.active_idx[i], m[i]) for i in range(len(Yf))]
    cases["K3b B=16"] = dict(
        kind="K3b", loss="least_squares",
        AT=torch.stack([q[1] for q in parts]).cpu(), y=Yf.cpu(),
        col_sq=torch.stack([q[2] for q in parts]).cpu(), mask=m.cpu(),
        order=torch.stack([q[3] for q in parts]).cpu(),
        count=[q[4] for q in parts], lam=lams)

    ycv = fleet_responses(X, 1, seed=300)[0]
    lm_cv = float(rt.lambda_max(ls, X, ycv))
    cv = rt.cv_solve(X, ycv, (np.geomspace(*CV_GRID) * lm_cv).tolist(),
                     n_folds=CV_FOLDS, config=cfg, keep_fold_betas=True,
                     refit=False)
    fr = cv.fold_results[-1]
    W = rt.kfold_weights(N, CV_FOLDS).to(X)
    per = [gram_slots(X, ycv, fr.active_idx[i], fr.active_mask[i],
                      torch.float64, W[i]) for i in range(CV_FOLDS)]
    cases["K6b CV B=5"] = dict(
        kind="K6b", G=torch.stack([q[0] for q in per]).cpu(),
        rho=torch.stack([q[1] for q in per]).cpu(),
        mask=torch.stack([q[3] for q in per]).cpu(),
        order=torch.stack([q[4] for q in per]).cpu(),
        count=[q[5] for q in per], lam=[float(cv.lams[-1])] * CV_FOLDS)
    del X, Yf

    Ln, yl = logistic_data(N, 100_000)
    XL = torch.from_numpy(Ln).to(dev)
    yL = torch.from_numpy(yl).to(dev)
    del Ln
    lamL = LOGIT_LAM * float(rt.lambda_max(rt.get_loss("logistic"), XL, yL))
    res = rt.saif(XL, yL, lamL, rt.SaifConfig(eps=1e-6, loss="logistic"))
    burst("K3 logistic", "logistic", XL, yL, res, lamL)
    del XL

    parent = np.arange(FUSED_P) - 1
    Xf = torch.from_numpy(fused_chain_data(N, FUSED_P)[0]).to(dev)
    Xt = rt.prepare_fused(Xf, parent).Xt
    for loss, frac, logistic in (("least_squares", FUSED_LS_LAM, False),
                                 ("logistic", FUSED_LOGIT_LAM, True)):
        yf = torch.from_numpy(fused_chain_data(N, FUSED_P,
                                               logistic=logistic)[1]).to(dev)
        lamf = frac * rt.fused_lambda_max(Xf, yf, parent, loss=loss)
        res = rt.saif_fused(Xf, yf, parent, lamf,
                            rt.SaifConfig(eps=1e-6, loss=loss))[1]
        pen = torch.where(res.active_mask
                          & (res.active_idx == Xt.shape[1] - 1), 0.0, 1.0)
        burst(f"K3-pen {'LS' if loss == 'least_squares' else loss}", loss,
              Xt, yf, res, lamf, pen.to(torch.float64))

    # shapes past the smoke's: synthetic gaussian blocks, 500 live of 512
    g = torch.Generator().manual_seed(5)
    for n, loss, pen_on in ((2000, "least_squares", False),
                            (7900, "least_squares", False),
                            (7900, "logistic", True)):
        k, live = 512, 500
        A = torch.randn(n, k, generator=g, dtype=torch.float64)
        w = torch.zeros(k, dtype=torch.float64)
        w[:20] = torch.rand(20, generator=g, dtype=torch.float64) * 2 - 1
        yy = A @ w + torch.randn(n, generator=g, dtype=torch.float64)
        if loss == "logistic":
            yy = torch.where(yy >= 0, 1.0, -1.0).to(torch.float64)
        mask = torch.arange(k) < live
        A = torch.where(mask[None, :], A, 0.0)
        pen = None
        if pen_on:
            pen = torch.ones(k, dtype=torch.float64)
            pen[0] = 0.0
        grad0 = -yy if loss == "least_squares" else -0.5 * yy
        cases[f"K3{'-pen' if pen_on else ''} {loss} n={n}"] = dict(
            kind="K3", loss=loss, AT=A.T.contiguous(), y=yy,
            col_sq=(A * A).sum(0), mask=mask, order=torch.arange(k),
            count=live, lam=0.3 * float((A.T @ grad0).abs().max()), pen=pen,
            n_ep=5, twin=True)
    for k, live in ((200, 150), (1000, 700), (999, 800), (2048, 1500),
                    (4096, 3000)):
        A = torch.randn(1000, k, generator=g, dtype=torch.float64)
        yy = A[:, :20] @ torch.ones(20, dtype=torch.float64) + torch.randn(
            1000, generator=g, dtype=torch.float64)
        mask = torch.arange(k) < live
        A = torch.where(mask[None, :], A, 0.0)
        rho = A.T @ yy
        cases[f"K6 k={k}"] = dict(
            kind="K6", G=A.T @ A, rho=rho, mask=mask, order=torch.arange(k),
            count=live, lam=0.3 * float(rho.abs().max()), n_ep=5, twin=True)
    # K5 past the smoke's block: synthetic gaussian blocks in float32
    for n, k, live in ((2048, 512, 500), (2049, 512, 500), (7900, 512, 500),
                       (1000, 1, 1)):
        A = torch.randn(n, k, generator=g)
        yy = A[:, :min(k, 20)].sum(1) + torch.randn(n, generator=g)
        mask = torch.arange(k) < live
        A = torch.where(mask[None, :], A, 0.0)
        cases[f"K5 n={n} k={k}"] = dict(
            kind="K5", A=A, y=yy, col_sq=(A * A).sum(0), mask=mask,
            lam=0.3 * float((A.T @ yy).abs().max()), beta0=None, n_ep=5,
            twin=True)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(cases, path)
    return cases


def noop_lam(case):
    """Twice the largest |gradient| at beta = 0, per problem: every step
    from beta = 0 then leaves its coordinate at 0."""
    import torch
    kind = case["kind"]
    if kind == "K5":
        return 2 * float((case["A"].T @ case["y"]).abs().max())
    if kind in ("K6", "K6b"):
        r = case["rho"]
        return (2 * r.abs().amax(-1)).tolist() if r.dim() > 1 else \
            2 * float(r.abs().max())
    f0 = -case["y"] if case["loss"] == "least_squares" else -0.5 * case["y"]
    c = torch.einsum("...kn,...n->...k", case["AT"], f0).abs().amax(-1)
    return (2 * c).tolist() if c.dim() else 2 * float(c)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the source tree whose repro_torch is probed")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--inputs", default=str(ROOT / "build" /
                                            "cm_probe_inputs.pt"))
    ap.add_argument("--sass", default=None,
                    help="write cuobjdump -sass of both sources here")
    ap.add_argument("--save-hashes", default=None)
    ap.add_argument("--compare-hashes", default=None)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("cm_probe_torch: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(0, str(ROOT))
    import repro_torch as rt
    from chip_smoke import burst_error, device_ms, nvidia_smi_line, time_ms
    from repro_torch.kernels import _build, ops

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {nvidia_smi_line()}; torch {torch.__version__}; "
          f"src {rt.__file__}", flush=True)
    build_with_report(_build, args.sass)
    dev = torch.device("cuda")
    inputs = Path(args.inputs)
    cases = (torch.load(inputs, weights_only=False) if inputs.exists()
             else make_inputs(inputs, dev))
    form = getattr(sys.modules["repro_torch.kernels.gram.gram"],
                   "gram_sweep_form", None)

    hashes, record, bad = {}, {}, []

    def fp(tag, outs):
        for i, t in enumerate(outs):
            hashes[f"{tag}/{i}"] = hashlib.sha256(
                t.contiguous().cpu().numpy().tobytes()).hexdigest()

    for dtype in ("float64", "float32"):
        dt = getattr(torch, dtype)
        for name, c in cases.items():
            kind = c["kind"]
            if kind == "K5" and dtype == "float64":
                continue                  # K5 computes in float32 only
            n_ep = c.get("n_ep", N_EP)
            T = {k: (v.to(dev, dt) if torch.is_tensor(v)
                     and v.is_floating_point() else
                     v.to(dev) if torch.is_tensor(v) else v)
                 for k, v in c.items()}
            for regime in ("updates", "no-op"):
                lam = c["lam"] if regime == "updates" else noop_lam(c)
                if kind == "K3":
                    k = T["AT"].shape[0]
                    beta0 = torch.zeros(k, dtype=dt, device=dev)

                    def run(lam=lam, T=T, beta0=beta0, n_ep=n_ep):
                        if T["pen"] is None:
                            return ops.cm_burst_xt(
                                T["AT"], T["y"], beta0, T["col_sq"],
                                T["mask"], T["order"], lam, n_ep,
                                T["count"], loss_name=T["loss"])
                        return ops.cm_burst_pen_xt(
                            T["AT"], T["y"], beta0, T["col_sq"], T["mask"],
                            T["order"], T["pen"], lam, n_ep, T["count"],
                            loss_name=T["loss"])
                    steps = n_ep * T["count"]
                elif kind == "K3b":
                    b, k, _ = T["AT"].shape
                    beta0 = torch.zeros(b, k, dtype=dt, device=dev)
                    nep = torch.full((b,), n_ep, dtype=torch.int32,
                                     device=dev)
                    nep[-1] = 0
                    lam_t = torch.tensor(lam, dtype=dt, device=dev)
                    cnt = torch.tensor(T["count"], dtype=torch.int32,
                                       device=dev)

                    def run(T=T, beta0=beta0, nep=nep, lam_t=lam_t,
                            cnt=cnt):
                        return ops.cm_burst_batch_xt(
                            T["AT"], T["y"], beta0, T["col_sq"], T["mask"],
                            T["order"], lam_t, nep, cnt,
                            loss_name=T["loss"])
                    steps = n_ep * max(T["count"])
                elif kind == "K5":
                    k = T["A"].shape[1]
                    beta0 = (torch.zeros(k, dtype=dt, device=dev)
                             if T["beta0"] is None else T["beta0"])

                    def run(lam=lam, T=T, beta0=beta0, n_ep=n_ep):
                        return ops.cm_epochs(T["A"], T["y"], beta0,
                                             T["col_sq"], T["mask"], lam,
                                             n_epochs=n_ep)
                    steps = n_ep * k
                elif kind == "K6":
                    k = T["G"].shape[0]
                    beta0 = torch.zeros(k, dtype=dt, device=dev)
                    lam_t = torch.tensor(lam, dtype=dt, device=dev)

                    def run(T=T, beta0=beta0, lam_t=lam_t, n_ep=n_ep):
                        return (ops.gram_sweep(
                            T["G"], T["rho"], beta0, T["mask"], lam_t,
                            T["order"], T["count"], n_ep),)
                    steps = n_ep * T["count"]
                else:                               # K6b
                    b, k, _ = T["G"].shape
                    beta0 = torch.zeros(b, k, dtype=dt, device=dev)
                    lam_t = torch.tensor(lam, dtype=dt, device=dev)
                    cnt = torch.tensor(T["count"], dtype=torch.int32,
                                       device=dev)
                    nep = torch.full((b,), n_ep, dtype=torch.int32,
                                     device=dev)

                    def run(T=T, beta0=beta0, lam_t=lam_t, cnt=cnt, nep=nep):
                        return (ops.gram_sweep_batch(
                            T["G"], T["rho"], beta0, T["mask"], lam_t,
                            T["order"], cnt, nep),)
                    steps = n_ep * max(T["count"])
                outs = run()
                torch.cuda.synchronize()
                tag = f"{dtype}/{name}/{regime}"
                fp(tag, outs)
                moved = int(sum((o != 0).sum() for o in outs[:1]))
                ms = time_ms(run, args.reps)
                extra = ""
                if c.get("twin") and regime == "updates":
                    # the plain twin, at the smoke's tolerances
                    if kind == "K3":
                        A = T["AT"].T
                        ref = ops.cm_burst_ref(
                            A, T["y"], beta0, T["col_sq"], T["mask"],
                            T["order"], lam, n_ep, T["count"], T["pen"],
                            loss_name=T["loss"])
                        err = burst_error(T["loss"], outs, ref, T["y"],
                                          lam)[1]
                        tol = {"float64": 1e-9, "float32": 1e-3}[dtype]
                    elif kind == "K5":
                        # the smoke's measure and tolerance
                        ref = ops.cm_epochs_ref(
                            T["A"], T["y"], beta0, T["col_sq"], T["mask"],
                            lam, n_epochs=n_ep)[0]
                        err = float((outs[0] - ref).abs().max()) / max(
                            float(ref.abs().max()), 1e-30)
                        tol = 1e-3
                    else:
                        ref = ops.gram_sweep_ref(
                            T["G"], T["rho"], beta0, T["mask"], lam_t,
                            T["order"], T["count"], n_ep)
                        err = float((outs[0] - ref).abs().max()) / max(
                            float(ref.abs().max()), 1e-300)
                        tol = {"float64": 1e-12, "float32": 1e-3}[dtype]
                    extra = f" twin_rel_err={err:.3e} tol={tol:.0e}"
                    if not err <= tol:
                        bad.append(tag)
                if kind in ("K6", "K6b") and form is not None:
                    extra += f" form={form(k, torch.finfo(dt).bits // 8)}"
                dev_ms = None
                if kind == "K5" and steps > 0:
                    dev_ms = device_ms(run, args.reps, "cm_epochs_kernel")
                    extra += (f" device_ms={dev_ms:.4f} device_us_per_step="
                              f"{dev_ms * 1e3 / steps:.4f}")
                us = ms * 1e3 / max(steps, 1)
                record[tag] = {"ms": ms, "us_per_step": us, "steps": steps,
                               "nonzero": moved, "device_ms": dev_ms}
                print(f"[probe {dtype}] {name} {regime}: steps={steps} "
                      f"ms={ms:.4f} us_per_step={us:.4f} "
                      f"nonzero_beta={moved}{extra}", flush=True)

    print(json.dumps({"card": nvidia_smi_line(), "src": args.src,
                      "probe": record}))
    rc = 0
    if bad:
        print(f"[twin] disagree: {bad}", flush=True)
        rc = 1
    if args.save_hashes:
        Path(args.save_hashes).parent.mkdir(parents=True, exist_ok=True)
        Path(args.save_hashes).write_text(json.dumps(hashes, indent=0))
    if args.compare_hashes:
        ref = json.loads(Path(args.compare_hashes).read_text())
        diff = sorted(k for k in ref if hashes.get(k) != ref[k])
        print(f"[bitwise] {len(ref) - len(diff)} of {len(ref)} outputs "
              f"equal bit for bit; differing: {diff}", flush=True)
        if diff:
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
