#!/usr/bin/env python3
"""Time the screening scans K1 (``screen_fused``) and K1b
(``screen_fused_batch``) on one NVIDIA card at ``chip_smoke.py``'s shapes,
with the top-h epilogue (masked) and without it (unmasked), and fingerprint
their outputs so that two source trees can be held bit for bit against
each other.

    python3 scripts/screen_probe_torch.py                      # this tree
    python3 scripts/screen_probe_torch.py --src OTHER/src \\
        --save-hashes a.json                                   # another tree
    python3 scripts/screen_probe_torch.py --compare-hashes a.json

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
line. Every output tensor of every probed launch is fingerprinted
(sha256 of its bytes); ``--compare-hashes`` fails the run when one
differs from the saved ones.
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
    _build.build(("screen",))

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
        record[dtype] = rows
        del X

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


if __name__ == "__main__":
    sys.exit(main())
