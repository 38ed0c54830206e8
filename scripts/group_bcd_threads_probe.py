#!/usr/bin/env python3
"""Time kernel B-n3 (``csrc/group_bcd.cu``) on one NVIDIA card at several
CTA sizes, and its plain version, on the group phases' blocks.

    python3 scripts/group_bcd_threads_probe.py --threads 256 512 1024

The design is ``chip_smoke.py``'s phase 2 (least squares, n = 1000, full
p, f64) in groups of 10; the block is the ``--live`` groups of largest
c0 (default 314, the live groups of the least-squares solve at 0.1 of the
group lambda_max). Each CTA size is built from the source with
``-DGROUP_NT=<threads>`` into its own library (``nvcc -Xptxas -v`` prints
its registers and spills), then one burst of ``--epochs`` epochs from
beta = 0 runs in each entry (least squares and logistic on the labels
sign(y), float64 and float32) and is held against the plain version on the
same inputs (relative error of beta and z); its time is the mean of CUDA
events over ``--reps`` calls. The plain version (``kernels/group/ref.py``)
is timed once in float64. Prints us per block step for each.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def build_variant(nt: int) -> ctypes.CDLL:
    from repro_torch.kernels import _build
    out = ROOT / "build" / f"group_bcd_nt{nt}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, f"-DGROUP_NT={nt}", "-Xptxas",
           "-v", "-o", str(out), str(_build.CSRC / "group_bcd.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
    for line in (res.stdout + res.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"[ptxas nt={nt}] {line.strip()}", flush=True)
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    for loss in ("ls", "logit"):
        for dts, ft in (("f32", ctypes.c_float), ("f64", ctypes.c_double)):
            fn = getattr(lib, f"group_bcd_{loss}_{dts}")
            fn.argtypes = [P] * 5 + [ft, I, I, I, I, P, P]
            fn.restype = I
    return lib


def run(lib, loss, A, y, slot, beta, L, lam, n_ep):
    import torch
    nl, gs, n = A.shape
    dts = "f64" if A.dtype == torch.float64 else "f32"
    fn = getattr(lib, f"group_bcd_{loss}_{dts}")
    b = beta.clone()
    z = torch.empty(n, dtype=A.dtype, device=A.device)
    s32 = slot.to(torch.int32)
    rc = fn(A.data_ptr(), y.data_ptr(), s32.data_ptr(), b.data_ptr(),
            L.data_ptr(), float(lam), n_ep, n, nl, gs, z.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"group_bcd nt launch failed: {rc}")
    return b, z


def events_ms(fn, reps):
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--threads", type=int, nargs="+",
                    default=[256, 512, 1024])
    ap.add_argument("--live", type=int, default=314)
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--p", type=int, default=100_000)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("group_bcd_threads_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (GROUP_SIZE, N, group_response,
                            nvidia_smi_line, simulation_data)
    from repro_torch.kernels.group.ref import group_bcd_ref, group_blocks

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {nvidia_smi_line()}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    dev = torch.device("cuda")
    gs = GROUP_SIZE
    Xn, _ = simulation_data(N, args.p)
    X = torch.from_numpy(Xn).to(dev)
    del Xn
    y = group_response(X, seed=400)
    ys = torch.sign(y)
    c0 = torch.linalg.vector_norm((X.T @ y).view(-1, gs), dim=1)
    groups = torch.sort(c0, descending=True, stable=True).indices[
        :args.live]
    gfro2 = torch.sum((X * X).view(N, -1, gs), dim=(0, 2))
    k = args.live
    slot = torch.arange(k, device=dev)
    beta0 = torch.zeros(k, gs, dtype=torch.float64, device=dev)
    steps = k * args.epochs
    cases = []
    for loss, yy, alpha in (("ls", y, 1.0), ("logit", ys, 0.25)):
        L = torch.clamp(alpha * gfro2[groups], min=1e-30)
        lam = 0.1 * float(c0.max()) if loss == "ls" else 0.1 * float(
            torch.linalg.vector_norm((X.T @ (-0.5 * ys)).view(-1, gs),
                                     dim=1).max())
        cases.append((loss, yy, L, lam))
    A64 = group_blocks(X, groups, gs)
    libs = {nt: build_variant(nt) for nt in args.threads}
    for loss, yy, L, lam in cases:
        name = "least_squares" if loss == "ls" else "logistic"
        t0 = time.perf_counter()
        bp, zp = group_bcd_ref(A64, yy, slot, beta0, L, lam, args.epochs,
                               loss_name=name)
        torch.cuda.synchronize()
        plain = time.perf_counter() - t0
        print(f"[plain {loss} float64] live={k} epochs={args.epochs} "
              f"s={plain:.3f} us_per_step={plain / steps * 1e6:.2f}",
              flush=True)
        for nt in args.threads:
            lib = libs[nt]
            for dt in (torch.float64, torch.float32):
                A = A64.to(dt)
                a = (A, yy.to(dt), slot, beta0.to(dt), L.to(dt), lam,
                     args.epochs)
                b, z = run(lib, loss, *a)
                if dt == torch.float64:
                    rb, rz = ((b - bp).abs().max() / bp.abs().max(),
                              (z - zp).abs().max() / zp.abs().max())
                else:
                    b2, z2 = group_bcd_ref(*a[:6], args.epochs,
                                           loss_name=name)
                    rb, rz = ((b - b2).abs().max() / b2.abs().max(),
                              (z - z2).abs().max() / z2.abs().max())
                ms = events_ms(lambda: run(lib, loss, *a), args.reps)
                print(f"[nt={nt} {loss} {dt}] ms={ms:.4f} us_per_step="
                      f"{ms / steps * 1e3:.4f} rel_err beta={float(rb):.3e}"
                      f" z={float(rz):.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
