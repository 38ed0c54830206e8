#!/usr/bin/env python3
"""Where the time of K7, the wide CM sweep (``cm_wide_kernel`` in
``src/repro_torch/csrc/cm_wide.cu``), goes on one NVIDIA card: the kernel
as it ships beside diagnostic edits of its source, at ``chip_smoke.py``'s
timing shapes (n = 1000; k = 2,000 columns of the LS design, held in L2,
20,000 and the full 100,000, one epoch from beta = 0) in float64 and
float32.

    python3 scripts/wide_variants_torch.py [--sass DIR] [--only no_pf]

Each variant is the checkout's ``cm_wide.cu`` with one line replaced (a
regular expression), built with the port's nvcc flags into
``build/wide_variants/`` (all builds in parallel) and called through the
wrapper ``ops.cm_sweep_wide`` with its library swapped in:

* ``as_is``: the kernel as it ships;
* ``no_pf``: the prefetch warp runs but issues no prefetch;
* ``idle``: the prefetch warp's CTA does nothing;
* ``head8``: the step word ahead of the reduction slots unpadded (8
  bytes, not 16), so the slots lose their 16-byte alignment.

The diagnostics compute the kernel's function: their beta and z at every
case of ``chip_smoke.wide_cases`` and at the timing shapes must equal
those of ``as_is`` bit for bit, and ``as_is`` agrees with the plain twin
at the smoke's tolerances. For each variant, dtype and shape it prints
the device time per launch (torch.profiler, ``--reps`` launches after a
warm-up) and microseconds per step, then one JSON line. With ``--sass
DIR`` it writes ``cuobjdump -sass`` of each variant there.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

VARIANTS = {
    "as_is": [],
    "no_pf": [(r"if \(hi > lo\)\n", "if (false)\n")],
    "idle": [(r"if \(tid < 32\)(?=\n\s+prefetch_warp)", "if (false)")],
    "head8": [(r"constexpr size_t HEAD = 16;", "constexpr size_t HEAD = 8;")],
}


def build(name, edits, src, out_dir, nvcc, flags, sass_dir):
    text = src
    for pattern, new in edits:
        text, hits = re.subn(pattern, lambda _: new, text)
        if hits != 1:
            raise RuntimeError(f"variant {name}: {pattern} matched {hits} "
                               f"lines of cm_wide.cu, not one")
    cu = out_dir / f"wide_{name}.cu"
    so = out_dir / f"libwide_{name}.so"
    cu.write_text(text)
    out = subprocess.run([nvcc, *flags, "-Xptxas", "-v", "-o", str(so),
                          str(cu)], capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{out.stderr}")
    regs = sorted(set(re.findall(r"Used (\d+ registers)", out.stderr)))
    if sass_dir:
        d = Path(sass_dir)
        d.mkdir(parents=True, exist_ok=True)
        sass = subprocess.run(
            [str(Path(nvcc).parent / "cuobjdump"), "-sass", str(so)],
            capture_output=True, text=True).stdout
        (d / f"wide_{name}.sass").write_text(sass)
    return name, (so, regs)


def load(_build, so):
    """The variant's library with the wrapper's argument types."""
    lib = ctypes.CDLL(str(so))
    for pattern, args in _build._SIGNATURES["cm_wide"].items():
        for dt, ftype in (("f32", ctypes.c_float), ("f64", ctypes.c_double)):
            fn = getattr(lib, pattern.format(dt=dt))
            fn.argtypes = [ftype if a is None else a for a in args]
            fn.restype = ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--only", nargs="*", default=None,
                    help="the variants to build and time (default: all)")
    ap.add_argument("--sass", default=None)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("wide_variants_torch: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import repro_torch as rt
    from chip_smoke import (LOGIT_LAM, LS_LAM, N, device_ms, errs,
                            logistic_data, nvidia_smi_line, same_bits,
                            simulation_data, wide_cases)
    from repro_torch.kernels import _build, ops

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {nvidia_smi_line()}; torch {torch.__version__}",
          flush=True)
    out_dir = ROOT / "build" / "wide_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "cm_wide.cu").read_text()
    todo = {k: v for k, v in VARIANTS.items()
            if args.only is None or k in args.only or k == "as_is"}
    with ThreadPoolExecutor(len(todo)) as ex:
        built = dict(ex.map(
            lambda kv: build(kv[0], kv[1], src, out_dir, _build.nvcc(),
                             _build.NVCC_FLAGS, args.sass), todo.items()))
    for name, (_, regs) in built.items():
        print(f"[ptxas {name}] {', '.join(regs)}", flush=True)

    dev = torch.device("cuda")
    Xn, yn = simulation_data(N, 100_000)
    X, y = torch.from_numpy(Xn).to(dev), torch.from_numpy(yn).to(dev)
    Ln, yl = logistic_data(N, 2000)
    XL, yL = torch.from_numpy(Ln).to(dev), torch.from_numpy(yl).to(dev)
    del Xn, Ln
    ls, lg = rt.get_loss("least_squares"), rt.get_loss("logistic")
    lam = LS_LAM * float(rt.lambda_max(ls, X, y))
    lamL = LOGIT_LAM * float(rt.lambda_max(lg, XL, yL))

    record, ok, ref = {}, True, {}
    for name, (so, _) in built.items():
        _build._LIBS["cm_wide"] = load(_build, so)
        rows, good = {}, True
        for dtype, tol in (("float64", 1e-9), ("float32", 1e-3)):
            dt = getattr(torch, dtype)
            for case, a, loss_name in wide_cases(X, y, lam, XL, yL, lamL, dt):
                out = ops.cm_sweep_wide(*a, loss_name=loss_name)
                torch.cuda.synchronize()
                key = (dtype, case)
                if name == "as_is":
                    ref[key] = out
                    r = errs(list(zip(out, ops.cm_sweep_wide_ref(
                        *a, loss_name=loss_name))))[1]
                    if not r <= tol:
                        print(f"[as_is] {dtype} {case}: rel_err={r:.3e} "
                              f"past {tol:.0e}", flush=True)
                        good = False
                elif not same_bits(list(out), list(ref[key])):
                    print(f"[{name}] {dtype} {case}: not bit for bit as_is",
                          flush=True)
                    good = False
            for label, k in (("k=2000", 2000), ("k=20000", 20_000),
                             ("full width", X.shape[1])):
                XT = X[:, :k].T.contiguous().to(dt)
                a = (XT, y.to(dt), torch.zeros(k, dtype=dt, device=dev),
                     torch.zeros(N, dtype=dt, device=dev), (XT * XT).sum(1),
                     torch.ones(k, dtype=torch.bool, device=dev),
                     torch.arange(k, device=dev), lam, 1, k)
                out = ops.cm_sweep_wide(*a)
                torch.cuda.synchronize()
                key = (dtype, "timing " + label)
                if name == "as_is":
                    ref[key] = [t.cpu() for t in out]
                elif not same_bits([t.cpu() for t in out], ref[key]):
                    print(f"[{name}] {dtype} {label}: not bit for bit as_is",
                          flush=True)
                    good = False
                ms = device_ms(lambda: ops.cm_sweep_wide(*a), args.reps,
                               "cm_wide_kernel")
                rows[f"{dtype} {label}"] = {"ms": ms, "us_per_step":
                                            ms * 1e3 / k}
                del XT, a
        ok = ok and good
        record[name] = rows
        print(f"[variant {name}] " + "; ".join(
            f"{k}: {v['ms']:.4f} ms {v['us_per_step']:.4f} us/step"
            for k, v in rows.items())
              + ("" if good else " (not the function)"), flush=True)
    print(json.dumps({"card": nvidia_smi_line(), "ms": record,
                      "bitwise": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
