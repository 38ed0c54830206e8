#!/usr/bin/env python3
"""Where the time of K4, the chain suffix sums (``chain_suffix_kernel`` in
``src/repro_torch/csrc/chain_suffix.cu``), goes on one NVIDIA card: the
kernel as it ships beside textual variants of its source, at
``chip_smoke.py``'s full width (n = 1000, p = 100,000) in float64 and
float32.

    python3 scripts/chain_variants_torch.py

Each variant is the checkout's ``chain_suffix.cu`` with one line replaced
(a regular expression, so the variants hold whatever the shipped values),
built with the port's nvcc flags into ``build/chain_variants/`` (all
builds in parallel) and called through the same C entry points:

* ``as_is``: the kernel as it ships;
* ``a1`` / ``a3``: the fold warp reads 1 or 3 chunks ahead;
* ``nv2`` / ``nv4`` / ``nv8``: 2, 4 or 8 16-byte vectors a chunk;
* ``nv8_a3``: 8 vectors a chunk, 3 chunks ahead;
* ``st_few`` / ``st_many``: a ring of 3 / 5 or 10 / 16 stages (float64 /
  float32);
* ``store_elem`` / ``store_bulk``: the store warp writes a folded tile one
  element a lane, or one bulk (TMA) store a row;
* ``no_add`` (a diagnostic, not the kernel's function): the fold copies
  each value instead of adding it, so no chain of adds is left: the time
  of the data movement and the loop alone;
* ``no_store`` (a diagnostic): the store warp reads the folded tile one
  element a lane but writes nothing: the time without the writes to
  device memory.

Every variant but the diagnostics must compute the kernel's function: its
output equals the plain twin at full width and at two edge shapes (13
rows, p = 777 and 5,000, signed zeros and NaN in the first and last
columns) bit for bit, NaN where the twin has NaN. For each variant and
dtype it prints the device time per launch (torch.profiler, ``--reps``
launches after a warm-up), then one JSON line. With ``--sass DIR`` it
writes ``cuobjdump -sass`` of each variant there.
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

# (pattern, replacement) pairs, regular expressions over the source
AHEAD = r"constexpr int AHEAD = \d+;"
NV = r"static constexpr int NV = \d+;"
STAGES = r"static constexpr int STAGES = sizeof\(T\) == 8 \? \d+ : \d+;"
STORE = r"constexpr bool BULK_STORE = \w+;"
VARIANTS = {
    "as_is": [],
    "a1": [(AHEAD, "constexpr int AHEAD = 1;")],
    "a3": [(AHEAD, "constexpr int AHEAD = 3;")],
    "nv2": [(NV, "static constexpr int NV = 2;")],
    "nv4": [(NV, "static constexpr int NV = 4;")],
    "nv8": [(NV, "static constexpr int NV = 8;")],
    "nv8_a3": [(NV, "static constexpr int NV = 8;"),
               (AHEAD, "constexpr int AHEAD = 3;")],
    "st_few": [(STAGES, "static constexpr int STAGES = sizeof(T) == 8 ? 3 : 5;")],
    "st_many": [(STAGES,
                 "static constexpr int STAGES = sizeof(T) == 8 ? 10 : 16;")],
    "store_elem": [(STORE, "constexpr bool BULK_STORE = false;")],
    "store_bulk": [(STORE, "constexpr bool BULK_STORE = true;")],
    "no_add": [(r"acc = add_rn\(at\(c\[v\], e\), acc\);",
                "acc = at(c[v], e);")],
    "no_store": [(STORE, "constexpr bool BULK_STORE = false;"),
                 (r"dst\[\(size_t\)r \* p \+ c\] = st\[r \* RG::RS \+ c\];",
                  "if (st[r * RG::RS + c] == T(-12345.5)) "
                  "dst[(size_t)r * p + c] = T(0);")],
}
DIAGNOSTIC = ("no_add", "no_store")


def build(name, edits, src, out_dir, nvcc, flags, sass_dir):
    text = src
    for pattern, new in edits:
        text, hits = re.subn(pattern, lambda _: new, text)
        if hits != 1:
            raise RuntimeError(f"variant {name}: {pattern} matched {hits} "
                               f"lines of chain_suffix.cu, not one")
    cu = out_dir / f"chain_{name}.cu"
    so = out_dir / f"libchain_{name}.so"
    cu.write_text(text)
    out = subprocess.run([nvcc, *flags, "-o", str(so), str(cu)],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{out.stderr}")
    if sass_dir:
        d = Path(sass_dir)
        d.mkdir(parents=True, exist_ok=True)
        sass = subprocess.run(
            [str(Path(nvcc).parent / "cuobjdump"), "-sass", str(so)],
            capture_output=True, text=True).stdout
        (d / f"chain_{name}.sass").write_text(sass)
    return name, so


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", nargs="*", default=None,
                    help="the variants to build and time (default: all)")
    ap.add_argument("--sass", default=None)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chain_variants_torch: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (N, chain_edge_input, device_ms, nvidia_smi_line,
                            same_bits, simulation_data)
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused.ref import chain_suffix_sums_ref

    print(f"card: {nvidia_smi_line()}; torch {torch.__version__}",
          flush=True)
    out_dir = ROOT / "build" / "chain_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "chain_suffix.cu").read_text()
    todo = {k: v for k, v in VARIANTS.items()
            if args.only is None or k in args.only}
    with ThreadPoolExecutor(len(todo)) as ex:
        libs = dict(ex.map(
            lambda kv: build(kv[0], kv[1], src, out_dir, _build.nvcc(),
                             _build.NVCC_FLAGS, args.sass), todo.items()))

    P, I = ctypes.c_void_p, ctypes.c_int
    Xn = simulation_data(N, 100_000)[0]
    cases = {}
    for dtype in ("float64", "float32"):
        dt = getattr(torch, dtype)
        Xs = [torch.from_numpy(Xn).to("cuda", dt)] + [
            chain_edge_input(13, q, dt, seed=q).to("cuda") for q in (777, 5000)]
        cases[dtype] = [(X, chain_suffix_sums_ref(X)) for X in Xs]
    record, ok = {}, True
    for name, so in libs.items():
        lib = ctypes.CDLL(str(so))
        rows = {}
        for dtype, xs in cases.items():
            fn = getattr(lib, "chain_suffix_sums_" + dtype.replace(
                "float", "f"))
            fn.argtypes, fn.restype = [P, P, I, I, P], ctypes.c_int
            good = True
            for X, S_ref in xs:
                S = torch.empty_like(X)

                def run(X=X, S=S):
                    rc = fn(P(X.data_ptr()), P(S.data_ptr()), X.shape[0],
                            X.shape[1],
                            P(torch.cuda.current_stream().cuda_stream))
                    if rc:
                        raise RuntimeError(f"{name}: CUDA error {rc}")
                run()
                torch.cuda.synchronize()
                good = good and same_bits([S], [S_ref])
                if X.shape[1] == 100_000:
                    ms = device_ms(run, args.reps, "chain_suffix_kernel")
            if name not in DIAGNOSTIC:
                ok = ok and good
            rows[dtype] = {"ms": ms, "bitwise": good}
        record[name] = rows
        print(f"[variant {name}] " + "; ".join(
            f"{k}: {v['ms']:.4f} ms"
            f"{'' if v['bitwise'] else ' (not the function)'}"
            for k, v in rows.items()), flush=True)
    print(json.dumps({"card": nvidia_smi_line(), "ms": record,
                      "bitwise": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
