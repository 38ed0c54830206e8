#!/usr/bin/env python3
"""Where the time of the screening scans K1 and K1b goes, on one NVIDIA
card: the kernels of ``src/repro_torch/csrc/screen.cu`` timed beside
variants of the same source with one part taken out.

    python3 scripts/screen_variants_torch.py

Each variant is the checkout's ``screen.cu`` with one line replaced, built
with the port's nvcc flags into ``build/screen_variants/`` (all builds in
parallel) and called through the same C entry points:

* ``as_is``: the kernels as they ship;
* ``one_cta``: one CTA per SM with 32 KB slabs, so that a CTA streams its
  items one after another (its outputs must equal ``as_is`` bit for bit);
* ``no_copy``: no slab is copied, so the scan computes on stale shared
  memory (compute and epilogue alone);
* ``no_fma``: one add per row in place of the QB x COLS fmas (the X stream
  and the epilogue alone);
* ``no_sort``: the epilogue without the warp sort.

Only ``as_is`` and ``one_cta`` compute the kernels' function. The design is
X ~ U[-10, 10] at the smoke's n = 1000, p = 100,000; K1b at B = 16 with
shared norms; h = 16 (the smoke's serial and fleet h); 500 active
features per problem. Times are CUDA-event means over ``--reps`` launches
after a warm-up, in float64 and float32, masked and unmasked, printed one
line per variant and then as one JSON line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# variant -> (line of screen.cu, its replacement)
CTAS = "  static constexpr int CTAS = 3;                    // per SM\n"
SLAB = ("  static constexpr int SLAB = BB >= 16 ? 8 * 1024 : 16 * 1024;"
        "   // X bytes\n")
VARIANTS = {
    "as_is": [],
    "one_cta": [(CTAS, CTAS.replace("3;", "1;")),
                (SLAB, "  static constexpr int SLAB = 32 * 1024;\n")],
    "no_copy": [("    if (pn < total) {\n",
                 "    if (false && pn < total) {\n")],
    "no_fma": [("            acc[j][q] = fma_rn(th.v[q], to_acc(x.v[j]), "
                "acc[j][q]);\n",
                "            if (q == 0) acc[j][q] += to_acc(x.v[j]);\n")],
    "no_sort": [("      for (int q = w; q < nb; q += S::NWARP) {\n",
                 "      for (int q = w; false && q < nb; q += S::NWARP) {\n")],
}


def build(name, edits, src, out_dir, nvcc, flags):
    text = src
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"variant {name}: line not found in screen.cu:"
                               f" {old.strip()}")
        text = text.replace(old, new)
    cu = out_dir / f"screen_{name}.cu"
    so = out_dir / f"libscreen_{name}.so"
    cu.write_text(text)
    out = subprocess.run([nvcc, *flags, "-o", str(so), str(cu)],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{out.stderr}")
    return name, so


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("screen_variants_torch: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import N, nvidia_smi_line, time_ms
    from repro_torch.kernels import _build

    print(f"card: {nvidia_smi_line()}; torch {torch.__version__}",
          flush=True)
    out_dir = ROOT / "build" / "screen_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "screen.cu").read_text()
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        libs = dict(ex.map(
            lambda kv: build(kv[0], kv[1], src, out_dir, _build.nvcc(),
                             _build.NVCC_FLAGS), VARIANTS.items()))

    dev = torch.device("cuda")
    n, p, h = N, 100_000, 16
    g = torch.Generator(device=dev).manual_seed(0)
    X64 = torch.rand(n, p, generator=g, dtype=torch.float64,
                     device=dev) * 20 - 10
    P, I = ctypes.c_void_p, ctypes.c_int
    # ..., masked, the ub guard (the sums' type; 1 here), outputs, stream
    sig = [P, P, P, I, P, P, I, I, I, I, I, None, P, P, P, P, P, P, P]
    record = {}
    outputs = {}
    for name, so in libs.items():
        lib = ctypes.CDLL(str(so))
        rows = {}
        for dt in (torch.float64, torch.float32):
            tag = "f64" if dt == torch.float64 else "f32"
            X = X64.to(dt)
            cn = torch.linalg.vector_norm(X, dim=0)
            for entry, b in (("screen_fused", 1), ("screen_fused_batch", 16)):
                fn = getattr(lib, f"{entry}_{tag}")
                fn.argtypes = [(ctypes.c_double if tag == "f64" else
                                ctypes.c_float) if a is None else a
                               for a in sig]
                fn.restype = ctypes.c_int
                gg = torch.Generator(device=dev).manual_seed(1)
                Th = (torch.randn(b, n, generator=gg, dtype=torch.float64,
                                  device=dev) / n).to(dt)
                act = torch.zeros(b, p, dtype=torch.bool, device=dev)
                for i in range(b):
                    act[i, torch.randperm(p, generator=gg, device=dev)[:500]] \
                        = True
                r = torch.full((b,), 0.05, dtype=dt, device=dev)
                pb = -(-p // 256)
                outs = [torch.empty(b, p, dtype=dt, device=dev)
                        for _ in range(3)]
                outs += [torch.empty(b, pb, h, dtype=dt, device=dev),
                         torch.empty(b, pb, h, dtype=torch.int32,
                                     device=dev),
                         torch.empty(b, pb, dtype=dt, device=dev)]
                st = P(torch.cuda.current_stream().cuda_stream)
                for masked in (0, 1):
                    def call():
                        rc = fn(P(X.data_ptr()), P(Th.data_ptr()),
                                P(cn.data_ptr()), 0, P(act.data_ptr()),
                                P(r.data_ptr()), b, n, p, h, masked, 1.0,
                                *[P(o.data_ptr()) for o in outs], st)
                        if rc != 0:
                            raise RuntimeError(f"{name} {entry}: CUDA "
                                               f"error {rc}")
                    key = (f"{'K1' if b == 1 else 'K1b'} {tag} "
                           f"{'masked' if masked else 'unmasked'}")
                    call()
                    torch.cuda.synchronize()
                    if masked and name in ("as_is", "one_cta"):
                        outputs.setdefault(key, []).append(
                            [o.clone() for o in outs])
                    rows[key] = time_ms(call, args.reps)
            del X
        record[name] = rows
        print(f"[variant {name}] " + " ".join(
            f"{k}={v:.4f}" for k, v in rows.items()), flush=True)
    same = all(all(torch.equal(a, c) for a, c in zip(*pair))
               for pair in outputs.values())
    print(f"[variant one_cta] outputs bitwise as_is: {same}", flush=True)
    print(json.dumps({"card": nvidia_smi_line(), "ms": record,
                      "one_cta_bitwise_as_is": same}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
