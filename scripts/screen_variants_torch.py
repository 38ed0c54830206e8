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
* ``no_sort``: the epilogue without the warp sort;
* ``fma_bf16``: the fma template instantiated for a bf16 X (``TI = bf16``,
  float sums; entries ``screen_fused_bf16`` and ``screen_fused_batch_bf16``),
  the bf16 mode's route before the tensor-core scan;
* ``tc_no_sort``: the tensor-core scan without its warp sorts.

Only ``as_is``, ``one_cta`` and ``fma_bf16`` compute the kernels' function.
The design is X ~ U[-10, 10] at the smoke's n = 1000, p = 100,000; K1b at
B = 16 with shared norms; h = 16 (the smoke's serial and fleet h); 500
active features per problem. Times are CUDA-event means over ``--reps``
launches after a warm-up, in float64 and float32, masked and unmasked,
printed one line per variant. Then the bf16 mode, masked, K1 (m = 1) and
K1b (B = 16): the tensor-core scan (``as_is``, ``screen_fused_tc``) beside
``fma_bf16`` on the same inputs, each held against the plain twin within
its float32 sums' bound (tensor cores: (gamma_n(2^-24) + gamma_n(2^-23))
sum|theta||x|; fma: 2 gamma_n(2^-24) sum|theta||x|), timed by the kernel's
own device time (torch.profiler) and by CUDA events, beside cuBLAS's bf16
product ``abs(Theta @ X)`` and the byte bound. Everything ends as one JSON
line.
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
FMA_AFTER = "SCREEN_ENTRY(screen_fused_batch_f64, double, double, 16)\n"
FMA_BF16 = ("SCREEN_ENTRY(screen_fused_bf16, __nv_bfloat16, float, 1)\n"
            "SCREEN_ENTRY(screen_fused_batch_bf16, __nv_bfloat16, float, 16)"
            "\n")
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
    "fma_bf16": [(FMA_AFTER, FMA_AFTER + FMA_BF16)],
    "tc_no_sort": [("      for (int q = ew; q < nb; q += TC_EWARPS) {\n",
                    "      for (int q = ew; false && q < nb; q += TC_EWARPS) {"
                    "\n")],
}
# the bf16 rows: (label, variant, entry, kernel name)
BF16_ROUTES = (("wgmma", "as_is", "tc", "screen_tc_kernel"),
               ("wgmma no_sort", "tc_no_sort", "tc", "screen_tc_kernel"),
               ("fma", "fma_bf16", "fma", "screen_fused_kernel"))


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
    ap.add_argument("--bf16-only", action="store_true",
                    help="build and time only the bf16 mode's routes")
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
    todo = {k: v for k, v in VARIANTS.items()
            if not args.bf16_only or k in {r[1] for r in BF16_ROUTES}}
    with ThreadPoolExecutor(len(todo)) as ex:
        libs = dict(ex.map(
            lambda kv: build(kv[0], kv[1], src, out_dir, _build.nvcc(),
                             _build.NVCC_FLAGS), todo.items()))

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
        if args.bf16_only or name in ("fma_bf16", "tc_no_sort"):
            continue                    # f32/f64 as as_is
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
    bf16, bf16_ok = bf16_rows(libs, X64, n, p, h, sig, dev, args.reps)
    print(json.dumps({"card": nvidia_smi_line(), "ms": record,
                      "one_cta_bitwise_as_is": same, "bf16": bf16}))
    return 0 if same and bf16_ok else 1


def bf16_rows(libs, X64, n, p, h, sig, dev, reps):
    """The bf16 mode, masked: the tensor-core scan (as_is, and tc_no_sort)
    and the fma instance (fma_bf16) on the same inputs at K1 (m = 1) and
    K1b (B = 16),
    each within its sums' bound of the twin; device and call ms, cuBLAS's
    bf16 product and the byte bound. Returns (rows, all within bound)."""
    import torch
    from chip_smoke import bound_ms, device_ms, time_ms
    from repro_torch.core.duality import dot_error_gamma
    from repro_torch.kernels.screen.ref import screen_fused_batch_ref
    from repro_torch.kernels.screen.screen import tma_bf16

    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    Xb = tma_bf16(X64)
    cn = torch.linalg.vector_norm(X64, dim=0).float()
    u = 2.0 ** -24
    guard = 1.0 + 8.0 * u
    st = P(torch.cuda.current_stream().cuda_stream)
    rows, ok_all = {}, True
    for b, entry in ((1, "screen_fused_bf16"),
                     (16, "screen_fused_batch_bf16")):
        gg = torch.Generator(device=dev).manual_seed(2)
        Th = (torch.randn(b, n, generator=gg, dtype=torch.float64,
                          device=dev) / n).to(torch.bfloat16)
        Thb, Thf = tma_bf16(Th), Th.float()
        act = torch.zeros(b, p, dtype=torch.bool, device=dev)
        for i in range(b):
            act[i, torch.randperm(p, generator=gg, device=dev)[:500]] = True
        r = torch.full((b,), 0.05, dtype=torch.float32, device=dev)
        pb = -(-p // 256)
        twin = screen_fused_batch_ref(Xb.float(), Thf, cn, act, r, h=h,
                                      guard=guard)
        absdot = Th.double().abs() @ Xb.double().abs()
        free = ~act
        bnd, by = bound_ms(n * p * 2 + b * n * 2 + p * 4 + b * p + b * 4
                           + 3 * b * p * 4 + b * pb * h * 8 + b * pb * 4,
                           2 * b * n * p, "bfloat16")
        lib_ms = time_ms(lambda: torch.abs(Th @ Xb), 20)
        for route, variant, kind, kernel in BF16_ROUTES:
            lib = ctypes.CDLL(str(libs[variant]))
            if kind == "tc":
                fn = lib.screen_fused_tc
                fn.argtypes = [P, I, P, I] + [F if a is None else a
                                              for a in sig[2:]]
                gam = dot_error_gamma(n, u) + dot_error_gamma(n, 2 * u)
            else:
                fn = getattr(lib, entry)
                fn.argtypes = [F if a is None else a for a in sig]
                gam = 2 * dot_error_gamma(n, u)
            fn.restype = ctypes.c_int
            outs = [torch.empty(b, p, dtype=torch.float32, device=dev)
                    for _ in range(3)]
            outs += [torch.empty(b, pb, h, dtype=torch.float32, device=dev),
                     torch.empty(b, pb, h, dtype=torch.int32, device=dev),
                     torch.empty(b, pb, dtype=torch.float32, device=dev)]
            tail = [P(cn.data_ptr()), 0, P(act.data_ptr()), P(r.data_ptr()),
                    b, n, p, h, 1, guard, *[P(o.data_ptr()) for o in outs],
                    st]

            def call(route=route, kind=kind, tail=tail, fn=fn):
                rc = (fn(P(Xb.data_ptr()), Xb.stride(0), P(Thb.data_ptr()),
                         Thb.stride(0), *tail) if kind == "tc" else
                      fn(P(Xb.data_ptr()), P(Thf.data_ptr()), *tail))
                if rc != 0:
                    raise RuntimeError(f"bf16 {route}: CUDA error {rc}")
            call()
            torch.cuda.synchronize()
            share = float(((outs[0] - twin[0]).abs().double()
                           / (gam * absdot).clamp(min=1e-300))[free].max())
            ok = share <= 1.0
            ok_all &= ok
            key = f"{'K1' if b == 1 else 'K1b'} bf16 {route}"
            rows[key] = dict(ms=device_ms(call, reps, kernel),
                             call_ms=time_ms(call, reps),
                             library_ms=lib_ms, bound_ms=bnd, bound_by=by,
                             err_over_twin_bound=share, ok=ok)
            print(f"[bf16 {key}] " + " ".join(
                f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in rows[key].items()), flush=True)
    return rows, ok_all


if __name__ == "__main__":
    sys.exit(main())
