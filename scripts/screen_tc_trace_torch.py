#!/usr/bin/env python3
"""Where the time of the bf16 tensor-core scan goes, on one NVIDIA card:
phase timestamps from inside ``screen_tc_kernel``.

    python3 scripts/screen_tc_trace_torch.py [--reps 3]

Builds a copy of the checkout's ``src/repro_torch/csrc/screen.cu`` under
``build/screen_tc_trace/`` whose kernel stamps the card's global timer
(``%globaltimer``, ns) at the edges of each work item's phases, for the
first four items of the first 256 CTAs:

* the wgmma warpgroup: the item's mainloop (from its first stage wait to
  its last stage's wgmmas) and the hand-over of its |sums| (the wait for a
  free epilogue buffer and the stores);
* the epilogue warps: the wait for the item's |sums|, the column pass and
  the warp sorts (an extra barrier of the epilogue warps closes the item).

It runs K1b (B = 16) and K1 (m = 1) at the smoke's n = 1000, p = 100,000
(X ~ U[-10, 10], 5 % of each problem's features active) and prints, per
phase, the mean, median and largest duration in us, the kernel's span,
how long each CTA's last epilogue runs after its last mainloop (the tail
that nothing overlaps), and four CTAs' timelines. The stamps cost a few
instructions an item; compare spans only with this script's own.
"""
from __future__ import annotations

import argparse
import ctypes
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# (anchor in screen.cu, its replacement); each anchor occurs once
STAMPS = [
    ("constexpr int TC_KB = 64;",
     "__device__ long long tc_trace[1024][8];\n"
     "__device__ __forceinline__ long long gtime() {\n"
     "  long long x;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(x));\n"
     "  return x;\n}\n"
     "constexpr int TC_KB = 64;"),
    ("      if (blockIdx.x + it * gridDim.x >= items) break;\n",
     "      if (blockIdx.x + it * gridDim.x >= items) break;\n"
     "      const long long A0 = gtime();\n"),
    ("      const int b = it & 1, u = it >> 1;\n",
     "      const long long A1 = gtime();\n"
     "      const int b = it & 1, u = it >> 1;\n"),
    ("      if (wl == 0) mbar_arrive(&kfull[b]);\n",
     "      if (wl == 0) mbar_arrive(&kfull[b]);\n"
     "      if (t == 0 && blockIdx.x < 256 && it < 4) {\n"
     "        long long* T = tc_trace[blockIdx.x * 4 + it];\n"
     "        T[0] = A0; T[1] = A1; T[2] = gtime();\n      }\n"),
    ("    const int b = it & 1;\n    mbar_wait(&kfull[b], ",
     "    const long long E0 = gtime();\n"
     "    const int b = it & 1;\n    mbar_wait(&kfull[b], "),
    ("    float* key_s = epi + b * S::EPI_FLOATS;\n    float* umax_s",
     "    const long long E1 = gtime();\n"
     "    float* key_s = epi + b * S::EPI_FLOATS;\n    float* umax_s"),
    ("    if (masked) {\n      epi_sync();\n",
     "    const long long E2 = gtime();\n"
     "    if (masked) {\n      epi_sync();\n"),
    ("    __syncwarp();\n    if (wl == 0) mbar_arrive(&kempty[b]);\n",
     "    epi_sync();\n"
     "    if (e == 0 && blockIdx.x < 256 && it < 4) {\n"
     "      long long* T = tc_trace[blockIdx.x * 4 + it];\n"
     "      T[3] = E0; T[4] = E1; T[5] = E2; T[6] = gtime(); T[7] = 1;\n"
     "    }\n"
     "    __syncwarp();\n    if (wl == 0) mbar_arrive(&kempty[b]);\n"),
    ("int empty_launch(void* stream) {",
     "int tc_trace_get(void* host) {\n"
     "  return (int)cudaMemcpyFromSymbol(host, tc_trace,"
     " sizeof tc_trace);\n}\n"
     "int tc_trace_clear() {\n"
     "  static long long zero[1024][8];\n"
     "  return (int)cudaMemcpyToSymbol(tc_trace, zero, sizeof zero);\n}\n"
     "int empty_launch(void* stream) {"),
]
# phase -> (start stamp, end stamp)
PHASES = {"mainloop": (0, 1), "hand-over": (1, 2), "epilogue wait": (3, 4),
          "column pass": (4, 5), "sorts": (5, 6)}


def stamped_source(src: str) -> str:
    for old, new in STAMPS:
        if src.count(old) != 1:
            raise RuntimeError(f"anchor not found once in screen.cu: "
                               f"{old.strip()[:60]}")
        src = src.replace(old, new)
    return src


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3,
                    help="launches a shape (the last one is traced)")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("screen_tc_trace_torch: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import nvidia_smi_line
    from repro_torch.kernels import _build

    out = ROOT / "build" / "screen_tc_trace"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(_build.CSRC, out)
    (out / "screen.cu").write_text(stamped_source(
        (out / "screen.cu").read_text()))
    _build.CSRC = out                     # the wrappers load the copy
    from repro_torch.kernels import ops
    from repro_torch.kernels.screen.screen import tma_bf16
    lib = _build.library("screen")

    print(f"card: {nvidia_smi_line()}; torch {torch.__version__}",
          flush=True)
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    n, p = 1000, 100_000
    X = (torch.rand(n, p, generator=g, dtype=torch.float64) * 20
         - 10).to(dev)
    Xb = tma_bf16(X)
    cn = torch.linalg.vector_norm(X, dim=0).float()
    buf = (ctypes.c_longlong * (1024 * 8))()
    for m in (16, 1):
        Th = (torch.randn(m, n, generator=g, dtype=torch.float64)
              / (10 * n ** 0.5)).to(dev)
        act = (torch.rand(m, p, generator=g) < 0.05).to(dev)
        r = torch.full((m,), 5e-3, device=dev)
        for _ in range(args.reps):
            lib.tc_trace_clear()
            torch.cuda.synchronize()
            ops.screen_fused_batch(Xb, Th, cn, act, r, h=16,
                                   in_dtype="bfloat16",
                                   guard=1.0 + 8 * 2.0 ** -24)
            torch.cuda.synchronize()
        _build.check(lib.tc_trace_get(ctypes.cast(buf, ctypes.c_void_p)),
                     "tc_trace_get")
        T = np.array(buf, dtype=np.int64).reshape(256, 4, 8)
        done = T[..., 7] == 1
        t0 = T[..., 0][done].min()
        print(f"[tc-trace m={m}] items traced {int(done.sum())}, span "
              f"{(T[..., 6][done].max() - t0) / 1e3:.2f} us", flush=True)
        for name, (a, b) in PHASES.items():
            d = (T[..., b] - T[..., a])[done] / 1e3
            print(f"  {name}: mean {d.mean():.2f} us, median "
                  f"{np.median(d):.2f}, max {d.max():.2f}", flush=True)
        last = done.sum(1) - 1            # each CTA's last traced item
        ctas = np.nonzero(done.any(1))[0]
        tail = np.array([T[c, last[c], 6] - T[c, last[c], 1]
                         for c in ctas]) / 1e3
        print(f"  tail (last epilogue after last mainloop): mean "
              f"{tail.mean():.2f} us, max {tail.max():.2f}", flush=True)
        for c in (0, 1, 64, int(ctas[-1])):
            print(f"  CTA {c}: " + "; ".join(
                f"item {i} main {(T[c, i, 0] - t0) / 1e3:.1f}-"
                f"{(T[c, i, 1] - t0) / 1e3:.1f} epi "
                f"{(T[c, i, 4] - t0) / 1e3:.1f}-"
                f"{(T[c, i, 6] - t0) / 1e3:.1f}"
                for i in range(4) if done[c, i]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
