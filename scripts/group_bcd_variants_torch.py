#!/usr/bin/env python3
"""Build design variants of the group block-CD kernel B-n3
(``csrc/group_bcd.cu``) on one NVIDIA card, hold each bit for bit against
the shipped build and against saved fingerprints of another tree, and
time each per block step; measure one CTA's read rate from L2.

    python3 scripts/group_bcd_variants_torch.py --hashes a.json
    python3 scripts/group_bcd_variants_torch.py --src OTHER/src \\
        --tag other --variants shipped --hashes b.json   # another tree
    python3 scripts/group_bcd_variants_torch.py --compare a.json b.json

Each variant is the tree's ``csrc/group_bcd.cu`` after the textual edits
of its ``VARIANTS`` entry (where the next block is loaded, the register
form's cluster size, a barrier wait that traps, a clock trace of a step's
phases), built with ``nvcc -Xptxas -v`` (registers and spills of every
kernel instance printed; ``--sass``: each kernel's local-memory loads and
stores counted in its SASS) into ``build/group_variants/``. Each case
runs through the tree's own wrapper (``kernels/group/group.py::
group_bcd``) with the variant's library in place of the tree's build, so
in the form the tree's gate gives it (the register form's copy of a
block, ``reg_layout``, made once a case, outside the timing). The cases
are
``chip_smoke.py``'s B-n3 blocks, 40 epochs from beta = 0: the
least-squares and logistic timing blocks (``group_timing_block``: the 314
and 250 groups of largest c0 on phase 2's and 3's designs in groups of
10, at GROUP_LAM and GROUP_LOGIT_HI of the group lambda_max; also the
first 32 of the least-squares block), the final live blocks of the
least-squares Scalar at GROUP_LAM (also in the logistic entry on the
labels sign(y)) and of the logistic Scalar at GROUP_LOGIT_LAM, and
``group_edge_cases``; each in float64 and float32. The first run solves
the two Scalars and saves the blocks to ``--inputs`` (under the
git-ignored ``build/``); later runs, from either tree, load them. Every
output (beta, z) is fingerprinted (sha256 of its bytes) under
``<variant>/<case>/<dtype>``; ``--hashes`` writes the fingerprints of the
``shipped`` variant and ``--compare`` fails when two files differ on a
common key. Timings: CUDA events, the mean of ``--reps`` launches after a
warm-up, as ms a launch and us a block step, on the timing and final
blocks; the ``trace`` variant prints its mean cycles a phase.

The L2 line: one CTA of 512 threads reads a block of ``gsize x n``
float64 values (80 KB at 10 x 1000), each thread its rows of every
column, ``--l2-reps`` times over, and prints GB/s and us per block.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
N_EP = 40

# name -> [(regex, replacement)] applied to csrc/group_bcd.cu; each edit
# must match exactly once
VARIANTS = {
    "shipped": [],
    # the next step's block loaded at the end of the step, or at the start
    # of its own step (before the update of z), instead of right after the
    # barrier wait
    "pf_end": [
        (r"(?m)^    if \(t \+ 1 < S\) fetch\(prv, [^\n]*\n[^\n]*\n", ""),
        (r"(?m)^(    __syncwarp\(\);  +// the warp's d is in\n)",
         r"\1    if (t + 1 < S) fetch(prv, s + 1 == nl ? 0 : s + 1);\n"),
    ],
    "pf_start": [
        (r"(?m)^    if \(t \+ 1 < S\) fetch\(prv, [^\n]*\n[^\n]*\n", ""),
        (r"(?m)^  if \(S > 0\) fetch\(X, 0\);\n", ""),
        (r"(?m)^(    if \(moved\) update\(prv, d\);\n)",
         r"    fetch(cur, s);\n\1"),
    ],
    # the register form on a cluster of 1, 2 or 4 CTAs (shipped: 8)
    **{f"cluster{c}": [(r"constexpr int CLUSTER = \d+;",
                        f"constexpr int CLUSTER = {c};")]
       for c in (1, 2, 4)},
    # a barrier wait that traps after 2^20 polls instead of hanging (the
    # first run of a changed exchange)
    "trap": [
        (r"  while \(!mbar_try\(b, parity\)\) \{\n  \}",
         "  for (long long i = 0; !mbar_try(b, parity); ++i)\n"
         "    if (i > (1LL << 20)) __trap();"),
    ],
    # diagnostic: thread 0 stamps clock64() at the register form's phase
    # boundaries on steps 100-163 of a launch (TRACE_PHASES, in order)
    "trace": [
        (r"(#include <stdint.h>\n)", r"""\1
__device__ long long g_trace[64 * 11];
#define STAMP(k) if (threadIdx.x == 0 && blockIdx.x == 0 && t >= 100 && \\
    t < 164) g_trace[(t - 100) * 11 + (k)] = clock64();
extern "C" int trace_read(void* out) {
  return (int)cudaMemcpyFromSymbol(out, g_trace, sizeof(g_trace));
}
"""),
        (r"(?m)^(    T d\[G\];  )", r"    STAMP(0)\n\1"),
        (r"(?m)^(    if \(moved\) update\(prv, d\);)", r"    STAMP(1)\n\1"),
        (r"(?m)^(    T part\[G\];)", r"    STAMP(2)\n\1"),
        (r"(?m)^(    \{\n      const T w = Fold)", r"    STAMP(3)\n\1"),
        (r"(?m)^(    mbar_wait\(mbar \+ par[^\n]*\n)",
         r"    STAMP(4)\n\1    STAMP(5)\n"),
        (r"(?m)^(    T q\[HALF\];)", r"    STAMP(6)\n\1"),
        (r"(?m)^(    const T lj = ls\[s\], tj = ts\[s\];)",
         r"    STAMP(7)\n\1"),
        (r"(?m)^(    T nrm2 = T\(0\);)", r"    STAMP(8)\n\1"),
        (r"(?m)^(    T dc = T\(0\);)", r"    STAMP(9)\n\1"),
        (r"(?m)^(    s = s \+ 1 == nl \? 0 : s \+ 1;)", r"    STAMP(10)\n\1"),
    ],
}
# what each stamp interval of the trace variant covers
TRACE_PHASES = ("d from the warp's copy", "update of z",
                "f'(z) and partial dots", "warp folds and sends",
                "barrier wait", "next block's loads sent",
                "cross-warp folds",
                "v, its share", "norm, sqrt, scale", "b, d, vote",
                "loop to the next step")

L2_SRC = r"""
#include <cuda_runtime.h>
namespace {
__global__ void __launch_bounds__(512, 1) l2_read(
    const double* __restrict__ a, int g, int n, int reps,
    double* __restrict__ out) {
  double acc[4] = {0, 0, 0, 0};
  for (int r = 0; r < reps; ++r)
#pragma unroll 10
    for (int c = 0; c < g; ++c)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = threadIdx.x + 512 * q;
        if (i < n) acc[q] += __ldg(a + (size_t)c * n + i);
      }
  out[threadIdx.x] = acc[0] + acc[1] + acc[2] + acc[3];
}
}
extern "C" int l2_read_launch(const void* a, int g, int n, int reps,
                              void* out, void* stream) {
  l2_read<<<1, 512, 0, (cudaStream_t)stream>>>(
      (const double*)a, g, n, reps, (double*)out);
  return (int)cudaGetLastError();
}
"""


def local_ops(_build, out, tag):
    """Count each kernel's local-memory loads and stores (spills) in the
    SASS that ``cuobjdump`` reads back from the library."""
    res = subprocess.run([str(Path(_build.nvcc()).parent / "cuobjdump"),
                          "-sass", str(out)], capture_output=True, text=True)
    for part in res.stdout.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        ldl = len(re.findall(r"\bLDL\b", part))
        stl = len(re.findall(r"\bSTL\b", part))
        print(f"[sass {tag}] {name}: LDL={ldl} STL={stl}", flush=True)


def nvcc_build(_build, src_text, out, tag, sass=False):
    out.parent.mkdir(parents=True, exist_ok=True)
    cu = out.with_suffix(".cu")
    cu.write_text(src_text)
    res = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas",
                          "-v", "-o", str(out), str(cu)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {tag}:\n{res.stdout}"
                           f"{res.stderr}")
    fn = None
    for line in (res.stdout + res.stderr).splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
        if "registers" in line or "spill" in line:
            print(f"[ptxas {tag}] {fn}: {line.strip()}", flush=True)
    if sass:
        local_ops(_build, out, tag)


def variant_source(text, edits, name):
    for pat, rep in edits:
        text, k = re.subn(pat, rep, text)
        if k != 1:
            raise RuntimeError(f"variant {name}: {pat!r} matched {k} times")
    return text


def load(_build, out):
    """The variant's library at ``out``, its entries typed as the tree's
    ``_build.library`` types its own build's."""
    lib_path = _build._lib_path
    _build._lib_path = lambda name: out
    _build._LIBS.pop("group_bcd", None)
    try:
        return _build.library("group_bcd")
    finally:
        _build._lib_path = lib_path
        _build._LIBS.pop("group_bcd", None)


def launcher(_build, group, lib):
    """A call of the tree's own wrapper ``group.group_bcd`` on the library
    ``lib`` (so in the form the tree's gate picks); the register form's
    copy of a block (``reg_layout``, where the tree has it) is made once
    for a run of calls on the same block, outside the timing."""
    layout = getattr(group, "reg_layout", None)
    if layout is not None and not hasattr(layout, "last"):
        def once(A):
            if once.last[0] is not A:       # A is kept, so not reused
                once.last = (A, layout(A))
            return once.last[1]
        once.last = (None, None)
        group.reg_layout = once

    def run(A, y, slot, beta, L, lam, n_ep, loss_name):
        _build._LIBS["group_bcd"] = lib
        return group.group_bcd(A, y, slot, beta, L, lam, n_ep,
                               loss_name=loss_name)
    return run


def print_trace(lib, what):
    """The trace variant's mean cycles per phase over its 63 full steps."""
    import numpy as np
    k = len(TRACE_PHASES)
    buf = np.zeros(64 * k, dtype=np.int64)
    rc = lib.trace_read(ctypes.c_void_p(buf.ctypes.data))
    if rc != 0:
        raise RuntimeError(f"trace_read failed: {rc}")
    st = buf.reshape(64, k).astype(np.float64)
    ends = np.concatenate([st[:-1, 1:], st[1:, :1]], axis=1)
    cyc = (ends - st[:-1]).mean(axis=0)
    parts = " ".join(f"{k}={c:.0f}" for k, c in zip(TRACE_PHASES, cyc))
    print(f"[trace] {what}: cycles a step={cyc.sum():.0f}; {parts}",
          flush=True)


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


def make_inputs(path, p):
    """The timing and final blocks (float64, on the card), solved once."""
    import torch
    import chip_smoke as cs
    import repro_torch as rt
    from repro_torch.core.group import group_solve, prepare_group
    if path.exists():
        return torch.load(path, map_location="cuda")
    dev = torch.device("cuda")
    Xn, _ = cs.simulation_data(cs.N, p)
    X = torch.from_numpy(Xn).to(dev)
    Ln, _ = cs.logistic_data(cs.N, p)
    XL = torch.from_numpy(Ln).to(dev)
    del Xn, Ln
    y = cs.group_response(X, seed=400)
    yl = cs.group_response(XL, seed=401, logistic=True)
    out = {"ls timing": (cs.group_timing_block(
        X, y, "least_squares", cs.GROUP_LAM,
        cs.GROUP_TIMING_LIVE["least_squares"]), "least_squares"),
           "logit timing": (cs.group_timing_block(
               XL, yl, "logistic", cs.GROUP_LOGIT_HI,
               cs.GROUP_TIMING_LIVE["logistic"]), "logistic")}
    for name, Xd, yy, loss_name, frac in (
            ("ls", X, y, "least_squares", cs.GROUP_LAM),
            ("logit", XL, yl, "logistic", cs.GROUP_LOGIT_LAM)):
        loss = rt.get_loss(loss_name)
        cfg = rt.GroupSaifConfig(eps=cs.GROUP_EPS, loss=loss_name)
        prep = prepare_group(Xd, yy, cs.GROUP_SIZE, cfg)
        lam = frac * rt.group_lambda_max(loss, Xd, yy, cs.GROUP_SIZE)
        res = group_solve(prep, lam, cfg)
        print(f"[inputs] {name} Scalar at {frac}: outer={res.n_outer} "
              f"active_groups={res.n_active_groups}", flush=True)
        blk = cs.group_block(Xd, prep.y, res, prep.gfro, lam, loss,
                             torch.float64)
        out[f"{name} final"] = (blk, loss_name)
        if name == "ls":
            ys = torch.sign(prep.y)
            lam_s = cs.GROUP_LAM * rt.group_lambda_max(
                rt.get_loss("logistic"), Xd, ys, cs.GROUP_SIZE)
            out["ls final, logistic entry"] = (
                (blk[0], ys, *blk[2:4], 0.25 * blk[4], lam_s, N_EP),
                "logistic")
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(out, path)
    return out


def l2_rate(_build, gs, n, reps):
    import torch
    out = ROOT / "build" / "group_variants" / "l2_read.so"
    nvcc_build(_build, L2_SRC, out, "l2_read")
    fn = ctypes.CDLL(str(out)).l2_read_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    a = torch.randn(gs * n, dtype=torch.float64, device="cuda")
    out = torch.empty(512, dtype=torch.float64, device="cuda")

    def go():
        rc = fn(a.data_ptr(), gs, n, reps, out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"l2_read launch failed: {rc}")
    ms = events_ms(go, 3)
    nbytes = 8.0 * gs * n
    print(f"[l2-read] one CTA of 512 threads, a {gs}x{n} float64 block "
          f"({nbytes / 1e3:.0f} KB) read {reps} times: ms={ms:.4f} "
          f"GB/s={nbytes * reps / ms / 1e6:.2f} us_per_block="
          f"{ms * 1e3 / reps:.4f}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the tree whose repro_torch (and csrc) to build")
    ap.add_argument("--tag", default="this")
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS))
    ap.add_argument("--hashes", help="write the shipped variant's "
                                     "fingerprints here")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"))
    ap.add_argument("--inputs", default=str(ROOT / "build" /
                                            "group_probe_inputs.pt"))
    ap.add_argument("--p", type=int, default=100_000)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--l2-reps", type=int, default=2000)
    ap.add_argument("--sass", action="store_true",
                    help="count each kernel's spill loads and stores in "
                         "its SASS (cuobjdump)")
    args = ap.parse_args()

    if args.compare:
        a, b = (json.loads(Path(f).read_text()) for f in args.compare)
        common = sorted(set(a) & set(b))
        bad = [k for k in common if a[k] != b[k]]
        print(f"[compare] {len(common)} common keys ({len(a)} and "
              f"{len(b)}), {len(bad)} differ: {bad}", flush=True)
        return 1 if bad or not common else 0

    import torch
    if not torch.cuda.is_available():
        print("group_bcd_variants_torch: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.group import group
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {cs.nvidia_smi_line()}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; tree {args.tag} ({args.src})", flush=True)
    source = (Path(args.src) / "repro_torch" / "csrc" /
              "group_bcd.cu").read_text()
    runs, libs = {}, {}
    for name in args.variants:
        text = variant_source(source, VARIANTS[name], name)
        out = ROOT / "build" / "group_variants" / f"{args.tag}_{name}.so"
        nvcc_build(_build, text, out, f"{args.tag} {name}", args.sass)
        libs[name] = load(_build, out)
        runs[name] = launcher(_build, group, libs[name])
    blocks = make_inputs(Path(args.inputs), args.p)
    dev = torch.device("cuda")
    hashes, times = {}, {}
    for dtype in ("float64", "float32"):
        dt = getattr(torch, dtype)
        cases = [(k, tuple(x.to(dt) if torch.is_tensor(x)
                           and x.is_floating_point() else x for x in a), ln)
                 for k, (a, ln) in blocks.items()]
        a, ln = blocks["ls timing"]
        cases.append(("ls timing 32 live", (a[0][:32].to(dt), a[1].to(dt),
                                             a[2][:32], a[3][:32].to(dt),
                                             a[4][:32].to(dt), *a[5:]), ln))
        cases += [(k, a, ln) for k, a, ln in cs.group_edge_cases(dev, dt)]
        for name, run in runs.items():
            for case, a, loss_name in cases:
                b, z = run(*a, loss_name)
                torch.cuda.synchronize()
                h = hashlib.sha256()
                h.update(b.cpu().numpy().tobytes())
                h.update(z.cpu().numpy().tobytes())
                hashes[f"{name}/{case}/{dtype}"] = h.hexdigest()
                if name == "trace" and case.endswith("timing"):
                    print_trace(libs[name], f"{case} {dtype}")
                if "timing" in case or case.endswith("final"):
                    ms = events_ms(lambda: run(*a, loss_name), args.reps)
                    steps = a[6] * a[0].shape[0]
                    times[f"{name}/{case}/{dtype}"] = ms
                    print(f"[time {args.tag} {name}] {case} {dtype}: live="
                          f"{a[0].shape[0]} ms={ms:.4f} us_per_step="
                          f"{ms * 1e3 / steps:.4f}", flush=True)
    for name in runs:
        if name != "shipped":
            same = [k for k in hashes if k.startswith(f"{name}/") and
                    hashes[k] == hashes.get("shipped/" + k.split("/", 1)[1])]
            total = sum(k.startswith(f"{name}/") for k in hashes)
            print(f"[bits {args.tag}] {name}: {len(same)} of {total} "
                  f"outputs equal the shipped variant's", flush=True)
    l2_rate(_build, cs.GROUP_SIZE, cs.N, args.l2_reps)
    if args.hashes:
        Path(args.hashes).parent.mkdir(parents=True, exist_ok=True)
        Path(args.hashes).write_text(json.dumps(
            {k.split("/", 1)[1]: v for k, v in hashes.items()
             if k.startswith("shipped/")}, indent=1, sort_keys=True))
    print(json.dumps({"tree": args.tag, "ms": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
