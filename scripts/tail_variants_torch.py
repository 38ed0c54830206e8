#!/usr/bin/env python3
"""Where the time of K2, the screen's tail (``screen_tail_kernel`` in
``src/repro_torch/csrc/screen.cu``), goes on one NVIDIA card: the kernel
as it ships beside textual variants of its source, at ``chip_smoke.py``'s
three screen shapes.

    python3 scripts/tail_variants_torch.py

Each variant is the checkout's ``screen.cu`` with one line replaced, built
with the port's nvcc flags into ``build/tail_variants/`` (all builds in
parallel) and called through the same C entry points:

* ``as_is``: the kernel as it ships (512 threads, 4 vectors of ub in
  flight a thread, a cluster of 16 CTAs a problem while the clusters fit
  on the SMs at once, else 8);
* ``c4`` / ``c8`` / ``c16``: a cluster of 4, 8 or 16 CTAs a problem at
  every shape;
* ``t256`` / ``t1024``: 256 or 1,024 threads a CTA;
* ``u2`` / ``u8``: 2 or 8 vectors in flight a thread;
* ``agg``: one shared atomic per bin and warp (``__match_any_sync``) in
  place of one per ub off the register-counted bins.

Every variant computes the kernel's function: each output must equal the
plain twin bit for bit. The shapes are the smoke's float64 screens: p =
100,000 with h = 16 for one problem and for the 16-problem fleet, and
h = 64 for the 5 CV folds (each with its own norms), on the inputs the
fleet screen gives K2b after a K1b scan of the smoke's least-squares
design (``scripts/screen_probe_torch.py``'s theta, radii and active
sets). For each variant and shape it prints the device time per launch
of the tail entry and of the histogram entry (torch.profiler, ``--reps`` launches after a warm-up),
then one JSON line.
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

THREADS = "constexpr int TAIL_THREADS = 512;\n"
UNROLL = ("constexpr int TAIL_UNROLL = 4;            "
          "// 16-byte loads in flight a thread\n")
CLUSTER = "  const int cluster = 16 * m <= sms ? 16 : 8;\n"
VARIANTS = {
    "as_is": [],
    "c4": [(CLUSTER, CLUSTER.replace("16 * m <= sms ? 16 : 8", "4"))],
    "c8": [(CLUSTER, CLUSTER.replace("16 * m <= sms ? 16 : 8", "8"))],
    "c16": [(CLUSTER, CLUSTER.replace("16 * m <= sms ? 16 : 8", "16"))],
    "t256": [(THREADS, THREADS.replace("512", "256"))],
    "t1024": [(THREADS, THREADS.replace("512", "1024"))],
    "u2": [(UNROLL, UNROLL.replace("= 4", "= 2"))],
    "u8": [(UNROLL, UNROLL.replace("= 4", "= 8"))],
    "agg": [("      atomicAdd(&bins_s[count_le(lb_s, h, top, y)], 1);\n",
             "      const int c = count_le(lb_s, h, top, y);\n"
             "      const unsigned peers = __match_any_sync(__activemask(), c);\n"
             "      if (wl == __ffs(peers) - 1) atomicAdd(&bins_s[c], "
             "__popc(peers));\n")],
}
SHAPES = ((1, 16, False), (16, 16, False), (5, 64, True))


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


def inputs(X, b, h, per_problem):
    """A screen's tail inputs as the ``cuda`` fleet screen hands them over:
    K1b's ub and tile maxima on the smoke's design X for b problems (Theta
    N(0, 1/n^2), 500 active features each, radii 0.01 .. 0.1; with
    ``per_problem`` the 5 CV folds' own norms), the merged tile winners
    (score, int64 id), the norms and the radii."""
    import torch
    import repro_torch as rt
    from repro_torch.kernels import ops
    dev = X.device
    n, p = X.shape
    g = torch.Generator().manual_seed(7)
    Theta = (torch.randn(b, n, generator=g, dtype=torch.float64) / n).to(dev)
    active = torch.zeros(b, p, dtype=torch.bool)
    for i in range(b):
        active[i, torch.randperm(p, generator=g)[:500]] = True
    active = active.to(dev)
    r = torch.linspace(0.01, 0.1, b, dtype=torch.float64, device=dev)
    if per_problem:
        W = rt.kfold_weights(n, b).to(X)
        cn = torch.stack([torch.sqrt(w @ (X * X)) for w in W])
    else:
        cn = torch.linalg.vector_norm(X, dim=0)
    _, ub, _, tops, topi, tmax = ops.screen_fused_batch(X, Theta, cn, active,
                                                        r, h=h)
    vals, pos = torch.sort(tops.reshape(b, -1), dim=1, descending=True,
                           stable=True)
    idx = torch.gather(topi.reshape(b, -1), 1, pos[:, :h]).long()
    return ub, tmax, vals[:, :h].contiguous(), idx, cn, r


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("tail_variants_torch: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (N, device_ms, nvidia_smi_line, same_bits,
                            simulation_data)
    from repro_torch.kernels import _build
    from repro_torch.kernels.screen.ref import (screen_tail_batch_ref,
                                                ub_histogram_batch_ref)

    print(f"card: {nvidia_smi_line()}; torch {torch.__version__}",
          flush=True)
    out_dir = ROOT / "build" / "tail_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "screen.cu").read_text()
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        libs = dict(ex.map(
            lambda kv: build(kv[0], kv[1], src, out_dir, _build.nvcc(),
                             _build.NVCC_FLAGS), VARIANTS.items()))

    P, I = ctypes.c_void_p, ctypes.c_int
    sig_tail = [P, P, P, I, P, P, I, P, I, I, I, I, P, P, P, P, P]
    sig_hist = [P, P, I, I, I, P, P]
    X = torch.from_numpy(simulation_data(N, 100_000)[0]).to("cuda")
    cases = [(b, h, pp, inputs(X, b, h, pp)) for b, h, pp in SHAPES]
    del X
    refs = [screen_tail_batch_ref(*a) for *_, a in cases]
    record, ok = {}, True
    for name, so in libs.items():
        lib = ctypes.CDLL(str(so))
        tail, hist = lib.screen_tail_f64, lib.ub_histogram_f64
        tail.argtypes, tail.restype = sig_tail, ctypes.c_int
        hist.argtypes, hist.restype = sig_hist, ctypes.c_int
        rows = {}
        for (b, h, pp, a), ref in zip(cases, refs):
            ub, tmax, sc, ix, cn, r = a
            p, pb = ub.shape[1], tmax.shape[1]
            lbs = torch.sort(ref[1], dim=1).values
            href = ub_histogram_batch_ref(ub, lbs)
            out = [torch.empty(b, dtype=ub.dtype, device=ub.device),
                   torch.empty(b, h, dtype=ub.dtype, device=ub.device),
                   torch.empty(b, h, dtype=torch.int32, device=ub.device),
                   torch.empty(b, dtype=torch.int32, device=ub.device)]
            hout = torch.empty(b, h + 1, dtype=torch.int32,
                               device=ub.device)
            st = P(torch.cuda.current_stream().cuda_stream)

            def run_tail():
                rc = tail(P(ub.data_ptr()), P(tmax.data_ptr()),
                          P(sc.data_ptr()), h, P(ix.data_ptr()),
                          P(cn.data_ptr()), p if pp else 0,
                          P(r.data_ptr()), b, p, pb, h,
                          P(out[1].data_ptr()), P(out[2].data_ptr()),
                          P(out[3].data_ptr()), P(out[0].data_ptr()), st)
                if rc:
                    raise RuntimeError(f"{name} tail: CUDA error {rc}")

            def run_hist():
                rc = hist(P(ub.data_ptr()), P(lbs.data_ptr()), b, p, h,
                          P(hout.data_ptr()), st)
                if rc:
                    raise RuntimeError(f"{name} hist: CUDA error {rc}")
            run_tail()
            run_hist()
            torch.cuda.synchronize()
            good = (same_bits([out[0], out[1], out[2], out[3]], ref)
                    and torch.equal(hout, href))
            ok = ok and good
            key = f"B={b} h={h}"
            rows[key] = {
                "tail_us": device_ms(run_tail, args.reps,
                                     "screen_tail_kernel") * 1e3,
                "hist_us": device_ms(run_hist, args.reps,
                                     "screen_tail_kernel") * 1e3,
                "bitwise": good}
        record[name] = rows
        print(f"[variant {name}] " + "; ".join(
            f"{k}: tail {v['tail_us']:.2f} us hist {v['hist_us']:.2f} us"
            f"{'' if v['bitwise'] else ' DIFFERS'}"
            for k, v in rows.items()), flush=True)
    print(json.dumps({"card": nvidia_smi_line(), "us": record,
                      "bitwise": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
