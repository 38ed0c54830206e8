#!/usr/bin/env python3
"""Time the chain suffix-sum kernel K4 on one NVIDIA card at
``chip_smoke.py``'s full width and fingerprint its outputs, so that two
source trees can be held bit for bit against each other.

    python3 scripts/chain_probe_torch.py                       # this tree
    python3 scripts/chain_probe_torch.py --src OTHER/src \\
        --save-hashes a.json                                   # another tree
    python3 scripts/chain_probe_torch.py --compare-hashes a.json

Cases, each in float64 and float32: the smoke's least-squares design
(the paper's Sec 5.1.1 simulation, n = 1000, p = 100,000); edge shapes, n
= 13 (and 1 and 8) with p in {1, 255, 256, 257, 777, 1000, 5000}, gaussian,
with -0.0 and NaN entries in the last and first columns and a row of -0.0
(13 rows: one CTA of 8 and one of 5); and X 4 or 8 bytes off 16-byte
alignment (a view into a larger buffer), which the kernel must copy
element by element. Every output is held against the plain twin on the
card (``chip_smoke.same_bits``: bit for bit where it is not NaN, NaN
where the twin is NaN: in float32 the kernel's first add turns a NaN in
the last column into the card's canonical NaN, where the twin copies
that column) and fingerprinted (sha256 of its bytes); ``--compare-hashes``
fails the run when one differs from the saved ones.

It prints nvcc's ``-Xptxas -v`` report for ``csrc/chain_suffix.cu`` (from
the one build the wrapper loads), then at full width the kernel's device
time per launch (torch.profiler), the time of a wrapper call (CUDA
events), the byte bound at 3.35 TB/s, the measured add latency and the
latency floor (p - 1 dependent adds at the card's maximum SM clock), and
a JSON line.
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

    import torch
    if not torch.cuda.is_available():
        print("chain_probe_torch: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    import repro_torch as rt
    from chip_smoke import (CHAIN_EDGE_P, N, bound_ms, chain_edge_input,
                            kernel_ms, nvidia_smi_line, same_bits,
                            simulation_data)
    from cm_probe_torch import build_with_report
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.fused.fused import add_latency_cycles

    print(f"card: {nvidia_smi_line()}; torch {torch.__version__}; "
          f"src {rt.__file__}", flush=True)
    build_with_report(_build, None, ("chain_suffix",))
    dev = torch.device("cuda")
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])

    hashes, record, bad = {}, {}, []

    def check(tag, X):
        S = ops.chain_suffix_sums(X)
        S_ref = ops.chain_suffix_sums_ref(X)
        torch.cuda.synchronize()
        same = same_bits([S], [S_ref])
        hashes[tag] = hashlib.sha256(
            S.contiguous().cpu().numpy().tobytes()).hexdigest()
        if not same:
            bad.append(tag)
        return same

    Xn = simulation_data(N, 100_000)[0]
    for dtype in ("float64", "float32"):
        dt = getattr(torch, dtype)
        edges = []
        for n in (13, 1, 8):
            for p in CHAIN_EDGE_P:
                X = chain_edge_input(n, p, dt, seed=p + n).to(dev)
                edges.append(check(f"{dtype}/edge n={n} p={p}", X))
        for p in (1000, 777):
            # a view one element into a larger buffer: its rows start 4 or
            # 8 bytes off a 16-byte boundary
            X = torch.empty(13 * p + 1, dtype=dt, device=dev)[1:].view(13, p)
            X.copy_(chain_edge_input(13, p, dt, seed=p))
            edges.append(check(f"{dtype}/off-aligned n=13 p={p}", X))
        X = torch.from_numpy(Xn).to(dev, dt)
        full = check(f"{dtype}/full n={N} p=100000", X)
        ms, call = kernel_ms(lambda: ops.chain_suffix_sums(X), args.reps,
                             "chain_suffix_kernel")
        n, p = X.shape
        isz = X.element_size()
        bnd, by = bound_ms(2 * n * p * isz, n * (p - 1), dtype)
        cyc = add_latency_cycles(dt)
        floor = (p - 1) * cyc / (clock * 1e6) * 1e3
        record[dtype] = dict(ms=ms, call_ms=call, bound_ms=bnd, bound_by=by,
                             add_latency_cycles=cyc, latency_floor_ms=floor,
                             bitwise_full=full, bitwise_edges=all(edges))
        print(f"[probe K4 {dtype}] n={n} p={p} ms={ms:.4f} "
              f"call_ms={call:.4f} bound_ms={bnd:.4f} ({by}) "
              f"add_latency_cycles={cyc:.2f} max_sm_clock_mhz={clock:.0f} "
              f"latency_floor_ms={floor:.4f} bitwise_full={full} "
              f"bitwise_edges={all(edges)} ({len(edges)} edge cases)",
              flush=True)
        del X

    print(json.dumps({"card": nvidia_smi_line(), "src": args.src,
                      "probe": record}))
    rc = 0
    if bad:
        print(f"[twin] not bitwise: {bad}", flush=True)
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
