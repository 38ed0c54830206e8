"""Run chip_smoke.py's ``[lm-hymba/full]`` phase alone on the card, once
for each depth of its float32 decode-against-forward check given, in
order, to see whether that check's depth moves the bfloat16 prefill and
decode timings that follow it in the same process.

    python3 scripts/lm_hymba_phase_torch.py [--layers 8 32 8 32]

Prints the phase's own lines for each run (``[lm-hymba/full/f32]``,
``[lm-hymba/full/bf16]``, the two profiles) after a ``[run]`` line naming
the depth. Needs one card; builds no kernel (the LM launches none).
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[8, 32, 8, 32],
                    help="depths of the float32 check, one run each")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as smoke
    import torch
    if not torch.cuda.is_available():
        print("lm_hymba_phase_torch: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smoke.nvidia_smi_line()
    print(f"card: {smi}; torch {torch.__version__}", flush=True)
    for i, n in enumerate(args.layers):
        smoke.LM_F32_LAYERS = n
        now = time.perf_counter()
        smoke.MARKS[:] = [now, now]
        print(f"[run] {i} f32_check_layers={n}", flush=True)
        smoke.lm_hymba_phase(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
