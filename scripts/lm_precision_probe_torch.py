#!/usr/bin/env python3
"""How far the port's LM decode drifts from its forward pass in float32, and
how far bfloat16 compute moves the prefill's last-position logits from
float32's, on hymba-1.5b's architecture at reduced width and depth.

    python3 scripts/lm_precision_probe_torch.py --device cpu

For each (layers, d_model) pair, a hymba config with the published head
width (64), GQA ratio 5 and ssm_state 16 but a 64-token window, chunk 32
and a 4,000-token vocab is initialised from a seed (``init``); B = 2
sequences of ``--seq`` tokens go through ``backbone`` + ``logits_fn`` and,
token by token, through ``decode_step`` from an empty state (the ring
wraps), and through ``make_prefill`` in bfloat16 and float32. It prints
the worst |decode - forward| over scale = max|logits| + 1, and the
bfloat16 difference's rms over the float32 logits' rms and its max over
scale: the numbers ``chip_smoke.py``'s ``[lm-hymba/full]`` bounds are set
against. Runs on the card unless given ``--device cpu``.

``--full`` instead takes the published hymba-1.5b config (one card: 6.6
GB of float32 weights) and prints the same bfloat16 ratios for B = 4
prompts at each ``--prompts`` length, over the first ``--depths`` layers,
with cuBLAS's reduced-precision bf16 reductions allowed (torch's default)
and not.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", nargs="+", default=["4x320", "8x320",
                                                     "16x320", "8x640"],
                    help="layers x d_model pairs")
    ap.add_argument("--seq", type=int, default=80)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the CPU (default: the card)")
    ap.add_argument("--full", action="store_true",
                    help="the published config's bfloat16 ratios")
    ap.add_argument("--prompts", type=int, nargs="+", default=[256, 2048])
    ap.add_argument("--depths", type=int, nargs="+", default=[8, 32])
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.saif import resolve_device
    from repro_torch.models import lm

    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    full = get_config("hymba_1_5b")
    if args.full:
        return full_width(full, dev, args)
    for shape in args.shapes:
        L, D = map(int, shape.split("x"))
        H = D // 64
        cfg = full.scaled(n_layers=L, d_model=D, n_heads=H,
                          n_kv_heads=max(H // 5, 1), d_ff=int(D * 3.44),
                          window=64, ssm_chunk=32, vocab=4000,
                          dtype="float32")
        gen = torch.Generator(device=dev).manual_seed(0)
        params = lm.init(cfg, generator=gen, device=dev)
        toks = torch.randint(0, cfg.vocab, (2, args.seq), generator=gen,
                             device=dev)
        with torch.inference_mode():
            hidden, _ = lm.backbone(params, toks, cfg)
            logits = lm.logits_fn(params, hidden, cfg)
            st = lm.init_decode_state(params, cfg, 2, args.seq)
            worst = 0.0
            for t in range(args.seq):
                lg, st = lm.decode_step(params, toks[:, t], st, cfg)
                worst = max(worst, float((lg - logits[:, t]).abs().max()))
            scale = float(logits.abs().max()) + 1.0
            rms_rel, max_rel = bf16_ratios(params, cfg, toks)
        print(f"layers={L} d_model={D} heads={H} scale={scale:.4f} "
              f"decode_vs_forward={worst:.4e} rel={worst / scale:.3e} "
              f"bf16_last: rms_rel={rms_rel:.4f} max_rel={max_rel:.4f}",
              flush=True)
    return 0


def bf16_ratios(params, cfg, toks):
    """(rms_rel, max_rel) of the bfloat16 prefill's last logits against the
    float32 prefill's."""
    from repro_torch.launch.steps import make_prefill
    l32 = make_prefill(cfg.scaled(dtype="float32"))(params, {"tokens": toks})
    l16 = make_prefill(cfg.scaled(dtype="bfloat16"))(
        params, {"tokens": toks}).float()
    d = l16 - l32
    return (float(d.pow(2).mean().sqrt() / l32.pow(2).mean().sqrt()),
            float(d.abs().max()) / (float(l32.abs().max()) + 1.0))


def full_width(full, dev, args) -> int:
    import torch
    from repro_torch.models import lm
    gen = torch.Generator(device=dev).manual_seed(29)
    params = lm.init(full, generator=gen, device=dev)
    for depth in args.depths:
        cfg = full.scaled(n_layers=depth)
        sub = {k: ({n: t[:depth] for n, t in v.items()}
                   if isinstance(v, dict) else v) for k, v in params.items()}
        for S in args.prompts:
            toks = torch.randint(0, full.vocab, (4, S), generator=gen,
                                 device=dev)
            for reduced in (True, False):
                torch.backends.cuda.matmul.\
                    allow_bf16_reduced_precision_reduction = reduced
                rms_rel, max_rel = bf16_ratios(sub, cfg, toks)
                print(f"full width: layers={depth} prompt={S} "
                      f"bf16_reduced_reduction={reduced} rms_rel="
                      f"{rms_rel:.4f} max_rel={max_rel:.4f}", flush=True)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    return 0


if __name__ == "__main__":
    sys.exit(main())
