"""Assigned-architecture registry (port of ``repro.configs``):
``get_config(arch_id)`` + shape registry.

Every entry reproduces the published config verbatim (see per-file source
tags). ``SHAPES`` defines the four assigned input-shape cells; applicability
filtering (long_500k needs sub-quadratic attention) lives in
``runnable_cells``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Tuple

from repro_torch.models.config import ModelConfig

ARCH_IDS = [
    "stablelm_3b", "deepseek_7b", "nemotron_4_15b", "glm4_9b", "hymba_1_5b",
    "xlstm_350m", "qwen3_moe_30b_a3b", "dbrx_132b", "whisper_tiny",
    "llama_3_2_vision_11b",
]

ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeCfg] = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}


def get_config(arch: str) -> ModelConfig:
    arch = ALIASES.get(arch, arch)
    if arch not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch!r}; options: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG


def smoke_config(arch: str) -> ModelConfig:
    arch = ALIASES.get(arch, arch)
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.SMOKE


def runnable_cells() -> List[Tuple[str, str, str]]:
    """All (arch, shape, status) cells; status 'run' or a skip reason."""
    out = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for sname, s in SHAPES.items():
            if sname == "long_500k" and not cfg.sub_quadratic:
                out.append((arch, sname,
                            "skip: full-attention arch, 512k dense KV is "
                            "quadratic (DESIGN.md §4)"))
            else:
                out.append((arch, sname, "run"))
    return out
