"""Serving step factories for the LM scaffold (port of the serving half of
``repro.launch.steps``).

``make_prefill(cfg)`` gives ``prefill(params, batch)`` -> the last
position's logits (B, V); ``make_serve_step(cfg)`` gives
``serve_step(params, tok, state)`` -> (logits (B, V), state), one token
for every sequence. Both run under ``torch.inference_mode()`` on the
device of ``params``. ``cfg.remat`` changes no value and is not read here.
The training step and the shape-spec builders are a later slice.
"""
from __future__ import annotations

import torch

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig


def make_serve_step(cfg: ModelConfig):
    @torch.inference_mode()
    def serve_step(params, tok, state: lm.DecodeState):
        return lm.decode_step(params, tok, state, cfg)
    return serve_step


def make_prefill(cfg: ModelConfig):
    @torch.inference_mode()
    def prefill(params, batch):
        hidden, _ = lm.backbone(params, batch["tokens"], cfg,
                                img_embed=batch.get("img_embed"),
                                frames=batch.get("frames"))
        return lm.logits_fn(params, hidden[:, -1:], cfg)[:, -1]
    return prefill
