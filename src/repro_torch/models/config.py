"""Architecture configuration schema for the LM scaffold (port of
``repro.models.config``).

One ``ModelConfig`` describes any of the six families:
  dense   — standard decoder-only transformer (GQA + RoPE)
  moe     — dense attention + top-k routed expert FFN
  ssm     — recurrent blocks only (xLSTM: mLSTM/sLSTM mix)
  hybrid  — parallel attention + SSM heads in each layer (Hymba)
  encdec  — encoder-decoder backbone (Whisper; stub audio frontend)
  vlm     — decoder with interleaved cross-attention layers (Llama-vision;
            stub vision tower)

The fields and defaults are the reference's; ``adtype`` and ``pdtype`` are
torch dtypes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    mlp_act: str = "swiglu"                 # swiglu | gelu | sq_relu
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # --- SSM / xLSTM / hybrid ---
    ssm_state: int = 0            # N (mamba state size / per-head kv rank)
    ssm_expand: int = 2           # mamba inner expansion
    ssm_chunk: int = 128          # chunkwise-parallel scan chunk length
    window: int = 0               # sliding-window size (0 = full attention)

    # --- enc-dec (whisper) ---
    n_enc_layers: int = 0
    n_frames: int = 1500          # stub audio frontend output length

    # --- vlm ---
    cross_every: int = 0          # insert a cross-attn layer every k layers
    n_image_tokens: int = 0       # stub vision tower output length

    # --- numerics / training ---
    dtype: str = "bfloat16"       # activation/compute dtype
    param_dtype: str = "float32"
    remat: bool = True            # training only; serving ignores it
    tie_embeddings: bool = False
    chunk_unroll: bool = False    # the reference's XLA unroll flags; the
    scan_unroll: bool = False     # port's loops are eager, so no effect

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def adtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run long_500k? (SSM-only or windowed-hybrid.)"""
        return self.family == "ssm" or (self.family == "hybrid"
                                        and self.window > 0)

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have an autoregressive decoder

    def scaled(self, **kw) -> "ModelConfig":
        """Reduced-config variant for CPU smoke tests."""
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for roofline
        MODEL_FLOPS = 6*N*D."""
        D, F, V = self.d_model, self.d_ff, self.vocab
        hd, H, Hkv = self.hd, self.n_heads, self.n_kv_heads
        attn = D * H * hd + 2 * D * Hkv * hd + H * hd * D
        if self.family == "moe":
            ff = self.n_experts * (3 * D * F) + D * self.n_experts
        elif self.mlp_act == "swiglu":
            ff = 3 * D * F
        elif self.family == "ssm":
            ff = 0
        else:
            ff = 2 * D * F
        if self.family == "ssm":
            # mLSTM: q,k,v,o projections + i/f/o gates
            per_layer = 4 * D * D + 3 * D * H
        elif self.family == "hybrid":
            Di = self.ssm_expand * D
            ssm = D * 2 * Di + Di * (2 * self.ssm_state + Di // 16 + 1) \
                + Di * D
            per_layer = attn + ff + ssm
        else:
            per_layer = attn + ff
        n_cross = (self.n_layers // self.cross_every
                   if self.cross_every else 0)
        cross = n_cross * (2 * D * H * hd + 2 * D * Hkv * hd)
        enc = self.n_enc_layers * (attn + ff)
        emb = V * D * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + cross + enc + emb

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if self.family != "moe":
            return self.param_count()
        D, F = self.d_model, self.d_ff
        full = self.param_count()
        ff_all = self.n_layers * self.n_experts * 3 * D * F
        ff_act = self.n_layers * self.top_k * 3 * D * F
        return full - ff_all + ff_act
