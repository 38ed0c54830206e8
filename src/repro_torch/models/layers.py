"""Shared transformer layers: norms, RoPE, GQA attention, MLP variants
(port of ``repro.models.layers``).

All functions are pure torch (params passed explicitly) and batched over
(B, S, D); they run where their inputs lie. KV caches are explicit
NamedTuples of tensors for the decode path.

Precision follows the reference: attention logits are accumulated in
float32 (float64 inputs in float64) and returned in float32 whatever the
inputs' dtype (the reference's ``preferred_element_type=float32``), masked
with -1e30 (not -inf), and the softmax runs in float32 before it is cast
back. The einsums are plain torch: ``scaled_dot_product_attention`` masks
and rounds otherwise.

:func:`remat_call` is the activation checkpointing of the layer loops and
the recurrent blocks' chunk loops, taken only while autograd records
(:func:`recording`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import Tensor

# the reference's mask fill (jnp.where(mask, logits, -1e30))
MASK_FILL = -1e30


def recording(*tensors) -> bool:
    """Whether autograd records a graph through any of ``tensors``: the
    condition for activation checkpointing (serving never checkpoints)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def remat_call(body, remat: bool, *args):
    """``body(*args)``, its activations recomputed in the backward pass
    when ``remat`` (the reference's ``jax.checkpoint``)."""
    if remat:
        from torch.utils.checkpoint import checkpoint
        return checkpoint(body, *args, use_reentrant=False)
    return body(*args)


def rms_norm(x: Tensor, w: Tensor, eps: float = 1e-5) -> Tensor:
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * w.to(x.dtype)


def rope_freqs(hd: int, theta: float, positions: Tensor):
    """positions: (...,) integer -> cos/sin of shape (..., hd//2)."""
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=positions.device) / hd))
    ang = positions[..., None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    """x: (B, S, H, hd); cos/sin: (B, S, hd//2) or (S, hd//2)."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    if cos.ndim == 2:
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    else:
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class KVCache(NamedTuple):
    k: Tensor   # (B, S_max, Hkv, hd)
    v: Tensor
    # ring-buffer semantics when window > 0: slot = pos % S_max


def _logits_f32(q: Tensor, k: Tensor) -> Tensor:
    """einsum("bqkgh,bskh->bkgqs") accumulated in float32, or in float64
    for float64 inputs, and returned in float32."""
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    return torch.einsum("bqkgh,bskh->bkgqs", q.to(acc), k.to(acc)).float()


def _softmax_f32(logits: Tensor, dtype: torch.dtype) -> Tensor:
    return torch.softmax(logits, dim=-1).to(dtype)


def gqa_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
                  window: int = 0, q_offset: int = 0) -> Tensor:
    """Grouped-query attention.

    q: (B, Sq, H, hd); k, v: (B, Sk, Hkv, hd). H % Hkv == 0.
    ``q_offset``: absolute position of q[0] (for causal masking in decode).
    """
    B, Sq, H, hd = q.shape
    _, Sk, Hkv, _ = k.shape
    g = H // Hkv
    qh = q.reshape(B, Sq, Hkv, g, hd)
    scale = hd ** -0.5
    logits = _logits_f32(qh, k) * scale
    dev = q.device
    qpos = torch.arange(Sq, device=dev) + q_offset
    kpos = torch.arange(Sk, device=dev)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=dev)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        mask &= kpos[None, :] > qpos[:, None] - window
    logits = torch.where(mask[None, None, None], logits, MASK_FILL)
    probs = _softmax_f32(logits, q.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    return out.reshape(B, Sq, H, hd)


def attention_block(x: Tensor, p, cfg, *, positions: Tensor, causal=True,
                    window=0, kv_x: Optional[Tensor] = None,
                    use_rope=True) -> Tensor:
    """Full attention sublayer (projections + GQA + out-proj).

    p: dict with wq (D, H*hd), wk/wv (D, Hkv*hd), wo (H*hd, D).
    kv_x: source of k/v (cross attention) — defaults to x.
    """
    B, S, D = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    src = x if kv_x is None else kv_x
    Skv = src.shape[1]
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (src @ p["wk"]).reshape(B, Skv, Hkv, hd)
    v = (src @ p["wv"]).reshape(B, Skv, Hkv, hd)
    if use_rope and kv_x is None:
        cos, sin = rope_freqs(hd, cfg.rope_theta, positions)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    out = gqa_attention(q, k, v, causal=causal and kv_x is None,
                        window=window)
    return out.reshape(B, S, H * hd) @ p["wo"]


def attention_decode(x: Tensor, p, cfg, cache: KVCache, pos: int, *,
                     window=0, kv_cached: bool = False):
    """One-token decode with KV cache update. x: (B, 1, D); ``pos`` a host
    int.

    Returns (out (B, 1, D), cache). The new token's k and v are written
    into ``cache`` in place (slot ``pos``, or ``pos % S_max`` when
    ``window`` > 0: the cache is then a ring buffer of its length). With
    ``window == 0`` a ``pos`` past the cache raises ``ValueError``; the
    reference's ``dynamic_update_slice`` clamps it and overwrites the last
    slot.
    """
    B, _, D = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p["wq"]).reshape(B, 1, H, hd)
    if kv_cached:
        # cross-attention: cache holds precomputed encoder/image k,v (no RoPE)
        out = gqa_attention(q, cache.k, cache.v, causal=False)
        return out.reshape(B, 1, H * hd) @ p["wo"], cache
    S_max = cache.k.shape[1]
    if window <= 0 and not 0 <= pos < S_max:
        raise ValueError(f"decode position {pos} is outside the KV cache of "
                         f"{S_max} slots (s_max); allocate a larger state")
    k = (x @ p["wk"]).reshape(B, 1, Hkv, hd)
    v = (x @ p["wv"]).reshape(B, 1, Hkv, hd)
    cos, sin = rope_freqs(hd, cfg.rope_theta,
                          torch.tensor([pos], device=x.device))
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    slot = pos % S_max if window > 0 else pos
    cache.k[:, slot] = k[:, 0]
    cache.v[:, slot] = v[:, 0]

    g = H // Hkv
    qh = q.reshape(B, 1, Hkv, g, hd)
    logits = _logits_f32(qh, cache.k) * hd ** -0.5
    kpos = torch.arange(S_max, device=x.device)
    if window > 0:
        # ring buffer: valid slots are the last min(pos+1, window) writes
        age = (slot - kpos) % S_max
        valid = age < min(pos + 1, S_max)
    else:
        valid = kpos <= pos
    logits = torch.where(valid[None, None, None, None, :], logits, MASK_FILL)
    probs = _softmax_f32(logits, x.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs,
                       cache.v).reshape(B, 1, H * hd)
    return out @ p["wo"], cache


def mlp_block(x: Tensor, p, act: str) -> Tensor:
    """Dense FFN. swiglu: w1,w3,w2; gelu/sq_relu: w1,w2."""
    if act == "swiglu":
        h = F.silu(x @ p["w1"]) * (x @ p["w3"])
    elif act == "gelu":
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(x @ p["w1"], approximate="tanh")
    elif act == "sq_relu":
        h = torch.square(F.relu(x @ p["w1"]))
    else:
        raise ValueError(act)
    return h @ p["w2"]
