"""Top-k routed mixture-of-experts FFN (token-choice, sort-based dispatch;
port of ``repro.models.moe``).

  1. router logits -> top_k (expert_id, prob) per token
  2. flatten the T*k assignments; each assignment's rank within its expert
     from a stable argsort of the expert ids and ``searchsorted``
  3. scatter token rows into an (E, C, D) buffer (assignments past
     capacity C are DROPPED — standard token-dropping MoE;
     C = T*k/E * capacity_factor)
  4. batched expert matmul (E, C, D) x (E, D, F)
  5. weighted combine back to (T, D)

Order and determinism: ``torch.topk`` promises no order among ties on the
card, so the top k are the first k of a stable descending sort (ties go to
the lower expert id, as ``jax.lax.top_k`` orders them). The dispatch writes
each kept slot once. The combine sums each token's k contributions as a
(T, k, D) reduction (they are contiguous), never with atomics, so a run is
bit for bit the next.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import Tensor


def moe_ffn(x: Tensor, p, cfg):
    """x: (B, S, D). p: router (D, E), w1/w3 (E, D, F), w2 (E, F, D).
    Returns (out (B, S, D), aux) with the Switch-style load-balance loss
    ``aux`` a 0-dim float32 tensor."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    dev = x.device
    xt = x.reshape(T, D)

    logits = (xt @ p["router"]).float()                      # (T, E)
    topv, topi = torch.sort(logits, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :k], topi[:, :k]                    # (T, k)
    probs = torch.softmax(topv, dim=-1).to(x.dtype)          # renormalized

    # ---- assignment ranks within each expert (T*k,) -----------------------
    flat_e = topi.reshape(-1)                                # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(sorted_e, torch.arange(E, device=dev))
    rank_sorted = torch.arange(T * k, device=dev) - starts[sorted_e]
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted

    C = max(int(T * k / E * cfg.capacity_factor), 1)
    C = -(-C // 256) * 256 if C > 256 else C   # pad: data-shardable dim
    keep = rank < C
    slot = torch.where(keep, flat_e * C + rank, E * C)      # E*C => dropped

    # ---- dispatch: (E*C, D) buffer; each kept slot is written once (the
    # dropped assignments all land on row E*C, which is cut off) ----------
    tok_of_assign = torch.arange(T, device=dev).repeat_interleave(k)
    buf = torch.zeros((E * C + 1, D), dtype=x.dtype, device=dev)
    buf.index_copy_(0, slot, xt[tok_of_assign])
    buf = buf[:-1].reshape(E, C, D)

    # ---- expert computation (batched over E) ------------------------------
    if cfg.mlp_act == "swiglu":
        h = F.silu(torch.einsum("ecd,edf->ecf", buf, p["w1"])) \
            * torch.einsum("ecd,edf->ecf", buf, p["w3"])
    else:
        h = F.gelu(torch.einsum("ecd,edf->ecf", buf, p["w1"]),
                   approximate="tanh")
    out_buf = torch.einsum("ecf,efd->ecd", h, p["w2"]).reshape(E * C, D)

    # ---- combine: each token's k contributions, summed in order -----------
    gathered = torch.where(keep[:, None],
                           out_buf[torch.clamp(slot, 0, E * C - 1)], 0.0)
    w = probs.reshape(-1)[:, None].to(x.dtype)
    out = (gathered * w).reshape(T, k, D).sum(dim=1)

    # auxiliary load-balance loss (Switch-style)
    me = torch.mean(torch.softmax(logits, dim=-1), dim=0)            # (E,)
    ce = torch.mean(F.one_hot(topi[:, 0], E).float(), dim=0)
    aux = E * torch.sum(me * ce)
    return out.reshape(B, S, D), aux
