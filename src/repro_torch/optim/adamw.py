"""AdamW + global-norm clipping + cosine schedule (port of
``repro.optim.adamw``).

The reference's formula, not ``torch.optim.AdamW`` (which adds ``eps``
after dividing by sqrt(bc2) and decays p by (1 - lr wd) before the step, a
different rounding): clip the gradients by their float32 global norm, then
at step t = step + 1, with lr = ``schedule(t)``,
``delta = mhat / (sqrt(vhat) + eps) + wd * p`` and ``p - lr * delta``.
Every quantity is float32 whatever a leaf's dtype, and each result is cast
back to its leaf's dtype (a float64 leaf is updated in float32, as in the
reference).

Trees are nested dicts of tensors, walked by ``repro_torch.tree`` in
sorted-key order, as ``jax.tree`` flattens the reference's dicts. The step, the schedule and
the bias corrections are 0-dim tensors on the parameters' device, so an
update makes no host sync. ``update`` is out of place: the state it was
given stays usable (a retried step starts from it again). The field names
of :class:`AdamWState` are the reference's, so a state saved by one
package's ``ckpt`` restores through the other's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional, Tuple

import torch
from torch import Tensor

from repro_torch.tree import leaves, tree_map


class AdamWState(NamedTuple):
    step: Tensor     # 0-dim int32
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def init(params) -> AdamWState:
    first = leaves(params)[0]
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        m=tree_map(torch.zeros_like, params),
        v=tree_map(torch.zeros_like, params))


def schedule(cfg: AdamWConfig, step: Tensor) -> Tensor:
    """Linear warmup to ``lr``, then a cosine decay to ``min_lr_frac`` x
    ``lr`` at ``total_steps`` (a 0-dim float32 tensor on ``step``'s
    device)."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def global_norm(tree) -> Tensor:
    """sqrt of the float32 sum of squares, summed leaf by leaf in the
    reference's leaf order."""
    total = 0
    for g in leaves(tree):
        total = total + torch.sum(torch.square(g.to(torch.float32)))
    return torch.sqrt(total)


def update(grads, state: AdamWState, params, cfg: AdamWConfig,
           norm: Optional[Tensor] = None) -> Tuple[Any, AdamWState]:
    """(new params, new state); ``params`` and ``state`` are left as they
    were. ``norm`` is ``global_norm(grads)`` when the caller has it
    already."""
    gn = global_norm(grads) if norm is None else norm
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-12), max=1.0)
    grads = tree_map(lambda g: g * scale.to(g.dtype), grads)

    step = state.step + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    step_f = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, step_f)
    bc2 = 1 - torch.pow(b2, step_f)

    def upd(p, g, m, v):
        f32 = torch.float32
        g32 = g.to(f32)
        m2 = b1 * m.to(f32) + (1 - b1) * g32
        v2 = b2 * v.to(f32) + (1 - b2) * torch.square(g32)
        mhat = m2 / bc1
        vhat = v2 / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) \
            + cfg.weight_decay * p.to(f32)
        p2 = p.to(f32) - lr * delta
        return p2.to(p.dtype), m2.to(m.dtype), v2.to(v.dtype)

    out = tree_map(upd, params, grads, state.m, state.v)

    def pick(i):
        return tree_map(lambda t: t[i], out)
    return pick(0), AdamWState(step=step, m=pick(1), v=pick(2))
