"""Train and serve step factories for the LM scaffold (port of
``repro.launch.steps``).

``make_train_step(cfg, opt_cfg, microbatch)`` gives
``train_step(state, batch)`` -> (new TrainState, loss, gradient norm): the
loss's gradients in every parameter leaf (:func:`value_and_grad`), then
AdamW (``optim/adamw.py``). ``make_prefill(cfg)`` gives ``prefill(params,
batch)`` -> the last position's logits (B, V); ``make_serve_step(cfg)``
gives ``serve_step(params, tok, state)`` -> (logits (B, V), state), one
token for every sequence. The serving steps run under
``torch.inference_mode()``; the train step records autograd, so
``cfg.remat`` checkpoints its layers and the recurrent chunks. Everything
runs on the device of ``params``. The shape-spec functions are a later
slice (A9.3).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch
from torch import Tensor

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.tree import leaves, tree_map


class TrainState(NamedTuple):
    params: Any
    opt: adamw.AdamWState


def init_train_state(cfg: ModelConfig, *, seed: int = 0, device=None
                     ) -> TrainState:
    """``lm.init`` parameters from ``seed`` and a zero AdamW state, on
    ``device`` (None = the card; it raises without one)."""
    params = lm.init(cfg, seed=seed, device=device)
    return TrainState(params=params, opt=adamw.init(params))


def _value_and_grad(params, batch: Dict[str, Tensor], cfg: ModelConfig):
    with torch.enable_grad():
        live = tree_map(lambda t: t.detach().requires_grad_(True),
                              params)
        loss = lm.train_loss(live, batch, cfg)
        grads = iter(torch.autograd.grad(loss, leaves(live),
                                         allow_unused=True))

    def grad_of(t):         # the leaves in the order autograd got them
        g = next(grads)
        return torch.zeros_like(t) if g is None else g
    return loss.detach(), tree_map(grad_of, params)


def value_and_grad(params, batch: Dict[str, Tensor], cfg: ModelConfig,
                   microbatch: int = 1) -> Tuple[Tensor, Dict[str, Any]]:
    """(loss, gradient tree) of ``lm.train_loss`` at ``params``: the
    gradient of every leaf, zeros for a leaf the loss does not reach
    (vlm's cross blocks without ``img_embed``), as ``jax.grad`` gives.
    With ``microbatch`` > 1 the batch is split on its leading axis and the
    microbatches run in sequence, their losses and gradients accumulated
    in float32 and divided by ``microbatch`` (the reference's
    ``lax.scan``): activation memory divided by the count, float32
    gradients. Otherwise each gradient has its leaf's dtype."""
    if microbatch == 1:
        return _value_and_grad(params, batch, cfg)
    B = next(iter(batch.values())).shape[0]
    if B % microbatch:
        raise ValueError(f"batch {B} does not split into {microbatch} "
                         f"microbatches")
    parts = {k: v.reshape(microbatch, B // microbatch, *v.shape[1:])
             for k, v in batch.items()}
    first = leaves(params)[0]
    loss_sum = torch.zeros((), dtype=torch.float32, device=first.device)
    gsum = tree_map(lambda p: torch.zeros(
        p.shape, dtype=torch.float32, device=p.device), params)
    for i in range(microbatch):
        loss, g = _value_and_grad(params, {k: v[i] for k, v in parts.items()},
                                  cfg)
        gsum = tree_map(lambda a, b: a + b.to(torch.float32), gsum, g)
        loss_sum = loss_sum + loss
    return (loss_sum / microbatch,
            tree_map(lambda g: g / microbatch, gsum))


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    microbatch: int = 1):
    """Training step: :func:`value_and_grad` (``microbatch`` > 1
    accumulates the microbatches' gradients, the standard fit-the-memory
    lever), then ``adamw.update``: (new state, loss, the gradients' global
    norm before clipping, a 0-dim float32 tensor). The reference's step
    returns the first two; the norm is the one that ``update`` clips by.
    The step is out of place: the state it was given stays usable, so a
    retried step (``runtime/fault.py::retry_step``) starts from it
    again."""

    def train_step(state: TrainState, batch
                   ) -> Tuple[TrainState, Tensor, Tensor]:
        loss, grads = value_and_grad(state.params, batch, cfg, microbatch)
        norm = adamw.global_norm(grads)
        params, opt = adamw.update(grads, state.opt, state.params, opt_cfg,
                                   norm)
        return TrainState(params, opt), loss, norm
    return train_step


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
