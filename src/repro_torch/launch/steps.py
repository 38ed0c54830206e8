"""Train and serve step factories for the LM scaffold (port of
``repro.launch.steps``).

``make_train_step(cfg, opt_cfg, microbatch, dp)`` gives
``train_step(state, batch)`` -> (new TrainState, loss, gradient norm): the
loss's gradients in every parameter leaf (:func:`value_and_grad`), then
AdamW (``optim/adamw.py``), on one rank or over the ranks of ``dp``. ``make_prefill(cfg)`` gives ``prefill(params,
batch)`` -> the last position's logits (B, V); ``make_serve_step(cfg)``
gives ``serve_step(params, tok, state)`` -> (logits (B, V), state), one
token for every sequence. The serving steps run under
``torch.inference_mode()``; the train step records autograd, so
``cfg.remat`` checkpoints its layers and the recurrent chunks. Everything
runs on the device of ``params``.

The shape-spec builders (``batch_specs``, ``param_specs``, ``opt_specs``,
``decode_state_specs``, ``serve_input_specs``, ``input_specs``) give
tensors on the ``meta`` device, the port's counterpart of the reference's
``ShapeDtypeStruct``s: every shape and dtype, no allocation. The dry-run
(``launch/dryrun.py``) places them with ``launch/shardings.py``.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch
from torch import Tensor

from repro_torch.configs import ShapeCfg
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
                    microbatch: int = 1, dp=None):
    """Training step: :func:`value_and_grad` (``microbatch`` > 1
    accumulates the microbatches' gradients, the standard fit-the-memory
    lever), then ``adamw.update``: (new state, loss, the gradients' global
    norm before clipping, a 0-dim float32 tensor). The reference's step
    returns the first two; the norm is the one that ``update`` clips by.
    The step is out of place: the state it was given stays usable, so a
    retried step (``runtime/fault.py::retry_step``) starts from it
    again.

    ``dp`` (a ``launch/train.py::DataParallel``) runs the step over its
    ranks: this rank's rows of the global batch, the loss and gradients
    averaged over the ranks, the norm of those, AdamW on this rank's
    slices of the parameters and moments (ZeRO-1), the parameters
    gathered. The state then holds this rank's moment slices."""

    def train_step(state: TrainState, batch
                   ) -> Tuple[TrainState, Tensor, Tensor]:
        params = state.params
        if dp is not None:
            batch = dp.rows(batch)
        loss, grads = value_and_grad(params, batch, cfg, microbatch)
        if dp is not None:
            loss, grads = dp.mean(loss, grads)
        norm = adamw.global_norm(grads)
        if dp is not None:
            grads, params = dp.shard(grads), dp.shard(params)
        params, opt = adamw.update(grads, state.opt, params, opt_cfg, norm)
        if dp is not None:
            params = dp.gather(params)
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


# ---------------------------------------------------------------------------
# shape-spec builders (meta tensors: no allocation)
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeCfg) -> Dict[str, Tensor]:
    B, S = shape.global_batch, shape.seq_len
    batch = {"tokens": _meta((B, S), torch.int32)}
    if shape.kind == "train":
        batch["labels"] = _meta((B, S), torch.int32)
    if cfg.family == "vlm":
        batch["img_embed"] = _meta((B, cfg.n_image_tokens, cfg.d_model),
                                   cfg.adtype)
    if cfg.family == "encdec":
        batch["frames"] = _meta((B, cfg.n_frames, cfg.d_model), cfg.adtype)
    return batch


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    return tree_map(lambda s: _meta(s, cfg.pdtype), lm.param_shapes(cfg))


def opt_specs(cfg: ModelConfig) -> adamw.AdamWState:
    p = param_specs(cfg)
    return adamw.AdamWState(step=_meta((), torch.int32),
                            m=tree_map(torch.empty_like, p),
                            v=tree_map(torch.empty_like, p))


def decode_state_specs(cfg: ModelConfig, shape: ShapeCfg) -> lm.DecodeState:
    """The port's cache allocator run on meta parameters: the caches'
    shapes and dtypes, no allocation."""
    return lm.init_decode_state(param_specs(cfg), cfg, shape.global_batch,
                                shape.seq_len)


def serve_input_specs(cfg: ModelConfig, shape: ShapeCfg):
    tok = _meta((shape.global_batch,), torch.int32)
    return tok, decode_state_specs(cfg, shape)


def input_specs(cfg: ModelConfig, shape: ShapeCfg):
    """The full argument-spec bundle for the cell's entry point."""
    if shape.kind == "train":
        return {"state": TrainState(params=param_specs(cfg),
                                    opt=opt_specs(cfg)),
                "batch": batch_specs(cfg, shape)}
    if shape.kind == "prefill":
        return {"params": param_specs(cfg),
                "batch": batch_specs(cfg, shape)}
    tok, dstate = serve_input_specs(cfg, shape)
    return {"params": param_specs(cfg), "tok": tok, "state": dstate}
