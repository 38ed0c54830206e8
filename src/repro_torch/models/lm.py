"""Unified causal LM over the six architecture families (port of
``repro.models.lm``).

Parameters are the reference's tree: a dict of tensors with the per-layer
weights stacked on a leading layer axis (``blocks``, ``blocks_m``,
``blocks_s``, ``cross_blocks``, ``enc_blocks``), so a tree saved or
converted from the reference maps leaf for leaf. The reference scans over
that axis; here an eager loop runs over the layers of one ``unbind(0)``,
casting each layer's master weights to the compute dtype on every call as
the reference's ``_cast_params`` does, and, with ``cfg.remat`` while
autograd records, checkpoints each layer as the reference's
``jax.checkpoint`` does. :class:`CausalLM` holds the same tree in nested
``nn.ParameterDict``s.

Entry points:
  init(cfg, generator=, seed=, device=)      -> params
  backbone(params, tokens, cfg)               -> (hidden, aux)
  logits_fn(params, hidden, cfg)              -> logits
  train_loss(params, batch, cfg)              -> scalar loss (differentiable)
  init_decode_state(params, cfg, B, s_max)    -> DecodeState
  fill_cross_cache(params, cfg, state, ...)   -> DecodeState (vlm / encdec)
  decode_step(params, tok, state, cfg)        -> (logits, DecodeState)

Serving differs from the reference in two ways that change no value:
``DecodeState.pos`` is a host int (the cache slot is a slice index, with no
device sync), and :func:`decode_step` writes the new token's KV entries
and recurrent states into the state's stacked tensors in place and returns
the same tensors with ``pos + 1``. Past ``s_max`` with no window it raises
where the reference overwrites its last slot.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (KVCache, attention_block,
                                       attention_decode, mlp_block, recording,
                                       remat_call, rms_norm)
from repro_torch.models.moe import moe_ffn
from repro_torch.tree import leaf_paths

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _dense_block_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    D, F_ = cfg.d_model, cfg.d_ff
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s = {"ln1": (D,), "ln2": (D,),
         "wq": (D, H * hd), "wk": (D, Hkv * hd), "wv": (D, Hkv * hd),
         "wo": (H * hd, D)}
    if cfg.family == "moe":
        E, Fe = cfg.n_experts, cfg.d_ff
        s |= {"router": (D, E), "w1": (E, D, Fe), "w3": (E, D, Fe),
              "w2": (E, Fe, D)}
    elif F_ > 0:
        if cfg.mlp_act == "swiglu":
            s |= {"w1": (D, F_), "w3": (D, F_), "w2": (F_, D)}
        else:
            s |= {"w1": (D, F_), "w2": (F_, D)}
    if cfg.family == "hybrid":
        Di = cfg.ssm_expand * D
        N = cfg.ssm_state
        dt_rank = max(D // 16, 1)
        s |= {"in_proj": (D, 2 * Di), "conv": (4, Di),
              "x_proj": (Di, dt_rank + 2 * N), "dt_proj": (dt_rank, Di),
              "A_log": (Di, N), "Dskip": (Di,), "out_proj": (Di, D)}
    return s


def _cross_block_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    D = cfg.d_model
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {"ln": (D,), "wq": (D, H * hd), "wk": (D, Hkv * hd),
            "wv": (D, Hkv * hd), "wo": (H * hd, D)}


def _mlstm_block_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    D, H, hd = cfg.d_model, cfg.n_heads, cfg.hd
    return {"ln": (D,), "wq": (D, H * hd), "wk": (D, H * hd),
            "wv": (D, H * hd), "wi": (D, H), "wf": (D, H),
            "wo_gate": (D, H * hd), "out": (H * hd, D)}


def _slstm_block_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    D = cfg.d_model
    return {"ln": (D,), "wz": (D, D), "wi": (D, D), "wf": (D, D),
            "wo": (D, D), "out": (D, D)}


def n_slstm_layers(cfg: ModelConfig) -> int:
    return cfg.n_layers // 4 if cfg.family == "ssm" else 0


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """Full parameter shape tree (the reference's, key for key)."""
    D, V = cfg.d_model, cfg.vocab
    L = cfg.n_layers
    tree: Dict[str, Any] = {
        "embed": (V, D),
        "final_ln": (D,),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = (D, V)
    if cfg.family == "ssm":
        Ls = n_slstm_layers(cfg)
        Lm = L - Ls
        tree["blocks_m"] = {k: (Lm, *v)
                            for k, v in _mlstm_block_shapes(cfg).items()}
        if Ls:
            tree["blocks_s"] = {k: (Ls, *v)
                                for k, v in _slstm_block_shapes(cfg).items()}
    else:
        tree["blocks"] = {k: (L, *v)
                          for k, v in _dense_block_shapes(cfg).items()}
    if cfg.family == "vlm" and cfg.cross_every:
        G = L // cfg.cross_every
        tree["cross_blocks"] = {k: (G, *v)
                                for k, v in _cross_block_shapes(cfg).items()}
        tree["img_proj"] = (D, D)   # stub vision tower output -> d_model
    if cfg.family == "encdec":
        Le = cfg.n_enc_layers
        tree["enc_blocks"] = {k: (Le, *v)
                              for k, v in _dense_block_shapes(cfg).items()}
        tree["enc_ln"] = (D,)
        tree["cross_blocks"] = {k: (L, *v)
                                for k, v in _cross_block_shapes(cfg).items()}
    return tree


def fixed_value(name: str) -> Optional[float]:
    """The reference's post-draw fix by leaf name: norms start at 1, A_log
    at 0 (A = -1), Dskip at 1; None for a leaf left as drawn."""
    if name.startswith("ln") or name in ("final_ln", "enc_ln", "Dskip"):
        return 1.0
    if name == "A_log":
        return 0.0
    return None


def init(cfg: ModelConfig, *, generator: Optional[torch.Generator] = None,
         seed: int = 0, device=None) -> Params:
    """Random parameters by the reference's rules (``jax.random`` itself
    cannot be reproduced): a leaf with >= 2 dims is N(0, 1) *
    shp[-2] ** -0.5, a 1-D leaf ones; then ``ln*``, ``final_ln`` and
    ``enc_ln`` are ones, ``A_log`` zeros and ``Dskip`` ones. Leaves are
    drawn in sorted-path order from ``generator`` (default: a generator on
    ``device`` seeded with ``seed``). ``device=None`` means the card."""
    from repro_torch.core.saif import resolve_device
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
    params: Params = {}
    for path, shp in leaf_paths(param_shapes(cfg)):
        if len(shp) >= 2:
            w = torch.randn(shp, generator=generator, dtype=cfg.pdtype,
                            device=dev) * shp[-2] ** -0.5
        else:
            w = torch.ones(shp, dtype=cfg.pdtype, device=dev)
        fixed = fixed_value(path[-1])
        if fixed is not None:
            w.fill_(fixed)
        node = params
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = w
    return params


# ---------------------------------------------------------------------------
# forward (training / prefill)
# ---------------------------------------------------------------------------

def _n_layers(blocks: Dict[str, Tensor]) -> int:
    return next(iter(blocks.values())).shape[0]


def _layers(blocks: Dict[str, Tensor]) -> list:
    """Every layer of a stacked block tree, as dicts of views taken by one
    ``unbind(0)`` a leaf: its backward writes a leaf's stacked gradient
    once, where indexing layer by layer writes a zero tensor the size of
    the whole leaf for every layer."""
    views = {k: v.unbind(0) for k, v in blocks.items()}
    return [{k: vs[i] for k, vs in views.items()}
            for i in range(_n_layers(blocks))]


def _cast(bp: Dict[str, Tensor], cfg: ModelConfig) -> Dict[str, Tensor]:
    """A layer's master weights in the compute dtype (the reference's
    ``_cast_params``)."""
    return {k: v.to(cfg.adtype) for k, v in bp.items()}


def _dense_layer(x, bp, cfg, positions, window):
    bp = _cast(bp, cfg)
    h = rms_norm(x, bp["ln1"], cfg.norm_eps)
    attn = attention_block(h, bp, cfg, positions=positions, causal=True,
                           window=window)
    if cfg.family == "hybrid":
        attn = 0.5 * (attn + ssm_lib.mamba_block(h, bp, cfg))
    x = x + attn
    h2 = rms_norm(x, bp["ln2"], cfg.norm_eps)
    if cfg.family == "moe":
        ff, aux = moe_ffn(h2, bp, cfg)
    elif cfg.d_ff > 0:
        ff, aux = mlp_block(h2, bp, cfg.mlp_act), None
    else:
        ff, aux = 0.0, None
    return x + ff, aux


def _cross_layer(x, cp, src, cfg, positions):
    cp = _cast(cp, cfg)
    h = rms_norm(x, cp["ln"], cfg.norm_eps)
    return x + attention_block(h, cp, cfg, positions=positions,
                               causal=False, kv_x=src, use_rope=False)


def _encoder_layer(enc, bp, cfg, enc_pos):
    bp = _cast(bp, cfg)
    h = rms_norm(enc, bp["ln1"], cfg.norm_eps)
    enc = enc + attention_block(h, bp, cfg, positions=enc_pos, causal=False)
    h2 = rms_norm(enc, bp["ln2"], cfg.norm_eps)
    return enc + mlp_block(h2, bp, cfg.mlp_act)


def _recurrent_layer(x, bp, block, cfg):
    bp = _cast(bp, cfg)
    h = rms_norm(x, bp["ln"], cfg.norm_eps)
    return x + block(h, bp, cfg)


def _encode(params: Params, frames: Tensor, cfg: ModelConfig,
            remat: bool = False) -> Tensor:
    """The encoder over stub frame embeddings (bidirectional, RoPE)."""
    enc = frames.to(cfg.adtype)
    enc_pos = torch.arange(enc.shape[1], device=enc.device)[None, :]
    for bp in _layers(params["enc_blocks"]):
        enc = remat_call(_encoder_layer, remat, enc, bp, cfg, enc_pos)
    return rms_norm(enc, params["enc_ln"], cfg.norm_eps)


def backbone(params: Params, tokens: Tensor, cfg: ModelConfig, *,
             img_embed: Optional[Tensor] = None,
             frames: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Token ids (B, S) -> final hidden states (B, S, D) + aux loss (a
    0-dim float32 tensor: the MoE layers' summed load-balance loss, else
    0). vlm runs its cross-attention layers only when ``img_embed`` is
    given; encdec needs ``frames``. With ``cfg.remat``, while autograd
    records, every layer is checkpointed (``torch.utils.checkpoint``, the
    reference's ``jax.checkpoint`` of a layer body); the values are the
    same either way."""
    B, S = tokens.shape
    remat = cfg.remat and recording(*(t for _, t in leaf_paths(params)))
    x = params["embed"][tokens].to(cfg.adtype)
    positions = torch.arange(S, device=x.device)[None, :]
    window = cfg.window
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    cross_src = None
    if cfg.family == "vlm" and cfg.cross_every and img_embed is not None:
        cross_src = (img_embed.to(cfg.adtype)
                     @ params["img_proj"].to(cfg.adtype))
        every = cfg.cross_every
    elif cfg.family == "encdec":
        cross_src, every = _encode(params, frames, cfg, remat), 1

    if cfg.family == "ssm":
        for name, block in (("blocks_m", ssm_lib.mlstm_block),
                            ("blocks_s", ssm_lib.slstm_block)):
            if name not in params:
                continue
            for bp in _layers(params[name]):
                x = remat_call(_recurrent_layer, remat, x, bp, block, cfg)
    elif cross_src is not None:
        # a cross-attention layer after every ``every`` decoder layers
        cross = _layers(params["cross_blocks"])
        for i, bp in enumerate(_layers(params["blocks"])):
            x, _ = remat_call(_dense_layer, remat, x, bp, cfg, positions,
                              window)
            if (i + 1) % every == 0:
                x = remat_call(_cross_layer, remat, x, cross[i // every],
                               cross_src, cfg, positions)
    else:
        for bp in _layers(params["blocks"]):
            x, a = remat_call(_dense_layer, remat, x, bp, cfg, positions,
                              window)
            if a is not None:
                aux = aux + a

    return rms_norm(x, params["final_ln"], cfg.norm_eps), aux


def logits_fn(params: Params, hidden: Tensor, cfg: ModelConfig) -> Tensor:
    head = (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"]).to(cfg.adtype)
    return hidden @ head


def train_loss(params: Params, batch: Dict[str, Tensor],
               cfg: ModelConfig) -> Tensor:
    """Next-token cross-entropy (+ MoE aux), a 0-dim float32 tensor.
    batch: tokens, labels (B, S) (and img_embed / frames). Differentiable
    in every leaf of ``params`` (``launch/steps.py`` takes its
    gradients)."""
    hidden, aux = backbone(params, batch["tokens"], cfg,
                           img_embed=batch.get("img_embed"),
                           frames=batch.get("frames"))
    logits = logits_fn(params, hidden, cfg).float()
    logp = F.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, batch["labels"][..., None].long())[..., 0]
    return -torch.mean(ll) + 0.01 * aux


# ---------------------------------------------------------------------------
# serving: caches and single-token decode
# ---------------------------------------------------------------------------

class DecodeState(NamedTuple):
    caches: Any        # per-family cache tree (stacked over layers)
    pos: int           # current position (host int)


def init_decode_state(params: Params, cfg: ModelConfig, batch: int,
                      s_max: int, *, img_embed=None, frames=None
                      ) -> DecodeState:
    """Allocate empty caches sized for ``s_max`` context, on the device of
    ``params``."""
    Hkv, hd = cfg.n_kv_heads, cfg.hd
    L = cfg.n_layers
    cache_len = min(cfg.window, s_max) if cfg.window else s_max
    dt = cfg.adtype
    dev = params["embed"].device

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def kv(leading, length):
        return KVCache(zeros(leading, batch, length, Hkv, hd),
                       zeros(leading, batch, length, Hkv, hd))

    if cfg.family == "ssm":
        Lm = L - n_slstm_layers(cfg)
        caches = {"m": ssm_lib.MLSTMState(
            C=zeros(Lm, batch, cfg.n_heads, hd, hd),
            n=zeros(Lm, batch, cfg.n_heads, hd))}
        if n_slstm_layers(cfg):
            Ls = n_slstm_layers(cfg)
            caches["s"] = ssm_lib.SLSTMState(
                c=zeros(Ls, batch, cfg.d_model, dtype=torch.float32),
                n=zeros(Ls, batch, cfg.d_model, dtype=torch.float32))
    elif cfg.family == "hybrid":
        Di = cfg.ssm_expand * cfg.d_model
        caches = {"kv": kv(L, cache_len),
                  "ssm": ssm_lib.MambaState(
                      h=zeros(L, batch, Di, cfg.ssm_state),
                      conv=zeros(L, batch, Di, 3))}
    elif cfg.family in ("vlm", "encdec"):
        n_cross = (cfg.n_layers // cfg.cross_every if cfg.family == "vlm"
                   else cfg.n_layers)
        src_len = (cfg.n_image_tokens if cfg.family == "vlm"
                   else cfg.n_frames)
        caches = {"kv": kv(L, cache_len), "cross": kv(n_cross, src_len)}
    else:
        caches = {"kv": kv(L, cache_len)}
    return DecodeState(caches=caches, pos=0)


def _kv_at(cache: KVCache, i: int) -> KVCache:
    return KVCache(cache.k[i], cache.v[i])


def _put(stacked, i: int, new) -> None:
    """Write layer ``i`` of a recurrent state into its stacked tensors."""
    for dst, src in zip(stacked, new):
        dst[i] = src


def decode_step(params: Params, tok: Tensor, state: DecodeState,
                cfg: ModelConfig) -> Tuple[Tensor, DecodeState]:
    """One new token for every sequence. tok: (B,) integer. The caches of
    ``state`` are updated in place; the returned state holds them with
    ``pos + 1``."""
    x = params["embed"][tok][:, None].to(cfg.adtype)          # (B, 1, D)
    pos = state.pos
    caches = state.caches
    eps = cfg.norm_eps

    if cfg.family == "ssm":
        for name, key, step in (("blocks_m", "m", ssm_lib.mlstm_decode),
                                ("blocks_s", "s", ssm_lib.slstm_decode)):
            if name not in params:
                continue
            for i, bp in enumerate(_layers(params[name])):
                bp = _cast(bp, cfg)
                h = rms_norm(x, bp["ln"], eps)
                c = type(caches[key])(*(t[i] for t in caches[key]))
                y, c2 = step(h, bp, cfg, c)
                _put(caches[key], i, c2)
                x = x + y
    elif cfg.family == "hybrid":
        for i, bp in enumerate(_layers(params["blocks"])):
            bp = _cast(bp, cfg)
            h = rms_norm(x, bp["ln1"], eps)
            a, _ = attention_decode(h, bp, cfg, _kv_at(caches["kv"], i), pos,
                                    window=cfg.window)
            sc = ssm_lib.MambaState(caches["ssm"].h[i], caches["ssm"].conv[i])
            m, sc2 = ssm_lib.mamba_decode(h, bp, cfg, sc)
            _put(caches["ssm"], i, sc2)
            x = x + 0.5 * (a + m)
            h2 = rms_norm(x, bp["ln2"], eps)
            x = x + mlp_block(h2, bp, cfg.mlp_act)
    elif cfg.family in ("vlm", "encdec"):
        every = cfg.cross_every if cfg.family == "vlm" else 1
        cross = _layers(params["cross_blocks"])
        for i, bp in enumerate(_layers(params["blocks"])):
            bp = _cast(bp, cfg)
            h = rms_norm(x, bp["ln1"], eps)
            a, _ = attention_decode(h, bp, cfg, _kv_at(caches["kv"], i), pos)
            x = x + a
            h2 = rms_norm(x, bp["ln2"], eps)
            x = x + mlp_block(h2, bp, cfg.mlp_act)
            if (i + 1) % every == 0:
                g = i // every
                cp = _cast(cross[g], cfg)
                hc = rms_norm(x, cp["ln"], eps)
                a2, _ = attention_decode(hc, cp, cfg,
                                         _kv_at(caches["cross"], g), pos,
                                         kv_cached=True)
                x = x + a2
    else:
        for i, bp in enumerate(_layers(params["blocks"])):
            bp = _cast(bp, cfg)
            h = rms_norm(x, bp["ln1"], eps)
            a, _ = attention_decode(h, bp, cfg, _kv_at(caches["kv"], i), pos,
                                    window=cfg.window)
            x = x + a
            h2 = rms_norm(x, bp["ln2"], eps)
            if cfg.family == "moe":
                ff, _ = moe_ffn(h2, bp, cfg)
            else:
                ff = mlp_block(h2, bp, cfg.mlp_act)
            x = x + ff

    hidden = rms_norm(x, params["final_ln"], eps)
    logits = logits_fn(params, hidden, cfg)[:, 0]
    return logits, DecodeState(caches=caches, pos=pos + 1)


def _cross_kv(src: Tensor, cross_blocks: Dict[str, Tensor],
              cfg: ModelConfig) -> KVCache:
    """Every cross block's k and v of ``src`` (B, Ss, D) at once: a batched
    einsum over the stacked weights (the reference ``vmap``s a projection
    over the blocks)."""
    B, Ss, _ = src.shape
    G = _n_layers(cross_blocks)
    Hkv, hd = cfg.n_kv_heads, cfg.hd
    k = torch.einsum("bsd,gde->gbse", src, cross_blocks["wk"].to(cfg.adtype))
    v = torch.einsum("bsd,gde->gbse", src, cross_blocks["wv"].to(cfg.adtype))
    return KVCache(k.reshape(G, B, Ss, Hkv, hd), v.reshape(G, B, Ss, Hkv, hd))


def fill_cross_cache(params: Params, cfg: ModelConfig, state: DecodeState,
                     *, img_embed=None, frames=None) -> DecodeState:
    """Populate cross-attention caches from the stub frontend embeddings."""
    if cfg.family == "vlm":
        img = img_embed.to(cfg.adtype) @ params["img_proj"].to(cfg.adtype)
        cross = _cross_kv(img, params["cross_blocks"], cfg)
        return state._replace(caches={**state.caches, "cross": cross})
    if cfg.family == "encdec":
        # run the encoder once, then project k/v per decoder layer
        enc = _encode(params, frames, cfg)
        cross = _cross_kv(enc, params["cross_blocks"], cfg)
        return state._replace(caches={**state.caches, "cross": cross})
    return state


# ---------------------------------------------------------------------------
# nn.Module view of the tree
# ---------------------------------------------------------------------------

def _to_parameters(tree: Dict[str, Any], device) -> Dict[str, Any]:
    return {k: (nn.ParameterDict(_to_parameters(v, device))
                if isinstance(v, dict) else nn.Parameter(v.to(device)))
            for k, v in tree.items()}


def _to_tree(node) -> Dict[str, Any]:
    return {k: (_to_tree(v) if isinstance(v, (dict, nn.ParameterDict))
                else v) for k, v in node.items()}


class CausalLM(nn.Module):
    """The parameter tree as a module: each top-level key of the tree is an
    attribute (a Parameter or a nested ``nn.ParameterDict``), so
    ``state_dict()`` keys are the tree's paths joined with dots, and
    ``.parameters()`` and ``.to()`` work. ``params`` is the tree view that
    the functions of this module take. Built from ``params`` (a tree of
    tensors, moved to ``device``) or else by :func:`init` with ``seed``;
    ``device=None`` means the card."""

    def __init__(self, cfg: ModelConfig, params: Optional[Params] = None, *,
                 seed: int = 0, device=None):
        super().__init__()
        from repro_torch.core.saif import resolve_device
        dev = resolve_device(device)
        self.cfg = cfg
        if params is None:
            params = init(cfg, seed=seed, device=dev)
        self._keys = tuple(params)
        for k, v in _to_parameters(params, dev).items():
            setattr(self, k, v)

    @property
    def params(self) -> Params:
        return _to_tree({k: getattr(self, k) for k in self._keys})

    def forward(self, tokens: Tensor, *, img_embed=None, frames=None
                ) -> Tensor:
        """Logits (B, S, V) of the full forward pass."""
        params = self.params
        hidden, _ = backbone(params, tokens, self.cfg, img_embed=img_embed,
                             frames=frames)
        return logits_fn(params, hidden, self.cfg)
