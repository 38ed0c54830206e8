"""Recurrent sequence blocks: selective SSM (Mamba-style), mLSTM, sLSTM
(port of ``repro.models.ssm``).

Where the state is matrix-valued (Mamba, mLSTM) the recurrence runs in
chunkwise-parallel form: a loop over chunks carries the state, and within a
chunk the recurrence is evaluated in parallel. The reference's
``lax.associative_scan`` becomes :func:`prefix_scan`, a log2(Q)-step
doubling scan with the same combine (a log-space cumsum would change the
products' rounding and underflow). sLSTM runs that scan over the whole
sequence.

Decode paths carry the state explicitly — O(1) per token.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from repro_torch.models.layers import recording, remat_call


def prefix_scan(a: Tensor, b: Tensor, dim: int) -> Tuple[Tensor, Tensor]:
    """Inclusive scan of h_t = a_t h_{t-1} + b_t along ``dim`` from h = 0:
    the prefix products of ``a`` and the states, by recursive doubling
    with the reference's combine ((a_x, b_x), (a_y, b_y)) -> (a_x a_y,
    a_y b_x + b_y), ceil(log2(len)) steps."""
    n = a.shape[dim]
    d = 1
    while d < n:
        a_lo, b_lo = a.narrow(dim, 0, n - d), b.narrow(dim, 0, n - d)
        a_hi, b_hi = a.narrow(dim, d, n - d), b.narrow(dim, d, n - d)
        a = torch.cat([a.narrow(dim, 0, d), a_lo * a_hi], dim=dim)
        b = torch.cat([b.narrow(dim, 0, d), a_hi * b_lo + b_hi], dim=dim)
        d *= 2
    return a, b


# ===========================================================================
# Mamba-style selective SSM
# ===========================================================================

class MambaState(NamedTuple):
    h: Tensor      # (B, Di, N) SSM state
    conv: Tensor   # (B, Di, K-1) causal-conv tail


def _mamba_chunk(h, uq, dtq, bq, cq, A):
    """One chunk of the selective scan from state ``h``: (y, last state)."""
    # discretize: a_t = exp(dt_t * A)  (B, Q, Di, N); b_t = dt*u*B
    da = torch.exp(dtq[..., None] * A[None, None])
    db = (dtq * uq)[..., None] * bq[:, :, None, :]
    a_pref, b_pref = prefix_scan(da, db, dim=1)
    hs = a_pref * h[:, None] + b_pref                         # (B,Q,Di,N)
    # a copy, so the carried state does not hold the chunk's hs alive
    return torch.einsum("bqdn,bqn->bqd", hs, cq), hs[:, -1].contiguous()


def _ssm_chunk_scan(u: Tensor, dt: Tensor, Bm: Tensor, Cm: Tensor,
                    A: Tensor, chunk: int) -> Tensor:
    """Chunked selective-SSM scan.

    u: (B, S, Di); dt: (B, S, Di); Bm/Cm: (B, S, N); A: (Di, N) (negative).
    Returns y: (B, S, Di). While autograd records, every chunk is
    checkpointed, as the reference always checkpoints its chunk body.
    """
    B, S, Di = u.shape
    N = A.shape[1]
    remat = recording(u, dt, Bm, Cm, A)
    h = torch.zeros((B, Di, N), dtype=u.dtype, device=u.device)
    ys = []
    for uq, dtq, bq, cq in zip(*(t.split(chunk, dim=1)
                                 for t in (u, dt, Bm, Cm))):
        y, h = remat_call(_mamba_chunk, remat, h, uq, dtq, bq, cq, A)
        ys.append(y)
    return torch.cat(ys, dim=1)


def mamba_block(x: Tensor, p, cfg) -> Tensor:
    """Selective-SSM sublayer. x: (B, S, D) -> (B, S, D).

    p: in_proj (D, 2Di), conv (K, Di), x_proj (Di, dt_rank + 2N),
       dt_proj (dt_rank, Di), A_log (Di, N), Dskip (Di,), out_proj (Di, D).
    """
    B, S, D = x.shape
    N = cfg.ssm_state
    K = p["conv"].shape[0]
    dt_rank = p["dt_proj"].shape[0]

    ur = x @ p["in_proj"]                                     # (B, S, 2Di)
    u, res = torch.chunk(ur, 2, dim=-1)
    # causal depthwise conv (kernel K)
    upad = F.pad(u, (0, 0, K - 1, 0))
    u = sum(upad[:, i:i + S] * p["conv"][i][None, None] for i in range(K))
    u = F.silu(u)

    proj = u @ p["x_proj"]                                    # (B,S,rank+2N)
    dt_low, Bm, Cm = torch.split(proj, [dt_rank, N, N], dim=-1)
    dt = F.softplus(dt_low @ p["dt_proj"])                    # (B, S, Di)
    A = -torch.exp(p["A_log"].float()).to(x.dtype)

    chunk = min(cfg.ssm_chunk, S)
    if S % chunk:
        pad = chunk - S % chunk

        def padded(t):
            return F.pad(t, (0, 0, 0, pad))
        y = _ssm_chunk_scan(padded(u), padded(dt), padded(Bm), padded(Cm),
                            A, chunk)[:, :S]
    else:
        y = _ssm_chunk_scan(u, dt, Bm, Cm, A, chunk)
    y = y + u * p["Dskip"][None, None]
    return (y * F.silu(res)) @ p["out_proj"]


def mamba_init_state(cfg, batch, dtype, device=None) -> MambaState:
    Di = cfg.ssm_expand * cfg.d_model
    return MambaState(
        h=torch.zeros((batch, Di, cfg.ssm_state), dtype=dtype, device=device),
        conv=torch.zeros((batch, Di, 3), dtype=dtype, device=device))


def mamba_decode(x: Tensor, p, cfg, state: MambaState
                 ) -> Tuple[Tensor, MambaState]:
    """One-token step. x: (B, 1, D)."""
    N = cfg.ssm_state
    dt_rank = p["dt_proj"].shape[0]

    ur = x[:, 0] @ p["in_proj"]
    u, res = torch.chunk(ur, 2, dim=-1)                       # (B, Di)
    conv_buf = torch.cat([state.conv, u[..., None]], dim=-1)  # (B, Di, K)
    u = torch.einsum("bdk,kd->bd", conv_buf, p["conv"])
    u = F.silu(u)
    new_conv = conv_buf[..., 1:]

    proj = u @ p["x_proj"]
    dt_low, Bm, Cm = torch.split(proj, [dt_rank, N, N], dim=-1)
    dt = F.softplus(dt_low @ p["dt_proj"])                    # (B, Di)
    A = -torch.exp(p["A_log"].float()).to(x.dtype)
    da = torch.exp(dt[..., None] * A[None])                   # (B, Di, N)
    h = da * state.h + (dt * u)[..., None] * Bm[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, Cm) + u * p["Dskip"][None]
    out = (y * F.silu(res)) @ p["out_proj"]
    return out[:, None], MambaState(h=h, conv=new_conv)


# ===========================================================================
# mLSTM (xLSTM matrix-memory block) — chunked linear attention with decay
# ===========================================================================

class MLSTMState(NamedTuple):
    C: Tensor   # (B, H, dk, dv) matrix memory
    n: Tensor   # (B, H, dk)     normalizer


def _mlstm_chunk(C, n, qq, kk, vv, oo, lff, lii, mask):
    """One chunk of the mLSTM from state (C, n): (y, C, n)."""
    dt = C.dtype
    Lc = torch.cumsum(lff, dim=1)              # (B, Q, H) inclusive
    # inter-chunk: y_t += (q_t * exp(Lc_t)) C_prev
    dec_t = torch.exp(Lc).to(dt)               # decay from chunk start
    y_inter = torch.einsum("bqhk,bhkv->bqhv", qq * dec_t[..., None], C)
    n_inter = torch.einsum("bqhk,bhk->bqh", qq * dec_t[..., None], n)
    # intra-chunk: s_{t,tau} = q_t.k_tau exp(Lc_t - Lc_tau + li_tau)
    w = Lc[:, :, None, :] - Lc[:, None, :, :] + lii[:, None, :, :]
    w = torch.where(mask[None, :, :, None], w, -torch.inf)
    wexp = torch.exp(torch.clamp(w, max=30.0)).to(dt)         # (B,Qt,Qs,H)
    s = torch.einsum("bqhk,bshk->bqsh", qq, kk) * wexp
    y = y_inter + torch.einsum("bqsh,bshv->bqhv", s, vv)
    nrm = n_inter + torch.sum(s, dim=2)        # q_t . n_t (intra part)
    # normalizer: max(|q.n|, 1) per xLSTM
    denom = torch.clamp(torch.abs(nrm), min=1.0)[..., None]
    out = oo * (y / denom.to(dt))
    # state update
    dec_chunk = torch.exp(Lc[:, -1]).to(dt)                   # (B, H)
    rdec = torch.exp(Lc[:, -1][:, None] - Lc + lii).to(dt)    # (B,Q,H)
    C = dec_chunk[..., None, None] * C + torch.einsum(
        "bqhk,bqhv->bhkv", kk * rdec[..., None], vv)
    n = dec_chunk[..., None] * n + torch.einsum("bqh,bqhk->bhk", rdec, kk)
    return out, C, n


def mlstm_block(x: Tensor, p, cfg) -> Tensor:
    """x: (B, S, D). p: wq/wk/wv (D, H*hd), wi/wf (D, H), wo_gate (D, H*hd),
    out (H*hd, D). Chunked parallel evaluation."""
    B, S, D = x.shape
    H, hd = cfg.n_heads, cfg.hd
    dt = x.dtype
    q = (x @ p["wq"]).reshape(B, S, H, hd) * hd ** -0.5
    k = (x @ p["wk"]).reshape(B, S, H, hd)
    v = (x @ p["wv"]).reshape(B, S, H, hd)
    # gates: log-sigmoid forget, exponential-capped input
    lf = F.logsigmoid((x @ p["wf"]).float())                  # (B,S,H)
    li = torch.clamp((x @ p["wi"]).float(), max=10.0)         # stability
    og = torch.sigmoid(x @ p["wo_gate"]).reshape(B, S, H, hd)

    Q = min(cfg.ssm_chunk, S)
    if S % Q:
        raise ValueError(f"seq {S} not divisible by chunk {Q}")

    C = torch.zeros((B, H, hd, hd), dtype=dt, device=x.device)
    n = torch.zeros((B, H, hd), dtype=dt, device=x.device)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    remat = recording(q, k, v, lf, li, og)
    ys = []
    for chunk in zip(*(t.split(Q, dim=1) for t in (q, k, v, og, lf, li))):
        y, C, n = remat_call(_mlstm_chunk, remat, C, n, *chunk, mask)
        ys.append(y)
    y = torch.cat(ys, dim=1).reshape(B, S, H * hd)
    return y @ p["out"]


def mlstm_init_state(cfg, batch, dtype, device=None) -> MLSTMState:
    H, hd = cfg.n_heads, cfg.hd
    return MLSTMState(
        C=torch.zeros((batch, H, hd, hd), dtype=dtype, device=device),
        n=torch.zeros((batch, H, hd), dtype=dtype, device=device))


def mlstm_decode(x: Tensor, p, cfg, state: MLSTMState):
    B = x.shape[0]
    H, hd = cfg.n_heads, cfg.hd
    dt = x.dtype
    q = (x[:, 0] @ p["wq"]).reshape(B, H, hd) * hd ** -0.5
    k = (x[:, 0] @ p["wk"]).reshape(B, H, hd)
    v = (x[:, 0] @ p["wv"]).reshape(B, H, hd)
    f = torch.exp(F.logsigmoid((x[:, 0] @ p["wf"]).float())).to(dt)  # (B, H)
    i = torch.exp(torch.clamp((x[:, 0] @ p["wi"]).float(), max=10.0)).to(dt)
    og = torch.sigmoid(x[:, 0] @ p["wo_gate"]).reshape(B, H, hd)
    C = f[..., None, None] * state.C + i[..., None, None] * \
        torch.einsum("bhk,bhv->bhkv", k, v)
    n = f[..., None] * state.n + i[..., None] * k
    num = torch.einsum("bhk,bhkv->bhv", q, C)
    den = torch.clamp(torch.abs(torch.einsum("bhk,bhk->bh", q, n)), min=1.0)
    y = og * (num / den[..., None].to(dt))
    return (y.reshape(B, 1, H * hd) @ p["out"]), MLSTMState(C=C, n=n)


# ===========================================================================
# sLSTM (scalar-memory xLSTM block) — elementwise linear recurrence
# ===========================================================================

class SLSTMState(NamedTuple):
    c: Tensor   # (B, D)
    n: Tensor   # (B, D)


def slstm_block(x: Tensor, p, cfg) -> Tensor:
    """x: (B, S, D). p: wz/wi/wf/wo (D, D), out (D, D)."""
    z = torch.tanh(x @ p["wz"])
    i = torch.exp(torch.clamp((x @ p["wi"]).float(), max=10.0))
    lf = F.logsigmoid((x @ p["wf"]).float())
    o = torch.sigmoid(x @ p["wo"])

    # linear recurrence c_t = f_t c_{t-1} + i_t z_t — the doubling scan
    f = torch.exp(lf)
    _, c = prefix_scan(f, i * z.float(), dim=1)
    _, n = prefix_scan(f, i, dim=1)
    h = o * (c / torch.clamp(torch.abs(n), min=1.0)).to(x.dtype)
    return h @ p["out"]


def slstm_init_state(cfg, batch, dtype=None, device=None) -> SLSTMState:
    """The sLSTM state is float32 whatever the compute dtype, as in the
    reference (``dtype`` is ignored)."""
    D = cfg.d_model
    return SLSTMState(
        c=torch.zeros((batch, D), dtype=torch.float32, device=device),
        n=torch.zeros((batch, D), dtype=torch.float32, device=device))


def slstm_decode(x: Tensor, p, cfg, state: SLSTMState):
    z = torch.tanh(x[:, 0] @ p["wz"])
    i = torch.exp(torch.clamp((x[:, 0] @ p["wi"]).float(), max=10.0))
    f = torch.exp(F.logsigmoid((x[:, 0] @ p["wf"]).float()))
    o = torch.sigmoid(x[:, 0] @ p["wo"])
    c = f * state.c + i * z.float()
    n = f * state.n + i
    h = o * (c / torch.clamp(torch.abs(n), min=1.0)).to(x.dtype)
    return (h @ p["out"])[:, None], SLSTMState(c=c, n=n)
