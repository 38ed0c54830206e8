"""Pluggable inner-solver backends for the SAIF CM burst (port of the serial
parts of ``repro.core.inner_backend``).

An outer step needs from the inner solver, on the fixed-capacity active
block: the coefficients after the CM burst, the model vector z = Xa beta,
the feasible dual point theta and the sub-problem duality gap — one
:class:`InnerOut`. Three backends:

  * ``torch`` — residual-update coordinate steps (``core/cm.py``), each an
                O(n) dot plus an O(n) rank-1 model update (the reference's
                ``jnp``);
  * ``gram``  — the covariance-update engine (least squares only): the Gram
                matrix G = Xa^T Xa and rho = Xa^T y of the active block ride
                in an :class:`InnerCarry` through the outer loop, so each
                coordinate step is an O(k_max) axpy; ADD/DEL refresh at most
                ``h`` columns per outer step;
  * ``cuda``  — kernel K3 (``kernels/cm``): the whole burst, the dual point
                and the gap in one launch (the reference's ``pallas``).

The Gram carry keeps the reference's invariants: ``gidx[s]`` names the
feature backing row/column s of G (-1 = nothing valid); G[s, t] = x_s^T x_t
for every pair of live slots whose ``gidx`` matches ``idx``; ``refresh``
invalidates dead slots first and then recomputes the dirty live ones.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core.active_set import ActiveSet
from repro_torch.core.cm import cm_epochs_compact, gram_epochs
from repro_torch.core.duality import duality_gap, feasible_dual
from repro_torch.core.losses import Loss

Tensor = torch.Tensor


class InnerCarry(NamedTuple):
    """Inner-solver state threaded through the outer loop (empty (0, 0) /
    (0,) tensors for backends that keep none)."""
    G: Tensor      # (k_max, k_max) active-block Gram matrix
    rho: Tensor    # (k_max,) x_j^T y per slot
    gidx: Tensor   # (k_max,) int64 feature id backing each slot (-1 = none)


class InnerOut(NamedTuple):
    beta: Tensor   # (k_max,) post-burst coefficients
    z: Tensor      # (n,) model vector Xa beta
    theta: Tensor  # (n,) feasible dual point
    gap: Tensor    # scalar sub-problem duality gap


class InnerBackend(NamedTuple):
    """``init(aset, carry, Xa)`` reconciles an inbound carry with the
    initial active set; ``refresh(carry, aset, Xa)`` absorbs the previous
    step's ADD/DEL; ``run(carry, aset, Xa, lam, n_ep)`` is the burst."""
    name: str
    init: Callable[[ActiveSet, InnerCarry, Tensor], InnerCarry]
    refresh: Callable[[InnerCarry, ActiveSet, Tensor], InnerCarry]
    run: Callable[[InnerCarry, ActiveSet, Tensor, Tensor, int], InnerOut]


def cold_inner_carry(k_max: int, dtype, device,
                     backend: str = "gram") -> InnerCarry:
    """All-invalid carry: forces a full rebuild in ``init``."""
    k = k_max if backend == "gram" else 0
    return InnerCarry(G=torch.zeros((k, k), dtype=dtype, device=device),
                      rho=torch.zeros(k, dtype=dtype, device=device),
                      gidx=torch.full((k,), -1, dtype=torch.long,
                                      device=device))


def _dual_and_gap(loss: Loss, Xa, y, beta, z, mask, lam):
    """Post-burst tail of the torch and gram backends: the feasible dual
    point and the sub-problem duality gap."""
    hat = -loss.grad(z, y) / lam
    theta = feasible_dual(loss, Xa, y, hat, lam, mask)
    gap = duality_gap(loss, Xa, y, beta, theta, lam, mask)
    return theta, gap


def _no_init(aset, carry, Xa):
    return carry


def _no_refresh(carry, aset, Xa):
    return carry


def make_inner_torch(loss: Loss, X: Tensor, y: Tensor) -> InnerBackend:
    """Plain backend: residual-update epochs, O(n) per coordinate step."""
    def run(carry, aset, Xa, lam, n_ep):
        beta, z = cm_epochs_compact(loss, Xa, y, aset.beta, Xa @ aset.beta,
                                    aset.mask, lam, aset.order, aset.count,
                                    n_ep)
        theta, gap = _dual_and_gap(loss, Xa, y, beta, z, aset.mask, lam)
        return InnerOut(beta=beta, z=z, theta=theta, gap=gap)

    return InnerBackend(name="torch", init=_no_init, refresh=_no_refresh,
                        run=run)


def make_inner_gram(loss: Loss, X: Tensor, y: Tensor, h: int
                    ) -> InnerBackend:
    """Covariance-update backend: O(k_max) coordinate steps (LS only)."""
    if loss.name != "least_squares":
        raise ValueError("the gram inner backend needs a linear gradient "
                         f"(least squares); got loss {loss.name!r}")

    def _rebuild(aset, Xa):
        return InnerCarry(G=Xa.T @ Xa, rho=Xa.T @ y,
                          gidx=torch.where(aset.mask, aset.idx, -1))

    def init(aset, carry, Xa):
        # the only place a full O(n k^2) build can happen
        gidx = torch.where(aset.mask, carry.gidx, -1)
        dirty = aset.mask & (gidx != aset.idx)
        if bool(dirty.any()):
            return _rebuild(aset, Xa)
        return carry._replace(gidx=gidx)

    def refresh(carry, aset, Xa):
        gidx = torch.where(aset.mask, carry.gidx, -1)
        dirty = aset.mask & (gidx != aset.idx)
        # at most h slots turn live per outer step (the candidate buffer)
        slots = torch.nonzero(dirty).flatten()[:h]
        if slots.numel() == 0:
            return carry._replace(gidx=gidx)
        ids = aset.idx[slots]
        cols = X[:, ids]
        G = carry.G.clone()
        G[:, slots] = Xa.T @ cols
        G[slots, :] = cols.T @ Xa
        rho = carry.rho.clone()
        rho[slots] = cols.T @ y
        gidx = gidx.clone()
        gidx[slots] = ids
        return InnerCarry(G=G, rho=rho, gidx=gidx)

    def run(carry, aset, Xa, lam, n_ep):
        beta = gram_epochs(carry.G, carry.rho, aset.beta, aset.mask, lam,
                           aset.order, aset.count, n_ep,
                           smoothness=loss.smoothness)
        z = Xa @ beta                # the only O(n k) term: once per burst
        theta, gap = _dual_and_gap(loss, Xa, y, beta, z, aset.mask, lam)
        return InnerOut(beta=beta, z=z, theta=theta, gap=gap)

    return InnerBackend(name="gram", init=init, refresh=refresh, run=run)


def make_inner_cuda(loss: Loss, X: Tensor, y: Tensor,
                    col_norm: Tensor) -> InnerBackend:
    """Kernel backend: one K3 launch per burst, on the transposed active
    block gathered straight from X."""
    from repro_torch.kernels.cm.cm import cm_burst_xt

    XT = X.T

    def run(carry, aset, Xa, lam, n_ep):
        XaT = torch.where(aset.mask[:, None],
                          torch.index_select(XT, 0, aset.idx),
                          0.0).contiguous()
        # O(k_max) gather of the precomputed column norms
        norms = torch.where(aset.mask, col_norm[aset.idx], 0.0)
        beta, z, theta, gap = cm_burst_xt(
            XaT, y, aset.beta, norms * norms, aset.mask, aset.order, lam,
            n_ep, aset.count, loss_name=loss.name)
        return InnerOut(beta=beta, z=z, theta=theta, gap=gap)

    return InnerBackend(name="cuda", init=_no_init, refresh=_no_refresh,
                        run=run)


def make_inner(name: str, loss: Loss, X: Tensor, y: Tensor,
               col_norm: Tensor, h: int) -> InnerBackend:
    if name == "gram":
        return make_inner_gram(loss, X, y, h)
    if name == "cuda":
        return make_inner_cuda(loss, X, y, col_norm)
    return make_inner_torch(loss, X, y)


# n/k_max crossover of the auto policy, the reference's: the gram step is an
# O(k_max) axpy against ~3 O(n) passes of the residual step.
GRAM_CROSSOVER = 4.0


def resolve_inner_backend(name: str, loss_name: str, n: int, k_max: int,
                          device: torch.device, itemsize: int = 8) -> str:
    """Inner-backend policy: an explicit name wins; ``auto`` picks the
    covariance-update engine for least squares while GRAM_CROSSOVER * n >=
    k_max, else the K3 kernel on a CUDA device and the plain path on the
    CPU. A block over K3's shared-memory budget raises on a CUDA device,
    under ``auto`` as under ``cuda``: the plain path there is a host loop
    that the caller must ask for by name."""
    from repro_torch.kernels.cm.cm import cm_smem_ok

    if name == "auto":
        if loss_name == "least_squares" and GRAM_CROSSOVER * n >= k_max:
            return "gram"
        if torch.device(device).type != "cuda":
            return "torch"
        name = "cuda"
    if name not in ("torch", "gram", "cuda"):
        raise ValueError(f"unknown inner backend {name!r}")
    if name == "gram" and loss_name != "least_squares":
        raise ValueError("inner_backend='gram' requires loss='least_squares'"
                         " (covariance updates need a linear gradient); use"
                         " 'torch' or 'cuda'")
    if name == "cuda" and not cm_smem_ok(n, k_max, itemsize):
        raise ValueError(
            f"CUDA inner backend: a {n}x{k_max} active block exceeds the "
            f"CM kernel's shared-memory budget; shrink k_max, or pass "
            f"inner_backend='torch' (a host loop on the card) or, for "
            f"least squares, 'gram'")
    return name
