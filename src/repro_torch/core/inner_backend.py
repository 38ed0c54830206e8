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

Fused LASSO's unpenalized slot (``unpen_idx`` >= 0, the feature id of
``b``) reaches every backend as per-slot l1 weights (0 on the slot holding
it, :func:`~repro_torch.core.active_set.pen_weights`) and, in the dual tail,
as its column: the dual point is projected onto x_b^T theta = 0 and the l1
term skips b. The plain backend Newton-polishes b for a general loss
before the tail; K3's ``_pen`` entries do the same in the kernel.

The Gram carry keeps the reference's invariants: ``gidx[s]`` names the
feature backing row/column s of G (-1 = nothing valid); G[s, t] = x_s^T x_t
for every pair of live slots whose ``gidx`` matches ``idx``; ``refresh``
invalidates dead slots first and then recomputes the dirty live ones.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import torch

from repro_torch.core import active_set as aset_lib
from repro_torch.core.active_set import ActiveSet
from repro_torch.core.cm import cm_epochs_compact, gram_epochs
from repro_torch.core.duality import duality_gap, feasible_dual, polish_unpen
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


def _dual_and_gap(loss: Loss, Xa, y, beta, z, mask, lam, pen=None,
                  x_unpen=None):
    """Post-burst tail of the torch and gram backends: the feasible dual
    point and the sub-problem duality gap (``pen``/``x_unpen``: the
    unpenalized slot's weights and column)."""
    hat = -loss.grad(z, y) / lam
    theta = feasible_dual(loss, Xa, y, hat, lam, mask, pen=pen,
                          x_unpen=x_unpen)
    gap = duality_gap(loss, Xa, y, beta, theta, lam, mask, pen=pen)
    return theta, gap


def _pen(aset: ActiveSet, unpen_idx: int, dtype):
    return (aset_lib.pen_weights(aset, unpen_idx, dtype)
            if unpen_idx >= 0 else None)


def _no_init(aset, carry, Xa):
    return carry


def _no_refresh(carry, aset, Xa):
    return carry


def make_inner_torch(loss: Loss, X: Tensor, y: Tensor,
                     unpen_idx: int = -1) -> InnerBackend:
    """Plain backend: residual-update epochs, O(n) per coordinate step."""
    x_unpen = X[:, unpen_idx] if unpen_idx >= 0 else None

    def run(carry, aset, Xa, lam, n_ep):
        pen = _pen(aset, unpen_idx, X.dtype)
        beta, z = cm_epochs_compact(loss, Xa, y, aset.beta, Xa @ aset.beta,
                                    aset.mask, lam, aset.order, aset.count,
                                    n_ep, pen)
        if unpen_idx >= 0 and loss.name != "least_squares":
            # general loss: polish b to stationarity so the dual point meets
            # its equality constraint through the gradient itself
            slots = torch.nonzero(aset.mask & (aset.idx == unpen_idx))
            if slots.numel():
                s = int(slots[0])
                b_new, z = polish_unpen(loss, x_unpen, y, z, beta[s])
                beta = beta.clone()
                beta[s] = b_new
        theta, gap = _dual_and_gap(loss, Xa, y, beta, z, aset.mask, lam,
                                   pen, x_unpen)
        return InnerOut(beta=beta, z=z, theta=theta, gap=gap)

    return InnerBackend(name="torch", init=_no_init, refresh=_no_refresh,
                        run=run)


def make_inner_gram(loss: Loss, X: Tensor, y: Tensor, h: int,
                    unpen_idx: int = -1) -> InnerBackend:
    """Covariance-update backend: O(k_max) coordinate steps (LS only). The
    unpenalized slot needs no Gram handling of its own: it is always
    resident, so its row and column of G stay valid."""
    if loss.name != "least_squares":
        raise ValueError("the gram inner backend needs a linear gradient "
                         f"(least squares); got loss {loss.name!r}")
    x_unpen = X[:, unpen_idx] if unpen_idx >= 0 else None

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
        pen = _pen(aset, unpen_idx, X.dtype)
        beta = gram_epochs(carry.G, carry.rho, aset.beta, aset.mask, lam,
                           aset.order, aset.count, n_ep,
                           smoothness=loss.smoothness, pen=pen)
        z = Xa @ beta                # the only O(n k) term: once per burst
        theta, gap = _dual_and_gap(loss, Xa, y, beta, z, aset.mask, lam,
                                   pen, x_unpen)
        return InnerOut(beta=beta, z=z, theta=theta, gap=gap)

    return InnerBackend(name="gram", init=init, refresh=refresh, run=run)


def make_inner_cuda(loss: Loss, X: Tensor, y: Tensor, col_norm: Tensor,
                    unpen_idx: int = -1) -> InnerBackend:
    """Kernel backend: one K3 launch per burst, on the transposed active
    block gathered straight from X; K3's ``_pen`` entries with an
    unpenalized slot."""
    from repro_torch.kernels.cm.cm import cm_burst_pen_xt, cm_burst_xt

    XT = X.T

    def run(carry, aset, Xa, lam, n_ep):
        XaT = torch.where(aset.mask[:, None],
                          torch.index_select(XT, 0, aset.idx),
                          0.0).contiguous()
        # O(k_max) gather of the precomputed column norms
        norms = torch.where(aset.mask, col_norm[aset.idx], 0.0)
        if unpen_idx >= 0:
            beta, z, theta, gap = cm_burst_pen_xt(
                XaT, y, aset.beta, norms * norms, aset.mask, aset.order,
                aset_lib.pen_weights(aset, unpen_idx, X.dtype), lam, n_ep,
                aset.count, loss_name=loss.name)
        else:
            beta, z, theta, gap = cm_burst_xt(
                XaT, y, aset.beta, norms * norms, aset.mask, aset.order, lam,
                n_ep, aset.count, loss_name=loss.name)
        return InnerOut(beta=beta, z=z, theta=theta, gap=gap)

    return InnerBackend(name="cuda", init=_no_init, refresh=_no_refresh,
                        run=run)


def make_inner(name: str, loss: Loss, X: Tensor, y: Tensor,
               col_norm: Tensor, h: int, unpen_idx: int = -1
               ) -> InnerBackend:
    if name == "gram":
        return make_inner_gram(loss, X, y, h, unpen_idx)
    if name == "cuda":
        return make_inner_cuda(loss, X, y, col_norm, unpen_idx)
    return make_inner_torch(loss, X, y, unpen_idx)


# --------------------------------------------------------------------------
# fleet backends (core/batch.py): B problems over one shared design
# --------------------------------------------------------------------------
# ``torch`` and ``gram`` are map-fused: each problem runs the SERIAL backend
# built for its own response (and its own h), so its burst, dual point and
# gap are the literal serial computation. ``cuda`` is the problem-gridded
# kernel K3b: one launch runs the bursts of every live problem, one CTA
# each, with K3's body, so a fleet burst is bitwise a serial burst.


class BatchInnerBackend(NamedTuple):
    """The fleet inner interface the engine consumes; one of two paths:

      * ``make_one(y_b, h_b) -> InnerBackend`` — map-fused (torch, gram):
        each live problem runs the serial backend built here;
      * ``fleet_step(problems, n_eps) -> [InnerOut]`` — the gridded kernel
        (cuda): one launch for the bursts of the live ``problems`` (the
        engine's per-problem states), each with its epoch count.

    ``init`` reconciles the fleet's inbound carries with its initial
    active sets, per problem, outside the loop."""
    name: str
    init: Callable
    make_one: Optional[Callable] = None
    fleet_step: Optional[Callable] = None


def cold_inner_carry_batch(b: int, k_max: int, dtype, device,
                           backend: str = "gram") -> List[InnerCarry]:
    """All-invalid carries, one per problem of the fleet."""
    return [cold_inner_carry(k_max, dtype, device, backend=backend)
            for _ in range(b)]


def _fleet_init(make_one, Y, hs):
    """Per-problem init of the serial backends (the only place a Gram
    carry is built in full)."""
    def init(asets, carries, Xas):
        return [make_one(y, h).init(a, c, Xa)
                for y, h, a, c, Xa in zip(Y, hs, asets, carries, Xas)]
    return init


def make_batch_inner_torch(loss: Loss, X: Tensor, Y, hs) -> BatchInnerBackend:
    """Fleet plain backend: the serial residual-update backend per problem
    (``Y``: the per-problem responses, ``hs``: their batch sizes)."""
    def make_one(y, h):
        return make_inner_torch(loss, X, y)
    return BatchInnerBackend(name="torch", init=_fleet_init(make_one, Y, hs),
                             make_one=make_one)


def make_batch_inner_gram(loss: Loss, X: Tensor, Y, hs) -> BatchInnerBackend:
    """Fleet covariance-update backend: the serial Gram backend per problem,
    each with its own (k_max, k_max) carry and its own refresh bound h."""
    def make_one(y, h):
        return make_inner_gram(loss, X, y, h)
    return BatchInnerBackend(name="gram", init=_fleet_init(make_one, Y, hs),
                             make_one=make_one)


def make_batch_inner_cuda(loss: Loss, X: Tensor,
                          col_norm: Tensor) -> BatchInnerBackend:
    """Fleet kernel backend: one K3b launch per outer step for the bursts of
    every live problem. The blocks are gathered transposed straight from X
    in one gather; lambda, the epoch counts and the live-slot counts reach
    the kernel as per-problem device arrays."""
    from repro_torch.kernels.cm.cm import cm_burst_batch_xt

    XT = X.T

    def fleet_step(probs, n_eps):
        asets = [q.aset for q in probs]
        idx = torch.stack([a.idx for a in asets])
        mask = torch.stack([a.mask for a in asets])
        AT = torch.where(mask[:, :, None], XT[idx], 0.0)
        norms = torch.where(mask, col_norm[idx], 0.0)
        meta = torch.tensor([n_eps, [a.count for a in asets]],
                            dtype=torch.int32).to(X.device)
        beta, z, theta, gap = cm_burst_batch_xt(
            AT, torch.stack([q.y for q in probs]),
            torch.stack([a.beta for a in asets]), norms * norms, mask,
            torch.stack([a.order for a in asets]),
            torch.stack([q.lam for q in probs]), meta[0], meta[1],
            loss_name=loss.name)
        # each problem's own contiguous tensors, for its serial reductions
        return [InnerOut(beta=beta[j].clone(), z=z[j],
                         theta=theta[j].clone(), gap=gap[j])
                for j in range(len(probs))]

    return BatchInnerBackend(name="cuda",
                             init=lambda asets, carries, Xas: carries,
                             fleet_step=fleet_step)


def make_batch_inner(name: str, loss: Loss, X: Tensor, Y, col_norm: Tensor,
                     hs) -> BatchInnerBackend:
    """Fleet inner backend by resolved name."""
    if name == "gram":
        return make_batch_inner_gram(loss, X, Y, hs)
    if name == "cuda":
        return make_batch_inner_cuda(loss, X, col_norm)
    return make_batch_inner_torch(loss, X, Y, hs)


# n/k_max crossover of the auto policy, the reference's: the gram step is an
# O(k_max) axpy against ~3 O(n) passes of the residual step. It decides only
# where the Gram sweep competes with a plain loop: on the CPU, and on the card
# past K3's shared-memory gate.
GRAM_CROSSOVER = 4.0


def resolve_inner_backend(name: str, loss_name: str, n: int, k_max: int,
                          device: torch.device, itemsize: int = 8,
                          unpen: bool = False) -> str:
    """Inner-backend policy: an explicit name wins. ``auto`` on a CUDA
    device runs the K3 kernel while the burst fits its shared memory
    (``cm_smem_ok``; ``unpen``: with the unpenalized slot's weights), for
    least squares too, since the port's Gram sweep is a host loop with one
    device read per coordinate step; past that gate least squares takes
    the Gram engine while GRAM_CROSSOVER * n >= k_max. On the CPU ``auto``
    keeps the reference's choice: the Gram engine for least squares under
    the same crossover, else the plain path. A burst that neither fits K3
    nor (least squares) the crossover raises on a CUDA device, under
    ``auto`` as under ``cuda``: the plain path there is a host loop that
    the caller must ask for by name."""
    from repro_torch.kernels.cm.cm import cm_smem_ok

    ls = loss_name == "least_squares"
    if name == "auto":
        if torch.device(device).type != "cuda":
            return "gram" if ls and GRAM_CROSSOVER * n >= k_max else "torch"
        if (ls and not cm_smem_ok(n, k_max, itemsize, unpen)
                and GRAM_CROSSOVER * n >= k_max):
            return "gram"
        name = "cuda"
    if name not in ("torch", "gram", "cuda"):
        raise ValueError(f"unknown inner backend {name!r}")
    if name == "gram" and not ls:
        raise ValueError("inner_backend='gram' requires loss='least_squares'"
                         " (covariance updates need a linear gradient); use"
                         " 'torch' or 'cuda'")
    if name == "cuda" and not cm_smem_ok(n, k_max, itemsize, unpen):
        raise ValueError(
            f"CUDA inner backend: a {n}x{k_max} active block exceeds the "
            f"CM kernel's shared-memory budget; shrink k_max, or pass "
            f"inner_backend='torch' (a host loop on the card) or, for "
            f"least squares, 'gram'")
    return name
