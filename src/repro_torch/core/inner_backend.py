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
                coordinate step is an O(k_max) axpy (kernel K6 on the
                card); ADD/DEL refresh at most ``h`` columns per outer
                step;
  * ``cuda``  — kernel K3 (``kernels/cm``): the whole burst, the dual point
                and the gap in one launch (the reference's ``pallas``).

Fused LASSO's unpenalized slot (``unpen_idx`` >= 0, the feature id of
``b``) reaches every backend as per-slot l1 weights (0 on the slot holding
it, :func:`~repro_torch.core.active_set.pen_weights`) and, in the dual tail,
as its column: the dual point is projected onto x_b^T theta = 0 and the l1
term skips b. The plain backend Newton-polishes b for a general loss
before the tail; K3's ``_pen`` entries do the same in the kernel.

Sample weights (``sample_w`` (n,), the K-fold CV row-mask trick) reach the
``torch`` and ``gram`` backends: the plain sweeps weight the gradient, the
Gram carry absorbs them (G = Xa^T diag(w) Xa, rho = Xa^T diag(w) y, so the
sweep itself is unweighted) and the dual tail weights the gradient, the
primal value and the conjugate sum. They do not compose with the
unpenalized slot, and the fleet kernel backend refuses them, as the
reference's does.

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
from repro_torch.core.cm import cm_epochs_compact
from repro_torch.core.duality import duality_gap, feasible_dual, polish_unpen
from repro_torch.core.losses import Loss, mv_last, per_problem

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
                  x_unpen=None, sample_w=None):
    """Post-burst tail of the torch and gram backends: the feasible dual
    point and the sub-problem duality gap (``pen``/``x_unpen``: the
    unpenalized slot's weights and column).

    ``sample_w`` (n,) weights the loss per sample: the gradient, primal
    value and conjugate sum pick up the weight. With binary weights the
    unscaled dual candidate lives on the weight-1 rows, so the LS tau*
    scaling and the constraint correlations against the shared Xa equal
    their row-subsampled counterparts exactly; the general-loss dom-f*
    clamp can move an exact 0 off 0, so theta is re-zeroed on the
    weight-0 rows after it. Without ``pen``/``x_unpen`` it also takes a
    stack of problems, one a row (the fast fleet's)."""
    lam_c = per_problem(lam)
    if sample_w is None:
        hat = -loss.grad(z, y) / lam_c
        theta = feasible_dual(loss, Xa, y, hat, lam, mask, pen=pen,
                              x_unpen=x_unpen)
        gap = duality_gap(loss, Xa, y, beta, theta, lam, mask, pen=pen)
        return theta, gap
    hat = -(sample_w * loss.grad(z, y)) / lam_c
    theta = feasible_dual(loss, Xa, y, hat, lam, mask, pen=pen,
                          x_unpen=x_unpen)
    if loss.name != "least_squares":
        theta = torch.where(sample_w > 0, theta, 0.0)
    beta_m = torch.where(mask, beta, 0.0) if mask is not None else beta
    l1 = torch.abs(beta_m) if pen is None else pen * torch.abs(beta_m)
    p_val = (torch.sum(sample_w * loss.value(mv_last(Xa, beta_m), y), dim=-1)
             + lam * torch.sum(l1, dim=-1))
    d_val = -torch.sum(sample_w * loss.conj(-lam_c * theta, y), dim=-1)
    return theta, p_val - d_val


def _no_weights_with_unpen(unpen_idx: int, sample_w) -> None:
    if unpen_idx >= 0 and sample_w is not None:
        raise ValueError("sample weights do not compose with the fused "
                         "unpenalized slot")


def _pen(aset: ActiveSet, unpen_idx: int, dtype):
    return (aset_lib.pen_weights(aset, unpen_idx, dtype)
            if unpen_idx >= 0 else None)


def _no_init(aset, carry, Xa):
    return carry


def _no_refresh(carry, aset, Xa):
    return carry


def make_inner_torch(loss: Loss, X: Tensor, y: Tensor,
                     unpen_idx: int = -1,
                     sample_w: Tensor | None = None) -> InnerBackend:
    """Plain backend: residual-update epochs, O(n) per coordinate step;
    ``sample_w`` weights the loss per sample."""
    _no_weights_with_unpen(unpen_idx, sample_w)
    x_unpen = (aset_lib.columns(X, unpen_idx) if unpen_idx >= 0
               else None)

    def run(carry, aset, Xa, lam, n_ep):
        pen = _pen(aset, unpen_idx, X.dtype)
        beta, z = cm_epochs_compact(loss, Xa, y, aset.beta, Xa @ aset.beta,
                                    aset.mask, lam, aset.order, aset.count,
                                    n_ep, pen, sample_w)
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
                                   pen, x_unpen, sample_w)
        return InnerOut(beta=beta, z=z, theta=theta, gap=gap)

    return InnerBackend(name="torch", init=_no_init, refresh=_no_refresh,
                        run=run)


def make_inner_gram(loss: Loss, X: Tensor, y: Tensor, h: int,
                    unpen_idx: int = -1,
                    sample_w: Tensor | None = None) -> InnerBackend:
    """Covariance-update backend: O(k_max) coordinate steps (LS only). The
    unpenalized slot needs no Gram handling of its own: it is always
    resident, so its row and column of G stay valid. ``sample_w`` folds
    into the carry (G = Xa^T diag(w) Xa, rho = Xa^T diag(w) y): only the
    carry builds and the dual tail see it. The sweep is
    :func:`~repro_torch.kernels.gram.gram.gram_sweep`: its plain loop on
    the CPU, kernel K6 on the card.

    Every product runs on the live slots alone (:func:`_live`), so its
    shapes, and on a card its summation order, do not depend on the
    capacity: a fleet row is its serial solve bit for bit whatever the two
    capacities. Entries of G off the live block are zero or stale (finite:
    products of finite columns); the sweep reads none of them through a
    live term."""
    from repro_torch.kernels.gram.gram import gram_sweep

    if loss.name != "least_squares":
        raise ValueError("the gram inner backend needs a linear gradient "
                         f"(least squares); got loss {loss.name!r}")
    _no_weights_with_unpen(unpen_idx, sample_w)
    x_unpen = (aset_lib.columns(X, unpen_idx) if unpen_idx >= 0
               else None)

    def _wgt(cols):
        return cols if sample_w is None else sample_w[:, None] * cols

    def _rebuild(aset, Xa):
        live = _live(aset)
        Xl = Xa[:, live]
        k = aset.mask.shape[0]
        G = Xa.new_zeros((k, k))
        G[live[:, None], live[None, :]] = Xl.T @ _wgt(Xl)
        rho = Xa.new_zeros(k)
        rho[live] = _wgt(Xl).T @ y
        return InnerCarry(G=G, rho=rho,
                          gidx=torch.where(aset.mask, aset.idx, -1))

    def init(aset, carry, Xa):
        # the only place a full O(n k^2) build can happen
        gidx = torch.where(aset.mask, carry.gidx, -1)
        dirty = aset.mask & (gidx != aset.idx)
        if bool(dirty.any()):
            make_inner_gram.rebuilds += 1
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
        cols = _wgt(aset_lib.columns(X, ids))
        live = _live(aset)
        Xl = Xa[:, live]
        G = carry.G.clone()
        G[live[:, None], slots[None, :]] = Xl.T @ cols
        G[slots[:, None], live[None, :]] = cols.T @ Xl
        rho = carry.rho.clone()
        rho[slots] = cols.T @ y
        gidx = gidx.clone()
        gidx[slots] = ids
        return InnerCarry(G=G, rho=rho, gidx=gidx)

    def run(carry, aset, Xa, lam, n_ep):
        pen = _pen(aset, unpen_idx, X.dtype)
        beta = gram_sweep(carry.G, carry.rho, aset.beta, aset.mask, lam,
                          aset.order, aset.count, n_ep,
                          smoothness=loss.smoothness, pen=pen)
        return _gram_tail(loss, Xa, y, _live(aset), lam, beta, pen, x_unpen,
                          sample_w)

    return InnerBackend(name="gram", init=init, refresh=refresh, run=run)


# full O(n k^2) carry builds so far (a warm handoff that keeps its slots
# needs none); a plain counter for the CV smoke's report
make_inner_gram.rebuilds = 0


def _live(aset: ActiveSet) -> Tensor:
    """The live slots of a serial active set in sweep order
    (``order[:count]``)."""
    return aset.order[:aset.count]


def _gram_tail(loss, Xa, y, live, lam, beta, pen=None, x_unpen=None,
               sample_w=None) -> InnerOut:
    """The Gram backend's post-sweep tail on the ``live`` slots (see
    :func:`_live`): z once per burst (its only O(n k) term), the dual
    point and the gap. A fleet whose sweeps ran in one K6b launch calls it
    per problem, as the serial burst does."""
    if live.numel() == 0:       # no live slot: one zero column stands in
        Xa, bl = Xa.new_zeros((Xa.shape[0], 1)), beta.new_zeros(1)
        pen = None if pen is None else pen[:1]
    else:
        Xa, bl = Xa[:, live], beta[live]
        pen = None if pen is None else pen[live]
    z = Xa @ bl
    theta, gap = _dual_and_gap(loss, Xa, y, bl, z, None, lam, pen,
                               x_unpen, sample_w)
    return InnerOut(beta=beta, z=z, theta=theta, gap=gap)


def gram_block_update(G: Tensor, rho: Tensor, gidx: Tensor,
                      rows_new: Tensor, y_new: Tensor, rows_old: Tensor,
                      y_old: Tensor, live: Optional[Tensor] = None):
    """Rank-m streaming update/downdate of a resident Gram carry: replace
    the (m, p) rows ``rows_old`` (responses ``y_old``) with ``rows_new``
    (``y_new``) in the active-block state,

        G   += C_new^T C_new - C_old^T C_old
        rho += C_new^T y_new - C_old^T y_old

    where ``C = rows[:, gidx]`` gathers the per-slot feature columns of
    the row block. Only the live slots (``gidx >= 0``; ``live``: their
    slot ids, found here when None, which reads their count on the host)
    are gathered and updated: the products' shapes follow the live count,
    not the capacity, and every other entry of G and rho is left as it
    was (stale entries are allowed: ``init`` / ``refresh`` never read a
    slot before reconciling it). An append-only stream passes zero rows
    as ``rows_old``/``y_old``, an exact no-op on the subtracted terms.

    ``gidx`` is returned unchanged: live slots keep ``gidx == idx``, so
    the warm re-solve's ``init`` finds no dirty slot and keeps the
    updated carry without the O(n k^2) rebuild."""
    if live is None:
        live = torch.nonzero(gidx >= 0).flatten()
    ids = gidx[live]
    c_new, c_old = rows_new[:, ids], rows_old[:, ids]
    G2, rho2 = G.clone(), rho.clone()
    G2[live[:, None], live[None, :]] += c_new.T @ c_new - c_old.T @ c_old
    rho2[live] += c_new.T @ y_new - c_old.T @ y_old
    return G2, rho2


def make_inner_cuda(loss: Loss, X: Tensor, y: Tensor, col_norm: Tensor,
                    unpen_idx: int = -1) -> InnerBackend:
    """Kernel backend: one K3 launch per burst, on the transposed active
    block gathered straight from X; K3's ``_pen`` entries with an
    unpenalized slot."""
    from repro_torch.kernels.cm.cm import cm_burst_pen_xt, cm_burst_xt

    def run(carry, aset, Xa, lam, n_ep):
        XaT = torch.where(aset.mask[:, None],
                          aset_lib.columns_t(X, aset.idx),
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
    """Serial inner backend by resolved name (unweighted)."""
    if name == "gram":
        return make_inner_gram(loss, X, y, h, unpen_idx)
    if name == "cuda":
        return make_inner_cuda(loss, X, y, col_norm, unpen_idx)
    return make_inner_torch(loss, X, y, unpen_idx)


# --------------------------------------------------------------------------
# fleet backends (core/batch.py): B problems over one shared design
# --------------------------------------------------------------------------
# ``torch`` is map-fused: each problem runs the SERIAL backend built for its
# own response, h and sample weights, so its burst, dual point and gap are
# the literal serial computation. ``gram`` keeps the per-problem carries and
# tails but runs the sweeps of every live problem in one K6b call, and
# ``cuda`` is the problem-gridded kernel K3b; both kernels run their serial
# kernel's body per CTA (their plain versions the serial loop per problem),
# so a fleet burst is bitwise a serial burst.


class BatchInnerBackend(NamedTuple):
    """The fleet inner interface the engine consumes:

      * ``make_one(y_b, h_b, w_b) -> InnerBackend`` — the serial backend
        of one problem (torch, gram); with no ``fleet_step`` each live
        problem runs its burst (map-fused), gram keeps it for the carry
        refresh;
      * ``fleet_step(problems, n_eps) -> ([InnerOut], [Xa])`` — one launch
        for the bursts of the live ``problems`` (the engine's per-problem
        states), each with its epoch count; returns each problem's burst
        and its gathered (n, k_max) block, and refreshes the problems'
        carries in place (cuda: K3b; gram: K6b).

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


def _fleet_init(make_one, Y, hs, weights):
    """Per-problem init of the serial backends (the only place a Gram
    carry is built in full)."""
    ws = [None] * len(Y) if weights is None else weights

    def init(asets, carries, Xas):
        return [make_one(y, h, w).init(a, c, Xa)
                for y, h, w, a, c, Xa in zip(Y, hs, ws, asets, carries, Xas)]
    return init


def make_batch_inner_torch(loss: Loss, X: Tensor, Y, hs,
                           weights=None) -> BatchInnerBackend:
    """Fleet plain backend: the serial residual-update backend per problem
    (``Y``: the per-problem responses, ``hs``: their batch sizes,
    ``weights``: their sample weights or None)."""
    def make_one(y, h, w=None):
        return make_inner_torch(loss, X, y, sample_w=w)
    return BatchInnerBackend(name="torch",
                             init=_fleet_init(make_one, Y, hs, weights),
                             make_one=make_one)


def make_batch_inner_gram(loss: Loss, X: Tensor, Y, hs,
                          weights=None) -> BatchInnerBackend:
    """Fleet covariance-update backend: the serial Gram backend per problem
    (``make_one``: its carry init and refresh), each with its own
    (k_max, k_max) carry (weighted by its own sample weights) and its own
    refresh bound h. One K6b call per outer step runs the sweeps of every
    live problem (on CPU tensors its plain version, the serial sweep per
    problem); the tails stay per problem, as in the serial burst."""
    from repro_torch.kernels.gram.gram import gram_sweep_batch

    def make_one(y, h, w=None):
        return make_inner_gram(loss, X, y, h, sample_w=w)

    def fleet_step(probs, n_eps):
        Xas = aset_lib.gather_columns_batch(X, [q.aset for q in probs])
        for q, Xa in zip(probs, Xas):
            q.carry = q.inner.refresh(q.carry, q.aset, Xa)
        asets = [q.aset for q in probs]
        meta = torch.tensor([n_eps, [a.count for a in asets]],
                            dtype=torch.int32).to(X.device)
        beta = gram_sweep_batch(
            torch.stack([q.carry.G for q in probs]),
            torch.stack([q.carry.rho for q in probs]),
            torch.stack([a.beta for a in asets]),
            torch.stack([a.mask for a in asets]),
            torch.stack([q.lam for q in probs]),
            torch.stack([a.order for a in asets]), meta[1], meta[0],
            smoothness=loss.smoothness)
        # each problem's own contiguous tensors, for its serial tail
        return [_gram_tail(loss, Xa, q.y, _live(q.aset), q.lam,
                           beta[j].clone(), sample_w=q.w)
                for j, (q, Xa) in enumerate(zip(probs, Xas))], Xas

    return BatchInnerBackend(name="gram",
                             init=_fleet_init(make_one, Y, hs, weights),
                             make_one=make_one, fleet_step=fleet_step)


def make_batch_inner_cuda(loss: Loss, X: Tensor, col_norm: Tensor,
                          weights=None) -> BatchInnerBackend:
    """Fleet kernel backend: one K3b launch per outer step for the bursts of
    every live problem. The blocks are gathered transposed straight from X
    in one gather; lambda, the epoch counts and the live-slot counts reach
    the kernel as per-problem device arrays. Like the reference's pallas
    fleet backend it takes no sample weights."""
    from repro_torch.kernels.cm.cm import cm_burst_batch_xt

    if weights is not None:
        raise ValueError("the batched cuda inner backend does not take "
                         "sample weights; use 'torch' or 'gram' for CV "
                         "fleets")
    def fleet_step(probs, n_eps):
        asets = [q.aset for q in probs]
        idx = torch.stack([a.idx for a in asets])
        mask = torch.stack([a.mask for a in asets])
        AT = torch.where(mask[:, :, None], aset_lib.columns_t(X, idx), 0.0)
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
        return ([InnerOut(beta=beta[j].clone(), z=z[j],
                          theta=theta[j].clone(), gap=gap[j])
                 for j in range(len(probs))],
                aset_lib.gather_columns_batch(X, asets))

    return BatchInnerBackend(name="cuda",
                             init=lambda asets, carries, Xas: carries,
                             fleet_step=fleet_step)


def make_batch_inner(name: str, loss: Loss, X: Tensor, Y, col_norm: Tensor,
                     hs, weights=None) -> BatchInnerBackend:
    """Fleet inner backend by resolved name; ``weights`` the problems'
    sample weights (B rows) or None."""
    if name == "gram":
        return make_batch_inner_gram(loss, X, Y, hs, weights)
    if name == "cuda":
        return make_batch_inner_cuda(loss, X, col_norm, weights)
    return make_batch_inner_torch(loss, X, Y, hs, weights)


# n/k_max crossover of the auto policy, the reference's: the gram step is an
# O(k_max) axpy against ~3 O(n) passes of the residual step. On the card too
# least squares takes the Gram engine (K6) under it, as the reference does on
# every backend.
GRAM_CROSSOVER = 4.0


def resolve_inner_backend(name: str, loss_name: str, n: int, k_max: int,
                          device: torch.device, itemsize: int = 8,
                          unpen: bool = False,
                          n_pad: Optional[int] = None) -> str:
    """Inner-backend policy: an explicit name wins. ``auto`` takes the
    reference's choice first: the Gram engine for least squares while
    GRAM_CROSSOVER * n >= k_max (on a CUDA device, kernel K6, which also
    needs its shared memory, ``gram_smem_ok``; the fused solve's
    unpenalized slot rides in K6's ``pen``). Otherwise, on a CUDA device,
    the K3 kernel while the burst fits its shared memory (``cm_smem_ok``;
    ``unpen``: with the unpenalized slot's weights), and on the CPU the
    plain path. A burst that fits neither raises on a CUDA device, under
    ``auto`` as under ``cuda``: the plain path there is a host loop that
    the caller must ask for by name.

    A bucket-padded problem routes on its real rows ``n`` while the
    kernel's shared-memory gate reads the rows it is handed, ``n_pad``
    (default ``n``): a route that the padded block does not fit raises."""
    from repro_torch.kernels.cm.cm import cm_smem_ok
    from repro_torch.kernels.gram.gram import gram_smem_ok

    ls = loss_name == "least_squares"
    on_card = torch.device(device).type == "cuda"
    if name == "auto":
        gram = ls and GRAM_CROSSOVER * n >= k_max
        if not on_card:
            return "gram" if gram else "torch"
        name = ("gram" if gram and gram_smem_ok(k_max, itemsize)
                else "cuda")
    if name not in ("torch", "gram", "cuda"):
        raise ValueError(f"unknown inner backend {name!r}")
    if name == "gram" and not ls:
        raise ValueError("inner_backend='gram' requires loss='least_squares'"
                         " (covariance updates need a linear gradient); use"
                         " 'torch' or 'cuda'")
    if name == "gram" and on_card and not gram_smem_ok(k_max, itemsize):
        raise ValueError(
            f"Gram inner backend: capacity {k_max} exceeds the Gram-sweep "
            f"kernel's shared-memory budget; shrink k_max, or pass "
            f"inner_backend='torch' (a host loop on the card)")
    rows = n if n_pad is None else n_pad
    if name == "cuda" and not cm_smem_ok(rows, k_max, itemsize, unpen):
        raise ValueError(
            f"CUDA inner backend: a {rows}x{k_max} active block exceeds the "
            f"CM kernel's shared-memory budget; shrink k_max, or pass "
            f"inner_backend='torch' (a host loop on the card) or, for "
            f"least squares, 'gram'")
    return name
