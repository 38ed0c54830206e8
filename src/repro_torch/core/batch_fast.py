"""The fast-parity fleet engine (``SaifConfig(parity="fast")``, least
squares): port of ``repro/core/batch.py:461-931`` (``_saif_batch_fast_jit``
and its helpers) and of the fast preparation (``:963-983``,
``:1089-1104``).

The bitwise engine (``core/batch.py``) buys byte-for-byte serial equality
by running every float path per problem in the serial order. This engine
is the opt-in other half of the trade (the reference's DESIGN.md §11):

  * **batch-axis ops** — bursts, dual points, gaps, balls and DEL
    certificates are (B, ...) tensor ops, one launch each for the fleet;
  * **a lockstep Gram sweep** — every problem sweeps the slots [0, hi) of
    its own highest live slot in slot order (no ``order`` upkeep: slots
    are placed by rank), through K6b with the identity order on a card;
    a dead slot's step is the identity, so this is the reference's sweep
    over the fleet's [0, hi);
  * **the certified mixed-precision screen** —
    :func:`~repro_torch.core.screen_backend.make_batch_screen_fast` (K1b
    in its bf16 / f32-input mode on a card), whose radius is widened by
    the rounding bound of its precision before any bound is formed;
  * **the Gram reconcile only when something changed** — after a step
    with no ADD and no post-check recruit nothing is dirty, so the refresh
    is skipped, and dead slots drop their feature id (``gidx = -1``) every
    step so that a feature dropped and added back is seen as dirty.

What it may never do: skip a certificate, narrow a ball, take a DEL or
ADD-stop decision on unwidened low-precision bounds (DEL's correlations
carry the working-precision gamma), mix problems, or end a row without
its working-precision gap. Acceptance is supports + gap <= eps + a
passing KKT residual, not bitwise trajectories.

The reference's ``lax.cond`` on ``jnp.any(..)`` become host reads of flags
the host needs anyway: one read an outer step (stop flags, the ADD mask,
overflow flags), one more for a low-precision screen's escalation
decision, one more for the hybrid rule's post-check. The epoch budgets,
lambdas and the sweep ranges stay on the device. A problem whose ADD
overflows the capacity ends the pass (the caller regrows every problem
from its cold start, as the reference does after running the pass out).
On a card the capacity must fit K6b's shared memory (``gram_smem_ok``),
else the engine raises; the reference has no such gate.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.core import active_set as aset_lib
from repro_torch.core.active_set import ActiveSet
from repro_torch.core.duality import mixed_precision_gamma, widened_radius
from repro_torch.core.inner_backend import InnerCarry, _dual_and_gap
from repro_torch.core.losses import get_loss
from repro_torch.core.saif import (SaifConfig, SaifResult, certify,
                                   del_mask)
from repro_torch.core.screen_backend import (fleet_col_norms,
                                             make_batch_screen_fast)

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# batched active-set edits without ``order`` upkeep
# ---------------------------------------------------------------------------

def _scatter_sink(t: Tensor, index: Tensor, src, dim_size: int) -> Tensor:
    """``t`` (B, dim_size) with ``src`` scattered at ``index`` along dim 1,
    where an index of ``dim_size`` is dropped (the reference's
    ``mode="drop"``): scattered into a sink column that is cut off."""
    ext = torch.cat([t, t[:, :1]], dim=1)
    ext.scatter_(1, index, src)
    return ext[:, :dim_size].contiguous()


def _delete_features_fast(aset: ActiveSet, drop: Tensor) -> ActiveSet:
    """Batched DEL (``repro/core/batch.py:481``): clear the flagged live
    slots; ``order`` is not kept (the sweep visits a slot range)."""
    p = aset.in_active.shape[1]
    drop = drop & aset.mask
    return aset._replace(
        mask=aset.mask & ~drop, beta=torch.where(drop, 0.0, aset.beta),
        in_active=_scatter_sink(aset.in_active,
                                torch.where(drop, aset.idx, p), False, p),
        count=aset.count - drop.sum(dim=1, dtype=torch.int32))


def _add_features_fast(aset: ActiveSet, cand_idx: Tensor,
                       cand_keep: Tensor) -> ActiveSet:
    """Batched ADD (``repro/core/batch.py:505``): the c-th kept candidate
    into the c-th free slot by slot id, as the serial ADD places them."""
    b, k = aset.mask.shape
    p = aset.in_active.shape[1]
    free = ~aset.mask
    free_i = free.to(torch.int32)
    free_rank = torch.cumsum(free_i, dim=1) - free_i
    n_free = free_i.sum(dim=1)
    keep_i = cand_keep.to(torch.int32)
    cand_rank = torch.cumsum(keep_i, dim=1) - keep_i
    n_want = keep_i.sum(dim=1)
    placed = cand_keep & (cand_rank < n_free[:, None])
    order_key = torch.where(free, free_rank, k + 1)
    slot_of_rank = torch.argsort(order_key, dim=1, stable=True)
    target = torch.gather(slot_of_rank, 1,
                          torch.clamp(cand_rank, 0, k - 1).long())
    target = torch.where(placed, target, k)
    ids = cand_idx.long()
    return aset._replace(
        idx=_scatter_sink(aset.idx, target, ids, k),
        mask=_scatter_sink(aset.mask, target, True, k),
        beta=_scatter_sink(aset.beta, target, 0.0, k),
        in_active=_scatter_sink(aset.in_active,
                                torch.where(placed, ids, p), True, p),
        overflowed=aset.overflowed | (n_want > n_free),
        count=aset.count + placed.sum(dim=1, dtype=torch.int32))


# ---------------------------------------------------------------------------
# Gram upkeep and the lockstep sweep
# ---------------------------------------------------------------------------

def _weighted(cols: Tensor, W: Optional[Tensor]) -> Tensor:
    return cols if W is None else cols * W[:, :, None]


def _gram_rebuild_fast(X: Tensor, Y: Tensor, W: Optional[Tensor],
                       aset: ActiveSet):
    """Full batched Gram build at the fleet's start
    (``repro/core/batch.py:539``): G = Xa^T diag(w) Xa, rho = Xa^T diag(w)
    y per problem. Returns the carry and the gathered blocks."""
    Xa = aset_lib.gather_columns_stacked(X, aset)
    Xw = _weighted(Xa, W).transpose(1, 2)
    return InnerCarry(G=torch.bmm(Xw, Xa),
                      rho=torch.bmm(Xw, Y[:, :, None])[:, :, 0],
                      gidx=torch.where(aset.mask, aset.idx, -1)), Xa


def _gram_refresh_fast(X: Tensor, Y: Tensor, W: Optional[Tensor],
                       carry: InnerCarry, aset: ActiveSet, Xa: Tensor,
                       h: int) -> InnerCarry:
    """Per-step batched Gram reconcile (``repro/core/batch.py:550``): at
    most ``h`` slots per problem changed feature since the last step;
    their rows, columns and rho entries are recomputed from ``h`` gathered
    columns against the step's blocks ``Xa``. Each problem's dirty slots
    come first in slot order by a stable sort of the dirty flags (the
    reference's ``nonzero(size=h, fill_value=k)``); the fill entries
    scatter into a sink row and column that is cut off. Dead slots keep
    stale, finite entries (products of finite columns): their beta is
    zero, so no live step reads them."""
    b, k = aset.idx.shape
    hs = min(h, k)
    gidx = torch.where(aset.mask, carry.gidx, -1)
    dirty = aset.mask & (gidx != aset.idx)
    slots = torch.sort((~dirty).to(torch.int8), dim=1,
                       stable=True).indices[:, :hs]
    target = torch.where(torch.gather(dirty, 1, slots), slots, k)
    ids = torch.gather(aset.idx, 1, slots)
    cols = _weighted(X.index_select(1, ids.reshape(-1)).reshape(
        -1, b, hs).permute(1, 0, 2), W)                    # (B, n, hs)
    Gblk = torch.bmm(Xa.transpose(1, 2), cols)             # (B, k, hs)
    G = torch.nn.functional.pad(carry.G, (0, 1, 0, 1))
    G[:, :k, :].scatter_(2, target[:, None, :].expand(b, k, hs), Gblk)
    G[:, :, :k].scatter_(1, target[:, :, None].expand(b, hs, k),
                         Gblk.transpose(1, 2))
    rho = _scatter_sink(carry.rho, target, torch.bmm(
        cols.transpose(1, 2), Y[:, :, None])[:, :, 0], k)
    return InnerCarry(G=G[:, :k, :k].contiguous(), rho=rho,
                      gidx=torch.where(aset.mask, aset.idx, -1))


def _gram_sweep_fast(G: Tensor, rho: Tensor, beta: Tensor, mask: Tensor,
                     lam: Tensor, n_ep: Tensor, order: Tensor,
                     smoothness: float = 1.0, plain: bool = False) -> Tensor:
    """Lockstep covariance-update sweeps (``repro/core/batch.py:586``):
    problem b sweeps its slots [0, hi_b) in slot order ``n_ep[b]`` times
    (0: frozen, beta kept), dead slots gated to zero. ``hi_b`` is one past
    its highest live slot, on the device; ``order`` the identity (B, k)
    int32. Runs :func:`~repro_torch.kernels.gram.gram.gram_sweep_batch`:
    kernel K6b on a card, its plain loop on the CPU (``plain``: anywhere).
    Returns beta."""
    from repro_torch.kernels.gram.gram import gram_sweep_batch
    from repro_torch.kernels.gram.ref import gram_sweep_batch_ref
    k = beta.shape[1]
    hi = torch.amax(torch.where(mask, torch.arange(
        1, k + 1, device=mask.device, dtype=torch.int32), 0), dim=1)
    sweep = gram_sweep_batch_ref if plain else gram_sweep_batch
    return sweep(G, rho, beta, mask, lam, order, hi, n_ep,
                 smoothness=smoothness)


# ---------------------------------------------------------------------------
# dual points, gaps and certificates, batched (least squares)
# ---------------------------------------------------------------------------

class _Cert(NamedTuple):
    center: Tensor     # (B, n) ball center
    r_eff: Tensor      # (B,) the ADD screen's radius
    stop_now: Tensor   # (B,) bool
    del_row: Tensor    # (B, k) bool
    dual_val: Tensor   # (B,)
    radius: Tensor     # (B,) the raw safe radius (the post-check's)


def _certify(loss, Y, W, g0, theta, gap, lam, eps, delta, is_add, Xa, aset,
             cn, c0, use_seq, rule, gamma_work) -> _Cert:
    """The serial certificate (:func:`~repro_torch.core.saif.certify`: the
    gap-safe ball, intersected with Thm 2's under ``use_seq``) and DEL rule
    (:func:`~repro_torch.core.saif.del_mask`) on the stacked fleet, with
    DEL's radius widened by the working-precision dot bound
    (``repro/core/batch.py:691-736``)."""
    center, r_eff, radius = certify(loss, Y, g0, theta, gap, lam, delta,
                                    aset, c0, use_seq, rule)
    del_row = del_mask(aset, Xa, center,
                       widened_radius(radius, center, gamma_work), cn)
    conj = loss.conj(-lam[:, None] * theta, Y)
    dual_val = -torch.sum(conj if W is None else W * conj, dim=1)
    return _Cert(center, r_eff, ~is_add & (gap <= eps), del_row, dual_val,
                 radius)


def _newton_fleet(loss, carry, aset, Xa, Y, W, lam, beta, theta, gap,
                  polishing):
    """The hybrid rule's working-set Newton polish as one masked (B, k, k)
    solve (``repro/core/batch.py:780-810``); a problem keeps the proposal
    only where it polishes and its certified gap is smaller."""
    m = aset.mask & (beta != 0.0)
    mf = m.to(beta.dtype)
    Gm = (carry.G * (mf[:, :, None] * mf[:, None, :])
          + torch.diag_embed(1.0 - mf))
    rhs = (carry.rho - lam[:, None] * torch.sign(beta)) * mf
    # solve_ex: a singular system yields junk, which the gap rejects
    b_n = torch.where(m, torch.linalg.solve_ex(Gm, rhs)[0], 0.0)
    z_n = torch.bmm(Xa, b_n[:, :, None])[:, :, 0]
    th_n, gap_n = _dual_and_gap(loss, Xa, Y, b_n, z_n, m, lam, sample_w=W)
    better = polishing & (gap_n < gap)
    bc = better[:, None]
    return (torch.where(bc, b_n, beta), torch.where(bc, th_n, theta),
            torch.where(better, gap_n, gap))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def solve_fleet_fast(prep, lams, config: SaifConfig, *, hs, h: int,
                     k_max: int, init_idx: Tensor, init_beta: Tensor,
                     init_mask: Tensor, use_seq: bool, rule,
                     delta0, pad_mask: Optional[Tensor] = None
                     ) -> SaifResult:
    """One pass of the fast fleet at capacity ``k_max`` (the reference's
    ``_saif_batch_fast_jit``): the outer loop as a host loop of batch-axis
    ops over the (B, ...) state. Returns a :class:`SaifResult` whose every
    field has a leading B. ``solve_fleet_fast.stats`` holds the pass's
    outer steps, host reads, screen calls, rows screened and escalated.

    The kernels run on a card: K1b (mixed mode for a low-precision
    ``screen_dtype``) with K2b for the screen, K6b for the sweep. An
    explicit ``screen_backend="torch"`` / ``inner_backend="torch"`` takes
    the screen's / the sweep's plain version instead, on any device.
    ``pad_mask`` (p,) flags a padded preparation's bucket-pad columns,
    born active without a slot in every problem."""
    from repro_torch.kernels.gram.gram import gram_smem_ok

    loss = get_loss(config.loss)
    X, Y, W = prep.X, prep.Y, prep.W
    n, p = X.shape
    b = Y.shape[0]
    dt, dev = X.dtype, X.device
    if (dev.type == "cuda" and config.inner_backend != "torch"
            and not gram_smem_ok(k_max, X.element_size())):
        raise ValueError(
            f"the fast fleet sweeps by the Gram kernel K6b, whose shared "
            f"memory takes no capacity of {k_max} ({dt}); shrink k_max or "
            f"use parity='bitwise'")
    lam = torch.tensor(lams, dtype=dt, device=dev)
    h_tilde = torch.tensor([max(int(math.ceil(config.zeta * h_b)), 1)
                            for h_b in hs], device=dev)[:, None]
    h_cap = torch.tensor(hs, device=dev)[:, None]
    delta = torch.tensor(delta0, dtype=dt, device=dev)
    screen = make_batch_screen_fast(X, prep.col_norm, h, config.screen_dtype,
                                    plain=config.screen_backend == "torch")
    plain_sweep = config.inner_backend == "torch"
    low = config.screen_dtype != "working"
    gamma_work = mixed_precision_gamma(n, dt, dt)
    cn = fleet_col_norms(prep.col_norm, b)
    eps = config.eps
    g0 = loss.grad(torch.zeros_like(Y), Y)
    ranks = torch.arange(h, device=dev)
    order = torch.arange(k_max, dtype=torch.int32, device=dev).expand(
        b, -1).contiguous()
    K, pf = config.inner_epochs, config.polish_factor

    aset = aset_lib.init_active_set_stacked(p, k_max, init_idx, dt,
                                            init_beta, init_mask)
    if pad_mask is not None:
        aset = aset._replace(in_active=aset.in_active | pad_mask)
    carry, _ = _gram_rebuild_fast(X, Y, W, aset)
    is_add = torch.ones(b, dtype=torch.bool, device=dev)
    gap = torch.full((b,), math.inf, dtype=dt, device=dev)
    tr = {k: torch.full((b, config.max_outer), -1.0, dtype=dt, device=dev)
          for k in ("n_active", "gap", "dual")}
    tr.update({k: torch.full((b, config.max_outer), -1, dtype=torch.int32,
                             device=dev)
               for k in ("screened", "survivors", "post_viol")})
    stop, t = [False] * b, [0] * b
    stats = {"steps": 0, "host_reads": 0, "screens": 0, "rows_screened": 0,
             "escalated_rows": 0}
    refresh = False
    neg1 = torch.full((b,), -1, dtype=torch.int32, device=dev)
    for s in range(config.max_outer):
        live_l = [not st for st in stop]
        if not any(live_l):
            break
        live = torch.tensor(live_l, device=dev)
        n_ep = (torch.where(is_add, K, K * pf) * live).to(torch.int32)

        # --- lockstep inner burst (Gram form)
        Xa = aset_lib.gather_columns_stacked(X, aset)
        if refresh:
            carry = _gram_refresh_fast(X, Y, W, carry, aset, Xa, h)
        else:       # nothing is dirty; dead slots still drop their id
            carry = carry._replace(gidx=torch.where(aset.mask, carry.gidx,
                                                    -1))
        beta = _gram_sweep_fast(carry.G, carry.rho, aset.beta, aset.mask,
                                lam, n_ep, order, loss.smoothness,
                                plain_sweep)
        theta, gap_new = _dual_and_gap(
            loss, Xa, Y, beta, torch.bmm(Xa, beta[:, :, None])[:, :, 0],
            aset.mask, lam, sample_w=W)
        if rule.newton_polish:
            beta, theta, gap_new = _newton_fleet(
                loss, carry, aset, Xa, Y, W, lam, beta, theta, gap_new,
                live & ~is_add)
        # a frozen problem keeps its gap (its sweep ran no epoch)
        gap = torch.where(live, gap_new, gap)
        cert = _certify(loss, Y, W, g0, theta, gap, lam, eps, delta, is_add,
                        Xa, aset, cn, prep.c0, use_seq, rule, gamma_work)
        aset = aset._replace(beta=beta)

        # --- DEL (widened gap-safe rule), then the host read of the step
        aset = _delete_features_fast(
            aset, cert.del_row & (live & ~cert.stop_now)[:, None])
        do_add = live & ~cert.stop_now
        if rule.add_bound != "point":
            do_add = do_add & is_add
        stop_now_l, do_add_l, over_l = torch.stack(
            (cert.stop_now, do_add, aset.overflowed)).tolist()
        stats["host_reads"] += 1
        if any(over_l):
            break           # the caller regrows: this pass is discarded

        # --- ADD phase
        n_scr = n_sur = neg1
        if any(do_add_l):
            out = screen(cert.center, cert.r_eff, aset.in_active, do_add)
            stats["screens"] += 1
            stats["host_reads"] += low      # the escalation decision
            stats["rows_screened"] += sum(do_add_l)
            n_scr = torch.where(do_add, (~aset.in_active).sum(
                dim=1, dtype=torch.int32) - out.n_surv, -1)
            n_sur = torch.where(do_add, out.n_surv, -1)
            add_done = out.max_ub < 1.0
            v_count = torch.clamp(out.cand_ge - 1 - ranks, min=0)
            keep = ((v_count < h_tilde) & (ranks < h_cap)
                    & torch.isfinite(out.cand_score))
            if rule.add_bound == "point":
                keep = keep & (out.cand_score >= 1.0)
            keep = torch.cumprod(keep.to(torch.int32), dim=1).bool()
            keep[:, 0] |= (gap <= 100.0 * eps) & torch.isfinite(
                out.cand_score[:, 0])
            aset = _add_features_fast(aset, out.cand_idx,
                                      keep & (do_add & ~add_done)[:, None])
            done = do_add & add_done
            if rule.delta_ramp:
                grown = torch.clamp(10.0 * delta, max=1.0)
                off = done & (delta >= 1.0)
                delta = torch.where(done & (delta < 1.0), grown, delta)
                is_add = is_add & ~off
            else:
                is_add = is_add & ~done

        # --- safe post-check (hybrid rule): the widened screen at the raw
        #     safe radius gates every stop; violators are recruited
        stop_final = stop_now_l
        post_viol = neg1
        checking = [a and b_ for a, b_ in zip(stop_now_l, live_l)]
        checked = rule.post_check and any(checking)
        if checked:
            do_check = live & cert.stop_now
            chk = screen(cert.center, cert.radius, aset.in_active, do_check)
            stats["screens"] += 1
            stats["host_reads"] += low
            stats["rows_screened"] += sum(checking)
            viol = do_check & (chk.max_ub >= 1.0)
            ub_c = chk.cand_score + torch.gather(
                cn, 1, torch.clamp(chk.cand_idx, max=p - 1)) * \
                cert.radius[:, None]
            keep = (viol[:, None] & torch.isfinite(chk.cand_score)
                    & (ub_c >= 1.0))
            keep[:, 0] = viol & torch.isfinite(chk.cand_score[:, 0])
            aset = _add_features_fast(aset, chk.cand_idx, keep)
            post_viol = torch.where(do_check, viol.to(torch.int32), -1)
            viol_l = viol.tolist()
            stats["host_reads"] += 1
            stop_final = [a and not v for a, v in zip(stop_now_l, viol_l)]
        refresh = any(do_add_l) or checked

        # --- traces (the step's column, live problems only)
        for key, val in (("n_active", aset.count.to(dt)), ("gap", gap),
                         ("dual", cert.dual_val), ("screened", n_scr),
                         ("survivors", n_sur), ("post_viol", post_viol)):
            tr[key][:, s] = torch.where(live, val, tr[key][:, s])
        for i in range(b):
            if live_l[i]:
                t[i] += 1
                stop[i] = stop_final[i]
        stats["steps"] = s + 1
    stats["escalated_rows"] = screen.escalated
    solve_fleet_fast.stats = stats
    return SaifResult(
        beta=aset_lib.scatter_beta_stacked(aset, p), gap=gap,
        n_outer=torch.tensor(t, device=dev), n_active=aset.count.long(),
        overflowed=aset.overflowed, trace_n_active=tr["n_active"],
        trace_gap=tr["gap"], trace_dual=tr["dual"], active_idx=aset.idx,
        active_mask=aset.mask, inner=carry,
        trace_screened=tr["screened"], trace_survivors=tr["survivors"],
        trace_post_viol=tr["post_viol"])


solve_fleet_fast.stats = {}


# ---------------------------------------------------------------------------
# the fast preparation
# ---------------------------------------------------------------------------

def prepare_fleet_stats_fast(X: Tensor, Y: Tensor, W: Optional[Tensor],
                             loss):
    """The fast preparation's device side (``repro/core/batch.py:964-983``):
    c0 = |(w *) f'(0) X| as one product for the fleet (the §11
    re-association), the column norms, and per problem max c0 (working
    precision: it is lambda_max and feeds delta0 and the Thm-2 ball) and
    the median of the float32-cast c0 (it only buckets the h formula).
    Returns (c0, col_norm, [max], [median]) after one host read."""
    G0 = loss.grad(torch.zeros_like(Y), Y)
    if W is not None:
        G0 = W * G0
    c0 = torch.abs(G0 @ X)
    col_norm = (torch.linalg.vector_norm(X, dim=0) if W is None
                else torch.sqrt(W @ (X * X)))
    srt = torch.sort(c0.to(torch.float32), dim=1).values
    p = srt.shape[1]
    med = srt[:, p // 2] if p % 2 else (srt[:, p // 2 - 1]
                                        + srt[:, p // 2]) / 2
    mx, md = torch.stack((torch.amax(c0, dim=1), med.to(c0.dtype))).tolist()
    return c0, col_norm, mx, md
