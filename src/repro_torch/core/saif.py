"""SAIF — Safe Active Incremental Feature selection (paper Algorithms 1 & 2),
in torch (port of ``repro.core.saif``).

The reference runs the outer loop as one jitted ``lax.while_loop``; here it
is a host loop over device tensors, and its data-dependent branches are
Python ``if``s on values read back once or a few times per outer step. The
active set is the fixed-capacity buffer of :mod:`repro_torch.core.active_set`;
the only O(p) work per outer step is the screening scan (gated on the ADD
phase), done by a :data:`~repro_torch.core.screen_backend.ScreenFn`; the CM
burst, dual point and gap come from an
:class:`~repro_torch.core.inner_backend.InnerBackend`.

An unpenalized coordinate (``SaifConfig.unpen_idx``, fused LASSO's ``b``,
Thm 7) is pinned at slot 0 of the active set from its null fit ``b0``,
never DELed, unthresholded in the CM steps, and its equality constraint
shapes the dual point; the Thm-2 sequential ball and the hybrid rule's
Newton polish assume an all-penalized problem and are off then.

Entry points take ``device=None``, which means ``"cuda"``: without a card
they raise unless the caller asks for ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import active_set as aset_lib
from repro_torch.core.duality import (gap_ball, gap_precision_floor,
                                      intersect_balls, null_gradient,
                                      sequential_ball)
from repro_torch.core.inner_backend import (InnerCarry, _dual_and_gap,
                                            cold_inner_carry, make_inner,
                                            resolve_inner_backend)
from repro_torch.core.losses import get_loss, mv_last, per_problem
from repro_torch.core.screen_backend import (BatchScreenFn, ScreenFn,
                                             ScreenRule, make_screen_cuda,
                                             make_screen_from_scan,
                                             make_screen_torch,
                                             resolve_backend,
                                             resolve_screen_rule)
from repro_torch.runtime.inject import seam as _fault_seam

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SaifConfig:
    """Hyper-parameters of Algorithm 1/2 (paper defaults where given)."""
    eps: float = 1e-6            # stopping duality gap
    inner_epochs: int = 5        # K soft-threshold sweeps per outer step
    polish_factor: int = 8       # K multiplier once ADD has stopped
    c: float = 1.0               # ADD batch size constant (h formula)
    zeta: float = 1.0            # violation tolerance multiplier (h~ = zeta h)
    k_max: Optional[int] = None  # active-set capacity (None => auto)
    max_outer: int = 2000        # outer-loop guard / trace length
    delta0: Optional[float] = None  # initial radius factor (None => lam/lam_max)
    use_seq_ball: bool = True    # intersect Thm-2 ball with the gap ball
    loss: str = "least_squares"
    screen_backend: str = "auto"  # "auto" | "torch" | "cuda"
    inner_backend: str = "auto"   # "auto" | "torch" | "gram" | "cuda"
    unpen_idx: Optional[int] = None  # feature id exempt from the l1
    #   penalty (fused LASSO's always-resident b slot); None = plain LASSO
    screen_rule: str = "saif"     # "saif" | "gap_safe" | "hybrid"
    parity: str = "bitwise"       # fleets: "bitwise" (each problem is its
    #   serial solve, bit for bit) | "fast" (least squares: the lockstep
    #   engine of core/batch_fast.py; it may re-associate, every screening
    #   decision is widened by a certified rounding bound and every row
    #   ends certified in working precision)
    screen_dtype: str = "working"  # "working" | "float32" | "bfloat16": the
    #   fast fleet screen's input type (f32 sums, radius widened by the
    #   certified error bound); anything but "working" needs parity="fast"

    def __post_init__(self):
        if self.parity not in ("bitwise", "fast"):
            raise ValueError(
                f"parity must be 'bitwise' or 'fast', got {self.parity!r}")
        if self.screen_dtype not in ("working", "float32", "bfloat16"):
            raise ValueError(
                "screen_dtype must be 'working', 'float32' or 'bfloat16', "
                f"got {self.screen_dtype!r}")
        if self.screen_dtype != "working" and self.parity != "fast":
            raise ValueError(
                "screen_dtype != 'working' is a fast-parity feature: "
                "low-precision screening deviates from the bitwise serial "
                "float path; set parity='fast' to opt in")
        resolve_screen_rule(self.screen_rule)   # fail fast on unknown names


class SaifResult(NamedTuple):
    beta: Tensor             # (p,) full solution
    gap: Tensor              # final sub-problem duality gap
    n_outer: int             # outer iterations executed
    n_active: int            # final |A_t|
    overflowed: bool         # capacity overflow flag
    trace_n_active: Tensor   # (max_outer,) |A_t| per outer step (-1 pad)
    trace_gap: Tensor        # (max_outer,)
    trace_dual: Tensor       # (max_outer,)
    active_idx: Tensor       # (k_max,) final slot -> feature map
    active_mask: Tensor      # (k_max,) final slot validity
    inner: InnerCarry        # final inner-backend carry
    trace_screened: Tensor   # (max_outer,) int32, -1 where ADD did not run
    trace_survivors: Tensor  # (max_outer,) int32
    trace_post_viol: Tensor  # (max_outer,) int32, -1 where no post-check


def add_batch_size_static(c: float, lam: float, c0_max: float,
                          c0_median: float, p: int) -> int:
    """h = ceil(c log((md+mx)/lam) log p) — paper Sec 2.2, rounded up to
    the next power of two (the reference's compile bucket)."""
    h = math.ceil(max(c * math.log(max((c0_median + c0_max) / lam,
                                       1.0 + 1e-9))
                      * math.log(max(p, 2)), 1.0))
    h = 1 << (max(h, 1) - 1).bit_length()
    return max(min(h, p), 1)


def default_capacity(h: int, p: int) -> int:
    return int(min(p, max(8 * h, 64)))


def initial_support(c0: Tensor, h: int, k_max: int, p: int,
                    unpen_idx: Optional[int] = None, b0=0.0):
    """Cold-start support (Algorithm 1 line 1): the top-h' features by c0,
    ties to the lowest id. With an unpenalized coordinate it is pinned at
    slot 0, seeded at its null fit ``b0``, and kept out of the top-h'.
    Returns (init_idx (k_max,), init_beta (k_max,), n_init)."""
    dev = c0.device
    init_idx = torch.zeros(k_max, dtype=torch.long, device=dev)
    init_beta = torch.zeros(k_max, dtype=c0.dtype, device=dev)
    if unpen_idx is None:
        n_init = min(h, k_max, p)
        init_idx[:n_init] = torch.sort(c0, descending=True,
                                       stable=True).indices[:n_init]
        return init_idx, init_beta, n_init
    n_init = min(h + 1, k_max, p)
    c0_top = c0.clone()
    c0_top[unpen_idx] = -torch.inf       # ties at 0 must not pick it
    top = torch.sort(c0_top, descending=True, stable=True).indices
    init_idx[0] = unpen_idx
    init_idx[1:n_init] = top[:n_init - 1]
    init_beta[0] = float(b0)
    return init_idx, init_beta, n_init


class _Problem:
    """One problem's state in the outer loop. The engine
    (:func:`_advance`) steps every live problem of a fleet; a serial solve
    is a fleet of one. ``inner`` is the problem's own (serial) inner
    backend, which a fleet step may use for its carry; ``cn`` its (p,)
    column norms (a weighted problem's own); ``w`` its sample weights
    (None = unweighted)."""

    def __init__(self, y, lam, eps, delta0, h_tilde, h_cap, h_post, c0,
                 aset, carry, inner=None, *, cn, w=None):
        self.y, self.eps, self.c0, self.cn, self.w = y, float(eps), c0, cn, w
        self.lam = torch.tensor(lam, dtype=y.dtype, device=y.device)
        self.delta = float(delta0)
        self.h_tilde, self.h_cap, self.h_post = h_tilde, h_cap, h_post
        self.aset, self.carry, self.inner = aset, carry, inner
        self.gap = torch.tensor(math.inf, dtype=y.dtype, device=y.device)
        self.is_add, self.stop, self.t = True, False, 0
        # one outer step's values, set by the engine
        self.g0 = self.theta = self.theta_c = self.r_eff = self.r_del = None
        self.gap_f, self.stop_now, self.stop_final = math.inf, False, False
        self.n_scr = self.n_sur = self.post_viol = -1
        self.traces = {k: [] for k in ("n_active", "gap", "dual", "screened",
                                       "survivors", "post_viol")}

    def result(self, p: int, max_outer: int) -> SaifResult:
        dt, dev = self.y.dtype, self.y.device

        def _trace(vals, dtype):
            tr = torch.full((max_outer,), -1, dtype=dtype, device=dev)
            tr[:len(vals)] = torch.tensor(vals, dtype=dtype, device=dev)
            return tr

        tr = self.traces
        return SaifResult(
            beta=aset_lib.scatter_beta(self.aset, p), gap=self.gap,
            n_outer=self.t, n_active=self.aset.count,
            overflowed=self.aset.overflowed,
            trace_n_active=_trace(tr["n_active"], dt),
            trace_gap=_trace(tr["gap"], dt), trace_dual=_trace(tr["dual"], dt),
            active_idx=self.aset.idx, active_mask=self.aset.mask,
            inner=self.carry,
            trace_screened=_trace(tr["screened"], torch.int32),
            trace_survivors=_trace(tr["survivors"], torch.int32),
            trace_post_viol=_trace(tr["post_viol"], torch.int32))


def newton_polish(loss, carry: InnerCarry, aset, Xa, y, lam, beta, theta,
                  gap, sample_w=None):
    """The hybrid rule's working-set Newton polish: one masked solve of
    G b = rho - lam*sign on the CM iterate's support, kept only if its
    certified gap beats the CM iterate's (a weighted problem's carry and
    gap are weighted). It runs on the live slots (``order[:count]``), as
    the Gram engine's products do, so no shape depends on the capacity."""
    dt = Xa.dtype
    live = aset.order[:aset.count]
    if live.numel() == 0:                   # nothing to polish
        return beta, theta, gap
    bl = beta[live]
    m = aset.mask[live] & (bl != 0.0)
    mf = m.to(dt)
    Gm = (carry.G[live[:, None], live[None, :]] * (mf[:, None] * mf[None, :])
          + torch.diag(1.0 - mf))
    rhs = (carry.rho[live] - lam * torch.sign(bl)) * mf
    # solve_ex: a singular system yields junk, which the gap rejects
    b_l = torch.where(m, torch.linalg.solve_ex(Gm, rhs)[0], 0.0)
    Xl = Xa[:, live]
    th_n, gap_n = _dual_and_gap(loss, Xl, y, b_l, Xl @ b_l, m, lam,
                                sample_w=sample_w)
    if bool(gap_n < gap):                          # NaN/junk reads False
        return torch.zeros_like(beta).index_copy(0, live, b_l), th_n, gap_n
    return beta, theta, gap


def certify(loss, y, g0, theta, gap, lam, delta, aset, c0, use_seq_ball,
            screen_rule: ScreenRule):
    """The ball region around the backend's dual point (Thm 2 / Eq. 12),
    radius floored at the gap's own arithmetic precision. Returns its
    center, the ADD-side radius (delta shrinks it for the ball rules; the
    point bound screens at 0) and the full gap-safe radius DEL keeps.
    A stack of problems, one a row, works too (the fast fleet's)."""
    ball = gap_ball(loss, theta, gap, lam,
                    floor=gap_precision_floor(theta, lam))
    if use_seq_ball:
        c0_active = torch.where(aset.mask, torch.gather(c0, -1, aset.idx),
                                -torch.inf)
        lam0t = torch.maximum(torch.amax(c0_active, dim=-1),
                              lam * (1 + 1e-12))
        b_seq = sequential_ball(loss, y, -g0 / per_problem(lam0t), lam0t,
                                lam)
        ball = intersect_balls(b_seq, ball)
    if screen_rule.add_bound == "point":
        r_eff = torch.zeros_like(ball.radius)
    else:
        r_eff = delta * ball.radius
    return ball.center, r_eff, ball.radius


def del_mask(aset, Xa, theta_c, r_del, col_norm, unpen_idx: int = -1):
    """DEL: the gap-safe rule on the sub-problem's live slots (or on a
    stack of problems' slots, one a row, with (B, p) norms)."""
    corr_act = torch.abs(mv_last(Xa.mT, theta_c))
    norm_act = torch.where(aset.mask, torch.gather(col_norm, -1, aset.idx),
                           0.0)
    drop = aset.mask & (corr_act + norm_act * per_problem(r_del) < 1.0)
    if unpen_idx >= 0:
        # the unpenalized slot's dual constraint is an equality: the < 1
        # DEL rule never applies to it
        drop = drop & (aset.idx != unpen_idx)
    return drop


def add_keep(sout, ranks, h_tilde: int, h_cap: int, screen_rule, stuck: bool,
             first_finite: bool):
    """Algorithm 2: candidate l is added iff |V_l| < h~ against R_t minus
    the better-ranked candidates (cumulative AND), at most ``h_cap`` of
    them; the progress guarantee forces the top-scoring feature when the
    sub-problem is near target (``stuck``) and nothing passes the test."""
    v_count = torch.clamp(sout.cand_ge - 1 - ranks, min=0)
    keep = ((v_count < h_tilde) & (ranks < h_cap)
            & torch.isfinite(sout.cand_score))
    if screen_rule.add_bound == "point":
        keep = keep & (sout.cand_score >= 1.0)
    keep = torch.cumprod(keep.long(), 0).bool()
    if stuck and first_finite:
        keep[0] = True
    return keep


def post_check_keep(chk, ranks, h_post: int, col_norm, r_del, p: int,
                    first_finite: bool):
    """The hybrid rule's post-check recruits: the candidates (at most
    ``h_post``) whose upper bound at the full radius still reaches 1, and
    always the top one."""
    ub_c = (chk.cand_score
            + col_norm[torch.clamp(chk.cand_idx, max=p - 1)] * r_del)
    keep = torch.isfinite(chk.cand_score) & (ub_c >= 1.0) & (ranks < h_post)
    keep[0] = first_finite
    return keep


def _advance(probs, X, *, loss, h, inner_epochs, polish_factor,
             max_outer, use_seq_ball, screen, fleet_step, screen_rule,
             newton, unpen_idx=-1) -> None:
    """The outer loop of Algorithm 1/2 (the reference's ``_saif_jit`` and,
    for a fleet, its ``_saif_batch_jit``), over a list of
    :class:`_Problem` whose states it advances in place until each stops.

    Every float computation runs per problem, on that problem's own
    tensors, in the serial order; only exact work is shared: the screen
    (``screen``, a :data:`BatchScreenFn` over the problems whose ADD
    phase runs), the bursts when ``fleet_step`` owns them, and the host
    reads, which fetch the problems' values together. Each problem reads
    its own column norms and sample weights (``_Problem.cn``/``.w``): a
    weighted fleet's problems have their own. A problem ends at
    its first ADD that runs out of slots: the reference runs it on to
    ``max_outer`` and then discards it (the caller regrows the capacity
    and starts over from the same initial support), so stopping there
    gives the same final result without the wasted steps. An ADD cannot
    overflow once k_max >= p.
    """
    p = X.shape[1]
    ranks = torch.arange(h, device=X.device)
    for q in probs:
        q.g0 = loss.grad(torch.zeros_like(q.y), q.y)       # f'(0)
    while True:
        live = [q for q in probs if not q.stop and q.t < max_outer]
        if not live:
            return
        n_eps = [inner_epochs if q.is_add else inner_epochs * polish_factor
                 for q in live]
        # --- K epochs of CM on each sub-problem (K * polish_factor once
        #     recruiting is done), dual point and gap (Eq. 11)
        if fleet_step is None:
            outs, Xas = [], []
            for q, n_ep in zip(live, n_eps):
                Xa = aset_lib.gather_columns(X, q.aset)
                q.carry = q.inner.refresh(q.carry, q.aset, Xa)
                outs.append(q.inner.run(q.carry, q.aset, Xa, q.lam, n_ep))
                Xas.append(Xa)
        else:
            outs, Xas = fleet_step(live, n_eps)
        for q, out, Xa in zip(live, outs, Xas):
            beta, q.theta, q.gap = out.beta, out.theta, out.gap
            if newton and not q.is_add:
                beta, q.theta, q.gap = newton_polish(
                    loss, q.carry, q.aset, Xa, q.y, q.lam, beta, q.theta,
                    q.gap, q.w)
            q.aset = q.aset._replace(beta=beta)
        for q in live:
            q.theta_c, q.r_eff, q.r_del = certify(
                loss, q.y, q.g0, q.theta, q.gap, q.lam, q.delta, q.aset,
                q.c0, use_seq_ball, screen_rule)

        # --- global stop check (gap target reached & recruiting finished)
        #     and DEL (gap-safe rule on the sub-problem)
        deleting, drops = [], []
        gap_fs = aset_lib.host_read([q.gap for q in live])
        for q, Xa, gap_f in zip(live, Xas, gap_fs):
            q.gap_f = gap_f
            q.stop_now = (not q.is_add) and gap_f <= q.eps
            q.n_scr = q.n_sur = q.post_viol = -1
            if not q.stop_now:
                deleting.append(q)
                drops.append(del_mask(q.aset, Xa, q.theta_c, q.r_del,
                                      q.cn, unpen_idx))
        for q, aset in zip(deleting, aset_lib.delete_features_batch(
                [q.aset for q in deleting], drops)):
            q.aset = aset

        # --- ADD phase, on the problems whose recruiting is on
        adding = [q for q in live if not q.stop_now
                  and (screen_rule.add_bound == "point" or q.is_add)]
        add_q, cands, keeps = [], [], []
        for q, sout, (mx, ns, ni, ff) in _screen(screen, probs, adding,
                                                 "r_eff"):
            q.n_sur = int(ns)
            q.n_scr = int(ni) - q.n_sur
            if mx < 1.0:                       # ADD stop (Remark 1)
                if not screen_rule.delta_ramp:
                    q.is_add = False
                elif q.delta < 1.0:
                    q.delta = min(10.0 * q.delta, 1.0)
                else:
                    q.is_add = False
            else:
                add_q.append(q)
                cands.append(sout.cand_idx)
                keeps.append(add_keep(sout, ranks, q.h_tilde, q.h_cap,
                                      screen_rule,
                                      q.gap_f <= 100.0 * q.eps, bool(ff)))
        for q, aset in zip(add_q, aset_lib.add_features_batch(
                [q.aset for q in add_q], cands, keeps)):
            q.aset = aset

        # --- safe post-check (hybrid rule): a stop needs one full screen
        #     at the certified radius; violators deny it and are recruited
        for q in live:
            q.stop_final = q.stop_now
        if screen_rule.post_check:
            add_q, cands, keeps = [], [], []
            checking = [q for q in live if q.stop_now]
            for q, chk, (mx, _, _, ff) in _screen(screen, probs, checking,
                                                  "r_del"):
                viol = mx >= 1.0
                q.post_viol = int(viol)
                if viol:
                    add_q.append(q)
                    cands.append(chk.cand_idx)
                    keeps.append(post_check_keep(chk, ranks, q.h_post,
                                                 q.cn, q.r_del, p,
                                                 bool(ff)))
                    q.stop_final = False
            for q, aset in zip(add_q, aset_lib.add_features_batch(
                    [q.aset for q in add_q], cands, keeps)):
                q.aset = aset

        duals = aset_lib.host_read([_dual_value(loss, q) for q in live])
        for q, dual in zip(live, duals):
            tr = q.traces
            tr["n_active"].append(float(q.aset.count))
            tr["gap"].append(q.gap_f)
            tr["dual"].append(dual)
            tr["screened"].append(q.n_scr)
            tr["survivors"].append(q.n_sur)
            tr["post_viol"].append(q.post_viol)
            q.stop = q.stop_final or q.aset.overflowed
            q.t += 1


def _dual_value(loss, q: _Problem) -> Tensor:
    """D(theta) of the problem's dual point, weighted by its sample
    weights when it has them."""
    if q.w is None:
        return loss.dual_objective(q.y, q.theta, q.lam)
    return -torch.sum(q.w * loss.conj(-q.lam * q.theta, q.y))


def _screen(screen, probs, picked, radius: str):
    """Run the fleet screen on the ``picked`` problems at their radius
    attribute ``radius``; yield (problem, its ScreenOut, host values
    (max_ub, n_surv, #inactive, top candidate finite)) read in one go."""
    if not picked:
        return []
    on = set(picked)
    do = [q in on for q in probs]
    picked = [q for q in probs if q in on]          # in the fleet's order
    outs = screen([q.theta_c if d else None for q, d in zip(probs, do)],
                  [getattr(q, radius) if d else None
                   for q, d in zip(probs, do)],
                  [q.aset.in_active if d else None
                   for q, d in zip(probs, do)], do)
    outs = [o for o, d in zip(outs, do) if d]
    f64 = torch.float64
    vals = aset_lib.host_read([
        torch.stack((o.max_ub.to(f64), o.n_surv.to(f64),
                     (~q.aset.in_active).sum().to(f64),
                     torch.isfinite(o.cand_score[0]).to(f64)))
        for q, o in zip(picked, outs)])
    return zip(picked, outs, vals)


def one_problem_screen(screen: ScreenFn) -> BatchScreenFn:
    """A serial screen as the engine's fleet screen of one problem."""
    def fleet(thetas, rs, in_actives, do):
        return [screen(thetas[0], rs[0], in_actives[0])]
    return fleet


def _solve(X, y, col_norm, c0, lam, eps, delta0, init_idx, init_beta,
           init_mask, carry_in: InnerCarry, h_tilde, h_cap, *, loss_name,
           h, k_max, inner_epochs, polish_factor, max_outer, use_seq_ball,
           screen_backend, inner_backend, screen_rule: ScreenRule,
           unpen_idx: int = -1, p_true: int = 0,
           screen_fn: Optional[ScreenFn] = None) -> SaifResult:
    """One serial solve (the reference's ``_saif_jit``): the engine
    :func:`_advance` on a fleet of one, with the serial screen (a caller's
    ``screen_fn``, else ``screen_backend``'s) and inner backend. With
    ``p_true < p`` the columns from ``p_true`` on are bucket padding."""
    loss = get_loss(loss_name)
    p = X.shape[1]
    if screen_fn is None:
        make_screen = (make_screen_cuda if screen_backend == "cuda"
                       else make_screen_torch)
        screen_fn = make_screen(X, col_norm, h)
    inner = make_inner(inner_backend, loss, X, y, col_norm, h, unpen_idx)
    aset = aset_lib.init_active_set(p, k_max, init_idx, X.dtype, init_beta,
                                    live_mask=init_mask)
    if 0 < p_true < p:
        # pad columns are born active without a slot, as in the reference:
        # every screen masks them, DEL touches only live slots and ADD
        # draws from screen candidates, so a pad is never scored,
        # recruited or deleted
        aset = aset._replace(in_active=aset.in_active | (
            torch.arange(p, device=X.device) >= p_true))
    carry = inner.init(aset, carry_in, aset_lib.gather_columns(X, aset))
    prob = _Problem(y, lam, eps, delta0, h_tilde, h_cap, h, c0, aset, carry,
                    inner, cn=col_norm)
    _advance([prob], X, loss=loss, h=h, inner_epochs=inner_epochs,
             polish_factor=polish_factor, max_outer=max_outer,
             use_seq_ball=use_seq_ball,
             screen=one_problem_screen(screen_fn),
             fleet_step=None, screen_rule=screen_rule,
             newton=(screen_rule.newton_polish and inner_backend == "gram"
                     and loss_name == "least_squares" and unpen_idx < 0),
             unpen_idx=unpen_idx)
    return prob.result(p, max_outer)


class PathState(NamedTuple):
    """One-time O(np) problem preparation: c0, the column norms, lambda_max
    and the host-side c0 statistics the h formula needs."""
    X: Tensor             # (n, p)
    y: Tensor             # (n,)
    c0: Tensor            # (p,) |X^T f'(null model)|
    col_norm: Tensor      # (p,)
    lam_max: float
    c0_max: float
    c0_median: float      # mean of the two middle values for even p
    b0: float = 0.0
    n_true: int = 0       # 0 = unpadded
    p_true: int = 0


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Without one, only an explicit CPU request
    runs: the port never quietly carries on on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    return dev


def as_tensor(a, device, dtype=None) -> Tensor:
    """Numpy array or tensor -> tensor on ``device`` (dtype kept unless
    given)."""
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(a if a.flags.writeable else a.copy())
    return torch.as_tensor(a).to(device=device, dtype=dtype).contiguous()


def _median(v: Tensor) -> Tensor:
    """jnp.median: the mean of the two middle values for an even count."""
    s = torch.sort(v).values
    m = s.shape[0]
    if m % 2:
        return s[m // 2]
    return (s[m // 2 - 1] + s[m // 2]) / 2


def prepare_path(X, y, config: SaifConfig = SaifConfig(),
                 device=None) -> PathState:
    """The one-time preparation pass (see :class:`PathState`). ``X`` and
    ``y`` may be numpy arrays or tensors; the dtype follows ``X``. With an
    unpenalized coordinate the null model sits at its partial optimum b0
    and c0[unpen_idx] is 0."""
    dev = resolve_device(device)
    loss = get_loss(config.loss)
    X = as_tensor(X, dev)
    y = as_tensor(y, dev, X.dtype)
    _, c0, b0 = null_gradient(loss, X, y, config.unpen_idx)
    col_norm = torch.linalg.vector_norm(X, dim=0)
    c0_max = float(torch.max(c0))
    return PathState(X=X, y=y, c0=c0, col_norm=col_norm, lam_max=c0_max,
                     c0_max=c0_max, c0_median=float(_median(c0)),
                     b0=float(b0))


def pad_path_state(prep: PathState, n_bucket: int,
                   p_bucket: int) -> PathState:
    """Zero-pad a real preparation up to a bucket shape (the reference's
    DESIGN.md §12).

    The statistics stay those of the REAL problem: c0 pads sit at -inf
    (they never win a top-h or a max), column-norm pads at 1.0 (never
    read, since every screen masks the pads, but finite), and
    ``n_true``/``p_true`` record the real dims for every policy formula.
    Zero pad rows are inert for least squares in exact arithmetic (each
    adds 0 to the primal, the gradient and the column norms), but they
    change the rounding of sums over n. Column padding is bitwise inert:
    no engine reduction runs over the feature axis (a screen scores each
    column on its own, selection is a stable sort or a max)."""
    n, p = prep.X.shape
    if n_bucket < n or p_bucket < p:
        raise ValueError(
            f"bucket ({n_bucket}, {p_bucket}) must dominate the problem "
            f"shape ({n}, {p})")
    if (n_bucket, p_bucket) == (n, p):
        return prep
    dn, dp = n_bucket - n, p_bucket - p
    pad = torch.nn.functional.pad
    return prep._replace(
        X=pad(prep.X, (0, dp, 0, dn)), y=pad(prep.y, (0, dn)),
        c0=pad(prep.c0, (0, dp), value=-math.inf),
        col_norm=pad(prep.col_norm, (0, dp), value=1.0),
        n_true=n, p_true=p)


def solve_scalar(prep: PathState, lam: float,
                 config: SaifConfig = SaifConfig(),
                 warm_idx=None, warm_beta=None, device=None, *,
                 scan_fn=None, screen_fn: Optional[ScreenFn] = None
                 ) -> SaifResult:
    """Solve LASSO at ``lam`` from an existing preparation (the host side):
    h, capacity, the initial active set, the backend choice and the
    capacity-overflow regrowth loop. ``screen_fn`` plugs a whole custom
    :data:`ScreenFn`; ``scan_fn`` (``theta -> |X^T theta|``) a bare scan,
    adapted by :func:`make_screen_from_scan`. A session
    (``repro_torch.core.api``) prepares once and calls this per request."""
    dev = resolve_device(device)
    X, y, c0, col_norm = (t.to(dev) for t in
                          (prep.X, prep.y, prep.c0, prep.col_norm))
    n, p = X.shape
    n_true = prep.n_true or n
    p_true = prep.p_true or p
    unpen = config.unpen_idx
    rule = resolve_screen_rule(config.screen_rule)
    # the Thm-2 ball assumes the all-penalized null dual -f'(0)/lam_max
    use_seq = config.use_seq_ball and unpen is None and rule.use_seq_ball

    h = add_batch_size_static(config.c, lam, prep.c0_max, prep.c0_median,
                              p_true)
    h_tilde = max(int(math.ceil(config.zeta * h)), 1)
    k_max = config.k_max or default_capacity(h, p_true)
    delta0 = config.delta0 if config.delta0 is not None else \
        min(max(lam / prep.lam_max, 1e-3), 1.0)
    screen = resolve_backend(config.screen_backend, dev)
    if screen_fn is None and scan_fn is not None:
        screen_fn = make_screen_from_scan(scan_fn, col_norm, h)

    if warm_idx is not None:
        k_max = max(k_max, default_capacity(h, p_true))
        warm_idx = as_tensor(warm_idx, dev, torch.long)
        warm_beta = (torch.zeros(warm_idx.shape[0], dtype=X.dtype,
                                 device=dev) if warm_beta is None
                     else as_tensor(warm_beta, dev, X.dtype))
        if unpen is not None and not bool((warm_idx == unpen).any()):
            # the unpenalized slot is always resident: prepend it, so a
            # capacity-full warm support can never truncate it away
            warm_idx = torch.cat([warm_idx.new_tensor([unpen]), warm_idx])
            warm_beta = torch.cat([warm_beta.new_tensor([prep.b0]),
                                   warm_beta])
        n_init = min(int(warm_idx.shape[0]), k_max, p_true)
        init_idx = torch.zeros(k_max, dtype=torch.long, device=dev)
        init_idx[:n_init] = warm_idx[:n_init]
        init_beta = torch.zeros(k_max, dtype=X.dtype, device=dev)
        init_beta[:n_init] = warm_beta[:n_init]
    else:
        init_idx, init_beta, n_init = initial_support(c0, h, k_max, p_true,
                                                      unpen, prep.b0)

    while True:
        init_idx = init_idx[:k_max]
        init_beta = init_beta[:k_max]
        if init_idx.shape[0] < k_max:   # capacity grew after overflow
            pad = k_max - init_idx.shape[0]
            init_idx = torch.nn.functional.pad(init_idx, (0, pad))
            init_beta = torch.nn.functional.pad(init_beta, (0, pad))
        # capacity growth can move the auto crossover
        inner = resolve_inner_backend(config.inner_backend, config.loss,
                                      n_true, k_max, dev, X.element_size(),
                                      unpen is not None, n_pad=n)
        # the engine dispatch routes through the fault-injection seam
        # (repro_torch.runtime.inject): one None-check when disarmed
        res = _fault_seam("serial", lambda: _solve(
            X, y, col_norm, c0, lam, config.eps, delta0, init_idx,
            init_beta, torch.arange(k_max, device=dev) < n_init,
            cold_inner_carry(k_max, X.dtype, dev, backend=inner),
            h_tilde, h, loss_name=config.loss, h=h, k_max=k_max,
            inner_epochs=config.inner_epochs,
            polish_factor=config.polish_factor, max_outer=config.max_outer,
            use_seq_ball=use_seq, screen_backend=screen,
            inner_backend=inner, screen_rule=rule,
            unpen_idx=-1 if unpen is None else unpen, p_true=p_true,
            screen_fn=screen_fn))
        if not res.overflowed or k_max >= p_true:
            return res
        k_max = min(2 * k_max, p_true)  # elastic capacity growth


def saif(X, y, lam: float, config: SaifConfig = SaifConfig(),
         warm_idx=None, warm_beta=None, device=None, *, scan_fn=None,
         screen_fn: Optional[ScreenFn] = None) -> SaifResult:
    """Solve LASSO at ``lam`` with SAIF: one-shot prepare + solve (the
    hooks as in :func:`solve_scalar`). ``device=None`` runs on the card;
    pass ``device="cpu"`` for the plain path on the CPU. Callers with more
    than one request on a problem should hold a session
    (``repro_torch.open_session``), which prepares once."""
    dev = resolve_device(device)
    return solve_scalar(prepare_path(X, y, config, dev), lam, config,
                        warm_idx=warm_idx, warm_beta=warm_beta, device=dev,
                        scan_fn=scan_fn, screen_fn=screen_fn)
