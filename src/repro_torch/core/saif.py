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
from repro_torch.core.losses import get_loss
from repro_torch.core.screen_backend import (ScreenRule, make_screen_cuda,
                                             make_screen_torch,
                                             resolve_backend,
                                             resolve_screen_rule)

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

    def __post_init__(self):
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


def _solve(X, y, col_norm, c0, lam, eps, delta0, init_idx, init_beta,
           init_mask, carry_in: InnerCarry, h_tilde, h_cap, *, loss_name,
           h, k_max, inner_epochs, polish_factor, max_outer, use_seq_ball,
           screen_backend, inner_backend, screen_rule: ScreenRule,
           unpen_idx: int = -1) -> SaifResult:
    """The outer loop of Algorithm 1/2 (the reference's ``_saif_jit``).

    The loop ends at the first ADD that runs out of slots. The reference
    runs such a solve on to ``max_outer`` and then discards it
    (solve_scalar regrows the capacity and starts over from the same
    initial support), so stopping there returns the same final result
    without the wasted steps. An ADD cannot overflow once k_max >= p: its
    candidates are inactive features, never more than the free slots.
    """
    loss = get_loss(loss_name)
    n, p = X.shape
    dt, dev = X.dtype, X.device
    lam = torch.tensor(lam, dtype=dt, device=dev)
    make_screen = (make_screen_cuda if screen_backend == "cuda"
                   else make_screen_torch)
    screen = make_screen(X, col_norm, h)
    inner = make_inner(inner_backend, loss, X, y, col_norm, h, unpen_idx)
    g0 = loss.grad(torch.zeros_like(y), y)          # f'(0)
    newton = (screen_rule.newton_polish and inner_backend == "gram"
              and loss_name == "least_squares" and unpen_idx < 0)
    ranks = torch.arange(h, device=dev)

    aset = aset_lib.init_active_set(p, k_max, init_idx, dt, init_beta,
                                    live_mask=init_mask)
    carry = inner.init(aset, carry_in, aset_lib.gather_columns(X, aset))
    gap = torch.tensor(math.inf, dtype=dt, device=dev)
    delta, is_add, stop, t = float(delta0), True, False, 0
    traces = {k: [] for k in ("n_active", "gap", "dual", "screened",
                              "survivors", "post_viol")}

    while not stop and t < max_outer:
        Xa = aset_lib.gather_columns(X, aset)
        # --- K epochs of CM on the sub-problem (K * polish_factor once
        #     recruiting is done), dual point and gap (Eq. 11)
        carry = inner.refresh(carry, aset, Xa)
        n_ep = inner_epochs if is_add else inner_epochs * polish_factor
        out = inner.run(carry, aset, Xa, lam, n_ep)
        beta, theta, gap = out.beta, out.theta, out.gap

        # --- working-set Newton polish (hybrid rule): one masked solve of
        #     G b = rho - lam*sign on the CM iterate's support, accepted only
        #     if its certified gap beats the CM iterate's
        if newton and not is_add:
            m = aset.mask & (beta != 0.0)
            mf = m.to(dt)
            Gm = carry.G * (mf[:, None] * mf[None, :]) + torch.diag(1.0 - mf)
            rhs = (carry.rho - lam * torch.sign(beta)) * mf
            # solve_ex: a singular system yields junk, which the gap rejects
            b_n = torch.where(m, torch.linalg.solve_ex(Gm, rhs)[0], 0.0)
            th_n, gap_n = _dual_and_gap(loss, Xa, y, b_n, Xa @ b_n, m, lam)
            if bool(gap_n < gap):                  # NaN/junk reads False
                beta, theta, gap = b_n, th_n, gap_n
        aset = aset._replace(beta=beta)

        # --- ball region from the backend's dual point (Thm 2 / Eq. 12),
        #     radius floored at the gap's own arithmetic precision
        ball = gap_ball(loss, theta, gap, lam,
                        floor=gap_precision_floor(theta, lam))
        if use_seq_ball:
            c0_active = torch.where(aset.mask, c0[aset.idx], -torch.inf)
            lam0t = torch.maximum(torch.max(c0_active), lam * (1 + 1e-12))
            b_seq = sequential_ball(loss, y, -g0 / lam0t, lam0t, lam)
            ball = intersect_balls(b_seq, ball)
        # delta shrinks the radius for the ADD-side rules only; DEL keeps
        # the full gap-safe radius; the point bound screens at radius 0
        if screen_rule.add_bound == "point":
            r_eff = torch.zeros_like(ball.radius)
        else:
            r_eff = delta * ball.radius
        r_del = ball.radius
        theta_c = ball.center

        # --- global stop check (gap target reached & recruiting finished)
        gap_f = float(gap)
        stop_now = (not is_add) and gap_f <= eps

        # --- DEL (gap-safe rule on the sub-problem)
        if not stop_now:
            corr_act = torch.abs(Xa.T @ theta_c)
            norm_act = torch.where(aset.mask, col_norm[aset.idx], 0.0)
            del_mask = aset.mask & (corr_act + norm_act * r_del < 1.0)
            if unpen_idx >= 0:
                # the unpenalized slot's dual constraint is an equality:
                # the < 1 DEL rule never applies to it
                del_mask = del_mask & (aset.idx != unpen_idx)
            aset = aset_lib.delete_features(aset, del_mask)

        # --- ADD phase
        do_add = (not stop_now) and (screen_rule.add_bound == "point"
                                     or is_add)
        n_scr = n_sur = -1
        if do_add:
            sout = screen(theta_c, r_eff, aset.in_active)
            n_sur = int(sout.n_surv)
            n_scr = int((~aset.in_active).sum()) - n_sur
            if float(sout.max_ub) < 1.0:       # ADD stop (Remark 1)
                if not screen_rule.delta_ramp:
                    is_add = False
                elif delta < 1.0:
                    delta = min(10.0 * delta, 1.0)
                else:
                    is_add = False
            else:
                # Algorithm 2: candidate l is added iff |V_l| < h~ against
                # R_t minus the better-ranked candidates (cumulative AND)
                v_count = torch.clamp(sout.cand_ge - 1 - ranks, min=0)
                keep = ((v_count < h_tilde) & (ranks < h_cap)
                        & torch.isfinite(sout.cand_score))
                if screen_rule.add_bound == "point":
                    keep = keep & (sout.cand_score >= 1.0)
                keep = torch.cumprod(keep.long(), 0).bool()
                # progress guarantee: force the top-scoring feature when the
                # sub-problem is near target and nothing passes the test
                if gap_f <= 100.0 * eps and bool(
                        torch.isfinite(sout.cand_score[0])):
                    keep[0] = True
                aset = aset_lib.add_features(aset, sout.cand_idx, keep)

        # --- safe post-check (hybrid rule): a stop needs one full screen
        #     at the certified radius; violators deny it and are recruited
        post_viol = -1
        stop_final = stop_now
        if screen_rule.post_check and stop_now:
            chk = screen(theta_c, r_del, aset.in_active)
            viol = float(chk.max_ub) >= 1.0
            post_viol = int(viol)
            if viol:
                ub_c = (chk.cand_score +
                        col_norm[torch.clamp(chk.cand_idx, max=p - 1)]
                        * r_del)
                keep = torch.isfinite(chk.cand_score) & (ub_c >= 1.0)
                keep[0] = bool(torch.isfinite(chk.cand_score[0]))
                aset = aset_lib.add_features(aset, chk.cand_idx, keep)
                stop_final = False

        traces["n_active"].append(float(aset.count))
        traces["gap"].append(gap_f)
        traces["dual"].append(float(loss.dual_objective(y, theta, lam)))
        traces["screened"].append(n_scr)
        traces["survivors"].append(n_sur)
        traces["post_viol"].append(post_viol)
        stop = stop_final or aset.overflowed
        t += 1

    def _trace(vals, dtype):
        tr = torch.full((max_outer,), -1, dtype=dtype, device=dev)
        tr[:len(vals)] = torch.tensor(vals, dtype=dtype, device=dev)
        return tr

    return SaifResult(
        beta=aset_lib.scatter_beta(aset, p), gap=gap, n_outer=t,
        n_active=aset.count, overflowed=aset.overflowed,
        trace_n_active=_trace(traces["n_active"], dt),
        trace_gap=_trace(traces["gap"], dt),
        trace_dual=_trace(traces["dual"], dt),
        active_idx=aset.idx, active_mask=aset.mask, inner=carry,
        trace_screened=_trace(traces["screened"], torch.int32),
        trace_survivors=_trace(traces["survivors"], torch.int32),
        trace_post_viol=_trace(traces["post_viol"], torch.int32))


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
    n_true: int = 0       # 0 = unpadded (padding is not ported yet)
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


def _median(v: Tensor) -> float:
    """jnp.median: the mean of the two middle values for an even count."""
    s = torch.sort(v).values
    m = s.shape[0]
    if m % 2:
        return float(s[m // 2])
    return float((s[m // 2 - 1] + s[m // 2]) / 2)


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
                     c0_max=c0_max, c0_median=_median(c0), b0=float(b0))


def solve_scalar(prep: PathState, lam: float,
                 config: SaifConfig = SaifConfig(),
                 warm_idx=None, warm_beta=None, device=None) -> SaifResult:
    """Solve LASSO at ``lam`` from an existing preparation (the host side):
    h, capacity, the initial active set, the backend choice and the
    capacity-overflow regrowth loop."""
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
                                      unpen is not None)
        res = _solve(
            X, y, col_norm, c0, lam, config.eps, delta0, init_idx,
            init_beta, torch.arange(k_max, device=dev) < n_init,
            cold_inner_carry(k_max, X.dtype, dev, backend=inner),
            h_tilde, h, loss_name=config.loss, h=h, k_max=k_max,
            inner_epochs=config.inner_epochs,
            polish_factor=config.polish_factor, max_outer=config.max_outer,
            use_seq_ball=use_seq, screen_backend=screen,
            inner_backend=inner, screen_rule=rule,
            unpen_idx=-1 if unpen is None else unpen)
        if not res.overflowed or k_max >= p_true:
            return res
        k_max = min(2 * k_max, p_true)  # elastic capacity growth


def saif(X, y, lam: float, config: SaifConfig = SaifConfig(),
         warm_idx=None, warm_beta=None, device=None) -> SaifResult:
    """Solve LASSO at ``lam`` with SAIF: prepare + solve. ``device=None``
    runs on the card; pass ``device="cpu"`` for the plain path on the
    CPU."""
    dev = resolve_device(device)
    return solve_scalar(prepare_path(X, y, config, dev), lam, config,
                        warm_idx=warm_idx, warm_beta=warm_beta, device=dev)
