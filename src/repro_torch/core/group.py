"""Group-LASSO SAIF in torch (port of ``repro.core.group``), the extension
the paper's conclusion proposes.

Problem:  min_beta  sum_j f(x_j. beta, y_j) + lam * sum_g ||beta_g||_2
with disjoint equal-size groups (p = n_groups * gsize).

Dual feasible set:  Omega = { theta : ||X_g^T theta||_2 <= 1  for all g }.
The LASSO machinery carries over group-wise: the gap-safe ball is the
same; a group is inactive when ||X_g^T theta|| + ||X_g||_F r < 1 (the
Frobenius norm bounds the operator norm, so the rule stays safe); ADD
recruits the groups of largest ||X_g^T theta||; the inner solver is cyclic
block-proximal descent with the group soft-threshold
S_t(v) = v max(0, 1 - t / ||v||) and L_g = alpha ||X_g||_F^2.

The reference runs the outer loop as one jitted ``lax.while_loop``; here it
is a host loop over device tensors, as :mod:`repro_torch.core.saif` runs the
serial engine. Each outer step gathers the live groups' blocks once, as
(live, gsize, n); the burst (kernel B-n3, ``kernels/group``, on a card)
and the dual point and DEL read that gather. The group scan (``X^T
theta``, block norms, a stable descending sort for the reference's
``top_k`` tie order, lower group id first) is torch calls, as the
reference leaves it to XLA. ``backend="torch"`` runs the plain burst on
any device; ``"auto"`` launches B-n3 on CUDA tensors (raising past its
gate) and runs the plain burst on CPU tensors.

Unlike the reference, a solve that had to leave out a group the safe rule
cannot screen (an ADD with no free slot for it) and did not then stop by
its rule is ``overflowed``, and :func:`group_solve` solves again at twice
the capacity, as the serial engine does; the reference fills its slots
silently and runs on to ``max_outer`` with a sub-problem that is not the
whole problem. Such an ADD with the sub-problem already solved to eps ends
the solve at once.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.core.losses import Loss, get_loss
from repro_torch.core.saif import as_tensor, resolve_device
from repro_torch.kernels.group.group import group_bcd
from repro_torch.kernels.group.ref import (group_bcd_ref, group_blocks,
                                           group_soft_threshold)

Tensor = torch.Tensor

__all__ = ["GroupSaifConfig", "GroupSaifResult", "GroupPrep",
           "group_soft_threshold", "group_lambda_max", "prepare_group",
           "group_solve", "group_saif", "solve_group_lasso_bcd",
           "group_compile_count"]


@dataclasses.dataclass(frozen=True)
class GroupSaifConfig:
    eps: float = 1e-8
    inner_epochs: int = 5
    polish_factor: int = 8
    k_max: Optional[int] = None    # active-set capacity in GROUPS
    max_outer: int = 2000
    h: Optional[int] = None        # groups recruited per ADD
    loss: str = "least_squares"


class GroupSaifResult(NamedTuple):
    beta: Tensor             # (p,) full solution
    gap: Tensor              # final sub-problem duality gap (0-d)
    n_outer: int             # outer iterations executed
    n_active_groups: int     # final number of live slots
    # final slot state, the warm handoff a session threads between group
    # requests
    gidx: Tensor = None      # (k_max,) slot -> group id
    gmask: Tensor = None     # (k_max,) slot validity
    beta_slots: Tensor = None  # (k_max, gsize) slot coefficients
    # an ADD left out a group that could not be screened (no free slot)
    # and the solve did not stop by its rule; group_solve regrows then, so
    # its results carry False
    overflowed: bool = False


def _group_norms(v: Tensor, gsize: int) -> Tensor:
    """(p,) -> (n_groups,) euclidean norms of consecutive blocks."""
    return torch.linalg.vector_norm(v.reshape(-1, gsize), dim=1)


def _top_ids(v: Tensor, m: int) -> Tensor:
    """The ids of the m largest entries of ``v``, largest first, ties by
    the lower id (``jax.lax.top_k``'s order)."""
    return torch.sort(v, descending=True, stable=True).indices[:m]


_BACKENDS = ("auto", "torch")


def _burst(backend: str):
    if backend not in _BACKENDS:
        raise ValueError(f"unknown group backend {backend!r}; options: "
                         f"{list(_BACKENDS)}")
    return group_bcd_ref if backend == "torch" else group_bcd


def solve_group_lasso_bcd(loss: Loss, X, y, lam, gsize: int, tol=1e-10,
                          max_epochs=50_000) -> Tensor:
    """Unscreened block-CD oracle (ground truth for tests). Every group is
    a slot; each epoch is one burst (a launch of B-n3 on a card), followed
    by the gap at the group-feasible scaled dual point."""
    X = torch.as_tensor(X)
    X = X.contiguous()
    y = as_tensor(y, X.device, X.dtype)
    n, p = X.shape
    ng = p // gsize
    Lg = torch.clamp(loss.smoothness
                     * torch.sum((X * X).view(n, ng, gsize), dim=(0, 2)),
                     min=1e-30)
    slot = torch.arange(ng, device=X.device)
    A = group_blocks(X, slot, gsize)
    beta = torch.zeros(ng, gsize, dtype=X.dtype, device=X.device)
    for _ in range(int(max_epochs)):
        beta, z = group_bcd(A, y, slot, beta, Lg, lam, 1,
                            loss_name=loss.name)
        hat = -loss.grad(z, y) / lam
        gmax = torch.max(_group_norms(X.T @ hat, gsize))
        theta = hat / torch.clamp(gmax, min=1.0)
        p_val = (torch.sum(loss.value(z, y))
                 + lam * torch.sum(torch.linalg.vector_norm(beta, dim=1)))
        gap = p_val - loss.dual_objective(y, theta, lam)
        if not float(gap) > tol:
            break
    return beta.reshape(-1)


def _gsaif(X, y, gfro, lam: float, eps: float, gidx, beta, gmask, *,
           loss_name: str, gsize: int, h: int, inner_epochs: int,
           polish_factor: int, max_outer: int, burst) -> GroupSaifResult:
    """The outer loop of ``repro/core/group.py:114 _gsaif_jit``, step for
    step, with the burst ``burst`` (B-n3 or its plain version), and the
    overflow flag the reference lacks: set when an ADD left out a group it
    cannot screen and the loop did not stop by its rule, or at once when
    that ADD came with the sub-problem's gap at most eps."""
    loss = get_loss(loss_name)
    n, p = X.shape
    ng = p // gsize
    dt, dev = X.dtype, X.device
    Lg_all = torch.clamp(loss.smoothness * gfro ** 2, min=1e-30)
    gidx = gidx.to(device=dev, dtype=torch.long).clone()
    gmask = gmask.to(device=dev, dtype=torch.bool).clone()
    beta = beta.to(device=dev, dtype=dt).clone()
    in_active = torch.zeros(ng, dtype=torch.int32, device=dev).index_add_(
        0, gidx, gmask.to(torch.int32)) > 0
    eps_c = float(torch.tensor(eps, dtype=dt))   # eps in X's type
    zero = torch.zeros(1, dtype=dt, device=dev)
    gap = torch.tensor(math.inf, dtype=dt, device=dev)
    is_add, stop, overflowed, dropped, t = True, False, False, False, 0
    while not stop and not overflowed and t < max_outer:
        # the live blocks, gathered once for the burst, the dual point and
        # the DEL
        live = torch.nonzero(gmask).flatten()
        A = group_blocks(X, gidx[live], gsize)       # (live, gsize, n)
        L = torch.where(gmask, Lg_all[gidx], 1.0)
        n_ep = inner_epochs if is_add else inner_epochs * polish_factor
        beta, z = burst(A, y, live, beta, L, lam, n_ep,
                        loss_name=loss_name)

        # dual point from the carried z, gap, ball
        hat = -loss.grad(z, y) / lam
        gn_hat = torch.linalg.vector_norm(A @ hat, dim=1)
        tau = 1.0 / torch.clamp(torch.max(torch.cat([gn_hat, zero])),
                                min=1.0)
        theta = tau * hat
        p_val = (torch.sum(loss.value(z, y))
                 + lam * torch.sum(torch.linalg.vector_norm(beta[live],
                                                            dim=1)))
        gap = p_val - loss.dual_objective(y, theta, lam)
        r = torch.sqrt(2.0 * loss.smoothness
                       * torch.clamp(gap, min=0.0)) / lam
        stop_now = (not is_add) and float(gap) <= eps_c

        if not stop_now:
            # DEL groups
            corr = torch.linalg.vector_norm(A @ theta, dim=1)
            dl = live[corr + gfro[gidx[live]] * r < 1.0]
            gmask[dl] = False
            beta[dl] = 0.0
            in_active[gidx[dl]] = False

        if is_add and not stop_now:
            # ADD groups: the top-h finite scores into the free slots, in
            # ascending slot order
            scores = _group_norms(X.T @ theta, gsize)
            scores = scores.masked_fill(in_active, -math.inf)
            ub = scores + gfro * r
            if bool(torch.max(ub) < 1.0):
                is_add = False
            else:
                top = _top_ids(scores, h)
                cand = top[torch.isfinite(scores[top])]
                free = torch.nonzero(~gmask).flatten()
                m = min(cand.numel(), free.numel())
                gidx[free[:m]] = cand[:m]
                gmask[free[:m]] = True
                in_active[cand[:m]] = True
                if cand.numel() > m and bool((ub[cand[m:]] >= 1.0).any()):
                    # a group the rule cannot screen found no free slot:
                    # with the sub-problem solved, nothing will free one
                    dropped = True
                    overflowed = float(gap) <= eps_c
        stop = stop_now
        t += 1
    overflowed = overflowed or (dropped and not stop)

    beta_full = torch.zeros(ng, gsize, dtype=dt, device=dev)
    live = torch.nonzero(gmask).flatten()
    beta_full[gidx[live]] = beta[live]
    return GroupSaifResult(beta=beta_full.reshape(-1), gap=gap, n_outer=t,
                           n_active_groups=int(live.numel()), gidx=gidx,
                           gmask=gmask, beta_slots=beta,
                           overflowed=overflowed)


def group_compile_count() -> int:
    """The reference counts its ``_gsaif_jit`` compilations here; the port
    runs eagerly and compiles nothing, so this is 0."""
    return 0


class GroupPrep(NamedTuple):
    """One-time group-problem preparation: null-gradient group norms, the
    per-group Frobenius norms, and the (lambda-independent) static sizes.
    Computed once per session (``repro_torch.core.api``)."""
    X: Tensor
    y: Tensor
    c0: Tensor      # (ng,) group norms of X^T f'(0)
    gfro: Tensor    # (ng,) per-group Frobenius norms
    gsize: int
    h: int
    k_max: int


def prepare_group(X, y, gsize: int,
                  config: GroupSaifConfig = GroupSaifConfig(),
                  device=None) -> GroupPrep:
    """c0 and the group Frobenius norms on ``device`` (None = the card),
    and the reference's h and capacity rules. ``X`` and ``y`` may be
    numpy arrays or tensors; the dtype follows ``X``."""
    dev = resolve_device(device)
    loss = get_loss(config.loss)
    X = as_tensor(X, dev)
    y = as_tensor(y, dev, X.dtype)
    n, p = X.shape
    if p % gsize:
        raise ValueError("p must be a multiple of the group size")
    ng = p // gsize
    g0 = loss.grad(torch.zeros_like(y), y)
    c0 = _group_norms(X.T @ g0, gsize)
    gfro = torch.sqrt(torch.sum((X * X).view(n, ng, gsize), dim=(0, 2)))
    h = config.h or max(1, 1 << (math.ceil(math.log2(max(ng, 2))) // 2))
    k_max = config.k_max or min(ng, max(8 * h, 32))
    return GroupPrep(X=X, y=y, c0=c0, gfro=gfro, gsize=gsize, h=h,
                     k_max=k_max)


def group_solve(prep: GroupPrep, lam: float,
                config: GroupSaifConfig = GroupSaifConfig(), warm=None, *,
                backend: str = "auto") -> GroupSaifResult:
    """One group solve from an existing preparation, on its device.
    ``warm`` is the previous solve's ``(gidx, gmask, beta_slots)``; None is
    the cold start: the top-min(h, k_max) groups of c0 in slots 0..m-1.
    A solve that overflows its capacity starts again from the same state
    with twice the slots (at most every group). ``backend``: ``"auto"``
    (B-n3 on a card), ``"torch"`` (the plain burst)."""
    burst = _burst(backend)
    X, gsize, h = prep.X, prep.gsize, prep.h
    dev = X.device
    ng = X.shape[1] // gsize
    k_max = prep.k_max if warm is None else int(warm[0].shape[0])
    while True:
        if warm is None:
            m = min(h, k_max)
            gidx = torch.zeros(k_max, dtype=torch.long, device=dev)
            gidx[:m] = _top_ids(prep.c0, m)
            gmask = torch.arange(k_max, device=dev) < m
            beta = torch.zeros(k_max, gsize, dtype=X.dtype, device=dev)
        else:
            pad = k_max - int(warm[0].shape[0])
            gidx = torch.nn.functional.pad(warm[0].to(dev), (0, pad))
            gmask = torch.nn.functional.pad(warm[1].to(dev), (0, pad))
            beta = torch.nn.functional.pad(warm[2].to(dev), (0, 0, 0, pad))
        res = _gsaif(X, prep.y, prep.gfro, float(lam), float(config.eps),
                     gidx, beta, gmask, loss_name=config.loss, gsize=gsize,
                     h=h, inner_epochs=config.inner_epochs,
                     polish_factor=config.polish_factor,
                     max_outer=config.max_outer, burst=burst)
        if not res.overflowed or k_max >= ng:
            return res
        k_max = min(2 * k_max, ng)      # elastic capacity growth


def group_saif(X, y, lam: float, gsize: int,
               config: GroupSaifConfig = GroupSaifConfig(),
               device=None) -> GroupSaifResult:
    """DEPRECATED legacy frontend: a one-shot session over
    :func:`group_solve`. Use ``repro_torch.open_session(Problem(X, y,
    penalty=group(gsize)), config).solve(Scalar(lam))``; the session keeps
    the preparation and the warm slot buffers across requests.
    ``device=None`` runs on the card."""
    from repro_torch.core._compat import warn_deprecated
    from repro_torch.core.api import Problem, Scalar, group, open_session
    warn_deprecated("repro_torch.core.group_saif",
                    "session.solve(Scalar(lam)) with penalty=group(gsize)")
    sess = open_session(Problem(X=X, y=y, loss=config.loss,
                                penalty=group(gsize)), config, device=device)
    return sess.solve(Scalar(lam=float(lam)))


def group_lambda_max(loss: Loss, X, y, gsize: int) -> float:
    """The smallest lambda with beta* = 0: max_g ||X_g^T f'(0)||. ``X``
    and ``y`` are tensors (on any device) or numpy arrays (on the CPU)."""
    X = torch.as_tensor(X)
    y = torch.as_tensor(y).to(device=X.device, dtype=X.dtype)
    g0 = loss.grad(torch.zeros_like(y), y)
    return float(torch.max(_group_norms(X.T @ g0, gsize)))
