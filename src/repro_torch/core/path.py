"""Warm-started SAIF lambda-path engine (paper Sec 5.3), in torch (port of
``repro.core.path``).

:func:`run_path` solves a descending lambda grid from one
:class:`~repro_torch.core.saif.PathState`, each solve warm-starting from
the last:

  * **prepare once** — c0, the column norms, lambda_max and the c0
    statistics of the h formula come from the one preparation;
  * **one candidate-buffer size** — h is the grid maximum (a power of two),
    while each lambda keeps its own batch size h_cap and violation
    tolerance h~, so the ADD decisions are those of a per-lambda solve.
    The reference does this to compile its engine once per grid; the port
    runs eagerly, so :attr:`SaifPathResult.n_compilations` is ``None``;
  * **slot-preserving warm state** — the next lambda starts from the
    previous solve's final slot layout, masked down to its nonzero support
    (:func:`_warm_state`), so the Gram carry, indexed by slot, rides along
    and the next solve rebuilds nothing. Fused paths keep the unpenalized
    slot resident even at b = 0;
  * **segment-batched overflow checks** — solutions are collected per
    segment; when one overflowed its capacity, the capacity doubles and the
    segment re-runs from its entry state.

Each per-lambda solve routes through the fault-injection seam
(``repro_torch.runtime.inject``, tag ``"path"``), as in the reference. The
legacy frontend :func:`saif_path` is a deprecated shim over a one-shot
session (``repro_torch.core.api``).
"""
from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.duality import (duality_gap, feasible_dual, gap_ball,
                                      sequential_ball)
from repro_torch.core.inner_backend import (InnerCarry, cold_inner_carry,
                                            resolve_inner_backend)
from repro_torch.core.losses import get_loss
from repro_torch.core.saif import (PathState, SaifConfig, SaifResult, _solve,
                                   add_batch_size_static, default_capacity,
                                   initial_support, resolve_device, saif)
from repro_torch.core.screen_backend import (ScreenFn, resolve_backend,
                                             resolve_screen_rule)
from repro_torch.runtime.inject import seam as _fault_seam

Tensor = torch.Tensor
# Inter-solve handoff: (idx (k,), beta (k,), live-mask (k,), InnerCarry)
WarmState = Tuple[Tensor, Tensor, Tensor, InnerCarry]


class SaifPathResult(NamedTuple):
    lams: np.ndarray
    betas: List[Tensor]
    results: List[SaifResult]
    n_compilations: Optional[int] = None   # no compilations in the port


def _warm_state(active_idx: Tensor, active_mask: Tensor, beta_full: Tensor,
                inner: InnerCarry, unpen_idx: int = -1) -> WarmState:
    """Slot-preserving warm start: the previous solve's slot layout masked
    down to its nonzero support, so the slot-indexed Gram carry stays valid
    verbatim. The unpenalized slot stays resident even at b = 0."""
    vals = torch.where(active_mask, beta_full[active_idx], 0.0)
    live = active_mask & (vals != 0)
    if unpen_idx >= 0:
        live = live | (active_mask & (active_idx == unpen_idx))
    return active_idx, torch.where(live, vals, 0.0), live, inner


def _inner_name(prep: PathState, config: SaifConfig, k: int) -> str:
    n = prep.n_true or prep.X.shape[0]
    return resolve_inner_backend(config.inner_backend, config.loss, n, k,
                                 prep.X.device, prep.X.element_size(),
                                 config.unpen_idx is not None,
                                 n_pad=prep.X.shape[0])


def cold_start(prep: PathState, h0: int, k: int,
               config: SaifConfig) -> WarmState:
    """Cold entry state at capacity ``k`` from the FIRST lambda's own batch
    size ``h0``, so a cold path entry matches a standalone solve there."""
    p = prep.p_true or prep.X.shape[1]
    idx, beta, n_init = initial_support(prep.c0, h0, k, p, config.unpen_idx,
                                        prep.b0)
    dev = prep.X.device
    return (idx, beta, torch.arange(k, device=dev) < n_init,
            cold_inner_carry(k, prep.X.dtype, dev,
                             backend=_inner_name(prep, config, k)))


def grow_warm(warm: WarmState, k: int, inner_name: str) -> WarmState:
    """Pad a warm state to capacity ``k``; a Gram carry is padded in place
    (new slots dead, gidx -1), any other carry rebuilt cold. A Gram
    engine handed another backend's carry (the crossover flipped, e.g. as
    a row stream grew n) gets a cold Gram carry, which its ``init``
    rebuilds."""
    idx, vals, mask, carry = warm
    k0 = idx.shape[0]
    if inner_name == "gram" and tuple(carry.G.shape) != (k0, k0):
        carry = cold_inner_carry(k0, vals.dtype, vals.device)
        warm = (idx, vals, mask, carry)
    pad = k - k0
    if pad <= 0:
        return warm
    if inner_name == "gram":
        carry = InnerCarry(
            G=torch.nn.functional.pad(carry.G, (0, pad, 0, pad)),
            rho=torch.nn.functional.pad(carry.rho, (0, pad)),
            gidx=torch.nn.functional.pad(carry.gidx, (0, pad), value=-1))
    else:
        carry = cold_inner_carry(k, vals.dtype, vals.device,
                                 backend=inner_name)
    return (torch.nn.functional.pad(idx, (0, pad)),
            torch.nn.functional.pad(vals, (0, pad)),
            torch.nn.functional.pad(mask, (0, pad)), carry)


def _seq_entry(X, y, col_norm, idx, vals, mask, gidx, lam0, lam, p_true,
               loss_name):
    """Theorem-2 sequential-ball warm entry: from a cached solution at
    ``lam0 >= lam``, the ball around (lam0/lam) theta0 widened by the
    propagated gap radius contains theta*(lam); its screening survivors not
    yet resident fill the free slots (value 0, gidx -1). Returns
    (idx, vals, mask, gidx, n_survivors, n_seeded)."""
    loss = get_loss(loss_name)
    p = X.shape[1]
    k = idx.shape[0]
    vals = torch.where(mask, vals, 0.0)
    cols = X[:, idx]
    z = cols @ vals
    hat = -loss.grad(z, y) / lam0
    theta0 = feasible_dual(loss, X, y, hat, lam0)
    gap0 = torch.clamp(duality_gap(loss, cols, y, vals, theta0, lam0,
                                   mask=mask), min=0.0)
    r_gap0 = gap_ball(loss, theta0, gap0, lam0).radius
    ball = sequential_ball(loss, y, theta0, lam0, lam)
    r = ball.radius + (lam0 / lam) * r_gap0
    ub = torch.abs(X.T @ ball.center) + col_norm * r
    survive = (ub >= 1.0) & (torch.arange(p, device=X.device) < p_true)
    in_slots = torch.zeros(p, dtype=torch.bool, device=X.device)
    in_slots[idx[mask]] = True
    score = torch.where(survive & ~in_slots, ub, -torch.inf)
    order = torch.sort(score, descending=True, stable=True)
    cand_score, cand_idx = order.values[:k], order.indices[:k]
    free_pos = torch.nonzero(~mask).flatten()
    n_seeded = min(int(torch.isfinite(cand_score).sum()),
                   int(free_pos.numel()))
    pos = free_pos[:n_seeded]
    idx2, mask2, gidx2 = idx.clone(), mask.clone(), gidx.clone()
    idx2[pos] = cand_idx[:n_seeded]
    mask2[pos] = True
    if gidx2.numel() == k:
        gidx2[pos] = -1
    return idx2, vals, mask2, gidx2, int(survive.sum()), n_seeded


def seq_warm_entry(prep: PathState, warm: WarmState, k_max: int,
                   lam0: float, lam: float,
                   config: SaifConfig) -> Tuple[WarmState, int]:
    """A certified warm-entry state at ``lam`` from a cached solution at
    ``lam0`` (see :func:`_seq_entry`), at capacity max(k_max, the warm
    state's). Returns (warm state, capacity)."""
    k_out = max(int(k_max), int(warm[0].shape[0]))
    idx, vals, mask, carry = grow_warm(warm, k_out,
                                       _inner_name(prep, config, k_out))
    X = prep.X
    lam0_t = torch.tensor(lam0, dtype=X.dtype, device=X.device)
    lam_t = torch.tensor(lam, dtype=X.dtype, device=X.device)
    idx2, vals2, mask2, gidx2, _, _ = _seq_entry(
        X, prep.y, prep.col_norm, idx, vals, mask, carry.gidx, lam0_t,
        lam_t, prep.p_true or X.shape[1], config.loss)
    return (idx2, vals2, mask2, carry._replace(gidx=gidx2)), k_out


def _segments(n_lams: int, segment_len: int) -> List[slice]:
    return [slice(i, min(i + segment_len, n_lams))
            for i in range(0, n_lams, segment_len)]


def run_path(prep: PathState, lams: Sequence[float],
             config: SaifConfig = SaifConfig(),
             make_screen: Optional[Callable[[int], ScreenFn]] = None,
             segment_len: int = 16,
             warm0: Optional[WarmState] = None,
             k_max0: Optional[int] = None
             ) -> Tuple[SaifPathResult, WarmState, int]:
    """The path engine: solve the grid ``lams`` (sorted descending) from
    ``prep``, each solve warm-starting from the last. ``make_screen`` threads
    a custom screen through every solve: it is called once with the
    engine's grid-max candidate count h and returns the ScreenFn (else
    ``config.screen_backend`` picks a built-in one). ``warm0``/``k_max0``
    are an entry warm state and the capacity it was built at (None = a cold
    entry, the same as a standalone solve at the first lambda). Returns
    (result, exit warm state, capacity)."""
    X = prep.X
    n, p = X.shape
    p_true = prep.p_true or p
    unpen = config.unpen_idx
    unpen_i = -1 if unpen is None else unpen
    rule = resolve_screen_rule(config.screen_rule)
    use_seq = config.use_seq_ball and unpen is None and rule.use_seq_ball
    lams_np = np.asarray(sorted([float(l) for l in lams], reverse=True))
    screen = resolve_backend(config.screen_backend, X.device)

    hs = [add_batch_size_static(config.c, lam, prep.c0_max, prep.c0_median,
                                p_true) for lam in lams_np]
    h = max(hs) if hs else 1
    k_max = config.k_max or default_capacity(h, p_true)
    if k_max0 is not None:
        k_max = max(k_max, k_max0)
    if warm0 is not None:
        k_max = max(k_max, int(warm0[0].shape[0]))
    # the custom screen's candidate buffer is the grid-max h
    screen_fn = make_screen(h) if make_screen is not None else None

    def run_lam(lam: float, h_lam: int, warm: WarmState) -> SaifResult:
        delta0 = config.delta0 if config.delta0 is not None else \
            min(max(lam / prep.lam_max, 1e-3), 1.0)
        idx, beta, mask, carry = warm
        # per-lambda engine dispatch through the fault-injection seam
        return _fault_seam("path", lambda: _solve(
            X, prep.y, prep.col_norm, prep.c0, lam, config.eps, delta0, idx,
            beta, mask, carry, max(int(math.ceil(config.zeta * h_lam)), 1),
            h_lam, loss_name=config.loss, h=h, k_max=k_max,
            inner_epochs=config.inner_epochs,
            polish_factor=config.polish_factor, max_outer=config.max_outer,
            use_seq_ball=use_seq, screen_backend=screen,
            inner_backend=_inner_name(prep, config, k_max),
            screen_rule=rule, unpen_idx=unpen_i, p_true=p_true,
            screen_fn=screen_fn))

    results: List[SaifResult] = [None] * len(lams_np)
    if warm0 is not None:
        warm = grow_warm(warm0, k_max, _inner_name(prep, config, k_max))
    else:
        warm = cold_start(prep, hs[0] if hs else 1, k_max, config)
    for seg in _segments(len(lams_np), segment_len):
        entry = warm
        while True:
            cur = entry
            seg_results = []
            for j in range(seg.start, seg.stop):
                res = run_lam(float(lams_np[j]), hs[j], cur)
                seg_results.append(res)
                cur = _warm_state(res.active_idx, res.active_mask, res.beta,
                                  res.inner, unpen_idx=unpen_i)
            if not any(r.overflowed for r in seg_results) or k_max >= p_true:
                break
            k_max = min(2 * k_max, p_true)  # elastic growth, segment re-entry
            entry = grow_warm(entry, k_max, _inner_name(prep, config, k_max))
        results[seg] = seg_results
        warm = cur
    return (SaifPathResult(lams=lams_np, betas=[r.beta for r in results],
                           results=results),
            warm, k_max)


def saif_path(X, y, lams: Sequence[float],
              config: SaifConfig = SaifConfig(),
              make_screen: Optional[Callable[[int], ScreenFn]] = None,
              segment_len: int = 16, device=None) -> SaifPathResult:
    """DEPRECATED legacy frontend: a one-shot session over
    :func:`run_path` from a cold entry. Use
    ``repro_torch.open_session(Problem(X, y), config).solve(Path(lams))``;
    a held-open session keeps the preparation and the warm buffers for the
    next request. ``device=None`` runs on the card."""
    from repro_torch.core._compat import warn_deprecated
    from repro_torch.core.api import Path as PathRequest
    from repro_torch.core.api import Problem, open_session
    warn_deprecated("repro_torch.saif_path", "session.solve(Path(lams))")
    sess = open_session(Problem(X=X, y=y, loss=config.loss), config,
                        make_screen=make_screen, segment_len=segment_len,
                        device=device)
    return sess.solve(PathRequest(lams=tuple(float(l) for l in lams)))


def saif_path_naive(X, y, lams: Sequence[float],
                    config: SaifConfig = SaifConfig(),
                    device=None) -> SaifPathResult:
    """One full :func:`~repro_torch.core.saif.saif` per lambda, warm-started
    from the previous solution's nonzero support: the reference's
    pre-engine driver, kept as a parity oracle."""
    dev = resolve_device(device)
    lams_np = np.asarray(sorted([float(l) for l in lams], reverse=True))
    betas, results = [], []
    warm_idx = warm_beta = None
    for lam in lams_np:
        res = saif(X, y, float(lam), config, warm_idx=warm_idx,
                   warm_beta=warm_beta, device=dev)
        betas.append(res.beta)
        results.append(res)
        support = torch.nonzero(torch.abs(res.beta) > 0).flatten()
        if support.numel():
            warm_idx, warm_beta = support, res.beta[support]
        else:
            warm_idx = warm_beta = None
    return SaifPathResult(lams=lams_np, betas=betas, results=results)


def lambda_grid(lam_max: float, n: int, lo_frac: float = 1e-3) -> np.ndarray:
    """Log-evenly spaced descending grid in [lo_frac*lam_max, lam_max)."""
    return np.geomspace(lam_max * (1 - 1e-9), lam_max * lo_frac, n)
