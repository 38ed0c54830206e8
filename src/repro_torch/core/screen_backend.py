"""Pluggable screening backends for the SAIF ADD phase (port of the serial
parts of ``repro.core.screen_backend``).

Per outer iteration the ADD decision needs, from the full feature set R_t:
the ADD-stop reduction max ub, the top-h candidates (score, feature id),
their lower bounds lb_l = |score_l - ||x_l|| r| and their violation counts
|V_l| = #{i in R_t : ub_i >= lb_l}. A :data:`ScreenFn` returns all of them
as one :class:`ScreenOut`. Two backends (and
:func:`make_screen_from_scan`, which wraps a caller's own scan):

  * ``torch`` — one matvec, a stable descending sort for the top-h, and
                searchsorted/bincount counts (the reference's ``jnp``);
  * ``cuda``  — kernels K1 (masked scan + tile top-h + tile max-ub) and K2
                (the tail: the candidates' bounds, the ub histogram against
                them, the counts, the survivors and max ub, in one launch),
                the reference's ``pallas``.

Both give the same candidates and the same integer counts: top-h ties go
to the lowest feature id (``jax.lax.top_k``'s order), which ``torch.topk``
does not promise, so every top-h here is a stable sort.

The fast fleet (``parity="fast"``) screens through
:func:`make_batch_screen_fast`, the certified mixed-precision screen.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence

import torch

from repro_torch.core.duality import (mixed_precision_gamma, unit_roundoff,
                                      widened_radius)
# the rule/backend seam: re-exported so rule consumers import one module
from repro_torch.core.screen_rule import (SCREEN_RULES,  # noqa: F401
                                          ScreenRule, resolve_screen_rule)
from repro_torch.kernels.screen.ref import (ge_counts_from_hist,
                                            survivor_count)
from repro_torch.kernels.screen.screen import TC_UNIT_ROUNDOFF, scan_input

Tensor = torch.Tensor


class ScreenOut(NamedTuple):
    max_ub: Tensor      # scalar: max over R_t of ub (−inf if R_t empty)
    cand_score: Tensor  # (h,) top-h scores over R_t (−inf padded)
    cand_idx: Tensor    # (h,) int64 global feature ids
    cand_lb: Tensor     # (h,) |score − ||x|| r| per candidate
    cand_ge: Tensor     # (h,) int32 #{i in R_t : ub_i >= cand_lb}
    n_surv: Tensor      # int32 #{i in R_t : ub_i >= 1}


# signature: (theta (n,), r scalar, in_active (p,) bool) -> ScreenOut
ScreenFn = Callable[[Tensor, Tensor, Tensor], ScreenOut]
# fleet signature, per problem of the fleet: (thetas, rs, in_actives, do)
# -> one ScreenOut each; a problem whose ``do`` is False passes None and
# gets the neutral :func:`_skip_screen_out`
BatchScreenFn = Callable[[Sequence[Optional[Tensor]],
                          Sequence[Optional[Tensor]],
                          Sequence[Optional[Tensor]], Sequence[bool]],
                         List[ScreenOut]]


def _top(x: Tensor, h: int):
    """Top-h of a 1-D tensor, ties to the lowest index (lax.top_k order)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:h], idx[:h]


def violation_ge_counts(ub: Tensor, lb_cand: Tensor) -> Tensor:
    """Plain counts #{i : ub_i >= lb_l} per candidate, sort-free in p."""
    h = lb_cand.shape[0]
    lb_sorted = torch.sort(lb_cand).values
    c = torch.searchsorted(lb_sorted, ub, right=True)
    hist = torch.bincount(c, minlength=h + 1)
    return ge_counts_from_hist(hist, lb_sorted, lb_cand)


def _candidate_out(scores_masked, ub, col_norm, r, h) -> ScreenOut:
    """Shared tail: top-h + bounds + counts from masked scores and ub."""
    cand_score, cand_idx = _top(scores_masked, h)
    cand_lb = torch.abs(cand_score - col_norm[cand_idx] * r)
    cand_ge = violation_ge_counts(ub, cand_lb)
    return ScreenOut(max_ub=torch.max(ub), cand_score=cand_score,
                     cand_idx=cand_idx, cand_lb=cand_lb, cand_ge=cand_ge,
                     n_surv=survivor_count(ub))


def make_screen_from_scan(scan_fn: Callable[[Tensor], Tensor],
                          col_norm: Tensor, h: int) -> ScreenFn:
    """Adapt a bare ``theta -> |X^T theta|`` scan to the full backend
    interface; everything past the scan is the plain screen's O(p) tail."""
    def screen(theta, r, in_active):
        masked = torch.where(in_active, -torch.inf, scan_fn(theta))
        ub = masked + col_norm * r
        return _candidate_out(masked, ub, col_norm, r, h)
    return screen


def make_screen_torch(X: Tensor, col_norm: Tensor, h: int) -> ScreenFn:
    """Plain backend: one matvec (``theta @ X``) + cheap reductions. The
    row-vector orientation keeps each column's sum independent of how
    many columns follow it, so p-bucket padding leaves every real
    column's score bitwise unchanged."""
    return make_screen_from_scan(lambda theta: torch.abs(theta @ X),
                                 col_norm, h)


def make_screen_cuda(X: Tensor, col_norm: Tensor, h: int) -> ScreenFn:
    """Kernel backend: K1 scans, the (p/BP) h tile winners merge into the
    global top-h, and K2 computes the rest of the screen in one launch
    (``screen_tail``)."""
    from repro_torch.kernels.screen.screen import screen_fused, screen_tail

    def screen(theta, r, in_active):
        _, ub, _, tops, topi, tmax = screen_fused(X, theta, col_norm,
                                                  in_active, r, h=h)
        # merge tile winners: O((p/BP) h) candidates, not O(p); a saturated
        # tile can name a padding lane (id >= p) with score -inf, which is
        # never kept
        cand_score, pos = _top(tops.reshape(-1), h)
        cand_idx = topi.reshape(-1)[pos].long()
        max_ub, cand_lb, cand_ge, n_surv = screen_tail(
            ub, tmax, cand_score, cand_idx, col_norm, r)
        return ScreenOut(max_ub=max_ub, cand_score=cand_score,
                         cand_idx=cand_idx, cand_lb=cand_lb, cand_ge=cand_ge,
                         n_surv=n_surv)
    return screen


# --------------------------------------------------------------------------
# fleet screens (core/batch.py): B problems over one shared design
# --------------------------------------------------------------------------
# The default ``torch`` fleet screen is a loop of the SERIAL screen over the
# problems whose ADD phase runs this step: each problem's scan is the
# literal serial matvec on its own tensors, so fleet decisions are bitwise
# those of B serial solves. ``cuda`` runs kernels K1b and K2b: one scan of
# the shared X for the whole fleet, each problem's scores bitwise K1's. The
# opt-in ``matmul`` screen turns the fleet's scans into one (B, n) x (n, p)
# product (ulp-grade against serial scans); ``distinct`` scans per-problem
# designs. A problem's top-h needs only the fleet's h candidates (the
# maximum over the fleet): a stable top-h is a prefix of a stable top-h'
# for h <= h', so each problem's own h_cap-prefix is its serial top-h.
# ``col_norm`` is the shared (p,) vector or, for a weighted fleet, a (B, p)
# matrix whose row b is problem b's own norms; a problem's scores, bounds
# and candidates read its own row.


def fleet_col_norms(col_norm: Tensor, b: int) -> Tensor:
    """(B, p) fleet column norms from a shared (p,) vector (a broadcast
    view) or pass-through."""
    return col_norm.expand(b, -1) if col_norm.ndim == 1 else col_norm


def _skip_screen_out(h: int, dtype, device) -> ScreenOut:
    """Neutral ScreenOut of a skipped problem: max_ub = -inf, no finite
    candidates (the engine reads nothing of it)."""
    return ScreenOut(max_ub=torch.tensor(-torch.inf, dtype=dtype,
                                         device=device),
                     cand_score=torch.full((h,), -torch.inf, dtype=dtype,
                                           device=device),
                     cand_idx=torch.zeros(h, dtype=torch.long, device=device),
                     cand_lb=torch.full((h,), torch.inf, dtype=dtype,
                                        device=device),
                     cand_ge=torch.zeros(h, dtype=torch.int32, device=device),
                     n_surv=torch.zeros((), dtype=torch.int32, device=device))


def _rows(out: ScreenOut, do: Sequence[bool], skip: ScreenOut
          ) -> List[ScreenOut]:
    """Split a batched ScreenOut over the ``do`` problems into one per
    problem of the fleet, ``skip`` for the others."""
    it = zip(*out)
    return [ScreenOut(*next(it)) if d else skip for d in do]


def _candidate_out_batch(masked: Tensor, ub: Tensor, col_norm: Tensor,
                         r: Tensor, h: int) -> ScreenOut:
    """Batched :func:`_candidate_out`: per-row top-h, bounds and counts
    from masked scores and ub (B, p); ``col_norm`` (p,) or (B, p), r (B,).
    The counts are exact: a per-row histogram of searchsorted positions."""
    b, p = masked.shape
    vals, idx = torch.sort(masked, dim=1, descending=True, stable=True)
    cand_score, cand_idx = vals[:, :h], idx[:, :h]
    cn = fleet_col_norms(col_norm, b)
    cand_lb = torch.abs(cand_score - torch.gather(cn, 1, cand_idx)
                        * r[:, None])
    lb_sorted = torch.sort(cand_lb, dim=1).values
    c = torch.searchsorted(lb_sorted, ub, right=True)
    c = c + (h + 1) * torch.arange(b, device=c.device)[:, None]
    hist = torch.bincount(c.flatten(), minlength=b * (h + 1)).reshape(b, -1)
    return ScreenOut(max_ub=torch.amax(ub, dim=1), cand_score=cand_score,
                     cand_idx=cand_idx, cand_lb=cand_lb,
                     cand_ge=ge_counts_from_hist(hist, lb_sorted, cand_lb),
                     n_surv=torch.sum(ub >= 1.0, dim=1, dtype=torch.int32))


def make_batch_screen_torch(X: Tensor, col_norm: Tensor,
                            h: int) -> BatchScreenFn:
    """Default fleet screen: the serial plain screen per problem whose
    ``do`` is set (the reference's ``jnp``), each on its own norms."""
    skip = _skip_screen_out(h, X.dtype, X.device)

    def screen(thetas, rs, in_actives, do):
        cns = fleet_col_norms(col_norm, len(do))
        return [make_screen_torch(X, cn, h)(th, r, act) if d else skip
                for cn, th, r, act, d in zip(cns, thetas, rs, in_actives,
                                             do)]
    return screen


def make_batch_screen_matmul(X: Tensor, col_norm: Tensor,
                             h: int) -> BatchScreenFn:
    """Shared-X screen: one (B, n) x (n, p) product scans the fleet
    (ulp-grade against serial scans; opt-in)."""
    skip = _skip_screen_out(h, X.dtype, X.device)

    def screen(thetas, rs, in_actives, do):
        sel = [i for i, d in enumerate(do) if d]
        Theta = torch.stack([thetas[i] for i in sel])
        r = torch.stack([rs[i] for i in sel])
        masked = torch.where(torch.stack([in_actives[i] for i in sel]),
                             -torch.inf, torch.abs(Theta @ X))
        cn = fleet_col_norms(col_norm, len(do))[sel]
        ub = masked + cn * r[:, None]
        return _rows(_candidate_out_batch(masked, ub, cn, r, h), do, skip)
    return screen


def make_batch_screen_distinct(Xs: Tensor, col_norm: Tensor,
                               h: int) -> BatchScreenFn:
    """Per-problem designs Xs (B, n, p): one batched contraction scans the
    problems whose ``do`` is set."""
    skip = _skip_screen_out(h, Xs.dtype, Xs.device)

    def screen(thetas, rs, in_actives, do):
        sel = [i for i, d in enumerate(do) if d]
        Theta = torch.stack([thetas[i] for i in sel])
        r = torch.stack([rs[i] for i in sel])
        cn = fleet_col_norms(col_norm, len(do))[sel]
        score = torch.abs(torch.einsum("bnp,bn->bp", Xs[sel], Theta))
        masked = torch.where(torch.stack([in_actives[i] for i in sel]),
                             -torch.inf, score)
        ub = masked + cn * r[:, None]
        return _rows(_candidate_out_batch(masked, ub, cn, r, h), do, skip)
    return screen


def _kernel_screen(X: Tensor, Theta: Tensor, col_norm: Tensor,
                   in_active: Tensor, r: Tensor, h: int, plain: bool = False,
                   **mode):
    """K1b scans the shared X for the m problems of Theta (m, n) (``mode``:
    its ``in_dtype`` / ``guard``; col_norm and r then in the sums' type),
    each problem's (p/BP) h tile winners merge into its top-h, and K2b
    computes the rest of every problem's screen in one launch
    (``screen_tail_batch``). ``plain``: the kernels' plain versions, on
    any device (X then already in the sums' type). Returns the batched
    ScreenOut and the masked scores (m, p)."""
    from repro_torch.kernels.screen.ref import (screen_fused_batch_ref,
                                                screen_tail_batch_ref)
    from repro_torch.kernels.screen.screen import (screen_fused_batch,
                                                   screen_tail_batch)
    m = Theta.shape[0]
    if plain:
        in_dt = mode.get("in_dtype", Theta.dtype)
        screen_tail_batch = screen_tail_batch_ref
        score, ub, _, tops, topi, tmax = screen_fused_batch_ref(
            X, Theta.to(in_dt).to(X.dtype), col_norm, in_active, r, h=h,
            guard=mode.get("guard", 1.0))
    else:
        score, ub, _, tops, topi, tmax = screen_fused_batch(
            X, Theta, col_norm, in_active, r, h=h, **mode)
    # merge each problem's tile winners: O((p/BP) h) candidates
    vals, pos = torch.sort(tops.reshape(m, -1), dim=1, descending=True,
                           stable=True)
    cand_score = vals[:, :h]
    cand_idx = torch.gather(topi.reshape(m, -1), 1, pos[:, :h]).long()
    max_ub, cand_lb, cand_ge, n_surv = screen_tail_batch(
        ub, tmax, cand_score, cand_idx, col_norm, r)
    return ScreenOut(max_ub=max_ub, cand_score=cand_score, cand_idx=cand_idx,
                     cand_lb=cand_lb, cand_ge=cand_ge, n_surv=n_surv), score


def make_batch_screen_cuda(X: Tensor, col_norm: Tensor,
                           h: int) -> BatchScreenFn:
    """Kernel fleet screen: :func:`_kernel_screen` for every problem whose
    ``do`` is set (with the shared norms, or each problem's own row of a
    (B, p) matrix; the reference's ``pallas``)."""
    skip = _skip_screen_out(h, X.dtype, X.device)

    def screen(thetas, rs, in_actives, do):
        sel = [i for i, d in enumerate(do) if d]
        out, _ = _kernel_screen(
            X, torch.stack([thetas[i] for i in sel]),
            col_norm if col_norm.ndim == 1 else col_norm[sel],
            torch.stack([in_actives[i] for i in sel]),
            torch.stack([rs[i] for i in sel]), h)
        return _rows(out, do, skip)
    return screen


def scan_unit_roundoff(in_dtype, device, plain: bool = False) -> float:
    """The unit roundoff of the screen scan's sums on the route that runs
    them, for X and theta rounded to ``in_dtype`` (a torch dtype or its
    name) and summed in float32 or the input type, the wider. The card's
    bf16 route (K1/K1b's tensor-core scan, unless ``plain``) is certified
    as a truncating float32 adder, 2^-23; every other route (the CPU, the
    plain versions, the float32-input and working modes' fma chains) rounds
    to nearest: the sums' type's u, the reference's."""
    if isinstance(in_dtype, str):
        in_dtype = getattr(torch, in_dtype)
    if (in_dtype == torch.bfloat16 and torch.device(device).type == "cuda"
            and not plain):
        return TC_UNIT_ROUNDOFF
    return unit_roundoff(torch.promote_types(torch.float32, in_dtype))


def scan_gamma(n: int, in_dtype, device, plain: bool = False) -> float:
    """gamma_total of the screen scan's dot on its route
    (:func:`scan_unit_roundoff`): the reference's ``mixed_precision_gamma``
    bit for bit wherever the sums round to nearest."""
    if isinstance(in_dtype, str):
        in_dtype = getattr(torch, in_dtype)
    return mixed_precision_gamma(
        n, in_dtype, torch.promote_types(torch.float32, in_dtype),
        u_acc=scan_unit_roundoff(in_dtype, device, plain))


def make_batch_screen_fast(X: Tensor, col_norm: Tensor, h: int,
                           screen_dtype: str = "working",
                           plain: bool = False):
    """Certified mixed-precision fleet screen (``parity="fast"``; port of
    ``repro/core/screen_backend.py:330-427``).

    Returns ``screen(Theta (B, n), r (B,), in_active (B, p), do (B,) bool)
    -> ScreenOut`` with a leading B on every field, all in X's (working)
    dtype. Every row is scanned once with X and theta rounded to
    ``screen_dtype`` ("working" | "float32" | "bfloat16") and summed in
    float32 (working: in X's dtype). Safety: the radius is widened by the
    certified bound gamma_total ||theta|| of that dot on its route
    (:func:`scan_gamma`; :func:`~repro_torch.core.duality.widened_radius`)
    before any bound is formed, and ub by the scalar guard (1 + 8 u_acc)
    that covers the bound pipeline's own roundings, so a feature this
    screen rules out the exact screen rules out too. Candidate selection
    is heuristic-grade and runs on the low-precision scores.

    A low-precision pass can leave a row's ADD stop undecidable: its ub
    refuses max ub < 1 while the anti-conservative bound, (1 - 8 u_acc)
    at the radius narrowed by the same widening, says the exact screen
    would stop. Such rows of ``do`` re-screen in working precision at the
    working-gamma radius (one host read decides); the others keep the
    cheap pass, cast to the working dtype.

    On a card the pass is K1b in its mixed mode over X cast once here
    (bf16: the tensor-core scan, certified with a truncating float32 adder;
    working mode: K1b on X itself), the guard in K1b's epilogue, then
    the tile merge and K2b's tail in float32; an escalation runs K1b and
    K2b in working precision on the undecidable rows only (its selection
    in working precision too, which the contract allows). On the CPU the
    same steps run the kernels' plain versions; ``plain`` takes them on a
    card too (the explicit ``screen_backend="torch"``).
    ``screen.escalated`` counts the escalated rows since the screen was
    made, ``screen.last_escalated`` lists those of the last call.
    """
    n = X.shape[0]
    work = X.dtype
    low = screen_dtype != "working"
    in_dt = getattr(torch, screen_dtype) if low else work
    acc = torch.promote_types(torch.float32, in_dt) if low else work
    plain = plain or X.device.type == "cpu"
    gamma = scan_gamma(n, in_dt, X.device, plain)
    gamma_work = mixed_precision_gamma(n, work, work)
    u_acc = unit_roundoff(acc)       # the epilogue's roundings: to nearest
    one_plus, one_minus = 1.0 + 8.0 * u_acc, 1.0 - 8.0 * u_acc
    # cast once: the design in the input type and its kernel's layout (freed
    # with the screen; the plain path holds its values in the sums' type),
    # the norms in the sums' type
    Xc = (X.to(in_dt).to(acc) if low and plain else
          scan_input(X, in_dt) if low else X)
    cn = col_norm.to(acc)
    mode = {"in_dtype": in_dt, "guard": one_plus} if low else {
        "guard": one_plus}

    def screen(Theta, r, in_active, do):
        r_wide = widened_radius(r, Theta, gamma)
        out, masked = _kernel_screen(Xc, Theta, cn, in_active, r_wide.to(acc),
                                     h, plain, **mode)
        if not low:
            return out
        widen = (r_wide - r).to(acc)
        r_lo = r_wide.to(acc) - 2.0 * widen
        cn_b = fleet_col_norms(cn, Theta.shape[0])
        ub_lo = torch.amax((masked + cn_b * r_lo[:, None]) * one_minus,
                           dim=1)
        undec = do & (out.max_ub >= 1.0) & (ub_lo < 1.0)
        flags = undec.tolist()
        out = out._replace(max_ub=out.max_ub.to(work),
                           cand_score=out.cand_score.to(work),
                           cand_lb=out.cand_lb.to(work))
        esc = screen.last_escalated = [i for i, u in enumerate(flags) if u]
        if not esc:
            return out
        screen.escalated += len(esc)
        rows = torch.tensor(esc, device=X.device)
        th = Theta[rows]
        hot, _ = _kernel_screen(
            X, th, col_norm if col_norm.ndim == 1 else col_norm[rows],
            in_active[rows], widened_radius(r[rows], th, gamma_work), h,
            plain)
        return ScreenOut(*[f.index_copy(0, rows, g)
                           for f, g in zip(out, hot)])

    screen.escalated = 0
    screen.last_escalated = []
    return screen


def make_batch_screen(name: str, X: Tensor, col_norm: Tensor,
                      h: int) -> BatchScreenFn:
    """Fleet screen by resolved name (see :func:`resolve_batch_screen`)."""
    if name == "cuda":
        return make_batch_screen_cuda(X, col_norm, h)
    if name == "matmul":
        return make_batch_screen_matmul(X, col_norm, h)
    return make_batch_screen_torch(X, col_norm, h)


# The reference's measured CPU crossover (its DESIGN.md §8): below this B*p
# the per-problem ``do`` skip of the serial-scan screen beats one product
# for the whole fleet end to end, so an informed call downgrades ``matmul``.
MATMUL_MIN_BP = 32_768


def resolve_batch_screen(name: str, device: torch.device, *,
                         b: Optional[int] = None,
                         p: Optional[int] = None) -> str:
    """Fleet screen policy: ``auto`` takes the kernels (K1b/K2b) on a CUDA
    device and the serial-scan screen elsewhere; ``matmul`` is honoured on
    a card, and on the CPU only when B*p reaches :data:`MATMUL_MIN_BP`
    (an uninformed call, without ``b``/``p``, keeps it)."""
    if name == "matmul":
        if torch.device(device).type != "cpu" or b is None or p is None:
            return name
        return name if b * p >= MATMUL_MIN_BP else "torch"
    return resolve_backend(name, device)


def resolve_backend(name: str, device: torch.device) -> str:
    """Backend policy: an explicit name wins; ``auto`` takes the kernels
    when the data lies on a CUDA device and the plain path elsewhere."""
    if name == "auto":
        return "cuda" if torch.device(device).type == "cuda" else "torch"
    if name not in ("torch", "cuda"):
        raise ValueError(f"unknown screen backend {name!r}")
    return name
