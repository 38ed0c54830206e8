"""The fleet: B LASSO problems over one shared design, solved together
(port of the bitwise engine of ``repro.core.batch``).

Traffic often arrives as fleets: many responses over one design, or one
response over a lambda grid. Each problem has its own response and its own
lambda; the fleet shares what is shared, the design and the O(n p)
screening scan, and keeps everything else per problem:

  * **one host loop** — :func:`_solve_fleet` drives every problem through
    the serial engine (:func:`repro_torch.core.saif._advance`) at once; a
    problem that stops, or whose ADD overflows its capacity, freezes there
    and costs nothing more, while the stragglers go on;
  * **shared scans** — one fleet screen per outer step covers every
    problem whose ADD phase runs; on a card it is kernel K1b, which reads X
    once per chunk of 16 problems, and K2b for the violation counts;
  * **shared bursts** — on a card one K3b launch runs the CM bursts of
    every live problem, one CTA each, and one K6b launch the Gram sweeps
    of a Gram fleet; the plain backend (and the Gram one on the CPU) runs
    each problem's serial burst.

The contract (the reference's DESIGN.md §8): row b of a fleet equals the
port's serial ``saif(X, Y[b], lams[b], config)`` bit for bit — beta, gap,
outer steps, active count, overflow flag and every trace — and, where the
two capacities match, the slot layout too. Every float computation runs
per problem on that problem's own tensors, in the serial order; only exact
work is batched (elementwise ops, maxima, stable sorts, integer counts and
the host reads). The fleet's candidate buffer is the largest h of its
problems; each problem keeps its own h_cap, h~ and post-check width, and a
stable top-h is a prefix of a longer one, so its decisions are its serial
ones. Capacity invariance (dead slots add exact zeros) carries the rest.

Sample ``weights`` (B, n) make each problem the weighted LASSO on its own
rows (binary weights = row subsampling, the K-fold CV trick of
``core/cv.py``): each problem has its own c0 and column norms
sqrt(w_b . X^2) (a (B, p) matrix, one matvec per problem), its own
weighted inner backend and dual tail, and the Thm-2 sequential ball is
off (it assumes the unweighted null dual). The weighted contract: row b of
a weighted fleet equals the fleet of one of problem b, bit for bit.

``SaifConfig(parity="fast")`` sends a least-squares fleet to the lockstep
engine of ``core/batch_fast.py`` (any other loss, and a caller's own
``screen_fn``, keep this engine, as in the reference) and, for every loss,
prepares the fleet the fast way: c0 as one product, the h formula's median
on float32 scores.

Bucket padding (:func:`pad_fleet_prep`, the reference's DESIGN.md §12): a
padded preparation carries zero rows and columns up to a bucket shape with
the real problems' statistics; the pad columns are born active without a
slot in every problem, in both engines, so no screen scores them, and
every policy formula (h, capacity, the inner routing) reads the real
``n_true``/``p_true``. A p-only padded fleet is bitwise the unpadded one.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Optional

import torch

from repro_torch.core import active_set as aset_lib
from repro_torch.core.batch_fast import (prepare_fleet_stats_fast,
                                         solve_fleet_fast)
from repro_torch.core.inner_backend import (GRAM_CROSSOVER,
                                            cold_inner_carry_batch,
                                            make_batch_inner,
                                            resolve_inner_backend)
from repro_torch.core.losses import get_loss
from repro_torch.core.saif import (SaifConfig, SaifResult, _advance,
                                   _median, _Problem, add_batch_size_static,
                                   as_tensor, default_capacity,
                                   resolve_device)
from repro_torch.core.screen_backend import (make_batch_screen,
                                             resolve_batch_screen,
                                             resolve_screen_rule)
from repro_torch.core.duality import null_gradient
from repro_torch.runtime.inject import seam as _fault_seam

Tensor = torch.Tensor


class FleetPrep(NamedTuple):
    """One-time per-fleet preparation (one host read for the h formula).
    ``c0_max`` is each problem's lambda_max."""
    X: Tensor               # (n, p) shared design
    Y: Tensor               # (B, n)
    c0: Tensor              # (B, p) per-problem |X^T (w *) f'(0)|
    col_norm: Tensor        # (p,) shared column norms, or (B, p) weighted
    c0_max: list            # B host floats (= per-problem lambda_max)
    c0_median: list
    n_true: int = 0         # 0 = unpadded (see pad_fleet_prep)
    p_true: int = 0
    W: Optional[Tensor] = None  # (B, n) sample weights, None = unweighted


def prepare_fleet(X, Y, config: SaifConfig = SaifConfig(), weights=None,
                  device=None) -> FleetPrep:
    """Per-problem null gradients and c0, the column norms, and one host
    read of the c0 statistics the h formula needs. Each problem's c0 is
    the serial ``null_gradient`` matvec on its own response, so lambda_max,
    delta0, the cold start and the Thm-2 ball are bitwise the serial
    ones. With ``weights`` (B, n) each problem's null gradient is weighted
    and its column norms are sqrt(w_b . X^2), each from its own matvec (a
    (B, n) x (n, p) product may pick another kernel for another B, which
    would break the fleet-of-one contract). Under ``parity="fast"`` the
    fleet's c0 is one product and the median is taken on float32 scores
    (``batch_fast.prepare_fleet_stats_fast``)."""
    dev = resolve_device(device)
    loss = get_loss(config.loss)
    X = as_tensor(X, dev)
    Y = as_tensor(Y, dev, X.dtype)
    if Y.ndim == 1:
        Y = Y[None]
    W = None
    if weights is not None:
        W = as_tensor(weights, dev, X.dtype)
        if W.ndim == 1:
            W = W[None]
        if W.shape != Y.shape:
            raise ValueError(f"weights must be (B, n) = {tuple(Y.shape)}, "
                             f"got {tuple(W.shape)}")
    if config.parity == "fast":
        c0, col_norm, mx, md = prepare_fleet_stats_fast(X, Y, W, loss)
        return FleetPrep(X=X, Y=Y, c0=c0, col_norm=col_norm, c0_max=mx,
                         c0_median=md, W=W)
    if W is None:
        c0 = [null_gradient(loss, X, y.clone())[1] for y in Y]
        col_norm = torch.linalg.vector_norm(X, dim=0)
    else:
        c0 = [torch.abs(X.T @ (w * loss.grad(torch.zeros_like(y), y)))
              for y, w in zip(Y, W)]
        XX = X * X
        col_norm = torch.stack([torch.sqrt(w.clone() @ XX) for w in W])
        del XX
    stats = torch.stack([torch.stack((torch.max(c), _median(c)))
                         for c in c0]).tolist()
    return FleetPrep(X=X, Y=Y, c0=torch.stack(c0), col_norm=col_norm,
                     c0_max=[s[0] for s in stats],
                     c0_median=[s[1] for s in stats], W=W)


def pad_fleet_prep(prep: FleetPrep, n_bucket: int,
                   p_bucket: int) -> FleetPrep:
    """Zero-pad a real fleet preparation up to a bucket shape, the fleet
    edition of :func:`~repro_torch.core.saif.pad_path_state`: the
    per-problem statistics stay those of the real problems (c0 pads at
    -inf, column-norm pads at 1.0, zero pad rows with weight 0), and
    ``n_true``/``p_true`` feed every policy formula."""
    n, p = prep.X.shape
    if n_bucket < n or p_bucket < p:
        raise ValueError(
            f"bucket ({n_bucket}, {p_bucket}) must dominate the fleet "
            f"design shape ({n}, {p})")
    if (n_bucket, p_bucket) == (n, p):
        return prep
    dn, dp = n_bucket - n, p_bucket - p
    pad = torch.nn.functional.pad
    return prep._replace(
        X=pad(prep.X, (0, dp, 0, dn)), Y=pad(prep.Y, (0, dn)),
        W=None if prep.W is None else pad(prep.W, (0, dn)),
        c0=pad(prep.c0, (0, dp), value=-math.inf),
        col_norm=pad(prep.col_norm, (0, dp), value=1.0),
        n_true=n, p_true=p)


def fleet_batch_sizes(prep: FleetPrep, lams, config: SaifConfig):
    """Per-problem h values and the fleet's candidate buffer, their
    maximum (each already a power of two)."""
    p = prep.p_true or prep.X.shape[1]
    hs = [add_batch_size_static(config.c, float(lam), mx, md, p)
          for lam, mx, md in zip(lams, prep.c0_max, prep.c0_median)]
    return hs, (max(hs) if hs else 1)


def initial_support_batch(c0: Tensor, hs, k_max: int, p: int, dtype):
    """Cold start per problem: its top-h_b features by c0, ties to the
    lowest id, in (B, k_max) slot buffers. One stable sort per row gives
    every problem's serial ``initial_support`` layout (a stable top-h is a
    prefix of a longer one). Returns (init_idx, init_beta, init_mask)."""
    b = c0.shape[0]
    n_cap = min(max(hs), k_max, p)
    top = torch.sort(c0, dim=1, descending=True, stable=True).indices
    n_init = torch.tensor([min(h, k_max, p) for h in hs], device=c0.device)
    init_idx = torch.zeros((b, k_max), dtype=torch.long, device=c0.device)
    init_idx[:, :n_cap] = top[:, :n_cap]
    mask = torch.arange(k_max, device=c0.device)[None, :] < n_init[:, None]
    init_idx = torch.where(mask, init_idx, 0)
    return (init_idx, torch.zeros((b, k_max), dtype=dtype, device=c0.device),
            mask)


def _delta0s(prep: FleetPrep, lams, config: SaifConfig):
    if config.delta0 is not None:
        return [float(config.delta0)] * len(lams)
    return [min(max(float(lam) / mx, 1e-3), 1.0)
            for lam, mx in zip(lams, prep.c0_max)]


def resolve_batch_inner(config: SaifConfig, n: int, k_max: int, b: int,
                        device, itemsize: int = 8,
                        weighted: bool = False,
                        n_pad: Optional[int] = None) -> str:
    """Fleet inner policy: the serial one. On a card ``auto`` takes the
    Gram engine (K6b) for least squares under the crossover, as the
    reference does, and otherwise K3b while one problem's burst fits K3's
    shared memory (``cm_smem_ok(n, k_max)``): each problem has its own CTA
    and its own shared memory, so the fleet size ``b`` adds nothing to
    either gate.

    A ``weighted`` fleet keeps the reference's policy: the kernel burst
    refuses sample weights, so ``auto`` on a card takes the Gram engine
    (K6b) for least squares while GRAM_CROSSOVER * n >= k_max and raises
    otherwise (logistic: the reference's ``auto`` on its accelerator
    picks the kernel, which refuses weights), naming
    ``inner_backend="torch"``; on the CPU ``auto`` keeps torch/gram.
    ``n`` is the real row count; ``n_pad`` the padded one the kernels
    get (see :func:`~repro_torch.core.inner_backend.resolve_inner_backend`).
    """
    del b                                   # no fleet factor on the card
    ls = config.loss == "least_squares"
    name = config.inner_backend
    if (weighted and name == "auto"
            and torch.device(device).type == "cuda"):
        if not (ls and GRAM_CROSSOVER * n >= k_max):
            raise ValueError(
                f"a weighted {config.loss} fleet (n={n}, k_max={k_max}) "
                f"has no kernel inner backend on the card: the CM burst "
                f"kernel does not take sample weights"
                + ("" if not ls else " and the Gram engine is past its "
                   "n/k_max crossover")
                + "; pass inner_backend=\"torch\" (a host loop on the "
                  "card)")
        name = "gram"
    name = resolve_inner_backend(name, config.loss, n, k_max, device,
                                 itemsize, n_pad=n_pad)
    if weighted and name == "cuda":
        raise ValueError("the batched cuda inner backend does not take "
                         "sample weights; use 'torch' or 'gram' for CV "
                         "fleets")
    return name


def _solve_fleet(prep: FleetPrep, lams, config: SaifConfig, *, hs, h, k_max,
                 init_idx, init_beta, init_mask, inner: str, screen: str,
                 use_seq: bool, rule, carries=None, screen_fn=None,
                 pad_mask: Optional[Tensor] = None) -> List[SaifResult]:
    """One pass of the fleet at capacity ``k_max`` (the reference's
    ``_saif_batch_jit``): per-problem states advanced by one host loop,
    from the (B, k_max) slot buffers ``init_*`` and, for a warm entry, the
    problems' inbound inner ``carries`` (None = cold; a Gram carry whose
    live slots still back the same features is kept, else rebuilt once).
    ``screen_fn`` is a caller's :data:`BatchScreenFn` (else the resolved
    ``screen``'s); ``pad_mask`` (p,) flags bucket-pad columns, born
    active without a slot in every problem. Returns one serial-form
    result per problem."""
    loss = get_loss(config.loss)
    X, col_norm = prep.X, prep.col_norm
    p, dt = X.shape[1], X.dtype
    b = prep.Y.shape[0]
    ys = [y.clone() for y in prep.Y]        # each problem's own tensor
    ws = [None] * b if prep.W is None else [w.clone() for w in prep.W]
    cns = ([col_norm] * b if col_norm.ndim == 1
           else [cn.clone() for cn in col_norm])
    binner = make_batch_inner(inner, loss, X, ys, col_norm, hs,
                              None if prep.W is None else ws)
    asets = aset_lib.init_active_set_batch(p, k_max, init_idx, dt, init_beta,
                                           init_mask)
    if pad_mask is not None:
        asets = [a._replace(in_active=a.in_active | pad_mask) for a in asets]
    if carries is None:
        carries = cold_inner_carry_batch(b, k_max, dt, X.device, inner)
    carries = binner.init(asets, carries,
                          aset_lib.gather_columns_batch(X, asets))
    delta0 = _delta0s(prep, lams, config)
    probs = [_Problem(y, lam, config.eps, d0,
                      max(int(math.ceil(config.zeta * h_b)), 1), h_b, h_b,
                      c0, aset, carry,
                      binner.make_one(y, h_b, w) if binner.make_one else None,
                      cn=cn, w=w)
             for y, w, cn, lam, d0, h_b, c0, aset, carry in zip(
                 ys, ws, cns, lams, delta0, hs, prep.c0, asets, carries)]
    _advance(probs, X, loss=loss, h=h,
             inner_epochs=config.inner_epochs,
             polish_factor=config.polish_factor, max_outer=config.max_outer,
             use_seq_ball=use_seq,
             screen=(make_batch_screen(screen, X, col_norm, h)
                     if screen_fn is None else screen_fn),
             fleet_step=binner.fleet_step, screen_rule=rule,
             newton=(rule.newton_polish and inner == "gram"
                     and config.loss == "least_squares"))
    return [q.result(p, config.max_outer) for q in probs]


def stack_results(results: List[SaifResult]) -> SaifResult:
    """One :class:`SaifResult` whose every field has a leading problem
    axis (counts and flags as (B,) tensors)."""
    dev = results[0].beta.device

    def col(name):
        vals = [getattr(r, name) for r in results]
        if isinstance(vals[0], Tensor):
            return torch.stack(vals)
        return torch.tensor(vals, device=dev)

    inner = type(results[0].inner)(*[torch.stack(t) for t in zip(
        *[r.inner for r in results])])
    return SaifResult(**{f: (inner if f == "inner" else col(f))
                         for f in SaifResult._fields})


def fleet_solve(X, Y, lams, config: SaifConfig = SaifConfig(), device=None,
                weights=None, prep: Optional[FleetPrep] = None,
                screen_fn=None) -> SaifResult:
    """Solve B LASSO problems over one shared design together.

    X (n, p) shared design; Y (B, n) responses (an (n,) vector is a fleet
    of one); ``lams`` a scalar or B per-problem lambdas; ``weights``
    optional (B, n) per-problem sample weights (binary row masks: the
    K-fold CV trick; the Thm-2 sequential ball is then off); ``prep`` a
    :class:`FleetPrep` made before, perhaps bucket-padded by
    :func:`pad_fleet_prep` (X, Y and weights are then ignored);
    ``screen_fn`` a custom
    :data:`~repro_torch.core.screen_backend.BatchScreenFn` sized for the
    fleet's h. ``device=None`` runs on the card; pass ``device="cpu"`` for
    the plain path on the CPU.

    Returns a :class:`~repro_torch.core.saif.SaifResult` whose every field
    has a leading problem axis; row b is bitwise the serial
    ``saif(X, Y[b], lams[b], config)`` (weighted: bitwise the fleet of one
    of problem b). Under ``parity="fast"`` a least-squares fleet runs the
    lockstep engine of ``core/batch_fast.py`` instead, unless a
    ``screen_fn`` is given (it owns its scores, so the bitwise engine
    serves it): each row has the bitwise engine's support, gap <= eps and
    a passing KKT residual, not its bits. When any problem's ADD overflows
    the shared capacity, the whole fleet starts over cold at twice the
    capacity from the same initial supports, as the reference does.
    """
    if config.unpen_idx is not None:
        raise NotImplementedError(
            "fleet_solve solves plain-LASSO fleets; the fused unpenalized "
            "slot is serial-only, as in the reference")
    dev = resolve_device(device)
    if prep is None:
        prep = prepare_fleet(X, Y, config, weights=weights, device=dev)
    n, p = prep.X.shape
    # a padded preparation: every policy reads the real dims
    n_eff = prep.n_true or n
    p_eff = prep.p_true or p
    pad_mask = (torch.arange(p, device=prep.X.device) >= p_eff
                if p_eff < p else None)
    b = prep.Y.shape[0]
    lam_list = torch.as_tensor(lams, dtype=torch.float64).reshape(-1)
    lam_list = lam_list.expand(b).tolist()
    rule = resolve_screen_rule(config.screen_rule)
    use_seq = config.use_seq_ball and rule.use_seq_ball and prep.W is None
    screen = resolve_batch_screen(config.screen_backend, prep.X.device, b=b,
                                  p=p_eff)
    hs, h = fleet_batch_sizes(prep, lam_list, config)
    k_max = config.k_max or default_capacity(h, p_eff)
    # the lockstep engine: least squares with the built-in screen only, as
    # in the reference
    fast = (config.parity == "fast" and config.loss == "least_squares"
            and screen_fn is None)
    # the cold start is made once, at the first capacity: a regrown fleet
    # restarts from the same (possibly capacity-truncated) supports, as
    # solve_scalar does, so its problems replay their serial regrowths. A
    # low-precision fast screen also selects the cold start on float32 c0
    low = fast and config.screen_dtype != "working"
    init = initial_support_batch(prep.c0.float() if low else prep.c0, hs,
                                 k_max, p_eff, prep.X.dtype)
    while True:
        pad = k_max - init[0].shape[1]
        init = tuple(torch.nn.functional.pad(t, (0, pad)) for t in init)
        # the fleet dispatch routes through the fault-injection seam
        # (repro_torch.runtime.inject): one None-check when disarmed
        if fast:
            res = _fault_seam("fleet", lambda: solve_fleet_fast(
                prep, lam_list, config, hs=hs, h=h, k_max=k_max,
                init_idx=init[0], init_beta=init[1], init_mask=init[2],
                use_seq=use_seq, rule=rule,
                delta0=_delta0s(prep, lam_list, config), pad_mask=pad_mask))
        else:
            # routed on the real rows; a padded block's kernel gate reads
            # the padded ones
            padded_rows = {} if n == n_eff else {"n_pad": n}
            inner = resolve_batch_inner(config, n_eff, k_max, b,
                                        prep.X.device, prep.X.element_size(),
                                        weighted=prep.W is not None,
                                        **padded_rows)
            res = _fault_seam("fleet", lambda: stack_results(_solve_fleet(
                prep, lam_list, config, hs=hs, h=h, k_max=k_max,
                init_idx=init[0], init_beta=init[1], init_mask=init[2],
                inner=inner, screen=screen, use_seq=use_seq, rule=rule,
                screen_fn=screen_fn, pad_mask=pad_mask)))
        if not bool(res.overflowed.any()) or k_max >= p_eff:
            return res
        k_max = min(2 * k_max, p_eff)


def saif_batch(X, Y, lams, config: SaifConfig = SaifConfig(),
               weights=None, device=None, screen_fn=None) -> SaifResult:
    """DEPRECATED legacy frontend: a one-shot session over
    :func:`fleet_solve`. Use
    ``repro_torch.open_session(Problem(X), config).solve(Fleet(Y, lams))``.
    """
    from repro_torch.core._compat import warn_deprecated
    from repro_torch.core.api import Fleet, Problem, open_session
    warn_deprecated("repro_torch.saif_batch",
                    "session.solve(Fleet(Y, lams))")
    sess = open_session(Problem(X=X, loss=config.loss), config,
                        device=device)
    return sess.solve(Fleet(Y=Y, lams=lams, weights=weights,
                            screen_fn=screen_fn))


def fleet_warm_state(results: List[SaifResult]):
    """The slot-preserving warm state of a fleet pass, per problem (the
    reference's batched ``_warm_state``, ``cv.py:147-154``): each
    problem's slot map masked down to its nonzero coefficients, and its
    final inner carry, which then stays valid verbatim. Returns
    (init_idx, init_beta, init_mask) (B, k_max) and the B carries."""
    idx = torch.stack([r.active_idx for r in results])
    mask = torch.stack([r.active_mask for r in results])
    vals = torch.where(mask, torch.gather(
        torch.stack([r.beta for r in results]), 1, idx), 0.0)
    live = mask & (vals != 0)
    return ((idx, torch.where(live, vals, 0.0), live),
            [r.inner for r in results])
