"""Feature-sharded SAIF on ``torch.distributed`` (port of
``repro.distributed.saif_sharded``).

The cost profile of SAIF (Theorem 5) is CM epochs on a small active block
plus an O(p) screening scan per ADD step. The scan is the only term that
touches the whole feature set, so it is the only term sharded:

  * X is partitioned by columns over every rank of the mesh (all its
    dimensions flattened, row-major). Each rank holds X_local (n, p_pad/W)
    on its device and, replicated, nothing wider than (p_pad,): the column
    norms and c0. p is padded up to a multiple of W with zero columns whose
    c0 is -inf and norm 1.0, born active (``saif.pad_path_state``'s rules).
  * screen: each rank runs K1 (or K1b for a fleet) on its columns and
    merges its tile winners into a local stable top-h with global ids; one
    gather brings the W x h pairs (with each rank's max ub) to every rank,
    where a stable descending sort in rank order merges them, ties to the
    lowest id as ``jax.lax.top_k`` orders them; the bounds follow from the
    replicated norms, K2 (K2b) counts the rank's ub against them (and
    against 1.0, for the survivors), and one SUM all-reduce adds the
    histograms. Two collectives per screen, O(W h) and O(h) wide.
  * The active block, the CM or Gram sweeps and every host decision are
    replicated: each rank runs the same engine on the same values. The
    engine reads design columns through ``active_set.columns`` /
    ``columns_t``, which fetch them from their owners (one SUM all-reduce,
    each owner's entries against -0.0 elsewhere: an exact copy).

Every rank must make every request (SPMD): a decision read from a rank's
own columns would send the ranks down different collectives. A candidate
with score -inf carries the sentinel id p_pad, which is never recruited,
and the screen equals the unsharded one on every finite candidate and in
its counts, max ub and survivors.

Where the port differs from the reference: a session's sharded design
takes c0 and the norms from the session's own preparation, and every
policy formula (h, capacity, initial support, inner routing) reads the
real p (``PathState.p_true``), so a sharded solve is bit for bit the
session's unsharded solve; the reference derives h from the padded width.

The mesh picks only the collective route (``distributed/comm.py``). The
entry points run where their ``device`` says; ``device=None`` means the
device of a tensor passed in that is not on the CPU, else the card (they
raise without one). ``device="cpu"`` with tensors on the card raises: the
work never moves to the host. A ``cuda`` mesh (NCCL) needs the card.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.core.screen_backend import ScreenOut
from repro_torch.distributed import comm

Tensor = torch.Tensor

_INT = {torch.float64: torch.int64, torch.float32: torch.int32}


def _to_bits(x: Tensor) -> Tensor:
    """A float tensor's bit patterns as int64 (exact, reversible)."""
    return x.contiguous().view(_INT[x.dtype]).to(torch.int64)


def _from_bits(b: Tensor, dtype) -> Tensor:
    return b.to(_INT[dtype]).contiguous().view(dtype)


class ShardedDesign:
    """A design partitioned by columns over the ranks of a mesh.

    ``X_local`` (n, p_pad / W) holds this rank's columns, from ``offset``;
    ``col_norm`` and ``c0`` (p_pad,) are replicated (``c0`` is None where
    the preparation holds it: a session's placements and a fleet's); ``p``
    is the real width. The engine takes it where it takes a design
    tensor: it has the global ``shape``, ``dtype``, ``device`` and
    ``element_size()``, and :meth:`columns` / :meth:`columns_t` fetch
    columns from their owners.
    """

    def __init__(self, X_local: Tensor, col_norm: Tensor,
                 c0: Optional[Tensor], p: int, mesh,
                 group: comm.FeatureGroup):
        if not group.host and X_local.device.type != "cuda":
            raise ValueError(f"a cuda mesh (NCCL) shards a design on the "
                             f"card, not on {X_local.device}")
        self.X_local, self.col_norm, self.c0 = X_local, col_norm, c0
        self.p, self.mesh, self.group = int(p), mesh, group
        n, self.p_local = X_local.shape
        self.offset = group.index * self.p_local
        self.shape = (n, self.p_local * group.size)
        self.dtype, self.device = X_local.dtype, X_local.device

    @property
    def local(self) -> slice:
        """This rank's columns of a (p_pad,) vector."""
        return slice(self.offset, self.offset + self.p_local)

    def element_size(self) -> int:
        return self.X_local.element_size()

    def to(self, device=None):
        """The design itself: it lives on its ranks' devices."""
        d = torch.device(device)
        if d.type != self.device.type or d.index not in (None,
                                                         self.device.index):
            raise ValueError(f"a sharded design on {self.device} cannot "
                             f"move to {d}")
        return self

    def columns(self, ids) -> Tensor:
        """(n, *ids.shape) exact copies of the columns ``ids`` (an int
        gives (n,)): each owner contributes its columns, -0.0 elsewhere,
        and one SUM all-reduce assembles them."""
        if not isinstance(ids, Tensor):
            # one column, laid out as a column of a matrix (a stride of
            # 2): the routines that read it then take the path that a
            # column of the whole design takes (on the CPU a strided dot
            # sums in another order than a contiguous one)
            col = self.columns(torch.tensor([int(ids)], device=self.device))
            return torch.cat((col, col), 1)[:, 0]
        flat = ids.reshape(-1)
        loc = flat - self.offset
        own = (loc >= 0) & (loc < self.p_local)
        part = torch.where(
            own, self.X_local[:, loc.clamp(0, self.p_local - 1)], -0.0)
        return comm.all_reduce_sum(self.group, part).reshape(-1, *ids.shape)

    def columns_t(self, ids: Tensor) -> Tensor:
        """(*ids.shape, n): :meth:`columns` transposed, each a contiguous
        row."""
        block = self.columns(ids)
        return block.reshape(block.shape[0], -1).T.contiguous().reshape(
            *ids.shape, -1)


def _device(device, *arrays) -> torch.device:
    """Where an entry point runs: ``device``; for None the device of the
    first tensor in ``arrays`` that is not on the CPU, else the card. A
    CPU device with such a tensor raises instead of moving it."""
    from repro_torch.core.saif import resolve_device
    away = [a.device for a in arrays
            if isinstance(a, Tensor) and a.device.type != "cpu"]
    dev = resolve_device(away[0] if device is None and away else device)
    if dev.type == "cpu" and away:
        raise ValueError(f"device='cpu' with inputs on {away[0]}: the "
                         f"sharded solve does not move them to the host")
    return dev


def _local_block(X: Tensor, fg: comm.FeatureGroup) -> Tensor:
    """This rank's columns of X (n, w), zero-padded to ceil(w / W): X
    itself at W = 1, a contiguous copy otherwise."""
    n, w = X.shape
    if fg.size == 1:
        return X
    pl = -(-w // fg.size)
    off = fg.index * pl
    blk = X[:, min(off, w):min(off + pl, w)]
    return torch.nn.functional.pad(blk, (0, pl - blk.shape[1])).contiguous()


def _pad_stats(v: Tensor, p_pad: int, value: float) -> Tensor:
    """``v`` (p,) or (B, p) padded with ``value`` to p_pad columns."""
    return v if v.shape[-1] == p_pad else torch.nn.functional.pad(
        v, (0, p_pad - v.shape[-1]), value=value)


def shard_design(X, y_grad0, mesh, device=None) -> ShardedDesign:
    """Pad p to a multiple of the mesh's rank count and keep this rank's
    columns. Each rank computes its columns' norms and c0 = |X^T y_grad0|
    (no c0 for ``y_grad0=None``, a fleet's placement) and one gather
    replicates them; pads get norm 1.0 and c0 -inf."""
    from repro_torch.core.saif import as_tensor
    dev = _device(device, X, y_grad0)
    fg = comm.feature_group(mesh)
    X = as_tensor(X, dev)
    p = X.shape[1]
    Xl = _local_block(X, fg)
    stats = [torch.linalg.vector_norm(Xl, dim=0)]
    if y_grad0 is not None:
        stats.append(torch.abs(Xl.T @ as_tensor(y_grad0, dev, X.dtype)))
    stats = comm.all_gather_rows(fg, torch.stack(stats))
    p_pad = Xl.shape[1] * fg.size
    pad = torch.arange(p_pad, device=dev) >= p
    col_norm = torch.where(pad, 1.0, stats[:, 0].reshape(-1))
    c0 = (None if y_grad0 is None
          else torch.where(pad, -math.inf, stats[:, 1].reshape(-1)))
    return ShardedDesign(Xl, col_norm, c0, p, mesh, fg)


def design_from_prep(prep, mesh,
                     placed: Optional[ShardedDesign] = None) -> ShardedDesign:
    """A session's placement over its ``PathState`` or a ``FleetPrep`` (an
    unweighted one): X_local sliced from the prepared X (a view at W = 1),
    or ``placed``'s X_local (another placement of the same session, so X
    is placed once), the norms the preparation's own, padded. No
    collective and no O(np) work; c0 stays in the preparation
    (:func:`sharded_prep`); a bucket-padded preparation keeps its real
    ``p_true``."""
    if placed is None:
        fg = comm.feature_group(mesh)
        Xl = _local_block(prep.X, fg)
    else:
        fg, Xl = placed.group, placed.X_local
    p_pad = Xl.shape[1] * fg.size
    return ShardedDesign(Xl, _pad_stats(prep.col_norm, p_pad, 1.0), None,
                         prep.p_true or prep.X.shape[1], mesh, fg)


def sharded_prep(prep, design: ShardedDesign):
    """The engine's ``PathState`` or ``FleetPrep`` over a session's sharded
    design: the preparation's own statistics, its c0 padded at -inf, the
    design's norms (the preparation's, padded), ``p_true`` the real
    width."""
    return prep._replace(X=design, c0=_pad_stats(prep.c0, design.shape[1],
                                                 -math.inf),
                         col_norm=design.col_norm, p_true=design.p)


def design_for(X, y, mesh, config=None, device=None) -> ShardedDesign:
    """The feature-sharded design from the penalized-null gradient: f'(0)
    for plain LASSO, at the unpenalized slot's partial optimum for fused
    problems (Thm 7), whose c0 is 0. The one-time placement."""
    from repro_torch.core.duality import null_point
    from repro_torch.core.losses import get_loss
    from repro_torch.core.saif import SaifConfig, as_tensor
    config = config or SaifConfig()
    dev = _device(device, X, y)
    X = as_tensor(X, dev)
    y = as_tensor(y, dev, X.dtype)
    u = config.unpen_idx
    g0, _ = null_point(get_loss(config.loss), None if u is None
                       else X[:, u], y)
    design = shard_design(X, g0, mesh, dev)
    if u is not None:
        design.c0[u] = 0.0
    return design


def fleet_design_for(X, mesh, device=None) -> ShardedDesign:
    """Fleet placement: X and the norms, all that fleet screening reads.
    Each problem's c0 comes from its own response
    (:func:`prepare_fleet_sharded`), so one placement serves every
    response batch."""
    return shard_design(X, None, mesh, device)


def path_state(design: ShardedDesign, y, config=None):
    """The ``PathState`` of a one-shot sharded solve: the design's c0 and
    norms, the c0 statistics over the real columns, b0 from the
    unpenalized column (fetched from its owner)."""
    from repro_torch.core.duality import null_point
    from repro_torch.core.losses import get_loss
    from repro_torch.core.saif import PathState, SaifConfig, _median, as_tensor
    config = config or SaifConfig()
    y = as_tensor(y, _device(design.device, y), design.dtype)
    u = config.unpen_idx
    _, b0 = null_point(get_loss(config.loss), None if u is None
                       else design.columns(u), y)
    c0 = design.c0[:design.p]
    c0_max = float(torch.max(c0))
    return PathState(X=design, y=y, c0=design.c0, col_norm=design.col_norm,
                     lam_max=c0_max, c0_max=c0_max,
                     c0_median=float(_median(c0)), b0=float(b0),
                     p_true=design.p)


def prepare_fleet_sharded(design: ShardedDesign, Y, config=None):
    """The fleet's ``FleetPrep`` over the sharded design: each problem's
    c0 from the serial ``null_gradient`` on this rank's columns, one gather
    for all of them; the h formula's statistics over the real columns."""
    from repro_torch.core.batch import FleetPrep
    from repro_torch.core.duality import null_gradient
    from repro_torch.core.losses import get_loss
    from repro_torch.core.saif import SaifConfig, _median, as_tensor
    config = config or SaifConfig()
    loss = get_loss(config.loss)
    Y = as_tensor(Y, _device(design.device, Y), design.dtype)
    if Y.ndim == 1:
        Y = Y[None]
    c0 = comm.all_gather_rows(design.group, torch.stack(
        [null_gradient(loss, design.X_local, y.clone())[1] for y in Y]))
    c0 = c0.permute(1, 0, 2).reshape(Y.shape[0], -1)
    c0 = torch.where(torch.arange(c0.shape[1], device=c0.device) < design.p,
                     c0, -math.inf)
    stats = torch.stack([torch.stack((torch.max(c[:design.p]),
                                      _median(c[:design.p]))) for c in c0])
    stats = stats.tolist()
    return FleetPrep(X=design, Y=Y, c0=c0, col_norm=design.col_norm,
                     c0_max=[s[0] for s in stats],
                     c0_median=[s[1] for s in stats], p_true=design.p)


# ---------------------------------------------------------------------------
# the sharded screens
# ---------------------------------------------------------------------------

def _local_top(tops: Tensor, topi: Tensor, h: int, offset: int,
               sentinel: int):
    """Each problem's stable top-h of its K1/K1b tile winners (m, tiles,
    h_tile): scores -inf-padded to h, global ids, non-finite scores at the
    sentinel id."""
    m = tops.shape[0]
    vals, pos = torch.sort(tops.reshape(m, -1), dim=1, descending=True,
                           stable=True)
    vals, pos = vals[:, :h], pos[:, :h]
    ids = torch.gather(topi.reshape(m, -1), 1, pos).long() + offset
    if vals.shape[1] < h:                   # fewer local lanes than h
        short = h - vals.shape[1]
        vals = torch.nn.functional.pad(vals, (0, short), value=-math.inf)
        ids = torch.nn.functional.pad(ids, (0, short))
    return vals, torch.where(torch.isfinite(vals), ids, sentinel)


def merge_payload_shape(m: int, h: int) -> tuple:
    """Each rank's part of :func:`_merge`'s one gather, an int64 tensor:
    row 0 the bits of the m x h scores and of the m extras, row 1 the ids
    (the dry-run's screen row reckons its collective bytes from it)."""
    return (m, 2, h + 1)


def _merge(design: ShardedDesign, score: Tensor, ids: Tensor,
           extra: Tensor):
    """One gather of every rank's (m, h) candidates and (m,) ``extra``
    floats; the merged (m, h) stable top-h (ties to the lowest global id)
    and the (W, m) extras."""
    m, h = score.shape
    payload = score.new_empty(merge_payload_shape(m, h), dtype=torch.int64)
    payload[:, 0, :h] = _to_bits(score)
    payload[:, 0, h] = _to_bits(extra)
    payload[:, 1, :h] = ids
    payload[:, 1, h] = 0
    allp = comm.all_gather_rows(design.group, payload)   # (W, m, 2, h+1)
    dt = score.dtype
    s_all = _from_bits(allp[:, :, 0, :h], dt).permute(1, 0, 2).reshape(m, -1)
    i_all = allp[:, :, 1, :h].permute(1, 0, 2).reshape(m, -1)
    vals, pos = torch.sort(s_all, dim=1, descending=True, stable=True)
    return (vals[:, :h], torch.gather(i_all, 1, pos[:, :h]),
            _from_bits(allp[:, :, 0, h], dt))


def _screen_rows(design: ShardedDesign, h: int, r: Tensor, ub: Tensor,
                 tops: Tensor, topi: Tensor, tmax: Tensor,
                 histogram) -> ScreenOut:
    """The screen of m problems from their K1/K1b outputs on this rank's
    columns (ub (m, p_local), tile winners, tile maxima) and radii r (m,);
    ``histogram`` is K2 or K2b. Returns the batched ScreenOut."""
    from repro_torch.kernels.screen.ref import ge_counts_from_hist
    score, ids = _local_top(tops, topi, h, design.offset, design.shape[1])
    cand_score, cand_idx, mub = _merge(design, score, ids,
                                       tmax.amax(dim=1))
    cn = design.col_norm
    # screen_tail_ref's bounds (K2's tail computes the same bits)
    cand_lb = torch.abs(cand_score - cn[torch.clamp(
        cand_idx, max=cn.shape[0] - 1)] * r[:, None])
    # the bounds and 1.0: one histogram gives the counts and the survivors
    q = torch.cat((cand_lb, torch.ones_like(cand_lb[:, :1])), 1)
    bounds = torch.sort(q, dim=1).values
    hist = comm.all_reduce_sum(design.group, histogram(ub, bounds))
    ge = ge_counts_from_hist(hist, bounds, q)
    return ScreenOut(max_ub=mub.amax(dim=0), cand_score=cand_score,
                     cand_idx=cand_idx, cand_lb=cand_lb, cand_ge=ge[:, :h],
                     n_surv=ge[:, h])


def make_sharded_screen(design: ShardedDesign, h: int):
    """Sharded :data:`~repro_torch.core.screen_backend.ScreenFn`: K1 on
    this rank's columns, one gather of the W x h candidates, K2's
    histogram against the merged bounds, one SUM all-reduce (see the
    module docstring)."""
    from repro_torch.kernels.screen.screen import screen_fused, ub_histogram
    X, sl = design.X_local, design.local
    cn = design.col_norm[sl]

    def hist(ub, bounds):
        return ub_histogram(ub[0], bounds[0])[None]

    def screen(theta, r, in_active):
        _, ub, _, tops, topi, tmax = screen_fused(X, theta, cn,
                                                  in_active[sl], r, h=h)
        out = _screen_rows(design, h, torch.as_tensor(
            r, dtype=X.dtype, device=X.device).reshape(1), ub[None],
            tops[None], topi[None], tmax[None], hist)
        return ScreenOut(*[f[0] for f in out])
    return screen


def make_sharded_screen_batch(design: ShardedDesign, h: int):
    """Sharded fleet screen (a
    :data:`~repro_torch.core.screen_backend.BatchScreenFn`): K1b scans this
    rank's columns for every problem whose ADD runs this step, and they all
    ride one gather and one all-reduce (K2b's histograms)."""
    from repro_torch.core.screen_backend import _rows, _skip_screen_out
    from repro_torch.kernels.screen.screen import (screen_fused_batch,
                                                   ub_histogram_batch)
    X, sl = design.X_local, design.local
    cn = design.col_norm[sl]
    skip = _skip_screen_out(h, X.dtype, X.device)

    def screen(thetas, rs, in_actives, do):
        sel = [i for i, d in enumerate(do) if d]
        r = torch.stack([rs[i] for i in sel])
        _, ub, _, tops, topi, tmax = screen_fused_batch(
            X, torch.stack([thetas[i] for i in sel]), cn,
            torch.stack([in_actives[i][sl] for i in sel]), r, h=h)
        return _rows(_screen_rows(design, h, r, ub, tops, topi, tmax,
                                  ub_histogram_batch), do, skip)
    return screen


def make_sharded_scan(design: ShardedDesign):
    """The legacy bare-scan hook: ``scan_fn(theta) -> |X^T theta|`` (p_pad,)
    replicated, pad columns at -inf (K1 unmasked on each rank's columns,
    one gather). ``make_screen_from_scan`` adapts it to a screen."""
    from repro_torch.kernels.screen.screen import screen_scores
    X, cn = design.X_local, design.col_norm[design.local]
    pad = torch.arange(design.shape[1], device=design.device) >= design.p

    def scan_fn(theta):
        score = screen_scores(X, theta, cn, 0.0)[0]
        out = comm.all_gather_rows(design.group, score[None]).reshape(-1)
        return torch.where(pad, -math.inf, out)
    return scan_fn


class ScreenResult(NamedTuple):
    top_scores: Tensor   # (h,)
    top_idx: Tensor      # (h,) global feature ids (int64)
    max_ub: Tensor       # scalar: max_i |x_i^T theta| + ||x_i|| r


def make_fused_screen(design: ShardedDesign, h: int):
    """The bare screening collective: each rank's top-h (K1 over its
    columns, pads masked) and max ub in one gather."""
    from repro_torch.kernels.screen.screen import screen_fused
    X, cn = design.X_local, design.col_norm[design.local]
    pad = (design.offset + torch.arange(design.p_local, device=X.device)
           ) >= design.p

    def fused(theta, r):
        r = torch.as_tensor(r, dtype=X.dtype, device=X.device)
        _, _, _, tops, topi, tmax = screen_fused(X, theta, cn, pad, r, h=h)
        score, ids = _local_top(tops[None], topi[None], h, design.offset,
                                design.shape[1])
        top_s, top_i, mub = _merge(design, score, ids, tmax.amax()[None])
        return ScreenResult(top_scores=top_s[0], top_idx=top_i[0],
                            max_ub=mub.amax())
    return fused


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------

def _memo(cache, h, make):
    if cache is None:
        return make()
    if h not in cache:
        cache[h] = make()
    return cache[h]


def _config(config, inner_backend):
    import dataclasses

    from repro_torch.core.saif import SaifConfig
    config = config or SaifConfig()
    if inner_backend is not None:
        config = dataclasses.replace(config, inner_backend=inner_backend)
    return config


def solve_scalar_sharded(X, y, lam: float, mesh, config=None,
                         inner_backend: Optional[str] = None,
                         design: Optional[ShardedDesign] = None,
                         screen_cache: Optional[dict] = None, prep=None,
                         device=None):
    """SAIF with the sharded screen: the result of ``saif`` on the same
    problem, beta cut to the real width. The inner solve is replicated, so
    every inner backend composes with it; its column reads are owner
    fetches.

    ``design`` / ``prep`` / ``screen_cache`` are the session's hooks: a
    placed design, its ``PathState`` (:func:`sharded_prep`; both skip the
    one-time work) and the per-h memo of screens."""
    from repro_torch.core.saif import add_batch_size_static, solve_scalar
    config = _config(config, inner_backend)
    if prep is None:
        if design is None:
            design = design_for(X, y, mesh, config, device)
        prep = path_state(design, y, config)
    design = prep.X
    # the engine's own h (solve_scalar derives it from the real width)
    h = add_batch_size_static(config.c, lam, prep.c0_max, prep.c0_median,
                              design.p)
    res = solve_scalar(prep, lam, config, device=design.device,
                       screen_fn=_memo(screen_cache, h, lambda: (
                           make_sharded_screen(design, h))))
    return res._replace(beta=res.beta[:design.p])


def fleet_solve_sharded(X, Y, lam, mesh, config=None,
                        inner_backend: Optional[str] = None,
                        design: Optional[ShardedDesign] = None,
                        screen_cache: Optional[dict] = None, prep=None,
                        device=None):
    """The fleet with the sharded screen: B lockstep solves whose scans
    ride one gather and one all-reduce per outer step, the result of
    ``fleet_solve`` on the same problems (plain-LASSO fleets without sample
    weights). ``design`` / ``prep`` / ``screen_cache``: the session's
    hooks, a placed design, its ``FleetPrep`` (:func:`sharded_prep`) and
    the per-h memo of screens."""
    from repro_torch.core.batch import fleet_batch_sizes, fleet_solve
    config = _config(config, inner_backend)
    if config.unpen_idx is not None:
        raise NotImplementedError("fused fleets are serial-only for now")
    if prep is None:
        if design is None:
            design = fleet_design_for(X, mesh, _device(device, X, Y))
        prep = prepare_fleet_sharded(design, Y, config)
    design = prep.X
    b = prep.Y.shape[0]
    lams = torch.as_tensor(lam, dtype=torch.float64).reshape(-1)
    lams = lams.expand(b).tolist()
    _, h = fleet_batch_sizes(prep, lams, config)
    res = fleet_solve(None, None, lams, config, device=design.device,
                      prep=prep, screen_fn=_memo(screen_cache, h, lambda: (
                          make_sharded_screen_batch(design, h))))
    return res._replace(beta=res.beta[:, :design.p])


def _one_shot(old, new, problem, config, mesh, device, request):
    from repro_torch.core._compat import warn_deprecated
    from repro_torch.core.api import open_session
    warn_deprecated(old, new)
    sess = open_session(problem, config, mesh=mesh, device=_device(
        device, problem.X, problem.y))
    return sess.solve(request)


def saif_distributed(X, y, lam: float, mesh, config=None,
                     inner_backend: Optional[str] = None, device=None):
    """DEPRECATED legacy frontend: a one-shot session over
    :func:`solve_scalar_sharded`. Use ``repro_torch.open_session(
    Problem(X, y), config, mesh=mesh).solve(Scalar(lam, sharded=True))``.
    """
    from repro_torch.core.api import Problem, Scalar
    config = _config(config, inner_backend)
    return _one_shot("repro_torch.distributed.saif_distributed",
                     "session.solve(Scalar(lam, sharded=True))",
                     Problem(X=X, y=y, loss=config.loss), config, mesh,
                     device, Scalar(lam=float(lam), sharded=True))


def saif_batch_distributed(X, Y, lam, mesh, config=None,
                           inner_backend: Optional[str] = None, device=None):
    """DEPRECATED legacy frontend: a one-shot session over
    :func:`fleet_solve_sharded`. Use ``repro_torch.open_session(
    Problem(X), config, mesh=mesh).solve(Fleet(Y, lams, sharded=True))``.
    """
    from repro_torch.core.api import Fleet, Problem
    config = _config(config, inner_backend)
    return _one_shot("repro_torch.distributed.saif_batch_distributed",
                     "session.solve(Fleet(Y, lams, sharded=True))",
                     Problem(X=X, loss=config.loss), config, mesh, device,
                     Fleet(Y=Y, lams=lam, sharded=True))


def saif_fused_distributed(X, y, parent, lam: float, mesh, config=None,
                           transform_backend: str = "auto", device=None):
    """DEPRECATED legacy frontend: tree fused LASSO with the sharded screen
    as a one-shot session. The Theorem-6 transform runs once; the
    transformed design (edge columns and the unpenalized b column) is
    sharded like a plain one. Returns (beta in node space, SaifResult).
    Use ``repro_torch.open_session(Problem(X, y,
    penalty=fused(parent)), config, mesh=mesh).solve(Scalar(lam,
    sharded=True))``."""
    from repro_torch.core.api import Problem, Scalar, fused
    from repro_torch.core.saif import SaifConfig
    config = config or SaifConfig()
    return _one_shot(
        "repro_torch.distributed.saif_fused_distributed",
        "session.solve(Scalar(lam, sharded=True)) with penalty=fused(parent)",
        Problem(X=X, y=y, loss=config.loss,
                penalty=fused(parent, transform_backend=transform_backend)),
        config, mesh, device, Scalar(lam=float(lam), sharded=True))
