"""Online row updates for a live Session (port of ``repro.core.online``).

A feature-selection service sees new samples arrive while a session is
hot. ``Session.solve(Update(rows, responses))`` absorbs an (m, p) row
block into the session's device-resident problem state and re-solves warm
through the path engine (``core/path.py::run_path``):

  * the design and response buffers are padded once, at stream entry, to
    a row capacity ``n_cap`` (power-of-two headroom in append mode, the
    ring size in sliding-window mode). Zero pad rows are exact for least
    squares (``grad(0, 0) = 0`` adds nothing to any X^T correlation, the
    primal value or the dual), the identity ``pad_path_state`` relies on;
    the engine routes on the resident row count ``n_true``;
  * the screening statistics stay exact incrementally: the signed
    correlation ``xty = X^T y`` and the squared column norms are rank-m
    updated on the device (``c0 = |xty|``, ``col_norm = sqrt(col_sq)``),
    so the Theorem-2 sequential ball keeps its exact geometry;
  * the resident Gram carry is block-updated
    (:func:`~repro_torch.core.inner_backend.gram_block_update`) on its
    live slots; ``gidx`` is left as it was, so the warm re-solve's
    ``init`` finds no dirty slot and skips the O(n k^2) rebuild
    (``make_inner_gram.rebuilds`` does not move);
  * sliding-window mode replaces the oldest resident rows (a ring
    buffer), a rank-m downdate. Catastrophic cancellation in the
    downdated column statistics is caught by a conditioning guard
    (``col_sq`` below 64 eps of the removed mass), which recomputes the
    statistics exactly and invalidates the carry (``gidx = -1`` forces
    the engine's rebuild).

``lam_max`` / ``c0_max`` / ``c0_median`` stay frozen at stream entry: they
feed only policy quantities (the ADD batch size h and the delta0 ramp),
never a safety certificate, which runs on the exactly updated ``c0`` /
``col_norm`` / ``y``.

Each update reads the host once (the guard flag, the live-slot counts)
and commits nothing to the session before every check has passed. The
port is eager: :func:`online_compile_count` returns 0.

Module scope stays numpy and stdlib only (the lazy public surface); torch
loads in the functions.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

__all__ = ["Update", "OnlineState", "apply_update", "online_compile_count"]


@dataclasses.dataclass(frozen=True)
class Update:
    """Streaming request: absorb an (m, p) row block, then re-solve warm.

    ``lam`` defaults to the session's last solved lambda; ``window``
    (fixed at stream entry) turns the stream into a sliding window of
    the most recent ``window`` rows; ``resolve=False`` applies the
    update without re-solving (the next request sees the new rows).
    """
    rows: Any
    responses: Any
    lam: Optional[float] = None
    window: Optional[int] = None
    resolve: bool = True
    deadline_s: Optional[float] = None
    priority: int = 0

    def __post_init__(self):
        from repro_torch.core.serving import validate_request
        validate_request(self)


class OnlineState:
    """Host bookkeeping of a streaming session.

    The problem state itself (the padded X and y, the exact c0 and column
    norms) lives in the session's ``PathState``; this object tracks the
    ring geometry and the two signed device statistics the incremental
    updates need (``xty`` keeps the sign that ``c0 = |xty|`` drops).
    """
    __slots__ = ("n_cap", "filled", "head", "window", "xty", "col_sq",
                 "updates", "rebuilds", "grows")

    def __init__(self, n_cap, filled, head, window, xty, col_sq):
        self.n_cap = n_cap          # padded row capacity (= window in a ring)
        self.filled = filled        # resident row count (n_true)
        self.head = head            # next write position
        self.window = window        # None: an append-only stream
        self.xty = xty              # (p,) device: X^T y, signed
        self.col_sq = col_sq        # (p,) device: ||x_j||^2
        self.updates = 0
        self.rebuilds = 0           # downdate-guard exact recomputes
        self.grows = 0              # append-mode capacity doublings


def _next_pow2(x: int) -> int:
    return 1 << (int(x) - 1).bit_length()


def online_compile_count() -> int:
    """Compilations of the streaming functions: 0, the port is eager
    (as ``unified_compile_count``). Its counterpart of "no new engine
    compilation per update" is "no Gram carry rebuild per update"
    (``make_inner_gram.rebuilds``)."""
    return 0


# ---------------------------------------------------------------------------
# the streaming functions: plain torch on the session's device
# ---------------------------------------------------------------------------

def init_stats(X, y):
    """Exact statistics of a resident design: (xty, col_sq, c0,
    col_norm)."""
    import torch
    xty = X.T @ y
    col_sq = torch.sum(X * X, dim=0)
    return xty, col_sq, torch.abs(xty), torch.sqrt(torch.clamp(col_sq,
                                                               min=0.0))


def _core(X, y, xty, col_sq, pos, rows, resp):
    """The rank-m replacement of rows ``pos`` by ``rows``/``resp``, read
    only: returns (old rows, old responses, xty2, col_sq2, bad), ``bad``
    the downdate guard's device flag."""
    import torch
    old = X[pos]
    old_y = y[pos]
    removed = torch.sum(old * old, dim=0)
    col_sq2 = col_sq + torch.sum(rows * rows, dim=0) - removed
    xty2 = xty + rows.T @ resp - old.T @ old_y
    # downdate conditioning guard: where removing the old rows cancelled
    # nearly all of a column's mass, the incremental statistic has no
    # trustworthy bits left; recompute exactly. Append-mode streams
    # replace zero rows (removed == 0) and never trip it.
    eps = torch.finfo(X.dtype).eps
    bad = torch.any((removed > 0.0) & (col_sq2 <= 64.0 * eps * removed))
    return old, old_y, xty2, torch.clamp(col_sq2, min=0.0), bad


def apply_plain(X, y, xty, col_sq, pos, rows, resp):
    """Statistics of the update without a carry: (old, old_y, xty2,
    col_sq2, c0_2, col_norm2, bad)."""
    import torch
    old, old_y, xty2, col_sq2, bad = _core(X, y, xty, col_sq, pos, rows,
                                           resp)
    return (old, old_y, xty2, col_sq2, torch.abs(xty2),
            torch.sqrt(col_sq2), bad)


def apply_carry(X, y, xty, col_sq, pos, rows, resp, mask, gidx):
    """:func:`apply_plain` plus the two device counts the one host read
    takes with the guard flag: the warm state's live slots (``mask``, the
    window's admission count) and the Gram carry's valid slots
    (``gidx >= 0``, the block update's gather)."""
    out = apply_plain(X, y, xty, col_sq, pos, rows, resp)
    return out + (mask.sum(), (gidx >= 0).sum())


# ---------------------------------------------------------------------------
# the stream
# ---------------------------------------------------------------------------

def _request_error(msg: str):
    from repro_torch.core.serving import RequestError
    return RequestError(msg)


def _check_eligible(session) -> None:
    """The reference's stream-entry checks and messages."""
    from repro_torch.core.api import LassoPenalty

    if not isinstance(session.penalty, LassoPenalty):
        raise NotImplementedError(
            "online row updates serve plain-LASSO sessions only "
            f"(penalty: {type(session.penalty).__name__})")
    if getattr(session, "_prep", None) is None:
        raise _request_error(
            "Update needs a session with responses (Problem.y)")
    if session.config.loss != "least_squares":
        raise NotImplementedError(
            "online row updates need the least-squares zero-pad-row "
            f"identity; loss is {session.config.loss!r}")
    if session.problem.weights is not None:
        raise NotImplementedError(
            "online row updates do not compose with per-sample weights")
    if getattr(session, "_pad_to", None) is not None:
        raise NotImplementedError(
            "online updates own their row-capacity padding; open the "
            "session without pad_to")
    if getattr(session, "_sharded", None) is not None:
        raise NotImplementedError(
            "online updates would stale the sharded design placement; "
            "open an unsharded session for streaming")


def _enter_stream(session, req: Update, m: int) -> OnlineState:
    """First Update on a session: pad the resident design to its row
    capacity in a buffer of its own (the caller's arrays are never
    written) and seed the device statistics."""
    prep = session._prep
    n0, p = prep.X.shape
    if req.window is not None:
        window: Optional[int] = int(req.window)
        if window < n0:
            raise _request_error(
                f"Update.window ({window}) must be >= the resident row "
                f"count ({n0}) at stream entry")
        n_cap = window
    else:
        window = None
        # power-of-two headroom: a capacity doubling is O(log) events
        # over any stream
        n_cap = _next_pow2(max(2 * n0, n0 + 4 * m))
    Xp = prep.X.new_zeros((n_cap, p))
    Xp[:n0] = prep.X
    yp = prep.y.new_zeros(n_cap)
    yp[:n0] = prep.y
    xty, col_sq, c0, col_norm = init_stats(Xp, yp)
    # zero pad rows leave every column dot product as it was, so the
    # pre-stream warm state (slot layout and Gram carry, all
    # n-independent) stays valid
    session._prep = prep._replace(X=Xp, y=yp, c0=c0, col_norm=col_norm,
                                  n_true=n0)
    st = OnlineState(n_cap=n_cap, filled=n0, head=n0 % n_cap,
                     window=window, xty=xty, col_sq=col_sq)
    session._online = st
    session._digest_memo = None
    session._push_event(f"online_stream_entered:n_cap={n_cap}")
    return st


def apply_update(session, req: Update):
    """Absorb ``req`` into ``session`` and (optionally) re-solve warm.

    Returns the warm re-solve's
    :class:`~repro_torch.core.saif.SaifResult`, or None when
    ``req.resolve`` is False. Nothing is written to the session's buffers
    before every check has passed; the rows are then written in place
    into the session's own padded buffers.
    """
    import torch

    from repro_torch.core.inner_backend import InnerCarry
    from repro_torch.core.saif import as_tensor

    st = session._online
    if st is None:
        _check_eligible(session)
    elif req.window is not None and int(req.window) != st.window:
        raise _request_error(
            f"Update.window changed mid-stream ({st.window} -> "
            f"{req.window}); the ring capacity is fixed at stream entry")
    prep = session._prep
    dev, dtype = prep.X.device, prep.X.dtype
    rows = as_tensor(req.rows, dev, dtype)
    resp = as_tensor(req.responses, dev, dtype)
    m, p = rows.shape
    if p != prep.X.shape[1]:
        raise _request_error(
            f"Update.rows must have {prep.X.shape[1]} columns to match the "
            f"design, got {p}")
    if st is None:
        st = _enter_stream(session, req, m)
        prep = session._prep
    n_cap = prep.X.shape[0]

    # append-mode capacity growth: double the row buffer (O(log) such
    # events over any stream)
    if st.window is None and st.filled + m > n_cap:
        new_cap = _next_pow2(st.filled + m)
        pad = new_cap - n_cap
        prep = prep._replace(
            X=torch.nn.functional.pad(prep.X, (0, 0, 0, pad)),
            y=torch.nn.functional.pad(prep.y, (0, pad)))
        session._prep = prep
        st.n_cap = n_cap = new_cap
        st.grows += 1
        session._push_event(f"online_capacity_grown:n_cap={new_cap}")

    start = st.head
    pos = torch.arange(start, start + m, device=dev)
    if st.window is not None:
        pos = pos % st.n_cap

    warm = session._warm
    carry = None if warm is None else warm[3]
    # a Gram carry of the warm capacity (a K3 or plain carry is (0, 0))
    use_carry = (carry is not None and carry.G.ndim == 2
                 and carry.G.shape[0] == warm[0].shape[0]
                 and warm[0].shape[0] > 1)
    if use_carry:
        idx, vals, mask, carry = warm
        (old, old_y, xty2, col_sq2, c02, cn2, bad, n_live,
         n_valid) = apply_carry(prep.X, prep.y, st.xty, st.col_sq, pos,
                                rows, resp, mask, carry.gidx)
        # the one host read of the update
        bad_h, live_h, valid_h = torch.stack(
            (bad.to(torch.int64), n_live.to(torch.int64),
             n_valid.to(torch.int64))).tolist()
    else:
        old, old_y, xty2, col_sq2, c02, cn2, bad = apply_plain(
            prep.X, prep.y, st.xty, st.col_sq, pos, rows, resp)
        bad_h, live_h, valid_h = int(bad), 0, 0
    if st.window is not None and live_h > st.window:
        # nothing committed: the session state is untouched
        raise _request_error(
            f"Update.window ({st.window}) is smaller than the resident "
            f"active count ({live_h}); the windowed system would be "
            f"underdetermined — raise the window")

    # commit
    prep.X[pos] = rows
    prep.y[pos] = resp
    st.updates += 1
    if st.window is None:
        st.filled += m
        st.head += m
    else:
        st.filled = min(st.filled + m, st.window)
        st.head = (st.head + m) % st.n_cap
    if bad_h:
        xty2, col_sq2, c02, cn2 = init_stats(prep.X, prep.y)
        if use_carry:
            # the downdated G/rho shared the cancellation: mark every slot
            # dirty, so the engine's init rebuilds the carry exactly
            session._warm = (idx, vals, mask, carry._replace(
                gidx=torch.full_like(carry.gidx, -1)))
        st.rebuilds += 1
        session._push_event("online_downdate_rebuild")
    elif use_carry:
        from repro_torch.core.inner_backend import gram_block_update
        # the valid slots first, in slot order (the count came with the
        # host read above)
        live = torch.argsort((carry.gidx < 0).to(torch.int8),
                             stable=True)[:valid_h]
        G2, rho2 = gram_block_update(carry.G, carry.rho, carry.gidx, rows,
                                     resp, old, old_y, live=live)
        session._warm = (idx, vals, mask,
                         InnerCarry(G=G2, rho=rho2, gidx=carry.gidx))
    st.xty, st.col_sq = xty2, col_sq2
    session._prep = prep._replace(c0=c02, col_norm=cn2, n_true=st.filled)
    session._digest_memo = None      # the resident problem changed

    if not req.resolve:
        return None
    lam = req.lam if req.lam is not None else session._last_lam
    if lam is None:
        raise _request_error(
            "Update.lam is required on the first resolving update (the "
            "session has no previous lambda to re-solve at)")
    return _resolve(session, float(lam))


def _resolve(session, lam: float):
    """Warm re-solve at the updated state through the path engine, with
    the session's warm state, capacity and screen hook (the session's
    ``Scalar(lam, warm=True)`` path)."""
    from repro_torch.core.path import run_path

    pr, warm, k_max = run_path(
        session._prep, [lam], session.config,
        make_screen=session._hook(), segment_len=session._segment_len,
        warm0=session._warm, k_max0=session._warm_k)
    session._warm, session._warm_k = warm, k_max
    session._last_lam = lam
    return pr.results[0]
