"""Screening kernels K1 (fused scan) and K2 (violation histogram, and with
it the rest of a screen's tail), and their fleet forms K1b and K2b:
wrappers.

The CUDA sources are ``csrc/screen.cu``; the plain versions are in
``ref.py``. A wrapper given CPU tensors returns the plain version; given
CUDA tensors it launches the kernel or raises. Each wrapper counts its
launches in its ``launches`` attribute.

K1 replaces ``repro/kernels/screen/screen.py:271 screen_fused_pallas``
(and, unmasked, ``:124 screen_scores_pallas``), its ``in_dtype`` /
``acc_dtype`` mode included; K2 replaces
``:512 ub_histogram_pallas`` and, in its tail entry, the code around
it in one screen (``repro/core/screen_backend.py:146-168``); K1b replaces
``:394 screen_fused_batch_pallas`` and K2b ``:562
ub_histogram_batch_pallas``. The mixed mode's launches count apart, in
``screen_fused.mixed.launches`` and ``screen_fused_batch.mixed.launches``;
its bf16 input runs the tensor-core scan (``screen_tc_kernel``, one kernel
for K1 and K1b), which reads X and Theta through TMA in the layout
:func:`tma_bf16` gives them.
"""
from __future__ import annotations

import ctypes
import types

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.screen.ref import (BP, screen_fused_batch_ref,
                                            screen_fused_ref,
                                            screen_scores_ref,
                                            screen_tail_batch_ref,
                                            screen_tail_ref,
                                            ub_histogram_batch_ref,
                                            ub_histogram_ref)

Tensor = torch.Tensor
_FLOATS = (torch.float32, torch.float64)
# K2 keeps the h bounds and the (h+1) bins in shared memory
HIST_SMEM_BUDGET = 200 * 1024


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _ptr(t: Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _require(t: Tensor, what: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{what} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


# (X's type, the sums' type) -> the kernel instance ("tc": the tensor-core
# scan of the bf16 mode)
_SCAN_INSTANCES = {(torch.float32, torch.float32): "f32",
                   (torch.float64, torch.float64): "f64",
                   (torch.bfloat16, torch.float32): "tc"}
# The tensor-core scan's float32 accumulation is certified as a truncating
# float32 adder: NVIDIA does not document how wgmma rounds its sums.
TC_UNIT_ROUNDOFF = 2.0 ** -23
# a failed tensor-map encode returns this + its CUresult (csrc/screen.cu)
_TC_ENCODE_ERROR = 100000


def _tma_ok(A: Tensor) -> bool:
    """A 2-D bf16 matrix TMA can read as it lies: unit column stride, a row
    stride of a multiple of 8 elements (16 bytes) and a 16-byte-aligned
    start."""
    return (A.dtype == torch.bfloat16 and A.ndim == 2 and A.stride(1) == 1
            and A.stride(0) % 8 == 0 and A.stride(0) >= A.shape[1]
            and A.data_ptr() % 16 == 0)


def tma_bf16(A: Tensor) -> Tensor:
    """A (rows, cols) in bfloat16, laid out for the tensor-core scan's TMA:
    a (rows, cols) view of a (rows, cols rounded up to 8) buffer, zeros in
    the pad. A itself when it already has such a layout."""
    if _tma_ok(A):
        return A
    rows, cols = A.shape
    ld = -(-cols // 8) * 8
    make = torch.empty if ld == cols else torch.zeros
    out = make((rows, ld), dtype=torch.bfloat16, device=A.device)
    out[:, :cols] = A
    return out[:, :cols]


def scan_input(X: Tensor, in_dtype) -> Tensor:
    """X cast once to the scan's input type (a torch dtype), in the layout
    its kernel reads: :func:`tma_bf16` for bfloat16, contiguous
    otherwise."""
    if in_dtype == torch.bfloat16:
        return tma_bf16(X)
    return X.to(in_dtype).contiguous()


def screen_dtypes(X: Tensor, in_dtype=None, acc_dtype=None):
    """The scan's (input, accumulator) dtypes, as the reference's
    ``_screen_dtypes`` resolves them: X and theta are rounded to
    ``in_dtype`` (default X's), the sums and every output are in
    ``acc_dtype`` (default: float32 or the input type, the wider). Names
    ("bfloat16") or torch dtypes."""
    def dtype(d):
        return getattr(torch, d) if isinstance(d, str) else d
    dt_in = X.dtype if in_dtype is None else dtype(in_dtype)
    dt_acc = (torch.promote_types(torch.float32, dt_in) if acc_dtype is None
              else dtype(acc_dtype))
    return dt_in, dt_acc


def _scan_args(X, Theta, col_norm, r, in_dtype, acc_dtype):
    """X in the input type (cast here unless the caller cast it once),
    Theta rounded to the input type and held in the sums' type (exactly),
    col_norm and r in the sums' type. For the tensor-core scan (bf16 on
    the card) X and Theta are bf16 in :func:`tma_bf16`'s layout (a caller's
    bf16 X is re-laid-out only where TMA cannot read it)."""
    dt_in, dt_acc = screen_dtypes(X, in_dtype, acc_dtype)
    if dt_in == torch.bfloat16 and X.device.type == "cuda":
        X, Theta = tma_bf16(X), tma_bf16(Theta)
    else:
        if X.dtype != dt_in:
            X = X.to(dt_in)
        Theta = Theta.to(dt_in).to(dt_acc)
    if isinstance(r, Tensor):
        r = r.to(dt_acc)
    return X, Theta, col_norm.to(dt_acc), r, dt_acc


def _scan(entry, X, Theta, col_norm, active, r, h_tile, masked, dt=None,
          guard=1.0):
    """Launch the scan kernel ``entry`` (K1 or K1b) on the m problems of
    Theta (m, n) (X in its input type, the rest in the sums' type ``dt``,
    by default X's); returns the (m, ...) outputs."""
    n, p = X.shape
    dt = X.dtype if dt is None else dt
    m = Theta.shape[0]
    dev = X.device
    inst = _SCAN_INSTANCES.get((X.dtype, dt))
    if inst is None:
        raise ValueError(f"no scan kernel for X in {X.dtype} summed in {dt}"
                         f" (float32, float64, bfloat16 into float32)")
    if inst == "tc":
        for what, A, shape in (("X", X, (n, p)), ("Theta", Theta, (m, n))):
            if (A.device != dev or tuple(A.shape) != shape
                    or not _tma_ok(A)):
                raise ValueError(f"{what} must be {shape} bfloat16 on {dev} "
                                 f"in tma_bf16's layout")
    else:
        _require(X, "X", X.dtype, (n, p), dev)
        _require(Theta, "Theta", dt, (m, n), dev)
    if col_norm.ndim == 1:
        _require(col_norm, "col_norm", dt, (p,), dev)
    else:
        _require(col_norm, "col_norm", dt, (m, p), dev)
    if active is not None:
        _require(active, "active", torch.bool, (m, p), dev)
    if isinstance(r, Tensor):
        r = r.to(device=dev, dtype=dt).reshape(m).contiguous()
    else:               # a host scalar: filled on the card, no copy or sync
        r = torch.full((m,), float(r), dtype=dt, device=dev)
    p_blocks = -(-p // BP)
    score = torch.empty((m, p), dtype=dt, device=dev)
    ub = torch.empty_like(score)
    lb = torch.empty_like(score)
    tops = torch.empty((m, p_blocks, h_tile), dtype=dt, device=dev)
    topi = torch.empty((m, p_blocks, h_tile), dtype=torch.int32, device=dev)
    tmax = torch.empty((m, p_blocks), dtype=dt, device=dev)
    lib = _build.library("screen")
    rest = (_ptr(col_norm), p if col_norm.ndim == 2 else 0,
            _ptr(active) if active is not None else None, _ptr(r), m, n, p,
            h_tile, int(masked), float(guard), _ptr(score), _ptr(ub),
            _ptr(lb), _ptr(tops), _ptr(topi), _ptr(tmax), _stream())
    if inst == "tc":
        rc = lib.screen_fused_tc(_ptr(X), X.stride(0), _ptr(Theta),
                                 Theta.stride(0), *rest)
        if rc >= _TC_ENCODE_ERROR:
            raise RuntimeError(f"{entry}: cuTensorMapEncodeTiled refused a "
                               f"tensor map (CUresult "
                               f"{rc - _TC_ENCODE_ERROR})")
    else:
        rc = getattr(lib, f"{entry}_{inst}")(_ptr(X), _ptr(Theta), *rest)
    _build.check(rc, entry)
    return score, ub, lb, tops, topi, tmax


def _count(wrapper, mixed: bool) -> None:
    if mixed:
        wrapper.mixed.launches += 1
    else:
        wrapper.launches += 1


def screen_fused(X: Tensor, theta: Tensor, col_norm: Tensor, active: Tensor,
                 r, *, h: int, in_dtype=None, acc_dtype=None,
                 guard: float = 1.0):
    """Fused ADD-phase scan (K1).

    Args: X (n, p) row-major, theta (n,), col_norm (p,), active (p,) bool
    (the features to exclude), r the ball radius, h the candidate count.
    Returns score, ub, lb (p,) masked as in the reference; per tile of
    ``BP`` columns its top ``min(h, BP)`` scores and global ids (int32),
    the first entries of a stable descending sort of (masked score, lane),
    so ties go to the lowest lane; and per tile the max ub.

    ``in_dtype`` / ``acc_dtype`` (see :func:`screen_dtypes`) ask for the
    mixed mode: X and theta rounded to ``in_dtype`` ("bfloat16" or
    "float32"; pass X already cast to skip a cast per call), sums and
    outputs in ``acc_dtype`` (float32). ``guard`` multiplies ub and the
    tile maxima (the certified screen's 1 + 8 u_acc).

    On the card each score is one fma chain over the rows in order (the
    same bits as every problem of K1b); persistent CTAs stream X through
    shared memory, and one warp sorts each tile's 256 scores. A bf16 input
    runs the tensor-core scan instead (wgmma on TMA-fed tiles), whose sums
    are float32 in another order.
    """
    X, Theta, col_norm, r, dt = _scan_args(X, theta[None], col_norm, r,
                                           in_dtype, acc_dtype)
    if X.device.type == "cpu":
        return screen_fused_ref(X.to(dt), Theta[0], col_norm, active, r, h=h,
                                guard=guard)
    out = _scan("screen_fused", X, Theta, col_norm, active[None], r,
                max(1, min(h, BP)), True, dt, guard)
    _count(screen_fused, in_dtype is not None or acc_dtype is not None)
    return tuple(t[0] for t in out)


def screen_fused_batch(X: Tensor, Theta: Tensor, col_norm: Tensor,
                       active: Tensor, r, *, h: int, in_dtype=None,
                       acc_dtype=None, guard: float = 1.0):
    """Fleet scan (K1b): K1 for the m problems of Theta (m, n) over the
    shared X, reading X once per chunk of 16 problems.

    col_norm (p,) shared or (m, p), active (m, p) bool, r (m,) radii (a
    tensor, which may stay on the card); ``in_dtype``, ``acc_dtype`` and
    ``guard`` as for :func:`screen_fused`. Returns score, ub, lb (m, p),
    tile winners tops/topi (m, p/BP, min(h, BP)) and tile max ub
    (m, p/BP): per problem bitwise what K1 returns. On the card a thread
    sums 2 columns for 16 (float64) or 8 (float32 sums) of a chunk's
    problems, and each problem's tile top-h is one warp's sort, the
    problems' sorts side by side. A bf16 input runs the tensor-core scan
    (chunks of 8 problems while m <= 8, else 16), whose rows are K1's
    within the float32 sums' bound, not bit for bit.
    """
    X, Theta, col_norm, r, dt = _scan_args(X, Theta, col_norm, r, in_dtype,
                                           acc_dtype)
    if X.device.type == "cpu":
        return screen_fused_batch_ref(X.to(dt), Theta, col_norm, active, r,
                                      h=h, guard=guard)
    out = _scan("screen_fused_batch", X, Theta, col_norm, active, r,
                max(1, min(h, BP)), True, dt, guard)
    _count(screen_fused_batch, in_dtype is not None or acc_dtype is not None)
    return out


def screen_scores(X: Tensor, theta: Tensor, col_norm: Tensor, r):
    """Unmasked scan: (score, ub, lb) per feature — K1 without the mask
    and the top-h (its launches count in ``screen_fused.launches``)."""
    if X.device.type == "cpu":
        return screen_scores_ref(X, theta, col_norm, r)
    out = _scan("screen_fused", X, theta[None], col_norm, None, r, 1, False)
    screen_fused.launches += 1
    return tuple(t[0] for t in out[:3])


def _check_h(h: int, dt) -> None:
    if h * torch.finfo(dt).bits // 8 + (h + 1) * 4 > HIST_SMEM_BUDGET:
        raise ValueError(f"ub_histogram: h={h} candidates exceed the "
                         f"kernel's shared-memory budget")


def _hist(ub: Tensor, lb_sorted: Tensor) -> Tensor:
    """Launch K2/K2b's histogram entry on ub (m, p) against lb_sorted
    (m, h)."""
    m, p = ub.shape
    h = lb_sorted.shape[1]
    dt = ub.dtype
    if dt not in _FLOATS:
        raise ValueError(f"ub has dtype {dt}; the kernel takes float32/64")
    _require(ub, "ub", dt, (m, p), ub.device)
    _require(lb_sorted, "lb_sorted", dt, (m, h), ub.device)
    _check_h(h, dt)
    hist = torch.empty((m, h + 1), dtype=torch.int32, device=ub.device)
    lib = _build.library("screen")
    fn = lib.ub_histogram_f64 if dt == torch.float64 else lib.ub_histogram_f32
    rc = fn(_ptr(ub), _ptr(lb_sorted), m, p, h, _ptr(hist), _stream())
    _build.check(rc, "ub_histogram")
    return hist


def ub_histogram(ub: Tensor, lb_sorted: Tensor) -> Tensor:
    """K2: hist[m] = #{i : #{l : lb_sorted[l] <= ub_i} = m}, (h+1,) int32;
    lb_sorted ascending (NaN last, as torch.sort leaves it)."""
    if ub.device.type == "cpu":
        return ub_histogram_ref(ub, lb_sorted)
    hist = _hist(ub[None], lb_sorted[None])[0]
    ub_histogram.launches += 1
    return hist


def ub_histogram_batch(ub: Tensor, lb_sorted: Tensor) -> Tensor:
    """K2b: K2 per row, ub (m, p) against lb_sorted (m, h) -> (m, h+1)
    int32, exact."""
    if ub.device.type == "cpu":
        return ub_histogram_batch_ref(ub, lb_sorted)
    hist = _hist(ub, lb_sorted)
    ub_histogram_batch.launches += 1
    return hist


def _tail(ub, tmax, cand_score, cand_idx, col_norm, r):
    """Launch K2/K2b's tail entry on the m problems of ub (m, p); returns
    (max_ub (m,), cand_lb (m, h), cand_ge (m, h), n_surv (m,))."""
    m, p = ub.shape
    h = cand_idx.shape[1]
    dt, dev = ub.dtype, ub.device
    if dt not in _FLOATS:
        raise ValueError(f"ub has dtype {dt}; the kernel takes float32/64")
    _require(ub, "ub", dt, (m, p), dev)
    _require(tmax, "tmax", dt, (m, tmax.shape[-1]), dev)
    _require(cand_idx, "cand_idx", torch.int64, (m, h), dev)
    # the scores may be a prefix of each row of the merge's sort
    if (cand_score.device != dev or cand_score.dtype != dt
            or tuple(cand_score.shape) != (m, h)
            or (h > 1 and cand_score.stride(1) != 1)):
        raise ValueError(f"cand_score must be ({m}, {h}) {dt} on {dev} "
                         f"with unit column stride")
    if col_norm.ndim == 1:
        _require(col_norm, "col_norm", dt, (p,), dev)
    else:
        _require(col_norm, "col_norm", dt, (m, p), dev)
    _check_h(h, dt)
    cand_lb = torch.empty((m, h), dtype=dt, device=dev)
    cand_ge = torch.empty((m, h), dtype=torch.int32, device=dev)
    n_surv = torch.empty(m, dtype=torch.int32, device=dev)
    max_ub = torch.empty(m, dtype=dt, device=dev)
    lib = _build.library("screen")
    fn = lib.screen_tail_f64 if dt == torch.float64 else lib.screen_tail_f32
    rc = fn(_ptr(ub), _ptr(tmax), _ptr(cand_score), cand_score.stride(0),
            _ptr(cand_idx), _ptr(col_norm), p if col_norm.ndim == 2 else 0,
            _ptr(r), m, p, tmax.shape[-1], h, _ptr(cand_lb), _ptr(cand_ge),
            _ptr(n_surv), _ptr(max_ub), _stream())
    _build.check(rc, "screen_tail")
    return max_ub, cand_lb, cand_ge, n_surv


def screen_tail(ub: Tensor, tmax: Tensor, cand_score: Tensor,
                cand_idx: Tensor, col_norm: Tensor, r):
    """The serial screen's tail in one launch of K2 (its launches count in
    ``ub_histogram.launches``): from K1's ub (p,) and tile maxima tmax,
    the merged candidates' scores and int64 ids (h,), the column norms
    (p,) and the radius r, returns (max_ub, cand_lb (h,), cand_ge (h,)
    int32, n_surv int32) as :func:`screen_tail_ref` computes them, bit
    for bit.

    On the card one thread-block cluster computes the bounds, sorts them
    in each CTA's shared memory, counts each ub by a binary search into
    shared bins in one pass and merges the bins into the leader CTA
    through distributed shared memory, which writes the counts.
    """
    if ub.device.type == "cpu":
        return screen_tail_ref(ub, tmax, cand_score, cand_idx, col_norm, r)
    dt, dev = ub.dtype, ub.device
    if isinstance(r, Tensor):
        r = r.to(device=dev, dtype=dt).reshape(1)
    else:               # a host scalar: filled on the card, no copy or sync
        r = torch.full((1,), float(r), dtype=dt, device=dev)
    out = _tail(ub[None], tmax[None], cand_score[None], cand_idx[None],
                col_norm, r)
    ub_histogram.launches += 1
    return tuple(t[0] for t in out)


def screen_tail_batch(ub: Tensor, tmax: Tensor, cand_score: Tensor,
                      cand_idx: Tensor, col_norm: Tensor, r: Tensor):
    """The fleet screen's tail, K2b (its launches count in
    ``ub_histogram_batch.launches``): :func:`screen_tail` for the m
    problems of ub (m, p), tmax (m, p/BP), scores and ids (m, h), col_norm
    (p,) shared or (m, p), r (m,) in ub's dtype; each row bitwise the
    serial tail."""
    if ub.device.type == "cpu":
        return screen_tail_batch_ref(ub, tmax, cand_score, cand_idx,
                                     col_norm, r)
    if r.dtype != ub.dtype or r.device != ub.device or r.shape != (
            ub.shape[0],):
        raise ValueError("r must be (m,) in ub's dtype, on ub's device")
    out = _tail(ub, tmax, cand_score, cand_idx, col_norm, r.contiguous())
    ub_histogram_batch.launches += 1
    return out


def empty_launch() -> None:
    """Launch the empty kernel once (the floor under a launch's device
    time; uncounted)."""
    _build.check(_build.library("screen").empty_launch(_stream()),
                 "empty_launch")


screen_fused.launches = 0
ub_histogram.launches = 0
screen_fused_batch.launches = 0
ub_histogram_batch.launches = 0
# launches in the mixed mode (``in_dtype`` / ``acc_dtype`` given)
screen_fused.mixed = types.SimpleNamespace(launches=0)
screen_fused_batch.mixed = types.SimpleNamespace(launches=0)
