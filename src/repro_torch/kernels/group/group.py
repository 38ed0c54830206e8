"""Group block-CD kernel B-n3: wrapper and shared-memory gate.

The CUDA source is ``csrc/group_bcd.cu``; the plain version is
``ref.py::group_bcd_ref``. A wrapper given CPU tensors returns the plain
version; given CUDA tensors it launches the kernel or raises.

B-n3 replaces the group-LASSO burst of ``repro/core/group.py:114
_gsaif_jit`` (the ``fori_loop``s at ``:165`` and ``:169``) and the epoch
of the unscreened oracle ``:67 solve_group_lasso_bcd`` (``:91``), XLA
loops: block coordinate descent over the live slots of a group active set,
counted in ``group_bcd.launches``. It takes the live groups' blocks as
the caller gathered them (``ref.group_blocks``: (live, gsize, n), each
column a contiguous row), so the kernel's loads are coalesced and the
block stays in L2 across epochs (the reference gathers all k_max slots'
blocks every outer step).

The kernel has two forms, one entry each, and :func:`group_form` picks
one from the shape: the register form (``group_bcd_reg_*``: a cluster of
8 CTAs, the thread's rows of a block in registers, the next block loaded
behind the step's tail, one barrier wait a step; the blocks laid out by
:func:`reg_layout`) where n <= 1,024, gsize <= 10 and its shared memory
fits, the chunked form (``group_bcd_*``, one CTA) elsewhere. Both give
the same bits.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.cm.cm import _LOSS, CM_SMEM_BUDGET_BYTES
from repro_torch.kernels.group.ref import group_bcd_ref
from repro_torch.kernels.screen.screen import (_FLOATS, _ptr, _require,
                                               _stream)

Tensor = torch.Tensor

GROUP_MAX_GSIZE = 256
GROUP_NW = 512 // 32            # the kernel's warps (NT = 512)
# the register form: 2 rows a thread, at most 10 columns
GROUP_REG_ROWS = 2 * 512
GROUP_REG_COLS = 10


def _reg_smem_bytes(k: int, gsize: int, itemsize: int) -> int:
    # a barrier per step parity (8 bytes each); the live slots'
    # coefficients, L and lam / L; the warp sums (2 parities, 16 warps, the
    # column bound) and each warp's v and d
    return 16 + (k * gsize + 2 * k + 4 * GROUP_NW * GROUP_REG_COLS) * itemsize


def _chunked_smem_bytes(n: int, k: int, gsize: int, itemsize: int) -> int:
    # z, y and the rows' gradients; the live slots' coefficients, L and
    # lam / L; the warp sums (16, gsize), v and the step's update
    return (3 * n + k * gsize + 2 * k + (GROUP_NW + 2) * gsize) * itemsize


def group_form(n: int, k: int, gsize: int, itemsize: int):
    """The kernel's form for a burst over ``n`` rows and at most ``k``
    live slots in groups of ``gsize``: ``"reg"`` (the thread's 2 rows of
    a block's columns in registers) where n <= 1,024, gsize <= 10 and its
    shared memory fits; else ``"chunked"`` where that form's fits; else
    None (no form takes it)."""
    if not 1 <= gsize <= GROUP_MAX_GSIZE:
        return None
    if (n <= GROUP_REG_ROWS and gsize <= GROUP_REG_COLS
            and _reg_smem_bytes(k, gsize, itemsize) <= CM_SMEM_BUDGET_BYTES):
        return "reg"
    if _chunked_smem_bytes(n, k, gsize, itemsize) <= CM_SMEM_BUDGET_BYTES:
        return "chunked"
    return None


def reg_layout(A: Tensor) -> Tensor:
    """The register form's copy of the blocks ``A`` (live, gsize, n):
    (live, gsize, 512, 2), entry (j, c, t, r) row t + 512 r of column c
    of block j, 0 past n, so that each thread loads its two rows of a
    column at once."""
    nl, gsize, n = A.shape
    out = A.new_zeros(nl, gsize, GROUP_REG_ROWS)
    out[..., :n] = A
    return out.view(nl, gsize, 2, GROUP_REG_ROWS // 2).transpose(
        2, 3).contiguous()


def group_smem_bytes(n: int, k: int, gsize: int, itemsize: int) -> int:
    """Shared memory of one burst over at most ``k`` live slots in the
    form :func:`group_form` picks (the chunked form's where none does)."""
    if group_form(n, k, gsize, itemsize) == "reg":
        return _reg_smem_bytes(k, gsize, itemsize)
    return _chunked_smem_bytes(n, k, gsize, itemsize)


def group_smem_ok(n: int, k_max: int, gsize: int, itemsize: int = 8) -> bool:
    """Does an (n, k_max, gsize) burst fit either form? (At n = 1000,
    gsize = 10 in float64: up to 2,079 groups, in the register form; the
    chunked form alone holds 1,868.)"""
    return group_form(n, k_max, gsize, itemsize) is not None


def group_bcd(A: Tensor, y: Tensor, slot: Tensor, beta: Tensor, L: Tensor,
              lam, n_epochs: int, *, loss_name: str = "least_squares"):
    """B-n3: ``n_epochs`` cyclic group soft-threshold sweeps over the live
    slots of a group active set. ``A`` (live, gsize, n) their blocks, as
    ``ref.group_blocks`` gathers them, ``slot`` (live,) their slot ids in
    ascending order, ``beta`` (k, gsize) and ``L`` (k,) every slot's
    coefficients and block Lipschitz constant. Returns (beta (k, gsize),
    z (n,) = sum_j X_j beta_j over the live slots); the inputs are left as
    they were."""
    if A.device.type == "cpu":
        return group_bcd_ref(A, y, slot, beta, L, lam, n_epochs,
                             loss_name=loss_name)
    nl, gsize, n = A.shape
    k = beta.shape[0]
    dt, dev = A.dtype, A.device
    if dt not in _FLOATS or loss_name not in _LOSS:
        raise ValueError(f"group_bcd: no kernel for loss {loss_name!r} in "
                         f"{dt}")
    if not group_smem_ok(n, k, gsize, A.element_size()):
        raise ValueError(f"group_bcd: a burst of {k} groups of {gsize} over "
                         f"{n} rows ({dt}) exceeds the kernel's "
                         f"shared-memory budget")
    A = A.contiguous()
    _require(y, "y", dt, (n,), dev)
    slot32 = slot.to(torch.int32).contiguous()
    _require(slot32, "slot", torch.int32, (nl,), dev)
    Lc = L.to(dt).contiguous()
    _require(Lc, "L", dt, (k,), dev)
    beta_out = beta.to(dt).clone().contiguous()
    _require(beta_out, "beta", dt, (k, gsize), dev)
    dts = "f64" if dt == torch.float64 else "f32"
    reg = group_form(n, k, gsize, A.element_size()) == "reg"
    fn = getattr(_build.library("group_bcd"),
                 f"group_bcd_{'reg_' if reg else ''}{_LOSS[loss_name]}_{dts}")
    if int(n_epochs) > 0:          # a masked slot's step writes 0
        slot = slot.long()
        kept = beta_out.index_select(0, slot)
        beta_out.zero_().index_copy_(0, slot, kept)
    if reg:
        A = reg_layout(A)
    z = torch.empty(n, dtype=dt, device=dev)
    rc = fn(_ptr(A), _ptr(y), _ptr(slot32), _ptr(beta_out), _ptr(Lc),
            float(lam), int(n_epochs), n, nl, int(gsize), _ptr(z),
            _stream())
    _build.check(rc, "group_bcd")
    group_bcd.launches += 1
    return beta_out, z


group_bcd.launches = 0
