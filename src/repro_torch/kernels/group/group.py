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
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.cm.cm import _LOSS, CM_SMEM_BUDGET_BYTES
from repro_torch.kernels.group.ref import group_bcd_ref
from repro_torch.kernels.screen.screen import (_FLOATS, _ptr, _require,
                                               _stream)

Tensor = torch.Tensor

# columns c < gsize of a step are finished by thread c
GROUP_MAX_GSIZE = 256
GROUP_NW = 512 // 32            # the kernel's warps (GROUP_NT = 512)


def group_smem_bytes(n: int, k: int, gsize: int, itemsize: int) -> int:
    """Shared memory of one burst over at most ``k`` live slots: z, y and
    the rows' gradients (n each), the live slots' coefficients (k, gsize),
    L and lam / L (k each), the warp sums (16, gsize), v and the step's
    update (gsize each)."""
    return ((3 * n + k * gsize + 2 * k + (GROUP_NW + 2) * gsize)
            * itemsize)


def group_smem_ok(n: int, k_max: int, gsize: int, itemsize: int = 8) -> bool:
    """Does an (n, k_max, gsize) burst fit one CTA? (gsize <= 256 as well;
    at n = 1000, gsize = 10 in float64, k_max up to 1,868 groups.)"""
    return (1 <= gsize <= GROUP_MAX_GSIZE
            and group_smem_bytes(n, k_max, gsize, itemsize)
            <= CM_SMEM_BUDGET_BYTES)


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
    fn = getattr(_build.library("group_bcd"),
                 f"group_bcd_{_LOSS[loss_name]}_{dts}")
    if int(n_epochs) > 0:          # a masked slot's step writes 0
        slot = slot.long()
        kept = beta_out.index_select(0, slot)
        beta_out.zero_().index_copy_(0, slot, kept)
    z = torch.empty(n, dtype=dt, device=dev)
    rc = fn(_ptr(A), _ptr(y), _ptr(slot32), _ptr(beta_out), _ptr(Lc),
            float(lam), int(n_epochs), n, nl, int(gsize), _ptr(z),
            _stream())
    _build.check(rc, "group_bcd")
    group_bcd.launches += 1
    return beta_out, z


group_bcd.launches = 0
