"""The bf16 mixed mode's tensor-core route (K1/K1b's wgmma scan) on the
CPU, where its kernel does not run, held against the reference:

  * ``scan_unit_roundoff``: the reference's ``unit_roundoff`` of the sums'
    type on the CPU, on the plain versions and in the float32-input and
    working modes; 2^-23 (a truncating float32 adder) on a (faked) card's
    bf16 route;
  * ``scan_gamma``: the reference's ``mixed_precision_gamma`` bit for bit
    wherever the sums round to nearest, and the fast screen on the CPU
    widens by exactly that gamma;
  * ``tma_bf16`` / ``scan_input``: the bf16 copy of X has X.to(bfloat16)'s
    values, a row stride of a multiple of 8 elements, zeros in the pad, and
    is kept as it is when it already has that layout;
  * the certificate of the route: a numpy emulation of a tensor core that
    aligns each k16 step's addends to the largest and truncates, summing
    exact bf16 x bf16 products in k-blocks of 16 and 64 (partials added
    with float32 round-to-nearest, as the kernel does, or one chain over
    all rows) stays within gamma_n(2^-23) sum |theta_j x_j| of the exact
    sum (hypothesis over n, block, magnitudes).
"""
import math
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import duality as j_dual
from repro.core.screen_backend import \
    make_batch_screen_fast as j_make_batch_screen_fast
from repro_torch.core import screen_backend as sb
from repro_torch.core.duality import dot_error_gamma, mixed_precision_gamma
from repro_torch.kernels.screen.screen import (TC_UNIT_ROUNDOFF, scan_input,
                                               tma_bf16)

CPU, CARD = torch.device("cpu"), torch.device("cuda")


# --------------------------------------------------------------------------
# the route's unit roundoff and gamma
# --------------------------------------------------------------------------

@pytest.mark.parametrize("in_dtype", ["bfloat16", "float32", "float64"])
@pytest.mark.parametrize("device,plain", [(CPU, False), (CPU, True),
                                          (CARD, False), (CARD, True)])
def test_scan_unit_roundoff_by_route(in_dtype, device, plain):
    """2^-23 only for bf16 on the card's kernel route; elsewhere the
    reference's u of the sums' type (float32, or the working float64)."""
    acc = "float64" if in_dtype == "float64" else "float32"
    u = sb.scan_unit_roundoff(in_dtype, device, plain)
    if in_dtype == "bfloat16" and device == CARD and not plain:
        assert u == TC_UNIT_ROUNDOFF == 2.0 ** -23
        assert u == 2 * j_dual.unit_roundoff("float32")
    else:
        assert u == j_dual.unit_roundoff(acc)
    assert sb.scan_unit_roundoff(getattr(torch, in_dtype), device,
                                 plain) == u


@pytest.mark.parametrize("n", [1, 40, 777, 1000, 1001, 100_000])
def test_scan_gamma_is_the_references_off_the_tensor_cores(n):
    """The CPU's, the plain path's and the fma routes' gamma equal the
    reference's floats; the card's bf16 route takes u = 2^-23 in the same
    formula, a wider gamma (about +0.75 % at n = 1000)."""
    for in_dt, acc in (("bfloat16", "float32"), ("float32", "float32"),
                       ("float64", "float64")):
        ref = j_dual.mixed_precision_gamma(n, in_dt, acc)
        assert sb.scan_gamma(n, in_dt, CPU) == ref
        assert sb.scan_gamma(n, in_dt, CARD, plain=True) == ref
        if in_dt != "bfloat16":
            assert sb.scan_gamma(n, in_dt, CARD) == ref
    card = sb.scan_gamma(n, "bfloat16", CARD)
    assert card == mixed_precision_gamma(n, "bfloat16", "float32",
                                         u_acc=2.0 ** -23)
    u_in = j_dual.unit_roundoff("bfloat16")
    assert card == (1 + u_in) ** 2 * (
        1 + j_dual.dot_error_gamma(n, 2.0 ** -23)) - 1
    assert card > j_dual.mixed_precision_gamma(n, "bfloat16", "float32")


def test_card_gamma_at_the_smoke_size():
    """gamma_total at n = 1000: 7.89e-3 rounding to nearest, 7.95e-3 on the
    tensor cores."""
    cpu = sb.scan_gamma(1000, "bfloat16", CPU)
    card = sb.scan_gamma(1000, "bfloat16", CARD)
    assert 7.88e-3 < cpu < 7.90e-3 and 7.94e-3 < card < 7.96e-3
    assert card / cpu - 1 < 0.0077


@pytest.mark.parametrize("screen_dtype", ["bfloat16", "float32"])
def test_cpu_fast_screen_widens_by_the_references_gamma(screen_dtype):
    """On the CPU the fast screen's max ub equals the reference's
    ``make_batch_screen_fast`` on the same inputs to float32 rounding: its
    radius is widened by the reference's gamma (gamma 0.75 % wider would
    move these ub by about 1e-4 of their size)."""
    rng = np.random.default_rng(5)
    n, p, b = 40, 300, 3
    X = rng.standard_normal((n, p))
    cn = np.linalg.norm(X, axis=0)
    Theta = rng.standard_normal((b, n)) * 0.05
    r = np.array([1e-3, 1e-2, 0.1])
    act = rng.random((b, p)) < 0.1
    t = [torch.from_numpy(np.array(a)) for a in (X, cn, Theta, r, act)]
    out = sb.make_batch_screen_fast(t[0], t[1], 8, screen_dtype)(
        t[2], t[3], t[4], torch.zeros(b, dtype=torch.bool))
    j_out = j_make_batch_screen_fast(jnp.asarray(X), jnp.asarray(cn), 8,
                                     screen_dtype)(
        jnp.asarray(Theta), jnp.asarray(r), jnp.asarray(act),
        jnp.zeros(b, dtype=bool))
    np.testing.assert_allclose(out.max_ub.numpy(), np.asarray(j_out.max_ub),
                               rtol=8 * 2.0 ** -24, atol=0)


# --------------------------------------------------------------------------
# the bf16 copy of X in TMA's layout
# --------------------------------------------------------------------------

@pytest.mark.parametrize("p", [777, 800, 100])
def test_tma_bf16_layout(p):
    rng = np.random.default_rng(p)
    X = torch.from_numpy(rng.standard_normal((13, p)) * 10)
    Xb = tma_bf16(X)
    assert Xb.dtype == torch.bfloat16 and tuple(Xb.shape) == (13, p)
    assert torch.equal(Xb, X.to(torch.bfloat16))
    ld = Xb.stride(0)
    assert Xb.stride(1) == 1 and ld % 8 == 0 and ld == -(-p // 8) * 8
    assert Xb.data_ptr() % 16 == 0
    whole = Xb.as_strided((13, ld), (ld, 1))
    assert torch.equal(whole[:, p:], torch.zeros(13, ld - p,
                                                 dtype=torch.bfloat16))
    assert tma_bf16(Xb) is Xb                  # already laid out: kept
    assert scan_input(X, torch.bfloat16).stride() == Xb.stride()


def test_tma_bf16_relays_out_what_tma_cannot_read():
    """A bf16 X whose row stride is not a multiple of 8, or whose start is
    not 16-byte aligned, is copied; a contiguous one with p % 8 == 0 is
    not; the float32-input mode keeps a plain contiguous cast."""
    base = torch.arange(6 * 64, dtype=torch.float64).reshape(6, 64)
    ok = base.to(torch.bfloat16)
    assert tma_bf16(ok) is ok
    for bad in (ok[:, 1:], ok[:, :61].contiguous(), ok.T):
        got = tma_bf16(bad)
        assert got is not bad and torch.equal(got, bad)
        assert got.stride(0) % 8 == 0 and got.stride(1) == 1
        assert got.data_ptr() % 16 == 0
    f = scan_input(base[:, 1:], torch.float32)
    assert f.dtype == torch.float32 and f.is_contiguous()
    assert torch.equal(f, base[:, 1:].float())


# --------------------------------------------------------------------------
# the certificate: a truncating tensor-core accumulation
# --------------------------------------------------------------------------

def _trunc32(v: float) -> np.float32:
    """The float64 value v rounded toward zero to float32."""
    f = np.float32(v)
    if abs(float(f)) > abs(v):
        f = np.nextafter(f, np.float32(0.0))
    return f


def _block_fma(acc: np.float32, prods: np.ndarray) -> np.float32:
    """One k16 step as studies of tensor cores describe it: the
    accumulator and the exact products aligned to the largest addend's
    float32 ulp, each truncated there, added exactly, the sum truncated to
    float32."""
    terms = np.concatenate([[np.float64(acc)], prods])
    nz = np.abs(terms[terms != 0])
    if nz.size == 0:
        return np.float32(0.0)
    q = 2.0 ** (int(np.frexp(nz.max())[1]) - 24)   # ulp of the largest
    kept = np.trunc(terms / q) * q                  # exact multiples of q
    return _trunc32(float(np.sum(kept)))


def _tc_dot(prods: np.ndarray, block: int, partials: bool) -> np.float32:
    """k-blocks of ``block`` rows, each a chain of k16 steps from zero;
    with ``partials`` the blocks' sums are added in float32 round to
    nearest (the kernel's __fadd_rn), else one chain runs over all rows."""
    total = np.float32(0.0)
    acc = np.float32(0.0)
    for b0 in range(0, prods.size, block):
        if partials:
            acc = np.float32(0.0)
        for k0 in range(b0, min(b0 + block, prods.size), 16):
            acc = _block_fma(acc, prods[k0:k0 + 16])
        if partials:
            total = np.float32(total + acc)
    return total if partials else acc


def _bf16(v: np.ndarray) -> np.ndarray:
    """v (float64) rounded toward zero to bfloat16, as float64."""
    bits = v.astype(np.float32).view(np.uint32) & np.uint32(0xFFFF0000)
    return bits.view(np.float32).astype(np.float64)


@given(seed=st.integers(0, 2 ** 31), n=st.integers(1, 2048),
       block=st.sampled_from([16, 64]), spread=st.integers(0, 40),
       partials=st.booleans(), same_sign=st.booleans())
@settings(max_examples=40, deadline=None)
def test_truncating_tensor_core_sums_within_the_route_bound(
        seed, n, block, spread, partials, same_sign):
    rng = np.random.default_rng(seed)
    scale = 2.0 ** rng.integers(-spread // 2, spread // 2 + 1, size=(2, n))
    theta = _bf16(rng.uniform(-1, 1, n) * scale[0])
    x = _bf16(rng.uniform(-1, 1, n) * scale[1])
    if same_sign:                   # no cancellation: the largest sums
        theta, x = np.abs(theta), np.abs(x)
    prods = theta * x               # bf16 x bf16: exact in float64
    got = _tc_dot(prods, block, partials)
    exact = sum(Fraction(float(v)) for v in prods)
    bound = dot_error_gamma(n, TC_UNIT_ROUNDOFF) * float(np.abs(prods).sum())
    assert abs(Fraction(float(got)) - exact) <= Fraction(bound)


def test_truncating_emulation_truncates():
    """The emulation's k16 step loses what lies below the largest addend's
    ulp, toward zero: 1 + 16 x 2^-25 stays 1; and its error on a long sum
    of equal positive terms exceeds round-to-nearest's."""
    assert _block_fma(np.float32(1.0), np.full(16, 2.0 ** -25)) == 1.0
    assert _block_fma(np.float32(0.0), np.full(16, 2.0 ** -4)) == 1.0
    prods = np.full(4096, 0.1)
    exact = math.fsum(prods)
    assert exact - float(_tc_dot(prods, 4096, False)) > 0
    rn = np.float32(0.0)
    for v in prods:
        rn = np.float32(rn + np.float32(v))
    assert (abs(exact - float(_tc_dot(prods, 4096, False)))
            > abs(exact - float(rn)))
