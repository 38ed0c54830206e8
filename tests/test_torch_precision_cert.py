"""The port's fast-parity fleet (``parity="fast"``) and its certified
mixed-precision screen on the CPU, held against the reference on the same
float64 numpy inputs (the reference's ``tests/test_precision_cert.py``,
``tests/test_screen_rules.py:154-178``):

  * the rounding-bound helpers equal the reference's floats exactly;
  * subset safety: the widened low-precision ub dominates the exact f64
    ub elementwise (32 seeds), and the ADD-stop bound stays safe under the
    two-tier escalation;
  * the port's screen against the reference's ``make_batch_screen_fast``:
    the same escalation decision per row, max ub within float32 rounding;
  * supports: ``fleet_solve(parity="fast")`` in every screen dtype finds
    the reference's bitwise-fleet supports with gap <= eps and KKT <= 1e-6
    lambda (32 seeds); hybrid + fast + bf16 finds the unscreened CM's;
  * weighted fleets, ``select_solve`` and a logistic fleet (which keeps
    the bitwise engine) under fast parity;
  * the Gram reconcile after a forced drop and re-add of one feature, and
    the config's validation errors.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.core import SaifConfig as JConfig
from repro.core import batch as j_batch
from repro.core import duality as j_dual
from repro.core.cm import solve_lasso_cm as j_solve_lasso_cm
from repro.core.losses import get_loss as j_get_loss
from repro.core.screen_backend import \
    make_batch_screen_fast as j_make_batch_screen_fast
from repro_torch.core import batch_fast as bf
from repro_torch.core import active_set as aset_lib
from repro_torch.core.duality import (dot_error_gamma, mixed_precision_gamma,
                                      unit_roundoff, widened_radius)
from repro_torch.core import screen_backend as sb
from repro_torch.core.screen_backend import make_batch_screen_fast
from repro_torch.kernels import ops
from test_torch_batch import _fleet, _support
from test_torch_saif import _one_torch_thread  # noqa: F401

N_SEEDS = 32
DTYPES = ("bfloat16", "float32", "float64")
LS = rt.get_loss("least_squares")


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------
# the rounding-bound helpers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 40, 1000, 2 ** 24])
def test_rounding_helpers_equal_the_reference(n):
    for dt in DTYPES:
        u = unit_roundoff(dt)
        assert u == j_dual.unit_roundoff(dt)
        assert unit_roundoff(getattr(torch, dt)) == u
        assert dot_error_gamma(n, u) == j_dual.dot_error_gamma(n, u)
        for acc in DTYPES:
            assert (mixed_precision_gamma(n, dt, acc)
                    == j_dual.mixed_precision_gamma(n, dt, acc))
            assert (mixed_precision_gamma(n, getattr(torch, dt),
                                          getattr(torch, acc))
                    == j_dual.mixed_precision_gamma(n, dt, acc))
    # the vacuous region: n u >= 1
    assert dot_error_gamma(n, 1.0 / n) == float("inf")
    assert dot_error_gamma(n, 1.0 / n) == j_dual.dot_error_gamma(n, 1.0 / n)
    if n >= 1000:
        assert mixed_precision_gamma(n, "bfloat16", "bfloat16") == float(
            "inf")


@pytest.mark.parametrize("dt", DTYPES)
def test_widened_radius_matches_the_reference(dt):
    rng = np.random.default_rng(5)
    Theta = rng.normal(size=(4, 37)) / 7.0
    r = rng.uniform(0, 1, 4)
    gamma = mixed_precision_gamma(37, dt, "float32")
    got = widened_radius(_t(r), _t(Theta), gamma)
    want = j_dual.widened_radius(jnp.asarray(r), jnp.asarray(Theta), gamma)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-15)
    one = widened_radius(_t(r[0]), _t(Theta[0]), gamma)
    np.testing.assert_allclose(float(one), float(want[0]), rtol=1e-15)


# --------------------------------------------------------------------------
# the certified screen
# --------------------------------------------------------------------------

def _screen_state(rng, n, p, b):
    """The reference's random fleet screen inputs: unit-ish columns, dual
    points, radii from decisive to sloppy."""
    X = rng.uniform(-1, 1, (n, p))
    X /= np.linalg.norm(X, axis=0, keepdims=True)
    cn = np.linalg.norm(X, axis=0)
    Theta = rng.normal(0, 1.0 / np.sqrt(n), (b, n))
    scales = np.array([1e-3, 0.3, 1.0])
    r = rng.uniform(0.0, 1.0, (b,)) * scales[rng.integers(0, 3, b)]
    in_active = rng.random((b, p)) < 0.05
    return X, cn, Theta, r, in_active


def _exact_ub(X, cn, Theta, r, in_active):
    score = np.abs(Theta @ X)
    return np.where(in_active, -np.inf, score) + cn[None, :] * r[:, None]


@pytest.mark.parametrize("screen_dtype", ["bfloat16", "float32",
                                          "bfloat16-card"])
def test_widened_screen_is_subset_safe(screen_dtype, monkeypatch):
    """Elementwise: the widened low-precision ub >= the exact f64 ub, so
    what the cheap pass rules out the exact screen rules out too; and
    max ub dominates the exact max (``do`` all False: the cheap branch).
    ``-card``: at the card's bf16 route's gamma (its tensor-core sums
    certified as a truncating float32 adder), on the same CPU twins."""
    screen_dtype, _, route = screen_dtype.partition("-")
    n, p, b = 48, 160, 3
    u_acc = unit_roundoff("float32")
    if route:
        card_gamma = sb.scan_gamma(n, screen_dtype, torch.device("cuda"))
        assert card_gamma > mixed_precision_gamma(n, screen_dtype, "float32")
        monkeypatch.setattr(sb, "scan_gamma", lambda *a, **k: card_gamma)
    for seed in range(N_SEEDS):
        rng = np.random.default_rng(1000 + seed)
        X, cn, Theta, r, in_active = _screen_state(rng, n, p, b)
        screen = make_batch_screen_fast(_t(X), _t(cn), p,
                                        screen_dtype=screen_dtype)
        out = screen(_t(Theta), _t(r), _t(in_active),
                     torch.zeros(b, dtype=torch.bool))
        assert screen.escalated == 0
        gamma = (card_gamma if route else
                 mixed_precision_gamma(n, screen_dtype, "float32"))
        r_wide = widened_radius(_t(r), _t(Theta), gamma).numpy()
        score_lo = np.full((b, p), -np.inf)
        np.put_along_axis(score_lo, out.cand_idx.numpy(),
                          out.cand_score.numpy(), axis=1)
        ub_lo = (score_lo + cn[None, :] * r_wide[:, None]) * (1 + 8 * u_acc)
        ub_exact = _exact_ub(X, cn, Theta, r, in_active)
        free = ~in_active
        assert np.all(ub_lo[free] >= ub_exact[free]), seed
        assert np.all(out.max_ub.numpy()
                      >= np.max(ub_exact, axis=1) - 1e-12), seed
        assert out.max_ub.dtype == torch.float64


def test_widened_screen_add_stop_safe_under_escalation():
    """With ``do`` set the escalation may swap in working precision for
    undecidable rows; max ub still dominates the exact one in every row,
    and some rows do escalate."""
    n, p, b = 48, 160, 4
    escalated = 0
    for seed in range(N_SEEDS):
        rng = np.random.default_rng(2000 + seed)
        X, cn, Theta, r, in_active = _screen_state(rng, n, p, b)
        ub0 = _exact_ub(X, cn, Theta, r, in_active)
        Theta = Theta / np.max(ub0, axis=1, keepdims=True)
        screen = make_batch_screen_fast(_t(X), _t(cn), 8,
                                        screen_dtype="bfloat16")
        out = screen(_t(Theta), _t(r), _t(in_active),
                     torch.ones(b, dtype=torch.bool))
        escalated += screen.escalated
        ub_exact = _exact_ub(X, cn, Theta, r, in_active)
        assert np.all(out.max_ub.numpy()
                      >= np.max(ub_exact, axis=1) - 1e-12), seed
    assert escalated > 0


@pytest.mark.parametrize("screen_dtype", ["working", "float32", "bfloat16"])
def test_fast_screen_against_the_reference(screen_dtype):
    """The port's screen and the reference's on the same inputs: the same
    rows escalate (the reference's decision recomputed from its own
    formula), max ub within float32 rounding (escalated rows: working
    precision), and the same top candidate wherever it is clear."""
    n, p, b, h = 48, 300, 4, 8
    low = screen_dtype != "working"
    u_acc = unit_roundoff("float32" if low else "float64")
    decided = undecided = 0
    for seed in range(N_SEEDS // 2):
        rng = np.random.default_rng(4000 + seed)
        X, cn, Theta, r, in_active = _screen_state(rng, n, p, b)
        ub0 = _exact_ub(X, cn, Theta, r, in_active)
        Theta = Theta / np.max(ub0, axis=1, keepdims=True)
        do = rng.random(b) < 0.75
        screen = make_batch_screen_fast(_t(X), _t(cn), h,
                                        screen_dtype=screen_dtype)
        got = screen(_t(Theta), _t(r), _t(in_active), _t(do))
        j_screen = j_make_batch_screen_fast(jnp.asarray(X), jnp.asarray(cn),
                                            h, screen_dtype=screen_dtype)
        want = j_screen(jnp.asarray(Theta), jnp.asarray(r),
                        jnp.asarray(in_active), jnp.asarray(do))
        if low:
            # the reference's undecidable rows, by its own formula
            in_dt = jnp.dtype(screen_dtype)
            gamma = j_dual.mixed_precision_gamma(n, in_dt, jnp.float32)
            r_wide = j_dual.widened_radius(jnp.asarray(r),
                                           jnp.asarray(Theta), gamma)
            score = jnp.abs(jnp.einsum(
                "bn,np->bp", jnp.asarray(Theta).astype(in_dt),
                jnp.asarray(X).astype(in_dt),
                preferred_element_type=jnp.float32))
            masked = jnp.where(jnp.asarray(in_active), -jnp.inf, score)
            cn32 = jnp.asarray(cn, jnp.float32)
            ub = (masked + cn32 * r_wide.astype(jnp.float32)[:, None]) * \
                jnp.float32(1 + 8 * u_acc)
            widen = (r_wide - jnp.asarray(r)).astype(jnp.float32)
            r_lo = r_wide.astype(jnp.float32) - 2.0 * widen
            ub_lo = (masked + cn32 * r_lo[:, None]) * \
                jnp.float32(1 - 8 * u_acc)
            undec = (do & np.asarray(jnp.max(ub, axis=1) >= 1.0)
                     & np.asarray(jnp.max(ub_lo, axis=1) < 1.0))
            esc = np.zeros(b, bool)
            esc[screen.last_escalated] = True
            assert (esc == undec).all(), seed
        else:
            undec = np.zeros(b, bool)
        undecided += int(undec.sum())
        mu_got, mu_want = got.max_ub.numpy(), np.asarray(want.max_ub)
        tol = np.where(undec, 1e-12, 8 * u_acc)
        assert np.all(np.abs(mu_got - mu_want) <= tol * np.abs(mu_want)), \
            seed
        s = np.asarray(want.cand_score)
        clear = (s[:, 0] - s[:, 1]) > 1e-2 * np.abs(s[:, 0])
        decided += int(clear.sum())
        assert (got.cand_idx.numpy()[clear, 0]
                == np.asarray(want.cand_idx)[clear, 0]).all(), seed
    assert decided > 0
    assert undecided > 0 if screen_dtype == "bfloat16" else True


# --------------------------------------------------------------------------
# supports against the reference
# --------------------------------------------------------------------------

def _seed_problem(seed, B=4, n=40, p=100):
    rng = np.random.default_rng(3000 + seed)
    X = rng.uniform(-10, 10, (n, p))
    Y = (X @ rng.normal(0, 0.2, (p, B))).T + rng.normal(0, 1.0, (B, n))
    lam = np.array([0.4 * float(j_dual.lambda_max(
        j_get_loss("least_squares"), jnp.asarray(X), jnp.asarray(Y[i])))
        for i in range(B)])
    return X, Y, lam


@pytest.fixture(scope="module")
def reference_supports():
    """The reference's bitwise-fleet supports, one fleet per seed."""
    out = []
    for seed in range(N_SEEDS):
        X, Y, lam = _seed_problem(seed)
        bit = j_batch.fleet_solve(X, Y, lam, JConfig(eps=1e-6))
        out.append([set(np.flatnonzero(np.abs(np.asarray(bit.beta[i])) > 0))
                    for i in range(Y.shape[0])])
    return out


@pytest.mark.parametrize("screen_dtype", ["working", "float32", "bfloat16"])
def test_fast_fleet_finds_the_bitwise_supports(screen_dtype,
                                                reference_supports):
    eps = 1e-6
    cfg = rt.SaifConfig(eps=eps, parity="fast", screen_dtype=screen_dtype)
    ops.reset_launch_counts()
    for seed in range(N_SEEDS):
        X, Y, lam = _seed_problem(seed)
        fast = rt.fleet_solve(X, Y, lam, cfg, device="cpu")
        for i in range(Y.shape[0]):
            got = set(torch.nonzero(fast.beta[i]).flatten().tolist())
            assert got == reference_supports[seed][i], (seed, i)
            assert float(fast.gap[i]) <= eps
            kkt = float(rt.kkt_residual(LS, _t(X), _t(Y[i]), fast.beta[i],
                                        float(lam[i])))
            assert kkt <= 1e-6 * lam[i], (seed, i, kkt)
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


def test_hybrid_fast_bf16_finds_the_oracle_support():
    """hybrid + parity="fast" + bf16 screening (the reference's
    ``test_hybrid_composes_with_mixed_precision_fleet``): the point
    discards ride on the widened radii and the post-check holds every row
    to the unscreened CM's support."""
    b = 6
    rng = np.random.default_rng(11)
    n, p = 40, 150
    X = rng.uniform(-10, 10, (n, p))
    Ys, lams = [], []
    jl = j_get_loss("least_squares")
    for i in range(b):
        w = np.zeros(p)
        w[rng.choice(p, 8, replace=False)] = rng.normal(size=8)
        Ys.append(X @ w + 0.5 * rng.normal(size=n))
        lams.append((0.08 + 0.25 * i / (b - 1)) * float(j_dual.lambda_max(
            jl, jnp.asarray(X), jnp.asarray(Ys[-1]))))
    cfg = rt.SaifConfig(eps=1e-7, screen_rule="hybrid", parity="fast",
                        screen_dtype="bfloat16")
    res = rt.fleet_solve(X, np.stack(Ys), lams, cfg, device="cpu")
    for i in range(b):
        ref = j_solve_lasso_cm(jl, jnp.asarray(X), jnp.asarray(Ys[i]),
                               lams[i], tol=1e-10)
        assert _support(res.beta[i]) == _support(_t(ref))
        assert float(res.gap[i]) <= 1e-7


# --------------------------------------------------------------------------
# other fleets under fast parity
# --------------------------------------------------------------------------

@pytest.mark.parametrize("screen_dtype", ["working", "bfloat16"])
def test_weighted_fast_fleet_against_the_reference(screen_dtype):
    """A weighted fast fleet (the CV row masks) has the reference's
    weighted bitwise supports, gap <= eps and a weighted KKT residual
    <= 1e-6 lambda."""
    X, Y, lams = _fleet(np.random.default_rng(7), 40, 120, 3)
    W = rt.kfold_weights(40, 3, seed=1).numpy()
    cfg = rt.SaifConfig(eps=1e-7, parity="fast", screen_dtype=screen_dtype)
    res = rt.fleet_solve(X, Y, lams, cfg, device="cpu", weights=W)
    ref = j_batch.fleet_solve(X, Y, jnp.asarray(lams), JConfig(eps=1e-7),
                              weights=jnp.asarray(W))
    for i in range(3):
        assert _support(res.beta[i]) == _support(_t(ref.beta[i]))
        assert float(res.gap[i]) <= 1e-7
        kkt = float(rt.kkt_residual(LS, _t(X), _t(Y[i]), res.beta[i],
                                    lams[i], sample_w=_t(W[i])))
        assert kkt <= 1e-6 * lams[i]


def test_select_solve_under_fast_parity():
    """``select_solve`` composes with fast parity: the subsample fleet runs
    the lockstep engine, CV the fast preparation; the stable support is
    the bitwise selection's."""
    X, Y, _ = _fleet(np.random.default_rng(8), 40, 120, 1)
    y = Y[0]
    lm = float(rt.lambda_max(LS, _t(X), _t(y)))
    req = rt.Select(lams=np.geomspace(0.9, 0.05, 6) * lm, n_folds=3,
                    n_subsamples=6, seed=2)
    fast = rt.select_solve(X, y, req, rt.SaifConfig(
        eps=1e-7, parity="fast", screen_dtype="bfloat16"), device="cpu")
    bit = rt.select_solve(X, y, req, rt.SaifConfig(eps=1e-7), device="cpu")
    assert fast.lam == bit.lam
    np.testing.assert_array_equal(fast.stable_support, bit.stable_support)
    np.testing.assert_allclose(fast.frequencies, bit.frequencies)


def test_logistic_fast_fleet_keeps_the_bitwise_engine():
    """Fast parity is least squares only: a logistic fleet runs the
    bitwise engine from the fast preparation, row for row the bitwise
    engine's on that preparation, with the bitwise supports."""
    X, Y, lams = _fleet(np.random.default_rng(9), 40, 100, 3,
                        loss_name="logistic")
    fast_cfg = rt.SaifConfig(loss="logistic", parity="fast")
    res = rt.fleet_solve(X, Y, lams, fast_cfg, device="cpu")
    prep = rt.prepare_fleet(X, Y, fast_cfg, device="cpu")
    bit_cfg = rt.SaifConfig(loss="logistic")
    same = rt.fleet_solve(None, None, lams, bit_cfg, device="cpu", prep=prep)
    plain = rt.fleet_solve(X, Y, lams, bit_cfg, device="cpu")
    for i in range(3):
        assert torch.equal(res.beta[i], same.beta[i])
        assert torch.equal(res.gap[i], same.gap[i])
        assert _support(res.beta[i]) == _support(plain.beta[i])


# --------------------------------------------------------------------------
# the Gram reconcile and the config
# --------------------------------------------------------------------------

def test_gram_refresh_sees_a_dropped_and_readded_feature():
    """Slot s holds feature f; f is dropped (the slot dies and its gidx is
    scrubbed to -1), a neighbour slot is refreshed while s is dead (its
    column of G then reads 0 in row s), and f comes back into s: the
    reconcile must see s as dirty, so every live entry of G and rho
    equals a full rebuild."""
    rng = np.random.default_rng(12)
    n, p, k, h = 30, 50, 8, 4
    X = _t(rng.normal(size=(n, p)))
    Y = _t(rng.normal(size=(1, n)))
    init_idx = torch.tensor([[3, 7, 11, 0, 0, 0, 0, 0]])
    mask = torch.tensor([[True, True, True] + [False] * 5])
    aset = aset_lib.init_active_set_stacked(p, k, init_idx, torch.float64,
                                            torch.zeros(1, k), mask)
    carry, _ = bf._gram_rebuild_fast(X, Y, None, aset)

    def step(aset, carry):
        Xa = aset_lib.gather_columns_stacked(X, aset)
        return bf._gram_refresh_fast(X, Y, None, carry, aset, Xa, h)

    # drop feature 7 (slot 1), add 20 into a free slot: 20 takes slot 1
    aset = bf._delete_features_fast(aset, torch.tensor([[False, True] +
                                                        [False] * 6]))
    carry = step(aset, carry)
    assert int(carry.gidx[0, 1]) == -1
    aset = bf._add_features_fast(aset, torch.tensor([[20]]),
                                 torch.tensor([[True]]))
    assert int(aset.idx[0, 1]) == 20
    carry = step(aset, carry)
    # drop 20 again, refresh a new neighbour (slot 3 <- 30) while slot 1 is
    # dead, then bring 7 back into slot 1
    aset = bf._delete_features_fast(aset, torch.tensor([[False, True] +
                                                        [False] * 6]))
    aset = bf._add_features_fast(aset, torch.tensor([[30]]),
                                 torch.tensor([[True]]))
    carry = step(aset, carry)
    assert int(aset.idx[0, 1]) == 30 and int(carry.gidx[0, 1]) == 30
    aset = bf._delete_features_fast(aset, torch.tensor([[False, True] +
                                                        [False] * 6]))
    aset = bf._add_features_fast(aset, torch.tensor([[31, 7]]),
                                 torch.tensor([[True, True]]))
    carry = step(aset, carry)
    full, _ = bf._gram_rebuild_fast(X, Y, None, aset)
    live = aset.mask[0]
    torch.testing.assert_close(carry.G[0][live][:, live],
                               full.G[0][live][:, live], rtol=1e-13,
                               atol=1e-12)
    torch.testing.assert_close(carry.rho[0][live], full.rho[0][live],
                               rtol=1e-13, atol=1e-12)
    assert torch.equal(carry.gidx, full.gidx)


def test_screen_dtype_validation_matches_the_reference():
    for kw in ({"screen_dtype": "float16"},
               {"screen_dtype": "bfloat16"},
               {"screen_dtype": "float32", "parity": "bitwise"}):
        with pytest.raises(ValueError) as want:
            JConfig(**kw)
        with pytest.raises(ValueError) as got:
            rt.SaifConfig(**kw)
        assert str(got.value) == str(want.value)
    assert rt.SaifConfig(parity="fast",
                         screen_dtype="bfloat16").screen_dtype == "bfloat16"
