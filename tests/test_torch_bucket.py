"""Bucket padding in the port (``pad_path_state``, ``pad_fleet_prep``, the
``pad_to`` session kwarg) on the CPU, against the reference's padding and
the port's unpadded solves.

  * The padded preparations equal the reference's value for value (zero
    rows and columns, c0 pads at -inf, column-norm pads at 1.0, zero
    weights on pad rows, ``n_true``/``p_true``).
  * A p-only padded session is bit for bit the unpadded one (the
    reference's serving bitwise tier, tests/test_server.py:43-60): serial
    Scalars and Paths (plain and kernel-twin screens, plain and Gram inner
    backends) and fleets (bitwise engine, plain and Gram; the fast engine
    in each screen dtype; weighted): beta, gap, active slots, outer steps
    and traces.
  * An n-padded least-squares session has the unpadded support, beta
    within rtol 1e-10 / atol 1e-12, gap <= eps and a KKT residual <= 1e-3
    lambda (tests/test_server.py:63-79).
  * The refusals: logistic row padding (p-only padding allowed and
    bitwise), weights, a custom make_screen, a fused penalty, a cropping
    bucket; and the shared-memory gate of the kernel inner backends reads
    the padded rows.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch as rt
from conftest import make_regression
from repro.core.batch import pad_fleet_prep as j_pad_fleet_prep
from repro.core.batch import prepare_fleet as j_prepare_fleet
from repro.core.saif import pad_path_state as j_pad_path_state
from repro_torch.convert import fleet_prep_from_numpy, path_state_from_numpy
from test_torch_saif import _one_torch_thread  # noqa: F401

N, P = 60, 300


def _problem(seed=0, n=N, p=P, uniform=True):
    X, y, _ = make_regression(np.random.default_rng(seed), n=n, p=p,
                              uniform=uniform)
    return X, y, float(np.abs(X.T @ y).max())


def _same_result(a, b, p=None):
    """Bit for bit, beta cut to the real width ``p``."""
    for f, x, y in zip(a._fields, a, b):
        if f == "beta" and p is not None:
            x = x[..., :p]
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), f
        elif isinstance(x, tuple):
            for u, v in zip(x, y):
                assert torch.equal(u, v), f
        else:
            assert x == y, f


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _support(beta, tol=0.0):
    return set(np.flatnonzero(np.abs(_np(beta)) > tol).tolist())


# ---------------------------------------------------------------------------
# the padded preparations against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bucket", [(60, 512), (64, 300), (64, 512)])
def test_pad_path_state_matches_reference(bucket):
    X, y, _ = _problem()
    jprep = J.prepare_path(jnp.asarray(X), jnp.asarray(y), J.SaifConfig())
    ref = j_pad_path_state(jprep, *bucket)
    prep = path_state_from_numpy(X, y, jprep.c0, jprep.col_norm,
                                 jprep.lam_max, jprep.c0_max,
                                 jprep.c0_median, device="cpu")
    mine = rt.pad_path_state(prep, *bucket)
    for f in ("X", "y", "c0", "col_norm"):
        np.testing.assert_array_equal(_np(getattr(mine, f)),
                                      np.asarray(getattr(ref, f)), f)
    assert (mine.n_true, mine.p_true) == (ref.n_true, ref.p_true) == (N, P)
    assert (mine.lam_max, mine.c0_max, mine.c0_median) == (
        prep.lam_max, prep.c0_max, prep.c0_median)


def test_pad_path_state_identity_and_refusal():
    X, y, _ = _problem()
    prep = rt.prepare_path(X, y, device="cpu")
    assert rt.pad_path_state(prep, N, P) is prep
    with pytest.raises(ValueError, match="must dominate"):
        rt.pad_path_state(prep, N - 1, 512)


@pytest.mark.parametrize("weighted", [False, True])
def test_pad_fleet_prep_matches_reference(weighted):
    X, y, _ = _problem(1)
    Y = np.stack([y, y[::-1].copy(), 0.5 * y])
    W = ((np.random.default_rng(2).random(Y.shape) > 0.3).astype(float)
         if weighted else None)
    jprep = j_prepare_fleet(jnp.asarray(X), jnp.asarray(Y), J.SaifConfig(),
                            weights=W)
    ref = j_pad_fleet_prep(jprep, 64, 512)
    prep = fleet_prep_from_numpy(X, Y, jprep.c0, jprep.col_norm,
                                 jprep.c0_max, jprep.c0_median, W=W,
                                 device="cpu")
    mine = rt.pad_fleet_prep(prep, 64, 512)
    for f in ("X", "Y", "c0") + (("W",) if weighted else ()):
        np.testing.assert_array_equal(_np(getattr(mine, f)),
                                      np.asarray(getattr(ref, f)), f)
    cn = _np(mine.col_norm)
    if not weighted:                    # the port's shared (p,) norms
        cn = np.broadcast_to(cn, (3, 512))
    np.testing.assert_array_equal(cn, np.asarray(ref.col_norm))
    assert (mine.n_true, mine.p_true) == (ref.n_true, ref.p_true) == (N, P)
    assert mine.c0_max == prep.c0_max and mine.c0_median == prep.c0_median


# ---------------------------------------------------------------------------
# p-only padding: bit for bit
# ---------------------------------------------------------------------------

def _sessions(X, y, cfg, bucket):
    prob = rt.Problem(X=X, y=y)
    return (rt.open_session(prob, cfg, device="cpu"),
            rt.open_session(prob, cfg, device="cpu", pad_to=bucket))


@pytest.mark.parametrize("inner", ["torch", "gram"])
@pytest.mark.parametrize("screen", ["torch", "cuda"])
def test_p_padded_scalar_bitwise(screen, inner):
    X, y, lm = _problem(3)
    cfg = rt.SaifConfig(screen_backend=screen, inner_backend=inner)
    direct, padded = _sessions(X, y, cfg, (N, 512))
    for frac in (0.3, 0.15, 0.08):
        d = direct.solve(rt.Scalar(frac * lm))
        p_ = padded.solve(rt.Scalar(frac * lm))
        assert p_.beta.shape == d.beta.shape == (P,)
        _same_result(p_, d)
        assert bool((p_.active_idx[p_.active_mask] < P).all())


def test_p_padded_path_and_warm_bitwise():
    X, y, lm = _problem(4)
    direct, padded = _sessions(X, y, rt.SaifConfig(), (N, 384))
    lams = tuple(np.geomspace(0.6, 0.1, 4) * lm)
    d, p_ = direct.solve(rt.Path(lams)), padded.solve(rt.Path(lams))
    for a, b, ba, bb in zip(p_.results, d.results, p_.betas, d.betas):
        _same_result(a, b, P)
        assert torch.equal(ba, bb) and ba.shape == (P,)
    d = direct.solve(rt.Scalar(0.07 * lm, warm=True))
    p_ = padded.solve(rt.Scalar(0.07 * lm, warm=True))
    _same_result(p_, d)


def _fleet(seed=5):
    X, y, lm = _problem(seed)
    rng = np.random.default_rng(seed + 1)
    Y = np.stack([y] + [X @ np.where(rng.random(P) < 0.05,
                                     rng.uniform(-1, 1, P), 0.0)
                        + rng.normal(0, 1, N) for _ in range(2)])
    lms = np.abs(Y @ X).max(axis=1)
    return X, Y, np.array([0.3, 0.2, 0.12]) * lms


@pytest.mark.parametrize("mode", [
    ("bitwise", "torch", "working"), ("bitwise", "gram", "working"),
    ("fast", "auto", "working"), ("fast", "auto", "float32"),
    ("fast", "auto", "bfloat16")])
def test_p_padded_fleet_bitwise(mode):
    parity, inner, dtype = mode
    X, Y, lams = _fleet()
    cfg = rt.SaifConfig(parity=parity, inner_backend=inner,
                        screen_dtype=dtype)
    prob = rt.Problem(X=X)
    d = rt.open_session(prob, cfg, device="cpu").solve(rt.Fleet(Y, lams))
    p_ = rt.open_session(prob, cfg, device="cpu", pad_to=(N, 512)).solve(
        rt.Fleet(Y, lams))
    assert p_.beta.shape == d.beta.shape == (3, P)
    _same_result(p_, d)
    assert bool((p_.active_idx[p_.active_mask] < P).all())
    for i in range(3):
        assert float(p_.gap[i]) <= cfg.eps


def test_p_padded_weighted_fleet_bitwise():
    X, Y, lams = _fleet(6)
    W = (np.random.default_rng(7).random(Y.shape) > 0.25).astype(float)
    prob = rt.Problem(X=X)
    req = rt.Fleet(Y, lams, weights=W)
    d = rt.open_session(prob, device="cpu").solve(req)
    p_ = rt.open_session(prob, device="cpu", pad_to=(N, 400)).solve(req)
    _same_result(p_, d)


def test_fleet_solve_on_padded_prep():
    """The engine entry itself: ``fleet_solve(prep=padded)`` is the
    unpadded fleet on the real columns, and no pad ever holds a slot."""
    X, Y, lams = _fleet(8)
    prep = rt.prepare_fleet(X, Y, device="cpu")
    res = rt.fleet_solve(None, None, lams, device="cpu",
                         prep=rt.pad_fleet_prep(prep, N, 320))
    ref = rt.fleet_solve(X, Y, lams, device="cpu")
    assert res.beta.shape == (3, 320) and not res.beta[:, P:].any()
    _same_result(res, ref, P)


# ---------------------------------------------------------------------------
# n padding: the same support, allclose, certified
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(60, 37, 64, 64), (60, 300, 64, 512)])
def test_n_padded_session_support_parity(shape):
    n, p, nb, pb = shape
    X, y, lm = _problem(9, n, p, uniform=False)
    cfg = rt.SaifConfig()
    prob = rt.Problem(X=X, y=y)
    direct = rt.open_session(prob, cfg, device="cpu")
    padded = rt.open_session(prob, cfg, device="cpu", pad_to=(nb, pb))
    loss = rt.get_loss("least_squares")
    for frac in (0.3, 0.12):
        lam = frac * lm
        d = direct.solve(rt.Scalar(lam))
        res = padded.solve(rt.Scalar(lam))
        assert _support(res.beta) == _support(d.beta)
        np.testing.assert_allclose(res.beta.numpy(), d.beta.numpy(),
                                   rtol=1e-10, atol=1e-12)
        assert float(res.gap) <= cfg.eps
        kkt = float(rt.kkt_residual(loss, torch.from_numpy(X),
                                    torch.from_numpy(y), res.beta, lam))
        assert kkt <= 1e-3 * lam


# ---------------------------------------------------------------------------
# refusals and the kernel gate
# ---------------------------------------------------------------------------

def test_pad_to_rejects_logistic_row_padding():
    rng = np.random.default_rng(10)
    X, y, _ = make_regression(rng, n=40, p=24, uniform=False)
    yl = np.sign(y) + (np.sign(y) == 0)
    prob = rt.Problem(X=X, y=yl, loss="logistic")
    cfg = rt.SaifConfig(loss="logistic")
    with pytest.raises(NotImplementedError, match="row padding"):
        rt.open_session(prob, cfg, device="cpu", pad_to=(48, 32))
    res = rt.open_session(prob, cfg, device="cpu", pad_to=(40, 32)).solve(
        rt.Scalar(0.05))
    direct = rt.open_session(prob, cfg, device="cpu").solve(rt.Scalar(0.05))
    _same_result(res, direct)


@pytest.mark.parametrize("case", ["weights", "make_screen", "fused",
                                  "crop"])
def test_pad_to_refusals(case):
    X, y, _ = _problem(11, 20, 30)
    prob, kw, err, match = rt.Problem(X=X, y=y), {}, NotImplementedError, ""
    if case == "weights":
        prob, match = rt.Problem(X=X, y=y, weights=np.ones(20)), "weights"
    elif case == "make_screen":
        kw, match = {"make_screen": lambda h: None}, "make_screen"
    elif case == "fused":
        prob = rt.Problem(X=X, y=y, penalty=rt.fused(np.arange(30) - 1))
        match = "plain-LASSO"
    else:
        err, match = ValueError, "never crop"
    with pytest.raises(err, match=match):
        rt.open_session(prob, device="cpu",
                        pad_to=(20, 29) if case == "crop" else (24, 32),
                        **kw)


def test_kernel_gate_reads_padded_rows():
    """The route is chosen on the real rows; the CM kernel's shared-memory
    gate reads the padded rows it would be handed, and refuses."""
    from repro_torch.core.inner_backend import resolve_inner_backend
    from repro_torch.kernels.cm.cm import cm_smem_ok
    cuda = torch.device("cuda")
    n, n_pad, k = 1000, 9000, 64
    assert cm_smem_ok(n, k) and not cm_smem_ok(n_pad, k)
    assert resolve_inner_backend("auto", "logistic", n, k, cuda) == "cuda"
    for name in ("auto", "cuda"):
        with pytest.raises(ValueError, match="shared-memory"):
            resolve_inner_backend(name, "logistic", n, k, cuda, n_pad=n_pad)
        with pytest.raises(ValueError, match="shared-memory"):
            rt.resolve_batch_inner(rt.SaifConfig(loss="logistic",
                                                 inner_backend=name),
                                   n, k, 4, cuda, n_pad=n_pad)
    # least squares under the crossover routes to the Gram sweep on the
    # real rows, whatever the padding
    assert resolve_inner_backend("auto", "least_squares", 100, 400, cuda,
                                 n_pad=n_pad) == "gram"
    assert resolve_inner_backend("torch", "logistic", n, k, cuda,
                                 n_pad=n_pad) == "torch"
