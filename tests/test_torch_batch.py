"""The port's fleet on the CPU: ``repro_torch.fleet_solve`` against B serial
``repro_torch.saif`` calls (bit for bit) and against the reference's
``repro.core.batch.fleet_solve`` on the same float64 inputs.

Bitwise cases: every field of fleet row b equals the serial result — beta,
gap, outer steps, active count, overflow flag and every trace — and, where
the capacities match, the slot layout. Reference cases (its ``jnp`` and
``gram`` fleets, which pass its own parity tests): the same support at
1e-8, the same ``n_active`` and integer traces, beta allclose (rtol 1e-6,
atol 1e-8), gap <= eps and the KKT residual <= 1e-3 lambda. The reference's
pallas fleet and its overflow regrowth fail its own tests, so the overflow
case is held against the port's serial solves only. Sizes are the
reference's fleet CI sizes (B <= 4, n <= 40, p <= 150).
"""
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.core import SaifConfig as JConfig
from repro.core import batch as j_batch
from repro.core.duality import lambda_max as j_lambda_max
from repro.core.losses import get_loss as j_get_loss
from repro_torch.convert import fleet_prep_from_numpy
from repro_torch.kernels import ops
from test_torch_saif import _one_torch_thread  # noqa: F401

INT_TRACES = ("trace_n_active", "trace_screened", "trace_survivors",
              "trace_post_viol")


def _fleet(rng, n, p, b, frac_lo=0.05, frac_hi=0.4,
           loss_name="least_squares"):
    """The reference's fleet generator (tests/test_batch_parity.py)."""
    X = rng.uniform(-10, 10, (n, p))
    Ys, lams = [], []
    for i in range(b):
        w = np.zeros(p)
        w[rng.choice(p, max(p // 15, 3), replace=False)] = rng.normal(
            size=max(p // 15, 3))
        if loss_name == "logistic":
            y = np.sign(X @ w + 0.3 * rng.normal(size=n))
            y[y == 0] = 1.0
        else:
            y = X @ w + 0.5 * rng.normal(size=n)
        frac = frac_lo + (frac_hi - frac_lo) * i / max(b - 1, 1)
        lams.append(frac * float(j_lambda_max(j_get_loss(loss_name), X, y)))
        Ys.append(y)
    return X, np.stack(Ys), lams


def _assert_bitwise(res, serial, b):
    """Fleet row b equals the serial result byte for byte."""
    assert torch.equal(res.beta[b], serial.beta)
    assert torch.equal(res.gap[b], serial.gap)
    assert int(res.n_outer[b]) == serial.n_outer
    assert int(res.n_active[b]) == serial.n_active
    assert bool(res.overflowed[b]) == serial.overflowed
    for f in ("trace_gap", "trace_dual") + INT_TRACES:
        assert torch.equal(getattr(res, f)[b], getattr(serial, f)), f
    if res.active_idx.shape[1] == serial.active_idx.shape[0]:
        assert torch.equal(res.active_idx[b], serial.active_idx)
        assert torch.equal(res.active_mask[b], serial.active_mask)


def _check_serial(X, Y, lams, cfg):
    ops.reset_launch_counts()
    res = rt.fleet_solve(X, Y, lams, cfg, device="cpu")
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}
    for i in range(Y.shape[0]):
        _assert_bitwise(res, rt.saif(X, Y[i], lams[i], cfg, device="cpu"), i)
    return res


@pytest.mark.parametrize("screen,inner", [
    ("torch", "torch"), ("torch", "gram"), ("cuda", "cuda")])
def test_fleet_equals_serial_solves_bitwise(screen, inner):
    """Fleet == B serial port solves; ``cuda`` on CPU tensors runs the
    plain twins of K1b/K2b/K3b against the serial twins of K1/K2/K3.
    The problems' h differ, so the fleet's capacity is larger than some
    serial ones."""
    X, Y, lams = _fleet(np.random.default_rng(0), 40, 150, 4)
    res = _check_serial(X, Y, lams, rt.SaifConfig(
        eps=1e-7, screen_backend=screen, inner_backend=inner))
    assert bool((res.gap <= 1e-7).all())


def test_fleet_logistic_mixed_convergence():
    X, Y, lams = _fleet(np.random.default_rng(3), 40, 100, 3, frac_lo=0.1,
                        frac_hi=0.5, loss_name="logistic")
    _check_serial(X, Y, lams, rt.SaifConfig(
        eps=1e-7, loss="logistic", inner_backend="torch"))


def test_fleet_hybrid_rule_with_newton_polish():
    """The hybrid rule with the Gram engine: per-problem Newton polish and
    post-check, each capped at the problem's own h."""
    X, Y, lams = _fleet(np.random.default_rng(6), 40, 150, 3, frac_lo=0.03,
                        frac_hi=0.3)
    res = _check_serial(X, Y, lams, rt.SaifConfig(
        eps=1e-7, inner_backend="gram", screen_rule="hybrid"))
    assert bool((res.trace_post_viol >= 0).any())


def test_fleet_early_finish_is_isolated():
    """A straggler does not perturb a problem that finished early."""
    rng = np.random.default_rng(2)
    n, p = 40, 120
    X = rng.uniform(-10, 10, (n, p))
    w = np.zeros(p)
    w[rng.choice(p, 10, replace=False)] = rng.normal(size=10)
    y = X @ w + 0.5 * rng.normal(size=n)
    lmax = float(j_lambda_max(j_get_loss("least_squares"), X, y))
    lams = [0.8 * lmax, 0.02 * lmax]
    res = _check_serial(X, np.stack([y, y]), lams,
                        rt.SaifConfig(eps=1e-9, inner_backend="gram"))
    assert int(res.n_outer[1]) > int(res.n_outer[0])


def test_gram_fleet_sweeps_in_one_batched_call_per_outer_step(monkeypatch):
    """The Gram fleet runs the card's path on the CPU too: one K6b call
    (its plain version here) per outer step for the live problems only,
    rows still bitwise the serial solves."""
    from repro_torch.kernels.gram import gram as kgram
    calls = []
    real = kgram.gram_sweep_batch

    def counted(G, *a, **k):
        calls.append(G.shape[0])
        return real(G, *a, **k)

    monkeypatch.setattr(kgram, "gram_sweep_batch", counted)
    rng = np.random.default_rng(2)
    n, p = 40, 120
    X = rng.uniform(-10, 10, (n, p))
    w = np.zeros(p)
    w[rng.choice(p, 10, replace=False)] = rng.normal(size=10)
    y = X @ w + 0.5 * rng.normal(size=n)
    lmax = float(j_lambda_max(j_get_loss("least_squares"), X, y))
    res = rt.fleet_solve(X, np.stack([y, y]), [0.8 * lmax, 0.02 * lmax],
                         rt.SaifConfig(eps=1e-9, inner_backend="gram"),
                         device="cpu")
    assert len(calls) == int(res.n_outer.max())
    assert sum(calls) == int(res.n_outer.sum())
    assert calls[-1] == 1                       # the straggler alone
    monkeypatch.undo()
    for i, lam in enumerate([0.8 * lmax, 0.02 * lmax]):
        _assert_bitwise(res, rt.saif(X, y, lam, rt.SaifConfig(
            eps=1e-9, inner_backend="gram"), device="cpu"), i)


def test_fleet_overflow_isolated_to_one_problem():
    """At k_max = 8 the small-lambda problem overflows: the fleet regrows
    cold, and every row still equals its serial solve (which regrows on
    its own)."""
    rng = np.random.default_rng(4)
    n, p = 40, 150
    X = rng.uniform(-10, 10, (n, p))
    w = np.zeros(p)
    w[rng.choice(p, 20, replace=False)] = rng.normal(size=20)
    y = X @ w + 0.5 * rng.normal(size=n)
    lmax = float(j_lambda_max(j_get_loss("least_squares"), X, y))
    lams = [0.6 * lmax, 0.03 * lmax]
    cfg = rt.SaifConfig(eps=1e-7, k_max=8, inner_backend="gram")
    res = _check_serial(X, np.stack([y, y]), lams, cfg)
    assert res.active_idx.shape[1] > 8           # the fleet regrew
    assert not bool(res.overflowed.any())


def _support(beta, tol=1e-8):
    return set(np.where(np.abs(np.asarray(beta)) > tol)[0].tolist())


@pytest.mark.parametrize("j_inner,t_inner", [("jnp", "torch"),
                                             ("gram", "gram")])
def test_fleet_matches_reference_fleet(j_inner, t_inner):
    X, Y, lams = _fleet(np.random.default_rng(0), 40, 150, 4)
    ref = j_batch.fleet_solve(X, Y, np.asarray(lams),
                              JConfig(eps=1e-7, inner_backend=j_inner))
    res = rt.fleet_solve(X, Y, lams, rt.SaifConfig(
        eps=1e-7, inner_backend=t_inner), device="cpu")
    loss = rt.get_loss("least_squares")
    for i, lam in enumerate(lams):
        b_ref, b = np.asarray(ref.beta[i]), res.beta[i].numpy()
        assert _support(b) == _support(b_ref)
        assert int(res.n_active[i]) == int(ref.n_active[i])
        for f in INT_TRACES:
            np.testing.assert_array_equal(getattr(res, f)[i].numpy(),
                                          np.asarray(getattr(ref, f)[i]))
        np.testing.assert_allclose(b, b_ref, rtol=1e-6, atol=1e-8)
        assert float(res.gap[i]) <= 1e-7
        kkt = rt.kkt_residual(loss, torch.from_numpy(X),
                              torch.from_numpy(Y[i]), res.beta[i], lam)
        assert float(kkt) <= 1e-3 * lam


def test_prepare_fleet_matches_reference():
    """The reference's FleetPrep carried over as numpy equals the port's
    own, and a fleet solved from it is the port's fleet."""
    X, Y, lams = _fleet(np.random.default_rng(1), 35, 100, 3)
    cfg = rt.SaifConfig(eps=1e-7, inner_backend="gram")
    j_prep = j_batch.prepare_fleet(X, Y, JConfig())
    carried = fleet_prep_from_numpy(
        np.asarray(j_prep.X), np.asarray(j_prep.Y), np.asarray(j_prep.c0),
        np.asarray(j_prep.col_norm), j_prep.c0_max, j_prep.c0_median,
        device="cpu")
    own = rt.prepare_fleet(X, Y, cfg, device="cpu")
    assert own.c0.shape == carried.c0.shape == (3, 100)
    torch.testing.assert_close(own.c0, carried.c0, rtol=1e-12, atol=1e-9)
    torch.testing.assert_close(own.col_norm, carried.col_norm, rtol=1e-12,
                               atol=0)
    np.testing.assert_allclose(own.c0_max, carried.c0_max, rtol=1e-12)
    np.testing.assert_allclose(own.c0_median, carried.c0_median, rtol=1e-12)
    a = rt.fleet_solve(None, None, lams, cfg, device="cpu", prep=carried)
    b = rt.fleet_solve(X, Y, lams, cfg, device="cpu", prep=own)
    for i in range(3):
        assert _support(a.beta[i]) == _support(b.beta[i])
        torch.testing.assert_close(a.beta[i], b.beta[i], rtol=1e-9,
                                   atol=1e-10)


def test_batch_policies():
    from repro_torch.core.screen_backend import resolve_batch_screen
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    cfg = rt.SaifConfig()
    assert rt.resolve_batch_inner(cfg, 100, 256, 16, cpu) == "gram"
    # least squares under the crossover: K6b on the card, as the reference
    assert rt.resolve_batch_inner(cfg, 100, 256, 16, cuda) == "gram"
    assert rt.resolve_batch_inner(cfg, 60, 256, 16, cuda) == "cuda"
    logit = rt.SaifConfig(loss="logistic")
    assert rt.resolve_batch_inner(logit, 100, 256, 16, cpu) == "torch"
    assert rt.resolve_batch_inner(logit, 100, 256, 16, cuda) == "cuda"
    # no fleet factor: the gate is one problem's, whatever B
    assert rt.resolve_batch_inner(logit, 1000, 1024, 10**4, cuda) == "cuda"
    with pytest.raises(ValueError, match="shared-memory"):
        rt.resolve_batch_inner(rt.SaifConfig(inner_backend="cuda"), 10**4,
                               4096, 2, cuda)
    with pytest.raises(ValueError, match="least_squares"):
        rt.resolve_batch_inner(rt.SaifConfig(loss="logistic",
                                             inner_backend="gram"),
                               100, 256, 2, cpu)
    with pytest.raises(ValueError, match="unknown"):
        rt.resolve_batch_inner(rt.SaifConfig(inner_backend="jnp"), 10, 8, 2,
                               cpu)
    assert resolve_batch_screen("auto", cpu) == "torch"
    assert resolve_batch_screen("auto", cuda) == "cuda"
    assert resolve_batch_screen("matmul", cpu, b=4, p=150) == "torch"
    assert resolve_batch_screen("matmul", cpu, b=16, p=4096) == "matmul"
    assert resolve_batch_screen("matmul", cuda, b=2, p=10) == "matmul"
    with pytest.raises(ValueError):
        resolve_batch_screen("pallas", cpu)


def test_matmul_screen_fleet_finds_the_serial_supports():
    """The opt-in one-product screen is ulp-grade, not bitwise: the same
    supports and gaps within eps."""
    X, Y, lams = _fleet(np.random.default_rng(0), 40, 150, 4)
    cfg = rt.SaifConfig(eps=1e-7, inner_backend="gram")
    res = rt.fleet_solve(X, Y, lams, cfg, device="cpu")
    mm = rt.fleet_solve(X, Y, lams, rt.SaifConfig(
        eps=1e-7, inner_backend="gram", screen_backend="matmul", k_max=None),
        device="cpu")
    for i in range(4):
        assert _support(mm.beta[i]) == _support(res.beta[i])
        assert float(mm.gap[i]) <= 1e-7


def test_unported_fleet_options_raise():
    X, Y, lams = _fleet(np.random.default_rng(0), 20, 30, 2)
    with pytest.raises(ValueError, match="parity"):
        rt.SaifConfig(parity="exact")
    # fast parity is ported: the lockstep fleet finds the bitwise supports
    fast = rt.fleet_solve(X, Y, lams, rt.SaifConfig(parity="fast"),
                          device="cpu")
    bit = rt.fleet_solve(X, Y, lams, rt.SaifConfig(), device="cpu")
    for i in range(2):
        assert _support(fast.beta[i]) == _support(bit.beta[i])
        assert float(fast.gap[i]) <= 1e-6
    # sample weights are ported; the kernel burst refuses them, as the
    # reference's pallas fleet does
    with pytest.raises(ValueError, match="sample weights"):
        rt.fleet_solve(X, Y, lams, rt.SaifConfig(inner_backend="cuda"),
                       device="cpu", weights=np.ones_like(Y))
    with pytest.raises(NotImplementedError):
        rt.fleet_solve(X, Y, lams, rt.SaifConfig(unpen_idx=0), device="cpu")
    # bucket padding is ported (tests/test_torch_bucket.py); a bucket that
    # would crop the design is refused
    prep = rt.prepare_fleet(X, Y, device="cpu")
    from repro_torch.core.batch import pad_fleet_prep
    with pytest.raises(ValueError, match="must dominate"):
        pad_fleet_prep(prep, 16, 64)
    with pytest.raises(ValueError, match="must dominate"):
        pad_fleet_prep(prep, 32, 16)


def test_fleet_refuses_to_fall_back(monkeypatch):
    X, Y, lams = _fleet(np.random.default_rng(0), 20, 30, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.fleet_solve(X, Y, lams)
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.saif_batch(X, Y, lams)
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.prepare_fleet(X, Y)
