"""Weighted fleets and K-fold cross-validation on the CPU, float64: the
port's ``fleet_solve(weights=)`` and ``cv_solve`` against the reference's
on the same inputs, with the reference's fold masks.

Contracts: against the reference (its ``jnp`` and ``gram`` weighted
fleets, which pass its own tests) the same support at 1e-8, the same
``n_active`` and integer traces, beta allclose (rtol 1e-6, atol 1e-8),
gap <= eps and the weighted KKT residual <= 1e-3 lambda; ``cv_mean`` and
``cv_se`` at rtol 1e-9 and the same ``best_lam``. Inside the port, bitwise:
row b of a weighted fleet equals the weighted fleet of one of problem b.
Against row subsampling: a fold's solve has the support of the serial
solve on its weight-1 rows and beta within 1e-9. Sizes are the
reference's (``test_batch_parity.py``: n <= 60, p <= 140, K <= 4,
L <= 5).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.core import SaifConfig as JConfig
from repro.core import batch as j_batch
from repro.core import kfold_weights as j_kfold_weights
from repro.core.cv import cv_solve as j_cv_solve
from repro.core.cv import one_se_lambda as j_one_se_lambda
from repro.core.duality import kkt_residual as j_kkt_residual
from repro.core.duality import lambda_max as j_lambda_max
from repro.core.losses import get_loss as j_get_loss
from repro_torch.convert import fleet_prep_from_numpy
from repro_torch.kernels import ops
from test_torch_batch import INT_TRACES, _support
from test_torch_saif import _one_torch_thread  # noqa: F401


def _t(a):
    return torch.from_numpy(np.array(a))


def _problem(seed, n, p, k_true, loss_name="least_squares"):
    """The reference's CV test problem (``test_batch_parity.py``)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-10, 10, (n, p))
    w = np.zeros(p)
    w[rng.choice(p, k_true, replace=False)] = rng.normal(size=k_true)
    if loss_name == "logistic":
        y = np.sign(X @ w + 0.3 * rng.normal(size=n))
        y[y == 0] = 1.0
    else:
        y = X @ w + 0.5 * rng.normal(size=n)
    lm = float(j_lambda_max(j_get_loss(loss_name), jnp.asarray(X),
                            jnp.asarray(y)))
    return X, y, lm


def _weighted_kkt(loss_name, X, y, w, beta, lam):
    return float(rt.kkt_residual(rt.get_loss(loss_name), _t(X), _t(y), beta,
                                 lam, sample_w=_t(w)))


@pytest.mark.parametrize("loss_name,j_inner,t_inner", [
    ("least_squares", "jnp", "torch"), ("least_squares", "gram", "gram"),
    ("logistic", "jnp", "torch")])
def test_weighted_fleet_matches_reference_fleet(loss_name, j_inner, t_inner):
    n, p, K = 48, 120, 3
    X, y, lm = _problem(6, n, p, 10, loss_name)
    W = np.asarray(j_kfold_weights(n, K, seed=0))
    Y = np.broadcast_to(y, (K, n)).copy()
    lams = [f * lm for f in (0.5, 0.3, 0.15)]
    eps = 1e-8
    ref = j_batch.fleet_solve(X, Y, np.asarray(lams), JConfig(
        eps=eps, loss=loss_name, inner_backend=j_inner),
        weights=jnp.asarray(W))
    ops.reset_launch_counts()
    res = rt.fleet_solve(X, Y, lams, rt.SaifConfig(
        eps=eps, loss=loss_name, inner_backend=t_inner), device="cpu",
        weights=W)
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}
    for i, lam in enumerate(lams):
        b, b_ref = res.beta[i].numpy(), np.asarray(ref.beta[i])
        assert _support(b) == _support(b_ref)
        assert int(res.n_active[i]) == int(ref.n_active[i])
        for f in INT_TRACES:
            np.testing.assert_array_equal(getattr(res, f)[i].numpy(),
                                          np.asarray(getattr(ref, f)[i]))
        np.testing.assert_allclose(b, b_ref, rtol=1e-6, atol=1e-8)
        assert float(res.gap[i]) <= eps
        assert _weighted_kkt(loss_name, X, y, W[i], res.beta[i],
                             lam) <= 1e-3 * lam


@pytest.mark.parametrize("inner", ["torch", "gram"])
def test_weighted_fleet_equals_subsampled_serial(inner):
    """The sample-weight trick (the port's copy of the reference's test): a
    binary-weighted fleet problem equals the serial solve on its weight-1
    rows: the support exactly, beta within 1e-9."""
    n, p, K = 48, 120, 3
    X, y, lm = _problem(6, n, p, 10)
    W = rt.kfold_weights(n, K, seed=0).numpy()
    lam = 0.15 * lm
    cfg = rt.SaifConfig(eps=1e-8, inner_backend=inner, use_seq_ball=False)
    res = rt.fleet_solve(X, np.broadcast_to(y, (K, n)).copy(), lam, cfg,
                         device="cpu", weights=W)
    for k in range(K):
        tr = W[k] > 0
        ref = rt.saif(X[tr], y[tr], lam, cfg, device="cpu")
        assert _support(res.beta[k]) == _support(ref.beta)
        np.testing.assert_allclose(res.beta[k].numpy(), ref.beta.numpy(),
                                   rtol=0, atol=1e-9)
        assert float(res.gap[k]) <= 1e-8


def _assert_rows_bitwise(a, i, b, j):
    assert torch.equal(a.beta[i], b.beta[j])
    assert torch.equal(a.gap[i], b.gap[j])
    assert int(a.n_outer[i]) == int(b.n_outer[j])
    assert int(a.n_active[i]) == int(b.n_active[j])
    for f in ("trace_gap", "trace_dual") + INT_TRACES:
        assert torch.equal(getattr(a, f)[i], getattr(b, f)[j]), f


@pytest.mark.parametrize("loss_name,inner,rule", [
    ("least_squares", "torch", "saif"), ("least_squares", "gram", "saif"),
    ("least_squares", "gram", "hybrid"), ("logistic", "torch", "saif")])
def test_weighted_fleet_equals_fleets_of_one_bitwise(loss_name, inner, rule):
    """Row b of a weighted fleet is the weighted fleet of one of problem b
    bit for bit (per-problem norms, c0, carries and certificates), with
    per-problem lambdas and responses; the plain (``cuda``-named twin)
    screen as well as the default one."""
    n, p, B = 40, 100, 3
    X, y, lm = _problem(11, n, p, 8, loss_name)
    rng = np.random.default_rng(5)
    W = (rng.random((B, n)) < 0.7).astype(float)
    Y = np.stack([y, y, np.roll(y, 3)])
    lams = [f * lm for f in (0.6, 0.25, 0.12)]
    for screen in ("torch", "cuda"):
        cfg = rt.SaifConfig(eps=1e-8, loss=loss_name, inner_backend=inner,
                            screen_rule=rule, screen_backend=screen)
        res = rt.fleet_solve(X, Y, lams, cfg, device="cpu", weights=W)
        for b in range(B):
            one = rt.fleet_solve(X, Y[b:b + 1], lams[b], cfg, device="cpu",
                                 weights=W[b:b + 1])
            _assert_rows_bitwise(res, b, one, 0)
            assert float(res.gap[b]) <= 1e-8


def test_unweighted_fleet_is_still_the_serial_solve():
    """Weights add a path; the unweighted fleet stays bitwise the serial
    solve (the contract of test_torch_batch.py), and all-one weights give
    the unweighted supports."""
    n, p = 40, 100
    X, y, lm = _problem(12, n, p, 8)
    cfg = rt.SaifConfig(eps=1e-8, inner_backend="gram")
    res = rt.fleet_solve(X, np.stack([y, y]), [0.5 * lm, 0.2 * lm], cfg,
                         device="cpu")
    for b, f in enumerate((0.5, 0.2)):
        _assert_rows_bitwise(res, b, rt.fleet_solve(
            X, y[None], f * lm, cfg, device="cpu"), 0)
        s = rt.saif(X, y, f * lm, cfg, device="cpu")
        assert torch.equal(res.beta[b], s.beta)
    ones = rt.fleet_solve(X, np.stack([y, y]), [0.5 * lm, 0.2 * lm], cfg,
                          device="cpu", weights=np.ones((2, n)))
    for b in range(2):
        assert _support(ones.beta[b]) == _support(res.beta[b])
        np.testing.assert_allclose(ones.beta[b].numpy(), res.beta[b].numpy(),
                                   rtol=1e-6, atol=1e-9)


def test_weighted_prep_matches_reference():
    """The reference's weighted FleetPrep carried over as numpy (W and the
    (B, p) norms) equals the port's own, and solves the same fleet."""
    n, p, K = 48, 120, 3
    X, y, lm = _problem(6, n, p, 10)
    W = np.asarray(j_kfold_weights(n, K, seed=1))
    Y = np.broadcast_to(y, (K, n)).copy()
    j_prep = j_batch.prepare_fleet(X, Y, JConfig(), weights=jnp.asarray(W))
    carried = fleet_prep_from_numpy(
        np.asarray(j_prep.X), np.asarray(j_prep.Y), np.asarray(j_prep.c0),
        np.asarray(j_prep.col_norm), j_prep.c0_max, j_prep.c0_median,
        W=np.asarray(j_prep.W), device="cpu")
    own = rt.prepare_fleet(X, Y, weights=W, device="cpu")
    assert own.col_norm.shape == carried.col_norm.shape == (K, p)
    torch.testing.assert_close(own.col_norm, carried.col_norm, rtol=1e-12,
                               atol=0)
    torch.testing.assert_close(own.c0, carried.c0, rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(own.c0_max, carried.c0_max, rtol=1e-12)
    assert torch.equal(own.W, carried.W)
    cfg = rt.SaifConfig(eps=1e-8, inner_backend="gram")
    a = rt.fleet_solve(None, None, 0.2 * lm, cfg, device="cpu", prep=carried)
    b = rt.fleet_solve(None, None, 0.2 * lm, cfg, device="cpu", prep=own)
    for i in range(K):
        assert _support(a.beta[i]) == _support(b.beta[i])
        torch.testing.assert_close(a.beta[i], b.beta[i], rtol=1e-9,
                                   atol=1e-10)
    with pytest.raises(ValueError, match="weights"):
        fleet_prep_from_numpy(X, Y, np.asarray(j_prep.c0),
                              np.asarray(j_prep.col_norm), j_prep.c0_max,
                              j_prep.c0_median, device="cpu")


@pytest.fixture(scope="module")
def cv_case():
    """One reference CV run (its test problem), shared by the module."""
    X, y, lm = _problem(7, 60, 140, 8)
    lams = np.geomspace(0.8 * lm, 0.05 * lm, 5)
    ref = j_cv_solve(X, y, lams, n_folds=4, config=JConfig(
        eps=1e-8, inner_backend="gram"), keep_fold_betas=True)
    return X, y, lams, ref


def test_cv_solve_matches_reference(cv_case):
    from repro_torch.core.inner_backend import make_inner_gram
    X, y, lams, ref = cv_case
    make_inner_gram.rebuilds = 0
    ops.reset_launch_counts()
    res = rt.cv_solve(X, y, lams, n_folds=4, config=rt.SaifConfig(
        eps=1e-8, inner_backend="gram"), keep_fold_betas=True, device="cpu")
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}
    # one full Gram build per fold at the cold start; every warm handoff
    # keeps its carry (the refit is the serial solve's own build)
    assert make_inner_gram.rebuilds == 4 + 1
    np.testing.assert_array_equal(res.lams, np.asarray(ref.lams))
    np.testing.assert_allclose(res.cv_mean, ref.cv_mean, rtol=1e-9)
    np.testing.assert_allclose(res.cv_se, ref.cv_se, rtol=1e-9)
    assert res.best_lam == float(ref.best_lam)
    assert res.n_compilations is None
    W = rt.kfold_weights(60, 4).numpy()
    for li, lam in enumerate(res.lams):
        fr = res.fold_results[li]
        assert torch.equal(fr.beta, res.fold_betas[li])
        for k in range(4):
            b, b_ref = res.fold_betas[li][k], np.asarray(ref.fold_betas[li][k])
            assert _support(b) == _support(b_ref)
            np.testing.assert_allclose(b.numpy(), b_ref, rtol=1e-6,
                                       atol=1e-8)
            assert float(fr.gap[k]) <= 1e-8
            assert _weighted_kkt("least_squares", X, y, W[k], b,
                                 lam) <= 1e-3 * lam
    assert _support(res.beta) == _support(np.asarray(ref.beta))
    np.testing.assert_allclose(res.beta.numpy(), np.asarray(ref.beta),
                               rtol=1e-6, atol=1e-8)
    assert float(res.best_result.gap) <= 1e-8


def test_cv_fold_matches_subsampled_serial(cv_case):
    """The reference's spot check of one (fold, lambda) cell against the
    row-subsampled serial solve, on the port's CV."""
    X, y, lams, _ = cv_case
    res = rt.cv_solve(X, y, lams, n_folds=4, config=rt.SaifConfig(
        eps=1e-8, inner_backend="torch"), keep_fold_betas=True, refit=False,
        device="cpu")
    assert res.beta is None and res.best_result is None
    W = rt.kfold_weights(60, 4).numpy()
    tr = W[1] > 0
    ref = rt.saif(X[tr], y[tr], float(res.lams[2]), rt.SaifConfig(
        eps=1e-8, inner_backend="gram", use_seq_ball=False), device="cpu")
    fb = res.fold_betas[2][1]
    assert _support(fb) == _support(ref.beta)
    np.testing.assert_allclose(fb.numpy(), ref.beta.numpy(), rtol=0,
                               atol=1e-9)


@pytest.mark.parametrize("n,K,seed", [(60, 4, 0), (48, 3, 1), (7, 7, 5),
                                      (100, 5, 42)])
def test_kfold_weights_bitwise_reference(n, K, seed):
    W = rt.kfold_weights(n, K, seed=seed)
    assert W.dtype == torch.float64 and W.shape == (K, n)
    np.testing.assert_array_equal(W.numpy(), np.asarray(
        j_kfold_weights(n, K, seed=seed)))
    assert (W.sum(0) == K - 1).all()
    with pytest.raises(ValueError):
        rt.kfold_weights(n, 1)


def test_one_se_lambda_matches_reference():
    rng = np.random.default_rng(0)
    for _ in range(20):
        lams = np.sort(rng.uniform(0.1, 5.0, 7))[::-1]
        mean, se = rng.uniform(1, 2, 7), rng.uniform(0, 0.3, 7)
        assert rt.one_se_lambda(lams, mean, se) == j_one_se_lambda(
            lams, mean, se)
    lams = np.array([4.0, 2.0, 1.0, 0.5])
    # min at 0.5 (1.0 +- 0.2): 1.0 (1.15) is within, 2.0 (1.3) is not
    assert rt.one_se_lambda(lams, [2.0, 1.3, 1.15, 1.0],
                            [0.1, 0.1, 0.1, 0.2]) == 1.0


def test_kkt_residual_sample_weights():
    X, y, lm = _problem(3, 30, 50, 5)
    w = (np.random.default_rng(1).random(30) < 0.6).astype(float)
    beta = np.where(np.arange(50) < 5, 0.01, 0.0)
    for loss_name in ("least_squares", "logistic"):
        yy = y if loss_name == "least_squares" else np.sign(y)
        got = rt.kkt_residual(rt.get_loss(loss_name), _t(X), _t(yy),
                              _t(beta), 0.3 * lm, sample_w=_t(w))
        want = j_kkt_residual(j_get_loss(loss_name), jnp.asarray(X),
                              jnp.asarray(yy), jnp.asarray(beta), 0.3 * lm,
                              sample_w=jnp.asarray(w))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-12)
        unweighted = rt.kkt_residual(rt.get_loss(loss_name), _t(X), _t(yy),
                                     _t(beta), 0.3 * lm)
        assert float(got) != float(unweighted)


def test_resolve_batch_inner_under_weights():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    ls, logit = rt.SaifConfig(), rt.SaifConfig(loss="logistic")
    # CPU: the reference's auto, weighted or not
    assert rt.resolve_batch_inner(ls, 100, 256, 5, cpu, weighted=True) \
        == "gram"
    assert rt.resolve_batch_inner(ls, 10, 256, 5, cpu, weighted=True) \
        == "torch"
    assert rt.resolve_batch_inner(logit, 100, 256, 5, cpu, weighted=True) \
        == "torch"
    # the card: weighted LS takes the Gram engine (K6b) under the crossover
    assert rt.resolve_batch_inner(ls, 1000, 512, 5, cuda, weighted=True) \
        == "gram"
    # unweighted least squares under the crossover: K6b too (the reference)
    assert rt.resolve_batch_inner(ls, 1000, 512, 5, cuda) == "gram"
    assert rt.resolve_batch_inner(ls, 100, 512, 5, cuda) == "cuda"
    with pytest.raises(ValueError, match='inner_backend="torch"'):
        rt.resolve_batch_inner(ls, 100, 1024, 5, cuda, weighted=True)
    # weighted logistic: the kernel burst refuses weights, auto raises
    with pytest.raises(ValueError, match='inner_backend="torch"'):
        rt.resolve_batch_inner(logit, 1000, 512, 5, cuda, weighted=True)
    assert rt.resolve_batch_inner(rt.SaifConfig(
        loss="logistic", inner_backend="torch"), 1000, 512, 5, cuda,
        weighted=True) == "torch"
    for dev in (cpu, cuda):
        with pytest.raises(ValueError, match="sample weights"):
            rt.resolve_batch_inner(rt.SaifConfig(inner_backend="cuda"), 100,
                                   256, 5, dev, weighted=True)
    from repro_torch.core.inner_backend import make_batch_inner_cuda
    with pytest.raises(ValueError, match="sample weights"):
        make_batch_inner_cuda(rt.get_loss("logistic"), torch.zeros(4, 6),
                              torch.ones(6), weights=[torch.ones(4)])


def test_weighted_fleet_on_faked_card_raises_for_logistic(monkeypatch):
    """On a (faked) card a weighted logistic fleet under ``auto`` raises
    before it solves anything, naming the plain backend."""
    X, y, lm = _problem(4, 30, 60, 5, "logistic")
    W = rt.kfold_weights(30, 2).numpy()
    import repro_torch.core.batch as batch_mod
    monkeypatch.setattr(batch_mod, "resolve_device",
                        lambda device=None: torch.device("cpu"))
    real = batch_mod.resolve_batch_inner

    def on_card(config, n, k_max, b, device, itemsize=8, weighted=False):
        return real(config, n, k_max, b, torch.device("cuda"), itemsize,
                    weighted)
    monkeypatch.setattr(batch_mod, "resolve_batch_inner", on_card)
    with pytest.raises(ValueError, match='inner_backend="torch"'):
        rt.fleet_solve(X, np.stack([y, y]), 0.3 * lm,
                       rt.SaifConfig(loss="logistic"), weights=W)


def test_unported_and_refused_options():
    X, y, lm = _problem(4, 30, 60, 5)
    W = rt.kfold_weights(30, 2).numpy()
    Y = np.stack([y, y])
    # fast parity is ported: the weighted lockstep fleet finds the bitwise
    # engine's supports, from the fast preparation
    fast_cfg = rt.SaifConfig(parity="fast")
    fast = rt.fleet_solve(X, Y, lm / 2, fast_cfg, device="cpu", weights=W)
    bit = rt.fleet_solve(X, Y, lm / 2, rt.SaifConfig(), device="cpu",
                         weights=W)
    for i in range(2):
        assert _support(fast.beta[i]) == _support(bit.beta[i])
        assert float(fast.gap[i]) <= 1e-6
    prep = rt.prepare_fleet(X, Y, fast_cfg, weights=W, device="cpu")
    slow = rt.prepare_fleet(X, Y, rt.SaifConfig(), weights=W, device="cpu")
    torch.testing.assert_close(prep.c0, slow.c0, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(prep.col_norm, slow.col_norm, rtol=1e-12,
                               atol=0)
    with pytest.raises(NotImplementedError):
        rt.cv_solve(X, y, [lm / 2], config=rt.SaifConfig(unpen_idx=0),
                    device="cpu")
    with pytest.raises(ValueError, match="non-empty"):
        rt.cv_solve(X, y, [], device="cpu")
    with pytest.raises(ValueError, match=r"\(B, n\)"):
        rt.fleet_solve(X, Y, lm / 2, device="cpu", weights=W[:, :10])
    from repro_torch.core.inner_backend import (make_inner_gram,
                                                make_inner_torch)
    loss = rt.get_loss("least_squares")
    for make in (lambda: make_inner_torch(loss, _t(X), _t(y), 0, _t(W[0])),
                 lambda: make_inner_gram(loss, _t(X), _t(y), 4, 0, _t(W[0]))):
        with pytest.raises(ValueError, match="unpenalized"):
            make()


def test_cv_and_weighted_entry_points_refuse_to_fall_back(monkeypatch):
    X, y, lm = _problem(4, 30, 60, 5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.cv_solve(X, y, [lm / 2])
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.fleet_solve(X, np.stack([y, y]), lm / 2,
                       weights=np.ones((2, 30)))
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.select_solve(X, y, rt.Select(lams=(lm / 2,)))
