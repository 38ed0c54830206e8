"""repro_torch losses and dual machinery against repro, float64, same numpy
inputs. The formulas are the same term for term, so only the order of
reductions differs: rtol 1e-12."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import duality as jd
from repro.core import losses as jl
from repro_torch.core import duality as td
from repro_torch.core import losses as tl

RTOL = 1e-12
LOSSES = ["least_squares", "logistic"]


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float64))


def _close(a, b, rtol=RTOL, atol=0.0):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol)


def _data(seed, loss_name, n=40, k=12):
    r = np.random.default_rng(seed)
    X = r.normal(size=(n, k))
    if loss_name == "logistic":
        y = np.where(r.random(n) < 0.5, -1.0, 1.0)
    else:
        y = r.normal(size=n)
    return X, y, r


@pytest.mark.parametrize("loss_name", LOSSES)
def test_loss_pieces_match(loss_name):
    X, y, r = _data(0, loss_name)
    z = r.normal(size=y.shape) * 3
    # u inside dom f* for the logistic conjugate (s = -u y in (0, 1)),
    # plus points outside it, where the reference's where-guards decide
    s = np.concatenate([r.uniform(0.01, 0.99, y.size - 4),
                        [0.0, 1.0, -0.3, 1.4]])
    u = -s * y
    jlo, tlo = jl.get_loss(loss_name), tl.get_loss(loss_name)
    assert jlo.smoothness == tlo.smoothness
    for fn in ("value", "grad", "hess"):
        _close(getattr(tlo, fn)(_t(z), _t(y)), getattr(jlo, fn)(z, y))
    _close(tlo.conj(_t(u), _t(y)), jlo.conj(u, y), atol=1e-15)
    _close(tlo.dual_clip(_t(u), _t(y)), jlo.dual_clip(u, y))
    ref_grad = jax.grad(lambda uu: jnp.sum(jlo.conj(uu, y)))(jnp.asarray(u))
    _close(tlo.conj_grad(_t(u), _t(y)), ref_grad, atol=1e-15)
    beta = r.normal(size=X.shape[1])
    _close(tlo.primal_objective(_t(X), _t(y), _t(beta), 0.3),
           jlo.primal_objective(X, y, beta, 0.3))
    _close(tlo.dual_objective(_t(y), _t(z / 10), 0.3),
           jlo.dual_objective(y, z / 10, 0.3))


@pytest.mark.parametrize("loss_name", LOSSES)
@pytest.mark.parametrize("seed", [1, 2])
def test_duality_functions_match(loss_name, seed):
    X, y, r = _data(seed, loss_name)
    jlo, tlo = jl.get_loss(loss_name), tl.get_loss(loss_name)
    lam = 0.4 * float(jd.lambda_max(jlo, X, y))
    mask = r.random(X.shape[1]) < 0.7
    beta = np.where(mask, r.normal(size=X.shape[1]) * 0.1, 0.0)
    z = X @ beta
    hat = -np.asarray(jlo.grad(z, y)) / lam

    th_j = jd.feasible_dual(jlo, X, y, hat, lam, mask)
    th_t = td.feasible_dual(tlo, _t(X), _t(y), _t(hat), lam,
                            torch.from_numpy(mask))
    _close(th_t, th_j)
    _close(td.duality_gap(tlo, _t(X), _t(y), _t(beta), th_t, lam,
                          torch.from_numpy(mask)),
           jd.duality_gap(jlo, X, y, beta, th_j, lam, mask))
    gap = 1e-3
    floor_j = jd.gap_precision_floor(th_j, lam)
    floor_t = td.gap_precision_floor(th_t, lam)
    _close(floor_t, floor_j)
    for g in (gap, -1.0):                      # raw gap and a floored one
        bj = jd.gap_ball(jlo, th_j, jnp.asarray(g), lam, floor=floor_j)
        bt = td.gap_ball(tlo, th_t, torch.tensor(g, dtype=torch.float64),
                         lam, floor=floor_t)
        _close(bt.radius, bj.radius)
    _close(td.lambda_max(tlo, _t(X), _t(y)), jd.lambda_max(jlo, X, y))
    g0j, c0j, b0j = jd.null_gradient(jlo, X, y)
    g0t, c0t, b0t = td.null_gradient(tlo, _t(X), _t(y))
    _close(g0t, g0j)
    _close(c0t, c0j)
    assert b0t == float(b0j) == 0.0
    _close(td.kkt_residual(tlo, _t(X), _t(y), _t(beta), lam),
           jd.kkt_residual(jlo, X, y, beta, lam))
    # Theorem-2 sequential ball at the null dual point, then the Eq. 12
    # cover of its intersection with the gap ball
    lam0 = float(np.max(np.abs(X.T @ np.asarray(g0j)))) * 1.05
    theta0 = -np.asarray(g0j) / lam0
    sj = jd.sequential_ball(jlo, y, theta0, lam0, lam)
    st = td.sequential_ball(tlo, _t(y), _t(theta0),
                            torch.tensor(lam0, dtype=torch.float64), lam)
    _close(st.center, sj.center)
    _close(st.radius, sj.radius, atol=1e-14)
    gj = jd.gap_ball(jlo, th_j, jnp.asarray(gap), lam)
    gt = td.gap_ball(tlo, th_t, torch.tensor(gap, dtype=torch.float64), lam)
    ij, it = jd.intersect_balls(sj, gj), td.intersect_balls(st, gt)
    _close(it.center, ij.center)
    _close(it.radius, ij.radius)


@pytest.mark.parametrize("case", ["lens", "disjoint", "contained",
                                  "same_center"])
def test_intersect_balls_cases(case):
    r = np.random.default_rng(3)
    c1 = r.normal(size=5)
    d = r.normal(size=5)
    d /= np.linalg.norm(d)
    c2, r1, r2 = {"lens": (c1 + 1.0 * d, 0.8, 0.7),
                  "disjoint": (c1 + 3.0 * d, 0.8, 0.7),
                  "contained": (c1 + 0.1 * d, 2.0, 0.5),
                  "same_center": (c1, 1.0, 0.6)}[case]
    ij = jd.intersect_balls(jd.Ball(jnp.asarray(c1), jnp.asarray(r1)),
                            jd.Ball(jnp.asarray(c2), jnp.asarray(r2)))
    f64 = torch.float64
    it = td.intersect_balls(td.Ball(_t(c1), torch.tensor(r1, dtype=f64)),
                            td.Ball(_t(c2), torch.tensor(r2, dtype=f64)))
    _close(it.center, ij.center)
    _close(it.radius, ij.radius)
