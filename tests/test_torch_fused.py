"""repro_torch's fused LASSO against repro on the same float64 inputs.

* The chain transform: the port's plain K4 (``chain_suffix_sums`` on a CPU
  tensor), its level loop and its numpy ``transform_design`` against the
  reference's ``chain_suffix_sums_pallas`` (interpret mode) and numpy
  transform, bit for bit; general trees to rtol 1e-12 (several children
  of one parent are summed in another order); ``recover_beta_device`` bit
  for bit.
* K3-pen's plain twin, ``cm_burst_ref(pen=)``, against
  ``cm_burst_pallas(pen=..., interpret=True)``, least squares and
  logistic, rtol 1e-10 (the same arithmetic summed in another order).
* The unpenalized-slot pieces (``null_gradient``, ``polish_unpen``, the
  pen-aware KKT residual) to rtol 1e-10.
* Fused solves on a chain and a random tree, least squares and logistic,
  through each inner backend: the same support and ``n_active`` as the
  reference, gap <= eps, coefficients within atol 1e-6, the same
  ``fused_lambda_max``.
* The inner-backend routing of ``auto``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch as rt
from repro.core import duality as jd
from repro.core.losses import get_loss as j_get_loss
from repro.kernels.cm.cm import cm_burst_pallas
from repro.kernels.fused.fused import chain_suffix_sums_pallas
from repro_torch.convert import fused_design_from_ref
from repro_torch.core import duality as td
from repro_torch.core import fused as tf
from repro_torch.core.inner_backend import resolve_inner_backend
from repro_torch.core.losses import get_loss as t_get_loss
from repro_torch.kernels import ops
from test_torch_saif import _one_torch_thread  # noqa: F401

RTOL = 1e-10


def _t(a):
    return torch.from_numpy(np.array(a))


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a), np.float64)
    return a.view(np.uint64)


def _support(beta, tol=1e-8):
    return set(np.where(np.abs(np.asarray(beta)) > tol)[0].tolist())


def _chain_parent(p):
    return np.arange(p) - 1


def _random_tree_parent(rng, p):
    parent = np.full(p, -1, np.int64)
    for v in range(1, p):
        parent[v] = rng.integers(0, v)
    return parent


# --------------------------------------------------------------------------
# the transform and its inverse
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n,p", [(9, 12), (33, 300), (16, 257), (8, 128)])
def test_chain_transform_bitwise(seed, n, p):
    """Every port path of the chain transform equals the reference's
    Pallas kernel and numpy fold bit for bit."""
    X = np.random.default_rng(seed).normal(size=(n, p))
    S_ref = np.asarray(chain_suffix_sums_pallas(jnp.asarray(X),
                                                interpret=True))
    Xb_np, xb_np = J.transform_design(X, J.build_tree(_chain_parent(p)))
    assert np.array_equal(_bits(S_ref[:, 1:]), _bits(Xb_np))
    assert np.array_equal(_bits(S_ref[:, 0]), _bits(xb_np))

    S = ops.chain_suffix_sums(_t(X))               # plain K4 on the CPU
    assert np.array_equal(_bits(S.numpy()), _bits(S_ref))
    tree = tf.build_tree(_chain_parent(p))
    assert tf.build_schedule(tree).is_chain
    for backend in ("cuda", "torch", "auto"):
        Xb, xb = tf.transform_design_device(_t(X), tree, backend=backend)
        assert np.array_equal(_bits(Xb.numpy()), _bits(Xb_np))
        assert np.array_equal(_bits(xb.numpy()), _bits(xb_np))
    Xb, xb = tf.transform_design(X, tree)
    assert np.array_equal(_bits(Xb), _bits(Xb_np))
    design = rt.prepare_fused(X, _chain_parent(p), device="cpu")
    assert np.array_equal(_bits(design.Xt[:, :-1].numpy()), _bits(Xb_np))
    assert design.unpen_idx == p - 1


def _raw_bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint64 if a.dtype == np.float64 else np.uint32)


@pytest.mark.parametrize("dtype,n,p,signed_zeros", [
    (np.float32, 9, 1, False), (np.float32, 13, 777, False),
    (np.float32, 13, 1, True), (np.float32, 13, 777, True),
    (np.float64, 13, 777, True)])
def test_chain_transform_bitwise_edges(dtype, n, p, signed_zeros):
    """The plain K4 in the input's dtype (float32 too), at p = 1 and
    p = 777 (no whole tile of the reference's 128-column blocks), and with
    -0.0 / +0.0 in the last column: bit for bit the numpy fold
    (``transform_design``). The reference's Pallas kernel starts its carry
    at +0.0 and pads on the right with +0.0, so where the fold is -0.0 it
    reads +0.0; everywhere else it is bit for bit the same."""
    X = np.random.default_rng(p).normal(size=(n, p)).astype(dtype)
    if signed_zeros:
        X[::2, -1] = -0.0
        X[1::4, -1] = 0.0
        X[3, :] = -0.0                  # a row whose every suffix is -0.0
    Xb_np, xb_np = J.transform_design(X, J.build_tree(_chain_parent(p)))
    S_np = np.concatenate([xb_np[:, None], Xb_np], axis=1)
    assert S_np.dtype == dtype
    S = ops.chain_suffix_sums(_t(X))               # plain K4 on the CPU
    assert S.dtype == _t(X).dtype
    assert np.array_equal(_raw_bits(S.numpy()), _raw_bits(S_np))
    S_pl = np.asarray(chain_suffix_sums_pallas(jnp.asarray(X),
                                               interpret=True))
    assert S_pl.dtype == dtype
    neg0 = (S_np == 0) & np.signbit(S_np)
    assert neg0.any() == signed_zeros
    assert np.array_equal(_raw_bits(S_pl)[~neg0], _raw_bits(S_np)[~neg0])
    assert (S_pl[neg0] == 0).all() and not np.signbit(S_pl[neg0]).any()


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("p", [2, 17, 60])
def test_tree_transform_matches_reference(seed, p):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(14, p))
    parent = _random_tree_parent(rng, p)
    Xb_ref, xb_ref = J.transform_design_scan(X, J.build_tree(parent))
    tree = tf.build_tree(parent)
    Xb, xb = tf.transform_design_scan(_t(X), tree)
    np.testing.assert_allclose(Xb.numpy(), np.asarray(Xb_ref),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(xb.numpy(), np.asarray(xb_ref),
                               rtol=1e-12, atol=1e-12)
    Xb_np, xb_np = tf.transform_design(X, tree)
    np.testing.assert_allclose(Xb.numpy(), Xb_np, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(xb.numpy(), xb_np, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("seed", [0, 1])
def test_recover_beta_device_bitwise(seed):
    rng = np.random.default_rng(seed)
    for p in (2, 13, 41):
        for parent in (_chain_parent(p), _random_tree_parent(rng, p)):
            bt = rng.normal(size=p - 1)
            b = float(rng.normal())
            ref = np.asarray(J.recover_beta_device(jnp.asarray(bt), b,
                                                   J.build_tree(parent)))
            tree = tf.build_tree(parent)
            dev = tf.recover_beta_device(_t(bt), b, tree)
            assert np.array_equal(_bits(dev.numpy()), _bits(ref))
            assert np.array_equal(_bits(tf.recover_beta(bt, b, tree)),
                                  _bits(ref))


def test_schedule_and_transform_backends():
    rng = np.random.default_rng(0)
    tree = tf.build_tree(_random_tree_parent(rng, 20))
    assert not tf.build_schedule(tree).is_chain
    with pytest.raises(ValueError, match="chain"):
        tf.transform_design_device(torch.zeros(3, 20), tree, backend="cuda")
    with pytest.raises(ValueError, match="backend"):
        tf.transform_design_device(torch.zeros(3, 20), tree, backend="scan")
    with pytest.raises(ValueError):
        tf.build_tree(np.array([-1, -1, 0]))


def test_fused_design_from_ref():
    """The reference's FusedDesign carried across solves like the port's
    own."""
    rng = np.random.default_rng(4)
    X = rng.normal(size=(30, 25))
    y = rng.normal(size=30)
    parent = _random_tree_parent(rng, 25)
    d = fused_design_from_ref(J.prepare_fused(X, parent, backend="scan"),
                              device="cpu")
    mine = rt.prepare_fused(X, parent, device="cpu")
    np.testing.assert_allclose(d.Xt.numpy(), mine.Xt.numpy(), rtol=1e-12,
                               atol=1e-12)
    assert d.unpen_idx == mine.unpen_idx == 24
    for a, b in zip(d.schedule[:4], mine.schedule[:4]):
        assert np.array_equal(a, b)
    bt = rng.normal(size=25)
    assert np.array_equal(rt.recover_from_transformed(_t(bt), d).numpy(),
                          rt.recover_from_transformed(_t(bt), mine).numpy())


# --------------------------------------------------------------------------
# K3-pen's plain twin and the unpenalized-slot pieces
# --------------------------------------------------------------------------

def _pen_block(seed, n, k, count, loss_name, unpen_live=True):
    r = np.random.default_rng(seed)
    mask = np.zeros(k, bool)
    mask[r.choice(k, count, replace=False)] = True
    A = np.where(mask[None, :], r.normal(size=(n, k)), 0.0)
    live = np.where(mask)[0]
    u = live[1] if unpen_live else np.where(~mask)[0][0]
    pen = np.ones(k)
    pen[u] = 0.0
    if loss_name == "logistic":
        y = np.where(r.random(n) < 0.5, -1.0, 1.0)
    else:
        y = A @ np.where(mask, r.normal(size=k), 0.0) + r.normal(size=n)
    beta = np.where(mask & (r.random(k) < 0.5), r.normal(size=k) * 0.1, 0.0)
    beta[u] = 0.2 if unpen_live else 0.0
    order = np.concatenate([live, np.where(~mask)[0]])
    g0 = np.asarray(j_get_loss(loss_name).grad(jnp.zeros(n), y))
    lam = 0.3 * float(np.max(np.abs(A.T @ g0)))
    return A, y, beta, mask, order, pen, lam


@pytest.mark.parametrize("loss_name", ["least_squares", "logistic"])
@pytest.mark.parametrize("n,k,count,unpen_live", [(64, 16, 12, True),
                                                  (100, 32, 25, True),
                                                  (50, 12, 8, False)])
def test_cm_burst_pen_matches_pallas(loss_name, n, k, count, unpen_live):
    A, y, beta, mask, order, pen, lam = _pen_block(n + k, n, k, count,
                                                   loss_name, unpen_live)
    col_sq = np.sum(A * A, axis=0)
    n_ep = 3
    ref = cm_burst_pallas(
        jnp.asarray(A), jnp.asarray(y), jnp.asarray(beta),
        jnp.asarray(col_sq), jnp.asarray(mask), jnp.asarray(order), lam,
        n_ep, count, pen=jnp.asarray(pen), loss_name=loss_name,
        interpret=True)
    ops.reset_launch_counts()
    outs = [ops.cm_burst_ref(_t(A), _t(y), _t(beta), _t(col_sq), _t(mask),
                             _t(order), lam, n_ep, count, _t(pen),
                             loss_name=loss_name),
            ops.cm_burst(_t(A), _t(y), _t(beta), _t(col_sq), _t(mask),
                         _t(order), lam, n_ep, count, _t(pen),
                         loss_name=loss_name),
            ops.cm_burst_pen_xt(_t(A.T.copy()), _t(y), _t(beta),
                                _t(col_sq), _t(mask), _t(order), _t(pen),
                                lam, n_ep, count, loss_name=loss_name)]
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}
    for out in outs:
        for a, b in zip(out, ref):
            b = np.asarray(b)
            np.testing.assert_allclose(
                np.asarray(a), b, rtol=RTOL,
                atol=RTOL * max(np.abs(b).max(), 1.0))


@pytest.mark.parametrize("loss_name", ["least_squares", "logistic"])
def test_unpen_duality_pieces_match_reference(loss_name):
    rng = np.random.default_rng(5)
    n, p = 40, 30
    X = rng.normal(size=(n, p))
    y = (np.where(rng.normal(size=n) > 0, 1.0, -1.0)
         if loss_name == "logistic" else rng.normal(size=n))
    jl, tl = j_get_loss(loss_name), t_get_loss(loss_name)
    for a, b in zip(jd.null_gradient(jl, X, y, unpen_idx=7),
                    td.null_gradient(tl, _t(X), _t(y), unpen_idx=7)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=RTOL,
                                   atol=1e-13)
    z = 0.1 * X @ rng.normal(size=p)
    bj, zj = jd.polish_unpen(jl, X[:, 3], y, z, 0.3)
    bt, zt = td.polish_unpen(tl, _t(X[:, 3]), _t(y), _t(z),
                             torch.tensor(0.3, dtype=torch.float64))
    np.testing.assert_allclose(float(bt), float(bj), rtol=RTOL)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=RTOL,
                               atol=1e-13)
    beta = np.where(rng.random(p) < 0.3, rng.normal(size=p), 0.0)
    pen = np.ones(p)
    pen[3] = 0.0
    lam = 0.5
    np.testing.assert_allclose(
        float(td.kkt_residual(tl, _t(X), _t(y), _t(beta), lam, _t(pen))),
        float(jd.kkt_residual(jl, X, y, beta, lam, pen=pen)), rtol=RTOL)


# --------------------------------------------------------------------------
# fused solves
# --------------------------------------------------------------------------

def _ls_chain_problem():
    """test_fused_device.py's path problem (n = 50, p = 60)."""
    rng = np.random.default_rng(11)
    n, p = 50, 60
    X = rng.normal(size=(n, p))
    beta = np.zeros(p)
    beta[:10] = 2.0
    beta[10:20] = -1.0
    return X, X @ beta + 0.1 * rng.normal(size=n)


def _logit_problem():
    """test_fused_device.py's logistic problem (n = 50, p = 40)."""
    rng = np.random.default_rng(48)
    n, p = 50, 40
    X = rng.normal(size=(n, p))
    beta = np.zeros(p)
    beta[:8] = 2.0
    y = np.sign(X @ beta + 0.3 * rng.normal(size=n))
    y[y == 0] = 1.0
    return X, y


CASES = [("least_squares", "chain", inner, frac)
         for inner in ("torch", "gram", "cuda", "auto")
         for frac in (0.3, 0.1)]
CASES += [("least_squares", "tree", inner, 0.2)
          for inner in ("torch", "gram", "cuda")]
CASES += [("logistic", tree, inner, frac)
          for tree in ("chain", "tree") for inner in ("torch", "cuda")
          for frac in (0.3, 0.1)]


@pytest.mark.parametrize("loss,tree,inner,frac", CASES)
def test_saif_fused_matches_reference(loss, tree, inner, frac):
    X, y = _ls_chain_problem() if loss == "least_squares" \
        else _logit_problem()
    p = X.shape[1]
    parent = (_chain_parent(p) if tree == "chain"
              else _random_tree_parent(np.random.default_rng(9), p))
    lm_ref = J.fused_lambda_max(X, y, parent, loss=loss)
    lm = rt.fused_lambda_max(X, y, parent, loss=loss, device="cpu")
    np.testing.assert_allclose(lm, lm_ref, rtol=1e-12)
    lam = frac * lm_ref
    eps = 1e-8
    b_ref, r_ref = J.saif_fused(X, y, parent, lam,
                                J.SaifConfig(eps=eps, loss=loss))
    b, res = rt.saif_fused(X, y, parent, lam,
                           rt.SaifConfig(eps=eps, loss=loss,
                                         inner_backend=inner),
                           device="cpu")
    assert _support(res.beta) == _support(r_ref.beta)
    assert res.n_active == int(r_ref.n_active)
    assert float(res.gap) <= eps
    np.testing.assert_allclose(b.numpy(), np.asarray(b_ref), atol=1e-6)
    Xt = rt.prepare_fused(X, parent, device="cpu").Xt
    pen = torch.ones(p, dtype=torch.float64)
    pen[p - 1] = 0.0
    kkt = float(rt.kkt_residual(rt.get_loss(loss), Xt, _t(y), res.beta,
                                lam, pen))
    assert kkt <= 1e-3 * lam


def test_slot_matches_exact_elimination_ls():
    """The unpenalized slot == Theorem 7's exact LS elimination, in the
    port and against the reference's eliminated route."""
    rng = np.random.default_rng(7)
    n, p = 40, 30
    X = rng.normal(size=(n, p))
    beta_true = np.zeros(p)
    beta_true[:10] = 1.5
    y = X @ beta_true + 0.1 * rng.normal(size=n)
    parent = _random_tree_parent(rng, p)
    for lam in (2.0, 10.0):
        cfg = rt.SaifConfig(eps=1e-10)
        b_slot, res = rt.saif_fused(X, y, parent, lam, cfg, device="cpu")
        b_elim, _ = rt.saif_fused_eliminated(X, y, parent, lam, cfg,
                                             device="cpu")
        b_ref, _ = J.saif_fused_eliminated(X, y, parent, lam,
                                           J.SaifConfig(eps=1e-10))
        o_s = rt.fused_objective(X, y, parent, b_slot, lam)
        o_e = rt.fused_objective(X, y, parent, b_elim, lam)
        assert float(res.gap) <= 1e-10
        assert abs(o_s - o_e) <= 1e-6 * max(abs(o_e), 1)
        np.testing.assert_allclose(b_elim, np.asarray(b_ref), atol=1e-6)
        np.testing.assert_allclose(
            o_e, J.fused_objective(X, y, parent, b_ref, lam), rtol=1e-9)


@pytest.mark.parametrize("loss", ["least_squares", "logistic"])
def test_fused_baseline_cm_matches_reference(loss):
    rng = np.random.default_rng(3)
    n, p = 30, 20
    X = rng.normal(size=(n, p))
    y = (np.where(X[:, :5].sum(1) + 0.3 * rng.normal(size=n) > 0, 1., -1.)
         if loss == "logistic" else rng.normal(size=n))
    parent = _chain_parent(p)
    lam = 0.3 * J.fused_lambda_max(X, y, parent, loss=loss)
    ref = J.fused_baseline_cm(X, y, parent, lam, tol=1e-10, loss=loss)
    mine = rt.fused_baseline_cm(X, y, parent, lam, tol=1e-10, loss=loss,
                                device="cpu")
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), atol=1e-6)
    beta, _ = rt.saif_fused(X, y, parent, lam,
                            rt.SaifConfig(eps=1e-10, loss=loss),
                            device="cpu")
    o_s = rt.fused_objective(X, y, parent, beta, lam, loss=loss)
    o_b = rt.fused_objective(X, y, parent, mine, lam, loss=loss)
    assert o_s <= o_b + 1e-6 * max(abs(o_b), 1)


def test_warm_start_never_truncates_unpen_slot():
    """A capacity-full warm support without b still pins b resident, and
    lands where the reference does."""
    rng = np.random.default_rng(2)
    n, p = 30, 300
    X = rng.normal(size=(n, p))
    y = rng.normal(size=n)
    _, c0, _ = jd.null_gradient(j_get_loss("least_squares"),
                                jnp.asarray(X), jnp.asarray(y), p - 1)
    lam = 0.8 * float(jnp.max(c0))
    ref = J.saif(X, y, lam, J.SaifConfig(eps=1e-9, unpen_idx=p - 1),
                 warm_idx=jnp.arange(64), warm_beta=jnp.zeros(64))
    res = rt.saif(X, y, lam, rt.SaifConfig(eps=1e-9, unpen_idx=p - 1),
                  warm_idx=torch.arange(64),
                  warm_beta=torch.zeros(64, dtype=torch.float64),
                  device="cpu")
    final = set(res.active_idx[res.active_mask].tolist())
    assert p - 1 in final
    assert float(res.gap) <= 1e-9
    assert _support(res.beta) == _support(ref.beta)
    assert res.n_active == int(ref.n_active)


# --------------------------------------------------------------------------
# inner-backend routing of ``auto``
# --------------------------------------------------------------------------

CPU, CUDA = torch.device("cpu"), torch.device("cuda")


@pytest.mark.parametrize("args,device,want", [
    # on the card least squares takes the Gram engine (K6, the fused slot
    # in its pen) under the reference's crossover, while the capacity
    # fits K6's gate ...
    (("least_squares", 100, 400), CUDA, "gram"),
    (("least_squares", 1000, 1024), CUDA, "gram"),
    # ... and K3 past the crossover while the burst fits it
    (("least_squares", 100, 401), CUDA, "cuda"),
    (("least_squares", 10**4, 4096), CUDA, "gram"),
    (("logistic", 1000, 1024), CUDA, "cuda"),
    # on the CPU the reference's crossover stands
    (("least_squares", 100, 400), CPU, "gram"),
    (("least_squares", 100, 401), CPU, "torch"),
    (("logistic", 100, 64), CPU, "torch"),
])
def test_auto_inner_routing(args, device, want):
    assert resolve_inner_backend("auto", *args, device) == want
    assert resolve_inner_backend("auto", *args, device, unpen=True) == want


def test_auto_inner_routing_over_every_gate():
    """Neither K3 nor the crossover: raise on the card, never the host
    loop; the unpenalized slot's weights count against the gate."""
    with pytest.raises(ValueError, match="inner_backend='torch'"):
        resolve_inner_backend("auto", "least_squares", 10**4, 50_000, CUDA)
    # under the crossover but past the Gram-sweep kernel's gate
    with pytest.raises(ValueError, match="inner_backend='torch'"):
        resolve_inner_backend("auto", "least_squares", 10**4, 40_000, CUDA)
    from repro_torch.kernels.cm.cm import cm_smem_bytes, cm_smem_ok
    n, k = 5000, 1024
    assert cm_smem_bytes(n, k, 8, pen=True) == cm_smem_bytes(n, k, 8) + 8 * k
    k_edge = next(k for k in range(1, 4096)
                  if cm_smem_ok(n, k) and not cm_smem_ok(n, k, pen=True))
    assert resolve_inner_backend("auto", "logistic", n, k_edge,
                                 CUDA) == "cuda"
    with pytest.raises(ValueError, match="shared-memory"):
        resolve_inner_backend("auto", "logistic", n, k_edge, CUDA,
                              unpen=True)
