"""Kernel K6 ``gram_sweep`` (and its fleet form K6b) and K1b with
per-problem column norms on the CPU, float64:

  * the Gram-sweep twin against the reference's ``repro.core.cm.
    gram_epochs`` (the device loop K6 replaces), with and without the
    unpenalized slot's weights, at 1e-12 relative; K6b's twin is K6's
    per problem;
  * K1b's twin with a (B, p) norm matrix (a weighted fleet's) against the
    reference's ``screen_fused_batch_pallas`` in interpret mode, and
    bitwise K1's twin per problem with its own norms;
  * the wrappers given CPU tensors launch nothing; the shared-memory
    gates, K6's layout and `auto`'s routing at the smoke's and the
    tests' shapes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.active_set import compact_order as j_compact_order
from repro.core.cm import gram_epochs as j_gram_epochs
from repro.kernels.screen.screen import screen_fused_batch_pallas
from repro_torch.kernels import ops
from test_torch_fleet_kernels import _close_masked, _fleet_scan, _merge
from test_torch_saif import _one_torch_thread  # noqa: F401

RTOL = 1e-12


def _t(a):
    return torch.from_numpy(np.array(a))


def _gram_problem(seed, n, k, live_frac=0.8, pen=False):
    r = np.random.default_rng(seed)
    mask = r.random(k) < live_frac
    mask[0] = True
    Xa = np.where(mask[None, :], r.normal(size=(n, k)), 0.0)
    y = Xa @ np.where(r.random(k) < 0.5, r.normal(size=k), 0.0) \
        + 0.3 * r.normal(size=n)
    G, rho = Xa.T @ Xa, Xa.T @ y
    beta = np.where(mask & (r.random(k) < 0.5), 0.1 * r.normal(size=k), 0.0)
    order = np.asarray(j_compact_order(jnp.arange(k), jnp.asarray(mask)))
    lam = 0.2 * float(np.abs(rho).max())
    w = None
    if pen:
        w = np.ones(k)
        w[int(order[0])] = 0.0                 # the first live slot
    return G, rho, beta, mask, order, int(mask.sum()), lam, w


@pytest.mark.parametrize("n,k,n_ep,pen", [(40, 16, 3, False),
                                          (60, 33, 5, False),
                                          (60, 33, 5, True),
                                          (25, 64, 2, True)])
def test_gram_twin_matches_reference_gram_epochs(n, k, n_ep, pen):
    G, rho, beta, mask, order, count, lam, w = _gram_problem(
        n + k, n, k, pen=pen)
    ops.reset_launch_counts()
    args = (_t(G), _t(rho), _t(beta), _t(mask), lam, _t(order), count, n_ep)
    kw = dict(smoothness=1.0, pen=None if w is None else _t(w))
    out = ops.gram_sweep(*args, **kw)
    assert ops.launch_counts() == {kn: 0 for kn in ops.KERNELS}
    assert torch.equal(out, ops.gram_sweep_ref(*args, **kw))
    ref = np.asarray(j_gram_epochs(
        jnp.asarray(G), jnp.asarray(rho), jnp.asarray(beta),
        jnp.asarray(mask), lam, jnp.asarray(order), count, n_ep,
        smoothness=1.0, pen=None if w is None else jnp.asarray(w)))
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL,
                               atol=RTOL * np.abs(ref).max())
    assert (out.numpy()[~mask] == 0).all()
    if pen:
        assert out[int(order[0])] != 0         # the unpenalized slot moves


def test_gram_batch_twin_is_the_serial_twin_per_problem():
    probs = [_gram_problem(s, 40, 24) for s in range(3)]
    G, rho, beta, mask, order = (torch.stack([_t(p_[j]) for p_ in probs])
                                 for j in range(5))
    count = [p_[5] for p_ in probs]
    lam = torch.tensor([p_[6] for p_ in probs])
    n_ep = [3, 0, 7]
    out = ops.gram_sweep_batch(G, rho, beta, mask, lam, order, count, n_ep)
    assert ops.gram_sweep_batch.launches == 0
    for i in range(3):
        assert torch.equal(out[i], ops.gram_sweep(
            G[i], rho[i], beta[i], mask[i], lam[i], order[i], count[i],
            n_ep[i]))
    assert torch.equal(out[1], beta[1])        # 0 epochs: unchanged


def test_gram_smem_gate():
    from repro_torch.kernels.gram.gram import (GRAM_SMEM_BUDGET_BYTES,
                                               gram_smem_bytes, gram_smem_ok)
    assert gram_smem_ok(4000, 8) and gram_smem_ok(5534, 8)
    assert not gram_smem_ok(5535, 8)
    assert gram_smem_ok(9752, 4) and not gram_smem_ok(9753, 4)
    assert gram_smem_bytes(5534, 8) <= GRAM_SMEM_BUDGET_BYTES


@pytest.mark.parametrize("n,p,b", [(64, 256, 3), (33, 1000, 4)])
def test_fleet_scan_twin_with_per_problem_norms(n, p, b):
    """A weighted fleet's (B, p) norms: K1b's twin against the reference's
    pallas scan, and bitwise K1's twin per problem with its own row."""
    h = 16
    X, Theta, _, active, radii = _fleet_scan(n + p, n, p, b)
    W = (np.random.default_rng(p).random((b, n)) < 0.7).astype(float)
    cn = np.sqrt(W @ (X * X))
    out = ops.screen_fused_batch(_t(X), _t(Theta), _t(cn), _t(active),
                                 _t(radii), h=h)
    assert ops.screen_fused_batch.launches == 0
    pal = screen_fused_batch_pallas(X, Theta, cn, active, radii, h=h,
                                    interpret=True)
    for i in range(b):
        ser = ops.screen_fused(_t(X), _t(Theta[i]), _t(cn[i]),
                               _t(active[i]), float(radii[i]), h=h)
        for a, s in zip(out, ser):
            assert torch.equal(a[i], s)
        for a, pb in zip(out[:3], pal[:3]):
            _close_masked(a[i].numpy(), np.asarray(pb[i]))
        cs, ci = _merge(out[3][i].numpy(), out[4][i].numpy(), h)
        cs_p, ci_p = _merge(pal[3][i], pal[4][i], h)
        fin = np.isfinite(cs_p)
        np.testing.assert_allclose(cs[fin], cs_p[fin], rtol=RTOL)
        assert (ci[fin] == ci_p[fin]).all()
    # the shared-norm call is a different scan where the rows differ
    shared = ops.screen_fused_batch(_t(X), _t(Theta), _t(cn[0]), _t(active),
                                    _t(radii), h=h)
    assert torch.equal(shared[1][0], out[1][0])
    assert not torch.equal(shared[1][1:], out[1][1:])


# Shared-memory bytes of the shapes the smoke and the tests give the
# kernels, as the first kernels' layouts counted them: (n, k, itemsize,
# pen) -> K3's, (k, itemsize) -> K6's state. The redesigned kernels keep
# both, so every gate answers as it did.
_CM_BYTES = {(1000, 512, 8, False): 35008, (1000, 1024, 8, False): 45760,
             (1000, 256, 8, False): 29632, (1000, 512, 8, True): 39104,
             (800, 512, 8, False): 30208, (1000, 512, 4, False): 18784,
             (60, 64, 8, False): 3040, (80, 128, 8, False): 4864,
             (5000, 1024, 8, True): 149952, (7900, 512, 8, True): 204704,
             (8000, 512, 8, True): 207104, (8192, 512, 8, False): 207616}
_GRAM_BYTES = {(512, 8): 18960, (1024, 8): 37904, (512, 4): 10760,
               (64, 8): 2384, (2048, 8): 75792, (4096, 8): 151568,
               (5534, 8): 204774, (5535, 8): 204811, (9752, 4): 204800}


@pytest.mark.parametrize("shape", sorted(_CM_BYTES))
def test_cm_smem_gate(shape):
    from repro_torch.kernels.cm.cm import (CM_SMEM_BUDGET_BYTES,
                                           cm_smem_bytes, cm_smem_ok)
    n, k, isz, pen = shape
    assert cm_smem_bytes(n, k, isz, pen) == _CM_BYTES[shape]
    assert cm_smem_ok(n, k, isz, pen) == (_CM_BYTES[shape]
                                          <= CM_SMEM_BUDGET_BYTES)


@pytest.mark.parametrize("shape", sorted(_GRAM_BYTES))
def test_gram_smem_gate_at_shapes(shape):
    from repro_torch.kernels.gram.gram import (GRAM_SMEM_BUDGET_BYTES,
                                               gram_smem_bytes, gram_smem_ok)
    k, isz = shape
    assert gram_smem_bytes(k, isz) == _GRAM_BYTES[shape]
    assert gram_smem_ok(k, isz) == (_GRAM_BYTES[shape]
                                    <= GRAM_SMEM_BUDGET_BYTES)


@pytest.mark.parametrize("k,isz,want", [
    # one warp with the ring up to k = 1024 (every shape of the smoke)
    (64, 8, (32, 16, 10832)), (512, 8, (32, 16, 84752)),
    (1024, 8, (32, 16, 169232)), (1024, 4, (32, 16, 87312)),
    # a row that is not a whole number of 16-byte words, or k past 1024:
    # 256 threads and no ring
    (999, 8, (256, 0, 36979)), (1022, 4, (256, 0, 21470)),
    (1025, 8, (256, 0, 37941)), (2048, 8, (256, 0, 75792)),
    (4096, 4, (256, 0, 86024)), (5534, 8, (256, 0, 204774)),
    (9752, 4, (256, 0, 204800)),
])
def test_gram_sweep_form(k, isz, want):
    from repro_torch.kernels.gram.gram import gram_sweep_form
    assert gram_sweep_form(k, isz) == want


def test_gram_sweep_form_fits_under_every_gate():
    """Every capacity the gate admits gets a layout within the card's
    limit, and the ring only where the state alone fits the gate."""
    from repro_torch.kernels.gram.gram import (SMEM_MAX_BYTES,
                                               gram_smem_bytes, gram_smem_ok,
                                               gram_sweep_form)
    for isz in (8, 4):
        ks = [k for k in range(1, 10_000) if gram_smem_ok(k, isz)]
        assert ks == list(range(1, ks[-1] + 1))
        for k in ks:
            threads, ring, nbytes = gram_sweep_form(k, isz)
            assert nbytes <= SMEM_MAX_BYTES
            assert nbytes >= gram_smem_bytes(k, isz)
            assert (threads == 32) == (ring > 0)
            assert ring == 0 or k <= 1024


@pytest.mark.parametrize("loss,n,k,device,unpen,want", [
    # the smoke's solves on the card: LS (auto) takes the Gram engine
    # under the crossover, as the reference does, logistic K3, fused (the
    # unpenalized slot), the CV refit and fold-1 serial solve
    ("least_squares", 1000, 512, "cuda", False, "gram"),
    ("least_squares", 1000, 1024, "cuda", False, "gram"),
    ("least_squares", 800, 512, "cuda", False, "gram"),
    ("logistic", 1000, 256, "cuda", False, "cuda"),
    ("logistic", 1000, 512, "cuda", True, "cuda"),
    # K3's shared-memory edge makes no difference under the crossover;
    # past the crossover least squares runs K3
    ("least_squares", 7900, 512, "cuda", True, "gram"),
    ("least_squares", 8000, 512, "cuda", True, "gram"),
    ("least_squares", 100, 512, "cuda", False, "cuda"),
    # the CPU tests' shapes keep the reference's crossover
    ("least_squares", 60, 64, "cpu", False, "gram"),
    ("least_squares", 60, 512, "cpu", False, "torch"),
    ("logistic", 80, 128, "cpu", False, "torch"),
])
def test_auto_routing_at_smoke_and_test_shapes(loss, n, k, device, unpen,
                                               want):
    from repro_torch.core.inner_backend import resolve_inner_backend
    assert resolve_inner_backend("auto", loss, n, k, torch.device(device),
                                 8, unpen) == want
