"""The fast fleet's kernels and helpers on the CPU, held against the
reference on the same float64 numpy inputs:

  * K1/K1b's mixed mode (X and theta rounded to bf16 or float32, float32
    sums and outputs): the twins against ``screen_fused_pallas`` /
    ``screen_fused_batch_pallas(in_dtype=.., acc_dtype="float32")`` in
    interpret mode, each score within the certified bound gamma_total
    ||theta|| ||x_i|| of the exact product, and within the float32 sums'
    bound 2 gamma_n(u_f32) sum_j |theta_j x_ji| of the Pallas kernel's on
    the same rounded inputs, the merged candidates equal wherever their
    scores are separated by more than that, p = 777 included; the ub
    guard; the dtype resolution;
  * K6b's twin with the identity order (the lockstep sweep) against
    ``repro.core.batch._gram_sweep_fast`` at rtol 1e-10, dead slots
    interleaved, a frozen problem and unequal budgets;
  * the stacked active-set helpers and the fast DEL / ADD against the
    reference's batched ones;
  * C3: ``auto``'s inner choice on a (faked) card against the reference's
    ``resolve_inner_backend`` and ``resolve_batch_inner``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SaifConfig as JConfig
from repro.core import active_set as j_aset
from repro.core import batch as j_batch
from repro.core import inner_backend as j_inner
from repro.core.duality import dot_error_gamma as j_dot_gamma
from repro.core.duality import mixed_precision_gamma as j_gamma
from repro.core.duality import unit_roundoff as j_unit
from repro.kernels.screen.screen import (_screen_dtypes,
                                         screen_fused_batch_pallas,
                                         screen_fused_pallas)
import repro_torch as rt
from repro_torch.core import active_set as aset_lib
from repro_torch.core import batch_fast as bf
from repro_torch.core.inner_backend import resolve_inner_backend
from repro_torch.kernels import ops
from repro_torch.kernels.cm.cm import cm_smem_ok
from repro_torch.kernels.gram.gram import gram_smem_ok
from repro_torch.kernels.screen.screen import screen_dtypes


def _t(a):
    return torch.from_numpy(np.array(a))


def _scan_inputs(seed, n, p, b):
    r = np.random.default_rng(seed)
    X = r.normal(size=(n, p))
    Theta = r.normal(size=(b, n)) / np.sqrt(n)
    cn = np.linalg.norm(X, axis=0)
    active = r.random((b, p)) < 0.1
    radii = r.uniform(0.0, 0.5, b)
    return X, Theta, cn, active, radii


def _merged(tops, topi, h):
    """Global top-h (scores, ids) of one problem's tile winners."""
    cs, pos = jax.lax.top_k(jnp.asarray(np.asarray(tops)).reshape(-1), h)
    return np.asarray(cs), np.asarray(jnp.asarray(
        np.asarray(topi)).reshape(-1)[pos])


@pytest.mark.parametrize("in_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("n,p,b", [(48, 160, 3), (37, 777, 3), (64, 777, 1)])
def test_mixed_scan_twins_against_pallas(in_dtype, n, p, b):
    h = 8
    X, Theta, cn, active, radii = _scan_inputs(n + p + b, n, p, b)
    gamma = j_gamma(n, in_dtype, "float32")
    bound = gamma * np.linalg.norm(Theta, axis=1)[:, None] * cn[None, :]
    exact = np.abs(Theta @ X)
    # both kernels get the inputs already rounded to in_dtype (each casts
    # them again, exactly), so they multiply the same values and differ by
    # their float32 sums' order only; the port's cast is the one it makes
    # itself, so its scores are those of the unrounded inputs
    X, Theta = (_t(a).to(getattr(torch, in_dtype)).double().numpy()
                for a in (X, Theta))
    pair = (2 * j_dot_gamma(n, j_unit("float32"))
            * (np.abs(Theta) @ np.abs(X)))
    ops.reset_launch_counts()
    if b == 1:          # K1 and its serial Pallas kernel
        out = ops.screen_fused(_t(X), _t(Theta[0]), _t(cn), _t(active[0]),
                               float(radii[0]), h=h, in_dtype=in_dtype,
                               acc_dtype="float32")
        out = [o[None].numpy() for o in out]
        pal = screen_fused_pallas(X, Theta[0], cn, active[0], radii[0], h=h,
                                  interpret=True, in_dtype=in_dtype,
                                  acc_dtype="float32")
        pal = [np.asarray(o)[None] for o in pal]
    else:               # K1b and the problem-gridded Pallas kernel
        out = ops.screen_fused_batch(_t(X), _t(Theta), _t(cn), _t(active),
                                     _t(radii), h=h, in_dtype=in_dtype,
                                     acc_dtype="float32")
        out = [o.numpy() for o in out]
        pal = screen_fused_batch_pallas(
            X, Theta, np.broadcast_to(cn, (b, p)).copy(), active, radii,
            h=h, interpret=True, in_dtype=in_dtype, acc_dtype="float32")
        pal = [np.asarray(o) for o in pal]
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}
    assert all(o.dtype in (np.float32, np.int32) for o in out)
    free = ~active
    score, pscore = out[0].astype(np.float64), pal[0].astype(np.float64)
    assert (np.isneginf(score) == active).all()
    assert (np.isneginf(pscore) == active).all()
    assert np.all(np.abs(score[free] - exact[free]) <= bound[free])
    assert np.all(np.abs(score[free] - pscore[free]) <= pair[free])
    nr = cn[None, :] * radii[:, None]
    ub_tol = pair + 4 * 2.0 ** -24 * (exact + bound + nr)
    assert np.all(np.abs(out[1][free] - pal[1][free]) <= ub_tol[free])
    for i in range(b):
        cs, ci = _merged(out[3][i], out[4][i], h)
        cs_p, ci_p = _merged(pal[3][i], pal[4][i], h)
        # a candidate is decided where it stands clear of its neighbours
        gap = np.abs(np.diff(np.concatenate([[np.inf], cs, [-np.inf]])))
        tol = np.max(pair[i])
        clear = (gap[:-1] > tol) & (gap[1:] > tol) & np.isfinite(cs)
        assert (ci[clear] == ci_p[clear]).all()
        assert np.max(out[5][i]) == pytest.approx(
            float(np.max(pal[5][i])), abs=float(np.max(ub_tol[i])))


def test_scan_guard_and_dtypes():
    """``guard`` multiplies ub and the tile maxima only; the working mode
    is bitwise the plain call; the dtype pairs resolve as the reference's
    ``_screen_dtypes`` does."""
    X, Theta, cn, active, radii = _scan_inputs(1, 40, 300, 2)
    args = (_t(X), _t(Theta), _t(cn), _t(active), _t(radii))
    plain = ops.screen_fused_batch(*args, h=4)
    same = ops.screen_fused_batch(*args, h=4, guard=1.0)
    assert all(torch.equal(a, c) for a, c in zip(plain, same))
    g = 1 + 8 * 2.0 ** -24
    lo = ops.screen_fused_batch(*args, h=4, in_dtype="float32")
    hi = ops.screen_fused_batch(*args, h=4, in_dtype="float32", guard=g)
    for i in (0, 2, 3, 4):
        assert torch.equal(lo[i], hi[i])
    assert torch.equal(hi[1], lo[1] * np.float32(g))
    assert torch.equal(hi[5], lo[5] * np.float32(g))
    Xj = jnp.zeros((2, 2))
    for ind, acc in ((None, None), ("float32", None), ("bfloat16", None),
                     ("bfloat16", "float32"), ("float32", "float32")):
        dt_in, dt_acc = screen_dtypes(torch.zeros(2, 2, dtype=torch.float64),
                                      ind, acc)
        j_in, j_acc = _screen_dtypes(Xj, ind, acc)
        assert (str(dt_in).split(".")[1], str(dt_acc).split(".")[1]) == (
            j_in.name, j_acc.name)


def test_lockstep_sweep_twin_against_the_reference():
    """K6b's twin with the identity order over [0, hi) per problem is the
    reference's lockstep sweep over the fleet's [0, hi): dead slots
    interleaved (stale but finite G entries), one frozen problem, unequal
    budgets, a warm beta."""
    r = np.random.default_rng(3)
    B, k, n = 5, 24, 60
    mask = r.random((B, k)) < 0.6
    mask[:, 0] = True
    mask[2, 18:] = False                 # a shorter live range
    A = r.normal(size=(B, n, k))
    G = np.einsum("bnk,bnl->bkl", A, A)
    G[~mask] *= 0.5                      # stale rows of dead slots
    rho = np.einsum("bnk,bn->bk", A, r.normal(size=(B, n)))
    beta = np.where(mask, r.normal(size=(B, k)) * 0.1, 0.0)
    lam = r.uniform(5.0, 15.0, B)
    n_ep = np.array([5, 0, 12, 1, 3], np.int32)
    want = j_batch._gram_sweep_fast(jnp.asarray(G), jnp.asarray(rho),
                                    jnp.asarray(beta), jnp.asarray(mask),
                                    jnp.asarray(lam), jnp.asarray(n_ep))
    order = torch.arange(k, dtype=torch.int32).expand(B, -1).contiguous()
    got = bf._gram_sweep_fast(_t(G), _t(rho), _t(beta), _t(mask), _t(lam),
                              _t(n_ep), order)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10,
                               atol=1e-12)
    assert torch.equal(got[1], _t(beta[1]))            # frozen: kept
    assert (got.numpy()[~mask] == 0).all()


def _j_aset_fields(a):
    return [np.asarray(x) for x in (a.idx, a.mask, a.beta, a.in_active,
                                    a.count, a.overflowed)]


def _t_aset_fields(a):
    return [x.numpy() for x in (a.idx, a.mask, a.beta, a.in_active,
                                a.count, a.overflowed)]


def test_stacked_active_set_edits_against_the_reference():
    """init, gather, scatter and the fast DEL / ADD (overflow included) on
    (B, k) buffers equal the reference's batched ones field for field."""
    r = np.random.default_rng(4)
    B, k, p, n = 3, 6, 40, 9
    X = r.normal(size=(n, p))
    init_idx = np.stack([r.choice(p, k, replace=False) for _ in range(B)])
    init_mask = r.random((B, k)) < 0.5
    init_beta = np.where(init_mask, r.normal(size=(B, k)), 0.0)
    ja = j_aset.init_active_set_batch(p, k, jnp.asarray(init_idx),
                                      jnp.float64, jnp.asarray(init_beta),
                                      live_mask=jnp.asarray(init_mask))
    ta = aset_lib.init_active_set_stacked(p, k, _t(init_idx), torch.float64,
                                          _t(init_beta), _t(init_mask))
    for x, y in zip(_t_aset_fields(ta), _j_aset_fields(ja)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(
        aset_lib.gather_columns_stacked(_t(X), ta).numpy(),
        np.asarray(j_aset.gather_columns_batch(jnp.asarray(X), ja)))
    for step in range(4):
        drop = r.random((B, k)) < 0.3
        ja = j_batch._delete_features_fast(ja, jnp.asarray(drop))
        ta = bf._delete_features_fast(ta, _t(drop))
        cand = np.stack([r.choice(p, 5, replace=False) for _ in range(B)])
        keep = r.random((B, 5)) < 0.8
        ja = j_batch._add_features_fast(ja, jnp.asarray(cand, jnp.int32),
                                        jnp.asarray(keep))
        ta = bf._add_features_fast(ta, _t(cand), _t(keep))
        for x, y in zip(_t_aset_fields(ta), _j_aset_fields(ja)):
            np.testing.assert_array_equal(x, y)
    assert bool(ta.overflowed.any())
    np.testing.assert_array_equal(
        aset_lib.scatter_beta_stacked(ta, p).numpy(),
        np.asarray(j_aset.scatter_beta_batch(ja, p)))


def test_auto_inner_choice_on_a_card_against_the_reference():
    """C3: on a (faked) card ``auto`` takes the Gram engine wherever the
    reference does (serial, fleet, fused least squares) and K6's shared
    memory holds the capacity, and otherwise K3 / K3b while the burst
    fits, else raises; the CPU policy is the reference's."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    seen = set()
    for loss in ("least_squares", "logistic"):
        for n in (40, 100, 1000, 7000, 10**4):
            for k_max in (64, 256, 400, 512, 4096, 40_000):
                ref = j_inner.resolve_inner_backend("auto", loss, n, k_max)
                assert resolve_inner_backend("auto", loss, n, k_max,
                                             cpu) == (
                    "torch" if ref == "jnp" else ref)
                gram = ref == "gram" and gram_smem_ok(k_max, 8)
                for unpen in (False, True):
                    fits = cm_smem_ok(n, k_max, 8, unpen)
                    if gram or fits:
                        got = resolve_inner_backend("auto", loss, n, k_max,
                                                    cuda, 8, unpen)
                        assert got == ("gram" if gram else "cuda")
                        seen.add(got)
                    else:
                        with pytest.raises(ValueError):
                            resolve_inner_backend("auto", loss, n, k_max,
                                                  cuda, 8, unpen)
                        seen.add("raise")
                for b in (1, 5, 16):
                    jcfg = JConfig(loss=loss)
                    ref_b = j_batch.resolve_batch_inner(jcfg, n, k_max, b)
                    gram_b = ref_b == "gram" and gram_smem_ok(k_max, 8)
                    cfg = rt.SaifConfig(loss=loss)
                    if gram_b or cm_smem_ok(n, k_max, 8):
                        assert rt.resolve_batch_inner(
                            cfg, n, k_max, b, cuda) == (
                            "gram" if gram_b else "cuda")
                    else:
                        with pytest.raises(ValueError):
                            rt.resolve_batch_inner(cfg, n, k_max, b, cuda)
    assert seen == {"gram", "cuda", "raise"}
