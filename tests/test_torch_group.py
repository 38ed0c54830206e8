"""Group LASSO in the port on the CPU: ``repro_torch.core.group``, the plain
version of kernel B-n3 (``kernels/group``), and the group arms of the
Session, serving and the server, held against ``repro`` on the same numpy
inputs in float64 at the reference's CI shapes (n = 40, p = 120 and 240,
gsize 4 and 8, ``device="cpu"``).

  * the helpers: ``_group_norms``, ``group_soft_threshold`` (v = 0 too),
    ``prepare_group`` (c0 and gfro at rtol 1e-13; h and k_max equal),
    ``group_lambda_max``;
  * the outer loop step by step: ``_gsaif`` with B-n3's plain burst
    against the reference's ``_gsaif_jit`` after 1, 2 and 3 outer steps
    (``gidx``, ``gmask`` and ``n_outer`` equal, ``beta_slots`` at rtol
    1e-10);
  * ``group_solve`` cold and warm (the warm triple carried across by
    ``convert.group_warm_from_numpy``), least squares and logistic:
    supports, ``n_outer``, ``n_active_groups``, ``gidx`` and ``gmask``
    equal, beta at atol 1e-8, gap <= eps; the unscreened oracle; the
    mirrors of tests/test_group.py, tests/test_api.py's two group tests
    and tests/test_serving_chaos.py's group verdicts;
  * the refusals with the reference's classes and messages (its
    "(DESIGN.md §N)" citations stripped), ``_scrub_warm``, a group Scalar
    through ``open_server``, ``device=None`` without a card, and a faked
    card (``meta`` tensors) on which the ``cuda`` wrapper raises rather
    than running the plain version; the shared-memory gate and its choice
    of the kernel's form (register or chunked) at each of their edges,
    and the entry a faked card's wrapper asks for in each form.
"""
import dataclasses
import re
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.core import api as JA
from repro.core import group as JG
from repro.core.losses import get_loss as j_get_loss
from repro.core.serving import open_serving as j_open_serving
from repro_torch import convert
from repro_torch.core import _compat
from repro_torch.core import group as G
from repro_torch.core.losses import get_loss
from repro_torch.kernels import _build, ops
from repro_torch.kernels.group.group import (group_bcd, group_form,
                                             group_smem_bytes, group_smem_ok,
                                             reg_layout)
from repro_torch.kernels.group.ref import group_bcd_ref, group_blocks
from test_torch_saif import _one_torch_thread  # noqa: F401

LOSSES = ["least_squares", "logistic"]
SHAPES = [(120, 4), (240, 8)]
# the most groups of 10 over 1,000 rows one float64 burst can hold (in
# the register form; the chunked form alone holds 1,868)
GATE_TOP_F64 = 2079


def _make(seed=0, n=40, p=120, gsize=4, k_groups=5, logistic=False):
    """tests/test_group.py's problem (labels sign(.) for logistic)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p))
    beta = np.zeros(p)
    for g in rng.choice(p // gsize, k_groups, replace=False):
        beta[g * gsize:(g + 1) * gsize] = rng.normal(size=gsize)
    y = X @ beta + 0.3 * rng.normal(size=n)
    if logistic:
        y = np.where(y >= 0, 1.0, -1.0)
    return X, y


def _glm(X, y, gsize, loss="least_squares"):
    return JG.group_lambda_max(j_get_loss(loss), X, y, gsize)


def _gsup(beta, gsize, tol=1e-7):
    return set(np.flatnonzero(np.linalg.norm(
        np.asarray(beta).reshape(-1, gsize), axis=1) > tol).tolist())


def _np(a):
    return a.numpy() if torch.is_tensor(a) else np.asarray(a)


def _held(res, jres, gsize, eps, atol=1e-8):
    """A port GroupSaifResult against the reference's."""
    assert res.n_outer == int(jres.n_outer)
    assert res.n_active_groups == int(jres.n_active_groups)
    np.testing.assert_array_equal(_np(res.gidx), _np(jres.gidx))
    np.testing.assert_array_equal(_np(res.gmask), _np(jres.gmask))
    assert _gsup(_np(res.beta), gsize) == _gsup(_np(jres.beta), gsize)
    np.testing.assert_allclose(_np(res.beta), _np(jres.beta), rtol=0,
                               atol=atol)
    assert float(res.gap) <= eps


def _strip(msg: str) -> str:
    return re.sub(r"\s*\(DESIGN\.md[^)]*\)", "", msg)


# ---------------------------------------------------------------------------
# helpers and the preparation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["random", "zero", "below", "t=0"])
def test_group_norms_and_soft_threshold(case):
    rng = np.random.default_rng(3)
    v = rng.normal(size=120)
    t = {"random": 0.7, "zero": 0.5, "below": 1e3, "t=0": 0.0}[case]
    if case == "zero":
        v = np.zeros(120)
    np.testing.assert_allclose(G._group_norms(torch.from_numpy(v), 4),
                               JG._group_norms(jnp.asarray(v), 4),
                               rtol=1e-14, atol=0)
    for blk in (v[:4], v):
        mine = G.group_soft_threshold(torch.from_numpy(blk), t).numpy()
        ref = np.asarray(JG.group_soft_threshold(jnp.asarray(blk), t))
        np.testing.assert_allclose(mine, ref, rtol=1e-14, atol=0)
        if case in ("zero", "below"):
            assert not mine.any()


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("shape", SHAPES)
def test_prepare_group_matches_reference(shape, loss):
    p, gs = shape
    X, y = _make(1, p=p, gsize=gs, logistic=loss == "logistic")
    for kw in ({}, {"h": 3, "k_max": 10}):
        jp = JG.prepare_group(X, y, gs, JG.GroupSaifConfig(loss=loss, **kw))
        tp = G.prepare_group(X, y, gs, G.GroupSaifConfig(loss=loss, **kw),
                             device="cpu")
        np.testing.assert_allclose(tp.c0.numpy(), np.asarray(jp.c0),
                                   rtol=1e-13, atol=0)
        np.testing.assert_allclose(tp.gfro.numpy(), np.asarray(jp.gfro),
                                   rtol=1e-13, atol=0)
        assert (tp.gsize, tp.h, tp.k_max) == (jp.gsize, jp.h, jp.k_max)
    assert G.group_lambda_max(get_loss(loss), X, y, gs) == pytest.approx(
        _glm(X, y, gs, loss), rel=1e-13)


# ---------------------------------------------------------------------------
# B-n3's plain version and the outer loop, step by step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_outer", [1, 2, 3])
@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("shape", SHAPES)
def test_outer_steps_match_reference(shape, loss, max_outer):
    """``_gsaif`` with B-n3's plain burst against ``_gsaif_jit`` after
    ``max_outer`` steps from the cold start, at 0.1 group-lambda_max."""
    p, gs = shape
    X, y = _make(2, p=p, gsize=gs, logistic=loss == "logistic")
    lam = 0.1 * _glm(X, y, gs, loss)
    jp = JG.prepare_group(X, y, gs, JG.GroupSaifConfig(loss=loss))
    m = min(jp.h, jp.k_max)
    gidx = np.zeros(jp.k_max, np.int32)
    gidx[:m] = np.argsort(-np.asarray(jp.c0), kind="stable")[:m]
    gmask = np.arange(jp.k_max) < m
    beta = np.zeros((jp.k_max, gs))
    kw = dict(loss_name=loss, gsize=gs, h=jp.h, inner_epochs=5,
              polish_factor=8, max_outer=max_outer)
    jres = JG._gsaif_jit(jp.X, jp.y, jp.gfro, jnp.asarray(lam),
                         jnp.asarray(1e-9), jnp.asarray(gidx),
                         jnp.asarray(beta), jnp.asarray(gmask),
                         k_max=jp.k_max, **kw)
    tp = convert.group_prep_from_numpy(jp.X, jp.y, jp.c0, jp.gfro, gs, jp.h,
                                       jp.k_max, device="cpu")
    res = G._gsaif(tp.X, tp.y, tp.gfro, lam, 1e-9,
                   torch.from_numpy(gidx.astype(np.int64)),
                   torch.from_numpy(beta), torch.from_numpy(gmask),
                   burst=group_bcd_ref, **kw)
    assert res.n_outer == int(jres.n_outer) == max_outer
    np.testing.assert_array_equal(res.gidx.numpy(), np.asarray(jres.gidx))
    np.testing.assert_array_equal(res.gmask.numpy(), np.asarray(jres.gmask))
    np.testing.assert_allclose(res.beta_slots.numpy(),
                               np.asarray(jres.beta_slots), rtol=1e-10,
                               atol=1e-14)


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("n_epochs", [0, 3])
def test_wrapper_on_cpu_is_the_plain_version(loss, n_epochs):
    """B-n3's wrapper given CPU tensors returns the plain version bit for
    bit and launches nothing; a masked slot's beta is zeroed when an epoch
    runs, and kept when none does; z sums the live slots."""
    X, y = _make(4, p=120, logistic=loss == "logistic")
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    g = torch.Generator().manual_seed(0)
    gidx = torch.randperm(30, generator=g)[:12]
    gmask = torch.arange(12) % 3 != 1
    beta = 0.1 * torch.randn(12, 4, generator=g, dtype=torch.float64)
    L = torch.rand(12, generator=g, dtype=torch.float64) * 50 + 20
    live = torch.nonzero(gmask).flatten()
    A = group_blocks(Xt, gidx[live], 4)
    np.testing.assert_array_equal(
        A.numpy(), np.stack([X[:, 4 * int(gi):4 * int(gi) + 4].T
                             for gi in gidx[live]]))
    ops.reset_launch_counts()
    a = (A, yt, live, beta, L, 2.0, n_epochs)
    b1, z1 = group_bcd(*a, loss_name=loss)
    b2, z2 = group_bcd_ref(*a, loss_name=loss)
    assert torch.equal(b1, b2) and torch.equal(z1, z2)
    assert ops.launch_counts()["group_bcd"] == 0
    assert torch.equal(b1[~gmask] == 0, torch.full_like(
        b1[~gmask], n_epochs > 0, dtype=torch.bool))
    if n_epochs == 0:
        assert torch.equal(b1, beta)
    z0 = sum(Xt[:, 4 * int(gidx[j]):4 * int(gidx[j]) + 4] @ b1[j]
             for j in live.tolist())
    torch.testing.assert_close(z1, z0, rtol=1e-12, atol=1e-12)
    assert torch.equal(beta[0], a[3][0])            # inputs untouched


# ---------------------------------------------------------------------------
# group_solve, the oracle, the reference's group tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("frac", [0.5, 0.1])
@pytest.mark.parametrize("loss", LOSSES)
def test_group_solve_cold_and_warm(loss, frac):
    X, y = _make(5, logistic=loss == "logistic")
    lam = frac * _glm(X, y, 4, loss)
    eps = 1e-9
    jcfg = JG.GroupSaifConfig(eps=eps, loss=loss)
    cfg = G.GroupSaifConfig(eps=eps, loss=loss)
    jp = JG.prepare_group(X, y, 4, jcfg)
    tp = G.prepare_group(X, y, 4, cfg, device="cpu")
    _held(G.group_solve(tp, lam, cfg), JG.group_solve(jp, lam, jcfg), 4,
          eps)
    # warm from the reference's solve at 1.5x lambda, both packages
    j0 = JG.group_solve(jp, 1.5 * lam, jcfg)
    jw = JG.group_solve(jp, lam, jcfg,
                        warm=(j0.gidx, j0.gmask, j0.beta_slots))
    tp2 = convert.group_prep_from_numpy(jp.X, jp.y, jp.c0, jp.gfro, 4, jp.h,
                                        jp.k_max, device="cpu")
    warm = convert.group_warm_from_numpy(j0.gidx, j0.gmask, j0.beta_slots)
    _held(G.group_solve(tp2, lam, cfg, warm=warm), jw, 4, eps)


@pytest.mark.parametrize("loss", LOSSES)
def test_zero_beta_above_lambda_max(loss):
    X, y = _make(6, logistic=loss == "logistic")
    lam = 1.2 * _glm(X, y, 4, loss)
    cfg = G.GroupSaifConfig(eps=1e-10, loss=loss)
    res = G.group_solve(G.prepare_group(X, y, 4, cfg, device="cpu"), lam,
                        cfg)
    assert float(res.beta.abs().max()) == 0.0
    jres = JG.group_solve(JG.prepare_group(
        X, y, 4, JG.GroupSaifConfig(eps=1e-10, loss=loss)), lam,
        JG.GroupSaifConfig(eps=1e-10, loss=loss))
    _held(res, jres, 4, 1e-10)


def test_capacity_overflow_regrows_where_the_reference_truncates():
    """A deliberate difference (ROADMAP section C): with k_max = 4 below the
    support (the oracle has 17 groups), the reference fills its slots,
    runs to max_outer and serves the truncated solve as ok; the port's ADD
    flags the overflow and ``group_solve`` solves again at 8, 16 and then
    all 30 groups' slots: bit for bit the solve at k_max = 32, the oracle's
    support, certified over every group and served ok. (Where an ADD drops
    a group but the solve then stops by its rule, nothing regrows:
    ``test_saif_config_maps_onto_the_group_config`` holds such a solve,
    k_max = 12, to the reference's slots.)"""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(40, 120))
    y = X[:, :40] @ rng.normal(size=40) + 0.3 * rng.normal(size=40)
    lam = 0.1 * _glm(X, y, 4)
    small = G.GroupSaifConfig(eps=1e-8, k_max=4, max_outer=200)
    roomy = dataclasses.replace(small, k_max=32)
    prep = G.prepare_group(X, y, 4, small, device="cpu")
    assert (prep.h, prep.k_max) == (4, 4)
    cold = G._gsaif(prep.X, prep.y, prep.gfro, lam, 1e-8,
                    torch.sort(prep.c0, descending=True).indices[:4],
                    torch.zeros(4, 4, dtype=torch.float64),
                    torch.ones(4, dtype=torch.bool), loss_name="least_squares",
                    gsize=4, h=4, inner_epochs=5, polish_factor=8,
                    max_outer=200, burst=group_bcd_ref)
    assert cold.overflowed and 1 < cold.n_outer < 200
    res = G.group_solve(prep, lam, small)
    full = G.group_solve(G.prepare_group(X, y, 4, roomy, device="cpu"), lam,
                         roomy)
    assert not res.overflowed and res.gidx.numel() == 30
    assert torch.equal(res.beta, full.beta) and res.n_outer == full.n_outer
    oracle = np.asarray(JG.solve_group_lasso_bcd(
        j_get_loss("least_squares"), jnp.asarray(X), jnp.asarray(y), lam, 4,
        tol=1e-10))
    assert _gsup(res.beta.numpy(), 4) == _gsup(oracle, 4)

    def corr(beta):
        hat = -(X @ np.asarray(beta) - y) / lam
        return np.linalg.norm((X.T @ hat).reshape(-1, 4), axis=1).max()
    assert corr(res.beta.numpy()) <= 1 + 1e-6
    jsmall = JG.GroupSaifConfig(eps=1e-8, k_max=4, max_outer=200)
    jres = JG.group_solve(JG.prepare_group(X, y, 4, jsmall), lam, jsmall)
    assert (int(jres.n_outer), int(jres.n_active_groups)) == (200, 4)
    assert corr(jres.beta) > 4
    out = rt.open_serving(rt.Problem(X=X, y=y, penalty=rt.group(4)), small,
                          device="cpu").solve(rt.Scalar(lam))
    assert out.verdict.ok and torch.equal(out.value.beta, res.beta)
    jout = j_open_serving(JA.Problem(X=X, y=y, penalty=JA.group(4)),
                          jsmall).solve(JA.Scalar(lam))
    assert jout.verdict.ok and "max_outer_exhausted" in jout.verdict.events


@pytest.mark.parametrize("loss", LOSSES)
def test_oracle_matches_reference(loss):
    X, y = _make(7, logistic=loss == "logistic")
    lam = 0.3 * _glm(X, y, 4, loss)
    ref = np.asarray(JG.solve_group_lasso_bcd(
        j_get_loss(loss), jnp.asarray(X), jnp.asarray(y), lam, 4,
        tol=1e-11))
    mine = G.solve_group_lasso_bcd(get_loss(loss), torch.from_numpy(X),
                                   torch.from_numpy(y), lam, 4, tol=1e-11)
    assert _gsup(mine.numpy(), 4) == _gsup(ref, 4)
    np.testing.assert_allclose(mine.numpy(), ref, rtol=0, atol=1e-8)


def _group_saif(*a, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return rt.group_saif(*a, device="cpu", **kw)


@pytest.mark.parametrize("frac", [0.5, 0.1])
def test_group_saif_matches_bcd_oracle(frac):
    """tests/test_group.py::test_group_saif_matches_bcd_oracle."""
    X, y = _make(8)
    loss = get_loss("least_squares")
    lam = frac * G.group_lambda_max(loss, X, y, 4)
    res = _group_saif(X, y, lam, 4, G.GroupSaifConfig(eps=1e-9))
    ref = G.solve_group_lasso_bcd(loss, torch.from_numpy(X),
                                  torch.from_numpy(y), lam, 4, tol=1e-11)
    assert _gsup(res.beta.numpy(), 4) == _gsup(ref.numpy(), 4)
    np.testing.assert_allclose(res.beta.numpy(), ref.numpy(), atol=1e-5)


def test_group_saif_zero_at_lambda_max():
    """tests/test_group.py::test_group_saif_zero_at_lambda_max."""
    X, y = _make(9)
    lmax = G.group_lambda_max(get_loss("least_squares"), X, y, 4)
    res = _group_saif(X, y, 1.2 * lmax, 4, G.GroupSaifConfig(eps=1e-10))
    assert float(res.beta.abs().max()) == 0.0


def test_group_active_set_small():
    """tests/test_group.py::test_group_active_set_small."""
    X, y = _make(10, p=240, k_groups=4)
    lam = 0.2 * G.group_lambda_max(get_loss("least_squares"), X, y, 4)
    res = _group_saif(X, y, lam, 4, G.GroupSaifConfig(eps=1e-8))
    assert res.n_active_groups < 60
    assert float(res.gap) <= 1e-8


def test_group_saif_warns_once_and_is_the_session():
    _compat.reset_deprecation_warnings()
    X, y = _make(11)
    lam = 0.3 * _glm(X, y, 4)
    cfg = G.GroupSaifConfig(eps=1e-8)
    with pytest.warns(DeprecationWarning, match="open_session"):
        r0 = rt.group_saif(X, y, lam, 4, cfg, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        rt.group_saif(X, y, lam, 4, cfg, device="cpu")   # once only
    r1 = G.group_solve(G.prepare_group(X, y, 4, cfg, device="cpu"), lam, cfg)
    assert torch.equal(r0.beta, r1.beta) and r0.n_outer == r1.n_outer


# ---------------------------------------------------------------------------
# the Session (tests/test_api.py:233, :261)
# ---------------------------------------------------------------------------

def _sessions(X, y, gsize, eps, loss="least_squares"):
    sess = rt.open_session(rt.Problem(X=X, y=y, loss=loss,
                                      penalty=rt.group(gsize)),
                           G.GroupSaifConfig(eps=eps), device="cpu")
    jsess = JA.open_session(JA.Problem(X=X, y=y, loss=loss,
                                       penalty=JA.group(gsize)),
                            JG.GroupSaifConfig(eps=eps))
    return sess, jsess


@pytest.mark.parametrize("loss", LOSSES)
def test_group_session_parity(loss):
    """tests/test_api.py::test_group_session_parity_and_single_compilation
    in the port: the session's Scalar is bit for bit ``group_saif`` and its
    direct ``group_solve``; cold, warm Scalars and a Path each equal the
    reference's session; the port compiles nothing."""
    X, y = _make(12, logistic=loss == "logistic")
    glm = _glm(X, y, 4, loss)
    eps = 1e-8
    sess, jsess = _sessions(X, y, 4, eps, loss)
    r1 = sess.solve(rt.Scalar(0.3 * glm))
    _held(r1, jsess.solve(JA.Scalar(0.3 * glm)), 4, eps)
    cfg = G.GroupSaifConfig(eps=eps, loss=loss)
    direct = G.group_solve(G.prepare_group(X, y, 4, cfg, device="cpu"),
                           0.3 * glm, cfg)
    assert torch.equal(r1.beta, direct.beta)
    assert torch.equal(r1.beta_slots, direct.beta_slots)
    r0 = _group_saif(X, y, 0.3 * glm, 4, cfg)
    assert torch.equal(r1.beta, r0.beta)
    for lam, warm in ((0.2, False), (0.15, True)):
        _held(sess.solve(rt.Scalar(lam * glm, warm=warm)),
              jsess.solve(JA.Scalar(lam * glm, warm=warm)), 4, eps)
    lams = (0.4 * glm, 0.25 * glm, 0.1 * glm)
    gp = sess.solve(rt.Path(lams))
    jgp = jsess.solve(JA.Path(lams))
    assert isinstance(gp, rt.GroupPathResult) and gp.n_compilations == 0
    np.testing.assert_array_equal(gp.lams, jgp.lams)
    assert len(gp.betas) == 3
    for res, jres in zip(gp.results, jgp.results):
        _held(res, jres, 4, eps)
    st = sess.compile_stats()
    assert (st.group, st.total, st.requests) == (0, 0, 4)
    assert sess.screen_backend is None and sess.screen_rule is None
    assert G.group_compile_count() == 0


def test_group_warm_path_matches_cold_solves():
    """tests/test_api.py::test_group_warm_path_matches_cold_solves."""
    X, y = _make(13)
    glm = _glm(X, y, 4)
    cfg = G.GroupSaifConfig(eps=1e-9)
    sess = rt.open_session(rt.Problem(X=X, y=y, penalty=rt.group(4)), cfg,
                           device="cpu")
    gp = sess.solve(rt.Path((0.35 * glm, 0.2 * glm)))
    prep = G.prepare_group(X, y, 4, cfg, device="cpu")
    for lam, beta in zip(gp.lams, gp.betas):
        ref = G.group_solve(prep, float(lam), cfg)      # cold
        assert _gsup(beta.numpy(), 4) == _gsup(ref.beta.numpy(), 4)
        np.testing.assert_allclose(beta.numpy(), ref.beta.numpy(),
                                   atol=1e-5)
    # the warm state is the path's last solve
    assert torch.equal(sess._gwarm[2], gp.results[-1].beta_slots)


def test_saif_config_maps_onto_the_group_config():
    X, y = _make(14)
    scfg = rt.SaifConfig(eps=1e-7, inner_epochs=3, polish_factor=4,
                         k_max=12, max_outer=50)
    sess = rt.open_session(rt.Problem(X=X, y=y, penalty=rt.group(4)), scfg,
                           device="cpu")
    from repro.core.saif import SaifConfig as JS
    jsess = JA.open_session(JA.Problem(X=X, y=y, penalty=JA.group(4)),
                            JS(eps=1e-7, inner_epochs=3, polish_factor=4,
                               k_max=12, max_outer=50))
    assert dataclasses.asdict(sess.config) == dataclasses.asdict(
        jsess.config)
    assert sess._gprep.k_max == jsess._gprep.k_max == 12
    lam = 0.3 * _glm(X, y, 4)
    _held(sess.solve(rt.Scalar(lam)), jsess.solve(JA.Scalar(lam)), 4, 1e-7)


REFUSALS = {
    "fleet": lambda m, X, y: m.Fleet(Y=np.stack([y, y]), lams=1.0),
    "cv": lambda m, X, y: m.CV(n_folds=3, lams=(1.0,)),
    "update": lambda m, X, y: m.Update(rows=X[:2], responses=y[:2]),
    "select": lambda m, X, y: m.Select(lams=(1.0,)),
    "sharded_scalar": lambda m, X, y: m.Scalar(1.0, sharded=True),
    "sharded_path": lambda m, X, y: m.Path((2.0, 1.0), sharded=True),
}


@pytest.mark.parametrize("kind", sorted(REFUSALS))
def test_group_request_refusals(kind):
    X, y = _make(15)
    sess, jsess = _sessions(X, y, 4, 1e-8)
    with pytest.raises(Exception) as ref:
        jsess.solve(REFUSALS[kind](JA, X, y))
    with pytest.raises(type(ref.value)) as mine:
        sess.solve(REFUSALS[kind](rt, X, y))
    assert str(mine.value) == _strip(str(ref.value))
    assert ref.type is NotImplementedError


@pytest.mark.parametrize("kind", ["no_y", "weights", "pad_to"])
def test_group_open_refusals(kind):
    X, y = _make(16)
    kw = {"no_y": dict(y=None), "weights": dict(weights=np.ones(40)),
          "pad_to": {}}[kind]
    extra = {"pad_to": (40, 128)} if kind == "pad_to" else {}
    with pytest.raises(Exception) as ref:
        JA.open_session(JA.Problem(**{"X": X, "y": y, **kw},
                                   penalty=JA.group(4)),
                        JG.GroupSaifConfig(), **extra)
    with pytest.raises(type(ref.value)) as mine:
        rt.open_session(rt.Problem(**{"X": X, "y": y, **kw},
                                   penalty=rt.group(4)),
                        G.GroupSaifConfig(), device="cpu", **extra)
    assert str(mine.value) == _strip(str(ref.value))


# ---------------------------------------------------------------------------
# serving and the server (tests/test_serving_chaos.py:208-214)
# ---------------------------------------------------------------------------

def test_group_serving_verdicts():
    """A group Scalar is gap-certified with no scalar KKT; a group solve
    that misses its own eps is a failed, typed verdict whose rungs all
    skip (the reference has no group rung), as in the reference."""
    rng = np.random.default_rng(12345)
    X = rng.uniform(-10, 10, (30, 64))
    y = X[:, :8] @ rng.uniform(-1, 1, 8) + rng.normal(size=30)
    srv = rt.open_serving(rt.Problem(X=X, y=y, penalty=rt.group(8)),
                          G.GroupSaifConfig(eps=1e-6), device="cpu")
    outg = srv.solve(rt.Scalar(2.0))
    assert outg.verdict.ok and outg.verdict.kkt_residual == 0.0
    jout = j_open_serving(JA.Problem(X=X, y=y, penalty=JA.group(8)),
                          JG.GroupSaifConfig(eps=1e-6)).solve(JA.Scalar(2.0))
    _held(outg.value, jout.value, 8, 1e-6)
    outp = srv.solve(rt.Path([4.0, 2.0]))
    assert outp.verdict.ok and outp.verdict.unit_ok == (True, True)
    tight = rt.open_serving(rt.Problem(X=X, y=y, penalty=rt.group(8)),
                            G.GroupSaifConfig(eps=1e-14, max_outer=4),
                            device="cpu")
    outt = tight.solve(rt.Scalar(2.0))
    jt = j_open_serving(JA.Problem(X=X, y=y, penalty=JA.group(8)),
                        JG.GroupSaifConfig(eps=1e-14, max_outer=4)
                        ).solve(JA.Scalar(2.0))
    assert not outt.verdict.ok and outt.verdict.rungs
    assert [(r.name, r.note) for r in outt.verdict.rungs] == \
        [(r.name, r.note) for r in jt.verdict.rungs]
    assert outt.verdict.events == jt.verdict.events
    assert tight.session._gwarm is None          # scrubbed
    assert not tight.breaker_open


def test_scrub_warm_resets_gwarm():
    X, y = _make(17)
    srv = rt.open_serving(rt.Problem(X=X, y=y, penalty=rt.group(4)),
                          G.GroupSaifConfig(eps=1e-8), device="cpu")
    lam = 0.3 * _glm(X, y, 4)
    assert srv.solve(rt.Scalar(lam)).verdict.ok
    assert srv.session._gwarm is not None
    events = []
    srv._scrub_warm(rt.Scalar(lam), events)
    assert srv.session._gwarm is None and events == ["warm_state_reset"]
    srv.solve(rt.Scalar(lam))
    srv._scrub_warm(rt.Fleet(Y=np.stack([y]), lams=lam), events)
    assert srv.session._gwarm is not None        # not a serial request


def test_group_scalar_through_the_server():
    """A group Scalar rides its own session, uncoalesced (the reference's
    ``_is_lasso`` rule), and equals the session's solve bit for bit."""
    X, y = _make(18)
    lam = 0.3 * _glm(X, y, 4)
    prob = rt.Problem(X=X, y=y, penalty=rt.group(4))
    server = rt.open_server(autostart=False, device="cpu")
    futs = [server.submit(prob, rt.Scalar(lam)),
            server.submit(prob, rt.Scalar(0.5 * lam))]
    server.run(timeout=0)
    sess = rt.open_session(prob, device="cpu")
    for fut, l in zip(futs, (lam, 0.5 * lam)):
        value, verdict = fut.result()
        assert verdict.ok and verdict.kkt_residual == 0.0
        assert torch.equal(value.beta, sess.solve(rt.Scalar(l)).beta)
    st = server.stats()
    assert (st.served, st.coalesced_batches, st.coalesced_requests) == \
        (2, 0, 0)
    server.close()


# ---------------------------------------------------------------------------
# the card: no fallback
# ---------------------------------------------------------------------------

def test_device_none_raises_without_a_card(monkeypatch):
    X, y = _make(19)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.open_session(rt.Problem(X=X, y=y, penalty=rt.group(4)))
    with pytest.raises(RuntimeError, match="CUDA"):
        G.prepare_group(X, y, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.group_prep_from_numpy(X, y, np.ones(30), np.ones(30), 4, 4,
                                      30)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with pytest.raises(RuntimeError, match="CUDA"):
            rt.group_saif(X, y, 1.0, 4)


def _meta_burst(n=40, live=8, k=8, gsize=4, dt=torch.float64):
    m = torch.device("meta")
    return (torch.empty(live, gsize, n, dtype=dt, device=m),
            torch.empty(n, dtype=dt, device=m),
            torch.arange(live, device=m),
            torch.zeros(k, gsize, dtype=dt, device=m),
            torch.ones(k, dtype=dt, device=m), 1.0, 5)


def test_faked_card_wrapper_raises_not_plain(monkeypatch):
    """On tensors that are not on the CPU (``meta`` stands in for the card
    here) B-n3's wrapper goes to its kernel: with no nvcc that is a
    ``KernelBuildError``, never the plain version, and nothing counts as a
    launch; ``group_solve`` under ``auto`` raises the same (``nonzero`` on
    ``meta`` tensors is told to assume every slot live)."""
    def no_nvcc(name):
        raise _build.KernelBuildError(f"nvcc not found (building {name})")
    monkeypatch.setattr(_build, "library", no_nvcc)
    monkeypatch.setattr(torch.fx.experimental._config,
                        "meta_nonzero_assume_all_nonzero", True)
    ops.reset_launch_counts()
    with pytest.raises(_build.KernelBuildError):
        group_bcd(*_meta_burst())
    m = torch.device("meta")
    prep = G.GroupPrep(X=torch.empty(40, 120, dtype=torch.float64, device=m),
                       y=torch.empty(40, dtype=torch.float64, device=m),
                       c0=torch.empty(30, dtype=torch.float64, device=m),
                       gfro=torch.empty(30, dtype=torch.float64, device=m),
                       gsize=4, h=4, k_max=30)
    with pytest.raises(_build.KernelBuildError):
        G.group_solve(prep, 1.0, warm=(torch.zeros(30, dtype=torch.long,
                                                    device=m),
                                       torch.ones(30, dtype=torch.bool,
                                                  device=m),
                                       torch.zeros(30, 4, dtype=torch.float64,
                                                   device=m)))
    assert ops.launch_counts()["group_bcd"] == 0


def test_shared_memory_gate():
    """The gate refuses what one CTA cannot hold, naming the shape, before
    any build; the smoke's shape (n = 1000, 1024 groups of 10, f64) fits."""
    top = GATE_TOP_F64
    assert group_smem_ok(1000, 1024, 10, 8)
    assert group_smem_ok(1000, top, 10, 8)
    assert not group_smem_ok(1000, top + 1, 10, 8)
    assert group_smem_ok(1000, top + 1, 10, 4)
    assert not group_smem_ok(40, 8, 257, 8) and not group_smem_ok(40, 8, 0)
    with pytest.raises(ValueError,
                       match=f"{top + 1} groups of 10 over 1000 rows"):
        group_bcd(*_meta_burst(n=1000, k=top + 1, gsize=10))
    with pytest.raises(ValueError, match="multiple of the group size"):
        G.prepare_group(*_make(20), 7, device="cpu")
    for backend in ("pallas", "cuda"):
        with pytest.raises(ValueError, match="unknown group backend"):
            G.group_solve(G.prepare_group(*_make(20), 4, device="cpu"), 1.0,
                          backend=backend)


@pytest.mark.parametrize("n", [1, 511, 512, 513, 1000, 1024])
def test_reg_layout_pairs_each_thread_s_rows(n):
    """The register form's copy of the blocks: entry (j, c, t, r) is row
    t + 512 r of column c of block j, 0 past n, so that thread t loads its
    two rows of a column at once; the gathered blocks are left as they
    were."""
    g = torch.Generator().manual_seed(n)
    A = torch.randn(3, 4, n, generator=g, dtype=torch.float64)
    before = A.clone()
    R = reg_layout(A)
    assert R.shape == (3, 4, 512, 2) and R.is_contiguous()
    assert R.dtype == A.dtype
    flat = R.transpose(2, 3).reshape(3, 4, 1024)
    assert torch.equal(flat[..., :n], A)
    assert not flat[..., n:].any()
    assert torch.equal(A, before)


def _chunked_bytes(n, k, gsize, itemsize):
    """The chunked form's shared memory (the only form's before the
    register form): z, y, the gradients, beta, L, lam / L, the warp sums,
    v and d."""
    return (3 * n + k * gsize + 2 * k + 18 * gsize) * itemsize


@pytest.mark.parametrize("n,k,gsize,itemsize,form", [
    # the register form's column bound, and one past it, in either type
    (1000, 1024, 10, 8, "reg"), (1000, 1024, 11, 8, "chunked"),
    (1000, 1024, 10, 4, "reg"), (1000, 1024, 11, 4, "chunked"),
    # its rows a thread: one up to 512, two up to 1,024, then chunked
    (511, 64, 10, 8, "reg"), (512, 64, 10, 8, "reg"), (513, 64, 10, 8, "reg"),
    (1023, 64, 10, 8, "reg"), (1024, 64, 10, 8, "reg"),
    (1025, 64, 10, 8, "chunked"), (1, 1, 1, 8, "reg"),
    # its shared memory: 2,079 groups of 10 in float64, then none (the
    # chunked form's top at 1,000 rows is 1,868)
    (1000, 2079, 10, 8, "reg"), (1000, 2080, 10, 8, None),
    (1025, 1862, 10, 8, "chunked"), (1025, 1863, 10, 8, None),
    # few rows: the chunked form holds more slots than the register form
    (40, 4159, 4, 8, "reg"), (40, 4160, 4, 8, "chunked"),
    (40, 4234, 4, 8, "chunked"), (40, 4235, 4, 8, None),
    # group sizes no form takes
    (1000, 8, 0, 8, None), (1000, 8, 256, 8, "chunked"),
    (1000, 8, 257, 8, None),
])
def test_group_form_edges(n, k, gsize, itemsize, form):
    """``group_form`` at each edge of the register form (its column bound,
    its rows a thread, its shared memory) and of the chunked
    form beyond it; the gate admits exactly the shapes a form takes, every
    shape the chunked form alone admitted among them, and counts the
    chosen form's bytes."""
    assert group_form(n, k, gsize, itemsize) == form
    assert group_smem_ok(n, k, gsize, itemsize) == (form is not None)
    if (1 <= gsize <= 256
            and _chunked_bytes(n, k, gsize, itemsize) <= 200 * 1024):
        assert form is not None
    if form == "chunked":
        assert group_smem_bytes(n, k, gsize, itemsize) == _chunked_bytes(
            n, k, gsize, itemsize)
    elif form == "reg":
        assert group_smem_bytes(n, k, gsize, itemsize) == 16 + (
            k * gsize + 2 * k + 640) * itemsize


@pytest.mark.parametrize("n,gsize,dt,loss,entry", [
    (1000, 10, torch.float64, "least_squares", "group_bcd_reg_ls_f64"),
    (1000, 11, torch.float64, "least_squares", "group_bcd_ls_f64"),
    (1000, 10, torch.float32, "logistic", "group_bcd_reg_logit_f32"),
    (1000, 11, torch.float32, "least_squares", "group_bcd_ls_f32"),
    (1025, 10, torch.float32, "logistic", "group_bcd_logit_f32"),
])
def test_faked_card_asks_for_the_form_entry(monkeypatch, n, gsize, dt, loss,
                                            entry):
    """On a faked card the wrapper asks the built library for the entry of
    the form ``group_form`` picks, and counts no launch when there is
    none."""
    class NoEntries:
        def __getattr__(self, name):
            raise _build.KernelBuildError(f"no entry {name}")
    monkeypatch.setattr(_build, "library", lambda name: NoEntries())
    monkeypatch.setattr(torch.fx.experimental._config,
                        "meta_nonzero_assume_all_nonzero", True)
    ops.reset_launch_counts()
    with pytest.raises(_build.KernelBuildError, match=f"no entry {entry}$"):
        group_bcd(*_meta_burst(n=n, gsize=gsize, dt=dt), loss_name=loss)
    assert ops.launch_counts()["group_bcd"] == 0


def test_lazy_surface():
    import repro_torch.core as core
    assert rt.GroupSaifConfig is G.GroupSaifConfig
    assert rt.group_solve is G.group_solve and rt.group is rt.core.api.group
    for name in ("group_saif", "group_solve", "GroupSaifConfig",
                 "GroupSaifResult", "group_lambda_max",
                 "group_compile_count", "prepare_group",
                 "solve_group_lasso_bcd"):
        assert getattr(core, name) is getattr(G, name)
    assert core.group is G and "group_bcd" in ops.KERNELS
