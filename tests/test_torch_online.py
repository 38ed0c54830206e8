"""Online row updates of the port (``repro_torch.core.online``, the
session's Update arm) on the CPU: the port's edition of the streaming
cases of tests/test_online.py, on the same streams (``_stream_problem``
and ``_batch``, n0 = 24-64, p = 120, float64, ``device="cpu"``).

Each stream goes through both packages. Against the reference's streamed
result and the port's cold solve of the resident rows: the same support,
beta allclose at atol 1e-6 (the reference's own tolerance), gap <= eps.
The counters (``updates``, ``grows``, ``rebuilds``) and the events are the
reference's; a steady-state update makes no Gram carry rebuild. Plus the
admission and stream errors with the reference's messages, Select on the
current rows, ``gram_block_update`` against the reference's (rtol 1e-12),
the carry across an inner-backend switch, the padded-rows kernel gate of
a ``cuda`` stream, and the checkpoint digest after updates.
"""
import re

import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.core import api as J
from repro.core.saif import SaifConfig as JConfig
from repro_torch.core.inner_backend import make_inner_gram
from test_torch_saif import _one_torch_thread  # noqa: F401

INNER_REF = {"torch": "jnp", "gram": "gram", "cuda": "jnp"}


def _stream_problem(seed=0, n0=40, p=120, k=5, noise=0.1):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n0, p))
    beta = np.zeros(p)
    beta[:k] = rng.uniform(0.8, 1.6, k)
    y = X @ beta + noise * rng.normal(size=n0)
    return X, y, beta, rng


def _batch(rng, beta, m, noise=0.1):
    p = beta.shape[0]
    Xn = rng.normal(size=(m, p))
    return Xn, Xn @ beta + noise * rng.normal(size=m)


def _support(beta):
    return np.flatnonzero(np.abs(np.asarray(beta)) > 0)


def _pair(X, y, inner="gram", eps=1e-8, **kw):
    """The port's session and the reference's on the same problem."""
    mine = rt.open_session(rt.Problem(X=X, y=y), rt.SaifConfig(
        eps=eps, inner_backend=inner, **kw), device="cpu")
    ref = J.open_session(J.Problem(X=X, y=y), JConfig(
        eps=eps, inner_backend=INNER_REF[inner], **kw))
    return mine, ref


def _cold(X, y, lam, inner="gram", eps=1e-8):
    return rt.open_session(rt.Problem(X=X, y=y), rt.SaifConfig(
        eps=eps, inner_backend=inner), device="cpu").solve(rt.Scalar(lam))


def _held(res, jres, cold, eps=1e-8):
    b = res.beta.numpy()
    assert float(res.gap) <= eps
    for other in (np.asarray(jres.beta), cold.beta.numpy()):
        np.testing.assert_array_equal(_support(b), _support(other))
        np.testing.assert_allclose(b, other, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# parity: the reference's streamed result and the cold solve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("inner", ["torch", "gram", "cuda"])
def test_update_parity_vs_reference_and_cold(inner):
    X, y, bt, rng = _stream_problem(seed=0)
    lam = 0.2 * float(np.abs(X.T @ y).max())
    sess, jsess = _pair(X, y, inner)
    sess.solve(rt.Scalar(lam))
    jsess.solve(J.Scalar(lam))
    rebuilds = 0
    Xs, ys = X, y
    for _ in range(4):
        Xn, yn = _batch(rng, bt, m=8)
        r0 = make_inner_gram.rebuilds
        res = sess.update(rows=Xn, responses=yn, lam=lam)
        rebuilds += make_inner_gram.rebuilds - r0
        jres = jsess.update(rows=Xn, responses=yn, lam=lam)
        # the warm re-solve takes the reference's outer steps (C5)
        assert res.n_outer == int(jres.n_outer)
        Xs, ys = np.vstack([Xs, Xn]), np.concatenate([ys, yn])
        _held(res, jres, _cold(Xs, ys, lam, inner))
    # the Gram carry was block-updated, never rebuilt
    assert rebuilds == 0
    st, jst = sess._online, jsess._online
    assert (st.n_cap, st.filled, st.head, st.updates, st.grows,
            st.rebuilds) == (jst.n_cap, jst.filled, jst.head, jst.updates,
                             jst.grows, jst.rebuilds)
    assert sess.drain_events() == jsess.drain_events() == (
        "online_stream_entered:n_cap=128",)
    assert sess._prep.n_true == 72 and sess._prep.X.shape == (128, 120)
    # the caller's arrays were never written
    assert np.array_equal(sess.problem.X, X)


@pytest.mark.parametrize("inner", ["torch", "gram"])
def test_window_parity_vs_reference_and_cold_tail(inner):
    X, y, bt, rng = _stream_problem(seed=4, n0=64)
    W = 64
    lam = 0.2 * float(np.abs(X.T @ y).max())
    sess, jsess = _pair(X, y, inner)
    sess.solve(rt.Scalar(lam))
    jsess.solve(J.Scalar(lam))
    rows_all, ys_all = [X], [y]
    for i in range(12):
        Xn, yn = _batch(rng, bt, m=8)
        rows_all.append(Xn)
        ys_all.append(yn)
        res = sess.update(rows=Xn, responses=yn, lam=lam, window=W)
        jres = jsess.update(rows=Xn, responses=yn, lam=lam, window=W)
        assert res.n_outer == int(jres.n_outer)       # C5
        if i % 4 == 3:
            Xs = np.vstack(rows_all)[-W:]
            ys = np.concatenate(ys_all)[-W:]
            _held(res, jres, _cold(Xs, ys, lam, inner))
    st, jst = sess._online, jsess._online
    assert (st.n_cap, st.filled, st.head, st.rebuilds) == \
        (jst.n_cap, jst.filled, jst.head, jst.rebuilds) == (64, 64, 32, 0)


def test_lam_default_and_resolve_false():
    X, y, bt, rng = _stream_problem(seed=1)
    lam = 0.25 * float(np.abs(X.T @ y).max())
    sess, jsess = _pair(X, y)
    sess.solve(rt.Scalar(lam))           # sets the session's last lambda
    jsess.solve(J.Scalar(lam))
    Xn, yn = _batch(rng, bt, m=4)
    res = sess.update(rows=Xn, responses=yn)          # lam: the last one
    jres = jsess.update(rows=Xn, responses=yn)
    _held(res, jres, _cold(np.vstack([X, Xn]), np.r_[y, yn], lam))
    # ingest only; the next request sees the new rows
    Xn2, yn2 = _batch(rng, bt, m=4)
    assert sess.update(rows=Xn2, responses=yn2, resolve=False) is None
    assert jsess.update(rows=Xn2, responses=yn2, resolve=False) is None
    res2, jres2 = sess.solve(rt.Scalar(lam)), jsess.solve(J.Scalar(lam))
    _held(res2, jres2, _cold(np.vstack([X, Xn, Xn2]), np.r_[y, yn, yn2],
                             lam))
    assert sess._online.updates == 2 and sess._last_lam == lam


def test_capacity_growth_equals_reference():
    X, y, bt, rng = _stream_problem(seed=3, n0=32)
    lam = 0.2 * float(np.abs(X.T @ y).max())
    sess, jsess = _pair(X, y)
    sess.solve(rt.Scalar(lam))
    jsess.solve(J.Scalar(lam))
    for _ in range(12):                      # 32 + 96 rows: cap 64 -> 128
        Xn, yn = _batch(rng, bt, m=8)
        res = sess.update(rows=Xn, responses=yn, lam=lam)
        jres = jsess.update(rows=Xn, responses=yn, lam=lam)
    assert sess._online.grows == jsess._online.grows == 1
    assert sess._online.n_cap == jsess._online.n_cap == 128
    ev = sess.drain_events()
    assert ev == jsess.drain_events()
    assert "online_capacity_grown:n_cap=128" in ev
    assert np.array_equal(_support(res.beta), _support(jres.beta))


def test_downdate_guard_trips_as_the_reference_does():
    """1e8-scale rows leaving the window cancel nearly all the incremental
    column mass: the guard recomputes the statistics exactly and marks
    the carry dirty at the same update as the reference, and the resolve
    on the clean tail holds against both."""
    X, y, bt, rng = _stream_problem(seed=5, n0=32)
    W = 32
    lam = 0.2 * float(np.abs(X.T @ y).max())
    sess, jsess = _pair(X, y)
    sess.solve(rt.Scalar(lam))
    jsess.solve(J.Scalar(lam))
    Xb = 1e8 * rng.normal(size=(16, X.shape[1]))
    yb = Xb @ bt
    for s in (sess, jsess):
        s.update(rows=Xb, responses=yb, window=W, resolve=False)
    assert sess.drain_events() == jsess.drain_events()
    rows_all, ys_all = [X, Xb], [y, yb]
    trips, jtrips = [], []
    r0 = make_inner_gram.rebuilds
    for i in range(4):
        Xn, yn = _batch(rng, bt, m=8)
        rows_all.append(Xn)
        ys_all.append(yn)
        res = sess.update(rows=Xn, responses=yn, lam=lam, window=W,
                          resolve=(i == 3))
        jres = jsess.update(rows=Xn, responses=yn, lam=lam, window=W,
                            resolve=(i == 3))
        trips.append(sess._online.rebuilds)
        jtrips.append(jsess._online.rebuilds)
        assert sess.drain_events() == jsess.drain_events()
    assert trips == jtrips and trips[-1] >= 1
    # the dirty carry was rebuilt by the engine's init, once
    assert make_inner_gram.rebuilds == r0 + 1
    Xs = np.vstack(rows_all)[-W:]
    ys = np.concatenate(ys_all)[-W:]
    _held(res, jres, _cold(Xs, ys, lam))


def test_zero_gram_rebuilds_at_steady_state():
    X, y, bt, rng = _stream_problem(seed=2, n0=64)
    lam = 0.2 * float(np.abs(X.T @ y).max())
    sess = rt.open_session(rt.Problem(X=X, y=y), rt.SaifConfig(
        eps=1e-8, inner_backend="gram"), device="cpu")
    sess.solve(rt.Scalar(lam))
    Xn, yn = _batch(rng, bt, m=8)
    sess.update(rows=Xn, responses=yn, lam=lam, window=64)   # warm-up
    r0 = make_inner_gram.rebuilds
    for _ in range(10):
        Xn, yn = _batch(rng, bt, m=8)
        res = sess.update(rows=Xn, responses=yn, lam=lam, window=64)
    assert make_inner_gram.rebuilds == r0
    assert rt.online_compile_count() == 0
    assert rt.unified_compile_count() == 0
    assert float(res.gap) <= 1e-8
    assert sess._online.updates == 11


# ---------------------------------------------------------------------------
# admission and stream errors: the reference's classes and messages
# ---------------------------------------------------------------------------

def _same_error(fn, jfn):
    with pytest.raises(Exception) as e:
        fn()
    with pytest.raises(Exception) as je:
        jfn()
    assert type(e.value).__name__ == type(je.value).__name__
    # the reference's messages cite its design notes; the port's do not
    assert str(e.value) == re.sub(r" ?\(DESIGN\.md §[0-9.]+\)", "",
                                  str(je.value))
    return e.value


def test_update_stream_errors_equal_reference():
    X, y, bt, rng = _stream_problem(seed=6, n0=24)
    lam = 0.3 * float(np.abs(X.T @ y).max())
    sess, jsess = _pair(X, y)
    sess.solve(rt.Scalar(lam))
    jsess.solve(J.Scalar(lam))
    Xn, yn = _batch(rng, bt, m=4)
    e = _same_error(
        lambda: sess.update(rt.Update(rows=Xn, responses=yn, lam=lam,
                                      window=8)),
        lambda: jsess.update(J.Update(rows=Xn, responses=yn, lam=lam,
                                      window=8)))
    assert isinstance(e, rt.RequestError) and "resident row count" in str(e)
    assert sess._online is None
    sess.update(rows=Xn, responses=yn, lam=lam, window=24)
    jsess.update(rows=Xn, responses=yn, lam=lam, window=24)
    e = _same_error(
        lambda: sess.update(rt.Update(rows=Xn, responses=yn, lam=lam,
                                      window=32)),
        lambda: jsess.update(J.Update(rows=Xn, responses=yn, lam=lam,
                                      window=32)))
    assert "mid-stream" in str(e)
    e = _same_error(
        lambda: sess.update(rows=np.ones((2, 7)), responses=np.ones(2),
                            lam=lam),
        lambda: jsess.update(rows=np.ones((2, 7)), responses=np.ones(2),
                             lam=lam))
    assert "columns" in str(e)
    # a first resolving update with no lambda anywhere
    X2, y2, _, _ = _stream_problem(seed=7, n0=24)
    s2, j2 = _pair(X2, y2)
    e = _same_error(lambda: s2.update(rows=Xn, responses=yn),
                    lambda: j2.update(rows=Xn, responses=yn))
    assert "first resolving update" in str(e)
    # a ring smaller than the warm state's live slots: the one host read
    # catches it and nothing is committed
    s3 = rt.open_session(rt.Problem(X=X, y=y), rt.SaifConfig(
        inner_backend="gram"), device="cpu")
    s3.update(rows=Xn, responses=yn, window=24, resolve=False)
    k = 32
    s3.set_warm_state((torch.arange(k), torch.zeros(k, dtype=torch.float64),
                       torch.ones(k, dtype=torch.bool),
                       rt.InnerCarry(G=torch.eye(k, dtype=torch.float64),
                                     rho=torch.zeros(k, dtype=torch.float64),
                                     gidx=torch.arange(k))), k)
    before = (s3._prep.X.clone(), s3._prep.c0.clone(), s3._online.head,
              s3._online.updates, s3._online.xty.clone(),
              s3.warm_state[3].G.clone())
    with pytest.raises(rt.RequestError, match="underdetermined"):
        s3.update(rows=Xn, responses=yn, lam=lam)
    assert torch.equal(s3._prep.X, before[0])
    assert torch.equal(s3._prep.c0, before[1])
    assert (s3._online.head, s3._online.updates) == before[2:4]
    assert torch.equal(s3._online.xty, before[4])
    assert torch.equal(s3.warm_state[3].G, before[5])


def test_update_eligibility_errors_equal_reference():
    X, y, bt, rng = _stream_problem(seed=8, n0=24, p=40)
    Xn, yn = _batch(rng, bt, m=4)
    lam = 0.3 * float(np.abs(X.T @ y).max())
    upd = dict(rows=Xn, responses=yn, lam=lam)
    parent = np.arange(40) - 1
    cases = [
        (dict(penalty=rt.fused(parent)), dict(penalty=J.fused(parent)), {}),
        (dict(loss="logistic", y=np.sign(y)),
         dict(loss="logistic", y=np.sign(y)), {}),
        (dict(weights=np.ones(24)), dict(weights=np.ones(24)), {}),
        ({}, {}, dict(pad_to=(32, 64))),
    ]
    for kw, jkw, skw in cases:
        yy = kw.pop("y", y)
        jkw.pop("y", None)
        loss = kw.get("loss", "least_squares")
        sess = rt.open_session(rt.Problem(X=X, y=yy, **kw),
                               rt.SaifConfig(loss=loss), device="cpu",
                               **skw)
        jsess = J.open_session(J.Problem(X=X, y=yy, **jkw),
                               JConfig(loss=loss), **skw)
        _same_error(lambda: sess.solve(rt.Update(**upd)),
                    lambda: jsess.solve(J.Update(**upd)))
        assert sess._online is None
    # a fleet-only session (no responses)
    e = _same_error(
        lambda: rt.open_session(rt.Problem(X=X), device="cpu").solve(
            rt.Update(**upd)),
        lambda: J.open_session(J.Problem(X=X)).solve(J.Update(**upd)))
    assert isinstance(e, rt.RequestError)


# ---------------------------------------------------------------------------
# the rest of the session around a stream
# ---------------------------------------------------------------------------

def test_select_on_streamed_session_uses_current_rows():
    X, y, bt, rng = _stream_problem(seed=30, n0=40, p=64, k=4)
    lam = 0.25 * float(np.abs(X.T @ y).max())
    cfg = rt.SaifConfig(eps=1e-7, inner_backend="gram")
    sess = rt.open_session(rt.Problem(X=X, y=y), cfg, device="cpu")
    jsess = J.open_session(J.Problem(X=X, y=y),
                           JConfig(eps=1e-7, inner_backend="gram"))
    sess.solve(rt.Scalar(lam))
    jsess.solve(J.Scalar(lam))
    Xs, ys = X, y
    for _ in range(3):
        Xn, yn = _batch(rng, bt, m=8)
        sess.update(rows=Xn, responses=yn, lam=lam)
        jsess.update(rows=Xn, responses=yn, lam=lam)
        Xs, ys = np.vstack([Xs, Xn]), np.concatenate([ys, yn])
    lams = tuple(np.geomspace(0.5, 0.05, 4)
                 * float(np.abs(Xs.T @ ys).max()))
    rep = sess.select(rt.Select(lams=lams, n_folds=3, stability=False,
                                seed=1))
    ref = rt.open_session(rt.Problem(X=Xs, y=ys), cfg, device="cpu").select(
        rt.Select(lams=lams, n_folds=3, stability=False, seed=1))
    jrep = jsess.select(J.Select(lams=lams, n_folds=3, stability=False,
                                 seed=1))
    assert np.array_equal(rep.cv_mean, ref.cv_mean)
    assert rep.lam == ref.lam == jrep.lam
    assert torch.equal(rep.beta, ref.beta)
    np.testing.assert_allclose(rep.cv_mean, np.asarray(jrep.cv_mean),
                               rtol=1e-10)
    np.testing.assert_allclose(rep.beta.numpy(), np.asarray(jrep.beta),
                               atol=1e-7)


def test_gram_block_update_equals_reference():
    import jax.numpy as jnp
    from repro.core.inner_backend import gram_block_update as j_update
    from repro_torch.core.inner_backend import gram_block_update
    rng = np.random.default_rng(0)
    k, m, p = 12, 5, 30
    A = rng.normal(size=(40, k))
    G = A.T @ A
    rho = rng.normal(size=k)
    gidx = rng.choice(p, k, replace=False)
    gidx[[1, 4, 7, 11]] = -1
    new, old = rng.normal(size=(m, p)), rng.normal(size=(m, p))
    yn, yo = rng.normal(size=m), rng.normal(size=m)
    t = torch.from_numpy
    G2, rho2 = gram_block_update(t(G), t(rho), t(gidx), t(new), t(yn),
                                 t(old), t(yo))
    jG2, jrho2 = j_update(jnp.asarray(G), jnp.asarray(rho),
                          jnp.asarray(gidx, jnp.int32), jnp.asarray(new),
                          jnp.asarray(yn), jnp.asarray(old), jnp.asarray(yo))
    np.testing.assert_allclose(G2.numpy(), np.asarray(jG2), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(rho2.numpy(), np.asarray(jrho2), rtol=1e-12,
                               atol=1e-12)
    dead = gidx < 0
    # entries of the dead slots are left exactly as they were
    assert np.array_equal(G2.numpy()[dead], G[dead])
    assert np.array_equal(rho2.numpy()[dead], rho[dead])
    # the live slots' ids passed in give the same result; zero old rows
    # (an append) subtract nothing
    live = torch.nonzero(t(gidx) >= 0).flatten()
    G3, _ = gram_block_update(t(G), t(rho), t(gidx), t(new), t(yn), t(old),
                              t(yo), live=live)
    assert torch.equal(G2, G3)
    G4, rho4 = gram_block_update(t(G), t(rho), t(gidx), t(new), t(yn),
                                 torch.zeros(m, p), torch.zeros(m))
    c = new[:, gidx[~dead]]
    np.testing.assert_allclose(G4.numpy()[np.ix_(~dead, ~dead)],
                               G[np.ix_(~dead, ~dead)] + c.T @ c,
                               rtol=1e-12)


def test_crossover_switch_rebuilds_the_carry_through_init():
    """``auto`` on the CPU runs the plain inner loop while 4 n < k_max;
    as the stream grows n it flips to the Gram engine, which must build
    its carry through ``init`` (the plain carry is (0, 0)), not read it."""
    X, y, bt, rng = _stream_problem(seed=9, n0=12, p=120)
    lam = 0.3 * float(np.abs(X.T @ y).max())
    cfg = rt.SaifConfig(eps=1e-8, k_max=64)
    sess = rt.open_session(rt.Problem(X=X, y=y), cfg, device="cpu")
    sess.solve(rt.Scalar(lam))
    assert sess.warm_state[3].G.shape == (0, 0)       # the plain carry
    r0 = make_inner_gram.rebuilds
    Xn, yn = _batch(rng, bt, m=2)                     # 4 * 14 < 64
    sess.update(rows=Xn, responses=yn, lam=lam)
    Xs, ys = np.vstack([X, Xn]), np.concatenate([y, yn])
    assert make_inner_gram.rebuilds == r0
    assert sess.warm_state[3].G.shape == (0, 0)
    Xn, yn = _batch(rng, bt, m=2)                     # 4 * 16 >= 64
    res = sess.update(rows=Xn, responses=yn, lam=lam)
    Xs, ys = np.vstack([Xs, Xn]), np.concatenate([ys, yn])
    assert make_inner_gram.rebuilds == r0 + 1
    assert sess.warm_state[3].G.shape == (64, 64)
    cold = rt.open_session(rt.Problem(X=Xs, y=ys), cfg,
                           device="cpu").solve(rt.Scalar(lam))
    assert float(res.gap) <= 1e-8
    np.testing.assert_array_equal(_support(res.beta), _support(cold.beta))
    np.testing.assert_allclose(res.beta.numpy(), cold.beta.numpy(),
                               atol=1e-6)
    # the next update keeps the Gram carry (block-updated, no rebuild)
    Xn, yn = _batch(rng, bt, m=2)
    r1 = make_inner_gram.rebuilds
    sess.update(rows=Xn, responses=yn, lam=lam)
    assert make_inner_gram.rebuilds == r1


def test_cuda_stream_raises_where_the_padded_rows_do_not_fit():
    """A ``cuda`` (K3) stream routes on the resident rows but hands the
    kernel the capacity-padded block: where that block exceeds K3's
    shared memory the re-solve raises (never the plain path), though the
    unpadded solve fits."""
    from repro_torch.kernels.cm.cm import cm_smem_ok
    rng = np.random.default_rng(10)
    n0, p = 4200, 24
    X = rng.normal(size=(n0, p))
    y = X[:, 0] - X[:, 1] + 0.1 * rng.normal(size=n0)
    lam = 0.3 * float(np.abs(X.T @ y).max())
    cfg = rt.SaifConfig(inner_backend="cuda", k_max=8)
    sess = rt.open_session(rt.Problem(X=X, y=y), cfg, device="cpu")
    assert float(sess.solve(rt.Scalar(lam)).gap) <= cfg.eps
    assert cm_smem_ok(n0 + 4, 8) and not cm_smem_ok(16384, 8)
    with pytest.raises(ValueError, match="shared-memory budget"):
        sess.update(rows=X[:4], responses=y[:4], lam=lam)
    assert sess._online.n_cap == 16384 and sess._online.filled == n0 + 4


def test_digest_resets_and_checkpoint_is_not_restored(tmp_path):
    """``content_digest`` names the resident rows: every committed update
    resets it, so a checkpoint taken after updates does not gate a fresh
    ``open_serving`` of the original problem (cold start), and the cache
    never serves a streaming session."""
    X, y, bt, rng = _stream_problem(seed=11, n0=32, p=60)
    lam = 0.25 * float(np.abs(X.T @ y).max())
    d = str(tmp_path / "stream")
    cache = rt.WarmCache(rt.WarmCacheConfig())
    srv = rt.open_serving(rt.Problem(X=X, y=y),
                          rt.SaifConfig(inner_backend="gram"), device="cpu",
                          serving=rt.ServingConfig(ckpt_dir=d),
                          warm_cache=cache)
    srv.solve(rt.Scalar(lam))
    d0 = srv.session.content_digest()
    assert srv.session._cache_eligible(rt.Scalar(lam))
    Xn, yn = _batch(rng, bt, m=4)
    srv.solve(rt.Update(rows=Xn, responses=yn, lam=lam))
    d1 = srv.session.content_digest()
    assert d1 != d0 and not srv.session._cache_eligible(rt.Scalar(lam))
    srv.solve(rt.Update(rows=Xn, responses=yn, lam=lam, resolve=False))
    assert srv.session._digest_memo is None
    assert srv.session.content_digest() not in (d0, d1)
    assert srv.checkpoint() is not None
    fresh = rt.open_serving(rt.Problem(X=X, y=y),
                            rt.SaifConfig(inner_backend="gram"),
                            device="cpu",
                            serving=rt.ServingConfig(ckpt_dir=d))
    assert not fresh.restored and fresh.session.warm_state is None
