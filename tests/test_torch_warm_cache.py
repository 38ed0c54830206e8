"""The cross-request homotopy cache of the port (``repro_torch.core.
warm_cache`` and the session's cache arm) on the CPU: the port's edition of
tests/test_online.py:266-370.

  * the LRU, its downward band ``lam <= lam0 <= band * lam`` and
    invalidation; the config's checks;
  * the digest is content-keyed and equal to the reference's on numpy
    inputs; a CPU tensor hashes as its numpy array;
  * a band hit enters through the Theorem-2 sequential-ball seed and ends
    certified (gap <= eps, KKT residual <= 1e-3 lambda, the reference
    serving layer's tolerance) with the cold session's support and beta
    within 1e-7, under each screen rule, and a 32-seed sweep has no
    violation; the cold (miss) path is bit for bit the cacheless session;
  * sessions the cache does not serve (warm requests, fused, weighted, a
    custom screen) leave it untouched.
"""
import numpy as np
import pytest
import torch

import repro_torch as rt
from conftest import make_regression
from repro.core.warm_cache import problem_digest as j_problem_digest
from repro_torch.core.warm_cache import problem_digest
from test_torch_saif import _one_torch_thread  # noqa: F401


def _support(beta):
    return np.flatnonzero(np.abs(beta.numpy()) > 0)


def _certified(X, y, res, lam, eps):
    kkt = float(rt.kkt_residual(rt.get_loss("least_squares"),
                                torch.from_numpy(X), torch.from_numpy(y),
                                res.beta, lam))
    return float(res.gap) <= eps and kkt <= max(1e-3 * lam, 1e-8)


def test_warm_cache_lru_band_and_invalidate():
    cache = rt.WarmCache(rt.WarmCacheConfig(capacity=2, band=2.0))
    d = "digest-a"
    cache.store(d, 1.0, ("warm1",), 8)
    # band: lam <= lam0 <= 2 lam
    assert cache.lookup(d, 0.6).lam0 == 1.0
    assert cache.lookup(d, 1.0).lam0 == 1.0       # an exact repeat hits
    assert cache.lookup(d, 0.4) is None           # 1.0 > 2 * 0.4
    assert cache.lookup(d, 2.0) is None           # upward: not certified
    assert cache.lookup("other", 0.6) is None
    cache.store(d, 0.8, ("warm2",), 8)            # the closest entry wins
    assert cache.lookup(d, 0.6).lam0 == 0.8
    cache.store(d, 0.5, ("warm3",), 8)            # LRU eviction
    assert len(cache) == 2
    st = cache.stats()
    assert st.evictions == 1 and st.puts == 3
    assert st.hits == 3 and st.misses == 3
    assert cache.invalidate(d, 0.5) == 1
    assert cache.invalidate(d) == 1
    assert len(cache) == 0 and cache.stats().invalidations == 2
    cache.store(d, 0.5, ("warm4",), 8)
    cache.clear()
    assert len(cache) == 0


def test_warm_cache_config_checks():
    with pytest.raises(ValueError, match="capacity"):
        rt.WarmCacheConfig(capacity=0)
    with pytest.raises(ValueError, match="band"):
        rt.WarmCacheConfig(band=0.5)
    assert rt.WarmCache().config == rt.WarmCacheConfig()


def test_problem_digest_is_content_keyed():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(8, 5))
    y = rng.normal(size=8)
    d = problem_digest(X, y)
    assert d == problem_digest(X.copy(), y.copy())
    assert d != problem_digest(X + 1e-9, y)
    assert d != problem_digest(X.astype(np.float32), y.astype(np.float32))
    assert d == j_problem_digest(X, y)                  # the reference's
    assert d == problem_digest(torch.from_numpy(X), torch.from_numpy(y))
    Xt = torch.from_numpy(X)
    assert problem_digest(Xt.T.contiguous().T, y) == d  # bytes, not layout


def _problem(seed, n=60, p=200):
    X, y, _ = make_regression(np.random.default_rng(seed), n=n, p=p,
                              uniform=False)
    return X, y, float(np.abs(X.T @ y).max())


@pytest.mark.parametrize("rule", ["saif", "gap_safe", "hybrid"])
def test_warm_cache_hit_certified_with_cold_support(rule):
    X, y, lm = _problem(10)
    cfg = rt.SaifConfig(eps=1e-8, inner_backend="gram", screen_rule=rule)
    cache = rt.WarmCache(rt.WarmCacheConfig())
    prob = rt.Problem(X=X, y=y)
    sess = rt.open_session(prob, cfg, device="cpu", warm_cache=cache)
    bare = rt.open_session(prob, cfg, device="cpu")

    first = sess.solve(rt.Scalar(0.3 * lm))          # a miss: the cold path
    assert sess.drain_events() == ("warm_cache_miss",)
    cold_first = bare.solve(rt.Scalar(0.3 * lm))
    for f in ("beta", "gap", "active_idx", "active_mask", "trace_gap"):
        assert torch.equal(getattr(first, f), getattr(cold_first, f)), f
    assert first.n_outer == cold_first.n_outer

    hit = sess.solve(rt.Scalar(0.21 * lm))
    events = sess.drain_events()
    assert len(events) == 1 and events[0].startswith("warm_cache_hit")
    assert sess.drain_events() == ()
    assert cache.stats().hits == 1 and cache.stats().misses == 1
    cold = bare.solve(rt.Scalar(0.21 * lm))
    assert _certified(X, y, hit, 0.21 * lm, cfg.eps)
    np.testing.assert_array_equal(_support(hit.beta), _support(cold.beta))
    np.testing.assert_allclose(hit.beta.numpy(), cold.beta.numpy(),
                               atol=1e-7)
    # the hit skipped cold growth: no more outer steps than the cold solve
    assert hit.n_outer <= cold.n_outer
    # a Path request rides the cache the same way (entry at its largest
    # lambda, the exit stored at its smallest)
    pr = sess.solve(rt.Path((0.2 * lm, 0.15 * lm)))
    assert sess.drain_events()[0].startswith("warm_cache_hit")
    for r, lam in zip(pr.results, pr.lams):
        assert _certified(X, y, r, lam, cfg.eps)
    assert len(cache) == 3


def test_warm_cache_32_seed_safety_sweep():
    """Across 32 seeds the cached entry gives a certified result with the
    cacheless support: no safety violation. One shared cache."""
    cfg = rt.SaifConfig(eps=1e-8, inner_backend="gram")
    cache = rt.WarmCache(rt.WarmCacheConfig(capacity=64))
    violations = []
    for seed in range(32):
        X, y, lm = _problem(1000 + seed, n=40, p=96)
        prob = rt.Problem(X=X, y=y)
        sess = rt.open_session(prob, cfg, device="cpu", warm_cache=cache)
        sess.solve(rt.Scalar(0.35 * lm))
        res = sess.solve(rt.Scalar(0.25 * lm))
        hit = any(e.startswith("warm_cache_hit")
                  for e in sess.drain_events())
        bare = rt.open_session(prob, cfg, device="cpu").solve(
            rt.Scalar(0.25 * lm))
        same = np.array_equal(_support(res.beta), _support(bare.beta))
        ok = _certified(X, y, res, 0.25 * lm, cfg.eps)
        if not (ok and hit and same):
            violations.append((seed, ok, hit, same))
    assert not violations, violations
    assert cache.stats().hits >= 32


def test_warm_cache_skips_ineligible_sessions():
    X, y, lm = _problem(11, n=40, p=80)
    cache = rt.WarmCache()
    cfg = rt.SaifConfig(inner_backend="gram")
    sess = rt.open_session(rt.Problem(X=X, y=y), cfg, device="cpu",
                           warm_cache=cache)
    sess.solve(rt.Scalar(0.3 * lm))
    assert len(cache) == 1
    # warm=True continues the session's own state, not the cache
    sess.solve(rt.Scalar(0.2 * lm, warm=True))
    assert cache.stats().hits == 0 and len(cache) == 1
    # weighted, fused and custom-screen sessions never touch it
    w = np.ones(40)
    rt.open_session(rt.Problem(X=X, y=y, weights=w), cfg, device="cpu",
                    warm_cache=cache).solve(rt.Scalar(0.3 * lm))
    parent = np.arange(80) - 1
    rt.open_session(rt.Problem(X=X, y=y, penalty=rt.fused(parent)),
                    rt.SaifConfig(), device="cpu",
                    warm_cache=cache).solve(rt.Scalar(0.3 * lm))
    st = cache.stats()
    assert (st.hits, st.misses, st.puts, len(cache)) == (0, 1, 1, 1)


def test_drop_cache_entry():
    X, y, lm = _problem(12, n=40, p=80)
    cache = rt.WarmCache()
    sess = rt.open_session(rt.Problem(X=X, y=y), rt.SaifConfig(),
                           device="cpu", warm_cache=cache)
    assert sess.drop_cache_entry() == 0                 # nothing stored yet
    sess.solve(rt.Scalar(0.3 * lm))
    assert len(cache) == 1
    assert sess.drop_cache_entry() == 1
    assert len(cache) == 0 and sess.drop_cache_entry() == 0
    no_cache = rt.open_session(rt.Problem(X=X, y=y), device="cpu")
    assert no_cache.drop_cache_entry() == 0
