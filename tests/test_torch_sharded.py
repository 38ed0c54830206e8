"""Feature-sharded SAIF (``repro_torch.distributed.saif_sharded``) on the
CPU, over gloo: the port's edition of the reference's sharded tests
(tests/test_api.py's 1-device-mesh sessions, tests/test_distribution.py).

At W = 1 the cases run in this process, in a gloo group of one that a
module fixture makes and destroys. At W = 2 and 4 each world size runs
all its cases once, in spawned ranks (``torch.multiprocessing``, a
``file://`` store, one torch thread a rank, a group timeout, the parent
joining with a timeout), and the tests read their verdicts. Shapes are
the reference's CI sizes (n = 30-50, p = 120-301, float64), where the
plain scan of a contiguous shard gives the full scan's bits. The ranks
import this module, so it imports the reference (and with it jax) only
inside the tests that compare with it.

Contracts:
  * the sharded screen equals ``make_screen_torch`` on the full X on every
    finite candidate, in its counts, max ub and survivors (p a multiple
    of W and not, p_local < h, pads, every column active), and the fleet
    screen equals the serial one per problem;
  * a sharded Scalar (least squares and logistic), warm Scalar, Path,
    Fleet (B = 3, ``gram``) and fused Scalar are bit for bit the port's
    unsharded session answers, with the same ``n_outer``;
  * against the reference: its 1-device-mesh session at atol 1e-8, its
    plain ``saif`` at atol 1e-6 with the same support; its
    ``make_sharded_scan`` and ``make_fused_screen``;
  * the legacy frontends warn once; the refusals keep the reference's
    messages; serving scrubs the sharded warm state and skips the grow
    rung; the server does not coalesce a sharded Scalar; an Update after
    a sharded request raises; ``launch/serve.py --device cpu`` exits 0.
"""
import os
import subprocess
import sys
import tempfile
import warnings

import numpy as np
import pytest
import torch

import repro_torch as rt
from repro_torch.core import _compat
from repro_torch.core.screen_backend import make_screen_torch
from repro_torch.distributed import saif_sharded as ss

EPS = 1e-7
SPAWN_TIMEOUT_S = 240
# a world size's cases, read by the tests below
CASES = ["screen/p_multiple", "screen/p_ragged", "screen/p_local_lt_h",
         "screen/all_active", "screen/batch", "scalar/least_squares",
         "scalar/logistic", "scalar/warm", "path", "fleet",
         "fleet/standalone", "fused"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the spawned ranks run (and the CPU path's
    tiny ops gain nothing from more)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_regression(rng, n, p, uniform=True):
    """conftest.make_regression's law (paper Sec 5.1.1, scaled down), here
    so that the ranks need not import conftest (and jax)."""
    X = rng.uniform(-10, 10, (n, p)) if uniform else rng.normal(0, 1, (n, p))
    beta = np.zeros(p)
    k = max(int(0.2 * p), 1)
    beta[rng.choice(p, k, replace=False)] = rng.uniform(-1, 1, k)
    return X, X @ beta + rng.normal(0, 1, n), beta


def make_classification(rng, n, p, k=10):
    """conftest.make_classification's law."""
    X = rng.normal(0, 1, (n, p))
    beta = np.zeros(p)
    beta[rng.choice(p, k, replace=False)] = rng.uniform(-2, 2, k)
    y = np.sign(X @ beta + 0.3 * rng.normal(0, 1, n))
    y[y == 0] = 1.0
    return X, y, beta


def _problem(seed=0, n=40, p=160):
    X, y, _ = make_regression(np.random.default_rng(seed), n=n, p=p)
    return X, y, float(np.abs(X.T @ y).max())


def _same_result(a, b):
    """Two SaifResults bit for bit (every tensor field, the carry too)."""
    for f, x, y in zip(a._fields, a, b):
        if isinstance(x, torch.Tensor):
            if not torch.equal(x, y):
                return False
        elif isinstance(x, tuple):
            if not all(torch.equal(u, v) for u, v in zip(x, y)):
                return False
        elif x != y:
            return False
    return True


# ---------------------------------------------------------------------------
# the cases, run at every world size (in process at W = 1, else per rank)
# ---------------------------------------------------------------------------

def _screen_case(mesh, n, p, h, seed, active_frac=0.2):
    """The sharded screen against the plain screen on the full X, on a
    random theta, radius and active set; True when equal on every finite
    candidate, in the counts, max ub and survivors."""
    rng = np.random.default_rng(seed)
    X = torch.from_numpy(rng.normal(size=(n, p)))
    g0 = torch.from_numpy(rng.normal(size=n))
    design = ss.shard_design(X, g0, mesh, "cpu")
    cn = design.col_norm[:p]
    p_pad = design.shape[1]
    theta = torch.from_numpy(rng.normal(size=n)) / 10.0
    r = torch.tensor(0.05, dtype=torch.float64)
    act = torch.from_numpy(rng.random(p) < active_frac)
    act_pad = torch.ones(p_pad, dtype=torch.bool)
    act_pad[:p] = act
    full = make_screen_torch(X, cn, h)(theta, r, act)
    mine = ss.make_sharded_screen(design, h)(theta, r, act_pad)
    fin = torch.isfinite(full.cand_score)
    return bool(torch.equal(full.cand_score, mine.cand_score)
                and torch.equal(full.cand_idx[fin], mine.cand_idx[fin])
                and bool((mine.cand_idx[~fin] >= p).all())
                and torch.equal(full.cand_lb, mine.cand_lb)
                and torch.equal(full.cand_ge, mine.cand_ge)
                and torch.equal(full.max_ub, mine.max_ub)
                and torch.equal(full.n_surv, mine.n_surv)
                and torch.equal(design.c0[:p], torch.abs(X.T @ g0))
                and torch.equal(cn, torch.linalg.vector_norm(X, dim=0)))


def _batch_screen_case(mesh, seed=7):
    """The sharded fleet screen, per problem, against the sharded serial
    screen and the plain screen (a skipped problem in the middle)."""
    rng = np.random.default_rng(seed)
    n, p, h = 30, 121, 16
    X = torch.from_numpy(rng.normal(size=(n, p)))
    design = ss.shard_design(X, torch.ones(n, dtype=torch.float64), mesh,
                             "cpu")
    p_pad = design.shape[1]
    thetas = [torch.from_numpy(rng.normal(size=n)) / 10.0 for _ in range(3)]
    rs = [torch.tensor(v, dtype=torch.float64) for v in (0.01, 0.2, 0.05)]
    acts = []
    for _ in range(3):
        a = torch.ones(p_pad, dtype=torch.bool)
        a[:p] = torch.from_numpy(rng.random(p) < 0.3)
        acts.append(a)
    do = [True, False, True]
    outs = ss.make_sharded_screen_batch(design, h)(thetas, rs, acts, do)
    serial = ss.make_sharded_screen(design, h)
    for i in (0, 2):
        one = serial(thetas[i], rs[i], acts[i])
        full = make_screen_torch(X, design.col_norm[:p], h)(
            thetas[i], rs[i], acts[i][:p])
        fin = torch.isfinite(full.cand_score)
        if not all(torch.equal(a, b) for a, b in zip(outs[i], one)):
            return False
        if not (torch.equal(full.cand_idx[fin], one.cand_idx[fin])
                and torch.equal(full.cand_ge, one.cand_ge)
                and torch.equal(full.n_surv, one.n_surv)):
            return False
    return bool(outs[1].max_ub == -torch.inf)


def _session_cases(mesh):
    """Every sharded request against the same session's unsharded one."""
    out = {}
    X, y, lm = _problem(3, n=40, p=161)
    cfg = rt.SaifConfig(eps=EPS, inner_backend="gram")
    sess = rt.open_session(rt.Problem(X=X, y=y), cfg, mesh=mesh,
                           device="cpu")
    a = sess.solve(rt.Scalar(0.3 * lm))
    b = sess.solve(rt.Scalar(0.3 * lm, sharded=True))
    out["scalar/least_squares"] = _same_result(a, b)
    aw = sess.solve(rt.Scalar(0.2 * lm, warm=True))
    bw = sess.solve(rt.Scalar(0.2 * lm, warm=True, sharded=True))
    out["scalar/warm"] = _same_result(aw, bw)
    lams = (0.5 * lm, 0.3 * lm, 0.15 * lm)
    pa = sess.solve(rt.Path(lams))
    pb = sess.solve(rt.Path(lams, sharded=True))
    out["path"] = all(_same_result(u, v) for u, v in zip(pa.results,
                                                         pb.results))
    Xc, yc, _ = make_classification(np.random.default_rng(4), n=50, p=130)
    lmc = float(rt.lambda_max(rt.get_loss("logistic"), torch.from_numpy(Xc),
                              torch.from_numpy(yc)))
    sl = rt.open_session(rt.Problem(X=Xc, y=yc, loss="logistic"),
                         rt.SaifConfig(eps=EPS, loss="logistic"), mesh=mesh,
                         device="cpu")
    out["scalar/logistic"] = _same_result(
        sl.solve(rt.Scalar(0.3 * lmc)),
        sl.solve(rt.Scalar(0.3 * lmc, sharded=True)))
    # the reference's fleet case (tests/test_distribution.py:238)
    rng = np.random.default_rng(5)
    Xf = rng.uniform(-10, 10, (30, 240))
    Ys, fl = [], []
    for i in range(3):
        w = np.zeros(240)
        w[rng.choice(240, 12, replace=False)] = rng.uniform(-1, 1, 12)
        Ys.append(Xf @ w + rng.normal(0, 1, 30))
        fl.append((0.05 + 0.05 * i) * float(np.max(np.abs(Xf.T @ Ys[-1]))))
    sf = rt.open_session(rt.Problem(X=Xf), cfg, mesh=mesh, device="cpu")
    fa = sf.solve(rt.Fleet(Y=np.stack(Ys), lams=fl))
    out["fleet"] = _same_result(
        fa, sf.solve(rt.Fleet(Y=np.stack(Ys), lams=fl, sharded=True)))
    # the standalone driver: its own placement, c0 from each rank's columns
    out["fleet/standalone"] = _same_result(fa, ss.fleet_solve_sharded(
        Xf, np.stack(Ys), fl, mesh, cfg, device="cpu"))
    Xu, yu, _ = make_regression(np.random.default_rng(6), n=40, p=60,
                                uniform=False)
    parent = np.arange(60) - 1
    su = rt.open_session(rt.Problem(X=Xu, y=yu, penalty=rt.fused(parent)),
                         rt.SaifConfig(eps=EPS), mesh=mesh, device="cpu")
    lmu = float(rt.fused_lambda_max(torch.from_numpy(Xu),
                                    torch.from_numpy(yu), parent,
                                    device="cpu"))
    (ba, ra), (bb, rb) = (su.solve(rt.Scalar(0.3 * lmu)),
                          su.solve(rt.Scalar(0.3 * lmu, sharded=True)))
    out["fused"] = torch.equal(ba, bb) and _same_result(ra, rb)
    return out


def _all_cases(mesh):
    W = mesh.mesh.numel()
    out = {"screen/p_multiple": _screen_case(mesh, 30, 40 * W, 16, 1),
           "screen/p_ragged": _screen_case(mesh, 40, 40 * W + 1, 32, 2),
           # h > p_local from W = 2 on (h <= p, as the engine's h is)
           "screen/p_local_lt_h": _screen_case(mesh, 30, 3 * W + 1,
                                               min(8, 3 * W + 1), 3),
           "screen/all_active": _screen_case(mesh, 30, 50, 8, 4,
                                             active_frac=1.1),
           "screen/batch": _batch_screen_case(mesh)}
    out.update(_session_cases(mesh))
    return out


def _rank_main(rank, world, store, out_dir):
    """One spawned rank: run every case, write its verdicts."""
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_group, make_host_mesh
    init_group(world, rank, store, timeout_s=60)
    try:
        res = _all_cases(make_host_mesh())
    finally:
        dist.destroy_process_group()
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


WORLDS = (2, 4)
_SPAWNED = {}


def _spawned(world):
    """The exit codes and verdicts of ``world`` spawned ranks. The first
    call starts the ranks of every world size in WORLDS together (each
    with its own store) and joins them all."""
    if not _SPAWNED:
        ctx = torch.multiprocessing.get_context("spawn")
        runs = {}
        for w in WORLDS:
            d = tempfile.mkdtemp(prefix=f"sharded-w{w}-")
            runs[w] = (d, [ctx.Process(target=_rank_main, args=(r, w, d, d))
                           for r in range(w)])
        for _, procs in runs.values():
            for pr in procs:
                pr.start()
        for _, procs in runs.values():
            for pr in procs:
                pr.join(SPAWN_TIMEOUT_S)
                if pr.is_alive():
                    pr.kill()
                    pr.join()
        for w, (d, procs) in runs.items():
            outs = [os.path.join(d, f"rank{r}.pt") for r in range(w)]
            _SPAWNED[w] = ([pr.exitcode for pr in procs],
                           [torch.load(f) if os.path.exists(f) else None
                            for f in outs])
    return _SPAWNED[world]


@pytest.fixture(scope="module")
def mesh1():
    """A gloo process group of one rank in this process, and its mesh."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_group, make_host_mesh
    init_group(1, 0, tempfile.mkdtemp(prefix="sharded-w1-"), timeout_s=60)
    try:
        yield make_host_mesh()
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def w1_cases(mesh1):
    return _all_cases(mesh1)


@pytest.mark.parametrize("case", CASES)
def test_world_of_one(w1_cases, case):
    assert w1_cases[case], case


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", CASES)
def test_spawned_ranks(world, case):
    codes, outs = _spawned(world)
    assert codes == [0] * world, codes
    assert all(o[case] for o in outs), (case, [o[case] for o in outs])


# ---------------------------------------------------------------------------
# against the reference (1-device mesh)
# ---------------------------------------------------------------------------

def _jmesh():
    import jax
    from jax.sharding import Mesh
    return Mesh(np.asarray(jax.devices()[:1]), ("feature",))


def test_against_reference(mesh1):
    """The reference's 1-device-mesh session at atol 1e-8 (Scalar, Path)
    and its plain ``saif`` at atol 1e-6 with the same support (its own bar,
    tests/test_distribution.py:228)."""
    import repro.core as J
    X, y, lm = _problem(8, n=40, p=160)
    lam = 0.25 * lm
    sess = rt.open_session(rt.Problem(X=X, y=y), rt.SaifConfig(eps=EPS),
                           mesh=mesh1, device="cpu")
    jsess = J.open_session(J.Problem(X=X, y=y), J.SaifConfig(eps=EPS),
                           mesh=_jmesh())
    res = sess.solve(rt.Scalar(lam, sharded=True))
    jres = jsess.solve(J.Scalar(lam, sharded=True))
    np.testing.assert_allclose(res.beta.numpy(), np.asarray(jres.beta),
                               atol=1e-8)
    plain = J.saif(X, y, lam, J.SaifConfig(eps=1e-8))
    np.testing.assert_allclose(res.beta.numpy(), np.asarray(plain.beta),
                               atol=1e-6)
    sup = set(np.flatnonzero(np.abs(res.beta.numpy()) > 1e-8).tolist())
    assert sup == set(np.flatnonzero(np.abs(np.asarray(plain.beta))
                                     > 1e-8).tolist())
    lams = (0.3 * lm, 0.2 * lm)
    pr = sess.solve(rt.Path(lams, sharded=True))
    jpr = jsess.solve(J.Path(lams, sharded=True))
    for b, jb, r in zip(pr.betas, jpr.betas, pr.results):
        assert b.shape == (X.shape[1],)
        np.testing.assert_allclose(b.numpy(), np.asarray(jb), atol=1e-8)
        assert float(r.gap) <= EPS


def test_fleet_against_reference(mesh1):
    import repro.core as J
    X, y, lm = _problem(9, n=30, p=120)
    Y = np.stack([y, y[::-1].copy()])
    lams = np.array([0.25 * lm, 0.2 * lm])
    sess = rt.open_session(rt.Problem(X=X), rt.SaifConfig(eps=1e-6),
                           mesh=mesh1, device="cpu")
    jsess = J.open_session(J.Problem(X=X), J.SaifConfig(eps=1e-6),
                           mesh=_jmesh())
    res = sess.solve(rt.Fleet(Y=Y, lams=lams, sharded=True))
    jres = jsess.solve(J.Fleet(Y=Y, lams=lams, sharded=True))
    np.testing.assert_allclose(res.beta.numpy(), np.asarray(jres.beta),
                               atol=1e-8)
    assert res.n_outer.tolist() == np.asarray(jres.n_outer).tolist()


def test_scan_and_fused_screen_against_reference(mesh1):
    """``make_sharded_scan`` and ``make_fused_screen`` against the
    reference's on a 1-device mesh."""
    import jax.numpy as jnp
    from repro.distributed import saif_sharded as jss
    rng = np.random.default_rng(10)
    n, p, h = 30, 120, 16
    X = rng.normal(size=(n, p))
    g0 = rng.normal(size=n)
    theta = rng.normal(size=n) / 10.0
    jd = jss.shard_design(jnp.asarray(X), jnp.asarray(g0), _jmesh())
    d = ss.shard_design(X, g0, mesh1, "cpu")
    np.testing.assert_allclose(d.col_norm.numpy(), np.asarray(jd.col_norm),
                               rtol=1e-14)
    np.testing.assert_allclose(d.c0.numpy(), np.asarray(jd.c0), rtol=1e-12)
    scan = ss.make_sharded_scan(d)(torch.from_numpy(theta))
    np.testing.assert_allclose(scan.numpy(), np.asarray(
        jss.make_sharded_scan(jd)(jnp.asarray(theta))), rtol=1e-12)
    fr = ss.make_fused_screen(d, h)(torch.from_numpy(theta), 0.1)
    jfr = jss.make_fused_screen(jd, h)(jnp.asarray(theta), 0.1)
    assert fr.top_idx.tolist() == np.asarray(jfr.top_idx).tolist()
    np.testing.assert_allclose(fr.top_scores.numpy(),
                               np.asarray(jfr.top_scores), rtol=1e-12)
    np.testing.assert_allclose(float(fr.max_ub), float(jfr.max_ub),
                               rtol=1e-12)
    # the scan hook drives a solve: saif(scan_fn=) equals the plain solve
    X2, y2, lm = _problem(11, n=30, p=120)
    d2 = ss.shard_design(X2, y2, mesh1, "cpu")
    a = rt.saif(X2, y2, 0.3 * lm, rt.SaifConfig(eps=EPS), device="cpu",
                scan_fn=ss.make_sharded_scan(d2))
    b = rt.saif(X2, y2, 0.3 * lm, rt.SaifConfig(eps=EPS), device="cpu")
    assert torch.equal(a.beta, b.beta)


# ---------------------------------------------------------------------------
# the frontends, refusals, serving, the server, updates, the CLI
# ---------------------------------------------------------------------------

def test_legacy_frontends_warn_once(mesh1):
    X, y, lm = _problem(12, n=30, p=120)
    _compat.reset_deprecation_warnings()
    cfg = rt.SaifConfig(eps=EPS)
    calls = [
        lambda: ss.saif_distributed(X, y, 0.3 * lm, mesh1, cfg,
                                    device="cpu"),
        lambda: ss.saif_batch_distributed(X, np.stack([y, y]), 0.3 * lm,
                                          mesh1, cfg, device="cpu"),
        lambda: ss.saif_fused_distributed(X, y, np.arange(120) - 1,
                                          0.5 * lm, mesh1, cfg,
                                          device="cpu")]
    sess = rt.open_session(rt.Problem(X=X, y=y), cfg, mesh=mesh1,
                           device="cpu")
    ref = sess.solve(rt.Scalar(0.3 * lm))
    for call in calls:
        with warnings.catch_warnings(record=True) as w1:
            warnings.simplefilter("always")
            first = call()
        with warnings.catch_warnings(record=True) as w2:
            warnings.simplefilter("always")
            call()
        assert [str(w.message) for w in w1
                if w.category is DeprecationWarning][0].count(
            "use repro_torch.open_session") == 1
        assert not [w for w in w2 if w.category is DeprecationWarning]
        if call is calls[0]:
            assert torch.equal(first.beta, ref.beta)
    assert torch.equal(ss.solve_scalar_sharded(X, y, 0.3 * lm, mesh1, cfg,
                                               device="cpu").beta, ref.beta)


def test_device_follows_the_inputs_not_the_mesh(mesh1, monkeypatch):
    """A gloo mesh picks the collective route only. On a faked card
    (``meta`` tensors stand in for it; the gather of a world of one is
    stubbed, since the host route cannot copy a meta tensor) the design
    stays where its inputs lie, X itself at W = 1; ``device="cpu"`` with
    such inputs raises instead of moving them; numpy inputs with
    ``device=None`` ask for the card and raise without one; a ``cuda``
    (NCCL) group refuses a design on the CPU."""
    from repro_torch.distributed import comm
    monkeypatch.setattr(comm, "all_gather_rows",
                        lambda fg, block: block[None])
    meta = torch.device("meta")
    X = torch.empty((30, 120), dtype=torch.float64, device=meta)
    y = torch.empty(30, dtype=torch.float64, device=meta)
    for design in (ss.shard_design(X, y, mesh1), ss.design_for(X, y, mesh1),
                   ss.fleet_design_for(X, mesh1)):
        assert design.device == meta and design.X_local is X
        assert design.col_norm.device == meta
    with pytest.raises(ValueError, match="does not move them to the host"):
        ss.design_for(X, y, mesh1, device="cpu")
    Xn, yn, _ = _problem(17, n=30, p=120)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="runs on a CUDA device"):
        ss.solve_scalar_sharded(Xn, yn, 1.0, mesh1)
    nccl = comm.FeatureGroup(pg=None, ranks=(0,), index=0, host=False)
    with pytest.raises(ValueError, match="cuda mesh"):
        ss.ShardedDesign(torch.zeros(3, 4), torch.ones(4), None, 4, None,
                         nccl)


def test_mesh_must_cover_every_rank(mesh1):
    from types import SimpleNamespace

    from repro_torch.distributed import comm
    part = SimpleNamespace(mesh=torch.tensor([[0, 1]]), device_type="cpu")
    with pytest.raises(ValueError, match="covers every rank"):
        comm.feature_group(part)


REFUSALS = {
    "weighted_scalar": (dict(weights=True), lambda lm: rt.Scalar(
        0.3 * lm, sharded=True), NotImplementedError,
        "weighted sharded solves: per-problem column norms live on the "
        "replicated path for now"),
    "weighted_fleet": ({}, lambda lm: "fleet_w", NotImplementedError,
                       "weighted sharded fleets: per-fold column norms live"),
    "cv": ({}, lambda lm: rt.CV(n_folds=3, lams=(0.3 * lm,), sharded=True),
           NotImplementedError, "sharded CV fleets: per-fold column norms "
           "live on the replicated path for now"),
    "group": (dict(group=True), lambda lm: rt.Scalar(lm, sharded=True),
              NotImplementedError, "sharded group screening is not "
              "implemented"),
    "no_mesh": (dict(no_mesh=True), lambda lm: rt.Scalar(0.3 * lm,
                                                         sharded=True),
                ValueError, "sharded=True needs a device mesh"),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusals(mesh1, name):
    """Each refusal with the reference's message (its "(DESIGN.md §8)"
    citation left out)."""
    X, y, lm = _problem(13, n=30, p=120)
    opts, make, err, msg = REFUSALS[name]
    kw = dict(y=y)
    if opts.get("weights"):
        kw["weights"] = np.ones(30)
    if opts.get("group"):
        kw["penalty"] = rt.group(4)
    sess = rt.open_session(rt.Problem(X=X, **kw), rt.SaifConfig(),
                           mesh=None if opts.get("no_mesh") else mesh1,
                           device="cpu")
    req = make(lm)
    if req == "fleet_w":
        req = rt.Fleet(Y=np.stack([y, y]), lams=0.3 * lm,
                       weights=np.ones((2, 30)), sharded=True)
    with pytest.raises(err, match=msg):
        sess.solve(req)


def test_serving_scrubs_the_sharded_warm_state(mesh1):
    """A NaN storm on a sharded Scalar: the grow rung is skipped, the
    oracle rung answers certified, the sharded warm state is reset and the
    unsharded one untouched; the same rungs and events as the reference's
    1-device-mesh serving session."""
    import repro.core as J
    import repro.core.serving as JS
    from repro.runtime.inject import FaultInjector as JInjector
    from repro_torch.runtime.inject import FaultInjector
    X, y, lm = _problem(14, n=30, p=80)
    lam = 0.25 * lm
    srv = rt.open_serving(rt.Problem(X=X, y=y), rt.SaifConfig(eps=EPS),
                          mesh=mesh1, device="cpu")
    srv.solve(rt.Scalar(lam))
    srv.solve(rt.Scalar(lam, sharded=True))
    sess = srv.session
    assert sess._sharded_warm is not None and sess._warm is not None
    with FaultInjector(nan_at=set(range(1, 30))) as inj:
        out = srv.solve(rt.Scalar(lam, warm=True, sharded=True))
    v = out.verdict
    assert v.ok and v.degraded
    assert "warm_state_reset" in v.events
    assert sess._sharded_warm is None and sess._sharded_warm_k is None
    assert sess._warm is not None
    assert "grow" not in [r.name for r in v.rungs if r.ok]
    jsrv = JS.open_serving(J.Problem(X=X, y=y), J.SaifConfig(eps=EPS),
                           mesh=_jmesh())
    jsrv.solve(J.Scalar(lam, sharded=True))
    with JInjector(nan_at=set(range(1, 30))) as jinj:
        jout = jsrv.solve(J.Scalar(lam, warm=True, sharded=True))
    assert inj.log == jinj.log
    assert [(r.name, r.ok) for r in v.rungs] == [
        (r.name, r.ok) for r in jout.verdict.rungs]
    assert v.events == jout.verdict.events
    assert srv.solve(rt.Scalar(lam, sharded=True)).verdict.ok


def test_server_does_not_coalesce_a_sharded_scalar(mesh1):
    X, y, lm = _problem(15, n=30, p=80)
    server = rt.open_server(autostart=False, max_batch=4, mesh=mesh1,
                            device="cpu", solver=rt.SaifConfig(eps=EPS))
    futs = [server.submit(rt.Problem(X=X, y=y), rt.Scalar(f * lm,
                                                           sharded=True))
            for f in (0.3, 0.25)]
    server.run(timeout=0)
    outs = [f.result(timeout=60) for f in futs]
    st = server.stats()
    server.close()
    assert all(o.verdict.ok for o in outs)
    assert st.coalesced_batches == 0 and st.served == 2


def test_update_after_a_sharded_request_raises(mesh1):
    X, y, lm = _problem(16, n=30, p=80)
    sess = rt.open_session(rt.Problem(X=X, y=y), rt.SaifConfig(eps=EPS),
                           mesh=mesh1, device="cpu")
    sess.solve(rt.Scalar(0.3 * lm, sharded=True))
    with pytest.raises(NotImplementedError,
                       match="would stale the sharded design placement"):
        sess.solve(rt.Update(rows=X[:2], responses=y[:2], lam=0.3 * lm))


def test_serve_cli_on_the_cpu():
    src = os.path.join(os.path.dirname(rt.__file__), os.pardir)
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--requests", "6", "--n", "48", "--p", "40"],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=os.path.abspath(src),
                 OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "6 certified ok" in r.stdout


def test_distributed_and_launch_import_cleanly():
    """``distributed/`` and ``launch/`` import neither jax nor repro, and
    importing them initialises no process group."""
    code = (
        "import sys, importlib\n"
        "for m in ('repro_torch.distributed.comm',\n"
        "          'repro_torch.distributed.saif_sharded',\n"
        "          'repro_torch.launch.mesh', 'repro_torch.launch.serve'):\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', "
        "'repro')]\n"
        "assert not bad, bad\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()\n"
        "print('CLEAN')\n")
    src = os.path.join(os.path.dirname(rt.__file__), os.pardir)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=os.path.abspath(src)))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "CLEAN" in r.stdout
