"""The port's fault runtime (``repro_torch.runtime.fault``), its fault
seam (``repro_torch.runtime.inject``) and its checkpoints
(``repro_torch.ckpt.checkpoint``) on the CPU, held against the reference's
modules: the port's editions of the runtime and checkpoint cases of
tests/test_fault.py.

  * backoff delays and the retry loop's sleeps equal ``repro``'s for the
    same seeded rng under a fake clock; the deadline is typed; unlisted
    exceptions pass through;
  * the straggler flags equal ``repro``'s on the reference test's
    sequences;
  * seeded injector schedules equal ``repro``'s; the tag filter advances
    the counter; double arming is an error; the preemption guard;
  * the NaN poke reaches the port's serial solve and, with ``nan_unit``,
    one row of a fleet only; the next solve is clean; a disarmed seam
    changes no bit;
  * checkpoints: a torn write is invisible and reclaimed, 3 steps are
    kept, async saves, and a tree saved by either package restores
    through the other's ``restore``.
"""
import os
import random
import sys

import numpy as np
import pytest
import torch

import repro.ckpt.checkpoint as jck
import repro.runtime.fault as jf
import repro.runtime.inject as ji
import repro_torch as rt
import repro_torch.ckpt.checkpoint as ck
from repro_torch.core.inner_backend import InnerCarry
from repro_torch.runtime import fault
from repro_torch.runtime.inject import FaultInjector, armed, seam
from test_torch_saif import _one_torch_thread  # noqa: F401


def _same_result(a, b):
    """Two SaifResults bit for bit (every tensor field, the carry too)."""
    for f, x, y in zip(a._fields, a, b):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), f
        elif isinstance(x, tuple):
            for u, v in zip(x, y):
                assert torch.equal(u, v), f
        else:
            assert x == y, f


# ---------------------------------------------------------------------------
# retry_step and backoff: the reference's schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("base,mult,jitter", [(0.1, 2.0, 0.0),
                                              (0.1, 2.0, 0.5),
                                              (0.01, 3.0, 0.9),
                                              (0.0, 2.0, 0.5)])
def test_backoff_delay_equals_reference(base, mult, jitter):
    a, b = random.Random(7), random.Random(7)
    mine = [fault.backoff_delay(k, base, mult, jitter, a)
            for k in range(1, 33)]
    ref = [jf.backoff_delay(k, base, mult, jitter, b) for k in range(1, 33)]
    assert mine == ref
    if jitter == 0.0 and base > 0.0:
        assert mine[:3] == [base, base * mult, base * mult * mult]


class _FakeTime:
    def __init__(self, step=0.0):
        self.t, self.step, self.sleeps = 0.0, step, []

    def clock(self):
        return self.t

    def sleep(self, s):
        self.sleeps.append(s)
        self.t += s


def _flaky(clock, fails, step=0.0):
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        clock.t += step
        if calls["n"] <= fails:
            raise RuntimeError("transient")
        return "ok"
    return fn


@pytest.mark.parametrize("fails,jitter", [(3, 0.0), (3, 0.5), (5, 0.25)])
def test_retry_sleeps_equal_reference(fails, jitter):
    out = {}
    for name, mod in (("mine", fault), ("ref", jf)):
        ft = _FakeTime()
        retried = []
        got = mod.retry_step(
            _flaky(ft, fails, 0.01), max_retries=5, backoff_base_s=0.1,
            backoff_mult=2.0, jitter=jitter, rng=random.Random(3),
            on_retry=lambda k, e: retried.append(k), sleep=ft.sleep,
            clock=ft.clock)
        assert got == "ok"
        out[name] = (ft.sleeps, retried, ft.t)
    assert out["mine"] == out["ref"]
    if jitter == 0.0:
        assert out["mine"][0] == [0.1, 0.2, 0.4]


def test_retry_deadline_is_typed_and_equal_reference():
    out = {}
    for name, mod in (("mine", fault), ("ref", jf)):
        ft = _FakeTime()
        always = _flaky(ft, 10**9, 0.05)
        with pytest.raises(mod.RetryDeadlineExceeded):
            mod.retry_step(always, max_retries=100, backoff_base_s=0.1,
                           jitter=0.5, rng=random.Random(1), deadline_s=0.3,
                           sleep=ft.sleep, clock=ft.clock)
        assert ft.t <= 0.6           # sleeps were capped to the budget
        with pytest.raises(mod.StepFailed):
            mod.retry_step(always, max_retries=1, sleep=ft.sleep,
                           clock=ft.clock)
        out[name] = ft.sleeps
    assert out["mine"] == out["ref"]
    assert issubclass(fault.RetryDeadlineExceeded, fault.StepFailed)
    assert issubclass(fault.StepFailed, RuntimeError)


def test_retry_does_not_catch_unlisted_exceptions():
    calls = []

    def boom():
        calls.append(1)
        raise ValueError("not transient")

    with pytest.raises(ValueError):
        fault.retry_step(boom, max_retries=5)
    assert len(calls) == 1


# ---------------------------------------------------------------------------
# StragglerMonitor: the reference's flags
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("factor,min_samples,seq", [
    (3.0, 3, [1.0] * 5 + [10.0, 4.0, 4.0, 1.1]),
    (2.0, 2, [0.1, 0.1, 0.1, 0.5]),
    (3.0, 5, list(np.random.default_rng(0).lognormal(0.0, 0.9, 60))),
])
def test_straggler_flags_equal_reference(factor, min_samples, seq):
    seen = {"mine": [], "ref": []}
    mons = {
        "mine": fault.StragglerMonitor(
            factor=factor, min_samples=min_samples,
            on_straggler=lambda s, t, m: seen["mine"].append((s, t, m))),
        "ref": jf.StragglerMonitor(
            factor=factor, min_samples=min_samples,
            on_straggler=lambda s, t, m: seen["ref"].append((s, t, m)))}
    flags = {k: [m.record(float(t)) for t in seq] for k, m in mons.items()}
    assert flags["mine"] == flags["ref"]
    assert mons["mine"].flagged == mons["ref"].flagged
    assert seen["mine"] == seen["ref"]
    if seq[5:6] == [10.0]:
        assert mons["mine"].flagged == [6, 7, 8]
    assert mons["mine"].timed(lambda: 42) == 42
    assert len(mons["mine"].times) == len(seq) + 1


def test_preemption_guard_trigger_and_uninstall():
    g = fault.PreemptionGuard(install=False)
    assert not g.preempted
    g.trigger()
    assert g.preempted
    g.uninstall()                   # no-op without install; must not raise


# ---------------------------------------------------------------------------
# the fault seam
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 2024, 99991])
def test_injector_schedules_equal_reference(seed):
    kw = dict(p_fail=0.3, p_nan=0.2, p_delay=0.1)
    a = FaultInjector.from_seed(seed, 40, **kw)
    b = ji.FaultInjector.from_seed(seed, 40, **kw)
    assert (a.fail_at, a.nan_at, a.delay_at) == (b.fail_at, b.nan_at,
                                                 b.delay_at)
    assert a.fail_at or a.nan_at


def test_seam_log_and_identity_when_disarmed():
    assert armed() is None
    assert seam("serial", lambda: 123) == 123
    with FaultInjector(fail_at={2}, delay_at={3}, delay_s=0.01) as inj:
        assert armed() is inj
        assert seam("serial", lambda: "a") == "a"
        with pytest.raises(RuntimeError, match="injected"):
            seam("serial", lambda: "b")
        assert seam("path", lambda: "c") == "c"
    assert inj.log == [(2, "serial", "fail"), (3, "path", "delay")]
    assert armed() is None          # disarmed on exit


def test_injector_tag_filter_still_advances_counter():
    with FaultInjector(fail_at={2}, tags={"fleet"}) as inj:
        assert seam("serial", lambda: 1) == 1   # call 1 (other tag)
        assert seam("serial", lambda: 2) == 2   # call 2: filtered out
        assert inj.calls == 2 and inj.log == []
    with pytest.raises(RuntimeError):
        with FaultInjector(fail_at={1}, tags={"fleet"}):
            seam("fleet", lambda: 3)
    assert armed() is None


def test_double_arming_is_an_error():
    with FaultInjector():
        with pytest.raises(RuntimeError, match="already armed"):
            FaultInjector().__enter__()
    assert armed() is None


def test_inject_module_imports_no_torch():
    import subprocess
    code = ("import sys, repro_torch.runtime.inject, "
            "repro_torch.runtime.fault\n"
            "assert 'torch' not in sys.modules")
    src = os.path.join(os.path.dirname(rt.__file__), os.pardir)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr


def _ls(seed=0, n=20, p=50):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p))
    y = X[:, 0] + 0.1 * rng.normal(size=n)
    return X, y


def test_nan_poke_reaches_the_serial_solve():
    X, y = _ls()
    cfg = rt.SaifConfig()
    prep = rt.prepare_path(X, y, cfg, "cpu")
    clean = rt.solve_scalar(prep, 5.0, cfg, device="cpu")
    with FaultInjector(nan_at={1}) as inj:
        res = rt.solve_scalar(prep, 5.0, cfg, device="cpu")
    assert inj.log == [(1, "serial", "nan")]
    assert not bool(torch.isfinite(res.beta).all())
    assert torch.isnan(res.beta[0]) and torch.isnan(res.gap)
    assert torch.equal(res.beta[1:], clean.beta[1:])
    # the next (uninjected) solve is clean: the poke worked on copies
    _same_result(rt.solve_scalar(prep, 5.0, cfg, device="cpu"), clean)


def test_nan_poke_reaches_the_path_engine():
    X, y = _ls(1)
    cfg = rt.SaifConfig()
    prep = rt.prepare_path(X, y, cfg, "cpu")
    with FaultInjector(nan_at={2}) as inj:
        pr, _, _ = rt.run_path(prep, [6.0, 4.0, 3.0], cfg)
    assert [a for _, _, a in inj.log] == ["nan"] and inj.calls == 3
    assert [t for _, t, _ in inj.log] == ["path"]
    assert torch.isnan(pr.results[1].gap)
    assert bool(torch.isfinite(pr.results[0].beta).all())


@pytest.mark.parametrize("parity", ["bitwise", "fast"])
def test_nan_unit_poisons_one_fleet_row(parity):
    X, y = _ls(2, n=30, p=60)
    Y = np.stack([y, X[:, 1] - X[:, 2], y + X[:, 3]])
    cfg = rt.SaifConfig(parity=parity)
    clean = rt.fleet_solve(X, Y, 4.0, cfg, device="cpu")
    with FaultInjector(nan_at={1}, nan_unit=1) as inj:
        res = rt.fleet_solve(X, Y, 4.0, cfg, device="cpu")
    assert inj.log == [(1, "fleet", "nan")]
    assert torch.isnan(res.beta[1, 0]) and torch.isnan(res.gap[1])
    assert torch.equal(res.beta[1, 1:], clean.beta[1, 1:])
    for b in (0, 2):
        assert torch.equal(res.beta[b], clean.beta[b])
        assert torch.equal(res.gap[b], clean.gap[b])
    # without nan_unit, every row's first coefficient and gap
    with FaultInjector(nan_at={1}):
        res = rt.fleet_solve(X, Y, 4.0, cfg, device="cpu")
    assert bool(torch.isnan(res.beta[:, 0]).all())
    assert bool(torch.isnan(res.gap).all())
    _same_result(rt.fleet_solve(X, Y, 4.0, cfg, device="cpu"), clean)


def test_disarmed_seam_is_bitwise_no_seam(monkeypatch):
    """A solve through the disarmed seam, through an armed injector with
    no schedule, and with the seam replaced by a plain call: bit for bit
    one result, at every boundary (serial, path, both fleet engines)."""
    X, y = _ls(3, n=30, p=80)
    Y = np.stack([y, y + X[:, 4]])
    cfg = rt.SaifConfig()
    prep = rt.prepare_path(X, y, cfg, "cpu")

    def run():
        return (rt.solve_scalar(prep, 3.0, cfg, device="cpu"),
                rt.run_path(prep, [5.0, 3.0], cfg)[0].results,
                rt.fleet_solve(X, Y, 3.0, cfg, device="cpu"),
                rt.fleet_solve(X, Y, 3.0, rt.SaifConfig(parity="fast"),
                               device="cpu"))

    def same(a, b):
        _same_result(a[0], b[0])
        for u, v in zip(a[1], b[1]):
            _same_result(u, v)
        _same_result(a[2], b[2])
        _same_result(a[3], b[3])

    disarmed = run()
    with FaultInjector() as inj:
        armed_empty = run()
    assert inj.calls == 5 and inj.log == []
    for name in ("saif", "path", "batch"):
        monkeypatch.setattr(sys.modules[f"repro_torch.core.{name}"],
                            "_fault_seam", lambda tag, fn: fn())
    no_seam = run()
    same(disarmed, armed_empty)
    same(disarmed, no_seam)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _warm_tree(k=6, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"idx": torch.randperm(40, generator=g)[:k],
            "beta": torch.randn(k, generator=g, dtype=torch.float64),
            "mask": torch.rand(k, generator=g) > 0.3,
            "G": torch.randn(k, k, generator=g, dtype=torch.float64),
            "rho": torch.randn(k, generator=g, dtype=torch.float64),
            "gidx": torch.arange(k) - 1}


def _assert_tree_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y)


def test_checkpoint_survives_killed_mid_flush_write(tmp_path):
    """A writer that dies mid-flush (torn .tmp dir, no meta) neither
    corrupts the previous checkpoint nor is offered for restore, and the
    next save of its step reclaims it."""
    d = str(tmp_path / "ck")
    tree = {"a": torch.arange(4.0, dtype=torch.float64),
            "b": torch.ones(2, 2)}
    ck.save(d, 1, tree, extra={"tag": "good"})
    torn = os.path.join(d, "step_00000002.tmp")
    os.makedirs(torn)
    np.save(os.path.join(torn, "arr_00000.npy"), np.zeros(4))
    assert ck.latest_step(d) == 1          # torn write invisible
    restored, extra = ck.restore(d, 1, tree)
    assert extra == {"tag": "good"}
    assert torch.equal(restored["a"], tree["a"])
    assert restored["b"].dtype == torch.float32
    ck.save(d, 2, tree, extra={"tag": "retry"})
    assert ck.latest_step(d) == 2
    assert not os.path.exists(torn)
    assert ck.load_meta(d, 2)["extra"]["tag"] == "retry"


def test_checkpoint_keeps_three_steps_and_saves_async(tmp_path):
    d = str(tmp_path / "ck")
    tree = _warm_tree()
    for step in range(1, 6):
        ck.save(d, step, tree)
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004",
                                     "step_00000005"]
    ck.save_async(d, 6, tree, extra={"async": True})
    ck.wait_pending()
    assert ck.latest_step(d) == 6 and len(os.listdir(d)) == 3
    back, extra = ck.restore(d, 6, {k: torch.zeros_like(v)
                                    for k, v in tree.items()})
    assert extra == {"async": True}
    for k in tree:
        assert torch.equal(back[k], tree[k]), k
    # numpy like leaves give numpy arrays; device= gives tensors there
    np_like = {k: v.numpy() for k, v in tree.items()}
    back_np, _ = ck.restore(d, 6, np_like)
    assert isinstance(back_np["G"], np.ndarray)
    back_dev, _ = ck.restore(d, 6, np_like, device="cpu")
    assert isinstance(back_dev["G"], torch.Tensor)
    _assert_tree_equal(back_np, {k: v.numpy() for k, v in back_dev.items()})
    with pytest.raises(ValueError, match="structure mismatch"):
        ck.restore(d, 6, {"idx": tree["idx"], "other": tree["beta"]})


def test_checkpoint_nested_tree_names_equal_reference(tmp_path):
    """Dicts, tuples and NamedTuples name their leaves as the reference's
    ``jax.tree_util`` paths do, so the .npy files line up."""
    carry = InnerCarry(G=torch.eye(3, dtype=torch.float64),
                       rho=torch.ones(3, dtype=torch.float64),
                       gidx=torch.arange(3))
    tree = {"warm": (torch.arange(3), carry), "lam": torch.tensor(0.5),
            "none": None}
    ck.save(str(tmp_path / "a"), 1, tree)
    jtree = {"warm": (np.arange(3), InnerCarry(*[t.numpy() for t in carry])),
             "lam": np.asarray(0.5, np.float32), "none": None}
    jck.save(str(tmp_path / "b"), 1, jtree)
    names = ck.load_meta(str(tmp_path / "a"), 1)["names"]
    assert names == jck.load_meta(str(tmp_path / "b"), 1)["names"]
    assert names == ["lam", "warm/[0]", "warm/[1]/G", "warm/[1]/gidx",
                     "warm/[1]/rho"]
    back, _ = ck.restore(str(tmp_path / "b"), 1, tree)
    assert isinstance(back["warm"][1], InnerCarry) and back["none"] is None
    assert torch.equal(back["warm"][1].G, carry.G)
    assert torch.equal(back["warm"][0], tree["warm"][0])


def test_checkpoint_cross_package(tmp_path):
    """A warm-state tree saved by the port restores through
    ``repro.ckpt.checkpoint.restore`` to equal arrays, and one saved by
    the reference restores through the port's."""
    import jax.numpy as jnp
    tree = _warm_tree(8, seed=4)
    d = str(tmp_path / "port")
    ck.save(d, 3, tree, extra={"kind": "saif-warm-state"})
    like = {k: jnp.zeros(tuple(v.shape), v.numpy().dtype)
            for k, v in tree.items()}
    back, extra = jck.restore(d, 3, like)
    assert extra == {"kind": "saif-warm-state"}
    _assert_tree_equal({k: np.asarray(v) for k, v in back.items()},
                       {k: v.numpy() for k, v in tree.items()})

    d2 = str(tmp_path / "ref")
    jtree = {k: jnp.asarray(v.numpy()) for k, v in _warm_tree(5, 9).items()}
    jck.save(d2, 7, jtree, extra={"from": "repro"})
    assert ck.latest_step(d2) == 7
    mine, extra = ck.restore(d2, 7, {k: torch.zeros(v.shape, dtype=t.dtype)
                                     for (k, v), t in zip(
                                         jtree.items(),
                                         _warm_tree(5, 9).values())})
    assert extra == {"from": "repro"}
    _assert_tree_equal({k: v.numpy() for k, v in mine.items()},
                       {k: np.asarray(v) for k, v in jtree.items()})
