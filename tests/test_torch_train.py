"""The LM scaffold's training in the port on the CPU: the token pipeline,
the train step, remat, checkpoints across packages, retries and the
trainer CLI, held against ``repro`` on the same inputs where it has them.

  * ``data.pipeline``: every batch bit for bit the reference's, across a
    ``state()`` / ``restore()`` cursor; ``to_device`` keeps int32 tokens.
  * ``make_train_step`` with microbatch 1 and 4 on the reference's own
    inputs of tests/test_distribution.py::test_microbatch_equivalence (its
    ``model_init`` weights and ``randint`` tokens, read out as numpy),
    against the reference's step and each other, with that test's bounds
    (the loss within 1e-5, the parameters within 5e-5). On other weights
    the bound on the parameters does not hold even for the reference
    against itself (9.8e-5 on ``np_params``): Adam's first step divides
    each gradient entry by its magnitude plus eps, so an entry near zero
    moves by up to 2 lr on a difference in its last bits. So on seeded
    weights microbatches are held at the gradients: the loss within 1e-5
    relative, each leaf within 1e-4 x its largest entry.
  * remat on and off, bit for bit, and the loss under autograd bit for bit
    the serving forward's (inference mode), for all ten SMOKE configs.
  * a 4-step loss stream on ``TokenPipeline`` against the reference's
    in-process loop (no mesh), within LOSS_STREAM_REL relative.
  * a reference ``TrainState`` saved by ``repro.ckpt`` restored by the
    port's ``ckpt`` and ``convert.train_state_from_numpy`` takes the
    reference's next step, and a port state saved by the port's takes the
    reference's through the reference's ``ckpt``: the loss within 1e-5
    relative, the parameters within NEXT_STEP_ABS.
  * the trainer: ``python -m repro_torch.launch.train --device cpu`` for 6
    steps, then resumed to 12, prints the last 3 losses of a straight
    12-step run (the port's tests/test_distribution.py:178); a step that
    raises once is retried onto the unfailed run's state; ``device=None``
    raises without a card; ``--model-parallel 2`` raises.
"""
import io
import os
import subprocess
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.ckpt import checkpoint as j_ckpt
from repro.data import pipeline as JP
from repro.launch import steps as J_steps
from repro.optim import adamw as JA
import repro_torch.configs as TC
from repro_torch import convert
from repro_torch.ckpt import checkpoint as t_ckpt
from repro_torch.data import pipeline as TP
from repro_torch.launch import steps as T_steps
from repro_torch.launch import train as T_train
from repro_torch.models import lm as TL
from repro_torch.optim import adamw as TA
from test_torch_lm import (as_np, both, cfgs, flat, np_batch, np_params,
                           to_j, to_t)
from test_torch_saif import _one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = JC.ARCH_IDS
LOSS_REL = 1e-5
GRAD_REL = 1e-4
# the largest seen: 9.1e-8 (the stream's losses), 1.2e-7 (the next step's
# parameters from a state carried across; each package's own two steps
# part by 6.1e-5, the sign sensitivity above)
LOSS_STREAM_REL = 1e-5
NEXT_STEP_ABS = 5e-5


def max_abs(a, b):
    fa, fb = flat(a), flat(b)
    assert fa.keys() == fb.keys()
    return max(float(np.max(np.abs(as_np(fa[k]).astype(np.float64)
                                   - as_np(fb[k]).astype(np.float64))))
               for k in fa)


def grads_close(g, g_ref, loss, loss_ref):
    assert abs(float(loss) - float(loss_ref)) <= LOSS_REL * abs(
        float(loss_ref))
    fg, fr = flat(g), flat(g_ref)
    assert fg.keys() == fr.keys()
    for k, r in fr.items():
        r = as_np(r).astype(np.float64)
        err = float(np.abs(as_np(fg[k]).astype(np.float64) - r).max())
        assert err <= GRAD_REL * float(np.abs(r).max()), (k, err)


# ---------------------------------------------------------------------------
# the token pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seq,batch,seed", [(128, 32, 4, 0),
                                                  (32001, 64, 3, 5),
                                                  (40, 17, 2, 9)])
def test_pipeline_bitwise_reference(vocab, seq, batch, seed):
    """Five batches, then a new pipeline restored from the cursor after
    the second: every batch the reference's bit for bit (int32)."""
    dc = dict(vocab=vocab, seq_len=seq, global_batch=batch, seed=seed)
    j, t = JP.TokenPipeline(JP.DataConfig(**dc)), TP.TokenPipeline(
        TP.DataConfig(**dc))
    cursor = None
    for i in range(5):
        a, b = j.next_batch(), t.next_batch()
        assert a.keys() == b.keys() == {"tokens", "labels"}
        for k in a:
            assert b[k].dtype == np.int32 and np.array_equal(a[k], b[k])
        if i == 1:
            cursor = t.state()
    assert cursor == {"step": 2, "seed": seed}
    t2 = TP.TokenPipeline(TP.DataConfig(**dc))
    t2.restore(cursor)
    j2 = JP.TokenPipeline(JP.DataConfig(**dc))
    j2.restore(cursor)
    for _ in range(3):
        a, b = j2.next_batch(), t2.next_batch()
        assert all(np.array_equal(a[k], b[k]) for k in a)
    dev = TP.to_device(b, "cpu")
    assert dev["tokens"].dtype == torch.int32
    assert np.array_equal(dev["labels"].numpy(), b["labels"])


def test_pipeline_refuses_another_seed():
    t = TP.TokenPipeline(TP.DataConfig(vocab=50, seq_len=8, global_batch=2,
                                       seed=1))
    with pytest.raises(ValueError, match="seed"):
        t.restore({"step": 3, "seed": 2})


# ---------------------------------------------------------------------------
# the train step against the reference's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_mb_case():
    """tests/test_distribution.py::test_microbatch_equivalence's inputs
    and the reference's two steps on them."""
    from repro.models import init as model_init
    cfg = JC.smoke_config("stablelm_3b").scaled(dtype="float32")
    params = model_init(jax.random.PRNGKey(0), cfg)
    toks = jax.random.randint(jax.random.PRNGKey(1), (8, 32), 0, cfg.vocab)
    batch = {"tokens": toks, "labels": jnp.roll(toks, -1, axis=1)}
    opt = JA.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    state = J_steps.TrainState(params=params, opt=JA.init(params))
    ref = {mb: J_steps.make_train_step(cfg, opt, microbatch=mb)(state, batch)
           for mb in (1, 4)}
    return (jax.tree.map(np.asarray, params),
            {k: np.asarray(v) for k, v in batch.items()}, ref)


def _port_step(np_tree, np_b, mb):
    tc = TC.smoke_config("stablelm_3b").scaled(dtype="float32")
    params = convert.lm_params_from_numpy(np_tree, tc, device="cpu")
    opt = TA.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    state = T_steps.TrainState(params=params, opt=TA.init(params))
    return T_steps.make_train_step(tc, opt, microbatch=mb)(
        state, {k: torch.from_numpy(np.array(v)) for k, v in np_b.items()})


@pytest.mark.parametrize("mb", [1, 4])
def test_train_step_matches_reference(ref_mb_case, mb):
    """The port's step against the reference's with the same microbatch
    count and against the reference's microbatch-1 step: test
    _microbatch_equivalence's bounds (loss 1e-5, parameters 5e-5); m, v
    and the step too."""
    np_tree, np_b, ref = ref_mb_case
    state, loss, _ = _port_step(np_tree, np_b, mb)
    for rmb in {mb, 1}:
        rstate, rloss = ref[rmb]
        assert abs(float(loss) - float(rloss)) < 1e-5
        assert max_abs(state.params, rstate.params) < 5e-5
    rstate = ref[mb][0]
    assert int(state.opt.step) == int(rstate.opt.step) == 1
    assert max_abs(state.opt.m, rstate.opt.m) < 1e-6
    assert loss.dtype == torch.float32


def test_microbatch_equivalence(ref_mb_case):
    """The port's microbatch 4 against its microbatch 1 on the reference
    test's inputs and bounds."""
    np_tree, np_b, _ = ref_mb_case
    s1, l1, _ = _port_step(np_tree, np_b, 1)
    s4, l4, _ = _port_step(np_tree, np_b, 4)
    assert abs(float(l1) - float(l4)) < 1e-5
    assert max_abs(s1.params, s4.params) < 5e-5


@pytest.mark.parametrize("arch", [a for a in ARCHS
                                  if "moe" not in a and a != "dbrx_132b"])
def test_microbatch_grads(arch):
    """``value_and_grad`` over 4 microbatches against 1 on seeded weights
    (float32 gradients, the loss within 1e-5 relative, each leaf within
    1e-4 x its largest entry). Not for MoE: its capacity and load-balance
    loss are per call, not additive over microbatches, in the reference
    too."""
    _, tc = cfgs(arch)
    _, tp = both(np_params(tc), tc, tc)
    b = to_t(np_batch(tc, 8, 32))
    l1, g1 = T_steps.value_and_grad(tp, b, tc)
    l4, g4 = T_steps.value_and_grad(tp, b, tc, microbatch=4)
    assert all(g.dtype == torch.float32 for g in flat(g4).values())
    grads_close(g4, g1, l4, l1)
    with pytest.raises(ValueError, match="microbatches"):
        T_steps.value_and_grad(tp, b, tc, microbatch=3)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_bitwise(arch):
    """remat on and off: the same loss and gradients bit for bit on the
    CPU; the loss under autograd is the serving forward's, bit for bit."""
    _, tc = cfgs(arch)
    _, tp = both(np_params(tc), tc, tc)
    b = to_t(np_batch(tc, 2, 32))
    on = T_steps.value_and_grad(tp, b, tc.scaled(remat=True))
    off = T_steps.value_and_grad(tp, b, tc)
    assert torch.equal(on[0], off[0])
    fo, ff = flat(on[1]), flat(off[1])
    assert all(torch.equal(fo[k], ff[k]) for k in fo)
    with torch.inference_mode():
        served = TL.train_loss(tp, b, tc.scaled(remat=True))
    assert torch.equal(served, on[0])


def test_grad_norm_attribute():
    """The step's third value is the gradients' global norm before
    clipping, the one ``adamw.update`` clips by: the new state is bit for
    bit ``update`` computing the norm itself."""
    _, tc = cfgs("hymba_1_5b")
    _, tp = both(np_params(tc), tc, tc)
    b = to_t(np_batch(tc, 2, 32))
    opt = TA.AdamWConfig(clip_norm=0.5)
    state = T_steps.TrainState(tp, TA.init(tp))
    new, loss, norm = T_steps.make_train_step(tc, opt)(state, b)
    l, g = T_steps.value_and_grad(tp, b, tc)
    assert torch.equal(norm, TA.global_norm(g)) and torch.equal(loss, l)
    assert float(norm) > opt.clip_norm       # the clip is taken
    params, o = TA.update(g, state.opt, tp, opt)
    assert max_abs(new.params, params) == 0.0
    assert max_abs(new.opt.m, o.m) == 0.0 and max_abs(new.opt.v, o.v) == 0.0


def test_loss_stream_matches_reference():
    """4 steps on ``TokenPipeline`` (seed 0, B = 4, S = 32) from the same
    seeded weights, the CLI's optimizer (lr 1e-3, warmup 10), both
    packages in process: the losses within LOSS_STREAM_REL relative."""
    jc, tc = cfgs("stablelm_3b")
    jp, tp = both(np_params(jc), jc, tc)
    kw = dict(lr=1e-3, warmup_steps=10, total_steps=4)
    dc = dict(vocab=jc.vocab, seq_len=32, global_batch=4, seed=0)
    jstep = jax.jit(J_steps.make_train_step(jc, JA.AdamWConfig(**kw)))
    tstep = T_steps.make_train_step(tc, TA.AdamWConfig(**kw))
    js = J_steps.TrainState(jp, JA.init(jp))
    ts = T_steps.TrainState(tp, TA.init(tp))
    jd, td = JP.TokenPipeline(JP.DataConfig(**dc)), TP.TokenPipeline(
        TP.DataConfig(**dc))
    for _ in range(4):
        js, jl = jstep(js, {k: jnp.asarray(v)
                            for k, v in jd.next_batch().items()})
        ts, tl, _ = tstep(ts, TP.to_device(td.next_batch(), "cpu"))
        assert abs(float(tl) - float(jl)) <= LOSS_STREAM_REL * float(jl)


# ---------------------------------------------------------------------------
# checkpoints across packages
# ---------------------------------------------------------------------------

def _states(steps=2):
    """The reference's and the port's TrainState after ``steps`` steps of
    each from the same seeded weights and batches (m, v and step
    nonzero), the two configs, a next batch and the optimizer config."""
    jc, tc = cfgs("hymba_1_5b")
    jp, tp = both(np_params(jc), jc, tc)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jstep = jax.jit(J_steps.make_train_step(jc, JA.AdamWConfig(**kw)))
    tstep = T_steps.make_train_step(tc, TA.AdamWConfig(**kw))
    js = J_steps.TrainState(jp, JA.init(jp))
    ts = T_steps.TrainState(tp, TA.init(tp))
    for i in range(steps):
        b = np_batch(jc, 2, 32, seed=10 + i)
        js, _ = jstep(js, to_j(b))
        ts, _, _ = tstep(ts, to_t(b))
    return js, ts, jc, tc, np_batch(jc, 2, 32, seed=20), jstep, tstep


def test_reference_state_through_port_checkpoint(tmp_path):
    """A reference TrainState saved by ``repro.ckpt``, restored by the
    port's ``ckpt`` into numpy and carried over by
    ``train_state_from_numpy``: every leaf equal, and the port's next step
    from it against the reference's next step from its own."""
    js, _, jc, tc, b, jstep, tstep = _states()
    j_ckpt.save(str(tmp_path), 2, js)
    like = jax.tree.map(np.asarray, js)
    got, _ = t_ckpt.restore(str(tmp_path), 2, like)
    ts = convert.train_state_from_numpy(got.params, got.opt, tc,
                                        device="cpu")
    assert ts.opt.step.dtype == torch.int32 and int(ts.opt.step) == 2
    assert max_abs(ts.params, js.params) == 0.0
    assert max_abs(ts.opt.m, js.opt.m) == max_abs(ts.opt.v, js.opt.v) == 0
    jn, jl = jstep(js, to_j(b))
    tn, tl, _ = tstep(ts, to_t(b))
    assert abs(float(tl) - float(jl)) <= LOSS_REL * abs(float(jl))
    assert max_abs(tn.params, jn.params) <= NEXT_STEP_ABS
    assert int(tn.opt.step) == int(jn.opt.step) == 3


def test_port_state_through_reference_checkpoint(tmp_path):
    """A port TrainState saved by the port's ``ckpt`` and restored by the
    reference's: every leaf equal, and the reference's next step from it
    against the port's next step."""
    js, ts, jc, tc, b, jstep, tstep = _states()
    t_ckpt.save(str(tmp_path), 2, ts)
    got, _ = j_ckpt.restore(str(tmp_path), 2, js)
    assert max_abs(got.params, ts.params) == 0.0
    assert int(got.opt.step) == 2
    jn, jl = jstep(got, to_j(b))
    tn, tl, _ = tstep(ts, to_t(b))
    assert abs(float(tl) - float(jl)) <= LOSS_REL * abs(float(jl))
    assert max_abs(tn.params, jn.params) <= NEXT_STEP_ABS


def test_train_state_from_numpy_refuses():
    jc, tc = cfgs("stablelm_3b")
    p = np_params(jc)
    m = {k: v for k, v in p.items()}
    ok = convert.train_state_from_numpy(p, (np.int32(0), p, p), tc,
                                        device="cpu")
    assert int(ok.opt.step) == 0
    del m["embed"]
    with pytest.raises(ValueError, match="missing"):
        convert.train_state_from_numpy(p, (0, m, p), tc, device="cpu")
    bad = dict(p, final_ln=np.ones(3, np.float32))
    with pytest.raises(ValueError, match="shape"):
        convert.train_state_from_numpy(p, (0, p, bad), tc, device="cpu")
    with pytest.raises(ValueError, match="extra"):
        convert.train_state_from_numpy(dict(p, x=p["embed"]), (0, p, p), tc,
                                       device="cpu")
    with pytest.raises(ValueError, match="step"):
        convert.train_state_from_numpy(p, (np.zeros(2), p, p), tc,
                                       device="cpu")


# ---------------------------------------------------------------------------
# retries, the device rule and the trainer CLI
# ---------------------------------------------------------------------------

def test_retried_step_lands_on_the_same_state():
    """A step that computes its result and then raises once is retried by
    ``train_loop`` from the state it was given: the run's losses and final
    state equal an unfailed run's bit for bit."""
    _, tc = cfgs("stablelm_3b")
    _, tp = both(np_params(tc), tc, tc)
    step = T_steps.make_train_step(tc, TA.AdamWConfig(lr=1e-3))
    dc = TP.DataConfig(vocab=tc.vocab, seq_len=16, global_batch=2)
    calls = {"n": 0}

    def flaky(state, batch):
        out = step(state, batch)
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("transient device error")
        return out

    runs = [T_train.train_loop(fn, T_steps.TrainState(tp, TA.init(tp)),
                               TP.TokenPipeline(dc), start=0, steps=3,
                               log_every=0)
            for fn in (step, flaky)]
    assert calls["n"] == 4
    assert runs[0].losses == runs[1].losses and not runs[1].preempted
    assert runs[0].grad_norms == runs[1].grad_norms
    assert max_abs(runs[0].state.params, runs[1].state.params) == 0.0
    assert max_abs(runs[0].state.opt.v, runs[1].state.opt.v) == 0.0


def test_device_none_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None means it")
    _, tc = cfgs("stablelm_3b")
    with pytest.raises(RuntimeError, match="CUDA"):
        T_steps.init_train_state(tc)
    with pytest.raises(RuntimeError, match="CUDA"):
        TP.to_device({"tokens": np.zeros((1, 2), np.int32)})
    with pytest.raises(RuntimeError, match="CUDA"):
        T_train.main(["--arch", "stablelm_3b", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.train_state_from_numpy(np_params(tc), (0, {}, {}), tc)


def test_model_parallel_refused():
    with pytest.raises(ValueError, match="model-parallel"):
        T_train.main(["--arch", "stablelm_3b", "--smoke", "--steps", "1",
                      "--model-parallel", "2", "--device", "cpu"])


def _losses(out):
    return [ln.split()[-1] for ln in out.splitlines()
            if ln.startswith("step ")]


def test_train_resume_end_to_end(tmp_path):
    """Train 6 steps (``python -m repro_torch.launch.train``), resume to
    12 from its checkpoints: the last 3 printed losses equal an
    uninterrupted 12-step run's (the resumed and straight runs call
    ``main`` in this process)."""
    base = ["--arch", "stablelm_3b", "--smoke", "--batch", "4", "--seq",
            "32", "--log-every", "1", "--lr", "1e-3", "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r1 = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                         *base, "--steps", "6", "--ckpt-dir",
                         str(tmp_path / "a"), "--ckpt-every", "3"],
                        capture_output=True, text=True, env=env, cwd=ROOT,
                        timeout=300)
    assert r1.returncode == 0, r1.stderr[-2000:]
    assert len(_losses(r1.stdout)) == 6 and "final loss" in r1.stdout

    def run(*extra):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert T_train.main(base + list(extra)) == 0
        return buf.getvalue()

    resumed = run("--steps", "12", "--ckpt-dir", str(tmp_path / "a"),
                  "--ckpt-every", "3")
    assert "[resume] restored step 6" in resumed
    assert len(_losses(resumed)) == 6
    straight = run("--steps", "12", "--ckpt-dir", str(tmp_path / "b"),
                   "--ckpt-every", "100")
    assert _losses(resumed)[-3:] == _losses(straight)[-3:], (resumed,
                                                             straight)
    assert t_ckpt.latest_step(str(tmp_path / "a")) == 12
