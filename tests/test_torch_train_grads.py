"""The LM scaffold's gradients in the port (``launch.steps.value_and_grad``)
on the CPU, held against ``jax.value_and_grad(repro.models.lm.train_loss)``
on the same numpy weights and batch from a seed: all ten SMOKE configs in
float32 here and in float64 in ``test_torch_train_grads_f64.py``
(whisper's ``frames`` and vlm's ``img_embed`` from the seed), and vlm
without ``img_embed``, where the cross blocks and the image
projection are left out of the loss and their gradients are zeros in both
packages (AdamW still decays them).

Bounds: the loss within 1e-5 relative, each leaf's gradient within 1e-4 x
the largest entry of the reference's. float64 keeps the float32 stages of
``test_torch_lm.py``'s docstring (attention logits and softmax, the xLSTM
gates and sLSTM state, the loss's log-softmax), so it does not reach
float64 accuracy. The largest seen: the loss 1.8e-7, a leaf 5.5e-6
(xLSTM) in float32; 9.1e-8 and 8.2e-6 (xLSTM) in float64; 2.9e-6 and
1.4e-6 for hymba. The reference's jitted ``value_and_grad`` compiles in
1.5-5 s a config, once per test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.models import lm as JL
from repro_torch.launch import steps as T_steps
from test_torch_lm import (as_np, both, cfgs, flat, np_batch, np_params,
                           to_j, to_t)
from test_torch_saif import _one_torch_thread  # noqa: F401

LOSS_REL = 1e-5
GRAD_REL = 1e-4
CASES = ([(a, True) for a in JC.ARCH_IDS]
         + [("llama_3_2_vision_11b", False)])


def check_grads(arch, dtype, with_inputs):
    jc, tc = cfgs(arch, dtype)
    jp, tp = both(np_params(jc), jc, tc)
    b = np_batch(jc, 2, 32)
    if not with_inputs:
        b.pop("img_embed")
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, bb: JL.train_loss(p, bb, jc)))(jp, to_j(b))
    tl, tg = T_steps.value_and_grad(tp, to_t(b), tc)
    assert tl.dtype == torch.float32 and tl.shape == ()
    assert abs(float(tl) - float(jl)) <= LOSS_REL * abs(float(jl))
    fj, ft = flat(jg), flat(tg)
    assert fj.keys() == ft.keys()
    zero = set()
    for k, g_ref in fj.items():
        g_ref = np.asarray(g_ref)
        g = ft[k]
        assert g.dtype == getattr(torch, dtype) and g.shape == g_ref.shape, k
        scale = float(np.abs(g_ref).max())
        if scale == 0.0:
            zero.add(k)
            assert not bool(g.any()), k
            continue
        err = float(np.abs(as_np(g).astype(np.float64) - g_ref).max())
        assert err <= GRAD_REL * scale, (k, err, scale)
    if tc.family == "vlm" and not with_inputs:
        assert {k[0] for k in zero} == {"cross_blocks", "img_proj"}
    else:
        assert not zero, zero


@pytest.mark.parametrize("arch,with_inputs", CASES,
                         ids=[f"{a}{'' if w else '-no_img'}"
                              for a, w in CASES])
def test_grads_f32(arch, with_inputs):
    check_grads(arch, "float32", with_inputs)
