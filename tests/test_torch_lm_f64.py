"""The LM scaffold's per-architecture checks of ``test_torch_lm.py`` in
float64 (compute and master weights), all ten SMOKE configs, against
``repro`` on the same numpy inputs. Every family keeps float32 stages in
both packages (attention logits and their softmax, the xLSTM gates and
sLSTM state), so the bound is test_torch_lm.py's 2e-5 x scale (scale =
max|reference logits| + 1), not a float64 one; the port's decode against
its own forward pass keeps test_archs.py's 2e-4 x scale."""
import pytest

from test_torch_lm import (ARCHS, check_decode_sequence, check_decode_state,
                           check_forward, check_loss)
from test_torch_saif import _one_torch_thread  # noqa: F401


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference_f64(arch):
    check_forward(arch, "float64")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_matches_reference_f64(arch):
    check_loss(arch, "float64")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_state_and_cross_cache_match_reference_f64(arch):
    check_decode_state(arch, "float64")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_sequence_matches_reference_and_forward_f64(arch):
    check_decode_sequence(arch, "float64")
