"""The LM scaffold's gradients in float64 against the reference (the
cases and bounds of ``test_torch_train_grads.py``; a file of their own so
the reference's compiles split over two workers)."""
import pytest

from test_torch_train_grads import CASES, check_grads
from test_torch_saif import _one_torch_thread  # noqa: F401


@pytest.mark.parametrize("arch,with_inputs", CASES,
                         ids=[f"{a}{'' if w else '-no_img'}"
                              for a, w in CASES])
def test_grads_f64(arch, with_inputs):
    check_grads(arch, "float64", with_inputs)
