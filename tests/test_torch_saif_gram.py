"""The port's main path end to end on the CPU, least squares with the
covariance-update (``gram``) inner backend: repro_torch.saif against
repro.saif with the reference's gram engine. Same pass criteria as
test_torch_saif.py."""
import pytest

import repro_torch as rt
from repro.core import SaifConfig as JConfig
from test_torch_saif import _one_torch_thread  # noqa: F401
from test_torch_saif import RULES, check_against_reference, ls_problem  # noqa: F401


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("frac", [0.5, 0.1, 0.02])
def test_least_squares_gram_matches_reference(ls_problem, frac, rule):
    X, y, lm = ls_problem
    check_against_reference(
        X, y, frac * lm, "least_squares",
        JConfig(screen_rule=rule, inner_backend="gram"),
        rt.SaifConfig(screen_rule=rule, inner_backend="gram"))
