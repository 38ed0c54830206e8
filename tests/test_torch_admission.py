"""Admission control of the port's Session API (``repro_torch.core.serving``)
against the reference's (``repro.core.serving``), on the CPU.

Every branch of ``validate_problem`` and ``validate_request`` (Scalar, Path,
Fleet, CV, Update, Select and the shared deadline/priority knobs) is built
once in each package from the same inputs. Pass criteria per case: both
refuse it, with exceptions of the same class name, each an instance of the
same builtin (``ValueError`` for a ``RequestError``, ``ArithmeticError`` for
a ``NumericalError``), and the same message. The port's inputs are numpy
arrays and, in a second run of every case, CPU tensors, which the port
checks on their own device.
"""
import numpy as np
import pytest
import torch

import repro.core.api as J
import repro.core.online as J_online
import repro.core.select as J_select
import repro_torch.core.api as T
from repro.core import serving as J_serving
from repro_torch.core import serving as T_serving

N, P = 6, 4


def _X():
    return np.arange(1.0, N * P + 1).reshape(N, P)


def _with(a, idx, val):
    """A float copy of ``a`` with ``a[idx] = val``."""
    a = np.array(a, dtype=float)
    a[idx] = val
    return a


# case name -> a function of (api, online, select, arr) that constructs the
# refused object from one package's modules; ``arr`` turns a numpy array
# into that package's input (numpy for the reference, numpy or a tensor
# for the port)
CASES = {
    # --- validate_problem
    "X_1d": lambda a, o, s, arr: a.Problem(X=arr(np.ones(5))),
    "X_empty": lambda a, o, s, arr: a.Problem(X=arr(np.ones((0, 3)))),
    "X_nan": lambda a, o, s, arr: a.Problem(
        X=arr(_with(_X(), (1, 2), np.nan))),
    "X_infs": lambda a, o, s, arr: a.Problem(
        X=arr(_with(_with(_X(), (0, 0), np.inf), (2, 3), -np.inf))),
    "X_dead_col": lambda a, o, s, arr: a.Problem(
        X=arr(_with(_X(), np.s_[:, 1], 0.0))),
    "X_dead_cols": lambda a, o, s, arr: a.Problem(
        X=arr(_with(_X(), np.s_[:, 1:3], 0.0))),
    "loss": lambda a, o, s, arr: a.Problem(X=arr(_X()), loss="hinge"),
    "y_shape": lambda a, o, s, arr: a.Problem(X=arr(_X()),
                                              y=arr(np.ones(N + 1))),
    "y_nan": lambda a, o, s, arr: a.Problem(
        X=arr(_X()), y=arr(_with(np.ones(N), 3, np.nan))),
    "w_shape": lambda a, o, s, arr: a.Problem(
        X=arr(_X()), y=arr(np.ones(N)), weights=arr(np.ones((N, 1)))),
    "w_nan": lambda a, o, s, arr: a.Problem(
        X=arr(_X()), y=arr(np.ones(N)),
        weights=arr(_with(np.ones(N), 0, np.nan))),
    "w_negative": lambda a, o, s, arr: a.Problem(
        X=arr(_X()), y=arr(np.ones(N)),
        weights=arr(_with(np.ones(N), 2, -1.0))),
    "w_zero": lambda a, o, s, arr: a.Problem(
        X=arr(_X()), y=arr(np.ones(N)), weights=arr(np.zeros(N))),
    # --- Scalar
    "scalar_zero": lambda a, o, s, arr: a.Scalar(0.0),
    "scalar_nan": lambda a, o, s, arr: a.Scalar(float("nan")),
    "scalar_grid": lambda a, o, s, arr: a.Scalar(np.array([0.5, 0.2])),
    "scalar_2d": lambda a, o, s, arr: a.Scalar(np.ones((2, 2))),
    "scalar_deadline": lambda a, o, s, arr: a.Scalar(0.5, deadline_s=0.0),
    "scalar_deadline_inf": lambda a, o, s, arr: a.Scalar(
        0.5, deadline_s=float("inf")),
    "scalar_priority": lambda a, o, s, arr: a.Scalar(0.5, priority=True),
    # --- Path
    "path_empty": lambda a, o, s, arr: a.Path(()),
    "path_negative": lambda a, o, s, arr: a.Path((0.5, -0.1)),
    "path_priority": lambda a, o, s, arr: a.Path((0.5,), priority=1.5),
    # --- Fleet
    "fleet_Y_3d": lambda a, o, s, arr: a.Fleet(Y=arr(np.ones((2, 2, N))),
                                               lams=0.5),
    "fleet_Y_nan": lambda a, o, s, arr: a.Fleet(
        Y=arr(_with(np.ones((2, N)), (1, 1), np.nan)), lams=0.5),
    "fleet_lams_shape": lambda a, o, s, arr: a.Fleet(
        Y=arr(np.ones((2, N))), lams=[0.5, 0.4, 0.3]),
    "fleet_lam_zero": lambda a, o, s, arr: a.Fleet(Y=arr(np.ones((2, N))),
                                                   lams=[0.5, 0.0]),
    "fleet_w_shape": lambda a, o, s, arr: a.Fleet(
        Y=arr(np.ones((2, N))), lams=0.5, weights=arr(np.ones((2, N + 1)))),
    "fleet_w_nan": lambda a, o, s, arr: a.Fleet(
        Y=arr(np.ones((2, N))), lams=0.5,
        weights=arr(_with(np.ones((2, N)), (0, 0), np.inf))),
    "fleet_w_negative": lambda a, o, s, arr: a.Fleet(
        Y=arr(np.ones((2, N))), lams=0.5,
        weights=arr(_with(np.ones((2, N)), (1, 0), -0.5))),
    "fleet_w_dead_row": lambda a, o, s, arr: a.Fleet(
        Y=arr(np.ones((2, N))), lams=0.5,
        weights=arr(_with(np.ones((2, N)), 1, 0.0))),
    "fleet_w1_zero": lambda a, o, s, arr: a.Fleet(
        Y=arr(np.ones(N)), lams=0.5, weights=arr(np.zeros(N))),
    # --- CV
    "cv_folds": lambda a, o, s, arr: a.CV(n_folds=1, lams=(0.5,)),
    "cv_empty": lambda a, o, s, arr: a.CV(n_folds=3, lams=()),
    "cv_negative": lambda a, o, s, arr: a.CV(n_folds=3, lams=(-0.5,)),
    # --- Update
    "update_rows_1d": lambda a, o, s, arr: o.Update(
        rows=arr(np.ones(P)), responses=arr(np.ones(1))),
    "update_rows_nan": lambda a, o, s, arr: o.Update(
        rows=arr(_with(np.ones((2, P)), (0, 1), np.nan)),
        responses=arr(np.ones(2))),
    "update_resp_shape": lambda a, o, s, arr: o.Update(
        rows=arr(np.ones((2, P))), responses=arr(np.ones(3))),
    "update_resp_nan": lambda a, o, s, arr: o.Update(
        rows=arr(np.ones((2, P))),
        responses=arr(_with(np.ones(2), 1, np.nan))),
    "update_lam_grid": lambda a, o, s, arr: o.Update(
        rows=arr(np.ones((2, P))), responses=arr(np.ones(2)),
        lam=np.array([0.5, 0.1])),
    "update_lam_zero": lambda a, o, s, arr: o.Update(
        rows=arr(np.ones((2, P))), responses=arr(np.ones(2)), lam=0.0),
    "update_window_zero": lambda a, o, s, arr: o.Update(
        rows=arr(np.ones((2, P))), responses=arr(np.ones(2)), window=0),
    "update_window_small": lambda a, o, s, arr: o.Update(
        rows=arr(np.ones((3, P))), responses=arr(np.ones(3)), window=2),
    # --- Select
    "select_empty": lambda a, o, s, arr: s.Select(lams=()),
    "select_negative": lambda a, o, s, arr: s.Select(lams=(0.5, -1.0)),
    "select_folds": lambda a, o, s, arr: s.Select(lams=(0.5,), n_folds=1),
    "select_rule": lambda a, o, s, arr: s.Select(lams=(0.5,), rule="max"),
    "select_subsamples": lambda a, o, s, arr: s.Select(lams=(0.5,),
                                                       n_subsamples=1),
    "select_frac": lambda a, o, s, arr: s.Select(lams=(0.5,),
                                                 subsample_frac=1.0),
    "select_pi": lambda a, o, s, arr: s.Select(lams=(0.5,),
                                               pi_threshold=1.5),
    "select_deadline": lambda a, o, s, arr: s.Select(lams=(0.5,),
                                                     deadline_s=-1.0),
}


def _refusal(make):
    with pytest.raises(Exception) as info:
        make()
    return info.value


@pytest.mark.parametrize("inputs", ["numpy", "tensor"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_refusal_matches_reference(case, inputs):
    make = CASES[case]
    arr = torch.from_numpy if inputs == "tensor" else (lambda a: a)
    ref = _refusal(lambda: make(J, J_online, J_select, lambda a: a))
    mine = _refusal(lambda: make(T, T, T, arr))
    assert type(mine).__name__ == type(ref).__name__, (mine, ref)
    assert isinstance(ref, (J_serving.RequestError,
                            J_serving.NumericalError))
    for builtin in (ValueError, ArithmeticError):
        assert isinstance(mine, builtin) == isinstance(ref, builtin)
    assert isinstance(mine, T_serving.ServingError)
    assert str(mine) == str(ref)


def test_taxonomy_is_the_builtins():
    assert issubclass(T_serving.RequestError, ValueError)
    assert issubclass(T_serving.NumericalError, ArithmeticError)
    assert issubclass(T_serving.BackendFault, RuntimeError)
    assert issubclass(T_serving.DeadlineExceeded, TimeoutError)
    for cls in (T_serving.RequestError, T_serving.NumericalError,
                T_serving.BackendFault, T_serving.DeadlineExceeded):
        assert issubclass(cls, T_serving.ServingError)


@pytest.mark.parametrize("inputs", ["numpy", "tensor"])
def test_valid_requests_pass(inputs):
    """What the reference admits, the port admits (also as tensors)."""
    arr = torch.from_numpy if inputs == "tensor" else (lambda a: a)
    X = _X()
    T.Problem(X=arr(X), y=arr(np.ones(N)), weights=arr(np.ones(N)))
    T.Problem(X=None)
    T.Scalar(0.5, deadline_s=1.0, priority=np.int64(2))
    T.Path(np.array([0.5, 0.1]))
    T.Fleet(Y=arr(np.ones((2, N))), lams=np.array([0.5, 0.4]),
            weights=arr(np.ones((2, N))))
    T.CV(n_folds=2, lams=(0.5,))
    T.Update(rows=arr(np.ones((2, P))), responses=arr(np.ones(2)), lam=0.2,
             window=4)
    T.Select(lams=(0.5, 0.1), n_subsamples=4)
