"""repro_torch — the PyTorch/CUDA port of ``repro`` (SAIF, arXiv 1806.05817).

The public serving surface::

    from repro_torch import Problem, Scalar, Path, Fleet, CV, open_session

    session = open_session(Problem(X=X, y=y), SaifConfig(eps=1e-7))
    res = session.solve(Scalar(lam))          # ... and keep serving

    srv = open_serving(Problem(X=X, y=y), SaifConfig(eps=1e-7))
    value, verdict = srv.solve(Scalar(lam))   # certified, retried, degraded
    srv.solve(Update(rows, responses))        # stream rows, re-solve warm

    server = open_server(max_batch=16)        # queue -> bucket -> fleet
    value, verdict = server.submit(Problem(X=X, y=y), Scalar(lam)).result()

Behind it: the serial SAIF solve, the fleet (B problems over one design,
solved together, with optional sample weights), the warm-started lambda
path, K-fold cross-validation and model selection (1-SE rule, stability
selection) for least squares and logistic loss, tree fused LASSO through
the Theorem-6 transform, group LASSO, and the paper's baselines (dynamic
screening, the sequential path, the strong-rule homotopy, the unscreened
CM), with the screening scan, the violation histogram, the CM burst
(serial and problem-gridded, with and without fused LASSO's unpenalized
slot), the Gram sweep (serial and problem-gridded), the residual-form CM
epochs, the wide-design CM sweep of the baselines, the group block CD and
the chain transform as CUDA C++ kernels for Hopper (``csrc/``). Sessions
and entry points run on the card unless the caller passes
``device="cpu"``.

Attributes load lazily (PEP 562): ``from repro_torch import open_session,
Problem`` imports neither torch nor an engine module; the engines load on
first use (``open_session(...)``, ``session.solve(...)``).
"""
from __future__ import annotations

import importlib

from repro_torch.core import _EXPORTS as _CORE_EXPORTS

# name -> defining module: everything repro_torch.core exports, plus the
# penalty factories that repro_torch.core leaves out (they would shadow
# its fused submodule)
_EXPORTS = {**_CORE_EXPORTS,
            "fused": "repro_torch.core.api", "group": "repro_torch.core.api",
            "GroupSaifConfig": "repro_torch.core.group"}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")


def __dir__():
    return sorted(set(__all__) | set(globals()))
