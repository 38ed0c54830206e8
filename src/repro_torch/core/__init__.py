"""SAIF core in torch.

Primary surface:
  Problem, open_session, Session          — declarative spec + serving
  open_serving, ServingSession, Verdict   — the fault-tolerant runtime
  open_server, Server, ServingFuture      — the async front end
  Scalar, Path, Fleet, CV, Select, Update — the request types
  saif, SaifConfig, SaifResult            — one-shot Algorithm 1/2

Engines: the serial solve, the fleet (weighted too; the fast-parity
lockstep engine with its certified mixed-precision screen), the lambda
path, fused LASSO, group LASSO, K-fold CV and model selection, the
paper's baselines (dynamic screening, the sequential path, the
strong-rule homotopy, the unscreened CM), and their building blocks.

Legacy frontends (deprecated shims over one-shot sessions; each warns
once per process): saif_path, saif_batch, cv_path, saif_fused, fused_path,
group_saif.

Attributes resolve lazily (PEP 562): importing :mod:`repro_torch.core`
loads no torch and no engine until a name is touched, so ``from
repro_torch import Problem, open_session`` stays cheap.
"""
from __future__ import annotations

import importlib
import sys
import types

_M = "repro_torch.core."
# name -> defining module (resolved on first attribute access)
_EXPORTS = {
    # the Problem/Session API
    **{name: _M + "api" for name in (
        "Problem", "Session", "open_session", "Scalar", "Path", "Fleet",
        "CV", "lasso", "LassoPenalty", "FusedPenalty", "GroupPenalty",
        "GroupPathResult", "CompileStats", "unified_compile_count",
        "SESSION_KWARG_DEFAULTS", "session_kwargs")},
    # NOTE: the fused(parent)/group(gsize) penalty factories are not
    # exported here: they would shadow the repro_torch.core.fused
    # submodule. Use repro_torch.fused / repro_torch.group or
    # repro_torch.core.api.fused / .group.
    # the fault-tolerant serving runtime and admission control
    **{name: _M + "serving" for name in (
        "open_serving", "ServingSession", "ServingConfig", "ServingResult",
        "ServingStats", "Verdict", "Rung",
        "ServingError", "RequestError", "NumericalError", "BackendFault",
        "DeadlineExceeded", "validate_problem", "validate_request")},
    # the async front end: queue -> bucket -> microbatch -> fleet
    **{name: _M + "server" for name in (
        "open_server", "Server", "ServerConfig", "ServerStats",
        "ServingFuture")},
    # streaming and model selection (import-light)
    **{name: _M + "online" for name in (
        "Update", "OnlineState", "apply_update", "online_compile_count")},
    **{name: _M + "select" for name in (
        "Select", "SelectionReport", "select_solve", "subsample_weights",
        "stability_frequencies")},
    **{name: _M + "warm_cache" for name in (
        "WarmCache", "WarmCacheConfig", "WarmCacheStats", "problem_digest")},
    # serial solver
    **{name: _M + "saif" for name in (
        "saif", "solve_scalar", "SaifConfig", "SaifResult", "PathState",
        "prepare_path", "pad_path_state")},
    # path engine
    **{name: _M + "path" for name in (
        "run_path", "saif_path", "saif_path_naive", "SaifPathResult",
        "lambda_grid")},
    # fleet engines
    **{name: _M + "batch" for name in (
        "fleet_solve", "saif_batch", "prepare_fleet", "pad_fleet_prep",
        "FleetPrep", "resolve_batch_inner")},
    "solve_fleet_fast": _M + "batch_fast",
    # cross-validation
    **{name: _M + "cv" for name in (
        "cv_solve", "cv_path", "CVPathResult", "kfold_weights",
        "one_se_lambda")},
    # oracle and inner machinery
    **{name: _M + "cm" for name in ("solve_lasso_cm", "cm_epoch")},
    **{name: _M + "inner_backend" for name in (
        "InnerBackend", "InnerCarry", "InnerOut", "resolve_inner_backend")},
    # screening backends and rules
    **{name: _M + "screen_backend" for name in (
        "ScreenFn", "ScreenOut", "BatchScreenFn", "make_screen_torch",
        "make_screen_cuda", "make_screen_from_scan", "resolve_backend")},
    **{name: _M + "screen_rule" for name in (
        "ScreenRule", "SCREEN_RULES", "resolve_screen_rule")},
    # duality and losses
    **{name: _M + "duality" for name in (
        "kkt_residual", "lambda_max", "dual_point", "unit_roundoff",
        "dot_error_gamma", "mixed_precision_gamma", "widened_radius")},
    "get_loss": _M + "losses",
    # baselines
    **{name: _M + "dynamic" for name in (
        "dynamic_screening", "DynConfig", "DynResult")},
    **{name: _M + "sequential" for name in ("sequential_path", "SeqConfig")},
    **{name: _M + "homotopy" for name in (
        "homotopy_path", "HomotopyConfig", "HomotopyResult",
        "support_metrics")},
    # group subsystem
    **{name: _M + "group" for name in (
        "group_saif", "group_solve", "GroupSaifConfig", "GroupSaifResult",
        "group_lambda_max", "group_compile_count", "prepare_group",
        "solve_group_lasso_bcd")},
    # fused subsystem
    **{name: _M + "fused" for name in (
        "saif_fused", "saif_fused_eliminated", "fused_baseline_cm",
        "fused_objective", "fused_path", "fused_lambda_max", "FusedDesign",
        "FusedPathResult", "prepare_fused", "build_tree", "build_schedule",
        "transform_design", "transform_design_scan",
        "transform_design_device", "recover_beta", "recover_beta_device",
        "recover_from_transformed", "eliminate_b_ls", "recover_b_ls")},
}

_SUBMODULES = {
    "_compat", "active_set", "api", "batch", "batch_fast", "cm", "cv",
    "duality", "dynamic", "fused", "group", "homotopy", "inner_backend",
    "losses",
    "online", "path", "saif", "screen_backend", "screen_rule", "select",
    "sequential", "server", "serving", "warm_cache",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    if name in _SUBMODULES:
        return importlib.import_module(_M + name)
    raise AttributeError(f"module 'repro_torch.core' has no attribute "
                         f"{name!r}")


def __dir__():
    return sorted(set(__all__) | _SUBMODULES | set(globals()))


class _LazyCoreModule(types.ModuleType):
    """Keeps ``from repro_torch.core import saif`` resolving to the
    *function*. ``saif`` is both a submodule and a public export; the
    import machinery sets the submodule as a package attribute at its
    first load, which would then shadow ``__getattr__``. Dropping exactly
    that setattr keeps every access on the lazy resolver (``from
    repro_torch.core.saif import ...`` goes through ``sys.modules`` and is
    unaffected)."""

    def __setattr__(self, name, value):
        if name == "saif" and isinstance(value, types.ModuleType):
            return
        super().__setattr__(name, value)


sys.modules[__name__].__class__ = _LazyCoreModule
