"""SAIF core in torch: the serial solve, the fleet (weighted too; the
fast-parity lockstep engine with its certified mixed-precision screen), the
lambda path, fused LASSO, K-fold CV and model selection, the paper's
baselines (dynamic screening, the sequential path, the strong-rule
homotopy, the unscreened CM), and their building blocks."""
from repro_torch.core.batch import (FleetPrep, fleet_solve, prepare_fleet,
                                    resolve_batch_inner, saif_batch)
from repro_torch.core.cm import cm_epoch, solve_lasso_cm
from repro_torch.core.cv import (CVPathResult, cv_solve, kfold_weights,
                                 one_se_lambda)
from repro_torch.core.batch_fast import solve_fleet_fast
from repro_torch.core.duality import (dot_error_gamma, dual_point,
                                      kkt_residual, lambda_max,
                                      mixed_precision_gamma, unit_roundoff,
                                      widened_radius)
from repro_torch.core.dynamic import DynConfig, DynResult, dynamic_screening
from repro_torch.core.fused import (FusedDesign, FusedPathResult,
                                    build_schedule, build_tree,
                                    eliminate_b_ls, fused_baseline_cm,
                                    fused_lambda_max, fused_objective,
                                    fused_path, prepare_fused, recover_b_ls,
                                    recover_beta, recover_beta_device,
                                    recover_from_transformed, saif_fused,
                                    saif_fused_eliminated, transform_design,
                                    transform_design_device,
                                    transform_design_scan)
from repro_torch.core.homotopy import (HomotopyConfig, HomotopyResult,
                                      homotopy_path, support_metrics)
from repro_torch.core.losses import get_loss
from repro_torch.core.path import (SaifPathResult, lambda_grid, run_path,
                                   saif_path, saif_path_naive)
from repro_torch.core.saif import (PathState, SaifConfig, SaifResult,
                                   prepare_path, saif, solve_scalar)
from repro_torch.core.select import (Select, SelectionReport, select_solve,
                                     stability_frequencies, subsample_weights)
from repro_torch.core.sequential import SeqConfig, sequential_path

__all__ = ["saif", "SaifConfig", "SaifResult", "PathState", "prepare_path",
           "solve_scalar", "get_loss", "kkt_residual", "lambda_max",
           "saif_path", "saif_path_naive", "run_path", "lambda_grid",
           "SaifPathResult", "saif_fused", "fused_path", "prepare_fused",
           "FusedDesign", "FusedPathResult", "fused_lambda_max",
           "fused_baseline_cm", "fused_objective", "saif_fused_eliminated",
           "eliminate_b_ls", "recover_b_ls", "build_tree", "build_schedule",
           "transform_design", "transform_design_scan",
           "transform_design_device", "recover_beta", "recover_beta_device",
           "recover_from_transformed", "fleet_solve", "saif_batch",
           "prepare_fleet", "FleetPrep", "resolve_batch_inner", "cv_solve",
           "kfold_weights", "one_se_lambda", "CVPathResult", "Select",
           "SelectionReport", "select_solve", "subsample_weights",
           "stability_frequencies", "dynamic_screening", "DynConfig",
           "DynResult", "sequential_path", "SeqConfig", "homotopy_path",
           "HomotopyConfig", "HomotopyResult", "support_metrics",
           "solve_lasso_cm", "cm_epoch", "dual_point", "solve_fleet_fast",
           "unit_roundoff", "dot_error_gamma", "mixed_precision_gamma",
           "widened_radius"]
