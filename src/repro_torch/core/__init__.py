"""SAIF core in torch: the serial solve and its building blocks."""
from repro_torch.core.duality import kkt_residual, lambda_max
from repro_torch.core.losses import get_loss
from repro_torch.core.saif import (PathState, SaifConfig, SaifResult,
                                   prepare_path, saif, solve_scalar)

__all__ = ["saif", "SaifConfig", "SaifResult", "PathState", "prepare_path",
           "solve_scalar", "get_loss", "kkt_residual", "lambda_max"]
