"""repro_torch — the PyTorch/CUDA port of ``repro`` (SAIF, arXiv 1806.05817).

The serial SAIF solve for least squares and logistic loss, with the
screening scan, the violation histogram and the CM burst as CUDA C++
kernels for Hopper (``csrc/``). Entry points run on the card unless the
caller passes ``device="cpu"``.
"""
from repro_torch.core import (PathState, SaifConfig, SaifResult, get_loss,
                              kkt_residual, lambda_max, prepare_path, saif,
                              solve_scalar)

__all__ = ["saif", "SaifConfig", "SaifResult", "PathState", "prepare_path",
           "solve_scalar", "get_loss", "kkt_residual", "lambda_max"]
