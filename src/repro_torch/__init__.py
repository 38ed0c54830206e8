"""repro_torch — the PyTorch/CUDA port of ``repro`` (SAIF, arXiv 1806.05817).

The serial SAIF solve, the fleet (B problems over one design, solved
together, with optional sample weights), the warm-started lambda path,
K-fold cross-validation and model selection (1-SE rule, stability
selection) for least squares and logistic loss, tree fused LASSO through
the Theorem-6 transform, and the paper's baselines (dynamic screening,
the sequential path, the strong-rule homotopy, the unscreened CM), with
the screening scan, the violation histogram, the CM burst (serial and
problem-gridded, with and without fused LASSO's unpenalized slot), the
Gram sweep (serial and problem-gridded), the residual-form CM epochs, the
wide-design CM sweep of the baselines and the chain transform as CUDA C++
kernels for Hopper (``csrc/``). Entry points run on the card unless the
caller passes ``device="cpu"``.
"""
from repro_torch.core import *  # noqa: F401,F403
from repro_torch.core import __all__  # noqa: F401
