"""Auto-lambda model selection: 1-SE CV and stability selection (port of
``repro.core.select``).

:func:`select_solve` answers the question users have, which features,
without asking them to pick a lambda:

  1. the K-fold CV fleet scores the grid (``core/cv.py``);
  2. the **1-SE rule** picks the largest lambda within one standard error
     of the CV minimum (``rule="min"`` keeps the raw argmin);
  3. optional **stability selection** (Meinshausen-Buehlmann): B random
     subsamples solved as ONE weighted :func:`fleet_solve` (binary row
     masks are exact row subsampling), giving per-feature selection
     frequencies and the stable support ``freq >= pi_threshold``;
  4. a full-data refit at the chosen lambda (the serial engine).

On a card the CV and stability fleets of least squares run K1b + K2b +
K6b and the refit K1/K2/K3. A :class:`Select` is checked at construction
by the admission control of ``core/serving.py`` (``RequestError``, a
``ValueError``). Module scope stays numpy and stdlib only (the lazy public
surface); torch loads with the functions that solve.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np

__all__ = ["Select", "SelectionReport", "subsample_weights",
           "stability_frequencies", "select_solve"]


@dataclasses.dataclass(frozen=True)
class Select:
    """Model-selection request: CV over ``lams``, 1-SE choice, optional
    stability selection, full-data refit. ``deadline_s`` and ``priority``
    are the serving knobs every request carries (validated here, read by
    :class:`~repro_torch.core.serving.ServingSession`)."""
    lams: Any
    n_folds: int = 5
    rule: str = "1se"                 # "1se" | "min"
    stability: bool = True
    n_subsamples: int = 16
    subsample_frac: float = 0.5
    pi_threshold: float = 0.6
    seed: int = 0
    refit: bool = True
    keep_fold_betas: bool = False
    deadline_s: Optional[float] = None
    priority: int = 0

    def __post_init__(self):
        from repro_torch.core.serving import validate_request
        validate_request(self)


class SelectionReport(NamedTuple):
    """What :func:`select_solve` hands back."""
    lams: np.ndarray                   # (L,) descending CV grid
    cv_mean: np.ndarray                # (L,) mean held-out loss
    cv_se: np.ndarray                  # (L,) standard error across folds
    lam_min: float                     # argmin of cv_mean
    lam_1se: float                     # 1-SE rule choice
    lam: float                         # the chosen lambda (per rule)
    rule: str                          # "1se" | "min"
    frequencies: Optional[np.ndarray]  # (p,) selection frequencies
    stable_support: Optional[np.ndarray]   # indices with freq >= pi
    pi_threshold: float
    beta: Optional[Any]                # (p,) full-data refit at lam
    best_result: Optional[Any]         # the refit's SaifResult
    fold_betas: Optional[Any]          # per-lambda (K, p), if kept
    n_compilations: Optional[int]      # None: nothing compiles in the port


def subsample_weights(n: int, n_subsamples: int, frac: float,
                      seed: int = 0, dtype=None) -> "torch.Tensor":
    """(B, n) binary row masks, each keeping ``floor(frac * n)`` rows drawn
    without replacement (numpy's RNG, bitwise the reference's masks for
    the same seed): the stability-selection analogue of
    :func:`~repro_torch.core.cv.kfold_weights`. A CPU tensor, float64
    unless ``dtype`` says otherwise."""
    import torch
    m = int(frac * n)
    if not 1 <= m < n:
        raise ValueError(f"subsample_frac={frac} keeps {m} of {n} rows; "
                         f"need 1 <= rows < n")
    rng = np.random.default_rng(seed)
    W = np.zeros((n_subsamples, n))
    for b in range(n_subsamples):
        W[b, rng.choice(n, size=m, replace=False)] = 1.0
    return torch.from_numpy(W).to(dtype or torch.float64)


def stability_frequencies(X, y, lam: float, config, n_subsamples: int,
                          frac: float, seed: int = 0, device=None
                          ) -> Tuple[np.ndarray, Any]:
    """Selection frequency per feature over B subsample solves, run as ONE
    weighted fleet. Returns ``(freq (p,), the fleet's SaifResult)``."""
    import torch
    from repro_torch.core.batch import fleet_solve
    from repro_torch.core.saif import as_tensor, resolve_device

    dev = resolve_device(device)
    X = as_tensor(X, dev)
    y = as_tensor(y, dev, X.dtype)
    n = X.shape[0]
    W = subsample_weights(n, n_subsamples, frac, seed=seed, dtype=X.dtype)
    Y = y.expand(int(n_subsamples), n).contiguous()
    fr = fleet_solve(X, Y, float(lam), config, device=dev, weights=W)
    # an exact count times 1/B: the reference's mean rounds so (XLA turns
    # its division by B into a product with 1/B), and the stable support
    # compares these values with pi_threshold
    count = (torch.abs(fr.beta) > 0).to(X.dtype).sum(dim=0)
    freq = count * (1.0 / fr.beta.shape[0])
    return freq.cpu().numpy(), fr


def select_solve(X, y, req: Select, config=None,
                 device=None) -> SelectionReport:
    """Run the full selection protocol (module docstring) on (X, y).
    ``device=None`` runs on the card; pass ``device="cpu"`` for the plain
    path on the CPU."""
    from repro_torch.core.cv import cv_solve, one_se_lambda
    from repro_torch.core.saif import (SaifConfig, as_tensor, resolve_device,
                                       saif)

    config = config or SaifConfig()
    dev = resolve_device(device)
    X = as_tensor(X, dev)
    y = as_tensor(y, dev, X.dtype)
    lams = tuple(float(l) for l in np.asarray(req.lams).ravel())
    cv = cv_solve(X, y, lams, n_folds=int(req.n_folds), config=config,
                  seed=int(req.seed),
                  keep_fold_betas=bool(req.keep_fold_betas), refit=False,
                  device=dev)
    lam_min = float(cv.best_lam)
    lam_1se = one_se_lambda(cv.lams, cv.cv_mean, cv.cv_se)
    lam = lam_1se if req.rule == "1se" else lam_min

    freq = stable = None
    if req.stability:
        freq, _ = stability_frequencies(
            X, y, lam, config, int(req.n_subsamples),
            float(req.subsample_frac), seed=int(req.seed) + 1, device=dev)
        stable = np.flatnonzero(freq >= float(req.pi_threshold))

    beta = best = None
    if req.refit:
        best = saif(X, y, lam, config, device=dev)
        beta = best.beta
    return SelectionReport(
        lams=cv.lams, cv_mean=cv.cv_mean, cv_se=cv.cv_se, lam_min=lam_min,
        lam_1se=lam_1se, lam=lam, rule=str(req.rule), frequencies=freq,
        stable_support=stable, pi_threshold=float(req.pi_threshold),
        beta=beta, best_result=best, fold_betas=cv.fold_betas,
        n_compilations=None)
