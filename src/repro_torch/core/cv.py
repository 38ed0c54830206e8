"""K-fold cross-validated lambda paths on the fleet (port of
``repro.core.cv``).

The glmnet-style protocol, K folds x L lambdas, is a fleet workload: the K
fold problems share the design X and differ only in which rows count.
:func:`cv_solve` runs the fold fleet one lambda at a time (descending,
warm-started): the O(p) screen is shared across folds at every outer step
(K1b on the card), and each fold's slots and Gram carry survive every
lambda handoff verbatim (the slot-preserving warm state of the path
engine, per problem).

Fold masking is the sample-weight trick: fold k's training problem is the
LASSO on diag(w_k) rows with binary w_k, which equals the row-subsampled
problem exactly, while X (and so the screening scan and the gathered
active blocks) stays shared. Per-fold column norms, c0 and lambda_max ride
along as (K, p) and K-vectors. The Thm-2 sequential ball assumes the
unweighted null dual, so weighted fleets run on the (precision-floored)
gap ball alone. On a card least-squares folds run K1b + K2b + the Gram
sweep kernel K6b; the refit is the serial solve (K1/K2/K3).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.batch import (_solve_fleet, fleet_warm_state,
                                    initial_support_batch, prepare_fleet,
                                    resolve_batch_inner, stack_results)
from repro_torch.core.losses import get_loss
from repro_torch.core.saif import (SaifConfig, SaifResult,
                                   add_batch_size_static, as_tensor,
                                   default_capacity, resolve_device, saif)
from repro_torch.core.screen_backend import (resolve_batch_screen,
                                             resolve_screen_rule)

Tensor = torch.Tensor


class CVPathResult(NamedTuple):
    lams: np.ndarray            # (L,) descending grid
    cv_mean: np.ndarray         # (L,) mean held-out loss per lambda
    cv_se: np.ndarray           # (L,) standard error across folds
    best_lam: float             # argmin of cv_mean
    beta: Optional[Tensor]      # (p,) full-data refit at best_lam
    best_result: Optional[SaifResult]
    fold_betas: Optional[List[Tensor]]  # per-lambda (K, p) if kept
    n_compilations: Optional[int]   # None: nothing compiles in the port
    # the port's addition: per lambda the fold fleet's stacked SaifResult
    # (gaps, outer steps, traces, slots, carries), kept with fold_betas
    fold_results: Optional[List[SaifResult]] = None


def kfold_weights(n: int, n_folds: int, seed: int = 0,
                  dtype=torch.float64) -> Tensor:
    """(K, n) binary TRAIN-row masks: row k is 1 off fold k, 0 on it.
    Folds are a balanced random partition (numpy's RNG, bitwise the
    reference's masks for the same seed). A CPU tensor."""
    if not 2 <= n_folds <= n:
        raise ValueError(f"need 2 <= n_folds <= n, got {n_folds} for n={n}")
    rng = np.random.default_rng(seed)
    assign = rng.permutation(np.arange(n) % n_folds)
    W = np.ones((n_folds, n))
    W[assign, np.arange(n)] = 0.0
    return torch.from_numpy(W).to(dtype)


def cv_solve(X, y, lams: Sequence[float], n_folds: int = 5,
             config: SaifConfig = SaifConfig(), seed: int = 0,
             keep_fold_betas: bool = False, refit: bool = True,
             device=None) -> CVPathResult:
    """K-fold cross-validation over a lambda grid.

    Solves the K fold problems as one weighted fleet at every lambda
    (descending, each fold warm-started from its own previous solution),
    scores each lambda by the mean held-out loss (``loss.value`` averaged
    over each fold's validation rows), and refits the winner on the full
    data with the serial solver. The h buffer is the grid's largest, so
    one capacity serves the whole grid; a fold that overflows it sends the
    whole grid back to its cold start at twice the capacity, as the
    reference does. ``device=None`` runs on the card; pass
    ``device="cpu"`` for the plain path on the CPU.
    """
    if config.unpen_idx is not None:
        raise NotImplementedError("cv_solve cross-validates plain-LASSO "
                                  "problems")
    if len(lams) == 0:
        raise ValueError("cv_solve needs a non-empty lambda grid")
    dev = resolve_device(device)
    loss = get_loss(config.loss)
    X = as_tensor(X, dev)
    y = as_tensor(y, dev, X.dtype)
    n, p = X.shape
    K = n_folds
    W = kfold_weights(n, K, seed=seed, dtype=X.dtype).to(dev)
    Y = y.expand(K, n).contiguous()
    lams_np = np.asarray(sorted([float(l) for l in lams], reverse=True))

    prep = prepare_fleet(X, Y, config, weights=W, device=dev)
    screen = resolve_batch_screen(config.screen_backend, dev, b=K, p=p)
    rule = resolve_screen_rule(config.screen_rule)
    # the grid's largest h: one candidate buffer and one capacity for the
    # whole K x L family; per-(fold, lambda) h_cap and h~ stay their own
    hs_grid = [[add_batch_size_static(config.c, lam, mx, md, p)
                for mx, md in zip(prep.c0_max, prep.c0_median)]
               for lam in lams_np]
    h = max(max(hs_l) for hs_l in hs_grid)
    k_max = config.k_max or default_capacity(h, p)
    # cold start at the grid's first lambda, computed once; elastic growth
    # pads it, as the serial solve's overflow recovery does
    cold = initial_support_batch(prep.c0, hs_grid[0], k_max, p, X.dtype)
    while True:
        pad = k_max - cold[0].shape[1]
        cold = tuple(torch.nn.functional.pad(t, (0, pad)) for t in cold)
        inner = resolve_batch_inner(config, n, k_max, K, dev,
                                    X.element_size(), weighted=True)
        init, carries = cold, None
        results: List[List[SaifResult]] = []
        overflowed = False
        for lam, hs_l in zip(lams_np, hs_grid):
            res = _solve_fleet(prep, [float(lam)] * K, config, hs=hs_l, h=h,
                               k_max=k_max, init_idx=init[0],
                               init_beta=init[1], init_mask=init[2],
                               inner=inner, screen=screen, use_seq=False,
                               rule=rule, carries=carries)
            results.append(res)
            if any(r.overflowed for r in res):
                # the grid is re-entered at twice the capacity; the rest of
                # this pass would be discarded (the reference runs it on)
                overflowed = True
                break
            init, carries = fleet_warm_state(res)
        if not overflowed or k_max >= p:
            break
        k_max = min(2 * k_max, p)

    # --- held-out scoring: mean validation loss per (fold, lambda) --------
    W_test = 1.0 - W                                        # (K, n)
    n_test = torch.sum(W_test, dim=1)                       # (K,)
    fold_betas = [torch.stack([r.beta for r in res]) for res in results]
    errs = [torch.sum(W_test * loss.value(B @ X.T, Y), dim=1) / n_test
            for B in fold_betas]
    err_kl = torch.stack(errs).cpu().numpy()                # (L, K)
    cv_mean = err_kl.mean(axis=1)
    cv_se = err_kl.std(axis=1, ddof=1) / np.sqrt(K)
    best_lam = float(lams_np[int(np.argmin(cv_mean))])

    beta_best = best_result = None
    if refit:
        best_result = saif(X, y, best_lam, config, device=dev)
        beta_best = best_result.beta
    return CVPathResult(
        lams=lams_np, cv_mean=cv_mean, cv_se=cv_se, best_lam=best_lam,
        beta=beta_best, best_result=best_result,
        fold_betas=fold_betas if keep_fold_betas else None,
        n_compilations=None,
        fold_results=([stack_results(res) for res in results]
                      if keep_fold_betas else None))


def one_se_lambda(lams: np.ndarray, cv_mean: np.ndarray,
                  cv_se: np.ndarray) -> float:
    """The glmnet 1-SE rule: the *largest* lambda whose CV error is within
    one standard error of the minimum, the sparsest model statistically
    indistinguishable from the best scorer. Expects the descending grid
    and per-lambda scores of a :class:`CVPathResult`."""
    lams = np.asarray(lams, np.float64)
    cv_mean = np.asarray(cv_mean, np.float64)
    cv_se = np.asarray(cv_se, np.float64)
    i_min = int(np.argmin(cv_mean))
    thresh = cv_mean[i_min] + cv_se[i_min]
    # descending grid: the first index within the threshold is the largest
    # eligible lambda (i_min itself qualifies, so one exists)
    return float(lams[int(np.argmax(cv_mean <= thresh))])


def cv_path(X, y, lams: Sequence[float], n_folds: int = 5,
            config: SaifConfig = SaifConfig(), seed: int = 0,
            keep_fold_betas: bool = False, refit: bool = True,
            device=None) -> CVPathResult:
    """DEPRECATED legacy frontend: a one-shot session over
    :func:`cv_solve`. Use ``repro_torch.open_session(Problem(X, y),
    config).solve(CV(n_folds, lams))``."""
    from repro_torch.core._compat import warn_deprecated
    from repro_torch.core.api import CV, Problem, open_session
    warn_deprecated("repro_torch.cv_path",
                    "session.solve(CV(n_folds, lams))")
    sess = open_session(Problem(X=X, y=y, loss=config.loss), config,
                        device=device)
    return sess.solve(CV(n_folds=n_folds,
                         lams=tuple(float(l) for l in lams), seed=seed,
                         keep_fold_betas=keep_fold_betas, refit=refit))
