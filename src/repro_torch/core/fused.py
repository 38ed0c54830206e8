"""Tree fused LASSO via the column transform of Theorem 6, in torch (port of
``repro.core.fused``).

Problem (17):  min_beta  sum_j f(x_j. beta, y_j) + lam ||D beta||_1,
with one row of D per edge of a tree. Rooting the tree, the new variables
are one difference per edge (penalized) and b = beta_root (unpenalized), so
  x_tilde_e = the sum of the columns of X in the subtree below edge e,
  x_b       = the sum of all columns,
and the problem becomes a plain LASSO in the edge variables with one
unpenalized coordinate b.

  * The tree's *level schedule* (nodes grouped by depth) is built on the
    host once per tree. The transform then visits the levels deepest
    first (:func:`transform_design_scan`, one ``index_add_`` per level)
    and :func:`recover_beta_device` visits them top down.
  * On a chain (the 1-D fused LASSO, the paper's Fig-7 workload) the
    transform is the column suffix sum, kernel K4
    (``kernels/fused``), an exact right fold bitwise equal to the numpy
    :func:`transform_design`.
  * b is not eliminated: it rides as the always-resident unpenalized slot
    of the SAIF active set (``SaifConfig.unpen_idx``), which serves every
    smooth loss, logistic included. Theorem 7's exact least-squares
    elimination (:func:`eliminate_b_ls`) stays as a parity oracle.

A fused session (``repro_torch.core.api``, ``penalty=fused(parent)``)
transforms once at ``open_session``, solves (or runs the path engine) on
the transformed design with the b column last, and recovers node-space
coefficients; :func:`saif_fused` and :func:`fused_path` are deprecated
shims over a one-shot session.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.cm import solve_lasso_cm
from repro_torch.core.duality import null_gradient
from repro_torch.core.losses import get_loss
from repro_torch.core.path import SaifPathResult
from repro_torch.core.saif import (SaifConfig, SaifResult, as_tensor,
                                   resolve_device, saif)

Tensor = torch.Tensor


class TreeTransform(NamedTuple):
    """Static description of the Theorem-6 transform for a given tree."""
    parent: np.ndarray        # (p,) parent[v] = parent node id, -1 at root
    edge_child: np.ndarray    # (p-1,) child node of edge e
    topo: np.ndarray          # (p,) nodes in topological (root-first) order
    root: int


class LevelSchedule(NamedTuple):
    """Nodes grouped by depth (the root excluded), one row per level padded
    to the widest with ``valid=False`` lanes. A level's children are
    distinct and their parents sit one level up, so a level reads only
    finished columns."""
    child: np.ndarray    # (L, W) int32 node ids (-1 padding)
    parent: np.ndarray   # (L, W) int32 parent ids
    edge: np.ndarray     # (L, W) int32 edge index of child (-1 padding)
    valid: np.ndarray    # (L, W) bool
    is_chain: bool       # path graph 0-1-...-p-1 rooted at 0


def build_tree(parent: np.ndarray) -> TreeTransform:
    parent = np.asarray(parent, np.int64)
    (roots,) = np.where(parent < 0)
    if len(roots) != 1:
        raise ValueError("parent array must encode exactly one root")
    root = int(roots[0])
    p = len(parent)
    children: list[list[int]] = [[] for _ in range(p)]
    for v, pa in enumerate(parent):
        if pa >= 0:
            children[pa].append(v)
    topo, stack = [], [root]
    while stack:
        v = stack.pop()
        topo.append(v)
        stack.extend(children[v])
    if len(topo) != p:
        raise ValueError("parent array does not encode a connected tree")
    edge_child = np.asarray([v for v in range(p) if v != root], np.int64)
    return TreeTransform(parent=parent, edge_child=edge_child,
                         topo=np.asarray(topo, np.int64), root=root)


def build_schedule(tree: TreeTransform) -> LevelSchedule:
    """Group the tree's nodes by depth: O(p) host work, once per tree."""
    p = len(tree.parent)
    depth = np.zeros(p, np.int64)
    for v in tree.topo:                       # parents precede children
        pa = tree.parent[v]
        if pa >= 0:
            depth[v] = depth[pa] + 1
    edge_of_child = np.full(p, -1, np.int64)
    edge_of_child[tree.edge_child] = np.arange(p - 1)
    n_levels = int(depth.max()) if p > 1 else 0
    levels = [[] for _ in range(n_levels)]
    for v in tree.topo:                       # deterministic: topo order
        if tree.parent[v] >= 0:
            levels[depth[v] - 1].append(v)
    width = max((len(l) for l in levels), default=1)
    child = np.full((n_levels, width), -1, np.int32)
    par = np.full((n_levels, width), -1, np.int32)
    edge = np.full((n_levels, width), -1, np.int32)
    valid = np.zeros((n_levels, width), bool)
    for d, nodes in enumerate(levels):
        m = len(nodes)
        child[d, :m] = nodes
        par[d, :m] = tree.parent[nodes]
        edge[d, :m] = edge_of_child[nodes]
        valid[d, :m] = True
    is_chain = bool(p >= 2 and
                    np.array_equal(tree.parent, np.arange(p) - 1))
    return LevelSchedule(child=child, parent=par, edge=edge, valid=valid,
                         is_chain=is_chain)


# --------------------------------------------------------------------------
# dense numpy reference transform (the parity oracle of the device paths)
# --------------------------------------------------------------------------

def transform_design(X: np.ndarray, tree: TreeTransform
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (X_bar (n, p-1) edge columns, xb (n,) the b column): child
    columns accumulated into their parents in reverse topological order."""
    X = np.asarray(X)
    sub = X.copy()
    for v in tree.topo[::-1]:
        pa = tree.parent[v]
        if pa >= 0:
            sub[:, pa] += sub[:, v]
    return sub[:, tree.edge_child], sub[:, tree.root].copy()


def recover_beta(beta_tilde: np.ndarray, b: float,
                 tree: TreeTransform) -> np.ndarray:
    """beta = T [beta_tilde; b]: prefix sums of the edge differences down
    the tree (numpy reference of :func:`recover_beta_device`)."""
    p = len(tree.parent)
    edge_of_child = np.full(p, -1, np.int64)
    edge_of_child[tree.edge_child] = np.arange(p - 1)
    beta = np.zeros(p)
    for v in tree.topo:
        pa = tree.parent[v]
        if pa < 0:
            beta[v] = b
        else:
            beta[v] = beta[pa] + beta_tilde[edge_of_child[v]]
    return beta


# --------------------------------------------------------------------------
# device transform: the level loop and the chain kernel K4
# --------------------------------------------------------------------------

def _levels(schedule: LevelSchedule, device, reverse: bool):
    """Per level, the valid lanes' (child, parent, edge) ids on ``device``.
    The schedule is uploaded once; the valid lanes of a row are a prefix
    (``build_schedule`` fills each row from the left)."""
    ids = [torch.as_tensor(a.astype(np.int64), device=device)
           for a in (schedule.child, schedule.parent, schedule.edge)]
    widths = schedule.valid.sum(axis=1).tolist()
    rows = range(len(widths))
    for d in (reversed(rows) if reverse else rows):
        yield tuple(a[d, :widths[d]] for a in ids)


def transform_design_scan(X, tree: TreeTransform,
                          schedule: Optional[LevelSchedule] = None
                          ) -> Tuple[Tensor, Tensor]:
    """Theorem-6 transform as a loop over the level schedule, deepest level
    first: each level adds its finished child columns into their parents
    (``index_add_``). On chains (one child per level) this is the numpy
    reference bitwise; on general trees it agrees up to the order of the
    per-parent child sums."""
    if schedule is None:
        schedule = build_schedule(tree)
    X = torch.as_tensor(X)
    if schedule.child.shape[0] == 0:            # single-node tree
        return X[:, :0], X[:, tree.root]
    sub = X.clone()
    for c, q, _ in _levels(schedule, X.device, reverse=True):
        sub.index_add_(1, q, sub[:, c])
    return sub[:, torch.as_tensor(tree.edge_child, device=X.device)], \
        sub[:, tree.root]


def transform_design_device(X, tree: TreeTransform,
                            schedule: Optional[LevelSchedule] = None,
                            backend: str = "auto"
                            ) -> Tuple[Tensor, Tensor]:
    """Transform dispatcher: ``cuda`` (the chain suffix-sum kernel K4; its
    plain version on a CPU tensor), ``torch`` (the level loop, any tree), or
    ``auto`` — K4 on a chain held on a CUDA device, the level loop
    otherwise."""
    if schedule is None:
        schedule = build_schedule(tree)
    X = torch.as_tensor(X)
    if backend == "auto":
        backend = ("cuda" if schedule.is_chain and X.device.type == "cuda"
                   else "torch")
    if backend == "cuda":
        if not schedule.is_chain:
            raise ValueError("the CUDA fused transform is the chain (1-D "
                             "fused lasso) special case; use "
                             "backend='torch' for general trees")
        from repro_torch.kernels.fused.fused import chain_suffix_sums
        S = chain_suffix_sums(X.contiguous())
        return S[:, 1:], S[:, 0]
    if backend != "torch":
        raise ValueError(f"unknown fused transform backend {backend!r}")
    return transform_design_scan(X, tree, schedule)


def recover_beta_device(beta_tilde, b, tree: TreeTransform,
                        schedule: Optional[LevelSchedule] = None) -> Tensor:
    """beta = T [beta_tilde; b], level by level from the root down on the
    device that holds ``beta_tilde``: one add per node in the numpy
    reference's order, so bitwise equal to :func:`recover_beta`."""
    if schedule is None:
        schedule = build_schedule(tree)
    beta_tilde = torch.as_tensor(beta_tilde)
    p = len(tree.parent)
    beta = torch.zeros(p, dtype=beta_tilde.dtype, device=beta_tilde.device)
    beta[tree.root] = torch.as_tensor(b, dtype=beta.dtype)
    for c, q, e in _levels(schedule, beta.device, reverse=False):
        beta[c] = beta[q] + beta_tilde[e]
    return beta


# --------------------------------------------------------------------------
# the fused problem object + SAIF drivers
# --------------------------------------------------------------------------

class FusedDesign(NamedTuple):
    """One-time transform of a fused problem: ``Xt`` holds the p-1 edge
    columns followed by the unpenalized b column at ``unpen_idx`` = p-1."""
    tree: TreeTransform
    schedule: LevelSchedule
    Xt: Tensor           # (n, p) transformed design, b column last
    unpen_idx: int


class FusedPathResult(NamedTuple):
    lams: np.ndarray
    betas: List[Tensor]        # node-space solutions (recovered)
    path: SaifPathResult       # transformed-space engine result


def prepare_fused(X, parent, backend: str = "auto",
                  device=None) -> FusedDesign:
    """The tree, its level schedule and the transformed design on
    ``device`` (None = the card): the one-time preparation every fused
    solve and path shares. The dtype follows ``X``."""
    dev = resolve_device(device)
    tree = build_tree(np.asarray(parent))
    schedule = build_schedule(tree)
    X_bar, xb = transform_design_device(as_tensor(X, dev), tree, schedule,
                                        backend)
    Xt = torch.cat([X_bar, xb[:, None]], dim=1)
    return FusedDesign(tree=tree, schedule=schedule, Xt=Xt,
                       unpen_idx=Xt.shape[1] - 1)


def recover_from_transformed(beta_t: Tensor,
                             design: FusedDesign) -> Tensor:
    """Node-space beta from a transformed-space solution (b column last)."""
    pt = beta_t.shape[0]
    return recover_beta_device(beta_t[:pt - 1], beta_t[pt - 1], design.tree,
                               design.schedule)


def saif_fused(X, y, parent, lam: float,
               config: SaifConfig = SaifConfig(),
               transform_backend: str = "auto",
               device=None) -> Tuple[Tensor, SaifResult]:
    """DEPRECATED legacy frontend: a one-shot fused session. Use
    ``repro_torch.open_session(Problem(X, y, penalty=fused(parent)),
    config).solve(Scalar(lam))``; the session transforms once and serves
    every later request from it. Returns (node-space beta, the
    transformed-space SaifResult)."""
    from repro_torch.core._compat import warn_deprecated
    from repro_torch.core.api import Problem, Scalar, open_session
    from repro_torch.core.api import fused as fused_penalty
    warn_deprecated("repro_torch.saif_fused",
                    "session.solve(Scalar(lam)) with penalty=fused(parent)")
    sess = open_session(
        Problem(X=X, y=y, loss=config.loss,
                penalty=fused_penalty(parent, transform_backend)),
        config, device=device)
    return sess.solve(Scalar(lam=float(lam)))


def fused_path(X, y, parent, lams, config: SaifConfig = SaifConfig(),
               transform_backend: str = "auto", segment_len: int = 16,
               device=None) -> FusedPathResult:
    """DEPRECATED legacy frontend: a one-shot fused session over the path
    engine, b pinned resident. Use ``open_session(Problem(X, y,
    penalty=fused(parent)), config).solve(Path(lams))``."""
    from repro_torch.core._compat import warn_deprecated
    from repro_torch.core.api import Path, Problem, open_session
    from repro_torch.core.api import fused as fused_penalty
    warn_deprecated("repro_torch.fused_path",
                    "session.solve(Path(lams)) with penalty=fused(parent)")
    sess = open_session(
        Problem(X=X, y=y, loss=config.loss,
                penalty=fused_penalty(parent, transform_backend)),
        config, segment_len=segment_len, device=device)
    return sess.solve(Path(lams=tuple(float(l) for l in lams)))


def fused_lambda_max(X, y, parent, loss: str = "least_squares",
                     transform_backend: str = "auto", device=None) -> float:
    """Smallest lam at which every coefficient is fused: the max
    |x_tilde^T f'| at the null model with b at its partial optimum."""
    design = prepare_fused(X, parent, transform_backend, device)
    y = as_tensor(y, design.Xt.device, design.Xt.dtype)
    _, c0, _ = null_gradient(get_loss(loss), design.Xt, y, design.unpen_idx)
    return float(torch.max(c0))


# --------------------------------------------------------------------------
# baselines and validation helpers
# --------------------------------------------------------------------------

def fused_baseline_cm(X, y, parent, lam: float, tol: float = 1e-9,
                      loss: str = "least_squares",
                      max_epochs: int = 100_000, device=None) -> Tensor:
    """Unscreened fused solve (the paper's CVX stand-in of Fig 7): full-width
    CM on the transformed problem, b unpenalized, any smooth loss."""
    design = prepare_fused(X, parent, "auto", device)
    y = as_tensor(y, design.Xt.device, design.Xt.dtype)
    beta_t = solve_lasso_cm(get_loss(loss), design.Xt, y, lam, tol=tol,
                            max_epochs=max_epochs,
                            unpen_idx=design.unpen_idx)
    return recover_from_transformed(beta_t, design)


def eliminate_b_ls(X_bar: np.ndarray, xb: np.ndarray, y: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Least-squares exact elimination of b (Theorem 7's projection), the
    parity oracle of the unpenalized slot."""
    q = xb / max(np.linalg.norm(xb), 1e-30)
    Xp = X_bar - np.outer(q, q @ X_bar)
    yp = y - q * (q @ y)
    return Xp, yp


def recover_b_ls(X_bar, xb, y, beta_tilde) -> float:
    r = y - X_bar @ beta_tilde
    return float((xb @ r) / max(xb @ xb, 1e-30))


def saif_fused_eliminated(X, y, parent, lam: float,
                          config: SaifConfig = SaifConfig(), device=None
                          ) -> Tuple[np.ndarray, SaifResult]:
    """Least-squares route: eliminate b exactly (numpy), solve a plain
    LASSO, recover. Parity oracle for the unpenalized-slot path."""
    if config.loss != "least_squares":
        raise ValueError("exact b-elimination is least-squares only; "
                         "saif_fused handles general losses")
    tree = build_tree(np.asarray(parent))
    X_bar, xb = transform_design(np.asarray(X), tree)
    y = np.asarray(y, X_bar.dtype)
    Xp, yp = eliminate_b_ls(X_bar, xb, y)
    res = saif(Xp, yp, lam, config, device=device)
    beta_tilde = res.beta.cpu().numpy()
    b = recover_b_ls(X_bar, xb, y, beta_tilde)
    return recover_beta(beta_tilde, b, tree), res


def fused_objective(X, y, parent, beta, lam,
                    loss: str = "least_squares") -> float:
    """Direct evaluation of (17), in float64 on the CPU, for validation."""
    tree = build_tree(np.asarray(parent))
    beta = np.asarray(torch.as_tensor(beta).cpu(), np.float64)
    X = np.asarray(torch.as_tensor(X).cpu(), np.float64)
    y = np.asarray(torch.as_tensor(y).cpu(), np.float64)
    z = torch.from_numpy(X @ beta)
    pen = np.sum(np.abs(beta[tree.edge_child] -
                        beta[tree.parent[tree.edge_child]]))
    val = torch.sum(get_loss(loss).value(z, torch.from_numpy(y)))
    return float(val) + lam * float(pen)
