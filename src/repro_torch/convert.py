"""State carried across from the reference package, as numpy arrays.

``repro``'s ``PathState`` and a solve's final slots, read out with
``np.asarray`` on each field, become the port's ``PathState`` and the
``(warm_idx, warm_beta)`` pair that :func:`~repro_torch.core.saif.solve_scalar`
takes, or the slot-preserving warm state of the path engine; its
``FusedDesign`` becomes the port's, its ``FleetPrep`` the port's fleet
preparation, and its ``GroupPrep`` and a group solve's final slots the
port's group preparation and warm triple; the LM scaffold's parameter
tree, read out with ``jax.tree.map(np.asarray, params)``, becomes the
port's (:func:`lm_params_from_numpy`), and a training state (parameters,
AdamW step, m and v) the port's ``TrainState``
(:func:`train_state_from_numpy`). Nothing here imports the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.batch import FleetPrep
from repro_torch.core.fused import FusedDesign, LevelSchedule, TreeTransform
from repro_torch.core.group import GroupPrep
from repro_torch.core.inner_backend import cold_inner_carry
from repro_torch.core.path import WarmState, _warm_state
from repro_torch.core.saif import PathState, as_tensor, resolve_device


def path_state_from_numpy(X, y, c0, col_norm, lam_max, c0_max, c0_median,
                          b0=0.0, n_true=0, p_true=0,
                          device=None) -> PathState:
    """A port :class:`PathState` from the fields of the reference's, on
    ``device`` (None = the card). The dtype follows ``X``."""
    dev = resolve_device(device)
    X = as_tensor(np.asarray(X), dev)
    return PathState(X=X, y=as_tensor(np.asarray(y), dev, X.dtype),
                     c0=as_tensor(np.asarray(c0), dev, X.dtype),
                     col_norm=as_tensor(np.asarray(col_norm), dev, X.dtype),
                     lam_max=float(lam_max), c0_max=float(c0_max),
                     c0_median=float(c0_median), b0=float(b0),
                     n_true=int(n_true), p_true=int(p_true))


def warm_start_from_numpy(active_idx, active_mask, beta):
    """(warm_idx, warm_beta) from a solve's final slot map ``active_idx``
    (k_max,), its validity ``active_mask`` and the full solution ``beta``
    (p,): the live slots' feature ids, in slot order, and their
    coefficients (CPU tensors; ``solve_scalar`` moves them)."""
    idx = np.asarray(active_idx)[np.asarray(active_mask, bool)]
    vals = np.asarray(beta)[idx]
    return torch.from_numpy(idx.astype(np.int64)), torch.from_numpy(vals)


def warm_state_from_numpy(active_idx, active_mask, beta, unpen_idx=None,
                          inner_backend: str = "torch",
                          device=None) -> WarmState:
    """The path engine's slot-preserving warm state from a solve's final
    slots and full solution, as the reference's ``_warm_state`` builds it:
    the slot layout masked down to the nonzero support, the unpenalized
    slot (``unpen_idx``) kept resident at any value. The inner carry is a
    cold one for the resolved backend ``inner_backend`` (a Gram engine
    rebuilds it once)."""
    dev = resolve_device(device)
    idx = torch.from_numpy(np.asarray(active_idx).astype(np.int64)).to(dev)
    mask = torch.from_numpy(np.array(active_mask, bool)).to(dev)
    beta = as_tensor(np.asarray(beta), dev)
    carry = cold_inner_carry(idx.shape[0], beta.dtype, dev,
                             backend=inner_backend)
    return _warm_state(idx, mask, beta, carry,
                       -1 if unpen_idx is None else int(unpen_idx))


def fused_design_from_ref(design, device=None) -> FusedDesign:
    """The port's :class:`FusedDesign` from the reference's (its tree, level
    schedule, transformed design ``Xt`` and ``unpen_idx``, each read with
    ``np.asarray``), with ``Xt`` on ``device`` (None = the card)."""
    t, s = design.tree, design.schedule
    tree = TreeTransform(parent=np.asarray(t.parent),
                         edge_child=np.asarray(t.edge_child),
                         topo=np.asarray(t.topo), root=int(t.root))
    schedule = LevelSchedule(child=np.asarray(s.child),
                             parent=np.asarray(s.parent),
                             edge=np.asarray(s.edge),
                             valid=np.asarray(s.valid),
                             is_chain=bool(s.is_chain))
    return FusedDesign(tree=tree, schedule=schedule,
                       Xt=as_tensor(np.asarray(design.Xt),
                                    resolve_device(device)),
                       unpen_idx=int(design.unpen_idx))


def fleet_prep_from_numpy(X, Y, c0, col_norm, c0_max, c0_median, W=None,
                          device=None) -> FleetPrep:
    """A port :class:`~repro_torch.core.batch.FleetPrep` from the fields of
    the reference's (``X`` (n, p), ``Y`` (B, n), ``c0`` (B, p), the column
    norms, the per-problem ``c0_max`` / ``c0_median`` and the sample
    weights ``W`` (B, n) or None), on ``device`` (None = the card). The
    reference broadcasts shared norms to (B, p); an unweighted
    preparation's identical rows become the port's shared (p,) vector, a
    weighted one keeps its (B, p) per-problem norms. Pass an unpadded
    preparation; :func:`~repro_torch.core.batch.pad_fleet_prep` pads it."""
    dev = resolve_device(device)
    X = as_tensor(np.asarray(X), dev)
    cn = np.asarray(col_norm)
    if W is None and cn.ndim == 2:
        if not (cn == cn[:1]).all():
            raise ValueError("per-problem column norms need the weights W "
                             "they came from")
        cn = cn[0]
    return FleetPrep(X=X, Y=as_tensor(np.atleast_2d(np.asarray(Y)), dev,
                                      X.dtype),
                     c0=as_tensor(np.asarray(c0), dev, X.dtype),
                     col_norm=as_tensor(cn, dev, X.dtype),
                     c0_max=[float(v) for v in np.asarray(c0_max)],
                     c0_median=[float(v) for v in np.asarray(c0_median)],
                     W=None if W is None else as_tensor(
                         np.atleast_2d(np.asarray(W)), dev, X.dtype))


def group_prep_from_numpy(X, y, c0, gfro, gsize, h, k_max,
                          device=None) -> GroupPrep:
    """A port :class:`GroupPrep` from the fields of the reference's, on
    ``device`` (None = the card). The dtype follows ``X``."""
    dev = resolve_device(device)
    X = as_tensor(np.asarray(X), dev)
    return GroupPrep(X=X, y=as_tensor(np.asarray(y), dev, X.dtype),
                     c0=as_tensor(np.asarray(c0), dev, X.dtype),
                     gfro=as_tensor(np.asarray(gfro), dev, X.dtype),
                     gsize=int(gsize), h=int(h), k_max=int(k_max))


def group_warm_from_numpy(gidx, gmask, beta_slots):
    """The group engine's warm triple ``(gidx, gmask, beta_slots)`` from a
    group solve's final slot state (CPU tensors; ``group_solve`` moves
    them to the preparation's device)."""
    return (torch.from_numpy(np.asarray(gidx).astype(np.int64)),
            torch.from_numpy(np.array(gmask, bool)),
            torch.from_numpy(np.array(beta_slots)))


def lm_params_from_numpy(tree, cfg, device=None):
    """The port's LM parameter tree from the reference's, read out as numpy
    arrays, on ``device`` (None = the card), each leaf's dtype kept. Every
    leaf is checked against :func:`~repro_torch.models.lm.param_shapes`
    of ``cfg``: a missing, extra or misshapen leaf raises ``ValueError``."""
    from repro_torch.models.lm import leaf_paths, param_shapes
    dev = resolve_device(device)
    want = dict(leaf_paths(param_shapes(cfg)))
    got = dict(leaf_paths(tree))
    missing = sorted(".".join(p) for p in want.keys() - got.keys())
    extra = sorted(".".join(p) for p in got.keys() - want.keys())
    if missing or extra:
        raise ValueError(f"LM parameter tree does not match {cfg.name}: "
                         f"missing {missing}, extra {extra}")
    out = {}
    for path, shp in want.items():
        a = np.asarray(got[path])
        if a.shape != tuple(shp):
            raise ValueError(f"LM parameter {'.'.join(path)} has shape "
                             f"{a.shape}, {cfg.name} needs {tuple(shp)}")
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = as_tensor(a, dev)
    return out


def train_state_from_numpy(params_tree, opt_tree, cfg, device=None):
    """The port's ``launch.steps.TrainState`` from the reference's, read
    out as numpy arrays: ``params_tree`` its parameters and ``opt_tree`` its
    ``AdamWState`` (step, m, v) in that field order (the reference's
    NamedTuple of numpy arrays, or any such triple), on ``device`` (None =
    the card), each leaf's dtype kept and the step int32. m and v are
    checked as the parameters are (:func:`lm_params_from_numpy`): a
    missing, extra or misshapen leaf raises ``ValueError``."""
    from repro_torch.launch.steps import TrainState
    from repro_torch.optim.adamw import AdamWState
    dev = resolve_device(device)
    step, m, v = opt_tree
    step = np.asarray(step)
    if step.shape != ():
        raise ValueError(f"AdamW step has shape {step.shape}, needs ()")
    return TrainState(
        params=lm_params_from_numpy(params_tree, cfg, device=dev),
        opt=AdamWState(step=torch.as_tensor(int(step), dtype=torch.int32,
                                            device=dev),
                       m=lm_params_from_numpy(m, cfg, device=dev),
                       v=lm_params_from_numpy(v, cfg, device=dev)))
