"""Checkpointing: atomic, resumable (port of ``repro.ckpt.checkpoint``).

Layout, the reference's: ``<dir>/step_<N:08d>/`` with one
``arr_<i:05d>.npy`` per flattened leaf, in the sorted order of its path
key, and ``meta.json`` (``step``, ``names``, ``extra``). A path key joins
its parts with ``/``: a dict key as itself, a tuple or list index as
``[i]``, a NamedTuple field by its name. So a tree saved by either package
restores through the other's ``restore``.

Writes go to ``step_<N>.tmp``, ``meta.json`` last and fsynced, then
``os.replace`` and an fsync of the directory: a crash mid-flush never
corrupts the latest checkpoint, and a torn ``.tmp`` is invisible and
reclaimed by the next save of its step. The last 3 steps are kept.
``save_async`` copies device -> host now and flushes on a daemon thread.

Trees are dicts, tuples, lists and NamedTuples of tensors or numpy arrays
(None is an empty subtree, as in ``jax.tree_util``). ``restore`` puts the
leaves on ``device``, or where ``like``'s leaves lie.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Callable, Dict, Optional

import numpy as np

__all__ = ["save", "save_async", "wait_pending", "latest_step",
           "load_meta", "restore"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten_with_paths(tree, prefix=()) -> Dict[str, Any]:
    """``{path key: leaf}`` of a tree."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = [(str(k), v) for k, v in sorted(tree.items())]
    elif _is_namedtuple(tree):
        items = list(zip(tree._fields, tree))
    elif isinstance(tree, (tuple, list)):
        items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    else:
        return {"/".join(prefix): tree}
    out = {}
    for part, sub in items:
        out.update(_flatten_with_paths(sub, prefix + (part,)))
    return out


def _map_with_paths(tree, fn: Callable[[str, Any], Any], prefix=()):
    """``tree`` with every leaf replaced by ``fn(path key, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_paths(v, fn, prefix + (str(k),))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*[_map_with_paths(v, fn, prefix + (f,))
                            for f, v in zip(tree._fields, tree)])
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_with_paths(v, fn, prefix + (f"[{i}]",))
                          for i, v in enumerate(tree))
    return fn("/".join(prefix), tree)


def _host(leaf) -> np.ndarray:
    """A leaf as a host numpy array (a tensor copied off its device)."""
    if hasattr(leaf, "detach"):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str, step: int, tree: Any,
         extra: Optional[Dict[str, Any]] = None) -> str:
    """Synchronous atomic checkpoint write. Returns the final path."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    flat = _flatten_with_paths(tree)
    names = []
    for i, (key, leaf) in enumerate(sorted(flat.items())):
        np.save(os.path.join(tmp, f"arr_{i:05d}.npy"), _host(leaf))
        names.append(key)
    meta = {"step": step, "names": names, "extra": extra or {}}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _fsync_dir(ckpt_dir)
    _gc(ckpt_dir, keep=3)
    return final


def _fsync_dir(path: str):
    """Flush the directory entry so the atomic rename survives power loss
    (the rename itself is atomic; its durability needs the parent dir
    synced)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:         # pragma: no cover - exotic filesystems
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


_pending: list[threading.Thread] = []


def save_async(ckpt_dir: str, step: int, tree: Any,
               extra: Optional[Dict[str, Any]] = None) -> threading.Thread:
    """Device->host copy happens now; disk flush on a daemon thread."""
    host_tree = _map_with_paths(tree, lambda _, leaf: _host(leaf))
    t = threading.Thread(target=save, args=(ckpt_dir, step, host_tree, extra),
                         daemon=True)
    t.start()
    _pending.append(t)
    return t


def wait_pending():
    for t in _pending:
        t.join()
    _pending.clear()


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def load_meta(ckpt_dir: str, step: int) -> Dict[str, Any]:
    """Read a checkpoint's meta.json (names, step, extra) without
    touching the arrays: callers that must rebuild the ``like`` tree
    before :func:`restore` (the serving runtime's warm-state restore,
    which records leaf shapes/dtypes in ``extra``) peek here."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f)


def restore(ckpt_dir: str, step: int, like: Any,
            device=None) -> tuple[Any, Dict[str, Any]]:
    """Restore into the structure of ``like``. Each leaf takes its like
    leaf's dtype and lies on ``device``, or, with ``device=None``, on its
    like leaf's device (a numpy like leaf gives a numpy array)."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    keys = sorted(_flatten_with_paths(like))
    if set(meta["names"]) != set(keys):
        raise ValueError("checkpoint structure mismatch: "
                         f"{sorted(set(meta['names']) ^ set(keys))}")
    slot = {k: i for i, k in enumerate(keys)}

    def load(key, like_leaf):
        a = np.load(os.path.join(path, f"arr_{slot[key]:05d}.npy"))
        if hasattr(like_leaf, "detach") or device is not None:
            import torch
            t = torch.from_numpy(a)
            if hasattr(like_leaf, "detach"):
                return t.to(device=like_leaf.device if device is None
                            else device, dtype=like_leaf.dtype)
            return t.to(device=device)
        return a.astype(like_leaf.dtype) if hasattr(like_leaf, "dtype") \
            else a

    return _map_with_paths(like, load), meta["extra"]


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_")
                   and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
