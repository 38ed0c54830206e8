"""Parameter trees: nested dicts of tensors, walked with their keys sorted
at every level, the order in which ``jax.tree`` flattens the reference's
dicts. The models, the optimizer, the compression and the train step all
take their leaves from here."""
from __future__ import annotations


def leaf_paths(tree, prefix=()):
    """(path, leaf) pairs of a nested dict, keys in sorted order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from leaf_paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def leaves(tree) -> list:
    """The leaves of a nested dict, in :func:`leaf_paths` order."""
    return [v for _, v in leaf_paths(tree)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of the
    trees in ``rest`` (the same dict structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)
