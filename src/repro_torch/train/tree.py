"""Nested dicts and lists of tensors as trees: the port's stand-in for
``jax.tree`` over its params, optimiser states and train states.  Dict
keys go in sorted order, as JAX flattens them, and a leaf's path is its
keys and list indices joined by "/", as JAX's checkpoint keys are."""
from __future__ import annotations


def _is_node(t) -> bool:
    return isinstance(t, (dict, list, tuple))


def _children(t):
    if isinstance(t, dict):
        return [(str(k), t[k]) for k in sorted(t)]
    return [(str(i), c) for i, c in enumerate(t)]


def tree_paths(tree, prefix="") -> list[tuple[str, object]]:
    """(path, leaf) pairs in flattening order."""
    if not _is_node(tree):
        return [(prefix, tree)]
    out = []
    for k, c in _children(tree):
        out += tree_paths(c, f"{prefix}/{k}" if prefix else k)
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_paths(tree)]


def _build(t, it):
    if isinstance(t, dict):
        return {k: _build(t[k], it) for k in sorted(t)}
    if isinstance(t, (list, tuple)):
        return type(t)(_build(c, it) for c in t)
    return next(it)


def tree_unflatten(template, leaves):
    """``template``'s structure with ``leaves`` (in flattening order) in
    place of its own.  (A module-level builder: a closure that called
    itself would hold ``leaves`` in a reference cycle, alive until the
    garbage collector ran.)"""
    return _build(template, iter(leaves))


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree of ``rest`` (same structure)."""
    cols = [tree_leaves(tree)] + [tree_leaves(r) for r in rest]
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*cols)])
