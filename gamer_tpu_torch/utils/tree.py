"""Nested containers of parameters, walked in ``jax.tree_util``'s order.

The fits keep flatten_scene's parameters as a tuple of per-instance dicts
(components as a tuple of dicts under "comps"). Tuples and lists are walked
in order and dicts in the order of their sorted keys, as
``jax.tree_util.tree_leaves`` walks them, so a leaf's index means the same
thing in both packages (checkpoint files and fingerprints key on it).
``None`` is an empty subtree, as in JAX.
"""

from __future__ import annotations


def _children(node):
    if isinstance(node, dict):
        return [node[k] for k in sorted(node)]
    if isinstance(node, (tuple, list)):
        return list(node)
    return None


def tree_leaves(tree) -> list:
    """The leaves of ``tree``, depth first."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for k in kids for leaf in tree_leaves(k)]


def tree_map_with_path(fn, tree, *rest, path=()):
    """``tree`` with every leaf replaced by ``fn(path, leaf, *rest_leaves)``;
    ``path`` is the tuple of dict keys and sequence indices to the leaf and
    ``rest`` are trees of the same structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], *(r[k] for r in rest),
                                      path=path + (k,))
                for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        out = [tree_map_with_path(fn, v, *(r[i] for r in rest),
                                  path=path + (i,))
               for i, v in enumerate(tree)]
        return type(tree)(out)
    return fn(path, tree, *rest)


def tree_map(fn, tree, *rest):
    """``tree`` with every leaf replaced by ``fn(leaf, *rest_leaves)``."""
    return tree_map_with_path(lambda _p, leaf, *r: fn(leaf, *r), tree, *rest)


def tree_unflatten_like(tree, leaves):
    """A tree of ``tree``'s structure holding ``leaves`` in leaf order."""
    it = iter(leaves)
    return tree_map(lambda _leaf: next(it), tree)


def leaf_name(path) -> str:
    """The last dict key on a path ('' when the path has none)."""
    for key in reversed(path):
        if isinstance(key, str):
            return key
    return ""
