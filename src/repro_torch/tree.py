"""Trees of tensors: nested dicts, tuples and lists.

The reference maps over its parameter and optimizer trees with
``jax.tree``; the port's trees are the same nested dicts holding
tensors, and these helpers are what it needs of ``jax.tree``. Leaves
come in ``jax.tree``'s order (dict keys sorted), so a reduction over
them adds in the reference's order.
"""

from __future__ import annotations

from typing import Any, Callable


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The leaves of ``tree``, dict keys in sorted order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(skeleton: Any, leaves: list) -> Any:
    """A tree shaped like ``skeleton`` holding ``leaves``, in
    :func:`tree_leaves` order."""
    it = iter(leaves)

    def build(node: Any) -> Any:
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (tuple, list)):
            return type(node)(build(v) for v in node)
        return next(it)

    out = build(skeleton)
    end = object()
    if next(it, end) is not end:
        raise ValueError("more leaves than the skeleton holds")
    return out
