"""Nested dicts of tensors: what the reference's ``jax.tree`` calls do to
a train state's pytrees (parameters, moments, gradients)."""

from __future__ import annotations


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (nested dicts), with the nodes of
    ``rest`` at the same keys; a node of ``rest`` below one of ``tree``'s
    leaves is passed whole (Adafactor's per-leaf state)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in ``jax.tree.leaves``' order: dict keys sorted."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]
