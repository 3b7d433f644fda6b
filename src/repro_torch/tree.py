"""Parameter trees: nested dicts, lists and tuples (NamedTuples too) of
tensors, the port's counterpart of the JAX pytrees that the reference's
optimizers, train step and checkpoints walk.

Leaves are visited in the order ``jax.tree_util`` visits them: dict keys
sorted, list and tuple items in order.  ``None`` is an empty subtree, as
in JAX.
"""

from __future__ import annotations

__all__ = ["tree_map", "tree_leaves", "tree_flatten_with_path",
           "tree_unflatten"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), in a tree of that structure;
    ``fn`` is called in leaf order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *items)
                            for items in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *items) for items in zip(tree, *rest))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_flatten_with_path(tree, prefix=()):
    """[(path, leaf)] with a path a tuple of dict keys, list / tuple indices
    and NamedTuple field names."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in tree_flatten_with_path(tree[k], prefix + (k,))]
    if _is_namedtuple(tree):
        return [item for name, v in zip(tree._fields, tree)
                for item in tree_flatten_with_path(v, prefix + (name,))]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in tree_flatten_with_path(v, prefix + (i,))]
    if tree is None:
        return []
    return [(prefix, tree)]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure holding ``leaves`` (in
    ``tree_leaves(like)`` order)."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
