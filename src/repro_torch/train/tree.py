"""Parameter trees (nested dicts of tensors, and tuples of them) as the
JAX package's pytrees flatten them: dict keys in sorted order, tuple items
in order, each leaf named by its path as ``jax.tree_util.keystr`` names it
(``[0]['layers']['dense0']['wq']``, ``[1]['step']``)."""
from __future__ import annotations

from typing import Callable


def leaves(tree, prefix: str = "") -> list[tuple[str, object]]:
    """[(keystr path, leaf)] in the JAX package's flattening order."""
    if isinstance(tree, dict):
        return [item for key in sorted(tree)
                for item in leaves(tree[key], f"{prefix}[{key!r}]")]
    if isinstance(tree, (tuple, list)):
        return [item for i, sub in enumerate(tree)
                for item in leaves(sub, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten(like, values: list):
    """A tree of ``like``'s structure whose leaves are ``values``, given in
    the order ``leaves(like)`` lists them."""
    by_path = dict(zip((p for p, _ in leaves(like)), values))

    def rebuild(t, prefix):
        if isinstance(t, dict):
            return {k: rebuild(v, f"{prefix}[{k!r}]") for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return type(t)(rebuild(v, f"{prefix}[{i}]")
                           for i, v in enumerate(t))
        return by_path[prefix]
    return rebuild(like, "")
