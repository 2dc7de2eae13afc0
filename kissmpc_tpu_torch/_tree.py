"""The few tree operations the port needs over its state: nested named
tuples (`EnvState`, `Problem`, `FleetCheckpoint`, ...), tuples, lists and
dicts, with tensors, arrays and numbers as leaves.  ``None`` is an empty
subtree, as in JAX's pytrees; a dict's leaves come in sorted key order."""

from __future__ import annotations

from typing import Any, Callable, Iterator, List


def _children(node):
    if isinstance(node, dict):
        return [node[k] for k in sorted(node)]
    return list(node)


def _is_node(x) -> bool:
    return isinstance(x, (tuple, list, dict))


def leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in order."""
    if tree is None:
        return []
    if _is_node(tree):
        return [leaf for child in _children(tree) for leaf in leaves(child)]
    return [tree]


def _rebuild(like, it: Iterator):
    if like is None:
        return None
    if not _is_node(like):
        return next(it)
    children = [_rebuild(child, it) for child in _children(like)]
    if isinstance(like, dict):
        return dict(zip(sorted(like), children))
    if hasattr(like, "_fields"):
        return type(like)(*children)
    return type(like)(children)


def unflatten(like, new_leaves) -> Any:
    """A tree of ``like``'s structure holding ``new_leaves`` in order."""
    new_leaves = list(new_leaves)
    count = len(leaves(like))
    if len(new_leaves) != count:
        raise ValueError(f"{len(new_leaves)} leaves for a tree of {count}")
    return _rebuild(like, iter(new_leaves))


def tree_map(fn: Callable, tree) -> Any:
    """``tree`` with ``fn`` applied to every leaf."""
    return unflatten(tree, [fn(leaf) for leaf in leaves(tree)])
