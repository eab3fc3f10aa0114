"""Small helpers over the port's nested trees (dicts, lists, tuples and
NamedTuples of tensors): params, optimizer moments, the train state.

Dict keys are walked in sorted order (JAX's pytree order), sequences in
order; a path is the tuple of keys and indices (NamedTuple fields by
name) that leads to a leaf.
"""
from __future__ import annotations

from typing import Any, Callable


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def flatten(tree: Any, prefix: tuple = ()) -> list:
    """[(path, leaf)] in walk order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flatten(tree[k], prefix + (k,))
        return out
    if _is_namedtuple(tree):
        out = []
        for name in tree._fields:
            out += flatten(getattr(tree, name), prefix + (name,))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, child in enumerate(tree):
            out += flatten(child, prefix + (i,))
        return out
    return [(prefix, tree)]


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in flatten(tree)]


def unflatten(like: Any, new_leaves) -> Any:
    """A tree shaped like `like` whose leaves are `new_leaves`, in order."""
    it = iter(new_leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if _is_namedtuple(node):
            return type(node)(*(build(getattr(node, n)) for n in node._fields))
        if isinstance(node, (list, tuple)):
            return type(node)(build(c) for c in node)
        return next(it)

    return build(like)


def map_tree(fn: Callable, tree: Any, *rest: Any) -> Any:
    """fn applied leaf by leaf over trees of one structure."""
    others = [leaves(t) for t in rest]
    return unflatten(tree, [fn(leaf, *(o[i] for o in others))
                            for i, leaf in enumerate(leaves(tree))])


def path_str(path: tuple) -> str:
    return "/".join(str(k) for k in path)
