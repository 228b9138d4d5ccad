"""Path-keyed walks over the port's trees — nested dicts, NamedTuples,
lists and tuples (parameters, optimizer and decode states, trees of
``partitioning.Sharding``) — in the JAX package's leaf order: dict keys
sorted, NamedTuple fields and sequence items in order.  A path is a tuple
of strings: dict keys, field names and indices, as the reference's key
paths name them.
"""
from __future__ import annotations

from typing import Any, Callable, Dict


def flatten(tree, prefix=()) -> Dict[tuple, Any]:
    """{path: leaf} in the reference's leaf order."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flatten(tree[k], prefix + (str(k),)))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for name, v in zip(tree._fields, tree):
            out.update(flatten(v, prefix + (name,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten(v, prefix + (str(i),)))
        return out
    return {prefix: tree}


def unflatten(like, leaves: Dict[tuple, Any], prefix=()):
    """A tree shaped like ``like`` with leaves from ``leaves``."""
    if isinstance(like, dict):
        return {k: unflatten(v, leaves, prefix + (str(k),))
                for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(unflatten(v, leaves, prefix + (name,))
                            for name, v in zip(like._fields, like)))
    if isinstance(like, (list, tuple)):
        return type(like)(unflatten(v, leaves, prefix + (str(i),))
                          for i, v in enumerate(like))
    return leaves[prefix]


def map_with_path(fn: Callable[[tuple, Any], Any], tree):
    """``fn(path, leaf)`` over every leaf of ``tree``, its structure
    kept."""
    return unflatten(tree, {p: fn(p, v) for p, v in flatten(tree).items()})
