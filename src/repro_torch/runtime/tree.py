"""Parameter trees of the port: nested dicts, lists, tuples and named
tuples of tensors, as `weights` and the optimizer build them. Leaves are
visited in a fixed order — dict keys as inserted, sequence items in order —
and named by their keys (a named tuple's by its field names) joined with
"/", the reference's checkpoint keys."""

from __future__ import annotations

from typing import Any, Callable, Iterator

import torch


def _items(tree: Any):
    if isinstance(tree, dict):
        return tree.items()
    if hasattr(tree, "_fields"):
        return zip(tree._fields, tree)
    return enumerate(tree)


def leaves(tree: Any, prefix: str = "") -> Iterator[tuple[str, torch.Tensor]]:
    """(key, tensor) of every leaf of ``tree``."""
    if isinstance(tree, torch.Tensor):
        yield prefix[:-1], tree
    elif isinstance(tree, (dict, list, tuple)):
        for k, v in _items(tree):
            yield from leaves(v, f"{prefix}{k}/")


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the same leaves of each of
    ``rest``), in a tree of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    return fn(tree, *rest)
