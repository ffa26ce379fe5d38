"""Nested dicts (and lists) of tensors, the port's counterpart of JAX's
pytrees: the parameters, the optimizer state and what a checkpoint holds.

Leaves are visited in the order ``jax.tree_util`` visits a pytree of
dicts and lists (dict keys sorted, list items in order), and a leaf's
path is its keys joined by ``/``, as ``repro.checkpoint.checkpointer``
names them (``params/stage0/u0/mixer/wq``).
"""

from __future__ import annotations

from typing import Callable, Iterator, List, Tuple


def leaves_with_path(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """``(path, leaf)`` for every leaf, in JAX's order."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        yield prefix, tree
        return
    for key, sub in items:
        yield from leaves_with_path(sub, f"{prefix}/{key}" if prefix
                                    else str(key))


def leaves(tree) -> List:
    return [leaf for _, leaf in leaves_with_path(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and trees of its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)
