"""Trees of tensors: the port's counterpart of ``jax.tree_util``.

The port's parameters, optimiser state and train state are nested dicts,
lists, tuples and dataclasses with tensor leaves.  These helpers walk
them in one fixed order — dict keys in insertion order, sequence items
in order, dataclass fields in declaration order — so trees of the same
structure (params, grads, ``mu``, ``nu``) flatten to aligned leaves.
``None`` is a leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Mapping

Path = tuple[Any, ...]


def _children(tree: Any) -> Iterator[tuple[Any, Any]] | None:
    if isinstance(tree, Mapping):
        return iter(tree.items())
    if isinstance(tree, (list, tuple)):
        return enumerate(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return ((f.name, getattr(tree, f.name))
                for f in dataclasses.fields(tree))
    return None


def flatten_with_paths(tree: Any, prefix: Path = ()) -> list[tuple[Path,
                                                                   Any]]:
    """``(path, leaf)`` pairs; a path holds the dict keys, sequence
    indices and dataclass field names from the root to the leaf."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [pair for key, sub in kids
            for pair in flatten_with_paths(sub, prefix + (key,))]


def leaves(tree: Any) -> list[Any]:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def unflatten(like: Any, new_leaves: list[Any]) -> Any:
    """A tree of ``like``'s structure whose leaves are ``new_leaves``, in
    :func:`leaves` order."""
    it = iter(new_leaves)
    out = _rebuild(like, it)
    if next(it, it) is not it:
        raise ValueError("unflatten: more leaves than the tree holds")
    return out


def _rebuild(like: Any, it: Iterator[Any]) -> Any:
    if isinstance(like, Mapping):
        return {k: _rebuild(v, it) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, it) for v in like)
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        return dataclasses.replace(like, **{
            f.name: _rebuild(getattr(like, f.name), it)
            for f in dataclasses.fields(like)})
    try:
        return next(it)
    except StopIteration:
        raise ValueError("unflatten: fewer leaves than the tree holds") \
            from None


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the aligned leaves of ``tree`` and ``rest`` (trees of
    the same structure), in ``tree``'s structure."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(leaf, *(o[i] for o in others))
                            for i, leaf in enumerate(leaves(tree))])
