"""Trees of tensors in the JAX package's order: nested dicts, lists, tuples
and NamedTuples (``AdamWState``) with tensor (or any non-container) leaves.

``jax.tree`` flattens a dict by its sorted keys; these helpers do the same,
so a leaf's index and its ``keystr`` path (``"['blocks']['attn']['wq']"``,
``"[0]"``, ``".mu"`` for a NamedTuple field) are the JAX package's for the
same tree, which keeps checkpoint manifests and summation orders alike.
A path is the tuple of dict keys, sequence indices and :class:`Field`\\ s
that leads to a leaf. ``None`` is an empty subtree, as in JAX.
"""

from __future__ import annotations

from typing import Any, Callable


class Field(str):
    """A NamedTuple field in a path: equal to its name, rendered ``.name``."""


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree: Any) -> list[tuple[Any, Any]]:
    """(path key, child) of one container level, in JAX's order."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(Field(f), getattr(tree, f)) for f in tree._fields]
    return list(enumerate(tree))


def _is_leaf(x: Any) -> bool:
    return not isinstance(x, (dict, list, tuple)) and x is not None


def keystr(path: tuple) -> str:
    """``jax.tree_util.keystr`` of a path: ``"['blocks']['attn']['wk']"``,
    ``"[0]"``, ``".mu['w']"``."""
    return "".join(f".{k}" if isinstance(k, Field) else f"[{k!r}]" for k in path)


def _flatten(tree: Any, path: tuple) -> list[tuple[tuple, Any]]:
    if tree is None:
        return []
    if _is_leaf(tree):
        return [(path, tree)]
    out = []
    for key, child in _children(tree):
        out.extend(_flatten(child, path + (key,)))
    return out


def flatten_with_path(tree: Any) -> list[tuple[str, Any]]:
    """Every leaf with its ``jax.tree_util.keystr`` path, in JAX's order."""
    return [(keystr(p), leaf) for p, leaf in _flatten(tree, ())]


def leaves(tree: Any) -> list:
    """The leaves in JAX's order."""
    return [leaf for _, leaf in _flatten(tree, ())]


def unflatten(like: Any, new_leaves) -> Any:
    """A tree of ``like``'s structure whose leaves are ``new_leaves`` (in
    JAX's order, as :func:`leaves` gives them)."""
    it = iter(new_leaves)

    def build(t):
        if t is None:
            return None
        if _is_leaf(t):
            return next(it)
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}  # the caller's key order back
        kids = [build(v) for _, v in _children(t)]
        return type(t)(*kids) if _is_namedtuple(t) else type(t)(kids)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def tree_map_with_path(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn(path, leaf, *others)`` over ``tree``'s leaves and the matching
    leaves (or subtrees) of ``rest``, keeping ``tree``'s structure and key
    order; ``path`` is the leaf's path tuple."""

    def walk(t, others, path):
        if t is None:
            return None
        if _is_leaf(t):
            return fn(path, t, *others)
        if isinstance(t, dict):
            return {k: walk(v, [o[k] for o in others], path + (k,)) for k, v in t.items()}
        if _is_namedtuple(t):
            return type(t)(*(walk(getattr(t, f), [getattr(o, f) for o in others],
                                  path + (Field(f),)) for f in t._fields))
        if any(len(o) != len(t) for o in others):
            raise ValueError("trees of different structure")
        return type(t)(walk(v, [o[i] for o in others], path + (i,)) for i, v in enumerate(t))

    return walk(tree, list(rest), ())


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn(leaf, *others)`` over ``tree``'s leaves and the matching leaves
    of ``rest`` (trees of the same structure)."""
    return tree_map_with_path(lambda _, *xs: fn(*xs), tree, *rest)
