"""Trees of tensors, flattened as ``jax.tree_util`` flattens them.

The port's training state is a tree of nested dicts, lists, tuples and
NamedTuples with tensor leaves; ``None`` is an empty subtree, as in JAX.
Leaves come in JAX's order (dict keys sorted, sequences and NamedTuple
fields in order), so that sums over them (the global norm) add in the
reference's order, and each leaf has the reference checkpoint's key
(``repro.ckpt.checkpoint._path_str``): ``name`` for a dict entry,
``.field`` for a NamedTuple field, ``[i]`` for a list or tuple item,
joined by ``/``.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator

__all__ = ["SEP", "flatten_with_keys", "leaves", "tree_map", "unflatten"]

SEP = "/"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> list[tuple[str, Any]] | None:
    """(key, child) pairs of an inner node in JAX's order; None for a
    leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", x) for i, x in enumerate(tree)]
    return None


def flatten_with_keys(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """[(key, leaf)] in JAX's leaf order; ``None`` has no leaves."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for key, child in kids:
        out += flatten_with_keys(child, f"{prefix}{SEP}{key}" if prefix
                                 else key)
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_keys(tree)]


def _rebuild(template, it: Iterator):
    if template is None:
        return None
    if isinstance(template, dict):
        new = {k: _rebuild(template[k], it) for k in sorted(template)}
        return {k: new[k] for k in template}
    if _is_namedtuple(template):
        return type(template)(*[_rebuild(getattr(template, f), it)
                                for f in template._fields])
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(x, it) for x in template)
    return next(it)


def unflatten(template, new_leaves) -> Any:
    """``template``'s structure with ``new_leaves`` (in JAX's order)."""
    it = iter(new_leaves)
    out = _rebuild(template, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(x, *(o[i] for o in others))
                            for i, x in enumerate(leaves(tree))])
