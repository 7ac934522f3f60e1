"""Parameter trees: nested dicts whose leaves are tensors (or, in a
quantized serving tree, ``QuantizedLeaf``s). The reference's pytrees."""
from __future__ import annotations


def tree_map(fn, tree, *rest):
    """``fn(leaf, *leaves)`` over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree):
    """The leaves in dict order (the order ``tree_map`` visits)."""
    if isinstance(tree, dict):
        return [l for v in tree.values() for l in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` in order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def sorted_leaf_index(tree) -> list:
    """Each leaf's index in the reference's leaf order (jax flattens a
    dict with its keys sorted, at every level), in ``tree_leaves``
    order: what the stochastic quantizers' draws are keyed by."""
    def paths(t, prefix=()):
        if isinstance(t, dict):
            return [p for k, v in t.items() for p in paths(v, prefix + (k,))]
        return [prefix]
    ps = paths(tree)
    order = sorted(range(len(ps)), key=lambda i: ps[i])
    index = [0] * len(ps)
    for j, i in enumerate(order):
        index[i] = j
    return index


def _children(tree):
    """A node's (name, child) pairs in the reference's leaf order, or
    None for a leaf: a dict's keys sorted (jax flattens dicts so), a
    NamedTuple's fields by name, a list's or tuple's items as ``[i]``."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f, getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    return None


def tree_flatten_with_path(tree):
    """``[(key, leaf), ...]`` in the reference's leaf order, each key the
    ``/``-joined path the reference's checkpoint store writes
    (``jax.tree_util.tree_flatten_with_path``: dict keys by name, fields
    by name, sequence indices as ``[0]``). ``None`` is an empty subtree,
    as in jax."""
    out = []
    _flatten_into(out, tree, ())
    return out


def _flatten_into(out, t, prefix) -> None:
    """:func:`tree_flatten_with_path`'s walk, a module function: a
    recursive closure would hold ``out`` (every leaf) in a reference
    cycle until a garbage collection."""
    if t is None:
        return
    kids = _children(t)
    if kids is None:
        out.append(("/".join(prefix), t))
        return
    for name, child in kids:
        _flatten_into(out, child, prefix + (name,))


def tree_map_with_path(fn, tree, prefix: str = ""):
    """``fn(key, leaf)`` over every leaf (keys as
    :func:`tree_flatten_with_path`), keeping the tree's structure:
    dicts stay dicts in their own order, NamedTuples their type."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    sub = {name: tree_map_with_path(fn, child,
                                    f"{prefix}/{name}" if prefix else name)
           for name, child in kids}
    if isinstance(tree, dict):
        return {k: sub[str(k)] for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(**{f: sub[f] for f in tree._fields})
    return type(tree)(sub[f"[{i}]"] for i in range(len(tree)))
