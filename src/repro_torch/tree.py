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
