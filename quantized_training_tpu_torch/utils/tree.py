"""Parameter trees: nested dicts of tensors with weight wrappers (no JAX
counterpart: JAX's pytrees do this there).

A weight wrapper (``quant/node.py::WeightNode``) is a node whose leaves are
its tensor fields in the order of its ``data_fields``, the JAX package's
``data_fields``; a field that is None (a master not attached) is no leaf.
Dict keys are visited in sorted order, as JAX flattens dicts, so that sums
over the leaves and the keys folded per leaf run in the JAX package's
order. ``is_leaf`` stops the walk at the nodes it accepts, as JAX's
``is_leaf`` does (an optimizer's 8-bit states against the parameters).
"""

from __future__ import annotations

from ..quant.node import WeightNode

_LEAF = object()  # a leaf's place in a treedef


def tree_flatten(tree, is_leaf=None) -> tuple[list, object]:
    """-> (leaves, treedef); :func:`tree_unflatten` inverts it."""
    leaves = []

    def walk(t):
        if is_leaf is None or not is_leaf(t):
            if isinstance(t, dict):
                return {k: walk(t[k]) for k in sorted(t)}
            if isinstance(t, WeightNode):
                return t.map_tensors(walk)
        leaves.append(t)
        return _LEAF

    return leaves, walk(tree)


def tree_unflatten(treedef, leaves: list):
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if isinstance(t, WeightNode):
            return t.map_tensors(build)
        return next(it)

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("tree_unflatten: more leaves than the tree holds")
    return out


def tree_leaves(tree, is_leaf=None) -> list:
    return tree_flatten(tree, is_leaf)[0]


def tree_map(fn, tree, *rest, is_leaf=None):
    """fn over the leaves of ``tree`` and of ``rest`` (trees of the same
    structure), leaf by leaf."""
    leaves, treedef = tree_flatten(tree, is_leaf)
    others = [tree_leaves(r, is_leaf) for r in rest]
    if any(len(o) != len(leaves) for o in others):
        raise ValueError("tree_map: trees of different structure")
    return tree_unflatten(treedef, [fn(*ls) for ls in zip(leaves, *others)])
