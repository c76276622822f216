"""Parameter trees: nested dicts of tensors with weight wrappers (no JAX
counterpart: JAX's pytrees do this there).

A weight wrapper (``quant/node.py::WeightNode``) is a node whose leaves are
its tensor fields in the order of its ``data_fields``, the JAX package's
``data_fields``; a field that is None (a master not attached) is no leaf.
Dict keys are visited in sorted order, as JAX flattens dicts, so that sums
over the leaves and the keys folded per leaf run in the JAX package's
order. ``is_leaf`` stops the walk at the nodes it accepts, as JAX's
``is_leaf`` does (an optimizer's 8-bit states against the parameters).

:func:`map_tensors` is the other walk: it keeps a tree's structure and
every value it does not map (a step count, a mesh), and it goes through
``NamedTuple`` states, lists and tuples too, in the tree's own order. It
is what a whole train state (or a loaded checkpoint) is mapped with.
"""

from __future__ import annotations

import dataclasses

import torch

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


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def map_tensors(fn, tree, *rest, is_leaf=_is_tensor, with_path: bool = False):
    """``fn(leaf, *matching)`` on every leaf of ``tree`` that ``is_leaf``
    accepts (a tensor by default), with the matching parts of ``rest``
    (trees of its structure, e.g. its ``parallel.Shard`` layout), through
    dicts, ``NamedTuple`` states, lists, tuples and the leaf fields of
    weight wrappers; anything else is kept as it is. ``with_path``: ``fn``
    gets the leaf's path (dict keys, field names, indices) first."""

    def walk(t, rs, path):
        if is_leaf(t):
            return fn(path, t, *rs) if with_path else fn(t, *rs)
        if isinstance(t, dict):
            return {k: walk(v, [r[k] for r in rs], path + (k,)) for k, v in t.items()}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(walk(v, [r[i] for r in rs], path + (f,)) for i, (f, v) in enumerate(zip(t._fields, t))))
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, [r[i] for r in rs], path + (i,)) for i, v in enumerate(t))
        if isinstance(t, WeightNode):
            return dataclasses.replace(t, **{f: walk(v, [getattr(r, f) for r in rs], path + (f,))
                                             for f, v in t.tensors().items()})
        return t

    return walk(tree, list(rest), ())
