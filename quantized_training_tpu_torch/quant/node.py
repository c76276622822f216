"""The weight wrappers as nodes of a parameter tree.

No JAX counterpart: there each wrapper is a dataclass registered with
``jax.tree_util.register_dataclass``, whose ``data_fields`` are its leaves.
Here every wrapper derives from :class:`WeightNode` and names the same
fields, in the same order, in ``data_fields``; ``utils/tree.py`` flattens
them in that order, and a field that is None (a master not attached) is no
leaf. Indexing a wrapper indexes each of its tensors (a layer of a stacked
``[L, ...]`` weight), and :meth:`WeightNode.unbind_layers` cuts it into its
L layers with one ``unbind`` a field.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar


class WeightNode:
    """Mixin of the weight wrapper dataclasses."""

    data_fields: ClassVar[tuple[str, ...]] = ()

    def tensors(self) -> dict:
        """The fields that are leaves, by name, in ``data_fields`` order."""
        return {f: getattr(self, f) for f in self.data_fields if getattr(self, f) is not None}

    def map_tensors(self, fn):
        """The same wrapper with ``fn`` applied to each leaf field."""
        return dataclasses.replace(self, **{f: fn(t) for f, t in self.tensors().items()})

    def __getitem__(self, idx):
        return self.map_tensors(lambda t: t[idx])

    def unbind_layers(self) -> list:
        """A stacked wrapper as its per-layer wrappers: every field cut by
        one ``unbind(0)``, whose backward stacks the per-layer grads once."""
        parts = {f: t.unbind(0) for f, t in self.tensors().items()}
        n = len(next(iter(parts.values())))
        return [dataclasses.replace(self, **{f: p[l] for f, p in parts.items()}) for l in range(n)]
