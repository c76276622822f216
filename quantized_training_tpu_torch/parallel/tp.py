"""Tensor-parallel serving over the ``model`` axis.

Counterpart of ``quantized_training_tpu/parallel/tp.py`` (:18-78): Megatron
sharding, where q/k/v/gate/up (column-parallel) split their output dim,
o/down (row-parallel) their input dim, and the lm_head its vocab; the KV
cache splits its heads. The JAX package hands these shardings to XLA. Here
``shard_params_tp`` returns a rank's slice with its layout, and with both
``models/llama_infer.py::forward_with_cache`` runs this rank's heads and
its slice of the MLP, sums o's and down's partial outputs over ``model``
(one all-reduce each a layer) and all-gathers the vocab-split logits. A
weight wrapper's tensors split by its path's rule, each where its dim
divides (an int8 weight's row scales follow q's rows and stay whole for
o); a leaf whose dim does not divide stays replicated.
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils.tree import map_tensors
from .mesh import Shard

# per-layer linear kernels are stacked [L, out, in]
_OUT_SHARDED = {"q", "k", "v", "gate", "up"}  # column-parallel
_IN_SHARDED = {"o", "down"}  # row-parallel (an all-reduce after)


def tp_param_spec(path, shape, mesh) -> int | None:
    """The dim of the leaf at ``path`` (its keys and field names) of global ``shape``
    split over ``model``, or None (JAX :30-46, case for case)."""
    n = mesh.shape["model"]
    shape = tuple(getattr(shape, "shape", shape))
    if n == 1:
        return None

    def ok(dim: int) -> bool:
        return len(shape) > dim and shape[dim] % n == 0

    if "lm_head" in path and ok(0):
        return 0  # vocab-split logits
    if any(k in _OUT_SHARDED for k in path) and len(shape) == 3 and ok(1):
        return 1
    if any(k in _IN_SHARDED for k in path) and len(shape) == 3 and ok(2):
        return 2
    return None  # embeddings, norms, odd shapes: replicated


def shard_params_tp(params, mesh):
    """(this rank's TP slice of every tensor of ``params`` (JAX :49-58),
    its :class:`Shard` layout): a wrapper's tensors split by the rule of
    the wrapper's path. A 4-bit weight keeps its global matrix shape as
    static metadata, so it is refused."""
    from ..quant.int4 import Int4Weight

    coord, n = mesh.coords["model"], mesh.shape["model"]

    def spec(path, t):
        if isinstance(t, Int4Weight):
            raise ValueError("int4 weights cannot be split over model: their matrix shape is static")
        return Shard(tp_param_spec(path, t.shape, mesh), coord, n)

    is_leaf = lambda t: isinstance(t, torch.Tensor) or (n > 1 and isinstance(t, Int4Weight))  # noqa: E731
    specs = map_tensors(spec, params, is_leaf=is_leaf, with_path=True)
    return map_tensors(lambda t, s: s.take(t), params, specs), specs


def kv_cache_spec(mesh, num_kv_heads: int | None = None) -> int | None:
    """A ``KVCache`` array is [L, B, S, KV_heads, hd]: dim 3 split over
    ``model``, or None where the heads do not divide (JAX :61-70)."""
    n = mesh.shape["model"]
    if n == 1 or (num_kv_heads is not None and num_kv_heads % n != 0):
        return None
    return 3


def shard_kv_cache(cache, mesh):
    """This rank's heads of every array of a ``KVCache`` (JAX :73-78)."""
    def put(x):
        dim = kv_cache_spec(mesh, num_kv_heads=x.shape[3] if x.ndim == 5 else None)
        return Shard(dim, mesh.coords["model"], mesh.shape["model"]).take(x)

    return dataclasses.replace(cache, **{f.name: put(getattr(cache, f.name)) for f in dataclasses.fields(cache)})
