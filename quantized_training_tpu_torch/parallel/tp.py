"""Tensor-parallel serving over the ``model`` axis.

Counterpart of ``quantized_training_tpu/parallel/tp.py`` (:18-78): Megatron
sharding, where q/k/v/gate/up (column-parallel) split their output dim,
o/down (row-parallel) their input dim, and the lm_head its vocab; the KV
cache splits its heads. The JAX package hands these shardings to XLA. Here
``shard_params_tp`` returns a rank's slice with its layout, and with both
``models/llama_infer.py::forward_with_cache`` runs this rank's heads and
its slice of the MLP and all-gathers the vocab-split logits. o's and
down's linears sum their partial products over ``model`` (one all-reduce
each a layer) before they round, as XLA's partitioned dot does: the int8
paths' int32 sums before the scales, the bf16, int8 weight-only and int4
products in fp32 (``quant/core.py::scaled_mm_over``, ``::matmul_over``); a
rank's bf16 partial outputs are never summed. An unpacked BitNet weight
takes its abs-mean over the whole matrix (``get_bitnet_scale`` under
``collectives.spanning(mesh, weights="model")``). A
weight wrapper's tensors split by its path's rule, each where its dim
divides (an int8 weight's row scales follow q's rows and stay whole for
o); a leaf whose dim does not divide stays replicated.

An int4 weight-only weight (``quant/int4.py::Int4Weight``) keeps its groups
flattened over its [O, I] matrix, so JAX's path rule applied leaf by leaf
would cut its ``packed`` inside each group and keep its scales whole; only
XLA's global program makes that right there. Here it is split by its
matrix: a column-parallel weight by whole rows of O (``packed``, ``scale``
and ``zero_point`` cut alike, where a rank's rows hold whole groups), a
row-parallel one by contiguous K blocks of every row (where (I / n) %
group_size == 0), through :class:`parallel.mesh.FlatShard`; the weight's
``mat_shape`` becomes the rank's, and the layout's node holds it too. The
nibble order stays as it is.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..utils.tree import map_tensors
from .mesh import FlatShard, Shard

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


def _int4_spec(path, w, mesh):
    """The layout of an ``Int4Weight`` (the module's docstring): its fields'
    :class:`FlatShard` by its path's rule, and the rank's ``mat_shape``."""
    coord, n = mesh.coords["model"], mesh.shape["model"]
    dim = tp_param_spec(path, w.shape, mesh)
    lead = tuple(w.packed.shape[:-2])
    if dim is None:
        whole = Shard(None, coord, n)
        return dataclasses.replace(w, packed=whole, scale=whole, zero_point=whole,
                                   master=None if w.master is None else whole)
    (O, I), g = w.mat_shape, w.group_size
    axis = dim - len(lead)  # 0: rows of O, 1: K blocks
    L = math.prod(lead)
    if axis == 0 and (O // n * I) % g == 0:
        pre, groups, mat = L, O // n * I // g, (O // n, I)
    elif axis == 1 and (I // n) % g == 0:
        pre, groups, mat = L * O, I // n // g, (O, I // n)
    else:
        raise ValueError(f"an int4 weight [{O}, {I}] in groups of {g} split on its {('rows', 'columns')[axis]} "
                         f"over model = {n}: a rank's share ends inside a group")
    local = mat[0] * mat[1] // g  # the rank's groups a matrix
    return dataclasses.replace(
        w, packed=FlatShard(1, coord, n, (pre, n, groups * g // 2), (*lead, local, g // 2)),
        scale=FlatShard(1, coord, n, (pre, n, groups), (*lead, local)),
        zero_point=FlatShard(1, coord, n, (pre, n, groups), (*lead, local)),
        master=None if w.master is None else Shard(dim, coord, n), mat_shape=mat)


def shard_params_tp(params, mesh):
    """(this rank's TP slice of every tensor of ``params`` (JAX :49-58),
    its :class:`Shard` layout): a wrapper's tensors split by the rule of
    the wrapper's path, an int4 weight's by its matrix (the module's
    docstring)."""
    from ..quant.int4 import Int4Weight

    coord, n = mesh.coords["model"], mesh.shape["model"]

    def spec(path, t):
        if isinstance(t, Int4Weight):
            return _int4_spec(path, t, mesh)
        return Shard(tp_param_spec(path, t.shape, mesh), coord, n)

    def take(t, s):
        if isinstance(t, Int4Weight):
            return dataclasses.replace(t, mat_shape=s.mat_shape,
                                       **{f: getattr(s, f).take(x) for f, x in t.tensors().items()})
        return s.take(t)

    is_leaf = lambda t: isinstance(t, (torch.Tensor, Int4Weight))  # noqa: E731
    specs = map_tensors(spec, params, is_leaf=is_leaf, with_path=True)
    return map_tensors(take, params, specs, is_leaf=is_leaf), specs


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
