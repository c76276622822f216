"""User-facing quantization API.

Counterpart of ``quantized_training_tpu/quant/api.py`` (:40-267):
:func:`prequantize_step`, :func:`qlinear`, :func:`qlinear_multi`,
:func:`is_quant_weight`,
:func:`quantize_params` with the same default filter, and the training
contract :func:`virtual_params` / :func:`merge_masters` /
:func:`commit_params`. Parameters are nested dicts of tensors; a leaf's path
is the tuple of its dict keys. All four schemes of the JAX package:
``mixed_precision`` in all of its dtypes (``quantize_params(raw,
"mixed_precision", dtype="int4")`` or ``dtype="fp8_e4m3", scale="row" |
"tile"``, as ``llm_pretrain.py --quantize_kwargs`` passes them),
``int8_quantized_training`` (``activation="none" | "int8" | "int8_sr"``),
``int4_weight_only`` (``group_size``) and ``bitnet``.

The storage-quantized schemes (int8 storage, int4 weight-only) train
through the contract: each step dequantizes the storage into a float
master, the gradients and the optimizer act on the masters, and the
updated masters are re-quantized into storage with stochastic rounding.
Where the storage is float (mixed precision, BitNet) the contract passes
the wrappers through; the optimizer updates their leaves.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from ..ops import remat
from ..ops.random import fold_in
from . import bitnet as _bitnet
from . import int4 as _int4
from . import int8 as _int8
from . import mixed_precision as _mp
from .configs import Int8QTConfig, MixedPrecisionConfig
from .core import _span, matmul_over, quantize_int8

# storage-quantized schemes: the optimizer works on a dequantized master
STORAGE_QUANTIZED_TYPES = (_int8.Int8Weight, _int4.Int4Weight)
# every weight wrapper type
QUANT_TYPES = (_int8.Int8Weight, _int4.Int4Weight, _bitnet.BitNetWeight, _bitnet.BitNetPackedWeight,
               _mp.MixedPrecisionWeight, _mp.PreQuantMPWeight)
_MP_TYPES = (_mp.MixedPrecisionWeight, _mp.PreQuantMPWeight)


def is_quant_weight(x) -> bool:
    return isinstance(x, QUANT_TYPES)


def prequantize_step(params, key: int | None = None, mesh=None, specs=None):
    """Every int8 :class:`mixed_precision.MixedPrecisionWeight` of the tree
    as a :class:`mixed_precision.PreQuantMPWeight`, its views made once for
    the step (JAX :55-97); other leaves pass through. Called at the top of
    a step's forward (``models/llama.py::backbone``), it takes the weight
    quantizes out of the layers: the forward's, the remat replay's and
    grad_input's. ``QT_PREQUANT``, read at each call: '0' (the default) does
    nothing, '1' or 'both' makes both views, 'row' or 'col' one. Under SR
    leaf i, in the JAX package's flatten order (dict keys sorted, each
    wrapper one leaf), draws from ``fold_in(key, i)``.

    ``mesh`` and ``specs`` (the tree's ``parallel.Shard`` layout, as the
    tree holds them): a weight split over fsdp on its rows or columns makes
    its views as the rank's shards of the global weight's views
    (``prequantize_weight``'s ``shard``); the caller gathers them with the
    weight (``parallel.fsdp.prequant_specs``)."""
    mode = os.environ.get("QT_PREQUANT", "0")
    if mode == "0":
        return params
    mode = {"1": "both"}.get(mode, mode)
    if mode not in ("both", "row", "col"):
        raise ValueError(f"QT_PREQUANT must be one of 0, 1, both, row, col; got {mode!r}")
    index = {p: i for i, p in enumerate(_leaf_paths(params))}

    def shard(path):
        if specs is None:
            return None
        s = _at(specs, path)
        dim = (next(iter(s.tensors().values())) if isinstance(s, _mp.MixedPrecisionWeight) else s).dim
        return None if dim is None else (dim, (mesh, "fsdp"))

    def pq(path, leaf):
        if not isinstance(leaf, _mp.MixedPrecisionWeight):
            return leaf
        return _mp.prequantize_weight(leaf, None if key is None else fold_in(key, index[path]), mode=mode,
                                      shard=shard(path))

    return _map_with_path(pq, params)


def qlinear(x: torch.Tensor, w, bias: torch.Tensor | None = None, *, key: int | None = None):
    """y = x @ w.T + bias, dispatched on the weight wrapper type; ``key``
    (an int, ``ops/random.py``) seeds stochastic rounding. Inside
    ``parallel.collectives.spanning(mesh, features=...)`` (a row-parallel
    linear under tensor parallelism) every scheme sums its partial products
    over the mesh axis before it rounds (``quant/core.py::matmul_over``,
    ``::scaled_mm_over``): the output is the whole product, not the rank's
    part."""
    if isinstance(w, _MP_TYPES):
        return _mp.linear(x, w, bias, key=key)
    if isinstance(w, _int8.Int8Weight):
        return _int8.linear(x, w, bias, key=key)
    if isinstance(w, _int4.Int4Weight):
        return _int4.linear(x, w, bias, key=key)
    if isinstance(w, (_bitnet.BitNetWeight, _bitnet.BitNetPackedWeight)):
        return _bitnet.linear(x, w, bias, key=key)
    out = matmul_over(x, w, "features") if _span("features") is not None else _PlainLinear.apply(x, w)
    return out + bias if bias is not None else out


class _PlainLinear(torch.autograd.Function):
    """``x @ w.T`` for a plain weight, with the backward that autograd runs
    for it (``grad.mm(w)`` and ``grad.t().mm(x2d)``, the same GEMMs on the
    same layouts, so the same bits), so that a remat replay of an unread
    output (``ops/remat.py``) can skip the product and still save what the
    node saves."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if remat.skips():
            return remat.unread_like(x, (*x.shape[:-1], w.shape[0]))
        return x @ w.T

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2d = g.reshape(-1, g.shape[-1])
        dx = g2d.mm(w).view(x.shape) if ctx.needs_input_grad[0] else None
        dw = g2d.t().mm(x.reshape(-1, x.shape[-1])) if ctx.needs_input_grad[1] else None
        return dx, dw


def qlinear_multi(x: torch.Tensor, weights, *, key: int | None = None):
    """[y_i = x @ w_i.T] for several heads sharing one input. For
    mixed-precision all-int8 weights the shared input is quantized ONCE for
    all heads, and once in the backward (``mixed_precision.linear_shared``);
    other weights take independent :func:`qlinear` calls, head i with
    ``fold_in(key, i)`` (JAX :126-132)."""
    if all(isinstance(w, _MP_TYPES) for w in weights):
        return _mp.linear_shared(x, weights, key=key)
    return [qlinear(x, w, key=None if key is None else fold_in(key, i)) for i, w in enumerate(weights)]


def _is_linear_weight_path(path) -> bool:
    """True for leaves stored under a dict key named 'w' (every linear kernel
    of the models is ``{"w": [O, I]}``). Does not exclude the lm_head."""
    return bool(path) and path[-1] == "w"


def _default_filter(path, leaf) -> bool:
    """Linear 'w' leaves except the LM head (the reference quantizes only the
    transformer body), and only where every matmul dim is >= 128 and a
    multiple of 32."""
    if "lm_head" in path:
        return False
    if not _is_linear_weight_path(path):
        return False
    return all(d >= 128 and d % 32 == 0 for d in leaf.shape[-2:])


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def quantize_params(params, scheme: str | None, *, filter_fn=None, **kwargs):
    """Wrap the linear weights of ``params`` (nested dicts of tensors) in
    scheme wrappers. ``scheme``: 'mixed_precision',
    'int8_quantized_training', 'int4_weight_only', 'bitnet', or None (a
    no-op); ``kwargs`` feed the scheme config."""
    if scheme is None:
        return params
    filter_fn = filter_fn or _default_filter
    if scheme == "mixed_precision":
        config = MixedPrecisionConfig(**kwargs)
        wrap = lambda w: _mp.MixedPrecisionWeight(w, config)
    elif scheme == "int8_quantized_training":
        config = Int8QTConfig(**kwargs)
        wrap = lambda w: _int8.Int8Weight.from_float(w, config)
    elif scheme == "int4_weight_only":
        group_size = kwargs.pop("group_size", 32)
        if kwargs:
            raise TypeError(f"int4_weight_only: unexpected kwargs {kwargs}")
        wrap = lambda w: _int4.Int4Weight.from_float(w, group_size)
    elif scheme == "bitnet":
        if kwargs:
            raise TypeError(f"bitnet: unexpected kwargs {kwargs}")
        wrap = _bitnet.BitNetWeight
    else:
        raise ValueError(f"unknown quantization scheme {scheme!r}")
    return _map_with_path(lambda path, leaf: wrap(leaf) if filter_fn(path, leaf) else leaf, params)


# The training contract (JAX :213-267): each step maps the storage tree to a
# differentiable float tree, the optimizer updates that tree, and the result
# is committed back to storage. Only Int8Weight and Int4Weight have a
# storage apart from their master; every other leaf passes through.


def virtual_params(qparams):
    """Storage tree -> differentiable float tree: the dequantized masters
    of the storage-quantized weights, every other leaf as it is."""
    return _map_with_path(
        lambda path, q: q.dequantize() if isinstance(q, STORAGE_QUANTIZED_TYPES) else q, qparams)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def merge_masters(vparams, qparams):
    """Pair the differentiable masters back with their storage, so that the
    forward runs on the stored weight while the gradients reach the
    master."""
    def merge(path, v):
        q = _at(qparams, path)
        return dataclasses.replace(q, master=v) if isinstance(q, STORAGE_QUANTIZED_TYPES) else v

    return _map_with_path(merge, vparams)


def _leaf_paths(tree, path=()):
    """The paths of the leaves in the JAX package's flatten order with each
    weight wrapper one leaf (``is_leaf=is_quant_weight``): dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_paths(tree[k], path + (k,))
    else:
        yield path


def commit_params(new_vparams, qparams, key: int | None = None):
    """Updated masters -> new storage tree: each storage-quantized leaf
    re-quantized with stochastic rounding from ``fold_in(key, i)``, i its
    index in the JAX package's flatten order (an int8 weight by K1's SR
    form on a CUDA tensor, the stacked [L, O, I] at once); every other leaf
    as it is."""
    index = {p: i for i, p in enumerate(_leaf_paths(qparams))}

    def commit(path, v):
        q = _at(qparams, path)
        if not isinstance(q, STORAGE_QUANTIZED_TYPES):
            return v
        if key is None:
            raise ValueError("commit_params: re-quantizing the storage needs a key")
        k = fold_in(key, index[path])
        if isinstance(q, _int8.Int8Weight):
            int_data, scale = quantize_int8(v, axis=-1, stochastic_rounding=True, key=k)
            return _int8.Int8Weight(int_data, scale, None, q.config)
        return _int4.requantize(v, q, k)

    return _map_with_path(commit, new_vparams)
