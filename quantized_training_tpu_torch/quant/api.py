"""User-facing quantization API.

Counterpart of ``quantized_training_tpu/quant/api.py`` (:100-267):
:func:`qlinear`, :func:`qlinear_multi`, :func:`is_quant_weight`,
:func:`quantize_params` with the same default filter, and the training
contract :func:`virtual_params` / :func:`merge_masters` /
:func:`commit_params`. Parameters are nested dicts of tensors; a leaf's path
is the tuple of its dict keys. Only the ``mixed_precision`` scheme is
ported, in all of its dtypes: ``quantize_params(raw, "mixed_precision",
dtype="int4")`` or ``dtype="fp8_e4m3", scale="row" | "tile"``, as
``llm_pretrain.py --quantize_kwargs`` passes them. The storage schemes of the
JAX package (int8 quantized training, int4 weight-only, BitNet) raise
NotImplementedError.
"""

from __future__ import annotations

import torch

from ..ops.random import fold_in
from . import mixed_precision as _mp
from .configs import MixedPrecisionConfig

QUANT_TYPES = (_mp.MixedPrecisionWeight,)
_UNPORTED_SCHEMES = ("int8_quantized_training", "int4_weight_only", "bitnet")


def is_quant_weight(x) -> bool:
    return isinstance(x, QUANT_TYPES)


def qlinear(x: torch.Tensor, w, bias: torch.Tensor | None = None, *, key: int | None = None):
    """y = x @ w.T + bias, dispatched on the weight wrapper type; ``key``
    (an int, ``ops/random.py``) seeds stochastic rounding."""
    if isinstance(w, _mp.MixedPrecisionWeight):
        return _mp.linear(x, w, bias, key=key)
    out = x @ w.T
    return out + bias if bias is not None else out


def qlinear_multi(x: torch.Tensor, weights, *, key: int | None = None):
    """[y_i = x @ w_i.T] for several heads sharing one input. For
    mixed-precision all-int8 weights the shared input is quantized ONCE for
    all heads, and once in the backward (``mixed_precision.linear_shared``);
    other weights take independent :func:`qlinear` calls, head i with
    ``fold_in(key, i)`` (JAX :126-132)."""
    if all(isinstance(w, _mp.MixedPrecisionWeight) for w in weights):
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
    scheme wrappers; ``kwargs`` feed the scheme config. ``scheme=None`` is a
    no-op."""
    if scheme is None:
        return params
    if scheme in _UNPORTED_SCHEMES:
        raise NotImplementedError(f"scheme {scheme!r} is not ported yet (ROADMAP A7)")
    if scheme != "mixed_precision":
        raise ValueError(f"unknown quantization scheme {scheme!r}")
    filter_fn = filter_fn or _default_filter
    config = MixedPrecisionConfig(**kwargs)
    return _map_with_path(
        lambda path, leaf: _mp.MixedPrecisionWeight(leaf, config) if filter_fn(path, leaf) else leaf,
        params,
    )


# The training contract (JAX :221-267): each step maps the storage tree to a
# differentiable float tree, the optimizer updates that tree, and the result
# is committed back to storage. The storage-quantized schemes (int8 storage,
# int4 weight-only), for which these maps do work, are not ported (ROADMAP
# A7); a MixedPrecisionWeight's storage is its bf16 master, so for the
# ported scheme all three are identities. train.py calls them all the same,
# so that it reads like its counterpart.


def virtual_params(qparams):
    """Storage tree -> differentiable float tree (the masters)."""
    return qparams


def merge_masters(vparams, qparams):
    """Pair the differentiable masters back with their storage."""
    return vparams


def commit_params(new_vparams, qparams, key: int | None = None):
    """Updated masters -> new storage tree. ``key`` seeds the stochastic
    re-quantization of the storage-quantized schemes (not ported)."""
    return new_vparams
