"""Mixed-precision int8 linear, forward only.

Counterpart of ``quantized_training_tpu/quant/mixed_precision.py`` (:30-143):
``MixedPrecisionWeight``, ``_dynamic_int8_mm`` and the forward of
``_mp_linear``, written as plain functions (the serving slice needs no
autograd). Both operands are quantized per matmul along their contraction
axis, so the scales stay off the reduction dim; the forward x . w^T is the
weight-stationary (1, 1) form, which runs K1 twice and K2 once on the card.
Only ``dtype='int8'`` is ported: int4 and fp8 raise.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.scaled_mm import scaled_mm_general
from .configs import MixedPrecisionConfig
from .core import quantize_int8


@dataclass
class MixedPrecisionWeight:
    """bf16 master weight + static per-matmul quantization config.

    ``data`` is [out, in], or [L, out, in] when stacked over layers;
    indexing a stacked weight gives the wrapped per-layer slice."""

    data: torch.Tensor
    config: MixedPrecisionConfig

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def shape(self):
        return self.data.shape

    def __getitem__(self, idx) -> "MixedPrecisionWeight":
        return MixedPrecisionWeight(self.data[idx], self.config)


def _dynamic_int8_mm(a, b, sr: bool, generator, dims=(1, 0)):
    """Contract a over dims[0] and b over dims[1], both dynamically
    quantized to INT8 along their contraction axis."""
    a_i8, sa = quantize_int8(a, axis=dims[0], stochastic_rounding=sr, generator=generator)
    b_i8, sb = quantize_int8(b, axis=dims[1], stochastic_rounding=sr, generator=generator)
    return scaled_mm_general(a_i8, b_i8, sa, sb, dims=dims, out_dtype=a.dtype)


def _mp_linear(config: MixedPrecisionConfig, x2d, w, generator=None):
    """x2d [B, in] @ w.T [in, out]; w is [out, in]."""
    if config.dtype != "int8":
        raise NotImplementedError(
            f"mixed_precision dtype={config.dtype!r} is not ported yet "
            "(ROADMAP A7: int4 needs ROADMAP B16, fp8 its own GEMM)"
        )
    if config.output:
        return _dynamic_int8_mm(x2d, w, config.stochastic_rounding, generator, dims=(1, 1))
    return x2d @ w.T


def linear(x, w: MixedPrecisionWeight, bias=None, *, generator=None):
    """Mixed-precision linear: y = x @ w.T + bias with per-matmul quant."""
    if w.config.stochastic_rounding and generator is None:
        raise ValueError("stochastic_rounding requires a generator")
    x2d = x.reshape(-1, x.shape[-1])
    out = _mp_linear(w.config, x2d, w.data, generator)
    out = out.reshape(*x.shape[:-1], w.data.shape[0])
    return out + bias if bias is not None else out
