"""Quantization schemes of the port.

Counterpart of ``quantized_training_tpu/quant/__init__.py``, for the part the
serving and training slices use: the mixed-precision int8 scheme, forward
and backward, the producer-fused linears of ``quant/fused.py``, and the
training contract of ``quant/api.py``.
"""

from .api import (
    commit_params,
    is_quant_weight,
    merge_masters,
    qlinear,
    qlinear_multi,
    quantize_params,
    virtual_params,
)
from .configs import Int8QTConfig, MixedPrecisionConfig
from .core import dequantize_int8, quantize_int8, quantize_int8_both
from .fused import mlp_linear, norm_linear_multi, set_impl, silu_mul_linear
from .mixed_precision import MixedPrecisionWeight

__all__ = [
    "qlinear",
    "qlinear_multi",
    "norm_linear_multi",
    "silu_mul_linear",
    "mlp_linear",
    "set_impl",
    "quantize_params",
    "is_quant_weight",
    "virtual_params",
    "merge_masters",
    "commit_params",
    "MixedPrecisionWeight",
    "Int8QTConfig",
    "MixedPrecisionConfig",
    "quantize_int8",
    "quantize_int8_both",
    "dequantize_int8",
]
