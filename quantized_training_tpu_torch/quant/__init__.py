"""Quantization schemes of the port.

Counterpart of ``quantized_training_tpu/quant/__init__.py``, for the part the
serving and training slices use: the mixed-precision scheme (int8, int4 and
fp8), forward and backward, the producer-fused linears of ``quant/fused.py``
(int8; the Llama's and the ViT's), and the training contract of
``quant/api.py``.
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
from .core import (
    dequantize_int8,
    quantize_int4_rowwise_absmax,
    quantize_int8,
    quantize_int8_both,
    unpack_int4_rowwise,
)
from .fused import (
    attn_out_linear,
    gelu_linear,
    layernorm_linear,
    mlp_linear,
    norm_linear_multi,
    set_impl,
    silu_mul_linear,
)
from .mixed_precision import MixedPrecisionWeight

__all__ = [
    "qlinear",
    "qlinear_multi",
    "norm_linear_multi",
    "silu_mul_linear",
    "mlp_linear",
    "attn_out_linear",
    "layernorm_linear",
    "gelu_linear",
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
    "quantize_int4_rowwise_absmax",
    "unpack_int4_rowwise",
    "dequantize_int8",
]
