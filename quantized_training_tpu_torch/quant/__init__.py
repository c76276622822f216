"""Quantization schemes of the port.

Counterpart of ``quantized_training_tpu/quant/__init__.py``: the four
schemes, forward and backward (mixed precision in int8, int4 and fp8; int8
weight storage, ``Int8Weight``; int4 weight-only, ``Int4Weight``; BitNet
1.58b, ``BitNetWeight`` and its packed form ``BitNetPackedWeight``), the
producer-fused linears of ``quant/fused.py`` (int8 mixed precision; the
Llama's and the ViT's), the training contract of ``quant/api.py``, and
the per-step weight pre-quantization (``prequantize_step``, ``QT_PREQUANT``,
``PreQuantMPWeight``).
"""

from .api import (
    commit_params,
    is_quant_weight,
    merge_masters,
    prequantize_step,
    qlinear,
    qlinear_multi,
    quantize_params,
    virtual_params,
)
from .bitnet import BitNetPackedWeight, BitNetWeight
from .configs import Int8QTConfig, MixedPrecisionConfig
from .core import (
    bf16_stochastic_round,
    dequantize_int4_groupwise,
    dequantize_int8,
    get_bitnet_scale,
    pack_i2_in_i8,
    quantize_bitnet_weight,
    quantize_int4_groupwise,
    quantize_int4_rowwise_absmax,
    quantize_int8,
    quantize_int8_both,
    unpack_i2_in_i8,
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
from .int4 import Int4Weight
from .int8 import Int8Weight
from .mixed_precision import MixedPrecisionWeight, PreQuantMPWeight

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
    "prequantize_step",
    "Int8Weight",
    "Int4Weight",
    "BitNetWeight",
    "BitNetPackedWeight",
    "MixedPrecisionWeight",
    "PreQuantMPWeight",
    "Int8QTConfig",
    "MixedPrecisionConfig",
    "quantize_int8",
    "quantize_int8_both",
    "quantize_int4_rowwise_absmax",
    "unpack_int4_rowwise",
    "dequantize_int8",
    "quantize_int4_groupwise",
    "dequantize_int4_groupwise",
    "get_bitnet_scale",
    "quantize_bitnet_weight",
    "pack_i2_in_i8",
    "unpack_i2_in_i8",
    "bf16_stochastic_round",
]
