"""Quantization schemes of the port.

Counterpart of ``quantized_training_tpu/quant/__init__.py``, for the part the
serving slice uses: the mixed-precision int8 scheme, forward only.
"""

from .api import is_quant_weight, qlinear, quantize_params
from .configs import Int8QTConfig, MixedPrecisionConfig
from .core import dequantize_int8, quantize_int8
from .mixed_precision import MixedPrecisionWeight

__all__ = [
    "qlinear",
    "quantize_params",
    "is_quant_weight",
    "MixedPrecisionWeight",
    "Int8QTConfig",
    "MixedPrecisionConfig",
    "quantize_int8",
    "dequantize_int8",
]
