"""Scheme configuration records.

Counterpart of ``quantized_training_tpu/quant/configs.py`` (``Int8QTConfig``,
``MixedPrecisionConfig``), carried over verbatim: ``MixedPrecisionConfig``
with every dtype (int8, int4, fp8_e4m3 with 'row' or 'tile' scales), and
``Int8QTConfig`` for int8 weight storage (``quant/int8.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal


@dataclass(frozen=True)
class Int8QTConfig:
    """INT8 quantized-training config.

    ``activation``: 'none' = weight-only (mixed bf16 matmul), 'int8' =
    dynamic row-wise activation quant + int8 matmul, 'int8_sr' = same with
    stochastic rounding of activations.
    """

    activation: Literal["none", "int8", "int8_sr"] = "none"


@dataclass(frozen=True)
class MixedPrecisionConfig:
    """Per-matmul dynamic quantization toggles (the flagship scheme).

    Each of output / grad_input / grad_weight independently selects whether
    that matmul runs as dynamic row-wise quantized INT8 (or INT4/FP8) with
    both operands re-quantized per matmul, or as plain bf16.
    """

    output: bool = True
    grad_input: bool = True
    grad_weight: bool = True
    dtype: Literal["int8", "int4", "fp8_e4m3"] = "int8"
    stochastic_rounding: bool = False
    scale: Literal["row", "tile"] = "row"
