"""Kernel-level ops of the port.

Counterpart of ``quantized_training_tpu/ops/__init__.py``. Twelve hand-written
CUDA kernels, each with a plain PyTorch version that CPU tensors take:

- K1 :func:`quantize_int8_rowwise` (``csrc/int8_quant.cu``), replacing
  ``ops/pallas_quant.py::quantize_int8_rowwise``;
- B4 :func:`quantize_int8_colwise` (``csrc/int8_quant.cu``), replacing
  ``ops/pallas_quant.py::quantize_int8_colwise``;
- B5 :func:`quantize_int8_both` (``csrc/int8_quant.cu``), replacing
  ``ops/pallas_quant.py::quantize_int8_both``;
- K2 :func:`scaled_mm_rhs_t` (``csrc/scaled_mm.cu``), replacing
  ``ops/pallas_mm.py::scaled_mm_dims`` with dims (1, 1);
- B1 :func:`scaled_mm` (``csrc/scaled_mm.cu``), replacing
  ``ops/pallas_mm.py::scaled_mm``;
- B2 :func:`scaled_mm_lhs_t` (``csrc/scaled_mm.cu``), replacing
  ``ops/pallas_mm.py::scaled_mm_dims`` with dims (0, 0);
- B6 :func:`fused_adamw_update` (``csrc/fused_adamw.cu``), replacing
  ``ops/pallas_optim.py::fused_adamw_update``;
- B7 :func:`rmsnorm_quant_rowwise`, B8 :func:`rmsnorm_quant_colwise`, B9
  :func:`silu_mul_quant_rowwise` and :func:`silu_mul_quant_colwise`, and B10
  :func:`rmsnorm_bwd` (``csrc/fused_producers.cu``), replacing the functions
  of the same names in ``ops/pallas_fused.py``: RMSNorm and silu(a) * b run
  inside the int8 quantizes, and the RMSNorm backward in one pass.

K1, B4, B5, B7, B8 and B9 also have a stochastic-rounding form, and B6 an SR
writeback,
drawn from the Philox stream of ``random.py`` (``csrc/philox.cuh``).

Each wrapper counts its kernel launches (:func:`launch_counts`), an SR form
apart from its plain form, so a run can show that its path went through the
kernels and which form ran. Importing this package builds nothing: the
kernels compile at their first launch (``ops/_build.py``).
"""

from . import random
from .fused_adamw import fused_adamw_plain, fused_adamw_update
from .fused_producers import (
    rmsnorm_bwd,
    rmsnorm_bwd_plain,
    rmsnorm_quant_colwise,
    rmsnorm_quant_colwise_plain,
    rmsnorm_quant_rowwise,
    rmsnorm_quant_rowwise_plain,
    silu_mul_quant_colwise,
    silu_mul_quant_colwise_plain,
    silu_mul_quant_rowwise,
    silu_mul_quant_rowwise_plain,
)
from .int8_quant import (
    quantize_int8_both,
    quantize_int8_both_plain,
    quantize_int8_colwise,
    quantize_int8_plain,
    quantize_int8_rowwise,
)
from .scaled_mm import (
    scaled_mm,
    scaled_mm_general,
    scaled_mm_lhs_t,
    scaled_mm_lhs_t_plain,
    scaled_mm_plain,
    scaled_mm_ref,
    scaled_mm_rhs_t,
    scaled_mm_rhs_t_plain,
)

# counter name -> (wrapper, the attribute it counts in)
KERNELS = {
    "quantize_int8_rowwise": (quantize_int8_rowwise, "launches"),
    "quantize_int8_rowwise_sr": (quantize_int8_rowwise, "sr_launches"),
    "quantize_int8_colwise": (quantize_int8_colwise, "launches"),
    "quantize_int8_colwise_sr": (quantize_int8_colwise, "sr_launches"),
    "quantize_int8_both": (quantize_int8_both, "launches"),
    "quantize_int8_both_sr": (quantize_int8_both, "sr_launches"),
    "scaled_mm_rhs_t": (scaled_mm_rhs_t, "launches"),
    "scaled_mm": (scaled_mm, "launches"),
    "scaled_mm_lhs_t": (scaled_mm_lhs_t, "launches"),
    "fused_adamw_update": (fused_adamw_update, "launches"),
    "fused_adamw_update_sr": (fused_adamw_update, "sr_launches"),
    "rmsnorm_quant_rowwise": (rmsnorm_quant_rowwise, "launches"),
    "rmsnorm_quant_rowwise_sr": (rmsnorm_quant_rowwise, "sr_launches"),
    "rmsnorm_quant_colwise": (rmsnorm_quant_colwise, "launches"),
    "rmsnorm_quant_colwise_sr": (rmsnorm_quant_colwise, "sr_launches"),
    "silu_mul_quant_rowwise": (silu_mul_quant_rowwise, "launches"),
    "silu_mul_quant_rowwise_sr": (silu_mul_quant_rowwise, "sr_launches"),
    "silu_mul_quant_colwise": (silu_mul_quant_colwise, "launches"),
    "silu_mul_quant_colwise_sr": (silu_mul_quant_colwise, "sr_launches"),
    "rmsnorm_bwd": (rmsnorm_bwd, "launches"),
}


def launch_counts() -> dict[str, int]:
    """Kernel launches per counter since the last :func:`reset_launch_counts`."""
    return {name: getattr(fn, attr) for name, (fn, attr) in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn, attr in KERNELS.values():
        setattr(fn, attr, 0)


__all__ = [
    "KERNELS",
    "launch_counts",
    "reset_launch_counts",
    "random",
    "fused_adamw_plain",
    "fused_adamw_update",
    "quantize_int8_both",
    "quantize_int8_both_plain",
    "quantize_int8_colwise",
    "quantize_int8_plain",
    "quantize_int8_rowwise",
    "rmsnorm_bwd",
    "rmsnorm_bwd_plain",
    "rmsnorm_quant_colwise",
    "rmsnorm_quant_colwise_plain",
    "rmsnorm_quant_rowwise",
    "rmsnorm_quant_rowwise_plain",
    "silu_mul_quant_colwise",
    "silu_mul_quant_colwise_plain",
    "silu_mul_quant_rowwise",
    "silu_mul_quant_rowwise_plain",
    "scaled_mm",
    "scaled_mm_general",
    "scaled_mm_lhs_t",
    "scaled_mm_lhs_t_plain",
    "scaled_mm_plain",
    "scaled_mm_ref",
    "scaled_mm_rhs_t",
    "scaled_mm_rhs_t_plain",
]
