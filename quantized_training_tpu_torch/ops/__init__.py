"""Kernel-level ops of the port.

Counterpart of ``quantized_training_tpu/ops/__init__.py``. Six hand-written
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
  ``ops/pallas_mm.py::scaled_mm_dims`` with dims (0, 0).

Each wrapper counts its kernel launches (:func:`launch_counts`), so a run can
show that its path went through the kernels. Importing this package builds
nothing: the kernels compile at their first launch (``ops/_build.py``).
"""

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

KERNELS = {
    "quantize_int8_rowwise": quantize_int8_rowwise,
    "quantize_int8_colwise": quantize_int8_colwise,
    "quantize_int8_both": quantize_int8_both,
    "scaled_mm_rhs_t": scaled_mm_rhs_t,
    "scaled_mm": scaled_mm,
    "scaled_mm_lhs_t": scaled_mm_lhs_t,
}


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last :func:`reset_launch_counts`."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = [
    "KERNELS",
    "launch_counts",
    "reset_launch_counts",
    "quantize_int8_both",
    "quantize_int8_both_plain",
    "quantize_int8_colwise",
    "quantize_int8_plain",
    "quantize_int8_rowwise",
    "scaled_mm",
    "scaled_mm_general",
    "scaled_mm_lhs_t",
    "scaled_mm_lhs_t_plain",
    "scaled_mm_plain",
    "scaled_mm_ref",
    "scaled_mm_rhs_t",
    "scaled_mm_rhs_t_plain",
]
