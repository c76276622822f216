"""Core int8 quantization numerics.

Counterpart of ``quantized_training_tpu/quant/core.py::quantize_int8`` and
``dequantize_int8`` (:47-119). A row quantize (``axis=-1``, any ndim) of a
CUDA tensor runs kernel K1 (``ops/int8_quant.py``); a CPU tensor runs the
plain version, along any axis and with optional stochastic rounding from an
explicit ``torch.Generator``.
"""

from __future__ import annotations

import torch

from ..ops.int8_quant import EPS, quantize_int8_plain, quantize_int8_rowwise


def quantize_int8(
    x: torch.Tensor,
    *,
    axis: int = -1,
    stochastic_rounding: bool = False,
    generator: torch.Generator | None = None,
    eps: float = EPS,
):
    """Absmax symmetric INT8 quantization along ``axis``.

    Returns ``(int_data int8, scale x.dtype)`` with ``scale`` keeping the
    reduced axis as size 1, so that ``dequant = int_data * scale``. The scale
    is computed in fp32 and cast back to x's dtype.

    On a CUDA tensor only the row quantize exists (K1; a strided input is
    made contiguous first). ``axis`` other than the last, and stochastic
    rounding, raise NotImplementedError there: their kernels (ROADMAP B3 SR,
    B4 colwise) are not ported yet, and they are off the serving path.
    """
    if x.device.type == "cpu":
        noise = None
        if stochastic_rounding:
            if generator is None:
                raise ValueError("stochastic_rounding=True requires a generator")
            noise = torch.rand(x.shape, generator=generator, dtype=torch.float32)
        return quantize_int8_plain(x, axis=axis, eps=eps, noise=noise)
    if stochastic_rounding:
        raise NotImplementedError(
            "quantize_int8: stochastic rounding has no CUDA kernel yet "
            "(ROADMAP B3, the SR variant of quantize_int8_rowwise)"
        )
    if axis not in (-1, x.ndim - 1):
        raise NotImplementedError(
            f"quantize_int8: axis={axis} has no CUDA kernel yet "
            "(ROADMAP B4 quantize_int8_colwise)"
        )
    return quantize_int8_rowwise(x.contiguous(), eps=eps)


def dequantize_int8(int_data: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return int_data.to(scale.dtype) * scale
