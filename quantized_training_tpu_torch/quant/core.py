"""Core int8 quantization numerics.

Counterpart of ``quantized_training_tpu/quant/core.py::quantize_int8``,
``dequantize_int8`` and ``quantize_int8_both`` (:47-174). On a CUDA tensor a
row quantize (``axis=-1``, any ndim) runs kernel K1, a column quantize of a
2-D tensor (``axis=0``) B4, and the both-axes quantize B5
(``ops/int8_quant.py``); a CPU tensor runs the plain versions, along any
axis and with optional stochastic rounding from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import torch

from ..ops.int8_quant import (
    EPS,
    quantize_int8_both as _quantize_both_kernel,
    quantize_int8_colwise,
    quantize_int8_plain,
    quantize_int8_rowwise,
)


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

    The row quantize goes to K1's wrapper and the column quantize of a 2-D
    tensor to B4's, which launch their kernels on a CUDA tensor (a strided
    input is made contiguous first) and take the plain version on a CPU
    tensor. The CPU also takes any other axis and stochastic rounding; on a
    CUDA tensor those raise NotImplementedError.
    """
    if stochastic_rounding:
        if x.device.type != "cpu":
            raise NotImplementedError(
                "quantize_int8: stochastic rounding has no CUDA kernel yet (ROADMAP B3-SR, the SR slice)"
            )
        if generator is None:
            raise ValueError("stochastic_rounding=True requires a generator")
        noise = torch.rand(x.shape, generator=generator, dtype=torch.float32)
        return quantize_int8_plain(x, axis=axis, eps=eps, noise=noise)
    if axis in (-1, x.ndim - 1):
        return quantize_int8_rowwise(x.contiguous(), eps=eps)
    if x.ndim == 2 and axis in (0, -2):
        return quantize_int8_colwise(x.contiguous(), eps=eps)
    if x.device.type == "cpu":
        return quantize_int8_plain(x, axis=axis, eps=eps)
    raise NotImplementedError(
        f"quantize_int8: axis={axis} of a {x.ndim}-D tensor has no CUDA kernel "
        "(K1 reduces the last axis, B4 the first of a 2-D tensor)"
    )


def dequantize_int8(int_data: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return int_data.to(scale.dtype) * scale


def quantize_int8_both(
    x: torch.Tensor,
    *,
    stochastic_rounding: bool = False,
    generator: torch.Generator | None = None,
    eps: float = EPS,
):
    """Quantize a 2-D ``x`` along both axes: -> (q_row, s_row, q_col, s_col).

    The mixed-precision backward consumes the same output gradient row-wise
    (grad_input) and column-wise (grad_weight). This is B5's wrapper: two
    reads of x on a CUDA tensor, the plain version on a CPU tensor; the
    numbers are those of two separate :func:`quantize_int8` calls, bit for
    bit. Stochastic rounding (CPU only) makes those two calls, the row draw
    first from ``generator``.
    """
    if x.ndim != 2:
        raise ValueError(f"quantize_int8_both: needs a 2-D tensor, got shape {tuple(x.shape)}")
    if stochastic_rounding:
        kw = dict(stochastic_rounding=True, generator=generator, eps=eps)
        return (*quantize_int8(x, axis=1, **kw), *quantize_int8(x, axis=0, **kw))
    return _quantize_both_kernel(x.contiguous(), eps=eps)
