"""Row-wise int8 quantize: kernel K1 and its plain version.

Counterpart of ``quantized_training_tpu/ops/pallas_quant.py::
quantize_int8_rowwise`` (:139), with the numerics of
``quantized_training_tpu/quant/core.py::quantize_int8`` (:99-115), which the
kernel matches bit for bit. The CUDA source is ``csrc/int8_quant.cu``; its
header says what bounds it on the H100 and how the design answers that.
"""

from __future__ import annotations

import torch

from . import _build

EPS = 1e-12
_DTYPES = (torch.bfloat16, torch.float32)


def quantize_int8_plain(x: torch.Tensor, *, axis: int = -1, eps: float = EPS,
                        noise: torch.Tensor | None = None):
    """``quant/core.py:99-115`` in torch: absmax along ``axis`` (taken in x's
    dtype, exact), scale = absmax / 127 in fp32, q = round-half-even(x /
    max(scale, eps)) (or floor(x / scale + noise) for stochastic rounding)
    clipped to int8; the scale is returned in x's dtype, keepdims."""
    absmax = x.abs().amax(dim=axis, keepdim=True).float()
    # divide by a tensor: PyTorch's CUDA kernels turn division by a Python
    # scalar into a multiply by its reciprocal, which is not IEEE division
    scale = absmax / absmax.new_full((), 127.0)
    q = x.float() / scale.clamp(min=eps)
    q = torch.floor(q + noise) if noise is not None else torch.round(q)
    return q.clamp(-128, 127).to(torch.int8), scale.to(x.dtype)


def quantize_int8_rowwise(x: torch.Tensor, *, eps: float = EPS):
    """x [..., K] -> (q int8 [..., K], scale x.dtype [..., 1]), reducing the
    last axis. A CPU tensor takes :func:`quantize_int8_plain`; a CUDA tensor
    (bf16 or fp32, contiguous) launches K1 on the current stream."""
    if x.device.type == "cpu":
        return quantize_int8_plain(x, eps=eps)
    if not x.is_cuda:
        raise ValueError(f"quantize_int8_rowwise: needs a CPU or CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"quantize_int8_rowwise: dtype {x.dtype} not in {_DTYPES}")
    if not x.is_contiguous():
        raise ValueError("quantize_int8_rowwise: x must be contiguous")
    if x.ndim == 0:
        raise ValueError("quantize_int8_rowwise: x must have a last axis")
    K = x.shape[-1]
    M = x.numel() // K if K else 0
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty((*x.shape[:-1], 1), dtype=x.dtype, device=x.device)
    err = _build.library().qt_quantize_int8_rowwise(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), M, K, eps,
        int(x.dtype == torch.bfloat16), _build.stream(),
    )
    _build.check(err, "quantize_int8_rowwise")
    quantize_int8_rowwise.launches += 1
    return q, scale


quantize_int8_rowwise.launches = 0
