"""FP8 (e4m3) quantization and matmuls.

Counterpart of ``quantized_training_tpu/ops/fp8.py`` (:29-97):
``quantize_fp8`` (absmax along one axis), ``quantize_fp8_tile`` (1 x 128
groups along the contraction axis, DeepSeek-V3's activation layout),
``quantize_fp8_block`` (128 x 128 blocks, its weight layout), ``fp8_mm`` and
``scaled_fp8_mm``. The quantizes are plain torch on every device, as XLA
lowered them in the JAX package: the fp32 value divided by the clipped fp32
scale (a tensor: CUDA divides by a Python scalar as a reciprocal multiply),
cast to ``torch.float8_e4m3fn``, the scale returned in x's dtype. The cast
saturates at 448 where ml_dtypes gives NaN above 464; |x / scale| <= 448 by
construction, so no quantize here reaches either.

``scaled_fp8_mm`` with row/column scales is plain torch too (the JAX
package ran it as an XLA dot on bf16-upcast operands): the product in fp32
(e4m3 values and their products are exact there), TF32 off, and the fp32
epilogue ``(acc * sa) * sb`` before the one cast to the output dtype. With
tile scales it is B15 (``ops/tile_scaled_mm.py``).
"""

from __future__ import annotations

import torch

E4M3 = torch.float8_e4m3fn
E5M2 = torch.float8_e5m2
_AMAX = {E4M3: 448.0, E5M2: 57344.0}
FP8_TYPES = (E4M3, E5M2)


def _div(num: torch.Tensor, den: float) -> torch.Tensor:
    """num / den by a tensor on num's device (a fill: no host copy)."""
    return num / num.new_full((), den)


def _cast(xf: torch.Tensor, scale: torch.Tensor, dtype, eps: float) -> torch.Tensor:
    return (xf / scale.clamp(min=eps)).to(dtype)


def quantize_fp8(x: torch.Tensor, *, axis: int = -1, dtype=E4M3, eps: float = 1e-12,
                 amax: torch.Tensor | None = None):
    """Absmax FP8 quantization along ``axis`` -> (fp8 data, scale in x's
    dtype keeping the reduced axis as size 1); dequant = data * scale.
    ``amax``: given fp32 maxima (keepdims) in place of x's own."""
    absmax = x.abs().amax(dim=axis, keepdim=True).float() if amax is None else amax
    scale = _div(absmax, _AMAX[dtype])
    return _cast(x.float(), scale, dtype, eps), scale.to(x.dtype)


def quantize_fp8_tile(x: torch.Tensor, *, group: int = 128, dtype=E4M3, eps: float = 1e-12):
    """1 x ``group`` quantization along the last axis: x [M, K] -> (fp8
    [M, K], scale [M, K / group]), the A operand of the tile-scaled matmul."""
    M, K = x.shape
    if K % group:
        raise ValueError(f"quantize_fp8_tile: K={K} is not a multiple of group={group}")
    xg = x.reshape(M, K // group, group)
    absmax = xg.abs().amax(dim=-1, keepdim=True).float()
    scale = _div(absmax, _AMAX[dtype])
    return _cast(xg.float(), scale, dtype, eps).reshape(M, K), scale[..., 0].to(x.dtype)


def quantize_fp8_block(x: torch.Tensor, *, block: int = 128, dtype=E4M3, eps: float = 1e-12):
    """``block`` x ``block`` quantization: x [K, N] -> (fp8 [K, N], scale
    [K / block, N / block]), the B operand of the tile-scaled matmul."""
    K, N = x.shape
    if K % block or N % block:
        raise ValueError(f"quantize_fp8_block: [{K}, {N}] is not a multiple of block={block}")
    xb = x.reshape(K // block, block, N // block, block)
    absmax = xb.abs().amax(dim=(1, 3), keepdim=True).float()
    scale = _div(absmax, _AMAX[dtype])
    return _cast(xb.float(), scale, dtype, eps).reshape(K, N), scale[:, 0, :, 0].to(x.dtype)


def _vector(s: torch.Tensor, n: int, shape) -> torch.Tensor:
    s = s.float()
    return s.reshape(1, 1) if s.numel() == 1 else s.reshape(n).reshape(shape)


def scaled_fp8_mm_general(a, b, scale_a, scale_b, *, dims=(1, 0), out_dtype=torch.bfloat16):
    """Contract fp8 a over dims[0] and b over dims[1] with a per-row
    (scale_a, size a.shape[1 - dims[0]]) and per-column (scale_b) epilogue,
    scalars broadcast: the fp8 branch of the JAX ``scaled_mm_general``
    (:148-153, :183-188). fp32 product with TF32 off, then ``(acc * sa) *
    sb`` in fp32 and one cast."""
    if a.dtype not in FP8_TYPES or b.dtype not in FP8_TYPES:
        raise TypeError(f"scaled_fp8_mm_general: fp8 operands only, got {a.dtype}, {b.dtype}")
    ca, cb = dims
    M, N = a.shape[1 - ca], b.shape[1 - cb]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        acc = torch.tensordot(a.float(), b.float(), dims=([ca], [cb]))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return ((acc * _vector(scale_a, M, (M, 1))) * _vector(scale_b, N, (1, N))).to(out_dtype)


def fp8_mm(a: torch.Tensor, b: torch.Tensor, *, out_dtype=torch.bfloat16) -> torch.Tensor:
    """a [M, K] fp8 @ b [K, N] fp8 -> out_dtype, fp32 accumulation."""
    one = torch.ones((), device=a.device)
    return scaled_fp8_mm_general(a, b, one, one, out_dtype=out_dtype)


def scaled_fp8_mm(a, b, row_scale, col_scale, *, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Row/col-scaled fp8 matmul a [M, K] @ b [K, N]; tile scales (2-D
    grids) go to B15 through ``ops.scaled_mm.scaled_mm``."""
    from .scaled_mm import scaled_mm

    return scaled_mm(a, b, row_scale, col_scale, out_dtype=out_dtype)
