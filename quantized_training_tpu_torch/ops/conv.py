"""Convolutions: float, int8 -> int32, and int8 with a per-channel scale.

Counterpart of ``quantized_training_tpu/ops/conv.py``: NHWC activations and
HWIO weights (its ``_DN``), symmetric zero padding, a stride per axis.

- :func:`conv2d` on floats is plain torch, ``F.conv2d`` in fp32 after a
  permute to NCHW / OIHW, cast to the input's dtype (XLA lowered it with no
  Pallas kernel); on int8 it is :func:`int8_conv2d`, as in the JAX package.
- :func:`int8_conv2d` and :func:`scaled_int8_conv2d` lower to the port's
  int8 GEMMs through im2col: the padded input viewed as [B, OH, OW, kh, kw,
  C] with ``as_strided`` and made contiguous as [B * OH * OW, kh * kw * C];
  an HWIO weight reshapes to [kh * kw * C, O] in the same order.
  ``int8_conv2d`` is B17's int8 form (``ops/matmul.py``, int8 -> int32);
  ``scaled_int8_conv2d`` is K2 (``ops/scaled_mm.py::scaled_mm_rhs_t``) on
  the weight as [O, kh * kw * C], a row scale of ones and the channel scale
  as the column scale, whose fp32 epilogue ``(acc * 1) * scale`` is the
  reference's fused one (``triton_conv2d.py:316-319``, JAX :70-71). A
  contraction off a multiple of 16 (C = 3 at 3 x 3 is 27) is zero-padded to
  one: exact for integers, and what both kernels' TMA routes need.

A CPU tensor takes the GEMMs' plain versions, whose int32 sums are exact
(float64 products, never fp32: 3 x 3 x 512 = 4,608 products of int8 pass
2**24); a CUDA tensor launches the kernels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .matmul import matmul
from .scaled_mm import scaled_mm_rhs_t

# the contraction is padded to this many int8 values (16 bytes)
K_ALIGN = 16


def _norm2(v) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def out_hw(H: int, W: int, kh: int, kw: int, stride, padding) -> tuple[int, int]:
    """The output's spatial size."""
    (sh, sw), (ph, pw) = _norm2(stride), _norm2(padding)
    return (H + 2 * ph - kh) // sh + 1, (W + 2 * pw - kw) // sw + 1


def im2col(x: torch.Tensor, kh: int, kw: int, stride, padding, k_align: int = 1) -> torch.Tensor:
    """NHWC x [B, H, W, C] -> patches [B * OH * OW, K] with K = kh * kw * C
    in (kh, kw, C) order, zero columns appended to a multiple of
    ``k_align``."""
    (sh, sw), (ph, pw) = _norm2(stride), _norm2(padding)
    B, H, W, C = x.shape
    OH, OW = out_hw(H, W, kh, kw, stride, padding)
    xp = F.pad(x, (0, 0, pw, pw, ph, ph)).contiguous()
    sB, sH, sW, sC = xp.stride()
    patches = xp.as_strided((B, OH, OW, kh, kw, C), (sB, sH * sh, sW * sw, sH, sW, sC))
    K = kh * kw * C
    Kp = -(-K // k_align) * k_align
    if Kp == K:
        return patches.reshape(B * OH * OW, K)
    cols = x.new_zeros((B * OH * OW, Kp))
    cols.view(B, OH, OW, Kp)[..., :K].unflatten(-1, (kh, kw, C)).copy_(patches)
    return cols


def _check_int8(x, w, what):
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"{what}: int8 x and w, got {x.dtype}, {w.dtype}")
    if x.ndim != 4 or w.ndim != 4 or x.shape[3] != w.shape[2]:
        raise ValueError(f"{what}: x [B, H, W, C] and w [kh, kw, C, O], got {tuple(x.shape)}, {tuple(w.shape)}")


def weight_kn(w: torch.Tensor, Kp: int) -> torch.Tensor:
    """HWIO w -> [Kp, O], zero rows past K = kh * kw * C."""
    kh, kw, C, O = w.shape
    wk = w.reshape(kh * kw * C, O)
    return wk if Kp == wk.shape[0] else F.pad(wk, (0, 0, 0, Kp - wk.shape[0]))


def int8_conv2d(x: torch.Tensor, w: torch.Tensor, stride=1, padding=0) -> torch.Tensor:
    """x [B, H, W, C] int8, w [kh, kw, C, O] int8 -> int32 [B, OH, OW, O],
    the exact sums: im2col, then B17's int8 form."""
    _check_int8(x, w, "int8_conv2d")
    kh, kw, _, O = w.shape
    cols = im2col(x, kh, kw, stride, padding, K_ALIGN)
    out = matmul(cols, weight_kn(w, cols.shape[1]).contiguous())
    return out.view(x.shape[0], *out_hw(*x.shape[1:3], kh, kw, stride, padding), O)


def scaled_int8_conv2d(x: torch.Tensor, w: torch.Tensor, channel_scale: torch.Tensor, stride=1, padding=0, *,
                       out_dtype=torch.bfloat16) -> torch.Tensor:
    """int8 conv with a per-output-channel scale (JAX :59-76): the int32
    sums times ``channel_scale`` [O] in fp32, cast to ``out_dtype``. im2col,
    then K2 with a row scale of ones; K2 writes bf16 or fp32, another dtype
    is cast from its fp32 out."""
    _check_int8(x, w, "scaled_int8_conv2d")
    kh, kw, _, O = w.shape
    cols = im2col(x, kh, kw, stride, padding, K_ALIGN)
    w_ok = weight_kn(w, cols.shape[1]).T.contiguous()
    ones = torch.ones(cols.shape[0], dtype=torch.float32, device=x.device)
    k2_out = out_dtype if out_dtype in (torch.bfloat16, torch.float32) else torch.float32
    out = scaled_mm_rhs_t(cols, w_ok, ones, channel_scale.reshape(-1).float(), out_dtype=k2_out)
    return out.to(out_dtype).view(x.shape[0], *out_hw(*x.shape[1:3], kh, kw, stride, padding), O)


def conv2d(x: torch.Tensor, w: torch.Tensor, stride=1, padding=0) -> torch.Tensor:
    """Generic NHWC / HWIO conv (JAX :27-45): int8 operands give the int32
    sums (:func:`int8_conv2d`); floats ``F.conv2d`` in fp32, cast to x's
    dtype."""
    if x.dtype == torch.int8:
        return int8_conv2d(x, w, stride, padding)
    out = F.conv2d(x.permute(0, 3, 1, 2).float(), w.permute(3, 2, 0, 1).float(), stride=_norm2(stride),
                   padding=_norm2(padding))
    return out.permute(0, 2, 3, 1).to(x.dtype).contiguous()
