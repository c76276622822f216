"""MX (OCP microscaling) and NVFP4 block quantization.

Counterpart of ``quantized_training_tpu/ops/mx.py``, function for function
and bit for bit: E8M0 power-of-two block scales from a block's absmax,
OCP's floor (:63) and cuBLAS's round-up (:50), by fp32 exponent bits; fp32
to FP4-E2M1 codes by explicit decision thresholds (:73), packed two to a
byte; ``quantize_mx`` over 32-element blocks (:103) and ``quantize_nvfp4``
over 16-element blocks with e4m3 scales and an fp32 tensor scale (:148),
their dequantizes, the block-scaled products ``mxfp4_mm`` / ``nvfp4_mm``
(:177, :210) and NVIDIA's 128 x 4 swizzled scale layout (:244).

Numerics only, in plain torch on every device: the JAX package has no
Pallas kernel here, and the H100 has no fp4 tensor cores. The two products
dequantize to bf16 (exact: an E2M1 value times a power of two or an e4m3
scale has at most 6 significant bits) and take one bf16 GEMM with fp32
accumulation, B17 (``ops/matmul.py``) with its fp32 output, where the JAX
package took XLA's dot; the scale and bias epilogue is torch's. B17 sums
in another order than XLA: the products agree within
``matmul.fp32_sum_bound`` of their operands.

Nibble order: the even element in the LOW nibble (JAX :19-21), unlike the
int4 schemes' packing (``quant/core.py``: even element high). The two do
not share a packer.

Casts to ``torch.float8_e4m3fn`` saturate on no device the same way, so
values are clipped to the format's maximum first, where JAX clips. Every
division is by a tensor: CUDA turns a division by a Python scalar into a
multiply by its reciprocal, which is not the IEEE quotient.
"""

from __future__ import annotations

import functools

import torch

from .matmul import matmul

F8E4M3 = torch.float8_e4m3fn
F8E5M2 = torch.float8_e5m2
E8M0 = torch.float8_e8m0fnu

DTYPE_AMAX = {F8E4M3: 448.0, F8E5M2: 57344.0, "fp4": 6.0}
DTYPE_POW2_AMAX = {F8E4M3: 256.0, F8E5M2: 32768.0, "fp4": 4.0}

# the E2M1 values of the 16 codes (JAX :40-44)
_LUT = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0, -0.0, -0.5, -1.0, -1.5, -2.0, -3.0, -4.0, -6.0)
FP4E2M1_LUT = torch.tensor(_LUT, dtype=torch.float32)


@functools.cache
def _lut(device: torch.device) -> torch.Tensor:
    """The LUT on ``device``, copied there once: a host-to-device copy cannot
    run inside a CUDA graph's capture."""
    return FP4E2M1_LUT.to(device)


def _scalar(v, device) -> torch.Tensor:
    """An fp32 0-d tensor of ``v`` on ``device``; a Python number is filled
    there, not copied from the host (graph-capturable)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.full((), float(v), dtype=torch.float32, device=device)


def _div(num: torch.Tensor, den: float) -> torch.Tensor:
    """num / den as the IEEE quotient on every device."""
    return num / num.new_full((), den)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.float().contiguous().view(torch.int32)


def _f32(bits: torch.Tensor) -> torch.Tensor:
    return bits.to(torch.int32).contiguous().view(torch.float32)


def absmax_to_mx_scales_nv(absmax: torch.Tensor, dtype) -> torch.Tensor:
    """cuBLAS's round-up E8M0 exponent of absmax / amax (JAX :50-60): int32
    bits, the exponent plus one where the mantissa is not zero."""
    if absmax.dtype != torch.float32:
        raise TypeError(f"absmax_to_mx_scales_nv: needs fp32, got {absmax.dtype}")
    bits = _bits(_div(absmax, DTYPE_AMAX[dtype]))
    exponent, mantissa = bits >> 23, bits & 0x7FFFFF
    round_up = ((exponent > 0) & (exponent < 254) & (mantissa > 0)) | ((exponent == 0) & (mantissa > 0x400000))
    return torch.where(round_up, exponent + 1, exponent)


def absmax_to_mx_scales_ocp(absmax: torch.Tensor, dtype) -> torch.Tensor:
    """OCP's floor to a power of two of absmax, over the format's largest
    power of two (JAX :63-70): int32 exponent bits."""
    if absmax.dtype != torch.float32:
        raise TypeError(f"absmax_to_mx_scales_ocp: needs fp32, got {absmax.dtype}")
    pow2 = _f32(_bits(absmax) & 0x7F800000)
    return _bits(_div(pow2, DTYPE_POW2_AMAX[dtype])) >> 23


def fp32_to_fp4e2m1(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> E2M1 codes in [0, 15] as int32, round to nearest even by
    thresholds (JAX :73-85)."""
    sign = (_bits(x) >> 31) & 0x1
    a = x.float().abs()
    code = torch.where(a <= 5.0, 0b0110, 0b0111)
    for bound, inclusive, c in ((3.5, False, 0b0101), (2.5, True, 0b0100), (1.75, False, 0b0011),
                                (1.25, True, 0b0010), (0.75, False, 0b0001), (0.25, True, 0b0000)):
        code = torch.where(a <= bound if inclusive else a < bound, c, code)
    return (sign << 3) | code.to(torch.int32)


def pack_fp4(codes: torch.Tensor) -> torch.Tensor:
    """[..., N] codes -> [..., N // 2] uint8, the even element in the LOW
    nibble (JAX :88-93)."""
    lo = codes[..., 0::2] & 0xF
    hi = codes[..., 1::2] & 0xF
    return (lo | (hi << 4)).to(torch.uint8)


def unpack_fp4(packed: torch.Tensor) -> torch.Tensor:
    """[..., P] uint8 -> [..., 2P] int32 codes, low nibble first (JAX
    :96-100)."""
    p = packed.to(torch.int32)
    return torch.stack([p & 0xF, p >> 4], dim=-1).reshape(*packed.shape[:-1], -1)


def _amax_key(dtype):
    if dtype not in DTYPE_AMAX:
        raise ValueError(f"unsupported MX element type {dtype!r}: float8_e4m3fn, float8_e5m2 or 'fp4'")
    return dtype


def quantize_mx(x: torch.Tensor, dtype, compute_scale_method: str = "ocp"):
    """OCP MX over 32-element blocks of the last axis (JAX :103-133).
    ``dtype``: ``torch.float8_e4m3fn``, ``torch.float8_e5m2`` or 'fp4'.
    Returns (xq, scales): xq fp8 [..., N] or packed fp4 uint8 [..., N // 2],
    scales E8M0 [..., N // 32]."""
    key = _amax_key(dtype)
    xb = x.float().reshape(*x.shape[:-1], -1, 32)
    amax = xb.abs().amax(dim=-1)
    if compute_scale_method == "ocp":
        scale_bits = absmax_to_mx_scales_ocp(amax, key)
    elif compute_scale_method == "nv":
        scale_bits = absmax_to_mx_scales_nv(amax, key)
    else:
        raise ValueError(f"unsupported compute_scale_method={compute_scale_method!r}")
    scales = scale_bits.to(torch.uint8).view(E8M0)
    limit = DTYPE_AMAX[key]
    xb = (xb / _f32(scale_bits << 23)[..., None].clamp(min=1e-12)).clamp(-limit, limit)
    if key == "fp4":
        return pack_fp4(fp32_to_fp4e2m1(xb).reshape(*x.shape[:-1], -1)), scales
    return xb.reshape(x.shape).to(dtype), scales


def _scale_f32(scales: torch.Tensor) -> torch.Tensor:
    """E8M0 scales -> fp32 2**(e - 127)."""
    return _f32(scales.view(torch.uint8).to(torch.int32) << 23)


def dequantize_mxfp4(xq: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Packed fp4 [M, N // 2] and E8M0 scales [M, N // 32] -> fp32 [M, N]
    (JAX :136-145)."""
    vals = _lut(xq.device)[unpack_fp4(xq).long()]
    M = vals.shape[0]
    return (vals.reshape(M, -1, 32) * _scale_f32(scales).reshape(M, -1, 1)).reshape(M, -1)


def quantize_nvfp4(x: torch.Tensor, tensor_scale=None):
    """NVFP4 over 16-element blocks of the last axis: e4m3 block scales and
    an fp32 tensor scale, max|x| / (6 * 448) unless given (JAX :148-166).
    Returns (packed uint8 [..., N // 2], scales e4m3 [..., N // 16],
    tensor_scale fp32)."""
    xb = x.float().reshape(*x.shape[:-1], -1, 16)
    q_amax, s_amax = DTYPE_AMAX["fp4"], DTYPE_AMAX[F8E4M3]
    if tensor_scale is None:
        tensor_scale = _div(xb.abs().amax(), q_amax * s_amax)
    else:
        tensor_scale = _scalar(tensor_scale, x.device)
    blocks_amax = xb.abs().amax(dim=-1)
    scales_f32 = blocks_amax / (q_amax * tensor_scale).clamp(min=1e-12)
    scales = scales_f32.clamp(-s_amax, s_amax).to(F8E4M3)
    denom = (tensor_scale * scales.float()).clamp(min=1e-12)
    xq = pack_fp4(fp32_to_fp4e2m1(xb / denom[..., None]).reshape(*x.shape[:-1], -1))
    return xq, scales, tensor_scale


def dequantize_nvfp4(xq: torch.Tensor, scales: torch.Tensor, tensor_scale) -> torch.Tensor:
    """Packed fp4 [M, N // 2], e4m3 scales [M, N // 16] and the tensor
    scale -> fp32 [M, N] (JAX :169-174)."""
    vals = _lut(xq.device)[unpack_fp4(xq).long()]
    M = vals.shape[0]
    s = scales.float() * _scalar(tensor_scale, xq.device)
    return (vals.reshape(M, -1, 16) * s.reshape(M, -1, 1)).reshape(M, -1)


def _bf16_product(af: torch.Tensor, bf: torch.Tensor) -> torch.Tensor:
    """af [M, K] . bf [N, K]^T in bf16 with an fp32 accumulator and fp32
    out: B17 (its plain version on the CPU)."""
    return matmul(af.to(torch.bfloat16).contiguous(), bf.to(torch.bfloat16).T.contiguous(),
                  out_dtype=torch.float32)


def _epilogue(out, bias, out_dtype):
    if bias is not None:
        out = out + bias.float()[None, :]
    return out.to(out_dtype)


def mxfp4_mm(a_packed, b_t_packed, scale_a, scale_b, bias=None, *, out_dtype=torch.bfloat16):
    """MXFP4 block-scaled matmul (JAX :177-207): A [M, K // 2] and B^T
    [N, K // 2] packed fp4 with E8M0 scales per 32-element block of K
    (scale_a [M, K // 32], scale_b [N, K // 32]), an optional bias [N]; both
    dequantized to bf16, B17's fp32 product, then the bias, in
    ``out_dtype``."""
    out = _bf16_product(dequantize_mxfp4(a_packed, scale_a), dequantize_mxfp4(b_t_packed, scale_b))
    return _epilogue(out, bias, out_dtype)


def nvfp4_mm(a_packed, b_t_packed, scale_a, scale_b, output_scale, bias=None, *, out_dtype=torch.bfloat16):
    """NVFP4 block-scaled matmul (JAX :210-241): 16-element blocks of K with
    e4m3 scales (scale_a [M, K // 16], scale_b [N, K // 16]);
    ``output_scale`` (tensor_scale_a * tensor_scale_b) multiplies the fp32
    product, then the optional bias [N] is added."""
    lut = _lut(a_packed.device)
    a_codes, b_codes = lut[unpack_fp4(a_packed).long()], lut[unpack_fp4(b_t_packed).long()]
    M, N = a_codes.shape[0], b_codes.shape[0]
    af = (a_codes.reshape(M, -1, 16) * scale_a.float()[..., None]).reshape(M, -1)
    bf = (b_codes.reshape(N, -1, 16) * scale_b.float()[..., None]).reshape(N, -1)
    out = _bf16_product(af, bf) * _scalar(output_scale, af.device)
    return _epilogue(out, bias, out_dtype)


def pack_block_scales_nv(scales: torch.Tensor) -> torch.Tensor:
    """NVIDIA's 128 x 4 swizzled layout of [M, N] block scales, M % 128 ==
    N % 4 == 0, flattened (JAX :244-251). One-byte types move as bytes."""
    M, N = scales.shape
    if M % 128 or N % 4:
        raise ValueError(f"pack_block_scales_nv: needs M % 128 == N % 4 == 0, got {tuple(scales.shape)}")
    raw = scales.view(torch.uint8) if scales.element_size() == 1 and scales.is_floating_point() else scales
    out = raw.reshape(M // 128, 128, N // 4, 4).permute(0, 2, 1, 3)
    out = out.reshape(-1, 4, 32, 4).permute(0, 2, 1, 3).reshape(-1)
    return out.view(scales.dtype) if raw is not scales else out
