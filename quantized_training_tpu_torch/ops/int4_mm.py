"""Scaled int4 matmul on packed operands: kernel B16 and its plain version.

Counterpart of ``quantized_training_tpu/ops/int4_mm.py`` (:39-83):
``unpack_int4``, ``int4_mm`` and ``scaled_int4_mm``, whose Pallas kernel
``ops/pallas_mm.py::scaled_int4_mm`` (:636) B16 replaces. Two signed int4
values a byte, the even element in the high nibble; B is taken packed along
K as ``b_t [N, K / 2]``, the layout a row-wise quantize of B^T gives.

The operands cross device memory at 4 bits a value and are widened to int8
on chip. Above the decode sizes B16 runs on the pipelined TMA + wgmma
mainloop of ``csrc/sm90_gemm.cuh``, whose producer widens each landed tile
of b into the K-major int8 stage that wgmma reads while its consumers build
a's fragments in registers (:func:`sm90_route`, counted in
``scaled_int4_mm.sm90_launches``); elsewhere on the wmma kernel of
``csrc/scaled_mm.cu`` (K2's K-major form), whose load stage unpacks in
registers. The sources' headers say what bounds each.
"""

from __future__ import annotations

import torch

from . import _build
from .scaled_mm import _SCALE_DTYPES, DECODE_M, _as_vector


# B16 on the sm90 mainloop sums 256 x each product in int32 (csrc/
# sm90_gemm.cuh, S4KMajor): exact below this K
SM90_MAX_K = 1 << 17


def sm90_route(M: int, K: int, aligned: bool = True) -> bool:
    """Whether B16 with M rows of a and contraction length K (unpacked)
    takes the TMA + wgmma mainloop (``csrc/sm90_gemm.cuh``): above the
    decode sizes (M > ``DECODE_M``, as K2), where TMA can describe the
    packed operands (rows of K / 2 bytes a multiple of 16: K % 32 == 0; both
    operands ``aligned`` on 16 bytes) and 0 < K < ``SM90_MAX_K``. Every
    int4 matmul of the Llama steps qualifies (K 2048, 5632 or 8192). The
    rest stays on the wmma kernel. The only thing that chooses B16's
    route."""
    return M > DECODE_M and K % 32 == 0 and 0 < K < SM90_MAX_K and aligned


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """[..., P] int8 (two nibbles each) -> [..., 2P] int8 values in [-8, 7]."""
    hi = packed >> 4  # arithmetic shift: sign-extends
    lo = (packed << 4) >> 4
    return torch.stack([hi, lo], dim=-1).reshape(*packed.shape[:-1], -1)


def int4_mm(a_packed: torch.Tensor, b_t_packed: torch.Tensor) -> torch.Tensor:
    """a [M, K / 2] packed . unpack(b_t [N, K / 2])^T -> exact int32 [M, N]."""
    a, b = unpack_int4(a_packed), unpack_int4(b_t_packed)
    return torch.tensordot(a.double(), b.double(), dims=([1], [1])).to(torch.int32)


def scaled_int4_mm_plain(a_packed, b_t_packed, row_scale, col_scale, *, out_dtype=torch.bfloat16):
    """Plain version of B16: unpack, contract in float64 (exact: |acc| <
    2**53), round to fp32 as the int32 -> fp32 cast does, then ``(acc *
    row_scale) * col_scale`` in fp32 and one cast, as ``ops/scaled_mm.py``'s
    plain versions."""
    a, b = unpack_int4(a_packed), unpack_int4(b_t_packed)
    M, N = a.shape[0], b.shape[0]
    acc = torch.tensordot(a.double(), b.double(), dims=([1], [1])).float()
    sa = _as_vector(row_scale, M, "row_scale").float().reshape(M, 1)
    sb = _as_vector(col_scale, N, "col_scale").float().reshape(1, N)
    return ((acc * sa) * sb).to(out_dtype)


def _pad_contraction(a, b):
    """Both packed operands with zero bytes after each row up to a multiple
    of 16 (K % 32 == 0), where K is no multiple of 16, which neither kernel
    takes (a grad_weight's tokens, say): zero nibbles add exact zeros, and
    the padded K takes the sm90 route."""
    P = a.shape[-1]
    if a.ndim != 2 or b.ndim != 2 or P != b.shape[-1] or P % 8 == 0:
        return a, b
    return torch.nn.functional.pad(a, (0, -P % 16)), torch.nn.functional.pad(b, (0, -P % 16))


def _launch(a, b, row_scale, col_scale, out_dtype):
    tensors = (a, b, row_scale, col_scale)
    if not all(t.is_cuda and t.device == a.device for t in tensors):
        raise ValueError("scaled_int4_mm: all operands must be on one CUDA device")
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"scaled_int4_mm: int8-packed operands only, got {a.dtype}, {b.dtype}")
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"scaled_int4_mm: shapes {tuple(a.shape)}, {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("scaled_int4_mm: a and b must be contiguous")
    M, P, N = a.shape[0], a.shape[1], b.shape[0]
    # 8-byte packed chunks (16 values) along K (csrc/scaled_mm.cu)
    if P % 8 or a.data_ptr() % 8 or b.data_ptr() % 8:
        raise ValueError(f"scaled_int4_mm: needs K / 2 % 8 == 0 (K % 16 == 0) and 8-byte aligned operands "
                         f"(shapes {tuple(a.shape)}, {tuple(b.shape)})")
    if row_scale.dtype != col_scale.dtype or row_scale.dtype not in _SCALE_DTYPES:
        raise TypeError(f"scaled_int4_mm: scales {row_scale.dtype}, {col_scale.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"scaled_int4_mm: out_dtype {out_dtype}")
    sa = _as_vector(row_scale, M, "row_scale")
    sb = _as_vector(col_scale, N, "col_scale")
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    sm90 = sm90_route(M, 2 * P, a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0)
    err = _build.library().qt_scaled_int4_mm(
        a.data_ptr(), b.data_ptr(), sa.data_ptr(), sb.data_ptr(), out.data_ptr(), M, N, 2 * P,
        int(sa.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16), int(sm90), _build.stream(),
    )
    _build.check(err, "scaled_int4_mm")
    return out, sm90


def scaled_int4_mm(a_packed: torch.Tensor, b_t_packed: torch.Tensor, row_scale: torch.Tensor,
                   col_scale: torch.Tensor, *, out_dtype=torch.bfloat16) -> torch.Tensor:
    """``out[M, N] = ((a . unpack(b_t)^T) * row_scale[M]) * col_scale[N]``
    for packed a [M, K / 2] and b_t [N, K / 2]. Scales [M] / [M, 1] and
    [N] / [1, N] or scalars, bf16 or fp32 (the same for both). A CPU tensor
    takes :func:`scaled_int4_mm_plain`; CUDA tensors launch B16 on the
    current stream, which needs 8-byte aligned, contiguous operands and K %
    16 == 0 (any other K is padded with zeros first, :func:`_pad_contraction`);
    on the sm90 mainloop where :func:`sm90_route` says so (counted in
    ``sm90_launches`` as well)."""
    if a_packed.device.type == "cpu":
        return scaled_int4_mm_plain(a_packed, b_t_packed, row_scale, col_scale, out_dtype=out_dtype)
    out, sm90 = _launch(*_pad_contraction(a_packed, b_t_packed), row_scale, col_scale, out_dtype)
    scaled_int4_mm.launches += 1
    scaled_int4_mm.sm90_launches += sm90
    return out


scaled_int4_mm.launches = 0
scaled_int4_mm.sm90_launches = 0
