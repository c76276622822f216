"""Tile-scaled matmul with two accumulators: kernel B15 and its plain version.

Counterpart of ``quantized_training_tpu/ops/pallas_mm.py::tile_scaled_mm``
(:378), which B15 replaces, and of ``ops/scaled_mm.py::_tile_scaled_mm_xla``
(:191-218), the JAX package's default for the tile-scaled mode of
``scaled_mm``: a [M, K] . b [K, N] with scale_a [M / QM, K / QK] and scale_b
[K / QK, N / QN], each K block's partial product rescaled by its pair of
scales and accumulated in fp32 (DeepSeek-V3's 1 x 128 activation groups and
128 x 128 weight blocks at QM = 1, QK = QN = 128).

B15 is ``csrc/tile_scaled_mm.cu``, for int8 and for e4m3 operands; its header
says what bounds it and how the design answers that. At QK % 128 == 0
(every call of the model: QK = 128) it runs on the pipelined TMA + wgmma
mainloop of ``csrc/sm90_gemm.cuh`` (:func:`sm90_route`, counted in
``sm90_launches`` and ``s8_sm90_launches``), whose producer rewrites each
landed tile into the stage wgmma reads (int8: b transposed to K-major;
e4m3: both operands widened to fp16, since e4m3 wgmma accumulates too
coarsely for ``fold_bound``) and whose consumers fold each quant block's
partial into the fp32 accumulator; the other quant blocks the wrapper
takes keep the wmma kernel.
"""

from __future__ import annotations

import torch

from . import _build

_KERNEL_TYPES = (torch.int8, torch.float8_e4m3fn)
_SCALE_DTYPES = (torch.bfloat16, torch.float32)


def sm90_route(qk: int) -> bool:
    """Whether B15 with a K quant block of ``qk`` takes the TMA + wgmma
    mainloop (``csrc/sm90_gemm.cuh``), whose 128-byte K steps fold a
    partial only at a step's end: where QK % 128 == 0. Every tile-scaled
    matmul of the model does (QK = 128); QK = 64 (2k + 1) keeps the wmma
    kernel. The only thing that chooses B15's route."""
    return qk % 128 == 0


def _grid(a, b, scale_a, scale_b):
    """(qm, qk, qn) of the scale grids, checked against the operands."""
    M, K = a.shape
    K2, N = b.shape
    n_qm, n_qk = scale_a.shape
    n_qk2, n_qn = scale_b.shape
    if K != K2 or n_qk != n_qk2 or M % n_qm or K % n_qk or N % n_qn:
        raise ValueError(f"tile_scaled_mm: operands {tuple(a.shape)}, {tuple(b.shape)} with scale grids "
                         f"{tuple(scale_a.shape)}, {tuple(scale_b.shape)}")
    qm, qk, qn = M // n_qm, K // n_qk, N // n_qn
    if qk < 128:
        raise ValueError(f"tile_scaled_mm: the K quant block ({qk}) must be >= 128")
    return qm, qk, qn


def tile_scaled_mm_plain(a, b, scale_a, scale_b, *, out_dtype=torch.bfloat16):
    """Plain version of B15, in the kernel's order: per K block the partial
    product in float64 (exact for int8 and e4m3 operands at these depths),
    rounded to fp32, then ``acc = acc + (part * sa) * sb`` in fp32, block
    after block; one cast at the end."""
    qm, qk, qn = _grid(a, b, scale_a, scale_b)
    sa = scale_a.float().repeat_interleave(qm, dim=0)  # [M, KB]
    sb = scale_b.float().repeat_interleave(qn, dim=1)  # [KB, N]
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32, device=a.device)
    for kb in range(scale_a.shape[1]):
        k = slice(kb * qk, (kb + 1) * qk)
        part = (a[:, k].double() @ b[k].double()).float()
        acc = acc + (part * sa[:, kb:kb + 1]) * sb[kb:kb + 1]
    return acc.to(out_dtype)


def fold_bound(a, b, scale_a, scale_b, roundings: int) -> torch.Tensor:
    """``roundings`` fp32 roundings of the folded magnitudes, elementwise, in
    float64: roundings * 2**-23 * sum_kb (|a_kb| . |b_kb|) * sa * sb. A
    recursive fp32 sum of n terms is within (n - 1) * 2**-24 of the sum of
    their magnitudes, so two implementations that sum a K block's products
    and fold the blocks in their own orders differ by at most this with
    ``roundings`` = QK + n_qk (n_qk when the block sums are exact, as for
    int8): the tolerance of B15's e4m3 form against its plain version."""
    qm, qk, qn = _grid(a, b, scale_a, scale_b)
    sa = scale_a.double().abs().repeat_interleave(qm, dim=0)
    sb = scale_b.double().abs().repeat_interleave(qn, dim=1)
    mag = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float64, device=a.device)
    for kb in range(scale_a.shape[1]):
        k = slice(kb * qk, (kb + 1) * qk)
        mag += (a[:, k].double().abs() @ b[k].double().abs()) * sa[:, kb:kb + 1] * sb[kb:kb + 1]
    return roundings * 2.0**-23 * mag


def _launch(a, b, scale_a, scale_b, out_dtype):
    tensors = (a, b, scale_a, scale_b)
    if not all(t.is_cuda and t.device == a.device for t in tensors):
        raise ValueError("tile_scaled_mm: all operands must be on one CUDA device")
    if a.dtype != b.dtype or a.dtype not in _KERNEL_TYPES:
        raise TypeError(f"tile_scaled_mm: int8 or float8_e4m3fn operands of one type, got {a.dtype}, {b.dtype}")
    if a.ndim != 2 or b.ndim != 2 or scale_a.ndim != 2 or scale_b.ndim != 2:
        raise ValueError("tile_scaled_mm: 2-D operands and scale grids")
    qm, qk, qn = _grid(a, b, scale_a, scale_b)
    M, K = a.shape
    N = b.shape[1]
    # K steps of 64 inside a quant block, 16-byte chunks along K of a and N of b
    if qk % 64 or N % 16 or a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError(f"tile_scaled_mm: needs QK % 64 == 0 (QK = {qk}), N % 16 == 0 (N = {N}) and "
                         "16-byte aligned operands")
    if scale_a.dtype != scale_b.dtype or scale_a.dtype not in _SCALE_DTYPES:
        raise TypeError(f"tile_scaled_mm: scales {scale_a.dtype}, {scale_b.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"tile_scaled_mm: out_dtype {out_dtype}")
    a, b, sa, sb = (t.contiguous() for t in tensors)
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    sm90 = sm90_route(qk)
    err = _build.library().qt_tile_scaled_mm(
        a.data_ptr(), b.data_ptr(), sa.data_ptr(), sb.data_ptr(), out.data_ptr(), M, N, K, qm, qk, qn,
        int(a.dtype == torch.float8_e4m3fn), int(sa.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        int(sm90), _build.stream(),
    )
    _build.check(err, "tile_scaled_mm")
    return out, sm90


def tile_scaled_mm(a: torch.Tensor, b: torch.Tensor, scale_a: torch.Tensor, scale_b: torch.Tensor,
                   *, out_dtype=torch.bfloat16) -> torch.Tensor:
    """``out = sum_kb ((a[:, kb] . b[kb, :]) * scale_a[:, kb]) * scale_b[kb, :]``
    with the scale grids expanded over their QM rows and QN columns. A CPU
    tensor takes :func:`tile_scaled_mm_plain` (any operand type); CUDA
    tensors launch B15 on the current stream: int8 or e4m3 operands, QK a
    multiple of 64 and at least 128, N % 16 == 0; on the sm90 mainloop where
    :func:`sm90_route` says so. Launches count per operand type
    (``launches`` e4m3, ``s8_launches`` int8), those on the sm90 route also
    in ``sm90_launches`` and ``s8_sm90_launches``."""
    if a.device.type == "cpu":
        return tile_scaled_mm_plain(a, b, scale_a, scale_b, out_dtype=out_dtype)
    out, sm90 = _launch(a, b, scale_a, scale_b, out_dtype)
    if a.dtype == torch.int8:
        tile_scaled_mm.s8_launches += 1
        tile_scaled_mm.s8_sm90_launches += sm90
    else:
        tile_scaled_mm.launches += 1
        tile_scaled_mm.sm90_launches += sm90
    return out


tile_scaled_mm.launches = 0
tile_scaled_mm.sm90_launches = 0
tile_scaled_mm.s8_launches = 0
tile_scaled_mm.s8_sm90_launches = 0
