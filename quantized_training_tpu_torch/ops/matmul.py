"""The plain tiled matmul: kernel B17 and its plain version.

Counterpart of ``quantized_training_tpu/ops/pallas_mm.py::matmul`` (:537),
which B17 replaces: ``A[M, K] . B[K, N]`` with an int32 accumulator for int8
operands and fp32 otherwise (``_acc_dtype``, :45), every K block added into
it, cast once to ``out_dtype`` (the accumulator's type by default). Its only
caller outside the tests is ``benchmark_mm.py``'s ``pallas_bf16`` row, and
the port's ``benchmark_mm`` runs it the same way.

The forms any caller of the JAX function uses:

- bf16 operands, fp32 accumulator, fp32 or bf16 out;
- int8 operands, int32 accumulator, int32 out.

B17 is ``csrc/matmul.cu``; its header says what bounds it on the H100 and how
the design answers that. Both forms run on the pipelined TMA + wgmma
mainloop of ``csrc/sm90_gemm.cuh`` where TMA can describe their operands
(:func:`sm90_route`; counted in ``matmul.sm90_launches`` for bf16 and
``matmul.s8_sm90_launches`` for int8), and on a wmma kernel elsewhere.
"""

from __future__ import annotations

import torch

from . import _build

# (operand dtype, accumulator dtype) -> the output dtypes it takes
FORMS = {
    (torch.bfloat16, torch.float32): (torch.float32, torch.bfloat16),
    (torch.int8, torch.int32): (torch.int32,),
}


def _form(a, b, acc_dtype, out_dtype):
    """(acc_dtype, out_dtype) of the call, or TypeError naming the forms."""
    acc_dtype = acc_dtype or (torch.int32 if a.dtype == torch.int8 else torch.float32)
    out_dtype = out_dtype or acc_dtype
    if a.dtype != b.dtype or out_dtype not in FORMS.get((a.dtype, acc_dtype), ()):
        raise TypeError(
            f"matmul: operands {a.dtype}, {b.dtype} with accumulator {acc_dtype} and out {out_dtype}; the forms are "
            "bf16 x bf16 -> fp32 accumulator -> fp32 or bf16 out, and int8 x int8 -> int32 accumulator -> int32 out")
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul: shapes {tuple(a.shape)} . {tuple(b.shape)}")
    return acc_dtype, out_dtype


def matmul_plain(a: torch.Tensor, b: torch.Tensor, *, acc_dtype=None, out_dtype=None) -> torch.Tensor:
    """Plain version of B17: the product in float64 (exact for int8 operands,
    |sum| < 2**53; within 2**-53 relative of each partial sum for bf16),
    rounded to the accumulator's type, then cast to ``out_dtype``."""
    acc_dtype, out_dtype = _form(a, b, acc_dtype, out_dtype)
    return (a.double() @ b.double()).to(acc_dtype).to(out_dtype)


def fp32_sum_bound(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise bound, in float64, on |fp32 sum in any order - the plain
    version's fp32|: ``K * 2**-24 * (|a| . |b|)``. A recursive fp32 sum of K
    exact products (a bf16 product is exact in fp32) is within (K - 1) *
    2**-24 of the sum of their magnitudes, and the plain version's single
    rounding within 2**-24 of it: the tolerance of B17's bf16 form (and of
    the JAX kernel's blocked fp32 sums) against :func:`matmul_plain`."""
    return a.shape[1] * 2.0**-24 * (a.double().abs() @ b.double().abs())


def vec_rows(t: torch.Tensor) -> bool:
    """A contiguous 2-D operand starts on a 16-byte boundary and its rows are
    a multiple of 16 bytes long: the wmma kernel loads it in whole 16-byte
    chunks, and TMA can describe it."""
    return t.data_ptr() % 16 == 0 and t.shape[1] * t.element_size() % 16 == 0


def sm90_route(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether B17 on contiguous a and b takes the TMA + wgmma mainloop
    (``csrc/sm90_gemm.cuh``): both forms, where TMA can describe both
    operands (16-byte aligned, rows a multiple of 16 bytes long: for int8
    K % 16 == N % 16 == 0) and K > 0. Operands off a 16-byte boundary or
    with ragged rows take the wmma kernel. The only thing that chooses
    B17's route."""
    return a.shape[1] > 0 and vec_rows(a) and vec_rows(b)


def _launch(a, b, out_dtype):
    """Launch B17 on the current stream; returns (out, whether it took the
    sm90 route)."""
    if not (a.is_cuda and b.device == a.device):
        raise ValueError("matmul: both operands must be on one CUDA device")
    a, b = a.contiguous(), b.contiguous()
    (M, K), N = a.shape, b.shape[1]
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    sm90 = sm90_route(a, b)
    err = _build.library().qt_matmul(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K, int(a.dtype == torch.bfloat16),
        int(out_dtype == torch.bfloat16), int(vec_rows(a)), int(vec_rows(b)), int(sm90), _build.stream(),
    )
    _build.check(err, "matmul")
    return out, sm90


def matmul(a: torch.Tensor, b: torch.Tensor, *, acc_dtype=None, out_dtype=None) -> torch.Tensor:
    """``out[M, N] = a[M, K] . b[K, N]`` accumulated in ``acc_dtype`` (int32
    for int8 operands, fp32 for bf16 by default) and cast to ``out_dtype``
    (the accumulator's type by default); other forms raise TypeError. A CPU
    tensor takes :func:`matmul_plain`; CUDA tensors launch B17 on the current
    stream, at any shape. Launches count per operand type (``launches``
    bf16, ``s8_launches`` int8), and those on the sm90 mainloop
    (:func:`sm90_route`) in ``sm90_launches`` (bf16) or ``s8_sm90_launches``
    (int8) as well."""
    _, out_dtype = _form(a, b, acc_dtype, out_dtype)
    if a.device.type == "cpu":
        return matmul_plain(a, b, acc_dtype=acc_dtype, out_dtype=out_dtype)
    out, sm90 = _launch(a, b, out_dtype)
    if a.dtype == torch.int8:
        matmul.s8_launches += 1
        matmul.s8_sm90_launches += sm90
    else:
        matmul.launches += 1
        matmul.sm90_launches += sm90
    return out


matmul.launches = 0
matmul.s8_launches = 0
matmul.sm90_launches = 0
matmul.s8_sm90_launches = 0


def int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 a [M, K] . b [K, N] -> int32 (JAX ``ops/scaled_mm.py::int8_mm``,
    :45): B17's int8 form."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int8_mm: int8 operands, got {a.dtype}, {b.dtype}")
    return matmul(a, b)
