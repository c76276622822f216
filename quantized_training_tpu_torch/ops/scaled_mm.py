"""Scaled int8 matmul: kernel K2, its plain version, and the fp32 oracle.

Counterparts in the JAX package:

- ``ops/pallas_mm.py::scaled_mm_dims`` (:192) with dims (1, 1), the TPU
  kernel K2 replaces (``csrc/scaled_mm.cu``; its header says what bounds it
  on the H100 and how the design answers that);
- ``ops/scaled_mm.py::scaled_mm_general`` (:122), the contraction-dims
  dispatcher, of which the port has the (1, 1) form on the card;
- ``ops/scaled_mm.py::scaled_mm_ref`` (:221), the fp32 oracle.
"""

from __future__ import annotations

import torch

from . import _build

_SCALE_DTYPES = (torch.bfloat16, torch.float32)


def _as_vector(s: torch.Tensor, n: int, what: str) -> torch.Tensor:
    """A per-row/col scale ([n], [n, 1], [1, n]) or a scalar -> contiguous [n]."""
    s = s.reshape(-1)
    if s.numel() == 1:
        s = s.expand(n)
    if s.numel() != n:
        raise ValueError(f"{what}: {s.numel()} scales for {n} rows/cols")
    return s.contiguous()


def _plain(a, b, scale_a, scale_b, dims, out_dtype):
    """Contract a over dims[0] and b over dims[1] in float64 (exact for int8
    operands, |acc| < 2**53), round to fp32 as the int32 -> fp32 cast does,
    then the epilogue ``(acc * sa) * sb`` in fp32."""
    ca, cb = dims
    M, N = a.shape[1 - ca], b.shape[1 - cb]
    acc = torch.tensordot(a.double(), b.double(), dims=([ca], [cb])).float()
    sa = _as_vector(scale_a, M, "scale_a").float().reshape(M, 1)
    sb = _as_vector(scale_b, N, "scale_b").float().reshape(1, N)
    return ((acc * sa) * sb).to(out_dtype)


def scaled_mm_rhs_t_plain(a, b, scale_a, scale_b, *, out_dtype=torch.bfloat16):
    """Plain version of K2: a [M, K] . b [N, K]^T with the row x col epilogue."""
    return _plain(a, b, scale_a, scale_b, (1, 1), out_dtype)


def scaled_mm_rhs_t(a: torch.Tensor, b: torch.Tensor, scale_a: torch.Tensor,
                    scale_b: torch.Tensor, *, out_dtype=torch.bfloat16) -> torch.Tensor:
    """``out[M, N] = ((a[M, K] . b[N, K]^T) * scale_a[M]) * scale_b[N]``.

    a and b are int8 and K-major. The scales are per row of a and per row
    of b ([M, 1] / [1, N] / [M] / [N]) or scalars, bf16 or fp32 (the same
    for both). A CPU tensor takes :func:`scaled_mm_rhs_t_plain`; CUDA
    tensors launch K2 on the current stream, which needs K % 16 == 0 and
    16-byte aligned, contiguous operands."""
    if a.device.type == "cpu":
        return scaled_mm_rhs_t_plain(a, b, scale_a, scale_b, out_dtype=out_dtype)
    tensors = (a, b, scale_a, scale_b)
    if not all(t.is_cuda and t.device == a.device for t in tensors):
        raise ValueError("scaled_mm_rhs_t: all operands must be on one CUDA device")
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"scaled_mm_rhs_t: int8 operands only, got {a.dtype}, {b.dtype}")
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"scaled_mm_rhs_t: shapes {tuple(a.shape)} . {tuple(b.shape)}^T")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("scaled_mm_rhs_t: a and b must be contiguous")
    M, K = a.shape
    N = b.shape[0]
    if K % 16 or a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError(f"scaled_mm_rhs_t: needs K % 16 == 0 and 16-byte aligned operands (K={K})")
    if scale_a.dtype != scale_b.dtype or scale_a.dtype not in _SCALE_DTYPES:
        raise TypeError(f"scaled_mm_rhs_t: scales {scale_a.dtype}, {scale_b.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"scaled_mm_rhs_t: out_dtype {out_dtype}")
    sa = _as_vector(scale_a, M, "scale_a")
    sb = _as_vector(scale_b, N, "scale_b")
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    err = _build.library().qt_scaled_mm_s8(
        a.data_ptr(), b.data_ptr(), sa.data_ptr(), sb.data_ptr(), out.data_ptr(),
        M, N, K, int(sa.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        _build.stream(),
    )
    _build.check(err, "scaled_mm_rhs_t")
    scaled_mm_rhs_t.launches += 1
    return out


scaled_mm_rhs_t.launches = 0


def scaled_mm_general(a, b, scale_a, scale_b, *, dims=(1, 0), out_dtype=torch.bfloat16):
    """Row/col-scaled matmul with explicit contraction dims: a over dims[0],
    b over dims[1]; scale_a per out-row, scale_b per out-col (scalars
    broadcast). dims (1, 1) is K2. The other forms (the training backward's
    (1, 0) and (0, 0)) run only on the CPU for now: on the card they raise
    NotImplementedError until their kernels land (ROADMAP, queue B)."""
    dims = tuple(dims)
    if dims == (1, 1):
        return scaled_mm_rhs_t(a, b, scale_a, scale_b, out_dtype=out_dtype)
    if dims not in ((1, 0), (0, 0)):
        raise ValueError(f"scaled_mm_general: dims {dims}")
    if a.device.type != "cpu":
        raise NotImplementedError(
            f"scaled_mm_general dims={dims} has no CUDA kernel yet "
            "(ROADMAP B1 scaled_mm / B2 scaled_mm_dims (0,0))"
        )
    return _plain(a, b, scale_a, scale_b, dims, out_dtype)


def scaled_mm_ref(a, b, scale_a, scale_b, *, out_dtype=torch.float32):
    """Pure-fp32 oracle: a [M, K] @ b [K, N] with each scale layout (scalar,
    row/col, or tile grid) expanded onto its operand before the matmul."""
    M, K = a.shape
    N = b.shape[1]

    def expand(s, rows, cols):
        s = s.float()
        if s.numel() == 1:
            return s.reshape(1, 1).expand(rows, cols)
        s = s.reshape(s.shape[0], -1)
        s = s.repeat_interleave(rows // s.shape[0], dim=0)
        return s.repeat_interleave(cols // s.shape[1], dim=1)

    out = (a.float() * expand(scale_a, M, K)) @ (b.float() * expand(scale_b, K, N))
    return out.to(out_dtype)
