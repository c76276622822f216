"""Scaled int8 matmul: kernels K2, B1 and B2, their plain versions, and the
fp32 oracle.

Counterparts in the JAX package:

- ``ops/pallas_mm.py::scaled_mm_dims`` (:192) with dims (1, 1), which K2
  replaces (:func:`scaled_mm_rhs_t`, the forward x . w^T), and with dims
  (0, 0), which B2 replaces (:func:`scaled_mm_lhs_t`, the grad_weight
  g^T . x over the tokens);
- ``ops/pallas_mm.py::scaled_mm`` (:85), which B1 replaces
  (:func:`scaled_mm`, the grad_input g . w), in the row/col/scalar-scale
  mode of ``ops/scaled_mm.py::scaled_mm`` (:65-107);
- ``ops/scaled_mm.py::scaled_mm`` (:65-119) and ``scaled_mm_general``
  (:122), the scale-mode and contraction-dims dispatchers: tile scales go
  to B15 (``tile_scaled_mm.py``), fp8 row scales to ``fp8.py``;
- ``ops/scaled_mm.py::scaled_mm_ref`` (:221), the fp32 oracle.

The three kernels are layout instantiations of one CUDA source,
``csrc/scaled_mm.cu``; its header says what bounds them on the H100 and how
the design answers that. K2 above the decode sizes, B1 and B2 run on the
pipelined TMA + wgmma mainloop of ``csrc/sm90_gemm.cuh`` (:func:`sm90_route`,
:func:`rhs_mn_sm90_route` and :func:`lhs_t_sm90_route`, counted in the
``sm90_launches`` of ``scaled_mm_rhs_t``, ``scaled_mm`` and
``scaled_mm_lhs_t``), and K2 at the decode sizes on a split-K stream of the
weight (:func:`decode_route`, counted in ``decode_launches``); the MN-major
operands (B1's b, both of B2's) are
transposed on chip, by the mainloop's producer, into the K-major stage that
8-bit wgmma reads, and B1 and B2 have no wmma form left. No operand is
transposed in device memory.
"""

from __future__ import annotations

import torch

from . import _build
from .fp8 import FP8_TYPES, scaled_fp8_mm_general
from .tile_scaled_mm import tile_scaled_mm

_SCALE_DTYPES = (torch.bfloat16, torch.float32)
# K2 at M <= DECODE_M (a decode step's slots) is bound by the weight's bytes,
# not the tensor cores: it streams the weight (decode_route)
DECODE_M = 16
# the decode stream (csrc/scaled_mm.cu::decode_stream): 16 rows of the weight
# a CTA (kDecodeRows), K in steps of DECODE_BK bytes split over at most
# DECODE_MAX_SPLITS CTAs of a cluster (kDecodeBK, kDecodeMaxSplits); the grid
# it aims for, about four CTAs on each of the H100's 132 SMs; and the least
# weight it takes (bytes): below it the wmma tile measured faster
DECODE_ROWS = 16
DECODE_BK = 128
DECODE_MAX_SPLITS = 8
DECODE_CTAS = 512
DECODE_MIN_BYTES = 1 << 18


def sm90_route(M: int) -> bool:
    """Whether K2 at M rows of a takes the TMA + wgmma mainloop
    (``csrc/sm90_gemm.cuh``): training, ViT and prefill sizes do, decode
    steps of up to ``DECODE_M`` slots take :func:`decode_route`'s stream."""
    return M > DECODE_M


def decode_route(M: int, N: int, K: int, aligned: bool = True) -> int:
    """The CTAs a cluster of K2's split-K weight stream at a [M, K] . b
    [N, K]^T (``csrc/scaled_mm.cu::decode_stream``): ``splits`` CTAs share
    16 rows of b, each one run of K; or 0 for the wmma tile, K2's first
    design. The stream takes every decode size (1 <= M <= ``DECODE_M``)
    with K > 0 a multiple of 16 on 16-byte aligned operands (what TMA
    describes) and a weight of at least ``DECODE_MIN_BYTES``, at as many
    splits as bring the grid to ``DECODE_CTAS``, at most
    ``DECODE_MAX_SPLITS`` and K's 128-byte steps: Llama2-1B's q/o and down
    take 4, gate/up 2, k/v 8. On the H100 that was the fastest geometry of
    those timed, or within 0.1 us of it, at each of them (PERF.md)."""
    if not (aligned and 1 <= M <= DECODE_M and K > 0 and K % 16 == 0 and N * K >= DECODE_MIN_BYTES):
        return 0
    steps, tiles = -(-K // DECODE_BK), -(-N // DECODE_ROWS)
    return min(DECODE_MAX_SPLITS, steps, -(-DECODE_CTAS // tiles))


def rhs_mn_sm90_route(N: int, K: int) -> bool:
    """Whether B1 (a [M, K] . b [K, N]) can take the TMA + wgmma mainloop,
    where a lands by TMA as K2's does and the producer transposes each
    landed [128 k][128 n] tile of b into wgmma's K-major stage: where TMA
    can describe both operands, their rows of K and N bytes a multiple of 16
    and K > 0 (M, the tokens, may be ragged: TMA zero-fills the rows past
    it). Every grad_input of the Llama and ViT steps does (K out features, N
    in features), and so does every shape B1's wrapper takes: B1 has no
    other kernel (its wmma form ran 1,554.6 us at the Llama2-1B step's
    gate/up, ``chip_smoke.py``)."""
    return N % 16 == 0 and K % 16 == 0 and K > 0


def lhs_t_sm90_route(M: int, N: int, K: int) -> bool:
    """Whether B2 (a [K, M]^T . b [K, N]) can take the TMA + wgmma mainloop,
    whose producer transposes each landed [128 k][128 m] tile into wgmma's
    K-major stage: where TMA can describe both operands, their rows of M and
    N bytes a multiple of 16 and K > 0. Every grad_weight of the Llama and
    ViT steps does (out features M, in features N, K tokens), and so does
    every shape B2's wrapper takes: B2 has no other kernel (its wmma form
    ran 2.5-7.6x slower at the Llama2-1B step's shapes on the H100,
    ``ab_sm90_forms.py``)."""
    return M % 16 == 0 and N % 16 == 0 and K > 0


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


def scaled_mm_plain(a, b, scale_a, scale_b, *, out_dtype=torch.bfloat16):
    """Plain version of B1: a [M, K] . b [K, N] with the row x col epilogue."""
    return _plain(a, b, scale_a, scale_b, (1, 0), out_dtype)


def scaled_mm_lhs_t_plain(a, b, scale_a, scale_b, *, out_dtype=torch.bfloat16):
    """Plain version of B2: a [K, M]^T . b [K, N] with the row x col epilogue."""
    return _plain(a, b, scale_a, scale_b, (0, 0), out_dtype)


def _launch(what, a, b, scale_a, scale_b, dims, out_dtype, sm90=False, decode=0):
    """Check the operands of one form and launch its kernel on the current
    stream, on the sm90 mainloop where ``sm90``, on the decode stream at
    ``decode`` CTAs a cluster where given: K2's choice; B1 and B2 have
    no other kernel, and a shape off their route raises. Operands stay in
    their stored layouts: a K-major operand has the contraction axis last,
    an MN-major one first."""
    tensors = (a, b, scale_a, scale_b)
    if not all(t.is_cuda and t.device == a.device for t in tensors):
        raise ValueError(f"{what}: all operands must be on one CUDA device")
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"{what}: int8 operands only, got {a.dtype}, {b.dtype}")
    ca, cb = dims
    if a.ndim != 2 or b.ndim != 2 or a.shape[ca] != b.shape[cb]:
        raise ValueError(f"{what}: shapes {tuple(a.shape)}, {tuple(b.shape)} for dims {dims}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{what}: a and b must be contiguous")
    K, M, N = a.shape[ca], a.shape[1 - ca], b.shape[1 - cb]
    # 16-byte chunks along each operand's contiguous axis (csrc/scaled_mm.cu):
    # K where an operand is K-major; B2's K, the tokens, is no row length
    if a.shape[1] % 16 or b.shape[1] % 16 or a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError(f"{what}: needs each operand's row length a multiple of 16 (K % 16 == 0 where it "
                         f"is K-major) and 16-byte aligned operands (shapes {tuple(a.shape)}, {tuple(b.shape)})")
    if scale_a.dtype != scale_b.dtype or scale_a.dtype not in _SCALE_DTYPES:
        raise TypeError(f"{what}: scales {scale_a.dtype}, {scale_b.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what}: out_dtype {out_dtype}")
    if dims != (1, 1) and not sm90:
        raise ValueError(f"{what}: shapes {tuple(a.shape)}, {tuple(b.shape)}: the sm90 mainloop, its only kernel, "
                         "needs every row length a multiple of 16 and K > 0")
    sa = _as_vector(scale_a, M, "scale_a")
    sb = _as_vector(scale_b, N, "scale_b")
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    flags = (int(sa.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16))
    if decode:
        err = _build.library().qt_scaled_mm_decode(
            a.data_ptr(), b.data_ptr(), sa.data_ptr(), sb.data_ptr(), out.data_ptr(), M, N, K, *flags, decode,
            _build.stream(),
        )
    else:
        err = _build.library().qt_scaled_mm_s8(
            a.data_ptr(), b.data_ptr(), sa.data_ptr(), sb.data_ptr(), out.data_ptr(), M, N, K,
            int(ca == 1), int(cb == 1), *flags, int(sm90), _build.stream(),
        )
    _build.check(err, what)
    return out


def scaled_mm_rhs_t(a: torch.Tensor, b: torch.Tensor, scale_a: torch.Tensor,
                    scale_b: torch.Tensor, *, out_dtype=torch.bfloat16) -> torch.Tensor:
    """``out[M, N] = ((a[M, K] . b[N, K]^T) * scale_a[M]) * scale_b[N]``.

    a and b are int8 and K-major. The scales are per row of a and per row
    of b ([M, 1] / [1, N] / [M] / [N]) or scalars, bf16 or fp32 (the same
    for both). A CPU tensor takes :func:`scaled_mm_rhs_t_plain`; CUDA
    tensors launch K2 on the current stream, which needs K % 16 == 0 and
    16-byte aligned, contiguous operands; on the sm90 mainloop where
    :func:`sm90_route` says so (counted in ``sm90_launches`` as well), on
    the decode stream where :func:`decode_route` gives its geometry
    (counted in ``decode_launches``), else on the wmma tile."""
    if a.device.type == "cpu":
        return scaled_mm_rhs_t_plain(a, b, scale_a, scale_b, out_dtype=out_dtype)
    sm90 = sm90_route(a.shape[0])
    decode = 0 if sm90 else decode_route(a.shape[0], b.shape[0], a.shape[-1],
                                         a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0)
    out = _launch("scaled_mm_rhs_t", a, b, scale_a, scale_b, (1, 1), out_dtype, sm90, decode)
    scaled_mm_rhs_t.launches += 1
    scaled_mm_rhs_t.sm90_launches += sm90
    scaled_mm_rhs_t.decode_launches += bool(decode)
    return out


scaled_mm_rhs_t.launches = 0
scaled_mm_rhs_t.sm90_launches = 0
scaled_mm_rhs_t.decode_launches = 0


def scaled_mm(a: torch.Tensor, b: torch.Tensor, scale_a: torch.Tensor, scale_b: torch.Tensor,
              *, out_dtype=torch.bfloat16) -> torch.Tensor:
    """``out[M, N] = ((a[M, K] . b[K, N]) * scale_a) * scale_b``; the scale
    layout decides the mode (JAX ``ops/scaled_mm.py::scaled_mm``, :65-119):

    - row/col/scalar: scale_a [M, 1] or [M] or a scalar, scale_b [1, N] or
      [N] or a scalar. int8 operands: a CPU tensor takes
      :func:`scaled_mm_plain`; CUDA tensors launch B1 on the current stream,
      which needs K % 16 == 0, N % 16 == 0, K > 0 and 16-byte aligned,
      contiguous operands, on the sm90 mainloop, the only kernel B1 has
      (:func:`rhs_mn_sm90_route`; counted in ``sm90_launches`` as well).
      fp8 operands: plain torch on every device
      (``ops/fp8.py::scaled_fp8_mm_general``), as XLA ran them;
    - tile: scale_a [M / QM, K / QK] and scale_b [K / QK, N / QN], the
      two-accumulator loop of B15 (``ops/tile_scaled_mm.py``)."""
    M, N = a.shape[0], b.shape[1]
    row_col = (scale_a.numel() == 1 or tuple(scale_a.shape) in ((M, 1), (M,))) and (
        scale_b.numel() == 1 or tuple(scale_b.shape) in ((1, N), (N,)))
    if not row_col:
        return tile_scaled_mm(a, b, scale_a, scale_b, out_dtype=out_dtype)
    if a.dtype in FP8_TYPES:
        return scaled_fp8_mm_general(a, b, scale_a, scale_b, dims=(1, 0), out_dtype=out_dtype)
    if a.device.type == "cpu":
        return scaled_mm_plain(a, b, scale_a, scale_b, out_dtype=out_dtype)
    sm90 = rhs_mn_sm90_route(b.shape[1], a.shape[1])
    out = _launch("scaled_mm", a, b, scale_a, scale_b, (1, 0), out_dtype, sm90)
    scaled_mm.launches += 1
    scaled_mm.sm90_launches += sm90
    return out


scaled_mm.launches = 0
scaled_mm.sm90_launches = 0


def scaled_mm_lhs_t(a: torch.Tensor, b: torch.Tensor, scale_a: torch.Tensor,
                    scale_b: torch.Tensor, *, out_dtype=torch.bfloat16) -> torch.Tensor:
    """``out[M, N] = ((a[K, M]^T . b[K, N]) * scale_a[M]) * scale_b[N]``:
    both operands contracted over their first axis, as stored. A CPU tensor
    takes :func:`scaled_mm_lhs_t_plain`; CUDA tensors launch B2 on the
    current stream, which needs M % 16 == 0, N % 16 == 0, K > 0 (any K: TMA
    zero-fills the token rows past it) and 16-byte aligned, contiguous
    operands, on the sm90 mainloop, the
    only kernel B2 has (:func:`lhs_t_sm90_route`; counted in
    ``sm90_launches`` as well)."""
    if a.device.type == "cpu":
        return scaled_mm_lhs_t_plain(a, b, scale_a, scale_b, out_dtype=out_dtype)
    sm90 = lhs_t_sm90_route(a.shape[1], b.shape[1], a.shape[0])
    out = _launch("scaled_mm_lhs_t", a, b, scale_a, scale_b, (0, 0), out_dtype, sm90)
    scaled_mm_lhs_t.launches += 1
    scaled_mm_lhs_t.sm90_launches += sm90
    return out


scaled_mm_lhs_t.launches = 0
scaled_mm_lhs_t.sm90_launches = 0

_BY_DIMS = {(1, 1): scaled_mm_rhs_t, (1, 0): scaled_mm, (0, 0): scaled_mm_lhs_t}


def scaled_mm_general(a, b, scale_a, scale_b, *, dims=(1, 0), out_dtype=torch.bfloat16):
    """Row/col-scaled matmul with explicit contraction dims: a over dims[0],
    b over dims[1]; scale_a per out-row, scale_b per out-col (scalars
    broadcast). Every operand stays in its stored layout: for int8 dims
    (1, 1) is K2, (1, 0) B1 and (0, 0) B2; fp8 operands take the plain
    fp32 product (``ops/fp8.py``), as the JAX package's XLA dot did."""
    dims = tuple(dims)
    if dims not in _BY_DIMS:
        raise ValueError(f"scaled_mm_general: dims {dims}")
    if a.dtype in FP8_TYPES:
        return scaled_fp8_mm_general(a, b, scale_a, scale_b, dims=dims, out_dtype=out_dtype)
    return _BY_DIMS[dims](a, b, scale_a, scale_b, out_dtype=out_dtype)


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
