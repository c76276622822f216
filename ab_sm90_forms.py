"""A/B of the sm90 mainloop's rewriting forms on one CUDA card: B1 (the int8
grad_input GEMM, ``S8MnB``), B2 (the int8 grad_weight GEMM, ``S8MnMajor``),
B15 (the tile-scaled GEMM: e4m3 ``E4m3F16``, int8 ``S8MnB`` with the fold),
B16 (the packed-int4 GEMM, ``S4KMajor``) and B17's int8 form (``S8MnB``
with the int32 epilogue, ``B17s8``) of
``quantized_training_tpu_torch/ops/csrc/sm90_gemm.cuh``; B5, the
both-axes int8 quantize of ``ops/csrc/int8_quant.cu`` (``B5``, its SR form
``B5sr``) and B4, the column int8 quantize, on thread-block clusters
(``B4``, ``B4sr``); and B7, B8, B9's row form, B10 and B11 of
``ops/csrc/fused_producers.cu`` on the persistent row walk (``B7``,
``B7sr``: RMSNorm inside the row quantize with the column absmax; ``B8``,
``B8sr``: RMSNorm inside the column quantize given the column scales;
``B9``, ``B9sr``: silu(a) * b inside the row quantize with the column
absmax; ``B10``: the RMSNorm backward, dx and dgamma; ``B11``, ``B11sr``:
the silu backward inside the row quantizes of (da, db) with their column
absmax), B9's column form and B12 given the column scales (``B9c``,
``B9csr``: silu(a) * b inside the column quantize; ``B12c``, ``B12csr``:
the silu backward inside the column quantizes of (da, db)) and B18's eight
forms (``B18lnr``, ``B18lnrsr``: LayerNorm inside
the row quantize with the column absmax; ``B18lnc``, ``B18lncsr``:
LayerNorm inside the column quantize given the column scales; ``B18gr``,
``B18grsr``, ``B18gc``, ``B18gcsr``: tanh-GELU, the same two), and B14 of ``ops/csrc/rope.cu`` on
the persistent row walk (``B14a``: the absmax of the grouped attention
output's ungrouped view, rows and columns; ``B14r``, ``B14rsr``, ``B14c``,
``B14csr``: its int8 quantize given the row or the column scales, RN and SR;
each in the step's [B, S, H, hd] memory and in [B, H, S, hd] memory)
beside B13 (``B13``: q's rotate-half RoPE and head grouping, which shares
its source); and B19, the causal int8 flash-attention forward of
``ops/csrc/int8_attention.cu`` on its sm90 design (``B19``: TMA, a producer
warpgroup, wgmma for both products; at Llama2-1B's attention, [16, 8, 2048,
hd] q, hd 64 and 128, block_kv 512); and the serving decode step's two
kernels: K1, the row int8 quantize of ``ops/csrc/int8_quant.cu`` on the
persistent row walk (``K1``, its SR form ``K1sr``), and K2 at decode sizes
on the split-K weight stream of ``ops/csrc/scaled_mm.cu`` (``K2d``: M 8 and
16 at Llama2-1B's four linear shapes); against an earlier tree's.

Each variant is this tree's ``ops/csrc`` with a few text edits
(``VARIANTS``), or with ``--parent DIR`` the sources of another checkout (an
earlier commit, for its wmma kernels), built with nvcc into a library of its
own under ``build/ab_sm90_forms/`` (only the sources the chosen kernels
need), all builds side by side. Every variant
is held against the plain versions at a ragged shape and at gate/up's
(B17's int8 form at 4096^3, B5 at its step shapes; bit-exact; B7, B8 and
B18's LayerNorm forms against this tree's first design (``kept/first``),
whose bits the walk keeps, B10's dx too and its dgamma within 2e-5 of its
largest magnitude, B4, B9 (both forms), B11, B12, B13, B14 and B18's
GELU forms against their plain versions; B19 within ``ops/int8_attention.py::agreement`` of
its plain version (the row sums of p in another order); B15's e4m3 form within ``fold_bound``'s QK + n_qk fp32
roundings, its worst error printed in those roundings; ``diag_`` variants
break the kernel or its tolerance on purpose, to time what a part of it
costs or to measure an error: they report and do not fail), then all are
timed in turns (in order, then reversed; ``utils/timing.py``: a CUDA graph
over L2-cold copies, CUDA events) at the Llama2-1B step's shapes, beside
the nearest library call on the same operands (``torch._int_mm``, unpacked
for B16; ``torch._scaled_mm`` with row scales for B15's e4m3 form; SDPA
in bf16 on the unquantized q, k, v for B19, a reference; none for B4, B5,
B7-B14, B18) and the share of the bound (the 8-bit tensor cores' 1,979
TOP/s; for B5 one read of x and two int8 writes at 3.35 TB/s, for B4 one
read and one write, for B7-B14 and B18 their inputs read and outputs written
once; for B19 the causal triangle's exponentials at 16 a clock an SM, as
``chip_smoke.py`` counts them). ``kept/first`` is this tree's B4, B7-B12,
B14, B18, B19 and K1 on their first design (route 0), and K2d on its wmma
tile (``decode_route`` 0); ``kept/wmma`` is this
tree's B16 and B17-s8 on their wmma kernels (``sm90`` = 0); ``parent/wmma``
the other checkout's B1, B2, B15, B16 and B17-s8 on theirs,
``parent/kernel`` its B5 and B13, ``parent/wmma`` its B19 (where it has
no sm90 design), and ``parent/walk``, ``parent/cluster`` its B4,
B7-B12, B14 and B18, whatever design they take there; K2, which no variant changes, is timed on this
tree's and the other checkout's mainloop, so that a change to the shared
mainloop shows on it.

``--sass NAME`` only builds and prints the SASS instruction count of each
variant's kernels whose name holds NAME (K1's SR walk against its RN walk:
``--kernels K1 --variants kept --sass quantize_rows_walk``).

Usage: python3 ab_sm90_forms.py [--parent DIR] [--variants kept,b2_3+3,...] [--kernels B1,B15,B5,B7,B8,B10,...]
       [--sass NAME]
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import re
import shutil
import subprocess
import time
from functools import partial
from pathlib import Path

import torch

from quantized_training_tpu_torch import ops
from quantized_training_tpu_torch.ops import _build, random
from quantized_training_tpu_torch.ops import fused_producers as FP
from quantized_training_tpu_torch.ops import int8_attention as ATTN
from quantized_training_tpu_torch.ops import int8_quant as IQ
from quantized_training_tpu_torch.ops import rope as ROPE
SM = importlib.import_module("quantized_training_tpu_torch.ops.scaled_mm")
from quantized_training_tpu_torch.ops.int8_quant import EPS
from quantized_training_tpu_torch.ops.tile_scaled_mm import fold_bound
from quantized_training_tpu_torch.utils.timing import copies, time_ms

OUT = Path(__file__).resolve().parent / "build" / "ab_sm90_forms"
INT8_OPS_PER_S = 1.979e15
HBM_BYTES_PER_S = 3.35e12
B5_KEY = 2**62 + 7  # the SR form's key
ROWS_KEY = 2**61 + 5  # the row walks' SR key (B7, B8, B9, B11)
SFU_PER_SM_CLOCK = 16  # exponentials a clock an SM (chip_smoke.py's)
_B2_DEPTH = "  static constexpr int BK = 128, kStages = 4, kRawSlots = 2, kAccShift = 0;"
_B16_DEPTH = "  static constexpr int kStages = kSub == 1 ? 4 : 3, kRawSlots = kSub == 1 ? 8 : 4;"
# widen a nibble by sign extension into the low half of its byte (kAccShift 0)
_SIGN_EXTEND = [
    ("return w & 0xF0F0F0F0u;", "return ((((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u) + 0x78787878u) ^ 0x80808080u;"),
    ("return (w << 4) & 0xF0F0F0F0u;", "return (((w & 0x0F0F0F0Fu) ^ 0x08080808u) + 0x78787878u) ^ 0x80808080u;"),
    ("  static constexpr int BK = kBK, kAccShift = 8;", "  static constexpr int BK = kBK, kAccShift = 0;"),
]
_B16_LOOP = "    for (int it = 0; it < BK / 32; ++it) {"
_BK128 = ("using S4KMajor = S4KMajorT<256>;", "using S4KMajor = S4KMajorT<128>;")
_MNB_DEPTH = "  static constexpr int BK = 128, kStages = 4, kRawSlots = 4, kAccShift = 0;"
_F16_DEPTH = "  static constexpr int BK = 64, kStages = 5, kRawSlots = 3, kAccShift = 0;"
# B15's e4m3 form on e4m3 wgmma (S8MnB's bytes, fp32 accumulators) in place
# of the fp16 widening
_E4M3_WGMMA = [
    ("// The bf16 MMA's fp16 twin, b MN-major: B15's e4m3 operands widened on chip.",
     """__device__ __forceinline__ void wgmma_e4m3(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\\n .reg .pred p;\\n setp.ne.b32 p, %66, 0;\\n"
      " wgmma.mma_async.sync.aligned.m64n128k32.f32.e4m3.e4m3 " QT_D64 ", %64, %65, p, 1, 1;\\n}"
      : QT_ACC64("+f")
      : "l"(da), "l"(db), "r"(1));
}
// The bf16 MMA's fp16 twin, b MN-major: B15's e4m3 operands widened on chip."""),
    ("// One K step's MMAs of a consumer warpgroup on stage s",
     "struct E4m3MnB : S8MnB {\n  using Acc = float;\n};\n\n// One K step's MMAs of a consumer warpgroup on stage s"),
    ("""    if constexpr (std::is_same_v<Form, E4m3F16>) {""",
     """    if constexpr (std::is_same_v<Form, E4m3MnB>) {
      wgmma_e4m3(d, da, db);
    } else if constexpr (std::is_same_v<Form, E4m3F16>) {"""),
    ("tile_scaled_mm.cu", "launch_sm90<qt_sm90::E4m3F16>", "launch_sm90<qt_sm90::E4m3MnB>"),
]
# B15's fold waiting for each quant block's own MMAs (wgmma_wait<0>; the
# other consumer warpgroup's MMAs keep the tensor cores busy meanwhile), one
# partial set, in place of the kept fold under the next block's MMAs
_FOLD_KEPT_START = "    typename Form::Acc part0[64], part1[64];\n    float acc[64];\n"
_FOLD_WAIT = """    typename Form::Acc part[64];
    float acc[64];
    const int rl = wg * 64 + (warp % 4) * 16 + lane / 4, cl = 128 + 2 * (lane % 4);  // this thread's scales
    for (int i = 0; i < tiles; ++i) {
      const int g0 = i * nk;
#pragma unroll
      for (int j = 0; j < 64; ++j) part[j] = 0, acc[j] = 0.0f;
      bool held = false;  // step g - 1's stage is not yet released
      for (int kt = 0; kt < nk; ++kt) {
        const int g = g0 + kt, s = g % S;
        mbar_wait(full0 + 8 * s, (g / S) & 1);
        fence_operands(part);
        wgmma_fence();
        stage_mma<Form>(part, ring + s * kStage + wg * 64 * kRowBytes, ring + s * kStage + kTileBytes);
        wgmma_commit();
        fence_operands(part);
        const bool fold = (kt + 1) % epi.kq == 0;
        if (fold) {
          wgmma_wait<0>();
        } else {
          wgmma_wait<1>();  // step g - 1's MMAs are done
        }
        fence_operands(part);
        if (held && lane == 0) mbar_arrive(empty0 + 8 * ((g - 1) % S));
        held = !fold;
        if (fold) {
          fold_block(acc, part, scales[s], rl, cl);
          __syncwarp();  // every lane has read the stage's scales
          if (lane == 0) mbar_arrive(empty0 + 8 * s);
        }
      }
      store_tile<0>(epi, acc, walk.origin(i), wg, M, N);
    }
  } else {
"""
# B1 with the roles swapped, out^T = b^T . a^T: a [M, K] lands by TMA as
# wgmma's B operand (K-major, as K2's b) and b [K, N] lands raw with the
# 128-byte swizzle in the same stage; no producer rewrite. The consumers
# build wgmma's register-A fragments of b^T: each 4 x 4 byte block (4 k rows
# x 4 n) is loaded one k row a lane by the 4 lanes that need its columns and
# transposed across them with two shuffles; the epilogue writes the
# transposed tile (2-byte stores, 16 contiguous bytes per 4 lanes).
_B1_SWAP_KERNEL = """
// column i = (lane / 4) % 4 of the 4 x 4 byte block whose row i this lane holds
__device__ __forceinline__ uint32_t xpose_lanes(uint32_t w, int i) {
  uint32_t p = __shfl_xor_sync(0xffffffffu, w, 8);
  w = __byte_perm(w, p, (i & 2) ? 0x3276 : 0x5410);
  p = __shfl_xor_sync(0xffffffffu, w, 4);
  return __byte_perm(w, p, (i & 1) ? 0x3715 : 0x6240);
}

template <typename ST, typename OT>
__global__ void __launch_bounds__(kThreads, 1)
b1_swap_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb, const ScaledOut<ST, OT> epi,
               int M, int N, const TileWalk walk) {
  constexpr int S = 5, kStage = kStageBytes;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[S], empty_bar[S];
  uint8_t* ring_ptr = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t ring = smem_u32(ring_ptr), full0 = smem_u32(full_bar), empty0 = smem_u32(empty_bar);
  const int wg = threadIdx.x / 128, nk = walk.nk;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) mbar_init(full0 + 8 * s, 1), mbar_init(empty0 + 8 * s, kConsumerWarps);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (wg == 2) {  // tile origin (x, y) = (n0, m0): a's tile is the stage's first half, b's raw tile the second
    if (threadIdx.x == 256) {
      const int steps = walk.count() * nk;
      StepCursor load(walk);
      for (int g = 0; g < steps; ++g, load.next()) {
        const int s = g % S, use = g / S;
        if (use > 0) mbar_wait(empty0 + 8 * s, (use - 1) & 1);
        mbar_expect_tx(full0 + 8 * s, kStageBytes);
        tma_load(ring + s * kStage, &ta, load.kt * 128, load.o.y, full0 + 8 * s);
        tma_load(ring + s * kStage + kTileBytes, &tb, load.o.x, load.kt * 128, full0 + 8 * s);
      }
    }
    return;
  }
  int d[64];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, tiles = walk.count();
  const int q = lane & 3, j = lane >> 2, i4 = j & 3, nb = wg * 64 + (warp % 4) * 16 + 4 * (j >> 2);
  for (int it = 0; it < tiles; ++it) {
    const int2 o = walk.origin(it);
    const int g0 = it * nk;
#pragma unroll
    for (int x = 0; x < 64; ++x) d[x] = 0;
    uint32_t a0[4][4], a1[4][4];
    const auto step = [&](int kt, uint32_t (&a)[4][4]) {
      const int g = g0 + kt, s = g % S;
      mbar_wait(full0 + 8 * s, (g / S) & 1);
      const uint8_t* raw = ring_ptr + s * kStage + kTileBytes;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {  // a[kk][r]: n + 8 (r & 1), k + 16 (r >> 1)
          const int k = 32 * kk + 16 * (r >> 1) + 4 * q + i4, n = nb + 8 * (r & 1);
          const uint32_t w = *reinterpret_cast<const uint32_t*>(raw + k * 128 + (((n >> 4) ^ (k & 7)) << 4) + (n & 15));
          a[kk][r] = xpose_lanes(w, i4);
        }
      const uint32_t sb = ring + s * kStage;
      fence_operands(d);
      fence_operands(a);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma(d, a[kk], smem_desc(sb + 32 * kk, 16, 1024));
      wgmma_commit();
      fence_operands(d);
      wgmma_wait<1>();
      if (kt > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((g - 1) % S));
    };
    for (int kt = 0; kt < nk; kt += 2) {
      step(kt, a0);
      if (kt + 1 < nk) step(kt + 1, a1);
    }
    wgmma_wait<0>();
    fence_operands(d);
    fence_operands(a0);
    fence_operands(a1);
    if (lane == 0) mbar_arrive(empty0 + 8 * ((g0 + nk - 1) % S));
    const int n0 = o.x + wg * 64 + (warp % 4) * 16 + j, m0 = o.y + 2 * q;
#pragma unroll
    for (int x = 0; x < 16; ++x)
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // d[4 x + e]: n0 + 8 (e / 2), m0 + 8 x + e % 2
        const int n = n0 + 8 * (e >> 1), m = m0 + 8 * x + (e & 1);
        if (n < N && m < M) {
          const auto rw = epi.row(m, N);
          store1(rw.p + n, epi.value(rw, n, d[4 * x + e]));
        }
      }
  }
}

template <typename ST, typename OT>
cudaError_t b1_swap(const void* a, const void* b, const void* sa, const void* sb, void* out, int M, int N, int K,
                    cudaStream_t stream) {
  CUtensorMap ta, tb;
  cudaError_t err = encode_2d(&ta, CU_TENSOR_MAP_DATA_TYPE_UINT8, a, K, M, K, 128, 128);
  if (err == cudaSuccess) err = encode_2d(&tb, CU_TENSOR_MAP_DATA_TYPE_UINT8, b, N, K, N, 128, 128);
  if (err != cudaSuccess) return err;
  const ScaledOut<ST, OT> epi{static_cast<const ST*>(sa), static_cast<const ST*>(sb), static_cast<OT*>(out)};
  auto kernel = b1_swap_kernel<ST, OT>;
  constexpr int smem = 5 * kStageBytes + 1024;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int tiles_m = (M + kBN - 1) / kBN;
  const TileWalk walk{tiles_m, ((N + kBM - 1) / kBM) * tiles_m, (K + 127) / 128};
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  kernel<<<walk.tiles < sms ? walk.tiles : sms, kThreads, smem, stream>>>(ta, tb, epi, M, N, walk);
  return cudaGetLastError();
}

}  // namespace qt_sm90"""
_B1_SWAP = [
    ("}  // namespace qt_sm90", _B1_SWAP_KERNEL),
    ("scaled_mm.cu", "    err = launch_sm90<qt_sm90::S8MnB>(a, b, sa, sb, out, M, N, K, scale_bf16, out_bf16, s);",
     """    using BF = __nv_bfloat16;
    err = scale_bf16 ? (out_bf16 ? qt_sm90::b1_swap<BF, BF>(a, b, sa, sb, out, M, N, K, s)
                                 : qt_sm90::b1_swap<BF, float>(a, b, sa, sb, out, M, N, K, s))
                     : (out_bf16 ? qt_sm90::b1_swap<float, BF>(a, b, sa, sb, out, M, N, K, s)
                                 : qt_sm90::b1_swap<float, float>(a, b, sa, sb, out, M, N, K, s));"""),
]
_B5_ROWS_LAUNCH = """  rows<<<R, kThreads, g.row_smem, stream>>>(x, static_cast<int8_t*>(q_row), static_cast<T*>(s_row), parts, M, K,
                                            eps, key_row);
"""
_B5_COLS_LAUNCH = """  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(cols), dim3(g.col_ctas), dim3(kThreads), args,
                                     g.col_smem, stream);
"""
_B5_LD_POLICY = """// a 16-byte load with the L2 eviction policy evict_last
__device__ __forceinline__ uint4 ld_evict_last(const uint4* p) {
  uint4 r;
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(pol));
  asm volatile("ld.global.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w) : "l"(p), "l"(pol));
  return r;
}

// The row steps of both passes"""
_B5_EVICT_LAST = [("int8_quant.cu", "// The row steps of both passes", _B5_LD_POLICY),
                  ("int8_quant.cu", "(kLast ? __ldcs(src) : *src)", "(kLast ? __ldcs(src) : ld_evict_last(src))")]
# B9's row form at one CTA an SM (its launch bounds), its RN form's column
# maxima in registers
_B9_ONE_CTA = ("fused_producers.cu", "return V == 1 || SR ? 1 : kSiluCtasPerSm;", "return 1;")
_B9_REG_MAX = [("fused_producers.cu", "constexpr bool kShared = COLMAX && !SR,", "constexpr bool kShared = false,"),
               ("fused_producers.cu", "                      : !SR       ? static_cast<size_t>(cta / tpr * K)",
                "                      : false     ? static_cast<size_t>(cta / tpr * K)")]
# B12's inverse column scales in shared memory [2K] (da's, then db's,
# element j of vector v at j nv + v), filled by the CTA, in place of each
# thread's in registers; and its launch bounds at two CTAs an SM
_B12_SMEM = [
    ("fused_producers.cu", """  float inv_a[V][N], inv_b[V][N];
#pragma unroll
  for (int p = 0; p < V; ++p)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      inv_a[p][j] = inv_scale(scale_a[walk.vec(p) * N + j], eps);
      inv_b[p][j] = inv_scale(scale_b[walk.vec(p) * N + j], eps);
    }
""", """  extern __shared__ float sinv[];
  for (int64_t i = threadIdx.x; i < nv; i += blockDim.x)
    for (int j = 0; j < N; ++j) {
      sinv[j * nv + i] = inv_scale(scale_a[i * N + j], eps);
      sinv[K + j * nv + i] = inv_scale(scale_b[i * N + j], eps);
    }
  __syncthreads();
"""),
    ("fused_producers.cu", """      cast_pack<SR, N>(da, inv_a[p], off, key, qa + off);
      cast_pack<SR, N>(db, inv_b[p], M * K + off, key, qb + off);""",
     """      const int64_t v = walk.vec(p);
      cast_pack_by<SR, N>(da, [&](int j) { return sinv[j * nv + v]; }, off, key, qa + off);
      cast_pack_by<SR, N>(db, [&](int j) { return sinv[K + j * nv + v]; }, M * K + off, key, qb + off);"""),
    ("fused_producers.cu", """  kernel<<<static_cast<unsigned int>(ctas), tpr > kThreads ? tpr : kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const T*>(dy),""",
     """  const size_t smem = static_cast<size_t>(2 * K) * sizeof(float);
  if (allow_smem(kernel, smem) != cudaSuccess) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned int>(ctas), tpr > kThreads ? tpr : kThreads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const T*>(dy),""")]
_B12_TWO_CTAS = ("fused_producers.cu", "__launch_bounds__(V == 1 ? kSiluRowsMaxCta : kSiluRowsMaxCta2)\nsilu_bwd_cols(",
                 "__launch_bounds__(V == 1 ? kSiluRowsMaxCta : kSiluRowsMaxCta2, V == 2 ? 2 : 1)\nsilu_bwd_cols(")
# B7's launch of its kernel and its fold (reduce_parts)
_B7_FOLD = """g, static_cast<int8_t*>(q), static_cast<float*>(s_row), pt, M, K, norm_eps, eps,
        key);
    if ((err = cudaGetLastError()) != cudaSuccess || !COLMAX) return err;
    return launch_reduce(true, pt, static_cast<float*>(amax), ctas, K, stream);"""
# the elementwise walks (B9-row, B18's GELU) at three vectors a thread on
# CTAs of 256 threads
_ELEMENTWISE_V3 = [
    ("fused_producers.cu", "cta <= kSiluRowsMaxCta2)))\n    return 0;",
     "cta <= kSiluRowsMaxCta2) || (V == 3 && cta <= kThreads)))\n    return 0;"),
    ("fused_producers.cu", "V == 1 ? elementwise_rows<Op, T, SR, COLMAX, 1> : elementwise_rows<Op, T, SR, COLMAX, 2>;",
     "V == 1 ? elementwise_rows<Op, T, SR, COLMAX, 1>\n                            : V == 3 ? elementwise_rows<Op, T, SR, COLMAX, 3>\n"
     "                                     : elementwise_rows<Op, T, SR, COLMAX, 2>;"),
    ("fused_producers.cu", "V == 1 ? elementwise_cols<Op, T, SR, 1> : elementwise_cols<Op, T, SR, 2>;",
     "V == 1 ? elementwise_cols<Op, T, SR, 1> : V == 3 ? elementwise_cols<Op, T, SR, 3> : elementwise_cols<Op, T, SR, 2>;"),
    *(("fused_producers.cu", f"kSiluRowsMaxCta2, silu_rows_ctas<SR, V>())\n{k}(",
       f"V == 3 ? kThreads : kSiluRowsMaxCta2, silu_rows_ctas<SR, V>())\n{k}(") for k in ("elementwise_rows", "elementwise_cols"))]
# B14 at three CTAs an SM (its launch bounds and grid)
_B14_THREE_CTA = ("rope.cu", "constexpr int kUngroupCtasPerSm = 2;", "constexpr int kUngroupCtasPerSm = 3;")
# (old text, new text) edits of sm90_gemm.cuh, or (file, old text, new text)
# of another source, each of which must match once; "fold_wait" replaces
# the fold loop from _FOLD_KEPT_START to the end of its branch
VARIANTS = {
    "kept": [],
    "b2_3+3": [(_B2_DEPTH, _B2_DEPTH.replace("kStages = 4, kRawSlots = 2", "kStages = 3, kRawSlots = 3"))],
    "b2_2+4": [(_B2_DEPTH, _B2_DEPTH.replace("kStages = 4, kRawSlots = 2", "kStages = 2, kRawSlots = 4"))],
    "b16_2+5": [(_B16_DEPTH, _B16_DEPTH.replace("kSub == 1 ? 4 : 3, kRawSlots = kSub == 1 ? 8 : 4",
                                                "kSub == 1 ? 4 : 2, kRawSlots = kSub == 1 ? 8 : 5"))],
    # 128 values of K a stage (twice the K steps, 64-byte TMA rows), 4 + 8 or 6 + 8 deep
    "b16_bk128": [_BK128],
    "b16_bk128_6+8": [_BK128, (_B16_DEPTH, _B16_DEPTH.replace("kSub == 1 ? 4 : 3", "kSub == 1 ? 6 : 3"))],
    "b16_sign_extend": _SIGN_EXTEND,
    # a CTA a tile instead of one CTA an SM walking its tiles (every form)
    "one_tile": [("  const int ctas = walk.tiles < sms ? walk.tiles : sms;", "  const int ctas = walk.tiles;")],
    # b's widening skipped: the mainloop's time without its rewrite
    "diag_b16_no_rewrite": [(_B16_LOOP, _B16_LOOP + "\n      if (t >= 0) continue;")],
    # no fence between the producer's stores and the consumers' wgmma reads
    "diag_no_fence": [("    fence_proxy_async();\n    mbar_arrive(full0 + 8 * s);", "    mbar_arrive(full0 + 8 * s);")],
    # B1's and B15-s8's depths (stages + raw slots; 5 + 4 and 6 + 2 leave no
    # room for B15's scales), then B15 e4m3's
    "mnb_5+3": [(_MNB_DEPTH, _MNB_DEPTH.replace("kStages = 4, kRawSlots = 4", "kStages = 5, kRawSlots = 3"))],
    "mnb_6+1": [(_MNB_DEPTH, _MNB_DEPTH.replace("kStages = 4, kRawSlots = 4", "kStages = 6, kRawSlots = 1"))],
    "f16_6+1": [(_F16_DEPTH, _F16_DEPTH.replace("kStages = 5, kRawSlots = 3", "kStages = 6, kRawSlots = 1"))],
    "f16_4+4": [(_F16_DEPTH, _F16_DEPTH.replace("kStages = 5, kRawSlots = 3", "kStages = 4, kRawSlots = 4"))],
    "fold_wait": "fold_wait",
    # B15's e4m3 form on e4m3 wgmma: its error against the fold bound
    "diag_b15_e4m3_wgmma": _E4M3_WGMMA,
    # B1 with the roles swapped: a's fragments of b^T in the consumers, no rewrite
    "b1_swap": _B1_SWAP,
    # B5's column pass walking the rows in the row pass's order, not the reverse
    "b5_forward": [("int8_quant.cu", "return kReverse ? steps - 1 - i : i;", "return i;")],
    # B5's row steps loaded after the body has run on the last one, not before
    "b5_load_after": [("int8_quant.cu", """      if (j < steps) load<kReverse>(xv, at(j), M, nv, b);
      body(at(i), a);""", """      body(at(i), a);
      if (j < steps) load<kReverse>(xv, at(j), M, nv, b);"""), ("int8_quant.cu", """      if (i < steps) load<kReverse>(xv, at(i), M, nv, a);
      body(at(j), b);""", """      body(at(j), b);
      if (i < steps) load<kReverse>(xv, at(i), M, nv, a);""")],
    # B5 with plain loads and stores in place of the evict-first ones
    "b5_no_cs": [("int8_quant.cu", "    __stcs(reinterpret_cast<uint2*>(q), ", "    *reinterpret_cast<uint2*>(q) = ("),
                 ("int8_quant.cu", "    __stcs(reinterpret_cast<unsigned int*>(q), ", "    *reinterpret_cast<unsigned int*>(q) = ("),
                 ("int8_quant.cu", "(kLast ? __ldcs(src) : *src)", "*src")],
    # B5's parts: the row pass alone, the column pass alone (on whatever the
    # front of q_col holds)
    "diag_b5_rows_only": [("int8_quant.cu", _B5_COLS_LAUNCH, "  return cudaSuccess;\n")],
    "diag_b5_cols_only": [("int8_quant.cu", _B5_ROWS_LAUNCH, "")],
    # B5's row pass loading x with an L2 evict-last policy, so that the column
    # pass finds it there
    "b5_evict_last": _B5_EVICT_LAST,
    # B5's column pass storing x's first 8 bytes a vector in place of the cast
    # (bf16 only): its loop's memory traffic alone; and with no grid barrier
    "diag_b5_cols_copy": [("int8_quant.cu", """        cast_vec<T, SR>(u[g][p], [&](int j) { return dy[j]; }, row * K + v * N, key, q + row * K + v * N);""",
                           """        __stcs(reinterpret_cast<uint2*>(q + row * K + v * N), make_uint2(u[g][p].x, u[g][p].y));""")],
    "diag_b5_no_grid_sync": [("int8_quant.cu", "  if constexpr (MODE == kWhole) cooperative_groups::this_grid().sync();\n",
                              "")],
    # the column pass at 3 CTAs an SM (at most 85 registers a thread)
    "b5_cols_ctas3": [("int8_quant.cu", """template <typename T, bool SR, int TPR, int G, int MODE>
__global__ void __launch_bounds__(kThreads, kBothCtasPerSm)
quantize_both_col_pass(""", """template <typename T, bool SR, int TPR, int G, int MODE>
__global__ void __launch_bounds__(kThreads, 3)
quantize_both_col_pass("""), ("int8_quant.cu", "std::min<int64_t>(needed, kBothCtasPerSm * sms));",
                                                           "std::min<int64_t>(needed, 3 * sms));")],
    # B7 and B11: the casts by rintf and the float -> int conversion (quant<SR>)
    # in place of one add; B11's sigmoid by __frcp_rn in place of IEEE
    # division (B9's and B12's too in that library); B7 with 8 vectors a thread (32 threads a row at K = 2048, one
    # CTA an SM) or 2 (128) in place of 4; without the fold of the CTAs' column maxima
    # (reduce_parts); with the casts' values replaced by the inputs' bits
    # (the walk, the producer and the row reductions, without the casts);
    # without the SR forms' Philox calls
    "rows_rintf": [("row_common.cuh", "      c[j] = SR ? byte_sr(r, words[j]) : byte_rn(r);",
                    "      c[j] = static_cast<uint8_t>(quant<SR>(y[4 * k + j], inv, words[j]));")],
    "b11_rcp": [("fused_producers.cu", "return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-a))); }",
                 "return __frcp_rn(__fadd_rn(1.0f, expf(-a))); }")],
    "b7_v8": [("fused_producers.cu", "constexpr int kNormV = 4;", "constexpr int kNormV = 8;"),
              ("fused_producers.cu", "__launch_bounds__(kThreads, 2)\nrmsnorm_rows(", "__launch_bounds__(kThreads, 1)\nrmsnorm_rows(")],
    "b7_v2": [("fused_producers.cu", "constexpr int kNormV = 4;", "constexpr int kNormV = 2;")],
    "diag_rows_no_fold": [("fused_producers.cu", _B7_FOLD, _B7_FOLD.replace(
                               "return launch_reduce(true, pt, static_cast<float*>(amax), ctas, K, stream);",
                               "return cudaSuccess;")),
                          ("fused_producers.cu", "  return launch_reduce(true, pt, static_cast<float*>(amax), ctas, 2 * K, stream);",
                           "  return cudaSuccess;")],
    "diag_rows_no_cast": [("row_common.cuh", "      c[j] = SR ? byte_sr(r, words[j]) : byte_rn(r);",
                           "      c[j] = __float_as_uint(y[4 * k + j]);")],
    # the SR forms' words from the element index in place of Philox
    "diag_rows_no_philox": [("row_common.cuh",
                             "    const uint4 w = SR ? qt::philox_block((idx0 >> 2) + k, key) : make_uint4(0u, 0u, 0u, 0u);",
                             "    const uint4 w = make_uint4(static_cast<uint32_t>(idx0) + k, 0u, 0u, 0u);")],
    # the same kernels on other launch arguments (ROUTE_ARGS): B7 at one CTA
    # an SM; B11 at one vector a thread (704 threads a row at K = 5632); B7
    # and B11 without their column maxima
    "b7_one_cta": [],
    "b11_v1": [],
    "diag_rows_no_amax": [],
    # B9's row form at one CTA an SM (no register cap from the launch
    # bounds) in place of two; at one vector a thread (704 threads a row);
    # without its fold (reduce_parts)
    "b9_one_cta": [_B9_ONE_CTA],
    # its RN form's column maxima in registers (two CTAs an SM, 80
    # registers), not in shared memory
    "b9_reg_max": _B9_REG_MAX,
    "b9_v1": [],
    # B9's SR columns at two vectors a thread (352 threads a row at K =
    # 5632, B9-row's) in place of one (704)
    "b9c_sr_v2": [],
    # B12 given scales at B11's two vectors a thread (352 threads a row at
    # K = 5632) in place of one (704); there with its inverse column scales
    # in shared memory [2K] in place of registers, at two CTAs an SM (80
    # registers a thread) and at one
    "b12_v2": [],
    "b12_smem": _B12_SMEM + [_B12_TWO_CTAS],
    "b12_smem_one_cta": _B12_SMEM,
    # B8 and B10 at one CTA an SM (no register cap from the launch bounds);
    # B10 with four vectors of x and dy a thread (64 threads a row at K =
    # 2048) in place of two (128)
    "b8_one_cta": [("fused_producers.cu", "__launch_bounds__(kThreads, 2)\nrmsnorm_cols(",
                    "__launch_bounds__(kThreads, 1)\nrmsnorm_cols(")],
    "b10_one_cta": [("fused_producers.cu", "__launch_bounds__(kThreads, 2)\nrmsnorm_bwd_walk(",
                     "__launch_bounds__(kThreads, 1)\nrmsnorm_bwd_walk(")],
    "b10_v4": [("fused_producers.cu", "constexpr int kNormBwdV = 2;", "constexpr int kNormBwdV = 4;")],
    "diag_b9_no_fold": [("fused_producers.cu", ": launch_reduce(true, pt, static_cast<float*>(amax), ctas, K, stream);",
                         ": cudaSuccess;")],
    # B18's LayerNorm walks at 32 threads a row of six vectors (bf16 K 1536;
    # 96 x 2 would break the chains' order: 96 does not divide 256) and at
    # one CTA an SM; B18's GELU walks at 256 threads a row of three vectors
    # (bf16 K 6144) and at one CTA an SM (B9-row's with them)
    "ln_v6": [("fused_producers.cu", "constexpr int kLayerNormVs[] = {4, 3};", "constexpr int kLayerNormVs[] = {6, 3};")],
    "ln_one_cta": [("fused_producers.cu", "constexpr int kLayerNormCtasPerSm = 2;", "constexpr int kLayerNormCtasPerSm = 1;")],
    "gelu_v3": _ELEMENTWISE_V3,
    "gelu_one_cta": [_B9_ONE_CTA],
    # the GELU rows' RN form with its column maxima in registers (B9-row's
    # b9_reg_max), at two and at three vectors a thread; without them
    # (diag: the maxima's and their fold's cost)
    "gelu_reg_max": _B9_REG_MAX,
    "gelu_v3_reg_max": _ELEMENTWISE_V3 + _B9_REG_MAX,
    "diag_gelu_no_amax": [],
    # B14's walks at 128 threads of two vectors and 256 of one a row (bf16
    # K 2048) in place of 64 of four; at one CTA an SM, and at three (its
    # launch bounds' register cap 85)
    "b14_v2": [],
    "b14_v1": [],
    "b14_one_cta": [],
    "b14_three_cta": [_B14_THREE_CTA],
    # B14's column form computing its inverse scales before the walk's
    # first loads, not after them
    "b14_cols_eager": [("rope.cu", "inv[p][j] = scale[walk.vec(p) * N + j];",
                        "inv[p][j] = inv_scale(scale[walk.vec(p) * N + j], eps);"),
                       ("rope.cu", "  bool inverted = false;", "  bool inverted = true;")],
    # B14's absmax without the fold of the CTAs' column maxima (reduce_parts)
    "diag_b14_no_fold": [("rope.cu", "    return launch_reduce(true, pt, static_cast<float*>(cmax), ctas, K, stream);\n  });",
                          "    return cudaSuccess;\n  });")],
    # B4's cluster form at each strip width (16, 8, 4 vectors) at every
    # shape; its loads and the cluster's merge without the cast
    **{f"b4_{sv}": [] for sv in (16, 8, 4)},
    "diag_b4_no_cast": [("int8_quant.cu", "    for (int64_t r = first; r < r1; r += step)\n      cast_vec<T, SR>(",
                         "    for (int64_t r = first; r < r1 && sv < 0; r += step)\n      cast_vec<T, SR>(")],
    # B19: the consumers at 232 registers and the producer at 40, or 216 and
    # 72 (kConsumerRegs, kProducerRegs); a warpgroup's two chunks of a block
    # side by side (2 w, 2 w + 1) in place of interleaved (w, w + 2); half
    # the k ring at hd 64 (4 stages); the accurate expf replaced by the
    # approximate __expf (diag: the exponentials' instruction cost; other
    # bits)
    "b19_regs_232": [("int8_attention.cu", "constexpr int kConsumerRegs = 224, kProducerRegs = 56;",
                      "constexpr int kConsumerRegs = 232, kProducerRegs = 40;")],
    "b19_regs_216": [("int8_attention.cu", "constexpr int kConsumerRegs = 224, kProducerRegs = 56;",
                      "constexpr int kConsumerRegs = 216, kProducerRegs = 72;")],
    "b19_split_side": [("int8_attention.cu", "const bool two = n > 2, real0 = w < n, real1 = w + 2 < n;",
                        "const bool two = n > 1, real0 = 2 * w < n, real1 = 2 * w + 1 < n;"),
                       ("int8_attention.cu", "const int g0 = g + min(w, n - 1), g1 = g + min(w + 2, n - 1);",
                        "const int g0 = g + min(2 * w, n - 1), g1 = g + min(2 * w + 1, n - 1);"),
                       ("int8_attention.cu", "        if (real1) scale(s1, g1, w + 2, mx);",
                        "        if (real1) scale(s1, g1, 2 * w + 1, mx);"),
                       ("int8_attention.cu", "        scale(s0, g0, w, mx);\n        wgmma_wait<0>();",
                        "        if (real0) scale(s0, g0, 2 * w, mx);\n        wgmma_wait<0>();"),
                       ("int8_attention.cu", "        if (real0) scale(s0, g0, w, mx);\n      }",
                        "        if (real0) scale(s0, g0, 2 * w, mx);\n      }")],
    "b19_k4": [("int8_attention.cu", "kKStages = HD == 64 ? 8 : 4,", "kKStages = 4,")],
    # K2's decode stream with a deeper ring
    "k2d_stages8": [("scaled_mm.cu", "constexpr int kDecodeStages = 4;", "constexpr int kDecodeStages = 8;")],
    # K2's decode stream without its MMAs, or without the cluster's sums
    # (diag: the stream alone; the reduction's cost)
    "diag_k2d_no_mma": [("scaled_mm.cu", "      for (int c = 0; c < kDecodeBK / 32; ++c) {",
                         "      for (int c = 0; c < kDecodeBK / 32 && kb < 0; ++c) {")],
    "diag_k2d_no_sum": [("scaled_mm.cu", "        if (k < splits) v[k] = cluster.map_shared_rank(part, k)[row * kCols + m];",
                         "        v[k] = part[row * kCols + m];")],
    # K1's walk at one CTA an SM, its SR form on the walk where the route
    # keeps the first design; K2's decode stream at other splits (launch
    # arguments, ROUTE_ARGS)
    "k1_one_cta": [],
    "k1_sr_walk_all": [],
    **{f"k2d_x{n}": [] for n in (1, 2, 3, 4, 8)},
    "diag_b19_fast_exp": [("int8_attention.cu", "const float p = expf(__fsub_rn(", "const float p = __expf(__fsub_rn(")],
    # B19's exponentials and their subtraction left out (diag: their time,
    # the results wrong)
    "diag_b19_no_p": [("int8_attention.cu", "const float p = expf(__fsub_rn(__int_as_float(d[4 * j + e]), mn[h]));",
                       "const float p = __int_as_float(d[4 * j + e]);")],
    # the transposers not rewriting the v stages (diag: whether the
    # producer's rewrite holds the consumers up)
    "diag_b19_no_rewrite": [("int8_attention.cu", "        for (int u = t; u < HD; u += kTransposers)",
                             "        for (int u = t; u < HD && g < 0; u += kTransposers)")],
    # the column pass's (d, 1 / d) with a vector's pairs side by side
    "b5_dy_by_vector": [("int8_quant.cu", "    col_dy[(c % N) * nv + c / N] = denom_of(s", "    col_dy[c] = denom_of(s"),
                        ("int8_quant.cu", "        for (int j = 0; j < N; ++j) dy[j] = col_dy[j * nv + v];",
                         "        for (int j = 0; j < N; ++j) dy[j] = col_dy[v * N + j];")],
}
# (M, N, K): B2 at every grad_weight of the Llama2-1B step (out, in, 8,192
# tokens) and of ViT-Giant's (6,400 padded tokens); B16 at the forward,
# grad_input and grad_weight shapes of gate/up and down
B2_SHAPES = [(2048, 2048, 8192), (256, 2048, 8192), (5632, 2048, 8192), (2048, 5632, 8192),
             (4608, 1536, 6400), (1536, 1536, 6400), (6144, 1536, 6400), (1536, 6144, 6400)]
B16_SHAPES = [(8192, 5632, 2048), (8192, 2048, 5632), (5632, 2048, 8192), (2048, 5632, 8192)]
# K2 at gate/up and q/o, against the parent's: the mainloop the forms share
K2_SHAPES = [(8192, 5632, 2048), (8192, 2048, 2048)]
# K2 at decode sizes: a decode step of 8 and of 16 slots at Llama2-1B's q/o,
# k/v, gate/up and down
K2D_SHAPES = [(M, N, K) for M in (8, 16) for N, K in ((2048, 2048), (256, 2048), (5632, 2048), (2048, 5632))]
# K1 at the Llama2-1B weights, a decode step's activation rows and the
# train step's activations
K1_SHAPES = [(2048, 2048), (256, 2048), (5632, 2048), (2048, 5632), (8, 2048), (8, 5632), (8192, 2048), (8192, 5632),
             (512, 2048), (4096, 5632)]


# B14's five forms: the absmax, the quantize given row or column scales, RN and SR
B14 = ("B14a", "B14r", "B14rsr", "B14c", "B14csr")
# launch arguments of B4, B7, B9, B11, B18 and B14 by variant (KERNELS'
# keyword arguments)
ROUTE_ARGS = {"b7_v8": {"B7": {"tpr": 32, "ctas_per_sm": 1}, "B7sr": {"tpr": 32, "ctas_per_sm": 1}},
              "b7_v2": {"B7": {"tpr": 128}, "B7sr": {"tpr": 128}},
              "b7_one_cta": {"B7": {"ctas_per_sm": 1}, "B7sr": {"ctas_per_sm": 1}},
              "b11_v1": {"B11": {"tpr": 704}, "B11sr": {"tpr": 704}},
              "diag_rows_no_amax": {k: {"amax": 0} for k in ("B7", "B7sr", "B11", "B11sr", "B9", "B9sr")},
              "b9_one_cta": {"B9": {"ctas_per_sm": 1}, "B9c": {"ctas_per_sm": 1}},
              "b9_v1": {k: {"tpr": 704, "ctas_per_sm": 1} for k in ("B9", "B9sr", "B9c")},
              "b12_v2": {k: {"tpr": 352} for k in ("B12c", "B12csr")},
              "b12_smem": {k: {"tpr": 352, "ctas_per_sm": 2} for k in ("B12c", "B12csr")},
              "b12_smem_one_cta": {k: {"tpr": 352} for k in ("B12c", "B12csr")},
              "b9c_sr_v2": {"B9csr": {"tpr": 352}},
              "b8_one_cta": {"B8": {"ctas_per_sm": 1}, "B8sr": {"ctas_per_sm": 1}},
              "b10_one_cta": {"B10": {"ctas_per_sm": 1}},
              "b10_v4": {"B10": {"tpr": 64}},
              "ln_v6": {k: {"tpr": 32} for k in ("B18lnr", "B18lnrsr", "B18lnc", "B18lncsr")},
              "ln_one_cta": {k: {"ctas_per_sm": 1} for k in ("B18lnr", "B18lnrsr", "B18lnc", "B18lncsr")},
              "gelu_v3": {k: {"tpr": 256} for k in ("B18gr", "B18grsr", "B18gc", "B18gcsr")},
              "gelu_one_cta": {k: {"ctas_per_sm": 1} for k in ("B18gr", "B18grsr", "B18gc", "B18gcsr")},
              "gelu_v3_reg_max": {k: {"tpr": 256} for k in ("B18gr", "B18grsr", "B18gc", "B18gcsr")},
              "diag_gelu_no_amax": {k: {"amax": 0} for k in ("B18gr", "B18grsr")},
              **{f"b4_{sv}": {k: {"geometry": (sv, 8)} for k in ("B4", "B4sr")} for sv in (16, 8, 4)},
              "b14_v2": {k: {"tpr": 128} for k in B14}, "b14_v1": {k: {"tpr": 256} for k in B14},
              "b14_one_cta": {k: {"ctas_per_sm": 1} for k in B14},
              "b14_three_cta": {k: {"ctas_per_sm": 3} for k in B14},
              "k1_one_cta": {k: {"ctas_per_sm": 1} for k in ("K1", "K1sr")},
              "k1_sr_walk_all": {"K1sr": {"walk_all": True}},
              **{f"k2d_x{n}": {"K2d": {"route": n}} for n in (1, 2, 3, 4, 8)}}


def sources(name: str, edits, parent: Path | None) -> Path:
    """A copy of the kernel sources for one variant."""
    d = OUT / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(parent / "quantized_training_tpu_torch/ops/csrc" if parent else _build.CSRC, d)
    if edits == "fold_wait":
        text = (d / "sm90_gemm.cuh").read_text()
        start = text.index(_FOLD_KEPT_START)
        end = text.index("\n  } else {\n", start) + len("\n  } else {\n")
        (d / "sm90_gemm.cuh").write_text(text[:start] + _FOLD_WAIT + text[end:])
        return d
    for edit in edits:
        fname, old, new = edit if len(edit) == 3 else ("sm90_gemm.cuh", *edit)
        text = (d / fname).read_text()
        if text.count(old) != 1:
            raise SystemExit(f"ab_sm90_forms: variant {name}: the edit {old[:60]!r} does not match once")
        (d / fname).write_text(text.replace(old, new))
    return d


# the source of each kernel's C entry
SOURCE = {"B1": "scaled_mm.cu", "B2": "scaled_mm.cu", "K2": "scaled_mm.cu", "K2d": "scaled_mm.cu", "B16": "scaled_mm.cu",
          "K1": "int8_quant.cu", "K1sr": "int8_quant.cu",
          "B15": "tile_scaled_mm.cu", "B15s8": "tile_scaled_mm.cu", "B17s8": "matmul.cu", "B5": "int8_quant.cu",
          "B5sr": "int8_quant.cu", "B4": "int8_quant.cu", "B4sr": "int8_quant.cu", "B7": "fused_producers.cu",
          "B7sr": "fused_producers.cu", "B9": "fused_producers.cu", "B9sr": "fused_producers.cu",
          **dict.fromkeys(("B9c", "B9csr", "B12c", "B12csr"), "fused_producers.cu"),
          "B11": "fused_producers.cu", "B11sr": "fused_producers.cu", "B8": "fused_producers.cu",
          "B8sr": "fused_producers.cu", "B10": "fused_producers.cu",
          **{k: "fused_producers.cu" for k in ("B18lnr", "B18lnrsr", "B18lnc", "B18lncsr", "B18gr", "B18grsr", "B18gc",
                                                "B18gcsr")}, **dict.fromkeys(("B13", "B14a", "B14r", "B14rsr", "B14c", "B14csr"), "rope.cu"),
          "B19": "int8_attention.cu"}
ENTRIES = {"scaled_mm.cu": ("qt_scaled_mm_s8", "qt_scaled_int4_mm", "qt_scaled_mm_decode"),
           "tile_scaled_mm.cu": ("qt_tile_scaled_mm",), "matmul.cu": ("qt_matmul",),
           "int8_quant.cu": ("qt_quantize_int8_both", "qt_quantize_int8_colwise", "qt_quantize_int8_rowwise"),
           "fused_producers.cu": ("qt_rmsnorm_quant_rowwise", "qt_silu_mul_bwd_quant_rowwise",
                                  "qt_silu_mul_quant_rowwise", "qt_rmsnorm_quant_colwise", "qt_rmsnorm_bwd",
                                  "qt_layernorm_quant_rowwise", "qt_layernorm_quant_colwise", "qt_gelu_quant_rowwise",
                                  "qt_gelu_quant_colwise", "qt_silu_mul_quant_colwise",
                                  "qt_silu_mul_bwd_quant_colwise"),
           "rope.cu": ("qt_rope_relayout", "qt_ungroup_amax", "qt_ungroup_quant"),
           "int8_attention.cu": ("qt_int8_flash_fwd",)}


def build(variants: dict, parent: Path | None, kernels) -> dict:
    """name -> (library, its signatures): the sources of ``kernels`` of each
    variant, compiled side by side."""
    files = sorted({SOURCE[k] for k in kernels})
    procs = {}
    for name, edits in variants.items():
        if not edits and name not in ("kept", "parent"):
            continue  # launch arguments only: the kept library
        d = sources(name, edits, parent if name == "parent" else None)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"), *(str(d / f) for f in files)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), d)
    libs = {}
    for name, (proc, d) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"ab_sm90_forms: {name} did not build:\n{log[-4000:]}")
        sigs = _build._SIGNATURES
        if name == "parent":  # that checkout's entry signatures
            spec = importlib.util.spec_from_file_location(
                "parent_build", parent / "quantized_training_tpu_torch/ops/_build.py")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            sigs = mod._SIGNATURES
        lib = ctypes.CDLL(str(d / "lib.so"))
        for fn in (e for f in files for e in ENTRIES[f] if e in sigs):  # an earlier tree may lack an entry
            getattr(lib, fn).argtypes = sigs[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = (lib, sigs)
    for name in variants:
        if name not in libs:
            libs[name] = libs["kept"]
    return libs


def b2(lib, sigs, sm90):
    """B2 on ``lib``'s route ``sm90``: a [K, M], b [K, N] -> bf16."""
    def call(a, b, sa, sb):
        (K, M), N = a.shape, b.shape[1]
        out = torch.empty(M, N, dtype=torch.bfloat16, device="cuda")
        _build.check(lib.qt_scaled_mm_s8(a.data_ptr(), b.data_ptr(), sa.data_ptr(), sb.data_ptr(), out.data_ptr(),
                                         M, N, K, 0, 0, 1, 1, sm90, _build.stream()), "B2")
        return out
    return call


def b1(lib, sigs, sm90):
    """B1 on ``lib``'s route ``sm90``: a [M, K], b [K, N] -> bf16."""
    def call(a, b, sa, sb):
        (M, K), N = a.shape, b.shape[1]
        out = torch.empty(M, N, dtype=torch.bfloat16, device="cuda")
        _build.check(lib.qt_scaled_mm_s8(a.data_ptr(), b.data_ptr(), sa.data_ptr(), sb.data_ptr(), out.data_ptr(),
                                         M, N, K, 1, 0, 1, 1, sm90, _build.stream()), "B1")
        return out
    return call


def b15(lib, sigs, sm90):
    """B15 on ``lib``'s route ``sm90`` (an entry without the argument has the
    wmma kernel only): a [M, K], b [K, N] e4m3 or int8, bf16 tile scales ->
    bf16."""
    route = (sm90,) if len(sigs["qt_tile_scaled_mm"]) == 16 else ()

    def call(a, b, sa, sb):
        (M, K), N = a.shape, b.shape[1]
        out = torch.empty(M, N, dtype=torch.bfloat16, device="cuda")
        _build.check(lib.qt_tile_scaled_mm(a.data_ptr(), b.data_ptr(), sa.data_ptr(), sb.data_ptr(), out.data_ptr(),
                                           M, N, K, M // sa.shape[0], K // sa.shape[1], N // sb.shape[1],
                                           int(a.dtype == torch.float8_e4m3fn), 1, 1, *route, _build.stream()),
                     "B15")
        return out
    return call


def k2(lib, sigs, sm90):
    """K2 on ``lib``'s route ``sm90``: a [M, K], b [N, K] -> bf16."""
    def call(a, b, sa, sb):
        (M, K), N = a.shape, b.shape[0]
        out = torch.empty(M, N, dtype=torch.bfloat16, device="cuda")
        _build.check(lib.qt_scaled_mm_s8(a.data_ptr(), b.data_ptr(), sa.data_ptr(), sb.data_ptr(), out.data_ptr(),
                                         M, N, K, 1, 1, 1, 1, sm90, _build.stream()), "K2")
        return out
    return call


def k2d(lib, sigs, _, route=None):
    """K2 at decode sizes of ``lib``: a [M, K], b [N, K] int8, bf16 scales ->
    bf16; on the split-K weight stream at the route's CTAs a cluster
    (``route``: this many instead, where K has as many steps; 0: the wmma
    tile), or on the wmma tile where that tree has no stream."""
    def call(a, b, sa, sb):
        (M, K), N = a.shape, b.shape[0]
        g = SM.decode_route(M, N, K) if route is None else min(route, -(-K // SM.DECODE_BK))
        out = torch.empty(M, N, dtype=torch.bfloat16, device="cuda")
        if g and "qt_scaled_mm_decode" in sigs:
            err = lib.qt_scaled_mm_decode(a.data_ptr(), b.data_ptr(), sa.data_ptr(), sb.data_ptr(), out.data_ptr(),
                                          M, N, K, 1, 1, g, _build.stream())
        else:
            err = lib.qt_scaled_mm_s8(a.data_ptr(), b.data_ptr(), sa.data_ptr(), sb.data_ptr(), out.data_ptr(), M,
                                      N, K, 1, 1, 1, 1, 0, _build.stream())
        _build.check(err, f"K2d at {M} x {N} x {K}, {g} CTAs a cluster")
        return out
    return call


def k1(lib, sigs, sr, tpr=None, ctas_per_sm=IQ.ROWWISE_CTAS_PER_SM, walk_all=False):
    """K1 of ``lib`` (``sr`` = 1: its SR form from ``B5_KEY``): x [M, K]
    bf16 -> (q, scale [M, 1]); on the walk at ``tpr`` threads a row
    (default: the route's, with ``walk_all`` the RN form's layout wherever
    one tiles the row; 0: the first design), or the first design where that
    tree's entry takes no route."""
    def call(x):
        M, K = x.shape
        t = IQ.rowwise_sm90_route(M, K, x.dtype, bool(sr) and not walk_all) if tpr is None else tpr
        args = ()
        if len(sigs["qt_quantize_int8_rowwise"]) == 12:
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            args = (t, IQ.row_walk_ctas(M, t, sms, ctas_per_sm) if t else 0)
        q = torch.empty(M, K, dtype=torch.int8, device="cuda")
        scale = torch.empty(M, 1, dtype=x.dtype, device="cuda")
        _build.check(lib.qt_quantize_int8_rowwise(x.data_ptr(), q.data_ptr(), scale.data_ptr(), M, K, EPS, 1, sr,
                                                  B5_KEY if sr else 0, *args, _build.stream()), "K1")
        return q, scale
    return call


def b17s8(lib, sigs, sm90):
    """B17's int8 form on ``lib``'s route ``sm90`` (an entry that refuses
    int8 on it has the wmma kernel only): a [M, K], b [K, N] -> int32."""
    def call(a, b):
        (M, K), N = a.shape, b.shape[1]
        out = torch.empty(M, N, dtype=torch.int32, device="cuda")
        _build.check(lib.qt_matmul(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K, 0, 0, 1, 1, sm90,
                                   _build.stream()), "B17s8")
        return out
    return call


def b19(lib, sigs, _, sm90=1):
    """B19 of ``lib``: (q_i8, q_s, k_i8, k_s, v_i8, v_s) of [n_inst, G, S,
    hd] q -> (out, lse), causal, block_kv 512, on its sm90 design (``sm90``
    1: one CTA an SM over the work items) or its first (0); an entry without
    the grid argument has the first design only."""
    routed = len(sigs["qt_int8_flash_fwd"]) == 16

    def call(q, qs, k, ks, v, vs):
        n_inst, G, S, hd = q.shape
        out = torch.empty(q.shape, dtype=torch.bfloat16, device="cuda")
        lse = torch.empty(n_inst, G, S, 1, dtype=torch.float32, device="cuda")
        ctas = min(n_inst * G * S // 64, torch.cuda.get_device_properties(0).multi_processor_count) if sm90 else 0
        _build.check(lib.qt_int8_flash_fwd(q.data_ptr(), qs.data_ptr(), k.data_ptr(), ks.data_ptr(), v.data_ptr(),
                                           vs.data_ptr(), out.data_ptr(), lse.data_ptr(), n_inst, G, S, hd, 512, 1,
                                           *((ctas,) if routed else ()), _build.stream()), "B19")
        return out, lse
    return call


def b5(lib, sigs, sr):
    """B5 (``sr`` = 1: its SR form, from the two keys ``B5_KEY`` splits
    into) of ``lib``: x [M, K] bf16 -> (q_row, s_row, q_col, s_col)."""
    key_row, key_col = random.split(B5_KEY) if sr else (0, 0)

    def call(x):
        M, K = x.shape
        q_row = torch.empty(M, K, dtype=torch.int8, device="cuda")
        q_col = torch.empty(M, K, dtype=torch.int8, device="cuda")
        s_row = torch.empty(M, 1, dtype=x.dtype, device="cuda")
        s_col = torch.empty(1, K, dtype=x.dtype, device="cuda")
        amax = torch.empty(K, dtype=torch.float32, device="cuda")
        _build.check(lib.qt_quantize_int8_both(x.data_ptr(), q_row.data_ptr(), s_row.data_ptr(), q_col.data_ptr(),
                                               s_col.data_ptr(), amax.data_ptr(), M, K, EPS, 1, sr, key_row, key_col,
                                               _build.stream()), "B5")
        return q_row, s_row, q_col, s_col
    return call


def _route(sigs, fn, tpr, M, ctas_per_sm):
    """The route arguments of ``fn`` (none where that tree's entry takes
    none) and the rows of its parts scratch: the walk's grid at ``tpr``
    threads a row, or the first design's blocks at tpr 0."""
    if len(sigs[fn]) == len(_build._SIGNATURES[fn]) - 2 or not tpr:
        route = () if len(sigs[fn]) < len(_build._SIGNATURES[fn]) else (0, 0)
        return route, -(-M // FP._rows_per_block(M))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return (tpr, FP.row_walk_ctas(M, tpr, sms, ctas_per_sm)), FP.row_walk_ctas(M, tpr, sms, ctas_per_sm)


def b7(lib, sigs, sr, tpr=None, ctas_per_sm=FP.NORM_CTAS_PER_SM, amax=1):
    """B7 of ``lib`` (``sr`` = 1: its SR form from ``ROWS_KEY``): x [M, K]
    bf16, g [K] fp32 -> (q, s_row, column absmax); on the walk at ``tpr`` threads
    a row (default: the route's; 0 the first design)."""
    def call(x, g):
        M, K = x.shape
        t = FP.norm_rows_sm90_route(K, x.dtype) if tpr is None else tpr
        route, rows = _route(sigs, "qt_rmsnorm_quant_rowwise", t, M, ctas_per_sm)
        q = torch.empty(M, K, dtype=torch.int8, device="cuda")
        s_row = torch.empty(M, 1, dtype=torch.float32, device="cuda")
        col = torch.empty(1, K, dtype=torch.float32, device="cuda")
        parts = torch.empty(rows, K, dtype=torch.float32, device="cuda")
        _build.check(lib.qt_rmsnorm_quant_rowwise(x.data_ptr(), g.data_ptr(), q.data_ptr(), s_row.data_ptr(),
                                                  col.data_ptr(), parts.data_ptr(), M, K, FP._rows_per_block(M), 1e-5,
                                                  FP.EPS, 1, sr, amax, ROWS_KEY if sr else 0, *route,
                                                  _build.stream()), "B7")
        return (q, s_row, col) if amax else (q, s_row)
    return call


def b8(lib, sigs, sr, tpr=None, ctas_per_sm=FP.NORM_CTAS_PER_SM):
    """B8 given scales of ``lib`` (``sr`` = 1: its SR form from
    ``ROWS_KEY``): x [M, K] bf16, g [K] fp32, the column scales [1, K] fp32
    -> (q,); on the walk at ``tpr`` threads a row (default: the route's; 0
    the first design)."""
    def call(x, g, scale):
        M, K = x.shape
        t = FP.norm_cols_sm90_route(K, x.dtype) if tpr is None else tpr
        route, _ = _route(sigs, "qt_rmsnorm_quant_colwise", t, M, ctas_per_sm)
        q = torch.empty(M, K, dtype=torch.int8, device="cuda")
        _build.check(lib.qt_rmsnorm_quant_colwise(x.data_ptr(), g.data_ptr(), scale.data_ptr(), q.data_ptr(), None,
                                                  None, None, M, K, FP._rows_per_block(M), 1e-5, FP.EPS, 1, sr,
                                                  ROWS_KEY if sr else 0, *route, _build.stream()), "B8")
        return (q,)
    return call


def b10(lib, sigs, _, tpr=None, ctas_per_sm=FP.NORM_CTAS_PER_SM):
    """B10 of ``lib``: x, dy [M, K] bf16, g [K] fp32 -> (dx, dgamma); on the
    walk at ``tpr`` threads a row (default: the route's; 0 the first
    design)."""
    def call(x, g, dy):
        M, K = x.shape
        t = FP.rmsnorm_bwd_sm90_route(K, x.dtype) if tpr is None else tpr
        route, rows = _route(sigs, "qt_rmsnorm_bwd", t, M, ctas_per_sm)
        dx = torch.empty_like(x)
        dg = torch.empty(K, dtype=torch.float32, device="cuda")
        parts = torch.empty(rows, K, dtype=torch.float32, device="cuda")
        _build.check(lib.qt_rmsnorm_bwd(x.data_ptr(), g.data_ptr(), dy.data_ptr(), dx.data_ptr(), dg.data_ptr(),
                                        parts.data_ptr(), M, K, FP._rows_per_block(M), 1e-5, 1, *route,
                                        _build.stream()), "B10")
        return dx, dg
    return call


def b9(lib, sigs, sr, tpr=None, ctas_per_sm=None, amax=1):
    """B9's row form of ``lib`` (``sr`` = 1: its SR form from ``ROWS_KEY``):
    a, b [M, K] bf16 -> (q, s_row, column absmax); on the walk at ``tpr``
    threads a row (default: the route's; 0 the first design) and
    ``ctas_per_sm`` CTAs an SM (default: the wrapper's for the form)."""
    def call(a, b):
        M, K = a.shape
        t = FP.silu_rows_sm90_route(K, a.dtype) if tpr is None else tpr
        per_sm = ctas_per_sm or FP.silu_rows_ctas_per_sm(K, a.dtype, sr)
        route, rows = _route(sigs, "qt_silu_mul_quant_rowwise", t, M, per_sm)
        q = torch.empty(M, K, dtype=torch.int8, device="cuda")
        s_row = torch.empty(M, 1, dtype=torch.float32, device="cuda")
        col = torch.empty(1, K, dtype=torch.float32, device="cuda")
        parts = torch.empty(rows, K, dtype=torch.float32, device="cuda")
        _build.check(lib.qt_silu_mul_quant_rowwise(a.data_ptr(), b.data_ptr(), q.data_ptr(), s_row.data_ptr(),
                                                   col.data_ptr(), parts.data_ptr(), M, K, FP._rows_per_block(M),
                                                   FP.EPS, 1, sr, amax, ROWS_KEY if sr else 0, *route,
                                                   _build.stream()), "B9")
        return (q, s_row, col) if amax else (q, s_row)
    return call


def b9c(lib, sigs, sr, tpr=None, ctas_per_sm=None):
    """B9's column form given scales of ``lib`` (``sr`` = 1: its SR form
    from ``ROWS_KEY``): a, b [M, K] bf16, the column scales [1, K] fp32 ->
    (q,); on the walk at ``tpr`` threads a row (default: the route's; 0 the
    first design) and ``ctas_per_sm`` CTAs an SM (default: the wrapper's for
    the form)."""
    def call(a, b, scale):
        M, K = a.shape
        t = FP.silu_cols_sm90_route(K, a.dtype, sr) if tpr is None else tpr
        per_sm = ctas_per_sm or FP._elementwise_ctas_per_sm(t, K, a.dtype, sr)
        route, _ = _route(sigs, "qt_silu_mul_quant_colwise", t, M, per_sm)
        q = torch.empty(M, K, dtype=torch.int8, device="cuda")
        _build.check(lib.qt_silu_mul_quant_colwise(a.data_ptr(), b.data_ptr(), scale.data_ptr(), q.data_ptr(), None,
                                                   None, None, M, K, FP._rows_per_block(M), FP.EPS, 1, sr,
                                                   ROWS_KEY if sr else 0, *route, _build.stream()), "B9 columns")
        return (q,)
    return call


def b12c(lib, sigs, sr, tpr=None, ctas_per_sm=FP.SILU_CTAS_PER_SM):
    """B12 given scales of ``lib`` (``sr`` = 1: its SR form from
    ``ROWS_KEY``): a, b, dy [M, K] bf16, da's and db's column scales [1, K]
    fp32 -> (qa, qb); on the walk at ``tpr`` threads a row (default: the
    route's; 0 the first design) and ``ctas_per_sm`` CTAs an SM."""
    def call(a, b, dy, da_scale, db_scale):
        M, K = a.shape
        t = FP.silu_bwd_cols_sm90_route(K, a.dtype) if tpr is None else tpr
        route, _ = _route(sigs, "qt_silu_mul_bwd_quant_colwise", t, M, ctas_per_sm)
        qa, qb = (torch.empty(M, K, dtype=torch.int8, device="cuda") for _ in range(2))
        _build.check(lib.qt_silu_mul_bwd_quant_colwise(
            a.data_ptr(), b.data_ptr(), dy.data_ptr(), da_scale.data_ptr(), db_scale.data_ptr(), qa.data_ptr(),
            qb.data_ptr(), M, K, FP._rows_per_block(M), FP.EPS, 1, sr, ROWS_KEY if sr else 0, *route,
            _build.stream()), "B12")
        return qa, qb
    return call


def b4(lib, sigs, sr, route=None, geometry=None):
    """B4 of ``lib`` (``sr`` = 1: its SR form from ``B5_KEY``): x [R, C]
    bf16 -> (q, scale [1, C]); on the cluster form at the route's geometry
    (``geometry``: this (strip vectors, cluster CTAs) instead, where
    its tile fits; ``route`` 0: the first design), or the first design where
    that tree's entry takes no route."""
    def call(x):
        R, C = x.shape
        g = IQ.colwise_sm90_route(R, C, x.dtype) if route is None else route
        if g and geometry and -(-R // geometry[1]) * geometry[0] * 16 <= IQ._CLUSTER_MAX_TILE:
            g = geometry
        args = (*(g or (0, 0)),) if len(sigs["qt_quantize_int8_colwise"]) == 13 else ()
        q = torch.empty(R, C, dtype=torch.int8, device="cuda")
        scale = torch.empty(1, C, dtype=x.dtype, device="cuda")
        amax = torch.empty(C, dtype=torch.float32, device="cuda")
        _build.check(lib.qt_quantize_int8_colwise(x.data_ptr(), q.data_ptr(), scale.data_ptr(), amax.data_ptr(), R, C,
                                                  EPS, 1, sr, B5_KEY if sr else 0, *args, _build.stream()), "B4")
        return q, scale
    return call


def b11(lib, sigs, sr, tpr=None, ctas_per_sm=FP.SILU_CTAS_PER_SM, amax=1):
    """B11 of ``lib`` (``sr`` = 1: its SR form from ``ROWS_KEY``): a, b, dy
    [M, K] bf16 -> (da_q, da_s, db_q, db_s, column absmax of da and db); on
    the walk at ``tpr`` threads a row (default: the route's)."""
    def call(a, b, dy):
        M, K = a.shape
        t = FP.silu_bwd_rows_sm90_route(K, a.dtype) if tpr is None else tpr
        route, rows = _route(sigs, "qt_silu_mul_bwd_quant_rowwise", t, M, ctas_per_sm)
        qa, qb = (torch.empty(M, K, dtype=torch.int8, device="cuda") for _ in range(2))
        sa, sb = (torch.empty(M, 1, dtype=torch.float32, device="cuda") for _ in range(2))
        col = torch.empty(2 * K, dtype=torch.float32, device="cuda")
        parts = torch.empty(rows, 2 * K, dtype=torch.float32, device="cuda")
        none = torch.empty(0, dtype=a.dtype, device="cuda")
        _build.check(lib.qt_silu_mul_bwd_quant_rowwise(
            a.data_ptr(), b.data_ptr(), dy.data_ptr(), qa.data_ptr(), sa.data_ptr(), qb.data_ptr(), sb.data_ptr(),
            col.data_ptr(), parts.data_ptr(), none.data_ptr(), none.data_ptr(), M, K, FP._rows_per_block(M), FP.EPS,
            1, sr, amax, 0, ROWS_KEY if sr else 0, *route, _build.stream()), "B11")
        out = (qa, sa, qb, sb)
        return out + (col[:K].view(1, K), col[K:].view(1, K)) if amax else out
    return call


def b18_layernorm(lib, sigs, sr, tpr=None, ctas_per_sm=None, cols=False):
    """B18's LayerNorm of ``lib`` (``sr`` = 1: its SR form from ``ROWS_KEY``):
    x [M, K] bf16, g, b [K] fp32 -> (q, s_row, column absmax); with ``cols``
    the column form given the column scales [1, K] fp32 -> (q,); on the walk
    at ``tpr`` threads a row (default: the route's; 0 the first design) and
    ``ctas_per_sm`` CTAs an SM (default: the wrapper's for the form)."""
    fn = "qt_layernorm_quant_colwise" if cols else "qt_layernorm_quant_rowwise"
    per_sm = ctas_per_sm or (FP.LAYERNORM_CTAS_PER_SM if cols else FP.layernorm_rows_ctas_per_sm(sr))

    def call(x, g, b, *scale):
        M, K = x.shape
        t = FP.layernorm_rows_sm90_route(K, x.dtype) if tpr is None else tpr
        route, rows = _route(sigs, fn, t, M, per_sm)
        q = torch.empty(M, K, dtype=torch.int8, device="cuda")
        key = ROWS_KEY if sr else 0
        if cols:
            _build.check(lib.qt_layernorm_quant_colwise(x.data_ptr(), g.data_ptr(), b.data_ptr(), scale[0].data_ptr(),
                                                        q.data_ptr(), None, None, None, M, K, FP._rows_per_block(M),
                                                        1e-6, FP.EPS, 1, sr, key, *route, _build.stream()),
                         "B18 LayerNorm columns")
            return (q,)
        s_row = torch.empty(M, 1, dtype=torch.float32, device="cuda")
        col = torch.empty(1, K, dtype=torch.float32, device="cuda")
        parts = torch.empty(rows, K, dtype=torch.float32, device="cuda")
        _build.check(lib.qt_layernorm_quant_rowwise(x.data_ptr(), g.data_ptr(), b.data_ptr(), q.data_ptr(),
                                                    s_row.data_ptr(), col.data_ptr(), parts.data_ptr(), M, K,
                                                    FP._rows_per_block(M), 1e-6, FP.EPS, 1, sr, 1, key, *route,
                                                    _build.stream()), "B18 LayerNorm rows")
        return q, s_row, col
    return call


def b18_gelu(lib, sigs, sr, tpr=None, ctas_per_sm=None, cols=False, amax=1):
    """B18's GELU of ``lib`` (``sr`` = 1: its SR form from ``ROWS_KEY``): a
    [M, K] bf16 -> (q, s_row, column absmax); with ``cols`` the column form
    given the column scales [1, K] fp32 -> (q,); on the walk at ``tpr``
    threads a row (default: the route's; 0 the first design) and
    ``ctas_per_sm`` CTAs an SM (default: the wrapper's for the form); rows
    without the column absmax at ``amax`` 0."""
    fn = "qt_gelu_quant_colwise" if cols else "qt_gelu_quant_rowwise"

    def call(a, *scale):
        M, K = a.shape
        t = FP.gelu_rows_sm90_route(K, a.dtype) if tpr is None else tpr
        route, rows = _route(sigs, fn, t, M, ctas_per_sm or FP.gelu_ctas_per_sm(K, a.dtype, sr))
        q = torch.empty(M, K, dtype=torch.int8, device="cuda")
        key = ROWS_KEY if sr else 0
        if cols:
            _build.check(lib.qt_gelu_quant_colwise(a.data_ptr(), scale[0].data_ptr(), q.data_ptr(), None, None, None,
                                                   M, K, FP._rows_per_block(M), FP.EPS, 1, sr, key, *route,
                                                   _build.stream()), "B18 GELU columns")
            return (q,)
        s_row = torch.empty(M, 1, dtype=torch.float32, device="cuda")
        col = torch.empty(1, K, dtype=torch.float32, device="cuda")
        parts = torch.empty(rows, K, dtype=torch.float32, device="cuda")
        _build.check(lib.qt_gelu_quant_rowwise(a.data_ptr(), q.data_ptr(), s_row.data_ptr(), col.data_ptr(),
                                               parts.data_ptr(), M, K, FP._rows_per_block(M), FP.EPS, 1, sr, amax,
                                               key, *route, _build.stream()), "B18 GELU rows")
        return (q, s_row, col) if amax else (q, s_row)
    return call


def b14(lib, sigs, sr, tpr=None, ctas_per_sm=ROPE.UNGROUP_CTAS_PER_SM, axis=None):
    """B14 of ``lib`` on the grouped attention output y [B, KV, G, S, hd]
    bf16: its absmax -> (row maxima [B, S, 1], column maxima [1, K]) (axis
    None), or its int8 quantize given the row scales [B, S, 1] (axis 1) or
    the column scales [1, K] (axis 0) -> (q,), ``sr`` = 1 its SR form from
    ``ROWS_KEY``; on the walk at ``tpr`` threads a row (default: the route's;
    0 the first design) and ``ctas_per_sm`` CTAs an SM."""
    fn = "qt_ungroup_amax" if axis is None else "qt_ungroup_quant"

    def call(y, *scale):
        B, KV, G, S, hd = y.shape
        M, K = B * S, KV * G * hd
        t = ROPE.ungroup_sm90_route(K, hd, y.dtype) if tpr is None else tpr
        route, rows = _route(sigs, fn, t, M, ctas_per_sm)
        head = (*ROPE._grouped_strides(y, "B14"), B, S, KV * G, hd)
        if axis is None:
            row = torch.empty(B, S, 1, dtype=torch.float32, device="cuda")
            col = torch.empty(1, K, dtype=torch.float32, device="cuda")
            parts = torch.empty(rows, K, dtype=torch.float32, device="cuda")
            _build.check(lib.qt_ungroup_amax(y.data_ptr(), *head, row.data_ptr(), col.data_ptr(), parts.data_ptr(),
                                             FP._rows_per_block(M), 1, *route, _build.stream()), "B14 absmax")
            return row, col
        q = torch.empty(B, S, K, dtype=torch.int8, device="cuda")
        _build.check(lib.qt_ungroup_quant(y.data_ptr(), *head, scale[0].data_ptr(), q.data_ptr(), FP._rows_per_block(M),
                                          axis, FP.EPS, 1, sr, ROWS_KEY if sr else 0, *route, _build.stream()),
                     "B14 quantize")
        return (q,)
    return call


def b13(lib, sigs, _):
    """B13 of ``lib``: x [B, S, H, hd] bf16 with rotate-half RoPE from fp32
    tables [S, hd] -> [B, S, H, hd] (mode 1, the grouping of q)."""
    def call(x, cos, sin):
        B, S, H, hd = x.shape
        out = torch.empty_like(x)
        _build.check(lib.qt_rope_relayout(x.data_ptr(), *x.stride()[:3], out.data_ptr(), *out.stride()[:3],
                                          cos.data_ptr(), sin.data_ptr(), cos.stride(0), B, S, H, hd, 1, 1,
                                          _build.stream()), "B13")
        return out
    return call


def b16(lib, sigs, sm90):
    """B16 on ``lib``'s route ``sm90`` (an entry without the argument has
    the wmma kernel only): a [M, K / 2], b [N, K / 2] packed -> bf16."""
    route = (sm90,) if len(sigs["qt_scaled_int4_mm"]) == 12 else ()

    def call(a, b, sa, sb):
        (M, P), N = a.shape, b.shape[0]
        out = torch.empty(M, N, dtype=torch.bfloat16, device="cuda")
        _build.check(lib.qt_scaled_int4_mm(a.data_ptr(), b.data_ptr(), sa.data_ptr(), sb.data_ptr(),
                                           out.data_ptr(), M, N, 2 * P, 1, 1, *route, _build.stream()), "B16")
        return out
    return call


def sass_counts(lib: Path, fragment: str, label: str) -> None:
    """Each kernel of ``lib`` whose mangled name holds ``fragment``: its
    SASS instructions (cuobjdump), in all and by opcode, the commonest
    first."""
    text = subprocess.run([str(Path(_build._nvcc()).parent / "cuobjdump"), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    for body in re.split(r"\n\s*Function : ", text)[1:]:
        name = body.split("\n", 1)[0].strip()
        if fragment not in name:
            continue
        ops = {}
        for op in re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", body):
            ops[op] = ops.get(op, 0) + 1
        top = ", ".join(f"{k} {v}" for k, v in sorted(ops.items(), key=lambda kv: -kv[1])[:10])
        print(f"{label} {name}: {sum(ops.values())} instructions ({top})", flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path,
                        help="another checkout, whose wmma B1, B2, B15, B16 and B17-s8, and B5, are timed too")
    parser.add_argument("--variants", default=",".join(VARIANTS))
    parser.add_argument("--kernels", default=",".join(KERNELS), help="the kernels to check and time")
    parser.add_argument("--sass", help="only count the SASS instructions of each variant's kernels whose name "
                                       "holds this (cuobjdump), by opcode")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ab_sm90_forms: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    variants = {k: VARIANTS[k] for k in args.variants.split(",")}
    kernels = args.kernels.split(",")
    if args.parent:
        variants["parent"] = []
    t0 = time.perf_counter()
    libs = build(variants, args.parent, kernels)
    print(f"built {list(libs)} in {time.perf_counter() - t0:.1f} s", flush=True)
    if args.sass:
        for name in dict.fromkeys(n if VARIANTS.get(n) or n in ("kept", "parent") else "kept" for n in libs):
            sass_counts(OUT / name / "lib.so", args.sass, name)
        return
    # (label, kernel, call): each variant on the sm90 route (B5: its kernels,
    # the SR form for B5sr), and the wmma kernels
    entries = [(f"{n}/{ROUTE.get(k, 'sm90')}", k, KERNELS[k](lib, sigs, QUANT.get(k, 1), **ROUTE_ARGS.get(n, {}).get(k, {})))
               for n, (lib, sigs) in libs.items() if n != "parent" for k in kernels]
    if "kept" in libs:
        entries += [("kept/wmma", k, KERNELS[k](*libs["kept"], 0)) for k in ("B16", "B17s8") if k in kernels]
        entries += [("kept/first", k, KERNELS[k](*libs["kept"], QUANT[k], **FIRST.get(k, {"tpr": 0})))
                    for k in ("B7", "B7sr", "B8", "B8sr", "B9", "B9sr", "B10", "B11", "B11sr", *SILU_COLS, "B4", "B4sr",
                              *B18, *B14, "B19", "K1", "K1sr", "K2d")
                    if k in kernels]
    if args.parent:
        entries += [(f"parent/{ROUTE.get(k, 'wmma')}", k, KERNELS[k](*libs["parent"], QUANT.get(k, 0)))
                    for k in kernels if k != "K2"]
        entries += [("parent/sm90", "K2", k2(*libs["parent"], 1))] if "K2" in kernels else []
    gen = torch.Generator(device="cuda").manual_seed(0)

    def operands(kernel, M, N, K=None, hd=None):
        def i8(shape):
            return torch.randint(-128, 128, shape, generator=gen, device="cuda", dtype=torch.int8)

        def e4m3(shape):
            return (torch.randn(shape, generator=gen, device="cuda") * 50).to(torch.float8_e4m3fn)

        def scales(*shape):
            return (torch.rand(shape, generator=gen, device="cuda") * 0.01).bfloat16()
        if kernel in ("B5", "B5sr"):  # (M, K): a gradient-sized x with an all-zero row and column
            x = (torch.randn(M, N, generator=gen, device="cuda") * 1e-3).bfloat16()
            x[0], x[:, 1] = 0, 0
            return (x,)
        if kernel in ("B7", "B7sr"):  # (M, K): x with an all-zero row, a bf16 gamma widened as the wrapper does
            x = torch.randn(M, N, generator=gen, device="cuda").bfloat16()
            x[0] = 0
            return x, (1 + 0.1 * torch.randn(N, generator=gen, device="cuda")).bfloat16().float()
        if kernel in ("B8", "B8sr"):  # (M, K): B7's operands and the column scales of its absmax
            x = torch.randn(M, N, generator=gen, device="cuda").bfloat16()
            x[0] = 0
            g = (1 + 0.1 * torch.randn(N, generator=gen, device="cuda")).bfloat16().float()
            return x, g, ops.rmsnorm_quant_rowwise_plain(x, g, with_col_amax=True)[2] * (1.0 / 127.0)
        if kernel == "B10":  # (M, K): x with an all-zero row, a bf16 gamma widened, a gradient-sized dy
            x = torch.randn(M, N, generator=gen, device="cuda").bfloat16()
            x[0] = 0
            dy = (torch.randn(M, N, generator=gen, device="cuda") * 1e-3).bfloat16()
            return x, (1 + 0.1 * torch.randn(N, generator=gen, device="cuda")).bfloat16().float(), dy
        if kernel in ("B9", "B9sr", "B9c", "B9csr"):  # (M, K): gate with an all-zero column, up
            a, b = (torch.randn(M, N, generator=gen, device="cuda").bfloat16() for _ in range(2))
            a[:, 1] = 0
            if kernel.startswith("B9c"):  # and the column scales of the row form's absmax
                return a, b, ops.silu_mul_quant_rowwise_plain(a, b, with_col_amax=True)[2] * (1.0 / 127.0)
            return a, b
        if kernel in ("K1", "K1sr"):  # (M, K): a weight-sized x with an all-zero row
            x = (torch.randn(M, N, generator=gen, device="cuda") * 0.02).bfloat16()
            x[0] = 0
            return (x,)
        if kernel in ("B4", "B4sr"):  # (R, C): a weight-sized x with an all-zero row and column
            x = (torch.randn(M, N, generator=gen, device="cuda") * 0.02).bfloat16()
            x[0], x[:, 3] = 0, 0
            return (x,)
        if kernel.startswith("B18ln"):  # (M, K): x off zero mean with a padded (all-zero) row, bf16 g and b widened
            x = (torch.randn(M, N, generator=gen, device="cuda") + 0.5).bfloat16()
            x[-1] = 0
            g = (1 + 0.1 * torch.randn(N, generator=gen, device="cuda")).bfloat16().float()
            b = (0.1 * torch.randn(N, generator=gen, device="cuda")).bfloat16().float()
            if kernel.startswith("B18lnc"):  # and the column scales of the row form's absmax
                return x, g, b, ops.layernorm_quant_plain(x, g, b, with_col_amax=True)[2] * (1.0 / 127.0)
            return x, g, b
        if kernel.startswith("B18g"):  # (M, K): fc1's output with an all-zero column
            a = torch.randn(M, N, generator=gen, device="cuda").bfloat16()
            a[:, 1] = 0
            if kernel.startswith("B18gc"):
                return a, ops.gelu_quant_plain(a, with_col_amax=True)[2] * (1.0 / 127.0)
            return (a,)
        if kernel == "B13":  # (M, K): q [M / 2048, 2048, K / 64, 64] and its tables
            x = torch.randn(M // 2048, 2048, N // 64, 64, generator=gen, device="cuda").bfloat16()
            pos = torch.arange(2048, device="cuda", dtype=torch.float32)[:, None]
            angle = pos * 10000.0 ** (-torch.arange(0, 64, 2, device="cuda") / 64.0)
            angle = torch.cat([angle, angle], dim=-1)
            return x, angle.cos() * 0.125, angle.sin() * 0.125
        if kernel in B14:  # (M, K, memory): the grouped attention output, 64-wide heads, 4 KV heads, an all-zero row
            B = 4 if M % 8192 == 0 else 2
            x = torch.randn(B, M // B, N // 64, 64, generator=gen, device="cuda").bfloat16()
            x[0, 1] = 0
            G = N // 64 // 4
            y = (x.view(B, M // B, 4, G, 64).permute(0, 2, 3, 1, 4) if K == "bshd"
                 else x.permute(0, 2, 1, 3).contiguous().view(B, 4, G, M // B, 64))
            if kernel == "B14a":
                return (y,)
            row, col = ops.ungroup_amax_plain(y)
            return y, (row if kernel.startswith("B14r") else col) * (1.0 / 127.0)
        if kernel in ("B11", "B11sr", "B12c", "B12csr"):  # (M, K): gate, up, and dact with an all-zero column
            a, b = (torch.randn(M, N, generator=gen, device="cuda").bfloat16() for _ in range(2))
            dy = (torch.randn(M, N, generator=gen, device="cuda") * 1e-3).bfloat16()
            dy[:, 1] = 0
            if kernel.startswith("B12c"):  # and the column scales of B11's absmax
                amax = ops.silu_mul_bwd_quant_rowwise_plain(a, b, dy)[4:]
                return a, b, dy, *(m * (1.0 / 127.0) for m in amax)
            return a, b, dy
        if kernel == "B19":  # (instances, G, S, hd): Llama2-1B's attention, quantized as the op's input
            q = torch.randn(M, N, K, hd, generator=gen, device="cuda").bfloat16()
            k, v = (torch.randn(M, K, hd, generator=gen, device="cuda").bfloat16() for _ in range(2))
            return ops.quantize_qkv(q, k, v)
        if kernel == "B17s8":
            return i8((M, K)), i8((K, N))
        if kernel in ("B15", "B15s8"):
            make = e4m3 if kernel == "B15" else i8
            return make((M, K)), make((K, N)), scales(M, K // 128), scales(K // 128, N // 128)
        a, b = {"B1": lambda: (i8((M, K)), i8((K, N))), "B2": lambda: (i8((K, M)), i8((K, N))),
                "B16": lambda: (i8((M, K // 2)), i8((N, K // 2))), "K2": lambda: (i8((M, K)), i8((N, K))),
                "K2d": lambda: (i8((M, K)), i8((N, K)))}[kernel]()
        return a, b, scales(M), scales(N)

    plain = {"B1": ops.scaled_mm_plain, "B2": ops.scaled_mm_lhs_t_plain, "B15": ops.tile_scaled_mm_plain,
             "B15s8": ops.tile_scaled_mm_plain, "B16": ops.scaled_int4_mm_plain, "K2": ops.scaled_mm_rhs_t_plain,
             "K2d": ops.scaled_mm_rhs_t_plain, "K1": ops.quantize_int8_plain,
             "K1sr": lambda x: ops.quantize_int8_plain(x, sr=True, key=B5_KEY),
             "B17s8": ops.matmul_plain, "B5": ops.quantize_int8_both_plain,
             "B5sr": lambda x: ops.quantize_int8_both_plain(x, sr=True, key=B5_KEY),
             "B11": ops.silu_mul_bwd_quant_rowwise_plain,
             "B9": lambda a, b: ops.silu_mul_quant_rowwise_plain(a, b, with_col_amax=True),
             "B9sr": lambda a, b: ops.silu_mul_quant_rowwise_plain(a, b, with_col_amax=True, sr=True, key=ROWS_KEY),
             "B4": lambda x: ops.quantize_int8_plain(x, axis=0),
             "B4sr": lambda x: ops.quantize_int8_plain(x, axis=0, sr=True, key=B5_KEY),
             "B11sr": lambda a, b, dy: ops.silu_mul_bwd_quant_rowwise_plain(a, b, dy, sr=True, key=ROWS_KEY),
             "B9c": lambda a, b, s: ops.silu_mul_quant_colwise_plain(a, b, scale=s)[:1],
             "B9csr": lambda a, b, s: ops.silu_mul_quant_colwise_plain(a, b, scale=s, sr=True, key=ROWS_KEY)[:1],
             "B12c": ops.silu_mul_bwd_quant_colwise_plain,
             "B12csr": lambda *args: ops.silu_mul_bwd_quant_colwise_plain(*args, sr=True, key=ROWS_KEY),
             "B18gr": lambda a: ops.gelu_quant_plain(a, with_col_amax=True),
             "B18grsr": lambda a: ops.gelu_quant_plain(a, with_col_amax=True, sr=True, key=ROWS_KEY),
             "B18gc": lambda a, s: ops.gelu_quant_plain(a, axis=0, scale=s)[:1],
             "B18gcsr": lambda a, s: ops.gelu_quant_plain(a, axis=0, scale=s, sr=True, key=ROWS_KEY)[:1],
             "B14a": ops.ungroup_amax_plain,
             "B19": lambda *qkv: ops.int8_flash_fwd_plain(*qkv, causal=True, block_kv=512),
             "B13": lambda x, c, s: ROPE.rope_ungroup_ref(ROPE.rope_group_ref(x, c, s, 1), None, None),
             **{k: partial(lambda y, s, axis, sr: (ops.ungroup_quant_plain(y, s, axis=axis, sr=sr, key=ROWS_KEY),),
                           axis=int(k.startswith("B14r")), sr=k.endswith("sr")) for k in B14[1:]}}
    if "kept" in libs:  # B7, B8, B18's LayerNorm and B10's dx keep their first designs' bits
        plain.update({k: KERNELS[k](*libs["kept"], QUANT[k], tpr=0)
                      for k in ("B7", "B7sr", "B8", "B8sr", "B10", "B18lnr", "B18lnrsr", "B18lnc", "B18lncsr")})
    for kernel, shape in (("B1", (130, 208, 272)), ("B1", (8192, 2048, 5632)), ("B2", (144, 208, 288)),
                          ("B2", (5632, 2048, 8192)), ("B15", (200, 256, 640)), ("B15", (8192, 2048, 5632)),
                          ("B15s8", (200, 256, 640)), ("B15s8", (8192, 2048, 5632)), ("B16", (130, 200, 288)),
                          ("B16", (5632, 2048, 8192)), ("K2", (8192, 5632, 2048)), ("B17s8", (200, 144, 304)),
                          ("B17s8", (4096, 4096, 4096)), *((k, s) for k in ("B5", "B5sr")
                                                          for s in ((130, 200), (8, 9000), *B5_SHAPES)),
                          *((k, s) for k in ("B7", "B7sr") for s in ((1001, 2048), *ROW_SHAPES["B7"])),
                          *((k, s) for k in ("B8", "B8sr", "B10")
                            for s in ((1000, 2048), *ROW_SHAPES[k.removesuffix("sr")])),
                          *((k, s) for k in ("B11", "B11sr") for s in ((1000, 5632), *ROW_SHAPES["B11"])),
                          *((k, s) for k in ("B9", "B9sr") for s in ((1000, 5632), *ROW_SHAPES["B9"])),
                          *((k, s) for k in SILU_COLS for s in ((1000, 5632), *SHAPES[k])),
                          *((k, s) for k in ("B4", "B4sr") for s in ((1000, 2048), (3, 2048), *B4_SHAPES)),
                          *((k, s) for k in B18 for s in ((1000, SHAPES[k][0][1]), *SHAPES[k])),
                          *((k, s) for k in B14 for s in ((1000, 2048, "bshd"), (1000, 2048, "bhsd"), *SHAPES[k])),
                          ("B13", (8192, 2048)), ("B19", (2, 2, 1024, 64)), *(("B19", s) for s in SHAPES["B19"]),
                          *((k, s) for k in ("K1", "K1sr") for s in ((263, 2048), (1000, 5632), *SHAPES[k])),
                          *(("K2d", (m, 200, 2064)) for m in (1, 9)), *(("K2d", s) for s in SHAPES["K2d"])):
        if kernel not in kernels:
            continue
        args_ = operands(kernel, *shape)
        ref = plain[kernel](*args_)
        if kernel == "B15":  # in fp32 roundings of the folded magnitudes (fold_bound)
            R = 128 + args_[2].shape[1]
            unit = fold_bound(*args_, 1).clamp(min=1e-300)
            ref32 = ops.tile_scaled_mm_plain(*args_, out_dtype=torch.float32).double()
        for label, k, call in entries:
            if k == kernel:
                try:
                    got = call(*args_)
                except RuntimeError as e:
                    raise SystemExit(f"ab_sm90_forms: {label} {kernel} at {shape}: {e}") from e
                if kernel == "B15":
                    # bf16 out: the fp32 sum within R roundings, then one bf16 rounding of it
                    err = (got.double() - ref32).abs() - 2.0**-8 * ref32.abs()
                    worst = (err / unit).max().item()
                    exact = worst <= R
                    print(f"{label} {kernel} {shape}: worst {worst:.2f} fp32 roundings of the folded magnitudes "
                          f"beyond a bf16 half-ulp (bound {R}): within {exact}", flush=True)
                elif kernel == "B19":  # the row sums of p in another order
                    exact, err, share = ATTN.agreement(*got, *ref, args_[5])
                    print(f"{label} {kernel} {shape}: within agreement of the plain version {exact} (max |out - "
                          f"plain| {err:.3e}, {share:.3e} of the elements differ)", flush=True)
                elif kernel == "B10":  # dx bit-exact, dgamma summed in the walk's order
                    rel = ((got[1] - ref[1]).abs().max() / ref[1].abs().max()).item()
                    exact = torch.equal(got[0], ref[0]) and rel <= 2e-5
                    print(f"{label} {kernel} {shape}: dx bit-exact {torch.equal(got[0], ref[0])}, dgamma {rel:.2e} "
                          "of its largest magnitude from the first design's", flush=True)
                else:
                    exact = (all(map(torch.equal, got, ref)) if isinstance(got, tuple)
                             else torch.equal(got, ref))
                    print(f"{label} {kernel} {shape}: bit-exact {exact}", flush=True)
                if not (exact or label.startswith("diag_")):
                    raise SystemExit(f"ab_sm90_forms: {label} {kernel} at {shape} differs from the plain version")
    rows = [(k, s) for k in kernels for s in SHAPES[k]]
    times = {}
    for turn in (entries, entries[::-1]):
        for label, kernel, call in turn:
            for k, shape in rows:
                if k == kernel:
                    inputs = copies(*operands(kernel, *shape))
                    times.setdefault((label, kernel, shape), []).append(time_ms(call, inputs, iters=8) * 1e3)
    for kernel, shape in rows:
        if kernel == "B19":  # the causal triangle's exponentials at the card's special-function rate
            n_inst, G, S, hd = shape
            mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                                       capture_output=True, text=True, check=True).stdout.split()[0])
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            bound_us = n_inst * G * S * (S + 1) // 2 / (SFU_PER_SM_CLOCK * sms * mhz * 1e6) * 1e6
            q, k, v = (torch.randn(n_inst, *s, generator=gen, device="cuda").bfloat16()
                       for s in ((G, S, hd), (S, hd), (S, hd)))
            sdpa_us = time_ms(lambda q, k, v: torch.nn.functional.scaled_dot_product_attention(
                q.reshape(1, n_inst * G, S, hd), k.unsqueeze(0), v.unsqueeze(0), is_causal=True, enable_gqa=True),
                copies(q, k, v), iters=8) * 1e3
            cells = [f"{label} {sum(t) / len(t):.1f} {[round(v, 1) for v in t]} ({bound_us * len(t) / sum(t):.3f})"
                     for (label, k_, s), t in times.items() if k_ == kernel and s == shape]
            print(f"{kernel} {list(shape)} causal, block_kv 512: bound {bound_us:.1f} us (exponentials); "
                  + "; ".join(cells) + f"; SDPA bf16 {sdpa_us:.1f} (a reference)", flush=True)
            continue
        if kernel == "K2d":  # the int8 weight and x read once, out written once
            M, N, K = shape
            bound_us = (N * K + M * K + 2 * M * N) / HBM_BYTES_PER_S * 1e6
            cells = [f"{label} {sum(t) / len(t):.1f} {[round(v, 1) for v in t]} ({bound_us * len(t) / sum(t):.3f})"
                     for (label, k, s), t in times.items() if k == kernel and s == shape]
            print(f"{kernel} M={M} N={N} K={K}: bound {bound_us:.2f} us (bytes); " + "; ".join(cells), flush=True)
            continue
        if kernel in ROW_BYTES:  # the inputs read once, the outputs written once
            M, K = shape[:2]
            bound_us = ROW_BYTES[kernel](M, K) / HBM_BYTES_PER_S * 1e6
            cells = [f"{label} {sum(t) / len(t):.1f} {[round(v, 1) for v in t]} ({bound_us * len(t) / sum(t):.3f})"
                     for (label, k, s), t in times.items() if k == kernel and s == shape]
            memory = f" {shape[2]} memory" if len(shape) == 3 else ""
            print(f"{kernel} M={M} K={K}{memory}: bound {bound_us:.1f} us (bytes); " + "; ".join(cells), flush=True)
            continue
        M, N, K = shape
        a, b, *_ = operands(kernel, M, N, K)
        lib_name, lib_us = "torch._int_mm", None
        if kernel == "B2":
            lib_us = time_ms(lambda a, b: torch._int_mm(a.t(), b), copies(a, b), iters=8) * 1e3
        elif kernel == "K2":
            lib_us = time_ms(lambda a, b: torch._int_mm(a, b.t()), copies(a, b), iters=8) * 1e3
        elif kernel in ("B1", "B15s8", "B17s8"):
            lib_us = time_ms(torch._int_mm, copies(a, b), iters=8) * 1e3
        elif kernel == "B15":
            lib_name = "torch._scaled_mm (row scales)"
            one_a, one_b = torch.ones(M, 1, device="cuda"), torch.ones(1, N, device="cuda")
            lib_us = time_ms(lambda a, b: torch._scaled_mm(a, b, scale_a=one_a, scale_b=one_b, out_dtype=torch.bfloat16),
                             copies(a, b.t().contiguous().t()), iters=8) * 1e3
        else:
            lib_us = time_ms(lambda a, b: torch._int_mm(a, b.t()), copies(ops.unpack_int4(a), ops.unpack_int4(b)),
                             iters=8) * 1e3
        bound_us = 2 * M * N * K / INT8_OPS_PER_S * 1e6
        cells = [f"{label} {sum(t) / len(t):.1f} {[round(v, 1) for v in t]} ({bound_us * len(t) / sum(t):.3f})"
                 for (label, k, shape), t in times.items() if k == kernel and shape == (M, N, K)]
        print(f"{kernel} M={M} N={N} K={K}: bound {bound_us:.1f} us; " + "; ".join(cells)
              + f"; {lib_name} {lib_us:.1f}", flush=True)


KERNELS = {"B1": b1, "B2": b2, "B15": b15, "B15s8": b15, "B16": b16, "K2": k2, "B17s8": b17s8, "B5": b5, "B5sr": b5,
           "B7": b7, "B7sr": b7, "B8": b8, "B8sr": b8, "B10": b10, "B11": b11, "B11sr": b11, "B9": b9, "B9sr": b9,
           "B4": b4, "B4sr": b4, "B18lnr": b18_layernorm, "B18lnrsr": b18_layernorm,
           "B18lnc": partial(b18_layernorm, cols=True), "B18lncsr": partial(b18_layernorm, cols=True),
           "B18gr": b18_gelu, "B18grsr": b18_gelu, "B18gc": partial(b18_gelu, cols=True),
           "B18gcsr": partial(b18_gelu, cols=True), "B13": b13, "B14a": b14, "B14r": partial(b14, axis=1),
           "B14rsr": partial(b14, axis=1), "B14c": partial(b14, axis=0), "B14csr": partial(b14, axis=0), "B19": b19,
           "K1": k1, "K1sr": k1, "K2d": k2d, "B9c": b9c, "B9csr": b9c, "B12c": b12c, "B12csr": b12c}
# B9's column form and B12 given scales, RN and SR
SILU_COLS = ("B9c", "B9csr", "B12c", "B12csr")
# B18's eight forms: LayerNorm and GELU, rows (with the column absmax) and
# columns given scales, RN and SR
B18 = ("B18lnr", "B18lnrsr", "B18lnc", "B18lncsr", "B18gr", "B18grsr", "B18gc", "B18gcsr")
# the argument each kernel's entry takes in place of the route: the SR flag
QUANT = {"B5": 0, "B5sr": 1, "B7": 0, "B7sr": 1, "B8": 0, "B8sr": 1, "B10": 0, "B11": 0, "B11sr": 1, "B9": 0,
         "B9sr": 1, "B4": 0, "B4sr": 1, **{k: int(k.endswith("sr")) for k in (*B18, *B14, *SILU_COLS)}, "B19": 0,
         "K1": 0,
         "K1sr": 1, "K2d": 0}
ROUTE = {"B5": "kernel", "B5sr": "kernel", "B7": "walk", "B7sr": "walk", "B8": "walk", "B8sr": "walk", "B10": "walk",
         "B11": "walk", "B11sr": "walk", "B9": "walk", "B9sr": "walk", "B4": "cluster", "B4sr": "cluster",
         "B13": "kernel", **dict.fromkeys((*B18, *B14, *SILU_COLS), "walk"), "K1": "walk", "K1sr": "walk",
         "K2d": "stream"}
# the keyword argument that forces a kernel's first design (``kept/first``)
FIRST = {"B4": {"route": 0}, "B4sr": {"route": 0}, "B19": {"sm90": 0}, "K2d": {"route": 0}}
def _b18_bytes(kernel):
    """B18's bytes at [M, K] bf16, as chip_smoke.py counts them: x read
    (LayerNorm: and fp32 g, b), q written, and the fp32 row scales and
    column absmax written (rows) or the column scales read (columns)."""
    gb = 8 if kernel.startswith("B18ln") else 0
    rows = kernel.startswith(("B18lnr", "B18gr"))
    return lambda M, K: 3 * M * K + gb * K + 4 * K + (4 * M if rows else 0)


# the bytes the row quantizes must move at [M, K] bf16: B5 x read, two int8
# and the bf16 scales written; B7 x and gamma read, q, the fp32 row scales
# and column absmax written; B11 (a, b, dy) read, two int8, two fp32 row
# scales and two column absmax written; B9's and B12's column forms the
# same inputs and the fp32 column scales (B12 two) read, the int8 written; B8 x, the bf16 gamma and the fp32
# column scales read, q written; B10 x, dy and the bf16 gamma read, dx and
# the fp32 dgamma written; B14 y read, and the fp32 row and column maxima
# (absmax) or q written and the fp32 row or column scales read; B13 x read,
# the rotated x written and the two fp32 tables read
ROW_BYTES = {"B5": lambda M, K: 4 * M * K + 2 * (M + K), "B5sr": lambda M, K: 4 * M * K + 2 * (M + K),
             "B7": lambda M, K: 3 * M * K + 2 * K + 4 * M + 4 * K, "B7sr": lambda M, K: 3 * M * K + 2 * K + 4 * M + 4 * K,
             "B11": lambda M, K: 8 * M * K + 8 * M + 8 * K, "B11sr": lambda M, K: 8 * M * K + 8 * M + 8 * K,
             "B9": lambda M, K: 5 * M * K + 4 * M + 4 * K, "B9sr": lambda M, K: 5 * M * K + 4 * M + 4 * K,
             "B9c": lambda M, K: 5 * M * K + 4 * K, "B9csr": lambda M, K: 5 * M * K + 4 * K,
             "B12c": lambda M, K: 8 * M * K + 8 * K, "B12csr": lambda M, K: 8 * M * K + 8 * K,
             "B8": lambda M, K: 3 * M * K + 2 * K + 4 * K, "B8sr": lambda M, K: 3 * M * K + 2 * K + 4 * K,
             "B10": lambda M, K: 6 * M * K + 2 * K + 4 * K,
             "B4": lambda M, K: 3 * M * K + 2 * K, "B4sr": lambda M, K: 3 * M * K + 2 * K,
             **{k: _b18_bytes(k) for k in B18},
             "B13": lambda M, K: 4 * M * K + 2 * 2048 * 64 * 4,
             "B14a": lambda M, K: 2 * M * K + 4 * M + 4 * K, "B14r": lambda M, K: 3 * M * K + 4 * M,
             "B14rsr": lambda M, K: 3 * M * K + 4 * M, "B14c": lambda M, K: 3 * M * K + 4 * K,
             "B14csr": lambda M, K: 3 * M * K + 4 * K,
             "K1": lambda M, K: 3 * M * K + 2 * M, "K1sr": lambda M, K: 3 * M * K + 2 * M}
# (M, N, K) each kernel is timed at: B1 at every grad_input of the Llama2-1B
# step (8,192 tokens; K out, N in features); B15 at gemm_forms' shapes in
# chip_smoke.py (forward, grad_input, grad_weight of gate/up and down); B17's
# int8 form at benchmark_mm.py's square sizes; B5's (M, K) at every output
# gradient of the bench.py step ([8192, 2048] q/o and down, [8192, 256] k/v)
# and of ViT-Giant's (qkv, fc1, proj and fc2 at 6,400 tokens), and at
# [8192, 5632], where x no longer fits in L2
B5_SHAPES = [(8192, 2048), (8192, 256), (6400, 4608), (6400, 6144), (6400, 1536), (8192, 5632)]
# B7, B9 and B11 at the Llama2-1B step's norm and FFN widths, B18 at
# ViT-Giant's (6,400 padded tokens, hidden 1536, MLP 6144); B4 at the
# fused step's four weights (q/o, k/v, gate/up, down), the unfused layer's
# x2d, and ViT-Giant's five a block (the qkv, proj, fc1 and fc2 weights and
# proj's input at 24 x 257 tokens)
ROW_SHAPES = {"B7": [(8192, 2048)], "B8": [(8192, 2048)], "B10": [(8192, 2048)], "B11": [(8192, 5632)],
              "B9": [(8192, 5632)]}
B4_SHAPES = [(2048, 2048), (256, 2048), (5632, 2048), (2048, 5632), (8192, 2048), (8192, 5632),
             (4608, 1536), (1536, 1536), (6144, 1536), (1536, 6144), (6168, 1536)]
SHAPES = {"B1": [(8192, 2048, 2048), (8192, 2048, 256), (8192, 2048, 5632), (8192, 5632, 2048)],
          "B2": B2_SHAPES, "B15": B16_SHAPES, "B15s8": B16_SHAPES, "B16": B16_SHAPES, "K2": K2_SHAPES,
          "B17s8": [(n, n, n) for n in (1024, 2048, 4096)], "B5": B5_SHAPES, "B5sr": B5_SHAPES,
          "B7": ROW_SHAPES["B7"], "B7sr": ROW_SHAPES["B7"], "B11": ROW_SHAPES["B11"], "B11sr": ROW_SHAPES["B11"],
          "B9": ROW_SHAPES["B9"], "B9sr": ROW_SHAPES["B9"], "B4": B4_SHAPES, "B4sr": B4_SHAPES,
          "B8": ROW_SHAPES["B8"], "B8sr": ROW_SHAPES["B8"], "B10": ROW_SHAPES["B10"],
          **{k: [(6400, 1536 if k.startswith("B18ln") else 6144)] for k in B18},
          **{k: [(8192, 2048, "bshd"), (8192, 2048, "bhsd")] for k in B14}, "B13": [(8192, 2048)],
          "B19": [(16, 8, 2048, 64), (16, 8, 2048, 128)], "K1": K1_SHAPES, "K1sr": K1_SHAPES, "K2d": K2D_SHAPES,
          **{k: [(8192, 5632), (256, 5632)] for k in SILU_COLS}}


if __name__ == "__main__":
    main()
