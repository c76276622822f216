// Absmax int8 quantize kernels, with the numerics of quant/core.py:99-115
// (not the Pallas kernels'): scale = absmax / 127 in fp32, q = rint(x /
// max(scale, eps)) with an IEEE division (the Pallas kernels multiply by a
// reciprocal and may differ by 1 LSB), clamped to [-128, 127]. The scale is
// stored in x's dtype, which is the cast core.py:115 applies before the GEMM
// epilogue reads it. Every kernel here runs at memory speed (about 3 flops
// per element), so each design counts bytes.
//
// K1: row-wise, x [M, K] -> q int8 [M, K], scale [M, 1]. Replaces
// quantized_training_tpu/ops/pallas_quant.py::quantize_int8_rowwise (:139).
// Under the dynamic scheme it re-reads every bf16 weight on every matmul of
// every decode step, which makes it the largest byte mover of the serving
// path. Bound: one read of x and one int8 write (10.3 us at [5632, 2048]
// bf16, 3.8 at [2048, 2048]). Design: rows of 1024 elements or more
// (weights, training and prefill activations) on 16-byte aligned inputs take
// the persistent row walk (quantize_rows_walk; ops/int8_quant.py::
// rowwise_sm90_route picks its threads a row): x read once into registers,
// the next row's loads in flight under this row's cast, the cast by div_rn
// and the one-add casts of B5's row pass, whose body it shares (row_top,
// cast_row). The first design stays for the rest: one 256-thread block per
// row for rows of 1024 elements or more (a decode step's 8 activation rows
// spread over 8 SMs), one warp per row below that (KV rows of 64), each
// reading its row twice (the absmax pass, then the cast pass from L1/L2)
// with __fdiv_rn and rintf an element; rows whose length or base is not
// 16-byte aligned take a scalar loop.
//
// B4: column-wise, x [R, C] -> q int8 [R, C], scale [1, C]. Replaces
// pallas_quant.py::quantize_int8_colwise (:229), the backward's quantize of
// w [out, in] along its first axis (7 a layer and micro-step in the fused
// Llama2-1B step: [2048, 2048], [256, 2048], [5632, 2048], [2048, 5632]),
// and of x2d [tokens, in] in the unfused layer. Bound: one read of x and one
// int8 write (10.3 us at [5632, 2048] bf16, 0.47 at [256, 2048]). Every
// weight fits in the 50 MB L2 and, split over a cluster of 8 CTAs, in their
// shared memory, so the design (quantize_cols_cluster, ops/int8_quant.py::
// colwise_sm90_route picks its geometry) is one launch: a cluster takes a
// strip of columns, each CTA reads its run of the strip's rows once into
// shared memory while keeping its columns' maxima in registers, the cluster
// merges its CTAs' maxima through distributed shared memory after one
// cluster barrier, and each CTA casts its tile from shared memory (div_rn,
// the one-add cast). The first design stays for unaligned views, a C off a
// whole number of vectors and tiles that would not fit (more than 8 x 3552
// rows): three launches, a memset of an fp32 [C] buffer, col_absmax (64-row
// blocks whose partial maxima meet there through atomicMax on the
// non-negative floats' bits) and col_cast (x read again, __fdiv_rn and
// rintf an element). At [256, 2048] its grid was 32 blocks on 132 SMs.
//
// B5: both axes, x [M, K] -> (q_row, s_row [M, 1], q_col, s_col [1, K]).
// Replaces pallas_quant.py::quantize_int8_both (:306), the backward's
// quantize of the output gradient (q, k, v, o and down in every layer and
// micro-step: [8192, 2048] and [8192, 256] in the Llama2-1B step; qkv, fc1,
// proj and fc2 at [6400, 4608 / 6144 / 1536] in ViT-Giant's). Bound: one read
// of x and two int8 writes at 3.35 TB/s (20.0 us at [8192, 2048]). The
// column scales need every row first, so x is read twice: the design keeps
// the second read in the 50 MB L2 where x fits and enough loads in flight
// for HBM on the first, and it keeps the arithmetic (two casts an element)
// off the quarter-rate units. Two kernels:
//
// - the row pass (quantize_both_row_pass): TPR threads a row (a warp up to
//   128 16-byte vectors, 2, 4 or 8 warps up to 1024), 4 vectors a thread a
//   row step: G rows of 4 / G vectors each, so that at K = 256 a warp takes
//   4 rows at once. A thread loads the next step's vectors before it works
//   on this step's, so 8 are in flight. The row max is a warp reduction (REDUX on the non-negative floats' bits), across the
//   row's warps through shared memory and a named barrier; the cast reads
//   the registers, not x again. A thread owns the same columns in every row
//   it takes, so it keeps their running max in registers (packed like x: two
//   bf16 a word); at the end the CTA merges its groups' in shared memory and
//   writes its K maxima, with plain stores, to a row of the front of q_col,
//   which is not written yet: no atomics (264 CTAs merging the same 2048
//   columns by atomicMax queue on each address in L2) and no memset of
//   amax. The grid is persistent: 2 CTAs of 256 threads an SM, each group of
//   TPR threads walking the row steps group, group + groups in the grid, ...;
// - the column pass (quantize_both_col_pass), launched cooperatively: the
//   grid reduces the row pass's rows of column maxima into amax and s_col,
//   meets at a grid-wide barrier, and casts q_col over them, walking the row
//   steps as the row pass does (double-buffered) but in reverse, so that the rows the row pass read last, which L2
//   still holds, are read first; each element by its column's max(scale,
//   eps) from shared memory. Its loads and both passes' int8 stores are
//   evict-first (ld/st.global.cs), so the outputs do not push x out of L2.
//
// The casts divide as IEEE division does without a division an element (a
// reciprocal a row or column and FMAs: div_rn) and round and convert by one
// add (kMagic), where __fdiv_rn, rintf and the float -> int cast each cost a
// quarter-rate instruction an element. ab_sm90_forms.py times the choices
// (its b5_* variants) and the passes apart (diag_b5_*). Above about 40 MB
// of x the second read partly comes from HBM again. An unaligned view, a K off a whole number of
// vectors, rows longer than 1024 vectors (bf16 K > 8192) or M below 2 (4
// for fp32: the maxima need K sizeof(x) bytes of q_col a CTA) take the first
// design: K1's block-per-row quantize over a run of rows per block that keeps
// each column's running max in shared memory and merges it by atomicMax into
// the zeroed amax (quantize_both_rows), then B4's column cast.
//
// The mesh forms (no Pallas counterpart: under a mesh JAX's program is one
// global program, whose maxima XLA takes over the whole of a sharded axis).
// A quantize whose reduced axis a mesh splits runs in two launches with an
// all-reduce of the maxima between them (parallel/collectives.py): a maxima
// form, which writes each row's or column's max |x| as fp32 and casts nothing,
// and a given-maxima form, which casts with scale = amax / 127 from the
// all-reduced maxima, the numbers of the whole quantize on the global tensor
// bit for bit. K1's two forms are its kernels (the row walk and the first
// design) with the reduction or the cast left out (kMaxima, kGiven). B5's
// maxima form is its row pass (q_row and s_row) and the column pass's
// reduction of the CTAs' parts into amax; B4's is its first design's
// col_absmax: the cluster form casts from the tile its CTAs hold in shared
// memory, which does not outlive the launch, so across an all-reduce the
// cast reads x again in any case. The one given form of a column quantize,
// B4's and B5's, is B5's column pass's cast alone (its first design's
// col_cast off B5's vector path), which measured faster than col_cast at 5
// of the 6 shapes of a rank's step (chip_smoke.py phase 3, PERF.md). Neither
// needs the cooperative launch, whose grid barrier only orders the two
// halves of the whole column pass.
//
// Stochastic rounding (the SR forms of K1, B4 and B5, replacing the
// ``sr=True`` bodies of pallas_quant.py:98-106 / :120-125, :220-225 and
// :276-302): q = floor(x / max(scale, eps) + u), clamped, with the same
// IEEE division, where u is element (r, c)'s word r * C + c of the key's
// Philox stream (philox.cuh) whatever the order the threads run in. The
// SR cast is a template flag of the same kernels: a thread that owns 8
// bf16 (or 4 fp32) elements of one 16-byte vector draws them from 2 (or 1)
// Philox calls, since the vector starts at a multiple of 4. That adds about
// 20 integer operations per element to the cast pass, which stays under
// the memory time of the pass. B5 draws its row and its column cast from
// two keys the wrapper derives from the call's key.

#include <cooperative_groups.h>

#include <algorithm>

#include "row_common.cuh"  // kThreads, to_f32, clamp_int8, vec_words, PackOf and the one-add casts

namespace {

constexpr int64_t kBlockRowMinK = 1024;

// The forms of a kernel: the whole quantize, its maxima alone (fp32, to
// amax), or its cast from given fp32 maxima (from amax)
constexpr int kWhole = 0, kMaxima = 1, kGiven = 2;

__device__ __forceinline__ void store_scale(float* p, float s) { *p = s; }
__device__ __forceinline__ void store_scale(__nv_bfloat16* p, float s) {
  *p = __float2bfloat16_rn(s);
}

__device__ __forceinline__ int8_t quant_one(float v, float denom) {
  // rintf rounds half to even, as jnp.round / torch.round do
  return clamp_int8(rintf(__fdiv_rn(v, denom)));
}

// floor(x / denom + u) with u = uniform_of(word): ops/random.py's order of
// operations, each rounded once (no contraction into an FMA)
__device__ __forceinline__ int8_t quant_one_sr(float v, float denom, uint32_t word) {
  return clamp_int8(floorf(__fadd_rn(__fdiv_rn(v, denom), qt::uniform_of(word))));
}

template <bool SR>
__device__ __forceinline__ int8_t quant_div(float v, float denom, uint32_t word) {
  return SR ? quant_one_sr(v, denom, word) : quant_one(v, denom);
}

// Absmax of one row, over the elements this thread owns (start ``tid``,
// stride ``STRIDE``): 16-byte vectors when ``vec``, else single elements.
template <typename T, int STRIDE>
__device__ __forceinline__ float row_absmax(const T* __restrict__ xr, int64_t K, bool vec, int tid) {
  constexpr int N = 16 / sizeof(T);
  float amax = 0.0f;
  if (vec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (int64_t i = tid; i < K / N; i += STRIDE) {
      uint4 u = xv[i];
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < N; ++j) amax = fmaxf(amax, fabsf(to_f32(e[j])));
    }
  } else {
    for (int64_t i = tid; i < K; i += STRIDE) amax = fmaxf(amax, fabsf(to_f32(xr[i])));
  }
  return amax;
}

// Cast the same elements to int8 given the row's max(scale, eps); ``base``
// is the row's first element index in the stream of ``key`` (SR only).
template <typename T, int STRIDE, bool SR>
__device__ __forceinline__ void row_cast(const T* __restrict__ xr, int8_t* __restrict__ qr, int64_t K,
                                         bool vec, int tid, float denom, uint64_t base, uint64_t key) {
  constexpr int N = 16 / sizeof(T);
  using Pack = typename PackOf<N>::type;
  if (vec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    Pack* qv = reinterpret_cast<Pack*>(qr);
    for (int64_t i = tid; i < K / N; i += STRIDE) {
      uint4 u = xv[i];
      const T* e = reinterpret_cast<const T*>(&u);
      uint32_t w[N];
      vec_words<SR, N>(base + i * N, key, w);
      union {
        Pack p;
        int8_t c[N];
      } out;
#pragma unroll
      for (int j = 0; j < N; ++j) out.c[j] = quant_div<SR>(to_f32(e[j]), denom, w[j]);
      qv[i] = out.p;
    }
  } else {
    for (int64_t i = tid; i < K; i += STRIDE)
      qr[i] = quant_div<SR>(to_f32(xr[i]), denom, SR ? qt::philox_word(base + i, key) : 0u);
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Short rows (K < kBlockRowMinK, e.g. KV rows of hd = 64): one warp per row.
template <typename T, bool SR, int MODE>
__global__ void __launch_bounds__(kThreads)
quantize_rows_warp(const T* __restrict__ x, int8_t* __restrict__ q, T* __restrict__ scale,
                   float* __restrict__ amax, int64_t M, int64_t K, float eps, bool vec, uint64_t key) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= M) return;  // whole warps leave together
  const float a = MODE == kGiven ? amax[row] : warp_max(row_absmax<T, 32>(x + row * K, K, vec, lane));
  if constexpr (MODE == kMaxima) {
    if (lane == 0) amax[row] = a;
    return;
  }
  const float s = __fdiv_rn(a, 127.0f);
  row_cast<T, 32, SR>(x + row * K, q + row * K, K, vec, lane, fmaxf(s, eps), row * K, key);
  if (lane == 0) store_scale(scale + row, s);
}

// Long rows (activations and weights, K >= kBlockRowMinK): one block per
// row, so even the 8 rows of a decode step spread over 8 SMs.
template <typename T, bool SR, int MODE>
__global__ void __launch_bounds__(kThreads)
quantize_rows_block(const T* __restrict__ x, int8_t* __restrict__ q, T* __restrict__ scale,
                    float* __restrict__ given, int64_t K, float eps, bool vec, uint64_t key) {
  __shared__ float part[kThreads / 32];
  const int64_t row = blockIdx.x;
  float amax;
  if constexpr (MODE == kGiven) {
    amax = given[row];
  } else {
    amax = warp_max(row_absmax<T, kThreads>(x + row * K, K, vec, threadIdx.x));
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = amax;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) amax = fmaxf(amax, part[w]);
    if constexpr (MODE == kMaxima) {
      if (threadIdx.x == 0) given[row] = amax;
      return;
    }
  }
  const float s = __fdiv_rn(amax, 127.0f);
  row_cast<T, kThreads, SR>(x + row * K, q + row * K, K, vec, threadIdx.x, fmaxf(s, eps), row * K, key);
  if (threadIdx.x == 0) store_scale(scale + row, s);
}

template <typename T, bool SR, int MODE = kWhole>
cudaError_t launch(const void* x, void* q, void* scale, float* amax, int64_t M, int64_t K, float eps, uint64_t key,
                   cudaStream_t stream) {
  const bool vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) && (K % (16 / sizeof(T)) == 0);
  const T* xt = static_cast<const T*>(x);
  int8_t* qt = static_cast<int8_t*>(q);
  T* st = static_cast<T*>(scale);
  if (K >= kBlockRowMinK) {
    quantize_rows_block<T, SR, MODE><<<static_cast<unsigned int>(M), kThreads, 0, stream>>>(xt, qt, st, amax, K,
                                                                                           eps, vec, key);
  } else {
    const int64_t blocks = (M + kThreads / 32 - 1) / (kThreads / 32);
    quantize_rows_warp<T, SR, MODE><<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
        xt, qt, st, amax, M, K, eps, vec, key);
  }
  return cudaGetLastError();
}

// ---- B4 and B5 -----------------------------------------------------------

constexpr int kColThreadsX = 32;       // threads along the columns, 16 bytes each
constexpr int kColThreadsY = kThreads / kColThreadsX;
constexpr int64_t kColRows = 64;       // rows per block in the column passes
constexpr int64_t kMaxBothRowsPerBlock = 32;

// amax >= 0, so its bit pattern orders like the float
__device__ __forceinline__ void atomic_max_nonneg(float* p, float v) {
  atomicMax(reinterpret_cast<unsigned int*>(p), __float_as_uint(v));
}

// Column absmax of rows [64 * blockIdx.y, +64) into amax[C] (zeroed before).
template <typename T>
__global__ void __launch_bounds__(kThreads)
col_absmax(const T* __restrict__ x, float* __restrict__ amax, int64_t R, int64_t C, bool vec) {
  constexpr int N = 16 / sizeof(T);
  __shared__ float part[kColThreadsY][kColThreadsX * N + 1];
  const int tx = threadIdx.x % kColThreadsX, ty = threadIdx.x / kColThreadsX;
  const int64_t c0 = (static_cast<int64_t>(blockIdx.x) * kColThreadsX + tx) * N;
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * kColRows;
  const int64_t r1 = r0 + kColRows < R ? r0 + kColRows : R;
  float m[N];
#pragma unroll
  for (int j = 0; j < N; ++j) m[j] = 0.0f;
  for (int64_t r = r0 + ty; r < r1 && c0 < C; r += kColThreadsY) {
    const T* xr = x + r * C + c0;
    if (vec) {  // C % N == 0: the whole vector is inside
      uint4 u = *reinterpret_cast<const uint4*>(xr);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < N; ++j) m[j] = fmaxf(m[j], fabsf(to_f32(e[j])));
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (c0 + j < C) m[j] = fmaxf(m[j], fabsf(to_f32(xr[j])));
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) part[ty][tx * N + j] = m[j];
  __syncthreads();
  if (ty == 0) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float v = part[0][tx * N + j];
#pragma unroll
      for (int y = 1; y < kColThreadsY; ++y) v = fmaxf(v, part[y][tx * N + j]);
      if (c0 + j < C && v > 0.0f) atomic_max_nonneg(amax + c0 + j, v);
    }
  }
}

// Cast rows [64 * blockIdx.y, +64) with the column scales amax / 127; the
// first row of blocks also stores the scales in x's dtype.
template <typename T, bool SR>
__global__ void __launch_bounds__(kThreads)
col_cast(const T* __restrict__ x, const float* __restrict__ amax, int8_t* __restrict__ q,
         T* __restrict__ scale, int64_t R, int64_t C, float eps, bool vec, uint64_t key) {
  constexpr int N = 16 / sizeof(T);
  using Pack = typename PackOf<N>::type;
  const int tx = threadIdx.x % kColThreadsX, ty = threadIdx.x / kColThreadsX;
  const int64_t c0 = (static_cast<int64_t>(blockIdx.x) * kColThreadsX + tx) * N;
  if (c0 >= C) return;  // no barrier below
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * kColRows;
  const int64_t r1 = r0 + kColRows < R ? r0 + kColRows : R;
  float denom[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float s = c0 + j < C ? __fdiv_rn(amax[c0 + j], 127.0f) : 0.0f;
    denom[j] = fmaxf(s, eps);
    if (blockIdx.y == 0 && ty == 0 && c0 + j < C) store_scale(scale + c0 + j, s);
  }
  for (int64_t r = r0 + ty; r < r1; r += kColThreadsY) {
    const T* xr = x + r * C + c0;
    int8_t* qr = q + r * C + c0;
    const uint64_t idx0 = r * C + c0;  // this vector's first index in the stream
    if (vec) {
      uint4 u = *reinterpret_cast<const uint4*>(xr);
      const T* e = reinterpret_cast<const T*>(&u);
      uint32_t w[N];
      vec_words<SR, N>(idx0, key, w);
      union {
        Pack p;
        int8_t c[N];
      } out;
#pragma unroll
      for (int j = 0; j < N; ++j) out.c[j] = quant_div<SR>(to_f32(e[j]), denom[j], w[j]);
      *reinterpret_cast<Pack*>(qr) = out.p;
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (c0 + j < C) qr[j] = quant_div<SR>(to_f32(xr[j]), denom[j], SR ? qt::philox_word(idx0 + j, key) : 0u);
    }
  }
}

// B5 pass 1: rows [rpb * blockIdx.x, +rpb), each quantized as K1's block
// path does, while colmax (dynamic shared memory, K floats) keeps each
// column's running max; merged into amax[K] once at the end. With ``vec``
// the thread owning vector i keeps column i * N + j at colmax[j * nv + i]
// (nv = K / N vectors), so a warp's shared-memory accesses hit distinct banks.
template <typename T, bool SR>
__global__ void __launch_bounds__(kThreads)
quantize_both_rows(const T* __restrict__ x, int8_t* __restrict__ q, T* __restrict__ scale,
                   float* __restrict__ amax, int64_t M, int64_t K, int64_t rpb, float eps, bool vec,
                   uint64_t key) {
  constexpr int N = 16 / sizeof(T);
  extern __shared__ float colmax[];
  __shared__ float part[2][kThreads / 32];
  const int64_t nv = K / N;
  for (int64_t i = threadIdx.x; i < K; i += kThreads) colmax[i] = 0.0f;
  __syncthreads();
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rpb;
  const int64_t r1 = r0 + rpb < M ? r0 + rpb : M;
  for (int64_t row = r0; row < r1; ++row) {
    const T* xr = x + row * K;
    float a = 0.0f;
    if (vec) {
      const uint4* xv = reinterpret_cast<const uint4*>(xr);
      for (int64_t i = threadIdx.x; i < nv; i += kThreads) {
        uint4 u = xv[i];
        const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const float v = fabsf(to_f32(e[j]));
          a = fmaxf(a, v);
          colmax[j * nv + i] = fmaxf(colmax[j * nv + i], v);
        }
      }
    } else {
      for (int64_t i = threadIdx.x; i < K; i += kThreads) {
        const float v = fabsf(to_f32(xr[i]));
        a = fmaxf(a, v);
        colmax[i] = fmaxf(colmax[i], v);
      }
    }
    // block max; ``part`` alternates between rows, so the next row's writes
    // never meet this row's reads
    float* pw = part[(row - r0) & 1];
    a = warp_max(a);
    if ((threadIdx.x & 31) == 0) pw[threadIdx.x >> 5] = a;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) a = fmaxf(a, pw[w]);
    const float s = __fdiv_rn(a, 127.0f);
    row_cast<T, kThreads, SR>(xr, q + row * K, K, vec, threadIdx.x, fmaxf(s, eps), row * K, key);
    if (threadIdx.x == 0) store_scale(scale + row, s);
  }
  __syncthreads();
  for (int64_t idx = threadIdx.x; idx < K; idx += kThreads) {
    const float v = colmax[idx];
    const int64_t col = vec ? (idx % nv) * N + idx / nv : idx;
    if (v > 0.0f) atomic_max_nonneg(amax + col, v);
  }
}

// ---- B5 on the vector path: the row pass and the column pass -------------

constexpr int kSlots = 4;           // 16-byte vectors of x a thread takes a row step
constexpr int kBothCtasPerSm = 2;   // the persistent grid of both passes

// A 16-byte vector of x as 4 words: its absolute values (the sign bits
// cleared, which orders non-negative floats like their unsigned bits), their
// elementwise max (two bf16 a word, or one fp32), the max of its values as
// fp32 bits, and element j's bits as an fp32 value.
template <typename T> struct Abs;
template <> struct Abs<__nv_bfloat16> {
  __device__ static uint4 of(uint4 u) {
    return make_uint4(u.x & 0x7FFF7FFFu, u.y & 0x7FFF7FFFu, u.z & 0x7FFF7FFFu, u.w & 0x7FFF7FFFu);
  }
  __device__ static uint4 max(uint4 a, uint4 b) {
    return make_uint4(__vmaxu2(a.x, b.x), __vmaxu2(a.y, b.y), __vmaxu2(a.z, b.z), __vmaxu2(a.w, b.w));
  }
  __device__ static unsigned int top(uint4 a) {
    const unsigned int m = __vmaxu2(__vmaxu2(a.x, a.y), __vmaxu2(a.z, a.w));
    return ::max(m >> 16, m & 0xFFFFu) << 16;
  }
  __device__ static unsigned int elem(uint4 a, int j) {
    const unsigned int w = j < 2 ? a.x : j < 4 ? a.y : j < 6 ? a.z : a.w;
    return j % 2 ? w & 0xFFFF0000u : w << 16;
  }
};
template <> struct Abs<float> {
  __device__ static uint4 of(uint4 u) {
    return make_uint4(u.x & 0x7FFFFFFFu, u.y & 0x7FFFFFFFu, u.z & 0x7FFFFFFFu, u.w & 0x7FFFFFFFu);
  }
  __device__ static uint4 max(uint4 a, uint4 b) {
    return make_uint4(::max(a.x, b.x), ::max(a.y, b.y), ::max(a.z, b.z), ::max(a.w, b.w));
  }
  __device__ static unsigned int top(uint4 a) { return ::max(::max(a.x, a.y), ::max(a.z, a.w)); }
  __device__ static unsigned int elem(uint4 a, int j) { return j == 0 ? a.x : j == 1 ? a.y : j == 2 ? a.z : a.w; }
};

// x / d rounded to nearest, as IEEE division rounds it, from y = RN(1 / d)
// and FMAs, with no division (a quarter-rate MUFU.RCP and its refinement an
// element) in the loop: q0 = RN(x y) lies within 1.5 ulp of x / d; one
// correction by the remainder x - d q0 makes it faithful, and a second
// gives RN(x / d) exactly (Markstein: for a faithful q and y within half an
// ulp of 1 / d, x - d q is exact and RN(q + (x - d q) y) = RN(x / d)). That
// needs no underflow: here |x / d| <= 127 (d >= the absmax of x's row or
// column / 127) and d >= eps, so the remainder is exact wherever |x / d| >=
// 2^-48, and a smaller quotient casts to the same int8 whatever its last bit.
__device__ __forceinline__ float div_rn(float x, float d, float y) {
  float q = __fmul_rn(x, y);
  q = __fmaf_rn(__fmaf_rn(-d, q, x), y, q);
  return __fmaf_rn(__fmaf_rn(-d, q, x), y, q);
}

// The int8 cast of a 16-byte vector starting at element idx0 of the stream
// (a multiple of 4), element j by its own (d, 1 / d) = dy(j), stored
// evict-first.
template <typename T, bool SR, typename DY>
__device__ __forceinline__ void cast_vec(uint4 u, DY dy, uint64_t idx0, uint64_t key, int8_t* __restrict__ q) {
  constexpr int N = 16 / sizeof(T);
  const T* e = reinterpret_cast<const T*>(&u);
  uint32_t w[N], b[N];
  vec_words<SR, N>(idx0, key, w);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float2 f = dy(j);
    const float v = div_rn(to_f32(e[j]), f.x, f.y);
    b[j] = SR ? byte_sr(v, w[j]) : byte_rn(v);
  }
  if constexpr (N == 8) {
    __stcs(reinterpret_cast<uint2*>(q), make_uint2(pack4(b[0], b[1], b[2], b[3]), pack4(b[4], b[5], b[6], b[7])));
  } else {
    __stcs(reinterpret_cast<unsigned int*>(q), pack4(b[0], b[1], b[2], b[3]));
  }
}

// A scale's (d, 1 / d): d = max(scale, eps), the reciprocal rounded to nearest
__device__ __forceinline__ float2 denom_of(float s, float eps) {
  const float d = fmaxf(s, eps);
  return make_float2(d, __frcp_rn(d));
}

// The body the row pass of B5 and K1's row walk share. row_top: the max |x|
// of a row over this thread's P vectors of it, as fp32 bits; with COLS the
// thread's running column maxima cm (packed as x) take the vectors too.
template <typename T, bool COLS, int P>
__device__ __forceinline__ unsigned int row_top(const uint4 (&u)[P], uint4 (&cm)[P]) {
  unsigned int m = 0u;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const uint4 a = Abs<T>::of(u[p]);
    if constexpr (COLS) cm[p] = Abs<T>::max(cm[p], a);
    m = ::max(m, Abs<T>::top(a));
  }
  return m;
}

// cast_row: row ``row``'s int8 cast from its vectors in registers (thread t
// of the row's tpr holds vector t + p tpr, p < P; one past the row's nv
// vectors is skipped) given the row's max |x| bits: s = amax / 127 (IEEE
// division), each element by div_rn and the one-add cast (cast_vec), and s
// stored in x's dtype by thread 0.
template <typename T, bool SR, int P>
__device__ __forceinline__ void cast_row(const uint4 (&u)[P], unsigned int amax, int64_t row, int64_t K, int t,
                                         int tpr, float eps, uint64_t key, int8_t* __restrict__ q,
                                         T* __restrict__ scale) {
  constexpr int N = 16 / sizeof(T);
  const int64_t nv = K / N;
  const float s = __fdiv_rn(__uint_as_float(amax), 127.0f);
  const float2 dy = denom_of(s, eps);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int64_t v = t + static_cast<int64_t>(p) * tpr;
    if (v < nv) cast_vec<T, SR>(u[p], [&](int) { return dy; }, row * K + v * N, key, q + row * K + v * N);
  }
  if (t == 0) store_scale(scale + row, s);
}

// The row steps of both passes: step i is rows [G i, G i + G), taken by a
// group of TPR threads; thread t of the group holds vector t + p TPR of each
// of its G rows (p < 4 / G).
template <int TPR, int G>
struct BothWalk {
  static constexpr int kVpl = kSlots / G, kGroups = kThreads / TPR, kWarps = TPR / 32;
  static_assert(kSlots % G == 0 && TPR % 32 == 0 && kThreads % TPR == 0 && (G == 1 || TPR == 32),
                "whole rows a group, 4 vectors a thread");
  int grp, t;
  __device__ BothWalk() : grp(threadIdx.x / TPR), t(threadIdx.x % TPR) {}
  __device__ int64_t first() const { return static_cast<int64_t>(blockIdx.x) * kGroups + grp; }
  __device__ int64_t stride() const { return static_cast<int64_t>(gridDim.x) * kGroups; }
  // the vectors of rows step * G .. + G - 1 (zero past the edge)
  template <bool kLast>
  __device__ void load(const uint4* __restrict__ xv, int64_t step, int64_t M, int64_t nv, uint4 (&u)[G][kVpl]) const {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int p = 0; p < kVpl; ++p) {
        const int64_t row = step * G + g, v = t + p * TPR;
        const uint4* src = xv + row * nv + v;
        u[g][p] = row < M && v < nv ? (kLast ? __ldcs(src) : *src) : make_uint4(0u, 0u, 0u, 0u);
      }
  }
  // body(step, u) on each of the group's row steps in turn (kReverse: counted
  // from the last step, with the column pass's evict-first loads), u the
  // step's vectors: the next step's are loaded before the body runs on this
  // step's, so that every warp has loads in flight while it computes
  // (ab_sm90_forms.py's b5_load_after loads after it)
  template <bool kReverse, class Body>
  __device__ void for_steps(const uint4* __restrict__ xv, int64_t M, int64_t nv, Body&& body) const {
    const int64_t steps = (M + G - 1) / G;
    const auto at = [&](int64_t i) { return kReverse ? steps - 1 - i : i; };
    uint4 a[G][kVpl], b[G][kVpl];
    int64_t i = first();
    if (i < steps) load<kReverse>(xv, at(i), M, nv, a);
    while (i < steps) {
      const int64_t j = i + stride();
      if (j < steps) load<kReverse>(xv, at(j), M, nv, b);
      body(at(i), a);
      if (j >= steps) break;
      i = j + stride();
      if (i < steps) load<kReverse>(xv, at(i), M, nv, a);
      body(at(j), b);
    }
  }
};

// The row pass: q_row and s_row, and the CTA's column maxima, packed as x is
// (16 bytes a vector), to row blockIdx.x of ``parts`` [gridDim.x][nv]: the
// front of q_col, which the column pass reads before it writes q_col.
// Dynamic shared memory: each group's column maxima, where its threads leave
// them at the end (plain stores of consecutive vectors, free of bank
// conflicts) for the CTA to merge.
template <typename T, bool SR, int TPR, int G>
__global__ void __launch_bounds__(kThreads, kBothCtasPerSm)
quantize_both_row_pass(const T* __restrict__ x, int8_t* __restrict__ q, T* __restrict__ scale,
                       uint4* __restrict__ parts, int64_t M, int64_t K, float eps, uint64_t key) {
  using W = BothWalk<TPR, G>;
  constexpr int N = 16 / sizeof(T), VPL = W::kVpl, WARPS = W::kWarps;
  extern __shared__ uint4 group_colmax[];  // [groups][nv]
  // the row maxima of a group's warps, alternating between steps, so that one
  // step's writes never meet the last one's reads
  __shared__ unsigned int part[2][W::kGroups][WARPS][G];
  const W walk;
  const int64_t nv = K / N;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4 cm[VPL];
#pragma unroll
  for (int p = 0; p < VPL; ++p) cm[p] = make_uint4(0u, 0u, 0u, 0u);
  int parity = 0;
  walk.template for_steps<false>(xv, M, nv, [&](int64_t step, const uint4 (&u)[G][VPL]) {
    unsigned int rmax[G];
#pragma unroll
    for (int g = 0; g < G; ++g) rmax[g] = __reduce_max_sync(0xFFFFFFFFu, row_top<T, true>(u[g], cm));
    if constexpr (WARPS > 1) {
      const int warp = walk.t / 32;
      if (walk.t % 32 == 0)
#pragma unroll
        for (int g = 0; g < G; ++g) part[parity][walk.grp][warp][g] = rmax[g];
      asm volatile("bar.sync %0, %1;" ::"r"(1 + walk.grp), "r"(TPR) : "memory");
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int w = 0; w < WARPS; ++w) rmax[g] = ::max(rmax[g], part[parity][walk.grp][w][g]);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int64_t row = step * G + g;
      if (row >= M) break;
      cast_row<T, SR>(u[g], rmax[g], row, K, walk.t, TPR, eps, key, q, scale);
    }
    parity ^= 1;
  });
#pragma unroll
  for (int p = 0; p < VPL; ++p) {
    const int64_t v = walk.t + p * TPR;
    if (v < nv) group_colmax[walk.grp * nv + v] = cm[p];
  }
  __syncthreads();
  for (int64_t v = threadIdx.x; v < nv; v += kThreads) {
    uint4 m = group_colmax[v];
#pragma unroll
    for (int g = 1; g < W::kGroups; ++g) m = Abs<T>::max(m, group_colmax[g * nv + v]);
    parts[blockIdx.x * nv + v] = m;
  }
}

// The column pass, launched cooperatively: first the grid reduces the row
// pass's R rows of column maxima (``parts``) into amax and s_col, S lanes of
// a warp a vector, each taking every S-th row; then, after a grid-wide
// barrier, it casts q_col (over ``parts``) from the column scales, the row
// steps in the reverse of the row pass's order. Dynamic shared memory: each
// column's (d, 1 / d), element j of vector v at j nv + v, so that a warp's
// lanes (consecutive vectors) read consecutive pairs, where a vector's pairs
// side by side (ab_sm90_forms.py's b5_dy_by_vector) make lanes 64 bytes
// apart and conflict on the banks.
//
// MODE kMaxima (B5's maxima form): the reduction alone, amax written and no
// scale; kGiven (its given form): the cast alone, from the caller's amax,
// CTA 0 storing s_col. Neither meets at the grid barrier, so both launch as
// plain kernels.
template <typename T, bool SR, int TPR, int G, int MODE>
__global__ void __launch_bounds__(kThreads, kBothCtasPerSm)
quantize_both_col_pass(const T* __restrict__ x, const uint4* parts, int R, float* __restrict__ amax, int8_t* q,
                       T* __restrict__ scale, int64_t M, int64_t K, float eps, uint64_t key) {
  using W = BothWalk<TPR, G>;
  constexpr int N = 16 / sizeof(T), VPL = W::kVpl;
  extern __shared__ float2 col_dy[];
  const W walk;
  const int64_t nv = K / N;
  if constexpr (MODE != kGiven) {
    const int64_t threads = static_cast<int64_t>(gridDim.x) * kThreads;
    const int lane = threadIdx.x % 32;
    int S = 32;
    while (S > 1 && nv * S > threads) S >>= 1;
    for (int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x - lane; base < nv * S;
         base += threads) {  // whole warps, for the shuffles
      const int64_t i = base + lane, v = i / S;
      uint4 m = make_uint4(0u, 0u, 0u, 0u);
      if (i < nv * S)
        for (int64_t r = i % S; r < R; r += 4 * S) {  // 4 loads in flight
          uint4 w[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) w[k] = r + k * S < R ? parts[(r + k * S) * nv + v] : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
          for (int k = 0; k < 4; ++k) m = Abs<T>::max(m, w[k]);
        }
      for (int off = S / 2; off > 0; off >>= 1)
        m = Abs<T>::max(m, make_uint4(__shfl_xor_sync(0xFFFFFFFFu, m.x, off), __shfl_xor_sync(0xFFFFFFFFu, m.y, off),
                                      __shfl_xor_sync(0xFFFFFFFFu, m.z, off), __shfl_xor_sync(0xFFFFFFFFu, m.w, off)));
      if (i < nv * S && i % S == 0)
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const float a = __uint_as_float(Abs<T>::elem(m, j));
          amax[v * N + j] = a;
          if constexpr (MODE == kWhole) store_scale(scale + v * N + j, __fdiv_rn(a, 127.0f));
        }
    }
  }
  if constexpr (MODE == kMaxima) return;
  if constexpr (MODE == kWhole) cooperative_groups::this_grid().sync();
  for (int64_t c = threadIdx.x; c < K; c += kThreads) {
    const float s = __fdiv_rn(__ldcg(amax + c), 127.0f);
    col_dy[(c % N) * nv + c / N] = denom_of(s, eps);
    if (MODE == kGiven && blockIdx.x == 0) store_scale(scale + c, s);
  }
  __syncthreads();
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  walk.template for_steps<true>(xv, M, nv, [&](int64_t step, const uint4 (&u)[G][VPL]) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int64_t row = step * G + g;
      if (row >= M) break;
#pragma unroll
      for (int p = 0; p < VPL; ++p) {
        const int64_t v = walk.t + p * TPR;
        if (v >= nv) continue;
        float2 dy[N];
#pragma unroll
        for (int j = 0; j < N; ++j) dy[j] = col_dy[j * nv + v];
        cast_vec<T, SR>(u[g][p], [&](int j) { return dy[j]; }, row * K + v * N, key, q + row * K + v * N);
      }
    }
  });
}

// The grids of B5's two passes: the row pass's R CTAs (each leaving its K
// column maxima, K sizeof(T) bytes, in an M K byte buffer), the column pass's
// CTAs, and its dynamic shared memory (each column's (d, 1 / d): 64 KB at
// 1024 vectors of bf16), its limit raised for ``cols`` where it needs more.
struct BothGrid {
  int R;
  unsigned int col_ctas;
  size_t row_smem, col_smem;
};

template <typename T, int TPR, int G>
cudaError_t both_grid(const void* cols, int64_t M, int64_t K, BothGrid& g) {
  constexpr int64_t groups = BothWalk<TPR, G>::kGroups;
  // the groups' packed column maxima (16 KB: 4 vectors a thread)
  g.row_smem = static_cast<size_t>(groups * K) * sizeof(T);
  g.col_smem = static_cast<size_t>(K) * 8;
  cudaError_t err = cudaSuccess;
  if (cols != nullptr && g.col_smem > 48 * 1024)
    err = cudaFuncSetAttribute(cols, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(g.col_smem));
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int64_t needed = ((M + G - 1) / G + groups - 1) / groups;
  g.col_ctas = static_cast<unsigned int>(std::min<int64_t>(needed, kBothCtasPerSm * sms));
  g.R = static_cast<int>(std::min<int64_t>({needed, kBothCtasPerSm * sms, M / static_cast<int64_t>(sizeof(T))}));
  return cudaSuccess;
}

template <typename T, bool SR, int TPR, int G>
cudaError_t launch_both_passes(const T* x, void* q_row, void* s_row, void* q_col, void* s_col, float* amax,
                               int64_t M, int64_t K, float eps, uint64_t key_row, uint64_t key_col,
                               cudaStream_t stream) {
  const auto rows = quantize_both_row_pass<T, SR, TPR, G>;
  const auto cols = quantize_both_col_pass<T, SR, TPR, G, kWhole>;
  BothGrid g;
  cudaError_t err = both_grid<T, TPR, G>(reinterpret_cast<const void*>(cols), M, K, g);
  if (err != cudaSuccess) return err;
  int R = g.R;
  uint4* parts = static_cast<uint4*>(q_col);  // the front of q_col, which the column pass writes last
  rows<<<R, kThreads, g.row_smem, stream>>>(x, static_cast<int8_t*>(q_row), static_cast<T*>(s_row), parts, M, K,
                                            eps, key_row);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // a cooperative launch (its CTAs meet at a grid barrier) through
  // cudaLaunchKernelEx's attribute, the form a CUDA graph capture records
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.col_ctas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = g.col_smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, cols, x, static_cast<const uint4*>(parts), R, amax, static_cast<int8_t*>(q_col),
                            static_cast<T*>(s_col), M, K, eps, key_col);
}

// B5's maxima form on the vector path: the row pass, its parts in the M K
// bytes of ``parts``, then the column pass's reduction of them into amax
template <typename T, bool SR, int TPR, int G>
cudaError_t launch_both_maxima(const T* x, void* q_row, void* s_row, void* parts, float* amax, int64_t M,
                               int64_t K, float eps, uint64_t key_row, cudaStream_t stream) {
  BothGrid g;
  cudaError_t err = both_grid<T, TPR, G>(nullptr, M, K, g);
  if (err != cudaSuccess) return err;
  uint4* p = static_cast<uint4*>(parts);
  quantize_both_row_pass<T, SR, TPR, G><<<g.R, kThreads, g.row_smem, stream>>>(
      x, static_cast<int8_t*>(q_row), static_cast<T*>(s_row), p, M, K, eps, key_row);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  quantize_both_col_pass<T, SR, TPR, G, kMaxima><<<g.col_ctas, kThreads, 0, stream>>>(x, p, g.R, amax, nullptr,
                                                                                      nullptr, M, K, eps, 0);
  return cudaGetLastError();
}

// B5's given form on the vector path: the column pass's cast from amax
template <typename T, bool SR, int TPR, int G>
cudaError_t launch_both_given(const T* x, void* q_col, void* s_col, float* amax, int64_t M, int64_t K, float eps,
                              uint64_t key_col, cudaStream_t stream) {
  const auto cols = quantize_both_col_pass<T, SR, TPR, G, kGiven>;
  BothGrid g;
  cudaError_t err = both_grid<T, TPR, G>(reinterpret_cast<const void*>(cols), M, K, g);
  if (err != cudaSuccess) return err;
  cols<<<g.col_ctas, kThreads, g.col_smem, stream>>>(x, nullptr, 0, amax, static_cast<int8_t*>(q_col),
                                                     static_cast<T*>(s_col), M, K, eps, key_col);
  return cudaGetLastError();
}

// ---- B4 on thread-block clusters ------------------------------------------

template <typename T>
bool vec_ok(const void* x, int64_t cols) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0 && cols % (16 / sizeof(T)) == 0;
}

// ---- K1 on the persistent row walk ------------------------------------------

// K1's walk (the route ops/int8_quant.py::rowwise_sm90_route picks its
// threads a row, tpr): a group of tpr threads (whole warps) takes a row, V
// 16-byte vectors a thread with tpr V the row's vectors: V = 4 at 32-256
// threads (bf16 K 1024-8192, the Llama2-1B weights' 2048 with 64), else 3
// (bf16 K 1536: 64), else 2 up to 384 (bf16 K 5632: 352, one group a CTA).
// The row is read once, into registers, and the next row's loads are in
// flight while the group casts this one (RowWalk); its max is a warp
// reduction, then an exchange of the group's warps' maxima in shared words
// (alternating between rows, so one named barrier a row suffices); the
// cast, the scale and the SR words are B5's row pass's (row_top, cast_row),
// so q and the scale are the first design's bit for bit. Two CTAs an SM.
constexpr int kRowWalkCtasPerSm = 2;

template <int V>
__host__ __device__ constexpr int row_walk_max_cta() { return V == 2 ? 384 : kThreads; }

template <typename T, bool SR, int V, int MODE>
__global__ void __launch_bounds__(row_walk_max_cta<V>(), kRowWalkCtasPerSm)
quantize_rows_walk(const T* __restrict__ x, int8_t* __restrict__ q, T* __restrict__ scale, float* __restrict__ amax,
                   int64_t M, int64_t K, int tpr, float eps, uint64_t key) {
  __shared__ unsigned int red[2][row_walk_max_cta<V>() / 32];  // each warp's row max bits, by row parity
  const RowWalk<V, 1> walk(tpr);
  const int warps = tpr / 32, warp = threadIdx.x / 32;
  constexpr int N = 16 / sizeof(T);
  const int64_t nv = K / N;
  const uint4* const in[1] = {reinterpret_cast<const uint4*>(x)};
  uint4 no_cols[V];  // K1 keeps no column state
  int parity = 0;
  walk.run(in, M, nv, [&](int64_t row, const uint4 (&u)[1][V]) {
    unsigned int m;
    if constexpr (MODE == kGiven) {
      m = __float_as_uint(amax[row]);
    } else {
      m = __reduce_max_sync(0xFFFFFFFFu, row_top<T, false>(u[0], no_cols));
      if (warps > 1) {
        if (threadIdx.x % 32 == 0) red[parity][warp] = m;
        group_sync(walk.grp, tpr);
        for (int w = walk.grp * warps; w < (walk.grp + 1) * warps; ++w) m = ::max(m, red[parity][w]);
        parity ^= 1;
      }
      if constexpr (MODE == kMaxima) {
        if (walk.t == 0) amax[row] = __uint_as_float(m);
        return;
      }
    }
    cast_row<T, SR>(u[0], m, row, K, walk.t, tpr, eps, key, q, scale);
  });
}

// K1's walk at tpr threads a row over ctas CTAs of max(tpr, 256) threads;
// refuses a layout the kernels do not have
template <typename T, bool SR, int MODE = kWhole>
cudaError_t launch_rows_walk(const void* x, void* q, void* scale, float* amax, int64_t M, int64_t K, int tpr,
                             int64_t ctas, float eps, uint64_t key, cudaStream_t stream) {
  constexpr int N = 16 / sizeof(T);
  const int64_t nv = K / N;
  const int cta = tpr > kThreads ? tpr : kThreads;
  const int V = tpr > 0 && tpr % 32 == 0 && cta % tpr == 0 && nv % tpr == 0 ? static_cast<int>(nv / tpr) : 0;
  const bool fits = V == 2 ? cta <= row_walk_max_cta<2>() : (V == 3 || V == 4) && cta == kThreads;
  if (!vec_ok<T>(x, K) || !fits || ctas <= 0) return cudaErrorInvalidValue;
  const auto kernel = V == 4 ? quantize_rows_walk<T, SR, 4, MODE>
                      : V == 3 ? quantize_rows_walk<T, SR, 3, MODE>
                               : quantize_rows_walk<T, SR, 2, MODE>;
  kernel<<<static_cast<unsigned int>(ctas), cta, 0, stream>>>(static_cast<const T*>(x), static_cast<int8_t*>(q),
                                                              static_cast<T*>(scale), amax, M, K, tpr, eps, key);
  return cudaGetLastError();
}


constexpr int kClusterMaxStrip = 16;  // vectors of a strip's row, at most
constexpr int kClusterThreads = 256;  // a CTA's threads
constexpr int kClusterCtasPerSm = 3;  // CTAs an SM its launch bounds keep resident (85 registers)

// 16 bytes from global to shared memory, asynchronously (cp.async, L2 only)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(static_cast<unsigned int>(__cvta_generic_to_shared(smem))),
               "l"(gmem)
               : "memory");
}

// B4 in one launch: a cluster of cs CTAs takes a strip of sv 16-byte vectors
// of every row (blockIdx.x / cs), CTA rank k of it rows [k rpc, (k + 1) rpc),
// rpc = ceil(R / cs). Each CTA copies its tile of x into shared memory at
// once (cp.async: every vector of the tile in flight, no registers held),
// then each thread takes the maxima of its vector's columns over its rows
// there (packed like x, as B5's row pass); the CTA merges its threads'
// maxima, the cluster merges its CTAs' through distributed shared memory
// after one cluster barrier, and each CTA casts its tile from shared memory
// with every column's (d, 1 / d). A thread reads back only the tile entries
// it copied, so the tile needs no barrier. Rank 0 stores the scales.
// Dynamic shared memory: the tile [rpc][sv].
template <typename T, bool SR>
__global__ void __launch_bounds__(kClusterThreads, kClusterCtasPerSm)
quantize_cols_cluster(const T* __restrict__ x, int8_t* __restrict__ q, T* __restrict__ scale, int64_t R, int64_t C,
                      int sv, float eps, uint64_t key) {
  constexpr int N = 16 / sizeof(T);
  extern __shared__ uint4 tile[];
  __shared__ uint4 warp_max[kClusterThreads / 32][kClusterMaxStrip];  // each warp's column maxima
  __shared__ uint4 cta_max[kClusterMaxStrip];  // this CTA's, which the cluster's CTAs read
  __shared__ uint4 col_max[kClusterMaxStrip];  // the cluster's
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks()), rank = static_cast<int>(cluster.block_rank());
  const int64_t nv = C / N, rpc = (R + cs - 1) / cs;
  const int64_t r0 = rank * rpc, r1 = r0 + rpc < R ? r0 + rpc : R;
  const int v = threadIdx.x % sv, step = kClusterThreads / sv;  // this thread's vector of the strip; rows a pass
  const int64_t cv = static_cast<int64_t>(blockIdx.x / cs) * sv + v;  // its vector of the row
  const bool in = cv < nv;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const int64_t first = r0 + threadIdx.x / sv;  // this thread's rows: first, first + step, ...
  if (in)
    for (int64_t r = first; r < r1; r += step) cp_async16(tile + (r - r0) * sv + v, xv + r * nv + cv);
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
  uint4 m = make_uint4(0u, 0u, 0u, 0u);
  if (in)
#pragma unroll 4
    for (int64_t r = first; r < r1; r += step) m = Abs<T>::max(m, Abs<T>::of(tile[(r - r0) * sv + v]));
  // the CTA's maxima: lanes l and l + sv hold the same vector
  for (int off = sv; off < 32; off <<= 1)
    m = Abs<T>::max(m, make_uint4(__shfl_xor_sync(0xFFFFFFFFu, m.x, off), __shfl_xor_sync(0xFFFFFFFFu, m.y, off),
                                  __shfl_xor_sync(0xFFFFFFFFu, m.z, off), __shfl_xor_sync(0xFFFFFFFFu, m.w, off)));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane < sv) warp_max[warp][lane] = m;
  __syncthreads();
  if (threadIdx.x < sv) {
    uint4 c = warp_max[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kClusterThreads / 32; ++w) c = Abs<T>::max(c, warp_max[w][threadIdx.x]);
    cta_max[threadIdx.x] = c;
  }
  cluster.sync();  // every CTA's maxima are written and visible to the cluster
  if (threadIdx.x < sv) {
    uint4 c = make_uint4(0u, 0u, 0u, 0u);
    for (int k = 0; k < cs; ++k) c = Abs<T>::max(c, cluster.map_shared_rank(cta_max, k)[threadIdx.x]);
    col_max[threadIdx.x] = c;
    if (rank == 0 && in)
#pragma unroll
      for (int j = 0; j < N; ++j) store_scale(scale + cv * N + j, __fdiv_rn(__uint_as_float(Abs<T>::elem(c, j)), 127.0f));
  }
  // the cluster barrier in two halves: arrive (release) after this CTA's last
  // read of a peer's shared memory, wait (acquire) before it exits, so that
  // no CTA's shared memory is freed while a peer still reads it
  __cluster_barrier_arrive();
  __syncthreads();
  float2 dy[N];
  const uint4 c = col_max[v];
#pragma unroll
  for (int j = 0; j < N; ++j) dy[j] = denom_of(__fdiv_rn(__uint_as_float(Abs<T>::elem(c, j)), 127.0f), eps);
  if (in)
#pragma unroll 2
    for (int64_t r = first; r < r1; r += step)
      cast_vec<T, SR>(tile[(r - r0) * sv + v], [&](int j) { return dy[j]; }, r * C + cv * N, key, q + r * C + cv * N);
  __cluster_barrier_wait();
}

// The static shared memory of a CTA of B4's cluster form (2.5 KB), and the
// largest tile it may take beside it within the 227 KB a block may use
constexpr size_t kClusterStatic = (kClusterThreads / 32 + 2) * kClusterMaxStrip * sizeof(uint4);
constexpr size_t kClusterMaxTile = 222 * 1024;
static_assert(kClusterMaxTile + kClusterStatic <= 227 * 1024, "B4's tile and statics exceed a block's shared memory");

// B4's cluster form: sv vectors a strip (4, 8 or 16), cs CTAs a cluster (at
// most 8, the portable size), the tile of ceil(R / cs) rows within
// kClusterMaxTile (ops/int8_quant.py::colwise_sm90_route checks the same).
template <typename T, bool SR>
cudaError_t launch_cols_cluster(const void* x, void* q, void* scale, int64_t R, int64_t C, int sv, int cs,
                                float eps, uint64_t key, cudaStream_t stream) {
  constexpr int N = 16 / sizeof(T);
  const int64_t nv = C / N, rpc = (R + cs - 1) / cs;
  const size_t smem = static_cast<size_t>(rpc) * sv * sizeof(uint4);
  if (!vec_ok<T>(x, C) || !(sv == 4 || sv == 8 || sv == 16) || cs < 1 || cs > 8 || smem > kClusterMaxTile)
    return cudaErrorInvalidValue;
  const auto kernel = quantize_cols_cluster<T, SR>;
  // the default 48 KB limit counts the static arrays too: ViT-Giant's fc2
  // weight [1536, 6144] takes a 48 KB tile
  cudaError_t err = cudaSuccess;
  if (smem + kClusterStatic > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned int>(cs);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>((nv + sv - 1) / sv * cs));
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), static_cast<int8_t*>(q), static_cast<T*>(scale), R,
                            C, sv, eps, key);
}

template <typename T>
dim3 col_grid(int64_t R, int64_t C) {
  constexpr int N = 16 / sizeof(T);
  const int64_t cols = (C + kColThreadsX * N - 1) / (kColThreadsX * N);
  const int64_t rows = std::max<int64_t>(1, (R + kColRows - 1) / kColRows);
  return dim3(static_cast<unsigned int>(cols), static_cast<unsigned int>(rows));
}

template <typename T, bool SR>
cudaError_t launch_colwise(const void* x, void* q, void* scale, float* amax, int64_t R, int64_t C,
                           float eps, uint64_t key, cudaStream_t stream) {
  const bool vec = vec_ok<T>(x, C);
  const T* xt = static_cast<const T*>(x);
  cudaError_t err = cudaMemsetAsync(amax, 0, C * sizeof(float), stream);
  if (err != cudaSuccess) return err;
  col_absmax<T><<<col_grid<T>(R, C), kThreads, 0, stream>>>(xt, amax, R, C, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  col_cast<T, SR><<<col_grid<T>(R, C), kThreads, 0, stream>>>(xt, amax, static_cast<int8_t*>(q),
                                                              static_cast<T*>(scale), R, C, eps, vec, key);
  return cudaGetLastError();
}

// The vector path of B5 (and of its forms): x aligned, K a whole number of
// at most 1024 vectors, and room for the row pass's parts
template <typename T>
bool both_vec_path(const void* x, int64_t M, int64_t K) {
  return vec_ok<T>(x, K) && K / (16 / sizeof(T)) <= 1024 && M >= static_cast<int64_t>(sizeof(T));
}

// FN's instantiation for the row pass's threads a row: the fewest that hold
// a row of nv vectors in 4 vectors each
#define QT_BOTH_WALK(FN, nv, ...)                                                                   \
  ((nv) <= 32    ? FN<T, SR, 32, 4>(__VA_ARGS__)                                                    \
   : (nv) <= 64  ? FN<T, SR, 32, 2>(__VA_ARGS__)                                                    \
   : (nv) <= 128 ? FN<T, SR, 32, 1>(__VA_ARGS__)                                                    \
   : (nv) <= 256 ? FN<T, SR, 64, 1>(__VA_ARGS__)                                                    \
   : (nv) <= 512 ? FN<T, SR, 128, 1>(__VA_ARGS__)                                                   \
                 : FN<T, SR, 256, 1>(__VA_ARGS__))

// The first design's row half of B5: amax zeroed, then K1's block-per-row
// quantize over runs of rows that merges the column maxima into it
template <typename T, bool SR>
cudaError_t launch_both_rows_first(const T* xt, void* q_row, void* s_row, float* amax, int64_t M, int64_t K,
                                   float eps, bool vec, uint64_t key_row, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(amax, 0, K * sizeof(float), stream);
  if (err != cudaSuccess) return err;
  // a run of rows per block amortises the colmax merge; about two blocks per SM
  const int64_t rpb = std::min<int64_t>(kMaxBothRowsPerBlock, std::max<int64_t>(1, M / 264));
  const size_t smem = static_cast<size_t>(K) * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(quantize_both_rows<T, SR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const unsigned int blocks = static_cast<unsigned int>((M + rpb - 1) / rpb);
  quantize_both_rows<T, SR><<<blocks, kThreads, smem, stream>>>(
      xt, static_cast<int8_t*>(q_row), static_cast<T*>(s_row), amax, M, K, rpb, eps, vec, key_row);
  return cudaGetLastError();
}

template <typename T, bool SR>
cudaError_t launch_both(const void* x, void* q_row, void* s_row, void* q_col, void* s_col,
                        float* amax, int64_t M, int64_t K, float eps, uint64_t key_row, uint64_t key_col,
                        cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const int64_t nv = K / (16 / sizeof(T));
  if (both_vec_path<T>(x, M, K))
    return QT_BOTH_WALK(launch_both_passes, nv, xt, q_row, s_row, q_col, s_col, amax, M, K, eps, key_row, key_col,
                        stream);
  const bool vec = vec_ok<T>(x, K);
  cudaError_t err = launch_both_rows_first<T, SR>(xt, q_row, s_row, amax, M, K, eps, vec, key_row, stream);
  if (err != cudaSuccess) return err;
  col_cast<T, SR><<<col_grid<T>(M, K), kThreads, 0, stream>>>(xt, amax, static_cast<int8_t*>(q_col),
                                                              static_cast<T*>(s_col), M, K, eps, vec, key_col);
  return cudaGetLastError();
}

// ---- the mesh forms (the header's "mesh forms") ----------------------------

// B5's maxima form: q_row, s_row and the column maxima in amax; ``parts`` is
// M K bytes of scratch (the vector path's CTA maxima)
template <typename T, bool SR>
cudaError_t launch_both_maxima_form(const void* x, void* q_row, void* s_row, void* parts, float* amax, int64_t M,
                                    int64_t K, float eps, uint64_t key_row, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const int64_t nv = K / (16 / sizeof(T));
  if (both_vec_path<T>(x, M, K))
    return QT_BOTH_WALK(launch_both_maxima, nv, xt, q_row, s_row, parts, amax, M, K, eps, key_row, stream);
  return launch_both_rows_first<T, SR>(xt, q_row, s_row, amax, M, K, eps, vec_ok<T>(x, K), key_row, stream);
}

// The given form of a column quantize (B4's and B5's): q_col and s_col from
// the column maxima in amax
template <typename T, bool SR>
cudaError_t launch_cols_given_form(const void* x, void* q_col, void* s_col, float* amax, int64_t M, int64_t K,
                                   float eps, uint64_t key_col, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const int64_t nv = K / (16 / sizeof(T));
  if (both_vec_path<T>(x, M, K))
    return QT_BOTH_WALK(launch_both_given, nv, xt, q_col, s_col, amax, M, K, eps, key_col, stream);
  col_cast<T, SR><<<col_grid<T>(M, K), kThreads, 0, stream>>>(xt, amax, static_cast<int8_t*>(q_col),
                                                              static_cast<T*>(s_col), M, K, eps, vec_ok<T>(x, K),
                                                              key_col);
  return cudaGetLastError();
}

// B4's maxima form: col_absmax into amax, zeroed first
template <typename T>
cudaError_t launch_cols_maxima(const void* x, float* amax, int64_t R, int64_t C, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(amax, 0, C * sizeof(float), stream);
  if (err != cudaSuccess) return err;
  col_absmax<T><<<col_grid<T>(R, C), kThreads, 0, stream>>>(static_cast<const T*>(x), amax, R, C, vec_ok<T>(x, C));
  return cudaGetLastError();
}

// The four (dtype, SR) instantiations of a launcher, picked at run time.
#define QT_DISPATCH(LAUNCH, is_bf16, sr, ...)                              \
  ((is_bf16) ? ((sr) ? LAUNCH<__nv_bfloat16, true>(__VA_ARGS__)          \
                     : LAUNCH<__nv_bfloat16, false>(__VA_ARGS__))        \
             : ((sr) ? LAUNCH<float, true>(__VA_ARGS__) : LAUNCH<float, false>(__VA_ARGS__)))

// The same for a form of K1 (kMaxima, kGiven)
#define QT_DISPATCH_FORM(LAUNCH, FORM, is_bf16, sr, ...)                            \
  ((is_bf16) ? ((sr) ? LAUNCH<__nv_bfloat16, true, FORM>(__VA_ARGS__)              \
                     : LAUNCH<__nv_bfloat16, false, FORM>(__VA_ARGS__))            \
             : ((sr) ? LAUNCH<float, true, FORM>(__VA_ARGS__) : LAUNCH<float, false, FORM>(__VA_ARGS__)))

}  // namespace

// Every entry point returns the launch's cudaError_t (0 on success).
// is_bf16: x and the scales are bf16, else fp32. sr: round stochastically
// from the Philox stream of ``key`` (philox.cuh), else to nearest even.

// x and q are contiguous [M, K]; scale is [M]. tpr, ctas
// (ops/int8_quant.py::rowwise_sm90_route): tpr 0 takes the first design
// (quantize_rows_block, quantize_rows_warp); else the row walk at tpr
// threads a row over ctas CTAs (x 16-byte aligned, K a whole number of
// vectors).
extern "C" int qt_quantize_int8_rowwise(const void* x, void* q, void* scale, int64_t M, int64_t K, float eps,
                                        int is_bf16, int sr, uint64_t key, int tpr, int64_t ctas, void* stream) {
  if (M <= 0 || K <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tpr != 0)
    return static_cast<int>(
        QT_DISPATCH(launch_rows_walk, is_bf16, sr, x, q, scale, nullptr, M, K, tpr, ctas, eps, key, s));
  return static_cast<int>(QT_DISPATCH(launch, is_bf16, sr, x, q, scale, nullptr, M, K, eps, key, s));
}

// K1's maxima form: amax [M] (fp32) gets each row's max |x|; tpr, ctas as
// for qt_quantize_int8_rowwise
extern "C" int qt_quantize_int8_rowwise_maxima(const void* x, void* amax, int64_t M, int64_t K, int is_bf16, int tpr,
                                               int64_t ctas, void* stream) {
  if (M <= 0 || K <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* a = static_cast<float*>(amax);
  if (tpr != 0)
    return static_cast<int>(QT_DISPATCH_FORM(launch_rows_walk, kMaxima, is_bf16, 0, x, nullptr, nullptr, a, M, K,
                                             tpr, ctas, 0.0f, 0, s));
  return static_cast<int>(QT_DISPATCH_FORM(launch, kMaxima, is_bf16, 0, x, nullptr, nullptr, a, M, K, 0.0f, 0, s));
}

// K1's given form: q and scale from the rows' maxima in amax [M] (fp32)
extern "C" int qt_quantize_int8_rowwise_given(const void* x, void* q, void* scale, const void* amax, int64_t M,
                                              int64_t K, float eps, int is_bf16, int sr, uint64_t key, int tpr,
                                              int64_t ctas, void* stream) {
  if (M <= 0 || K <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* a = static_cast<float*>(const_cast<void*>(amax));
  if (tpr != 0)
    return static_cast<int>(
        QT_DISPATCH_FORM(launch_rows_walk, kGiven, is_bf16, sr, x, q, scale, a, M, K, tpr, ctas, eps, key, s));
  return static_cast<int>(QT_DISPATCH_FORM(launch, kGiven, is_bf16, sr, x, q, scale, a, M, K, eps, key, s));
}

// x and q are contiguous [R, C]; scale is [C]. sv, cs
// (ops/int8_quant.py::colwise_sm90_route): sv 0 takes the first design
// (col_absmax, col_cast), amax then fp32 scratch of C floats; else the
// cluster form with sv vectors a strip and cs CTAs a cluster (x 16-byte
// aligned, C a whole number of vectors), amax unused.
extern "C" int qt_quantize_int8_colwise(const void* x, void* q, void* scale, void* amax, int64_t R, int64_t C,
                                        float eps, int is_bf16, int sr, uint64_t key, int sv, int cs, void* stream) {
  if (R <= 0 || C <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sv != 0)
    return static_cast<int>(
        QT_DISPATCH(launch_cols_cluster, is_bf16, sr, x, q, scale, R, C, sv, cs, eps, key, s));
  float* a = static_cast<float*>(amax);
  return static_cast<int>(QT_DISPATCH(launch_colwise, is_bf16, sr, x, q, scale, a, R, C, eps, key, s));
}

// B4's maxima form: amax [C] (fp32) gets each column's max |x|
extern "C" int qt_quantize_int8_colwise_maxima(const void* x, void* amax, int64_t R, int64_t C, int is_bf16,
                                               void* stream) {
  if (R <= 0 || C <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* a = static_cast<float*>(amax);
  return static_cast<int>(is_bf16 ? launch_cols_maxima<__nv_bfloat16>(x, a, R, C, s)
                                  : launch_cols_maxima<float>(x, a, R, C, s));
}

// x, q_row and q_col are contiguous [M, K]; s_row is [M], s_col [K]; amax
// is fp32 scratch of K floats, and K * 4 bytes must fit in a block's shared
// memory (K <= 58112). The row cast draws from key_row, the column cast
// from key_col.
extern "C" int qt_quantize_int8_both(const void* x, void* q_row, void* s_row, void* q_col, void* s_col,
                                     void* amax, int64_t M, int64_t K, float eps, int is_bf16, int sr,
                                     uint64_t key_row, uint64_t key_col, void* stream) {
  if (M <= 0 || K <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* a = static_cast<float*>(amax);
  return static_cast<int>(QT_DISPATCH(launch_both, is_bf16, sr, x, q_row, s_row, q_col, s_col, a, M, K, eps,
                                      key_row, key_col, s));
}

// B5's maxima form: q_row, s_row [M] (the row cast from key_row) and the
// column maxima in amax [K] (fp32); parts is M K bytes of scratch
extern "C" int qt_quantize_int8_both_maxima(const void* x, void* q_row, void* s_row, void* parts, void* amax,
                                            int64_t M, int64_t K, float eps, int is_bf16, int sr, uint64_t key_row,
                                            void* stream) {
  if (M <= 0 || K <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* a = static_cast<float*>(amax);
  return static_cast<int>(
      QT_DISPATCH(launch_both_maxima_form, is_bf16, sr, x, q_row, s_row, parts, a, M, K, eps, key_row, s));
}

// The given form of a column quantize (B4's and B5's): q_col and s_col [K]
// (the cast from key_col) from the column maxima in amax [K] (fp32)
extern "C" int qt_quantize_int8_colwise_given(const void* x, void* q_col, void* s_col, const void* amax, int64_t M,
                                              int64_t K, float eps, int is_bf16, int sr, uint64_t key_col,
                                              void* stream) {
  if (M <= 0 || K <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* a = static_cast<float*>(const_cast<void*>(amax));
  return static_cast<int>(QT_DISPATCH(launch_cols_given_form, is_bf16, sr, x, q_col, s_col, a, M, K, eps, key_col, s));
}
