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
// path. Design: one 256-thread block per row for rows of 1024 elements or
// more (activations, weights), so even the 8 rows of a decode step spread
// over 8 SMs; one warp per row below that (KV rows of 64). Each thread moves
// 16 bytes per load; the absmax pass and the cast pass read the same row, so
// the second read hits L1/L2 rather than device memory. Rows whose length or
// base is not 16-byte aligned take a scalar loop.
//
// B4: column-wise, x [R, C] -> q int8 [R, C], scale [1, C]. Replaces
// pallas_quant.py::quantize_int8_colwise (:229), the backward's quantize of
// x2d [tokens, in] and w [out, in] along their first axis. The column max is
// order-independent, so the token rows are split across blocks (64 rows
// each) and the partial maxima meet in an fp32 [C] buffer through atomicMax
// on the non-negative float's bit pattern: bit-exact, and [8192, 2048] fills
// the card with 1024 blocks where 64 columns per block and no split would
// give 32. A second pass does the cast. Loads run along the contiguous
// column axis: 32 threads x 16 bytes of one row per warp.
//
// B5: both axes, x [M, K] -> (q_row, s_row [M, 1], q_col, s_col [1, K]).
// Replaces pallas_quant.py::quantize_int8_both (:306), the backward's
// quantize of the output gradient. Pass 1 is K1's block-per-row quantize over
// a run of rows per block that also keeps each column's running max in
// shared memory (a thread owns the same columns in every row, so no atomics
// there) and merges it into the fp32 [K] buffer once per block. Pass 2 is
// B4's column cast. Bytes: two reads of x and two int8 writes.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;        // 8 warps
constexpr int64_t kBlockRowMinK = 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store_scale(float* p, float s) { *p = s; }
__device__ __forceinline__ void store_scale(__nv_bfloat16* p, float s) {
  *p = __float2bfloat16_rn(s);
}

__device__ __forceinline__ int8_t clamp_int8(float r) {
  return static_cast<int8_t>(fminf(fmaxf(r, -128.0f), 127.0f));
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
__device__ __forceinline__ int8_t quant(float v, float denom, uint32_t word) {
  return SR ? quant_one_sr(v, denom, word) : quant_one(v, denom);
}

// The stream words of a 16-byte vector's N elements starting at idx0
// (a multiple of 4); nothing is drawn without SR.
template <bool SR, int N>
__device__ __forceinline__ void vec_words(uint64_t idx0, uint64_t key, uint32_t (&w)[N]) {
  if (SR) {
    qt::stream_words<N>(idx0, key, w);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) w[j] = 0u;
  }
}

template <int N> struct PackOf;
template <> struct PackOf<8> { using type = uint2; };         // 8 int8 from 8 bf16
template <> struct PackOf<4> { using type = unsigned int; };  // 4 int8 from 4 fp32

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
      for (int j = 0; j < N; ++j) out.c[j] = quant<SR>(to_f32(e[j]), denom, w[j]);
      qv[i] = out.p;
    }
  } else {
    for (int64_t i = tid; i < K; i += STRIDE)
      qr[i] = quant<SR>(to_f32(xr[i]), denom, SR ? qt::philox_word(base + i, key) : 0u);
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Short rows (K < kBlockRowMinK, e.g. KV rows of hd = 64): one warp per row.
template <typename T, bool SR>
__global__ void __launch_bounds__(kThreads)
quantize_rows_warp(const T* __restrict__ x, int8_t* __restrict__ q, T* __restrict__ scale,
                   int64_t M, int64_t K, float eps, bool vec, uint64_t key) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= M) return;  // whole warps leave together
  const float s = __fdiv_rn(warp_max(row_absmax<T, 32>(x + row * K, K, vec, lane)), 127.0f);
  row_cast<T, 32, SR>(x + row * K, q + row * K, K, vec, lane, fmaxf(s, eps), row * K, key);
  if (lane == 0) store_scale(scale + row, s);
}

// Long rows (activations and weights, K >= kBlockRowMinK): one block per
// row, so even the 8 rows of a decode step spread over 8 SMs.
template <typename T, bool SR>
__global__ void __launch_bounds__(kThreads)
quantize_rows_block(const T* __restrict__ x, int8_t* __restrict__ q, T* __restrict__ scale,
                    int64_t K, float eps, bool vec, uint64_t key) {
  __shared__ float part[kThreads / 32];
  const int64_t row = blockIdx.x;
  float amax = warp_max(row_absmax<T, kThreads>(x + row * K, K, vec, threadIdx.x));
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = amax;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) amax = fmaxf(amax, part[w]);
  const float s = __fdiv_rn(amax, 127.0f);
  row_cast<T, kThreads, SR>(x + row * K, q + row * K, K, vec, threadIdx.x, fmaxf(s, eps), row * K, key);
  if (threadIdx.x == 0) store_scale(scale + row, s);
}

template <typename T, bool SR>
cudaError_t launch(const void* x, void* q, void* scale, int64_t M, int64_t K, float eps, uint64_t key,
                   cudaStream_t stream) {
  const bool vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) && (K % (16 / sizeof(T)) == 0);
  const T* xt = static_cast<const T*>(x);
  int8_t* qt = static_cast<int8_t*>(q);
  T* st = static_cast<T*>(scale);
  if (K >= kBlockRowMinK) {
    quantize_rows_block<T, SR><<<static_cast<unsigned int>(M), kThreads, 0, stream>>>(xt, qt, st, K, eps, vec,
                                                                                     key);
  } else {
    const int64_t blocks = (M + kThreads / 32 - 1) / (kThreads / 32);
    quantize_rows_warp<T, SR><<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(xt, qt, st, M, K, eps,
                                                                                         vec, key);
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
      for (int j = 0; j < N; ++j) out.c[j] = quant<SR>(to_f32(e[j]), denom[j], w[j]);
      *reinterpret_cast<Pack*>(qr) = out.p;
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (c0 + j < C) qr[j] = quant<SR>(to_f32(xr[j]), denom[j], SR ? qt::philox_word(idx0 + j, key) : 0u);
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

template <typename T>
dim3 col_grid(int64_t R, int64_t C) {
  constexpr int N = 16 / sizeof(T);
  const int64_t cols = (C + kColThreadsX * N - 1) / (kColThreadsX * N);
  const int64_t rows = std::max<int64_t>(1, (R + kColRows - 1) / kColRows);
  return dim3(static_cast<unsigned int>(cols), static_cast<unsigned int>(rows));
}

template <typename T>
bool vec_ok(const void* x, int64_t cols) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0 && cols % (16 / sizeof(T)) == 0;
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

template <typename T, bool SR>
cudaError_t launch_both(const void* x, void* q_row, void* s_row, void* q_col, void* s_col,
                        float* amax, int64_t M, int64_t K, float eps, uint64_t key_row, uint64_t key_col,
                        cudaStream_t stream) {
  const bool vec = vec_ok<T>(x, K);
  const T* xt = static_cast<const T*>(x);
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
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  col_cast<T, SR><<<col_grid<T>(M, K), kThreads, 0, stream>>>(xt, amax, static_cast<int8_t*>(q_col),
                                                              static_cast<T*>(s_col), M, K, eps, vec, key_col);
  return cudaGetLastError();
}

// The four (dtype, SR) instantiations of a launcher, picked at run time.
#define QT_DISPATCH(LAUNCH, is_bf16, sr, ...)                              \
  ((is_bf16) ? ((sr) ? LAUNCH<__nv_bfloat16, true>(__VA_ARGS__)          \
                     : LAUNCH<__nv_bfloat16, false>(__VA_ARGS__))        \
             : ((sr) ? LAUNCH<float, true>(__VA_ARGS__) : LAUNCH<float, false>(__VA_ARGS__)))

}  // namespace

// Every entry point returns the launch's cudaError_t (0 on success).
// is_bf16: x and the scales are bf16, else fp32. sr: round stochastically
// from the Philox stream of ``key`` (philox.cuh), else to nearest even.

// x and q are contiguous [M, K]; scale is [M].
extern "C" int qt_quantize_int8_rowwise(const void* x, void* q, void* scale, int64_t M, int64_t K, float eps,
                                        int is_bf16, int sr, uint64_t key, void* stream) {
  if (M <= 0 || K <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(QT_DISPATCH(launch, is_bf16, sr, x, q, scale, M, K, eps, key, s));
}

// x and q are contiguous [R, C]; scale is [C]; amax is fp32 scratch of C
// floats.
extern "C" int qt_quantize_int8_colwise(const void* x, void* q, void* scale, void* amax, int64_t R, int64_t C,
                                        float eps, int is_bf16, int sr, uint64_t key, void* stream) {
  if (R <= 0 || C <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* a = static_cast<float*>(amax);
  return static_cast<int>(QT_DISPATCH(launch_colwise, is_bf16, sr, x, q, scale, a, R, C, eps, key, s));
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
