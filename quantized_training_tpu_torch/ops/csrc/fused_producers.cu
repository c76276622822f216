// Producer-fused int8 quantize kernels and the one-pass RMSNorm backward.
//
// In the int8 decoder layer every quantized linear's input is made by a
// cheap op, the "producer": RMSNorm (the q/k/v and gate/up inputs) or
// silu(gate) * up (the down projection's input). Unfused, the producer writes
// its bf16 output and the quantize reads it back, in the forward, in the
// remat replay and in the backward's column quantize. These kernels run the
// producer inside the quantize, so the producer's output never reaches
// device memory and the quantize sees its unrounded fp32 values.
//
// Numerics are the Pallas bodies' (ops/pallas_fused.py:95-132 with
// pallas_quant.py:75-87), not quant/core.py's: scale = absmax * (1/127) in
// fp32, q = rint(y * (1 / max(scale, eps))) with a correctly rounded
// reciprocal, or with SR floor(y * inv + u), u the uniform at element (r, c)'s
// index r * K + c of the key's Philox stream (philox.cuh), clamped to int8.
// The producers, in fp32 with every operation rounded once (no contraction):
//   rmsnorm: y = (x * rstd) * g, rstd = rsqrt(sum(x * x) / K + norm_eps);
//   silu:    y = (a * (1 / (1 + exp(-a)))) * b.
// The row's sum of squares runs in one fixed order (each thread its own
// vectors, a butterfly across the warp, the warps in order), so the same row
// gives the same y in every kernel here: the column maxima that B7 and the
// row form of B9 forward give the backward's column quantize the exact scale
// of the two-pass form.
//
// Kernels, what they replace (quantized_training_tpu/ops/pallas_fused.py):
// - B7 row_quant<NormProducer>: rmsnorm_quant_rowwise (:154), x [M, K] ->
//   q int8 [M, K], scale fp32 [M], optionally the column absmax fp32 [K];
// - B9 row_quant<SiluProducer>: silu_mul_quant_rowwise (:325), a, b [M, K];
// - B8 col_quant<NormProducer>: rmsnorm_quant_colwise (:246), column int8
//   given the column scales, or after producer_col_absmax (the two-pass form);
// - B9 col_quant<SiluProducer>: silu_mul_quant_colwise (:409), the same;
// - B10 rmsnorm_bwd_rows + reduce_parts: rmsnorm_bwd (:491), dx in x's
//   dtype and dgamma fp32 [K] in one read of x and dy.
//
// What bounds them on the H100: bytes. B7 at [8192, 2048] bf16 moves 50 MB
// (x read, q written), B9-row at [8192, 5632] 231 MB (a and b read), B10 101
// MB (x, dy read, dx written): 15, 69 and 30 us at 3.35 TB/s; the exp of the
// sigmoid is about 20 fp32 operations per element, under a third of B9's
// memory time. Design: a block of 256 threads walks a run of rows; a thread
// owns the same 16-byte vectors (8 bf16 or 4 fp32) of every row, so its
// loads are coalesced and the column maxima (B7, B9 with column absmax) and
// the dgamma partial sums (B10) it keeps in shared memory need no atomics
// inside the block. The producer writes the row's y once into shared memory
// (fp32, element j of vector i at [j * nv + i], so a warp's accesses hit
// distinct banks); the absmax pass and the cast read it back from there.
// Each block writes its column maxima or dgamma partial sums to an fp32
// [blocks, K] buffer, which reduce_parts folds over the blocks in a fixed
// order: dgamma is a function of its inputs, and no atomics are used.
// (Merging the maxima by atomicMax instead, K per block on the same K
// addresses, serializes: B7 with the column absmax took 103 us that way at
// [8192, 2048], against 56 us for B8, on an H100 80GB HBM3 at 700 W.) wgmma and TMA do not apply; speed beyond 16-byte loads
// is for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr float kInv127 = 1.0f / 127.0f;  // the fp32 constant the Pallas bodies multiply by

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_elem(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_elem(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// The N elements of the 16-byte vector at p, as fp32.
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float (&v)[N]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = to_f32(e[j]);
}

__device__ __forceinline__ int8_t clamp_int8(float r) {
  return static_cast<int8_t>(fminf(fmaxf(r, -128.0f), 127.0f));
}

// rint(y * inv) (round half to even), or with SR floor(y * inv + u)
template <bool SR>
__device__ __forceinline__ int8_t quant(float y, float inv, uint32_t word) {
  const float r = __fmul_rn(y, inv);
  return clamp_int8(SR ? floorf(__fadd_rn(r, qt::uniform_of(word))) : rintf(r));
}

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
template <> struct PackOf<8> { using type = uint2; };         // 8 int8
template <> struct PackOf<4> { using type = unsigned int; };  // 4 int8

template <bool MAX>
__device__ __forceinline__ float warp_reduce(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = MAX ? fmaxf(v, o) : __fadd_rn(v, o);
  }
  return v;  // the butterfly leaves the same value in every lane
}

// The block's max (or sum) of v, in every thread, in a fixed order. ``red``
// is kWarps floats of shared memory; the leading barrier lets a call reuse
// it right after the previous one.
template <bool MAX>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  v = warp_reduce<MAX>(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = MAX ? fmaxf(r, red[w]) : __fadd_rn(r, red[w]);
  return r;
}

// ---- the producers ----------------------------------------------------------
// fill(row, ybuf, red): write the row's y into this thread's entries of ybuf
// ([j * nv + i] for its vectors i) and return the max |y| over them.

template <typename T>
struct NormProducer {
  static constexpr int N = 16 / sizeof(T);
  const T* __restrict__ x;
  const float* __restrict__ g;  // gamma, widened to fp32 by the wrapper (exact)
  int64_t K;
  float norm_eps;

  __device__ __forceinline__ float fill(int64_t row, float* ybuf, float* red) const {
    const int64_t nv = K / N;
    const T* xr = x + row * K;
    float ss = 0.0f;
    for (int64_t i = threadIdx.x; i < nv; i += kThreads) {
      float v[N];
      load_vec<T, N>(xr + i * N, v);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        ybuf[j * nv + i] = v[j];
        ss = __fmaf_rn(v[j], v[j], ss);
      }
    }
    ss = block_reduce<false>(ss, red);
    const float rstd = __frsqrt_rn(__fadd_rn(__fdiv_rn(ss, static_cast<float>(K)), norm_eps));
    float amax = 0.0f;
    for (int64_t i = threadIdx.x; i < nv; i += kThreads) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float y = __fmul_rn(__fmul_rn(ybuf[j * nv + i], rstd), g[i * N + j]);
        ybuf[j * nv + i] = y;
        amax = fmaxf(amax, fabsf(y));
      }
    }
    return amax;
  }
};

// silu(a) * b with the sigmoid as 1 / (1 + exp(-a)), IEEE division: the
// plain version (ops/fused_producers.py::silu_mul_f32) computes the same
// operations in the same order, so B9 is bit-exact with it on the card.
__device__ __forceinline__ float silu_mul(float a, float b) {
  const float s = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-a)));
  return __fmul_rn(__fmul_rn(a, s), b);
}

template <typename T>
struct SiluProducer {
  static constexpr int N = 16 / sizeof(T);
  const T* __restrict__ a;
  const T* __restrict__ b;
  int64_t K;

  __device__ __forceinline__ float fill(int64_t row, float* ybuf, float*) const {
    const int64_t nv = K / N;
    float amax = 0.0f;
    for (int64_t i = threadIdx.x; i < nv; i += kThreads) {
      float va[N], vb[N];
      load_vec<T, N>(a + row * K + i * N, va);
      load_vec<T, N>(b + row * K + i * N, vb);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float y = silu_mul(va[j], vb[j]);
        ybuf[j * nv + i] = y;
        amax = fmaxf(amax, fabsf(y));
      }
    }
    return amax;
  }
};

// ---- B7 and the row form of B9 ----------------------------------------------

// This thread's entries of the block's column maxima (or sums) [K], in the
// shared layout [j * nv + i], to row blockIdx.x of parts [blocks, K].
template <int N>
__device__ __forceinline__ void store_part(const float* acc, float* __restrict__ parts, int64_t K) {
  const int64_t nv = K / N;
  for (int64_t i = threadIdx.x; i < nv; i += kThreads)
#pragma unroll
    for (int j = 0; j < N; ++j) parts[static_cast<int64_t>(blockIdx.x) * K + i * N + j] = acc[j * nv + i];
}

// Rows [rpb * blockIdx.x, +rpb): the row quantize of the producer's y; with
// COLMAX also this block's column absmax of |y| into parts[blockIdx.x].
// Dynamic shared memory: ybuf [K], then (COLMAX) colmax [K], both fp32.
template <class P, bool SR, bool COLMAX>
__global__ void __launch_bounds__(kThreads)
row_quant(P p, int8_t* __restrict__ q, float* __restrict__ s_row, float* __restrict__ parts, int64_t M,
          int64_t rpb, float eps, uint64_t key) {
  constexpr int N = P::N;
  using Pack = typename PackOf<N>::type;
  extern __shared__ float smem[];
  __shared__ float red[kWarps];
  const int64_t K = p.K, nv = K / N;
  float* ybuf = smem;
  float* colmax = smem + K;
  if (COLMAX)
    for (int64_t i = threadIdx.x; i < nv; i += kThreads)
#pragma unroll
      for (int j = 0; j < N; ++j) colmax[j * nv + i] = 0.0f;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rpb;
  const int64_t r1 = r0 + rpb < M ? r0 + rpb : M;
  for (int64_t row = r0; row < r1; ++row) {
    const float s = __fmul_rn(block_reduce<true>(p.fill(row, ybuf, red), red), kInv127);
    const float inv = __frcp_rn(fmaxf(s, eps));
    for (int64_t i = threadIdx.x; i < nv; i += kThreads) {
      uint32_t w[N];
      vec_words<SR, N>(row * K + i * N, key, w);
      union {
        Pack pack;
        int8_t c[N];
      } out;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float y = ybuf[j * nv + i];
        out.c[j] = quant<SR>(y, inv, w[j]);
        if (COLMAX) colmax[j * nv + i] = fmaxf(colmax[j * nv + i], fabsf(y));
      }
      *reinterpret_cast<Pack*>(q + row * K + i * N) = out.pack;
    }
    if (threadIdx.x == 0) s_row[row] = s;
  }
  if (COLMAX) store_part<N>(colmax, parts, K);
}

// ---- B8 and the column form of B9 -------------------------------------------

// Pass 1 of the two-pass form: this block's column absmax of |y| into
// parts[blockIdx.x]. Dynamic shared memory: ybuf [K], colmax [K].
template <class P>
__global__ void __launch_bounds__(kThreads)
producer_col_absmax(P p, float* __restrict__ parts, int64_t M, int64_t rpb) {
  constexpr int N = P::N;
  extern __shared__ float smem[];
  __shared__ float red[kWarps];
  const int64_t K = p.K, nv = K / N;
  float* ybuf = smem;
  float* colmax = smem + K;
  for (int64_t i = threadIdx.x; i < nv; i += kThreads)
#pragma unroll
    for (int j = 0; j < N; ++j) colmax[j * nv + i] = 0.0f;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rpb;
  const int64_t r1 = r0 + rpb < M ? r0 + rpb : M;
  for (int64_t row = r0; row < r1; ++row) {
    p.fill(row, ybuf, red);
    for (int64_t i = threadIdx.x; i < nv; i += kThreads)
#pragma unroll
      for (int j = 0; j < N; ++j) colmax[j * nv + i] = fmaxf(colmax[j * nv + i], fabsf(ybuf[j * nv + i]));
  }
  store_part<N>(colmax, parts, K);
}

// The column quantize of y with the column scales ``scale`` [K]; with
// FROM_AMAX ``scale`` holds the column absmax and the scale is amax * (1/127),
// which the first row of blocks stores into s_out [K]. Dynamic shared
// memory: ybuf [K], inv [K] (1 / max(scale, eps) of this thread's columns).
template <class P, bool SR, bool FROM_AMAX>
__global__ void __launch_bounds__(kThreads)
col_quant(P p, const float* __restrict__ scale, float* __restrict__ s_out, int8_t* __restrict__ q, int64_t M,
          int64_t rpb, float eps, uint64_t key) {
  constexpr int N = P::N;
  using Pack = typename PackOf<N>::type;
  extern __shared__ float smem[];
  __shared__ float red[kWarps];
  const int64_t K = p.K, nv = K / N;
  float* ybuf = smem;
  float* inv = smem + K;
  for (int64_t i = threadIdx.x; i < nv; i += kThreads)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float s = FROM_AMAX ? __fmul_rn(scale[i * N + j], kInv127) : scale[i * N + j];
      inv[j * nv + i] = __frcp_rn(fmaxf(s, eps));
      if (FROM_AMAX && blockIdx.x == 0) s_out[i * N + j] = s;
    }
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rpb;
  const int64_t r1 = r0 + rpb < M ? r0 + rpb : M;
  for (int64_t row = r0; row < r1; ++row) {
    p.fill(row, ybuf, red);
    for (int64_t i = threadIdx.x; i < nv; i += kThreads) {
      uint32_t w[N];
      vec_words<SR, N>(row * K + i * N, key, w);
      union {
        Pack pack;
        int8_t c[N];
      } out;
#pragma unroll
      for (int j = 0; j < N; ++j) out.c[j] = quant<SR>(ybuf[j * nv + i], inv[j * nv + i], w[j]);
      *reinterpret_cast<Pack*>(q + row * K + i * N) = out.pack;
    }
  }
}

// ---- B10 --------------------------------------------------------------------

// Rows [rpb * blockIdx.x, +rpb) of the RMSNorm backward (the closed form of
// quant/fused.py::_rmsnorm_bwd_math): rstd = rsqrt(sum(x * x) / K + eps),
// xn = x * rstd, dxn = dy * g, c = sum(dxn * xn) / K taken as
// (sum(dy * g * x) * rstd) / K, dx = (dxn - xn * c) * rstd in x's dtype; this
// block's partial sum of dy * xn over its rows goes to dg_part[blockIdx.x]
// [K]. Pass 2 re-reads the row, which the pass before left in L1/L2.
// Dynamic shared memory: dgacc [K].
template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_rows(const T* __restrict__ x, const float* __restrict__ g, const T* __restrict__ dy,
                 T* __restrict__ dx, float* __restrict__ dg_part, int64_t M, int64_t K, int64_t rpb,
                 float norm_eps) {
  constexpr int N = 16 / sizeof(T);
  extern __shared__ float dgacc[];
  __shared__ float red[kWarps];
  const int64_t nv = K / N;
  for (int64_t i = threadIdx.x; i < nv; i += kThreads)
#pragma unroll
    for (int j = 0; j < N; ++j) dgacc[j * nv + i] = 0.0f;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rpb;
  const int64_t r1 = r0 + rpb < M ? r0 + rpb : M;
  for (int64_t row = r0; row < r1; ++row) {
    const T* xr = x + row * K;
    const T* dyr = dy + row * K;
    float ss = 0.0f, sd = 0.0f;
    for (int64_t i = threadIdx.x; i < nv; i += kThreads) {
      float vx[N], vd[N];
      load_vec<T, N>(xr + i * N, vx);
      load_vec<T, N>(dyr + i * N, vd);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        ss = __fmaf_rn(vx[j], vx[j], ss);
        sd = __fmaf_rn(__fmul_rn(vd[j], g[i * N + j]), vx[j], sd);
      }
    }
    ss = block_reduce<false>(ss, red);
    sd = block_reduce<false>(sd, red);
    const float kf = static_cast<float>(K);
    const float rstd = __frsqrt_rn(__fadd_rn(__fdiv_rn(ss, kf), norm_eps));
    const float c = __fdiv_rn(__fmul_rn(sd, rstd), kf);
    for (int64_t i = threadIdx.x; i < nv; i += kThreads) {
      float vx[N], vd[N];
      load_vec<T, N>(xr + i * N, vx);
      load_vec<T, N>(dyr + i * N, vd);
      uint4 out;
      T* e = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float xn = __fmul_rn(vx[j], rstd);
        const float dxn = __fmul_rn(vd[j], g[i * N + j]);
        store_elem(&e[j], __fmul_rn(__fsub_rn(dxn, __fmul_rn(xn, c)), rstd));
        dgacc[j * nv + i] = __fadd_rn(dgacc[j * nv + i], __fmul_rn(vd[j], xn));
      }
      *reinterpret_cast<uint4*>(dx + row * K + i * N) = out;
    }
  }
  store_part<N>(dgacc, dg_part, K);
}

// ---- the fold over the blocks ----------------------------------------------

constexpr int kPartLanes = 32;  // threads that share one column's parts

// out[k] = the max (or sum) over p of parts[p][k], in a fixed order: lane j
// of column k folds p = j, j + 32, ... in turn, then lane 0 the 32 lanes'
// results in lane order. A warp holds 32 neighbouring columns, so its loads
// are coalesced; a block is 32 columns x 32 lanes.
template <bool MAX>
__global__ void __launch_bounds__(32 * kPartLanes)
reduce_parts(const float* __restrict__ parts, float* __restrict__ out, int64_t nparts, int64_t K) {
  __shared__ float acc[kPartLanes][33];
  const int col = threadIdx.x & 31, lane = threadIdx.x >> 5;
  const int64_t k = static_cast<int64_t>(blockIdx.x) * 32 + col;
  float r = 0.0f;  // the maxima are of absolute values
  if (k < K)
#pragma unroll 4
    for (int64_t p = lane; p < nparts; p += kPartLanes)
      r = MAX ? fmaxf(r, parts[p * K + k]) : __fadd_rn(r, parts[p * K + k]);
  acc[lane][col] = r;
  __syncthreads();
  if (lane == 0 && k < K) {
    for (int l = 1; l < kPartLanes; ++l) r = MAX ? fmaxf(r, acc[l][col]) : __fadd_rn(r, acc[l][col]);
    out[k] = r;
  }
}

cudaError_t launch_reduce(bool max, const float* parts, float* out, int64_t nparts, int64_t K, cudaStream_t stream) {
  const unsigned int blocks = static_cast<unsigned int>((K + 31) / 32);
  if (max)
    reduce_parts<true><<<blocks, 32 * kPartLanes, 0, stream>>>(parts, out, nparts, K);
  else
    reduce_parts<false><<<blocks, 32 * kPartLanes, 0, stream>>>(parts, out, nparts, K);
  return cudaGetLastError();
}

// ---- launchers --------------------------------------------------------------

unsigned int n_blocks(int64_t M, int64_t rpb) { return static_cast<unsigned int>((M + rpb - 1) / rpb); }

// Opt a kernel into more than 48 KB of dynamic shared memory when it needs it.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
}

template <class P, bool SR, bool COLMAX>
cudaError_t launch_row(const P& p, void* q, void* s_row, void* amax, void* parts, int64_t M, int64_t rpb,
                       float eps, uint64_t key, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(p.K) * sizeof(float) * (COLMAX ? 2 : 1);
  float* pt = static_cast<float*>(parts);
  cudaError_t err;
  if ((err = allow_smem(row_quant<P, SR, COLMAX>, smem)) != cudaSuccess) return err;
  row_quant<P, SR, COLMAX><<<n_blocks(M, rpb), kThreads, smem, stream>>>(
      p, static_cast<int8_t*>(q), static_cast<float*>(s_row), pt, M, rpb, eps, key);
  if ((err = cudaGetLastError()) != cudaSuccess || !COLMAX) return err;
  return launch_reduce(true, pt, static_cast<float*>(amax), n_blocks(M, rpb), p.K, stream);
}

// scale: the column scales [K], or nullptr for the two-pass form, which
// computes the column absmax into amax [K] (by way of parts) and the scales
// into s_out [K].
template <class P, bool SR>
cudaError_t launch_col(const P& p, const float* scale, void* q, void* s_out, void* amax, void* parts, int64_t M,
                       int64_t rpb, float eps, uint64_t key, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(p.K) * sizeof(float) * 2;
  int8_t* qt = static_cast<int8_t*>(q);
  cudaError_t err;
  if (scale != nullptr) {
    if ((err = allow_smem(col_quant<P, SR, false>, smem)) != cudaSuccess) return err;
    col_quant<P, SR, false><<<n_blocks(M, rpb), kThreads, smem, stream>>>(p, scale, nullptr, qt, M, rpb, eps, key);
    return cudaGetLastError();
  }
  float* am = static_cast<float*>(amax);
  float* pt = static_cast<float*>(parts);
  if ((err = allow_smem(producer_col_absmax<P>, smem)) != cudaSuccess) return err;
  producer_col_absmax<P><<<n_blocks(M, rpb), kThreads, smem, stream>>>(p, pt, M, rpb);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = launch_reduce(true, pt, am, n_blocks(M, rpb), p.K, stream)) != cudaSuccess) return err;
  if ((err = allow_smem(col_quant<P, SR, true>, smem)) != cudaSuccess) return err;
  col_quant<P, SR, true><<<n_blocks(M, rpb), kThreads, smem, stream>>>(p, am, static_cast<float*>(s_out), qt, M,
                                                                       rpb, eps, key);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const float* g, const void* dy, void* dx, void* dg, void* dg_part, int64_t M,
                       int64_t K, int64_t rpb, float norm_eps, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(K) * sizeof(float);
  cudaError_t err;
  if ((err = allow_smem(rmsnorm_bwd_rows<T>, smem)) != cudaSuccess) return err;
  const unsigned int blocks = n_blocks(M, rpb);
  rmsnorm_bwd_rows<T><<<blocks, kThreads, smem, stream>>>(static_cast<const T*>(x), g, static_cast<const T*>(dy),
                                                          static_cast<T*>(dx), static_cast<float*>(dg_part), M, K,
                                                          rpb, norm_eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_reduce(false, static_cast<const float*>(dg_part), static_cast<float*>(dg), blocks, K, stream);
}

template <typename T>
NormProducer<T> norm_producer(const void* x, const void* g, int64_t K, float norm_eps) {
  return NormProducer<T>{static_cast<const T*>(x), static_cast<const float*>(g), K, norm_eps};
}

template <typename T>
SiluProducer<T> silu_producer(const void* a, const void* b, int64_t K) {
  return SiluProducer<T>{static_cast<const T*>(a), static_cast<const T*>(b), K};
}

}  // namespace

// Every entry point returns the launch's cudaError_t (0 on success). The
// wrapper (ops/fused_producers.py) guarantees: inputs contiguous, 16-byte
// aligned, K % 128 == 0, K * 8 bytes within a block's shared memory; g is
// fp32 [K]; is_bf16 selects bf16 (else fp32) inputs; q is int8 [M, K]; scales
// and maxima are fp32; rpb is the number of rows per block; sr rounds
// stochastically from the Philox stream of ``key``.

// B7: q, s_row [M]; with with_amax the column absmax into amax [K], by way
// of parts, fp32 scratch of ceil(M / rpb) * K floats (else both unused).
extern "C" int qt_rmsnorm_quant_rowwise(const void* x, const void* g, void* q, void* s_row, void* amax, void* parts,
                                        int64_t M, int64_t K, int64_t rpb, float norm_eps, float eps, int is_bf16,
                                        int sr, int with_amax, uint64_t key, void* stream) {
  if (M <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define QT_ROW(T, SR, AM) launch_row<NormProducer<T>, SR, AM>(norm_producer<T>(x, g, K, norm_eps), q, s_row, amax, \
                                                              parts, M, rpb, eps, key, s)
  if (is_bf16)
    return sr ? (with_amax ? QT_ROW(__nv_bfloat16, true, true) : QT_ROW(__nv_bfloat16, true, false))
              : (with_amax ? QT_ROW(__nv_bfloat16, false, true) : QT_ROW(__nv_bfloat16, false, false));
  return sr ? (with_amax ? QT_ROW(float, true, true) : QT_ROW(float, true, false))
            : (with_amax ? QT_ROW(float, false, true) : QT_ROW(float, false, false));
#undef QT_ROW
}

// B9, row form: as B7 with the inputs a, b [M, K].
extern "C" int qt_silu_mul_quant_rowwise(const void* a, const void* b, void* q, void* s_row, void* amax, void* parts,
                                         int64_t M, int64_t K, int64_t rpb, float eps, int is_bf16, int sr,
                                         int with_amax, uint64_t key, void* stream) {
  if (M <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define QT_ROW(T, SR, AM) launch_row<SiluProducer<T>, SR, AM>(silu_producer<T>(a, b, K), q, s_row, amax, parts, M, \
                                                              rpb, eps, key, s)
  if (is_bf16)
    return sr ? (with_amax ? QT_ROW(__nv_bfloat16, true, true) : QT_ROW(__nv_bfloat16, true, false))
              : (with_amax ? QT_ROW(__nv_bfloat16, false, true) : QT_ROW(__nv_bfloat16, false, false));
  return sr ? (with_amax ? QT_ROW(float, true, true) : QT_ROW(float, true, false))
            : (with_amax ? QT_ROW(float, false, true) : QT_ROW(float, false, false));
#undef QT_ROW
}

// B8: scale [K] given, or nullptr for the two-pass form, which writes the
// column absmax into the scratch amax [K] (by way of parts, as B7) and the
// scales into s_out [K].
extern "C" int qt_rmsnorm_quant_colwise(const void* x, const void* g, const void* scale, void* q, void* s_out,
                                        void* amax, void* parts, int64_t M, int64_t K, int64_t rpb, float norm_eps,
                                        float eps, int is_bf16, int sr, uint64_t key, void* stream) {
  if (M <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
#define QT_COL(T, SR) launch_col<NormProducer<T>, SR>(norm_producer<T>(x, g, K, norm_eps), sc, q, s_out, amax, \
                                                      parts, M, rpb, eps, key, s)
  if (is_bf16) return sr ? QT_COL(__nv_bfloat16, true) : QT_COL(__nv_bfloat16, false);
  return sr ? QT_COL(float, true) : QT_COL(float, false);
#undef QT_COL
}

// B9, column form: as B8 with the inputs a, b [M, K].
extern "C" int qt_silu_mul_quant_colwise(const void* a, const void* b, const void* scale, void* q, void* s_out,
                                         void* amax, void* parts, int64_t M, int64_t K, int64_t rpb, float eps,
                                         int is_bf16, int sr, uint64_t key, void* stream) {
  if (M <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
#define QT_COL(T, SR) launch_col<SiluProducer<T>, SR>(silu_producer<T>(a, b, K), sc, q, s_out, amax, parts, M, rpb, \
                                                      eps, key, s)
  if (is_bf16) return sr ? QT_COL(__nv_bfloat16, true) : QT_COL(__nv_bfloat16, false);
  return sr ? QT_COL(float, true) : QT_COL(float, false);
#undef QT_COL
}

// B10: dx [M, K] in x's dtype, dg fp32 [K]; dg_part is fp32 scratch of
// ceil(M / rpb) * K floats.
extern "C" int qt_rmsnorm_bwd(const void* x, const void* g, const void* dy, void* dx, void* dg, void* dg_part,
                              int64_t M, int64_t K, int64_t rpb, float norm_eps, int is_bf16, void* stream) {
  if (M <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  return static_cast<int>(is_bf16 ? launch_bwd<__nv_bfloat16>(x, gf, dy, dx, dg, dg_part, M, K, rpb, norm_eps, s)
                                  : launch_bwd<float>(x, gf, dy, dx, dg, dg_part, M, K, rpb, norm_eps, s));
}
