// Building blocks of the row-walking kernels (fused_producers.cu, rope.cu,
// int8_quant.cu).
//
// A block of kThreads threads walks a run of rows; a thread owns the same
// 16-byte vectors of every row, so its loads are coalesced and the per-column
// state it keeps in shared memory (column maxima, partial sums) needs no
// atomics inside the block. Column state that spans blocks goes to an fp32
// [blocks, K] buffer, which reduce_parts folds over the blocks in a fixed
// order: the result is a function of the inputs, and no atomics are used.
// The int8 cast is the Pallas bodies' (ops/pallas_quant.py:75-87): q =
// rint(y * (1 / max(scale, eps))) with a correctly rounded reciprocal, or with
// SR floor(y * inv + u), u from the Philox stream (philox.cuh), clamped.
//
// The persistent form (RowWalk, fused_producers.cu's B7-B11): a group of
// TPR threads (whole warps) takes one row at a time, V vectors a thread with
// TPR V the row's vectors, so no lane idles; the next row's vectors are
// loaded before the group works on this row's, and a thread keeps its
// columns' running state in registers, since it owns the same columns in
// every row it takes. The casts round and convert by one add (byte_rn,
// byte_sr), where rintf and the float -> int cast each take a quarter-rate
// conversion an element.

#pragma once

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

// The N fp32 values v, rounded to T, as the 16-byte vector at p.
template <typename T, int N>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float (&v)[N]) {
  uint4 u;
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int j = 0; j < N; ++j) store_elem(&e[j], v[j]);
  *reinterpret_cast<uint4*>(p) = u;
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

// 1.5 * 2^23: v + kMagic is v rounded to an integer (half to even) for |v| <
// 2^22, held in the low bits of the sum's word, so one add rounds and
// converts, where rintf and a float -> int cast each take a quarter-rate
// conversion.
constexpr float kMagic = 12582912.0f;

// rint(q) clamped to [-128, 127], in the low byte of the word (clamping
// first rounds the same)
__device__ __forceinline__ uint32_t byte_rn(float q) {
  return __float_as_uint(__fadd_rn(fminf(fmaxf(q, -128.0f), 127.0f), kMagic));
}

// floor(q + u) clamped to [-128, 127], u the uniform of ``word``: the sum
// rounded to an integer by kMagic, less one where that rounded up
__device__ __forceinline__ uint32_t byte_sr(float q, uint32_t word) {
  const float s = __fadd_rn(q, qt::uniform_of(word));
  float r = __fsub_rn(__fadd_rn(s, kMagic), kMagic);
  r = r > s ? __fsub_rn(r, 1.0f) : r;
  return __float_as_uint(__fadd_rn(fminf(fmaxf(r, -128.0f), 127.0f), kMagic));
}

// the low bytes of 4 words, in order
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// The int8 of N products y[j] * inv_of(j) (quant<SR>'s values, bit for bit:
// |y inv| <= 127 (1 + 2^-23) < 2^22), stored as one N-byte pack at q; with
// SR element j draws word idx0 + j of the stream of ``key`` (idx0 % 4 == 0),
// four words a Philox call, each call's words used as soon as drawn.
template <bool SR, int N, class InvOf>
__device__ __forceinline__ void cast_pack_by(const float (&y)[N], InvOf inv_of, uint64_t idx0, uint64_t key,
                                             int8_t* q) {
  uint32_t b[N / 4];
#pragma unroll
  for (int k = 0; k < N / 4; ++k) {
    const uint4 w = SR ? qt::philox_block((idx0 >> 2) + k, key) : make_uint4(0u, 0u, 0u, 0u);
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
    uint32_t c[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float inv = inv_of(4 * k + j);
      const float r = __fmul_rn(y[4 * k + j], inv);
      c[j] = SR ? byte_sr(r, words[j]) : byte_rn(r);
    }
    b[k] = pack4(c[0], c[1], c[2], c[3]);
  }
  if constexpr (N == 8) {
    *reinterpret_cast<uint2*>(q) = make_uint2(b[0], b[1]);
  } else {
    *reinterpret_cast<unsigned int*>(q) = b[0];
  }
}

// cast_pack_by with one inverse scale (a row's) for every element
template <bool SR, int N>
__device__ __forceinline__ void cast_pack(const float (&y)[N], float inv, uint64_t idx0, uint64_t key, int8_t* q) {
  cast_pack_by<SR, N>(y, [inv](int) { return inv; }, idx0, key, q);
}

// cast_pack_by with element j's own inverse scale inv[j] (its column's)
template <bool SR, int N>
__device__ __forceinline__ void cast_pack(const float (&y)[N], const float (&inv)[N], uint64_t idx0, uint64_t key,
                                          int8_t* q) {
  cast_pack_by<SR, N>(y, [&inv](int j) { return inv[j]; }, idx0, key, q);
}

// The inverse scale of the cast: 1 / max(scale, eps), correctly rounded.
__device__ __forceinline__ float inv_scale(float s, float eps) { return __frcp_rn(fmaxf(s, eps)); }

// Words idx0 .. idx0 + N - 1 of the stream of ``key`` with SR, else zeros.
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

template <int N>
union Int8Pack {
  typename PackOf<N>::type pack;
  int8_t c[N];
};

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

// Zero this thread's entries of a shared per-column array [K] (layout
// [j * nv + i] for its vectors i, so a warp's accesses hit distinct banks).
template <int N>
__device__ __forceinline__ void zero_cols(float* acc, int64_t K) {
  const int64_t nv = K / N;
  for (int64_t i = threadIdx.x; i < nv; i += kThreads)
#pragma unroll
    for (int j = 0; j < N; ++j) acc[j * nv + i] = 0.0f;
}

// This thread's entries of the block's column maxima (or sums) [K], in the
// shared layout [j * nv + i], to row blockIdx.x of parts [blocks, ld] at
// column offset col0.
template <int N>
__device__ __forceinline__ void store_part(const float* acc, float* __restrict__ parts, int64_t K, int64_t ld = 0,
                                           int64_t col0 = 0) {
  const int64_t nv = K / N;
  if (ld == 0) ld = K;
  for (int64_t i = threadIdx.x; i < nv; i += kThreads)
#pragma unroll
    for (int j = 0; j < N; ++j) parts[static_cast<int64_t>(blockIdx.x) * ld + col0 + i * N + j] = acc[j * nv + i];
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

// ---- the persistent row walk ------------------------------------------------

// Group grp of a CTA's groups of TPR threads takes rows grp + groups *
// blockIdx.x, then every groups * gridDim.x-th row after it; thread t of the
// group holds vector t + p TPR (p < V) of each of its rows, in each of NIN
// inputs [M, nv] of 16-byte vectors (nv = TPR V).
template <int V, int NIN>
struct RowWalk {
  int tpr, grp, t;
  __device__ explicit RowWalk(int tpr_) : tpr(tpr_), grp(threadIdx.x / tpr_), t(threadIdx.x % tpr_) {}
  __device__ int64_t vec(int p) const { return t + static_cast<int64_t>(p) * tpr; }
  __device__ void load(const uint4* const (&in)[NIN], int64_t row, int64_t nv, uint4 (&u)[NIN][V]) const {
#pragma unroll
    for (int k = 0; k < NIN; ++k)
#pragma unroll
      for (int p = 0; p < V; ++p) u[k][p] = in[k][row * nv + vec(p)];
  }
  // body(row, u) on each of the group's rows in turn, u the row's vectors:
  // the next row's are loaded before the body runs on this row's, so that
  // every warp has loads in flight while it computes
  template <class Body>
  __device__ void run(const uint4* const (&in)[NIN], int64_t M, int64_t nv, Body&& body) const {
    run_by<uint4[NIN][V]>(M, [&](int64_t row, uint4 (&u)[NIN][V]) { load(in, row, nv, u); }, body);
  }
  // run over rows that fetch(row, u) loads into a Buf u, not [M, nv] rows of
  // vectors (B14's strided attention output, with the row's scale)
  template <class Buf, class Fetch, class Body>
  __device__ void run_by(int64_t M, Fetch&& fetch, Body&& body) const {
    const int64_t groups = blockDim.x / tpr, stride = groups * gridDim.x;
    Buf a, b;
    int64_t i = blockIdx.x * groups + grp;
    if (i < M) fetch(i, a);
    while (i < M) {
      const int64_t j = i + stride;
      if (j < M) fetch(j, b);
      body(i, a);
      if (j >= M) break;
      i = j + stride;
      if (i < M) fetch(i, a);
      body(j, b);
    }
  }
};

// Wait for the TPR threads of group grp (named barrier 1 + grp; 0 is
// __syncthreads'), so that one group's row exchange never waits for another.
__device__ __forceinline__ void group_sync(int grp, int tpr) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + grp), "r"(tpr) : "memory");
}

// ---- launch helpers ---------------------------------------------------------

unsigned int n_blocks(int64_t M, int64_t rpb) { return static_cast<unsigned int>((M + rpb - 1) / rpb); }

// Opt a kernel into more than 48 KB of shared memory when its dynamic
// ``smem`` and its static arrays together need it: the default limit counts
// both, so 48 KB of dynamic memory (two fp32 rows at K = 6144) plus a
// kernel's red[kWarps] fails to launch without the opt-in.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  constexpr size_t kDefault = 48 * 1024;
  if (smem + 1024 <= kDefault) return cudaSuccess;  // the static arrays here are far below 1 KB
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess || smem + attr.sharedSizeBytes <= kDefault) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
}

}  // namespace
