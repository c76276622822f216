// K1: row-wise absmax int8 quantize, x [M, K] -> q int8 [M, K], scale [M, 1].
//
// Replaces the TPU kernel quantized_training_tpu/ops/pallas_quant.py::
// quantize_int8_rowwise (:139). Numerics follow quant/core.py:99-115, not the
// Pallas kernel: scale = absmax / 127 in fp32, q = rint(x / max(scale, eps))
// with an IEEE division (the Pallas kernel multiplies by a reciprocal and may
// differ by 1 LSB), clamped to [-128, 127]. The scale is stored in x's dtype,
// which is the cast core.py:115 applies before the GEMM epilogue reads it.
//
// Bound on the H100: bytes. The kernel does about 3 flops per element, so it
// runs at memory speed; under the dynamic scheme it re-reads every bf16 weight
// on every matmul of every decode step, which makes it the largest byte mover
// of the serving path. Design: one 256-thread block per row for rows of 1024
// elements or more (activations, weights), so even the 8 rows of a decode
// step spread over 8 SMs; one warp per row below that (KV rows of 64). Each
// thread moves 16 bytes per load; the absmax pass and the cast pass read the
// same row, so the second read hits L1/L2 rather than device memory. Rows
// whose length or base is not 16-byte aligned take a scalar loop.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;        // 8 warps
constexpr int64_t kBlockRowMinK = 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store_scale(float* p, float s) { *p = s; }
__device__ __forceinline__ void store_scale(__nv_bfloat16* p, float s) {
  *p = __float2bfloat16_rn(s);
}

__device__ __forceinline__ int8_t quant_one(float v, float denom) {
  // rintf rounds half to even, as jnp.round / torch.round do
  float r = rintf(__fdiv_rn(v, denom));
  r = fminf(fmaxf(r, -128.0f), 127.0f);
  return static_cast<int8_t>(r);
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

// Cast the same elements to int8 given the row's max(scale, eps).
template <typename T, int STRIDE>
__device__ __forceinline__ void row_cast(const T* __restrict__ xr, int8_t* __restrict__ qr, int64_t K,
                                         bool vec, int tid, float denom) {
  constexpr int N = 16 / sizeof(T);
  using Pack = typename PackOf<N>::type;
  if (vec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    Pack* qv = reinterpret_cast<Pack*>(qr);
    for (int64_t i = tid; i < K / N; i += STRIDE) {
      uint4 u = xv[i];
      const T* e = reinterpret_cast<const T*>(&u);
      union {
        Pack p;
        int8_t c[N];
      } out;
#pragma unroll
      for (int j = 0; j < N; ++j) out.c[j] = quant_one(to_f32(e[j]), denom);
      qv[i] = out.p;
    }
  } else {
    for (int64_t i = tid; i < K; i += STRIDE) qr[i] = quant_one(to_f32(xr[i]), denom);
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Short rows (K < kBlockRowMinK, e.g. KV rows of hd = 64): one warp per row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_rows_warp(const T* __restrict__ x, int8_t* __restrict__ q, T* __restrict__ scale,
                   int64_t M, int64_t K, float eps, bool vec) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= M) return;  // whole warps leave together
  const float s = __fdiv_rn(warp_max(row_absmax<T, 32>(x + row * K, K, vec, lane)), 127.0f);
  row_cast<T, 32>(x + row * K, q + row * K, K, vec, lane, fmaxf(s, eps));
  if (lane == 0) store_scale(scale + row, s);
}

// Long rows (activations and weights, K >= kBlockRowMinK): one block per
// row, so even the 8 rows of a decode step spread over 8 SMs.
template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_rows_block(const T* __restrict__ x, int8_t* __restrict__ q, T* __restrict__ scale,
                    int64_t K, float eps, bool vec) {
  __shared__ float part[kThreads / 32];
  const int64_t row = blockIdx.x;
  float amax = warp_max(row_absmax<T, kThreads>(x + row * K, K, vec, threadIdx.x));
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = amax;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) amax = fmaxf(amax, part[w]);
  const float s = __fdiv_rn(amax, 127.0f);
  row_cast<T, kThreads>(x + row * K, q + row * K, K, vec, threadIdx.x, fmaxf(s, eps));
  if (threadIdx.x == 0) store_scale(scale + row, s);
}

template <typename T>
cudaError_t launch(const void* x, void* q, void* scale, int64_t M, int64_t K, float eps,
                   cudaStream_t stream) {
  const bool vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) && (K % (16 / sizeof(T)) == 0);
  const T* xt = static_cast<const T*>(x);
  int8_t* qt = static_cast<int8_t*>(q);
  T* st = static_cast<T*>(scale);
  if (K >= kBlockRowMinK) {
    quantize_rows_block<T><<<static_cast<unsigned int>(M), kThreads, 0, stream>>>(xt, qt, st, K, eps, vec);
  } else {
    const int64_t blocks = (M + kThreads / 32 - 1) / (kThreads / 32);
    quantize_rows_warp<T><<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(xt, qt, st, M, K, eps, vec);
  }
  return cudaGetLastError();
}

}  // namespace

// Returns the launch's cudaError_t (0 on success). is_bf16: x and scale are
// bf16, else fp32. x and q are contiguous [M, K]; scale is [M].
extern "C" int qt_quantize_int8_rowwise(const void* x, void* q, void* scale, int64_t M,
                                        int64_t K, float eps, int is_bf16, void* stream) {
  if (M <= 0 || K <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_bf16 ? launch<__nv_bfloat16>(x, q, scale, M, K, eps, s)
                                  : launch<float>(x, q, scale, M, K, eps, s));
}
