// K2: scaled int8 GEMM in the weight-stationary (1,1) form,
//   out[M, N] = ((float)(A[M, K] . B[N, K]^T) * sa[M]) * sb[N]
// with exact int32 accumulation and the fp32 epilogue of
// quantized_training_tpu/ops/scaled_mm.py:183-188, rounded once to the output
// dtype.
//
// Replaces the TPU kernel quantized_training_tpu/ops/pallas_mm.py::
// scaled_mm_dims (:192) with dims=(1, 1) (on the TPU's default backend this
// product went to XLA's int8 dot).
//
// Bound on the H100: at prefill M (hundreds of tokens) the int8 tensor-core
// rate; at decode M = 8 the bytes of the int8 weight, read once per call.
// Design: both operands are K-major, which is the layout the int8 MMA takes,
// so no transpose is ever materialised. Tiles go through shared memory in
// 16-byte K chunks stored fragment-contiguous ([chunk][row][16]), so every
// wmma load is 256-bit aligned; wmma m16n16k16 signed-char fragments
// accumulate in int32. Two tile shapes: 64x64 (K step 64) for prefill, and
// 16x32 with a K step of 256 for M <= 16, so a decode call keeps more weight
// bytes in flight per block. Ragged M and N are zero-filled on load and
// masked on store. No wgmma, TMA or pipelining yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Copy rows [r0, r0 + R) x cols [k0, k0 + BK) of a K-major int8 matrix into
// smem laid out [BK / 16][R][16], zero-filling outside [0, rows) x [0, K).
template <int R, int BK, int NT>
__device__ __forceinline__ void load_tile(int8_t (*dst)[R][16], const int8_t* __restrict__ src,
                                          int r0, int rows, int k0, int K) {
  constexpr int CH = BK / 16;
  for (int idx = threadIdx.x; idx < R * CH; idx += NT) {
    const int r = idx / CH, c = idx % CH;
    const int gr = r0 + r, gk = k0 + c * 16;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (gr < rows && gk < K)  // K % 16 == 0: a chunk is wholly inside or outside
      v = *reinterpret_cast<const uint4*>(src + static_cast<int64_t>(gr) * K + gk);
    *reinterpret_cast<uint4*>(&dst[c][r][0]) = v;
  }
}

template <int BM, int BN, int BK, int WARPS_M, int WARPS_N, typename ST, typename OT>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32)
scaled_mm_s8(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
             const ST* __restrict__ sa, const ST* __restrict__ sb, OT* __restrict__ out,
             int M, int N, int K) {
  constexpr int NT = WARPS_M * WARPS_N * 32;
  constexpr int CH = BK / 16;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  constexpr int FM = WM / 16, FN = WN / 16;
  constexpr int LDC = BN + 4;
  static_assert(WM % 16 == 0 && WN % 16 == 0, "warp tile must be whole fragments");

  __shared__ __align__(128) int8_t As[CH][BM][16];
  __shared__ __align__(128) int8_t Bs[CH][BN][16];
  __shared__ __align__(128) int Cs[BM][LDC];

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0);

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_tile<BM, BK, NT>(As, a, m0, M, k0, K);
    load_tile<BN, BK, NT>(Bs, b, n0, N, k0, K);
    __syncthreads();
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], reinterpret_cast<const signed char*>(&As[c][wm * WM + i * 16][0]), 16);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], reinterpret_cast<const signed char*>(&Bs[c][wn * WN + j * 16][0]), 16);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(&Cs[wm * WM + i * 16][wn * WN + j * 16], acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();

  for (int idx = threadIdx.x; idx < BM * BN; idx += NT) {
    const int r = idx / BN, c = idx % BN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm < M && gn < N) {
      // same association as scaled_mm.py: (acc * sa) * sb, all fp32
      const float v = (static_cast<float>(Cs[r][c]) * to_f32(sa[gm])) * to_f32(sb[gn]);
      store_out(out + static_cast<int64_t>(gm) * N + gn, v);
    }
  }
}

template <int BM, int BN, int BK, int WARPS_M, int WARPS_N, typename ST, typename OT>
cudaError_t launch_tiles(const void* a, const void* b, const void* sa, const void* sb, void* out,
                         int M, int N, int K, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  scaled_mm_s8<BM, BN, BK, WARPS_M, WARPS_N, ST, OT><<<grid, WARPS_M * WARPS_N * 32, 0, stream>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b), static_cast<const ST*>(sa),
      static_cast<const ST*>(sb), static_cast<OT*>(out), M, N, K);
  return cudaGetLastError();
}

template <typename ST, typename OT>
cudaError_t launch(const void* a, const void* b, const void* sa, const void* sb, void* out, int M,
                   int N, int K, cudaStream_t stream) {
  if (M <= 16) return launch_tiles<16, 32, 256, 1, 2, ST, OT>(a, b, sa, sb, out, M, N, K, stream);
  return launch_tiles<64, 64, 64, 2, 2, ST, OT>(a, b, sa, sb, out, M, N, K, stream);
}

}  // namespace

// Returns the launch's cudaError_t (0 on success). a [M, K] and b [N, K] are
// contiguous int8 with K % 16 == 0 and 16-byte aligned bases; sa [M] and
// sb [N] are bf16 if scale_bf16 else fp32; out [M, N] is bf16 if out_bf16
// else fp32.
extern "C" int qt_scaled_mm_s8(const void* a, const void* b, const void* sa, const void* sb,
                               void* out, int M, int N, int K, int scale_bf16, int out_bf16,
                               void* stream) {
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (scale_bf16) {
    err = out_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(a, b, sa, sb, out, M, N, K, s)
                   : launch<__nv_bfloat16, float>(a, b, sa, sb, out, M, N, K, s);
  } else {
    err = out_bf16 ? launch<float, __nv_bfloat16>(a, b, sa, sb, out, M, N, K, s)
                   : launch<float, float>(a, b, sa, sb, out, M, N, K, s);
  }
  return static_cast<int>(err);
}
