// The scaled int8 GEMM in three layouts, each a form of
//   out[M, N] = ((float)(sum_k A[m, k] * B[k, n]) * sa[m]) * sb[n]
// with exact int32 accumulation and the fp32 epilogue of
// quantized_training_tpu/ops/scaled_mm.py:183-188, rounded once to the output
// dtype. Each operand is stored either K-major (its rows run along the
// contraction axis) or MN-major (the contraction axis is its slow axis):
//
// - K2, (1,1): a [M, K] . b [N, K]^T, both K-major: the forward x . w^T.
//   Replaces ops/pallas_mm.py::scaled_mm_dims (:192) with dims=(1, 1).
// - B1, (1,0): a [M, K] . b [K, N], a K-major, b MN-major: the backward's
//   grad_input g . w. Replaces ops/pallas_mm.py::scaled_mm (:85).
// - B2, (0,0): a [K, M]^T . b [K, N], both MN-major: the backward's
//   grad_weight g^T . x over the tokens. Replaces ops/pallas_mm.py::
//   scaled_mm_dims (:192) with dims=(0, 0).
//
// Bound on the H100: at training and prefill M the int8 tensor-core rate; at
// decode M = 8 the bytes of the int8 weight, read once per call. Design: no
// operand is ever transposed in device memory (the JAX package's rule,
// quant/mixed_precision.py:192-195). Tiles go through shared memory in 16x16
// blocks of 16-byte rows, laid out so that every wmma fragment load is
// 256-bit aligned with a leading dimension of 16: a K-major tile as
// [K / 16][rows][16] (16-byte chunks along K), an MN-major one as
// [rows / 16][K][16] (16-byte chunks along M or N). wmma m16n16k16
// signed-char fragments take either layout (row_major / col_major) and
// accumulate in int32, so one kernel, templated on the two layouts, serves
// all three forms. Tiles: 64x64 with a K step of 64, and for the (1,1) form
// at M <= 16 a 16x32 tile with a K step of 256, so a decode call keeps more
// weight bytes in flight per block. Ragged rows are zero-filled on load and
// masked on store. The next K tile is fetched into registers while the
// current one runs through the MMAs. No wgmma, TMA or cp.async yet: wgmma
// takes 8-bit operands K-major only, so a faster (1,0)/(0,0) needs its
// operands written K-major by the quantize, a design question for a later PR.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// One thread's share of an operand tile, rows [r0, r0 + R) x contraction
// [k0, k0 + BK): fetch() reads its 16-byte chunks into registers, zero-filling
// outside [0, rows) x [0, K); store() writes them to shared memory.
// K-major (src [rows, K]): chunks along K, stored [BK / 16][R][16].
// MN-major (src [K, rows], rows % 16 == 0): chunks along the rows, stored
// [R / 16][BK][16]. Consecutive threads read consecutive 16 bytes, and a
// thread issues all of its loads before it waits on any.
template <int R, int BK, int NT, bool KMAJOR>
struct TileCopy {
  static constexpr int CH = KMAJOR ? BK / 16 : R / 16;  // chunks along the contiguous axis
  static constexpr int ITERS = R * BK / 16 / NT;
  static_assert(R * BK / 16 % NT == 0, "every thread copies the same number of chunks");
  uint4 v[ITERS];

  __device__ __forceinline__ void fetch(const int8_t* __restrict__ src, int r0, int rows, int k0,
                                        int K) {
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int idx = threadIdx.x + it * NT, slow = idx / CH, c = idx % CH;
      bool inside;
      int64_t off;
      if constexpr (KMAJOR) {  // slow: the tile row; c: the K chunk
        const int gr = r0 + slow, gk = k0 + c * 16;
        inside = gr < rows && gk < K;  // K % 16 == 0: a chunk is wholly inside or outside
        off = static_cast<int64_t>(gr) * K + gk;
      } else {  // slow: the k index; c: the row chunk
        const int gk = k0 + slow, gr = r0 + c * 16;
        inside = gk < K && gr < rows;  // rows % 16 == 0: likewise
        off = static_cast<int64_t>(gk) * rows + gr;
      }
      v[it] = inside ? *reinterpret_cast<const uint4*>(src + off) : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  __device__ __forceinline__ void store(int8_t* __restrict__ dst) const {
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int idx = threadIdx.x + it * NT, slow = idx / CH, c = idx % CH;
      *reinterpret_cast<uint4*>(dst + (KMAJOR ? c * R + slow : c * BK + slow) * 16) = v[it];
    }
  }
};

// The 16x16 fragment at contraction chunk c and tile row r (a multiple of 16).
template <int R, int BK, bool KMAJOR>
__device__ __forceinline__ const signed char* frag(const int8_t* tile, int c, int r) {
  const int off = KMAJOR ? (c * R + r) * 16 : ((r / 16) * BK + c * 16) * 16;
  return reinterpret_cast<const signed char*>(tile + off);
}

template <int BM, int BN, int BK, int WARPS_M, int WARPS_N, bool A_KMAJOR, bool B_KMAJOR,
          typename ST, typename OT>
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
  // a K-major A is row_major as wmma sees A[m][k]; a K-major B is col_major
  using LayoutA = std::conditional_t<A_KMAJOR, wmma::row_major, wmma::col_major>;
  using LayoutB = std::conditional_t<B_KMAJOR, wmma::col_major, wmma::row_major>;

  __shared__ __align__(128) int8_t As[BM * BK];
  __shared__ __align__(128) int8_t Bs[BN * BK];
  __shared__ __align__(128) int Cs[BM][LDC];

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0);

  TileCopy<BM, BK, NT, A_KMAJOR> ta;
  TileCopy<BN, BK, NT, B_KMAJOR> tb;
  ta.fetch(a, m0, M, 0, K);
  tb.fetch(b, n0, N, 0, K);
  for (int k0 = 0; k0 < K; k0 += BK) {
    ta.store(As);
    tb.store(Bs);
    __syncthreads();
    if (k0 + BK < K) {  // the next K tile's loads run under this tile's MMAs
      ta.fetch(a, m0, M, k0 + BK, K);
      tb.fetch(b, n0, N, k0 + BK, K);
    }
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, LayoutA> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, LayoutB> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], frag<BM, BK, A_KMAJOR>(As, c, wm * WM + i * 16), 16);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], frag<BN, BK, B_KMAJOR>(Bs, c, wn * WN + j * 16), 16);
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

template <int BM, int BN, int BK, int WARPS_M, int WARPS_N, bool AK, bool BKM, typename ST,
          typename OT>
cudaError_t launch_tiles(const void* a, const void* b, const void* sa, const void* sb, void* out,
                         int M, int N, int K, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  scaled_mm_s8<BM, BN, BK, WARPS_M, WARPS_N, AK, BKM, ST, OT>
      <<<grid, WARPS_M * WARPS_N * 32, 0, stream>>>(
          static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
          static_cast<const ST*>(sa), static_cast<const ST*>(sb), static_cast<OT*>(out), M, N, K);
  return cudaGetLastError();
}

template <bool AK, bool BKM, typename ST, typename OT>
cudaError_t launch(const void* a, const void* b, const void* sa, const void* sb, void* out, int M,
                   int N, int K, cudaStream_t stream) {
  if constexpr (AK && BKM) {
    if (M <= 16)
      return launch_tiles<16, 32, 256, 1, 2, AK, BKM, ST, OT>(a, b, sa, sb, out, M, N, K, stream);
  }
  return launch_tiles<64, 64, 64, 2, 2, AK, BKM, ST, OT>(a, b, sa, sb, out, M, N, K, stream);
}

template <bool AK, bool BKM>
cudaError_t launch_dtypes(const void* a, const void* b, const void* sa, const void* sb, void* out,
                          int M, int N, int K, int scale_bf16, int out_bf16, cudaStream_t s) {
  if (scale_bf16)
    return out_bf16 ? launch<AK, BKM, __nv_bfloat16, __nv_bfloat16>(a, b, sa, sb, out, M, N, K, s)
                    : launch<AK, BKM, __nv_bfloat16, float>(a, b, sa, sb, out, M, N, K, s);
  return out_bf16 ? launch<AK, BKM, float, __nv_bfloat16>(a, b, sa, sb, out, M, N, K, s)
                  : launch<AK, BKM, float, float>(a, b, sa, sb, out, M, N, K, s);
}

}  // namespace

// Returns the launch's cudaError_t (0 on success). a_kmajor: a is [M, K],
// else [K, M]; b_kmajor: b is [N, K], else [K, N]; (0, 1) is not a form the
// port uses and is refused. Operands are contiguous int8, 16-byte aligned,
// with K % 16 == 0 and every MN-major operand's row length (M or N) a
// multiple of 16. sa [M] and sb [N] are bf16 if scale_bf16 else fp32; out
// [M, N] is bf16 if out_bf16 else fp32.
extern "C" int qt_scaled_mm_s8(const void* a, const void* b, const void* sa, const void* sb,
                               void* out, int M, int N, int K, int a_kmajor, int b_kmajor,
                               int scale_bf16, int out_bf16, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (a_kmajor && b_kmajor) {
    err = launch_dtypes<true, true>(a, b, sa, sb, out, M, N, K, scale_bf16, out_bf16, s);
  } else if (a_kmajor) {
    err = launch_dtypes<true, false>(a, b, sa, sb, out, M, N, K, scale_bf16, out_bf16, s);
  } else if (!b_kmajor) {
    err = launch_dtypes<false, false>(a, b, sa, sb, out, M, N, K, scale_bf16, out_bf16, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
