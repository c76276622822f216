// B17: the plain tiled matmul out[M, N] = A[M, K] . B[K, N], with the
// accumulator of quantized_training_tpu/ops/pallas_mm.py::matmul (:537):
// int32 for int8 operands, fp32 for bf16 ones, rounded once to the output
// type (int32; fp32 or bf16). Replaces that function, whose only caller
// outside the tests is benchmark_mm.py's pallas_bf16 row.
//
// Bound on the H100 at the benchmark's square sizes: the tensor cores, 989
// TFLOP/s dense in bf16 and 1,979 TOP/s in int8 (4096^3: 139 us and 69 us);
// the bytes (two operands read once, the output written once) bound it only
// below about n = 900 in bf16. Design: where TMA can describe both operands
// (each 16-byte aligned, its rows a multiple of 16 bytes long), both forms
// run on the pipelined TMA + wgmma mainloop of sm90_gemm.cuh. a is K-major
// and b MN-major in either form. The bf16 forms read b MN-major through
// wgmma's transpose bit (Bf16MnB); 8-bit wgmma reads its operands K-major
// only, so the int8 form takes B1's S8MnB form, whose producer warpgroup
// transposes each landed tile of b into the K-major stage, and stores the
// int32 sums as they are (IntOut: exact at any K the int32 range holds). The
// caller decides that route and passes it in (ops/matmul.py::sm90_route).
// The operands TMA cannot describe (a base off a 16-byte boundary, or rows
// not a multiple of 16 bytes long) take the wmma kernel below, the tile
// machinery of mm_tiles.cuh: each operand copied into shared memory as it is
// in 16x16 fragment blocks (bf16 m16n16k16 fragments with fp32 accumulators,
// or signed-char fragments with int32 ones), 64x64 tiles with a K step of 64
// on four warps, the next K tile fetched into registers while the current
// one runs through the MMAs. Any shape: ragged edges are zero-filled value
// by value on load (the sums are the same as over zero-padded copies, which
// are never made) and masked on store.

#include <mma.h>

#include "mm_tiles.cuh"
#include "sm90_gemm.cuh"

using namespace nvcuda;
using qt_mm::frag;
using qt_mm::SmemT;
using qt_mm::Src;
using qt_mm::TileCopy;

namespace {

__device__ __forceinline__ void store_acc(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_acc(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store_acc(int* p, int v) { *p = v; }

// S: BF16 (fp32 accumulators, OT float or bf16) or S8 (int32, OT int).
template <int BM, int BN, int BK, int WARPS_M, int WARPS_N, Src S, typename OT>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32)
matmul_kernel(const void* __restrict__ a, const void* __restrict__ b, OT* __restrict__ out, int M, int N, int K,
              bool a_vec, bool b_vec) {
  using T = SmemT<S>;
  using FragT = std::conditional_t<S == Src::BF16, __nv_bfloat16, signed char>;
  using AccT = std::conditional_t<S == Src::BF16, float, int>;
  constexpr int NT = WARPS_M * WARPS_N * 32;
  constexpr int CH = BK / 16;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  constexpr int FM = WM / 16, FN = WN / 16;
  constexpr int LDC = BN + 4;
  static_assert(WM % 16 == 0 && WN % 16 == 0, "warp tile must be whole fragments");

  __shared__ __align__(128) T As[BM * BK];
  __shared__ __align__(128) T Bs[BN * BK];
  __shared__ __align__(128) AccT Cs[BM][LDC];

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;

  wmma::fragment<wmma::accumulator, 16, 16, 16, AccT> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], AccT(0));

  TileCopy<BM, BK, NT, true, S> ta;   // a [M, K], K-major
  TileCopy<BN, BK, NT, false, S> tb;  // b [K, N], MN-major
  ta.fetch_masked(a, m0, M, 0, K, a_vec);
  tb.fetch_masked(b, n0, N, 0, K, b_vec);
  for (int k0 = 0; k0 < K; k0 += BK) {
    ta.store(As);
    tb.store(Bs);
    __syncthreads();
    if (k0 + BK < K) {  // the next K tile's loads run under this tile's MMAs
      ta.fetch_masked(a, m0, M, k0 + BK, K, a_vec);
      tb.fetch_masked(b, n0, N, k0 + BK, K, b_vec);
    }
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, FragT, wmma::row_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, FragT, wmma::row_major> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], reinterpret_cast<const FragT*>(frag<BM, BK, true>(As, c, wm * WM + i * 16)),
                               16);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], reinterpret_cast<const FragT*>(frag<BN, BK, false>(Bs, c, wn * WN + j * 16)),
                               16);
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
      wmma::store_matrix_sync(&Cs[wm * WM + i * 16][wn * WN + j * 16], acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();

  for (int idx = threadIdx.x; idx < BM * BN; idx += NT) {
    const int r = idx / BN, c = idx % BN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm < M && gn < N) store_acc(out + static_cast<int64_t>(gm) * N + gn, Cs[r][c]);
  }
}

template <Src S, typename OT>
cudaError_t launch(const void* a, const void* b, void* out, int M, int N, int K, int a_vec, int b_vec,
                   cudaStream_t stream) {
  constexpr int BM = 64, BN = 64, BK = 64;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  matmul_kernel<BM, BN, BK, 2, 2, S, OT><<<grid, 128, 0, stream>>>(a, b, static_cast<OT*>(out), M, N, K, a_vec != 0,
                                                                   b_vec != 0);
  return cudaGetLastError();
}

}  // namespace

// Returns the launch's cudaError_t (0 on success). a [M, K] and b [K, N],
// contiguous, both int8 (is_bf16 = 0: out int32) or both bf16 (out fp32, or
// bf16 where out_bf16). a_vec / b_vec: the operand starts on a 16-byte
// boundary and its rows are a multiple of 16 bytes long, so whole chunks
// load as vectors. sm90: the sm90_gemm.cuh mainloop, which needs a_vec,
// b_vec and K > 0.
extern "C" int qt_matmul(const void* a, const void* b, void* out, int M, int N, int K, int is_bf16, int out_bf16,
                         int a_vec, int b_vec, int sm90, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (sm90) {
    err = !a_vec || !b_vec || K <= 0 || (!is_bf16 && out_bf16) ? cudaErrorInvalidValue
          : !is_bf16                                             ? qt_sm90::matmul_s8(a, b, out, M, N, K, s)
          : out_bf16 ? qt_sm90::matmul_bf16<__nv_bfloat16>(a, b, out, M, N, K, s)
                     : qt_sm90::matmul_bf16<float>(a, b, out, M, N, K, s);
  } else if (!is_bf16) {
    err = out_bf16 ? cudaErrorInvalidValue : launch<Src::S8, int>(a, b, out, M, N, K, a_vec, b_vec, s);
  } else if (out_bf16) {
    err = launch<Src::BF16, __nv_bfloat16>(a, b, out, M, N, K, a_vec, b_vec, s);
  } else {
    err = launch<Src::BF16, float>(a, b, out, M, N, K, a_vec, b_vec, s);
  }
  return static_cast<int>(err);
}
