// The scaled int8 GEMM in three layouts, and its packed-int4 form, each a
// form of
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
// - B16: a [M, K / 2] . b [N, K / 2]^T, both packed signed int4 (two values a
//   byte, the even one in the high nibble), K-major: every matmul of int4
//   mixed precision. Replaces ops/pallas_mm.py::scaled_int4_mm (:636). The
//   operands cross device memory at 4 bits a value and are widened to int8
//   on chip for the int8 MMA: the H100 lists no int4 tensor-core rate, so
//   the .s4 mma shapes are not used. int32 sums are exact, so B16 equals the
//   JAX package's hi . hi + lo . lo split (pallas_mm.py:600-633) whatever
//   order it sums in.
//
// Bound on the H100: at training and prefill M the int8 tensor-core rate; at
// decode M = 8 the bytes of the int8 weight, read once per call. No operand
// is ever transposed in device memory (the JAX package's rule,
// quant/mixed_precision.py:192-195). K2 at M > 16, B1, B2, and B16 at M > 16
// with K % 32 == 0 run on the pipelined TMA + wgmma mainloop of
// sm90_gemm.cuh (its note says how it answers the bound; B1, B2 and B16
// through a producer that rewrites the landed tiles into wgmma's K-major
// layout); the caller decides that route and passes it in (ops/scaled_mm.py::
// sm90_route, ::rhs_mn_sm90_route and ::lhs_t_sm90_route, ops/int4_mm.py::
// sm90_route).
//
// Everything below is the wmma kernel of K2's and B16's decode tiles, and of
// B16 at a K that TMA cannot describe packed (K % 32 != 0), past the
// mainloop's exact range (K >= 2^17), or on operands off a 16-byte
// boundary: both operands K-major. Tiles go through shared memory in 16x16
// blocks of 16-byte rows (mm_tiles.cuh), so that every wmma fragment load is
// 256-bit aligned with a leading dimension of 16. wmma m16n16k16
// signed-char fragments accumulate in int32; one kernel, templated on
// packed operands, serves both GEMMs; B16's load stage unpacks each 8-byte
// chunk to 16 sign-extended int8 values in registers (mm_tiles.cuh). Tiles:
// 64x64 with a K step of 64, and at M <= 16 a 16x32 tile with a K step of
// 256, so a decode call keeps more weight bytes in flight per block. Ragged
// rows are zero-filled on load and masked on store. The next K tile is
// fetched into registers while the current one runs through the MMAs.

#include <mma.h>

#include "mm_tiles.cuh"
#include "sm90_gemm.cuh"

using namespace nvcuda;
using qt_mm::frag;
using qt_mm::Src;
using qt_mm::store_out;
using qt_mm::TileCopy;
using qt_mm::to_f32;

namespace {

// a and b K-major (K2's and B16's decode tiles, B16 off the sm90 route). S:
// S8, or S4 for packed int4 operands.
template <int BM, int BN, int BK, int WARPS_M, int WARPS_N, Src S, typename ST, typename OT>
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
  using LayoutA = wmma::row_major;
  using LayoutB = wmma::col_major;

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

  TileCopy<BM, BK, NT, true, S> ta;
  TileCopy<BN, BK, NT, true, S> tb;
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
        wmma::load_matrix_sync(fa[i], frag<BM, BK, true>(As, c, wm * WM + i * 16), 16);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], frag<BN, BK, true>(Bs, c, wn * WN + j * 16), 16);
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

template <int BM, int BN, int BK, int WARPS_M, int WARPS_N, Src S, typename ST, typename OT>
cudaError_t launch_tiles(const void* a, const void* b, const void* sa, const void* sb, void* out,
                         int M, int N, int K, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  scaled_mm_s8<BM, BN, BK, WARPS_M, WARPS_N, S, ST, OT>
      <<<grid, WARPS_M * WARPS_N * 32, 0, stream>>>(
          static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
          static_cast<const ST*>(sa), static_cast<const ST*>(sb), static_cast<OT*>(out), M, N, K);
  return cudaGetLastError();
}

template <Src S, typename ST, typename OT>
cudaError_t launch(const void* a, const void* b, const void* sa, const void* sb, void* out, int M,
                   int N, int K, cudaStream_t stream) {
  if constexpr (S == Src::S8) {  // K2 off the sm90 route: the decode sizes
    return launch_tiles<16, 32, 256, 1, 2, S, ST, OT>(a, b, sa, sb, out, M, N, K, stream);
  } else {
    if (M <= 16) return launch_tiles<16, 32, 256, 1, 2, S, ST, OT>(a, b, sa, sb, out, M, N, K, stream);
    return launch_tiles<64, 64, 64, 2, 2, S, ST, OT>(a, b, sa, sb, out, M, N, K, stream);
  }
}

template <Src S>
cudaError_t launch_dtypes(const void* a, const void* b, const void* sa, const void* sb, void* out,
                          int M, int N, int K, int scale_bf16, int out_bf16, cudaStream_t s) {
  using BF = __nv_bfloat16;
  if (scale_bf16)
    return out_bf16 ? launch<S, BF, BF>(a, b, sa, sb, out, M, N, K, s)
                    : launch<S, BF, float>(a, b, sa, sb, out, M, N, K, s);
  return out_bf16 ? launch<S, float, BF>(a, b, sa, sb, out, M, N, K, s)
                  : launch<S, float, float>(a, b, sa, sb, out, M, N, K, s);
}

// K2, B1, B2 or B16 on sm90_gemm.cuh (Form S8KMajor, S8MnB, S8MnMajor or
// S4KMajor), in the same four (scale, out) types.
template <class Form>
cudaError_t launch_sm90(const void* a, const void* b, const void* sa, const void* sb, void* out, int M, int N,
                        int K, int scale_bf16, int out_bf16, cudaStream_t s) {
  using BF = __nv_bfloat16;
  using qt_sm90::scaled;
  if (scale_bf16)
    return out_bf16 ? scaled<Form, BF, BF>(a, b, sa, sb, out, M, N, K, s)
                    : scaled<Form, BF, float>(a, b, sa, sb, out, M, N, K, s);
  return out_bf16 ? scaled<Form, float, BF>(a, b, sa, sb, out, M, N, K, s)
                  : scaled<Form, float, float>(a, b, sa, sb, out, M, N, K, s);
}

}  // namespace

// Returns the launch's cudaError_t (0 on success). a_kmajor: a is [M, K],
// else [K, M]; b_kmajor: b is [N, K], else [K, N]; (0, 1) is not a form the
// port uses and is refused. Operands are contiguous int8, 16-byte aligned,
// each with its row length (K where it is K-major, M or N where it is
// MN-major) a multiple of 16. sa [M] and sb [N] are bf16 if scale_bf16 else fp32; out
// [M, N] is bf16 if out_bf16 else fp32. sm90: the (1, 1) form on the
// sm90_gemm.cuh mainloop, else on the wmma kernel; the (1, 0) and (0, 0)
// forms run on the mainloop only, with K > 0 (sm90 = 0 is refused).
extern "C" int qt_scaled_mm_s8(const void* a, const void* b, const void* sa, const void* sb,
                               void* out, int M, int N, int K, int a_kmajor, int b_kmajor,
                               int scale_bf16, int out_bf16, int sm90, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (a_kmajor && b_kmajor) {
    err = sm90 ? launch_sm90<qt_sm90::S8KMajor>(a, b, sa, sb, out, M, N, K, scale_bf16, out_bf16, s)
               : launch_dtypes<Src::S8>(a, b, sa, sb, out, M, N, K, scale_bf16, out_bf16, s);
  } else if (K <= 0) {
    err = cudaErrorInvalidValue;
  } else if (a_kmajor && sm90) {
    err = launch_sm90<qt_sm90::S8MnB>(a, b, sa, sb, out, M, N, K, scale_bf16, out_bf16, s);
  } else if (!a_kmajor && !b_kmajor && sm90) {
    err = launch_sm90<qt_sm90::S8MnMajor>(a, b, sa, sb, out, M, N, K, scale_bf16, out_bf16, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// B16. a [M, K / 2] and b [N, K / 2] packed signed int4, contiguous, 8-byte
// aligned, K the unpacked contraction length with K % 16 == 0; sa [M], sb
// [N], out [M, N] as for qt_scaled_mm_s8. sm90: on the sm90_gemm.cuh
// mainloop, which needs K % 32 == 0 (16-byte packed rows), K < 2^17 (its
// int32 sums of 256 x each product) and 16-byte aligned operands; else on
// the wmma kernel. Returns the launch's cudaError_t.
extern "C" int qt_scaled_int4_mm(const void* a, const void* b, const void* sa, const void* sb,
                                 void* out, int M, int N, int K, int scale_bf16, int out_bf16, int sm90,
                                 void* stream) {
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (sm90) {
    err = K % 32 || K >= (1 << 17) ? cudaErrorInvalidValue
                 : launch_sm90<qt_sm90::S4KMajor>(a, b, sa, sb, out, M, N, K, scale_bf16, out_bf16, s);
  } else {
    err = launch_dtypes<Src::S4>(a, b, sa, sb, out, M, N, K, scale_bf16, out_bf16, s);
  }
  return static_cast<int>(err);
}
