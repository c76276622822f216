// B15: the tile-scaled GEMM with two accumulators (DeepSeek-V3's recipe),
//   out[M, N] = sum over K blocks kb of
//               (float)(A[:, kb] . B[kb, :]) * sa[m / QM, kb] * sb[kb, n / QN]
// accumulated in fp32 in block order as acc = acc + (part * sa) * sb, then
// rounded once to the output dtype. A [M, K] is K-major, B [K, N] MN-major
// (as quantize_fp8_block stores a weight block), sa [M / QM, K / QK] and sb
// [K / QK, N / QN] in their natural layouts, bf16 or fp32. Replaces
// ops/pallas_mm.py::tile_scaled_mm (:378, pallas_call at :451 for n_qk <= 32
// and :483 above: a split by Mosaic's lane rule on the scale blocks, which
// has no counterpart here) and its two-accumulator loop (:326-334).
//
// Two operand types:
// - int8: each K block's partial is an exact int32 tensor-core sum, rounded
//   to fp32 as the plain version rounds its float64 partial, so the kernel
//   is bit-exact with it;
// - e4m3 (the model's fp8 tile path): read from device memory at one byte a
//   value and widened to fp16 on chip (exact), then fp16 MMAs with fp32
//   accumulation. e4m3 wgmma would run at twice fp16's rate, but it
//   accumulates more coarsely than fp32: measured on the H100, 231-578
//   fp32 roundings of the folded magnitudes against the 133-172 the
//   tolerance allows (ab_sm90_forms.py's diag_b15_e4m3_wgmma; DeepSeek-V3's
//   report, on the same hardware, promotes every 128 K for this). The
//   block partial is an fp32 tensor-core sum, not the plain version's
//   rounded float64 one, so the e4m3 form is held to a stated tolerance.
//   The per-block rescale into the fp32 accumulator outside the tensor core
//   is the two-level accumulation that keeps the long-K error bounded.
//
// Bound on the H100: the tensor-core rate at the model's shapes (189 G ops at
// M=8192, N=5632, K=2048: 95.5 us at 1,979 T/s; 191 us at fp16's 989, the
// rate the e4m3 form's MMAs run at; the bytes, mostly the bf16 output,
// about 36 us). At QK % 128 == 0, which every call of the model has (QK =
// 128), both operand types run on the pipelined TMA + wgmma mainloop of
// sm90_gemm.cuh (S8MnB: a by TMA, b transposed on chip by the producer;
// E4m3F16: both widened to fp16 on chip by the producer; the fold after
// each quant block; its note says how); the caller decides that route and
// passes it in (ops/tile_scaled_mm.py::sm90_route).
//
// Below is the wmma kernel that runs the other quant blocks the wrapper
// takes (QK % 64 == 0, QK >= 128); its e4m3 form widens to fp16 on the way
// into shared memory. Design: a block owns a 64x64 output tile (four warps,
// 32x32 each) and walks K in steps of 64 (a quant block of QK >= 128 is whole
// steps); operand tiles go through shared memory in 16x16 fragment blocks
// (mm_tiles.cuh), the next K step fetched into registers under the MMAs. At
// the end of each quant block every warp stores its partial fragments to
// shared memory (wmma's register layout is opaque), and each lane folds its
// 32 outputs into fp32 registers with the block's scales, which the block
// reads once per quant block into shared memory (double-buffered, so no
// extra barrier). Ragged rows of A are zero-filled and masked on store.

#include <mma.h>

#include "mm_tiles.cuh"
#include "sm90_gemm.cuh"

using namespace nvcuda;
using qt_mm::frag;
using qt_mm::SmemT;
using qt_mm::Src;
using qt_mm::store_out;
using qt_mm::TileCopy;
using qt_mm::to_f32;

namespace {

constexpr int BM = 64, BN = 64, BK = 64, WARPS_M = 2, WARPS_N = 2;
constexpr int NT = WARPS_M * WARPS_N * 32;

template <Src S, typename ST, typename OT>
__global__ void __launch_bounds__(NT)
tile_scaled_mm_kernel(const void* __restrict__ a, const void* __restrict__ b,
                      const ST* __restrict__ sa, const ST* __restrict__ sb, OT* __restrict__ out,
                      int M, int N, int K, int qm, int qk, int qn) {
  constexpr bool INT = S == Src::S8;
  constexpr int CH = BK / 16;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  constexpr int FM = WM / 16, FN = WN / 16;
  constexpr int LDC = BN + 4;
  constexpr int PER = WM * WN / 32;  // outputs a lane folds and stores
  using E = SmemT<S>;
  using FragT = std::conditional_t<INT, signed char, __half>;
  using Acc = std::conditional_t<INT, int, float>;

  __shared__ __align__(128) E As[BM * BK];
  __shared__ __align__(128) E Bs[BN * BK];
  __shared__ __align__(128) Acc Cs[BM][LDC];
  __shared__ float sa_s[2][BM], sb_s[2][BN];

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int n_qk = K / qk, n_qn = N / qn;

  float accf[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) accf[j] = 0.0f;

  TileCopy<BM, BK, NT, true, S> ta;
  TileCopy<BN, BK, NT, false, S> tb;
  ta.fetch(a, m0, M, 0, K);
  tb.fetch(b, n0, N, 0, K);
  for (int kb = 0; kb < n_qk; ++kb) {
    const int buf = kb & 1;
    // this quant block's scale of every tile row and tile column; buffer buf
    // was last read two quant blocks ago, before this block's barriers
    for (int i = threadIdx.x; i < BM + BN; i += NT) {
      if (i < BM) {
        const int gm = min(m0 + i, M - 1);
        sa_s[buf][i] = to_f32(sa[static_cast<int64_t>(gm / qm) * n_qk + kb]);
      } else {
        const int gn = min(n0 + i - BM, N - 1);
        sb_s[buf][i - BM] = to_f32(sb[static_cast<int64_t>(kb) * n_qn + gn / qn]);
      }
    }
    wmma::fragment<wmma::accumulator, 16, 16, 16, Acc> acc[FM][FN];
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], static_cast<Acc>(0));
    for (int k0 = kb * qk; k0 < (kb + 1) * qk; k0 += BK) {
      ta.store(As);
      tb.store(Bs);
      __syncthreads();
      if (k0 + BK < K) {  // the next K step's loads run under this step's MMAs
        ta.fetch(a, m0, M, k0 + BK, K);
        tb.fetch(b, n0, N, k0 + BK, K);
      }
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, FragT, wmma::row_major> fa[FM];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, FragT, wmma::row_major> fb[FN];
#pragma unroll
        for (int i = 0; i < FM; ++i)
          wmma::load_matrix_sync(fa[i], frag<BM, BK, true>(As, c, wm * WM + i * 16), 16);
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::load_matrix_sync(fb[j], frag<BN, BK, false>(Bs, c, wn * WN + j * 16), 16);
#pragma unroll
        for (int i = 0; i < FM; ++i)
#pragma unroll
          for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }
    // fold the block's partial into the fp32 accumulator, in the plain
    // version's order and roundings: acc + (part * sa) * sb, no FMA
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::store_matrix_sync(&Cs[wm * WM + i * 16][wn * WN + j * 16], acc[i][j], LDC,
                                wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = lane + 32 * j, r = wm * WM + e / WN, c = wn * WN + e % WN;
      const float part = static_cast<float>(Cs[r][c]);
      accf[j] = __fadd_rn(accf[j], __fmul_rn(__fmul_rn(part, sa_s[buf][r]), sb_s[buf][c]));
    }
    __syncwarp();
  }

#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int e = lane + 32 * j;
    const int gm = m0 + wm * WM + e / WN, gn = n0 + wn * WN + e % WN;
    if (gm < M && gn < N) store_out(out + static_cast<int64_t>(gm) * N + gn, accf[j]);
  }
}

template <Src S, typename ST, typename OT>
cudaError_t launch(const void* a, const void* b, const void* sa, const void* sb, void* out, int M,
                   int N, int K, int qm, int qk, int qn, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  tile_scaled_mm_kernel<S, ST, OT><<<grid, NT, 0, stream>>>(
      a, b, static_cast<const ST*>(sa), static_cast<const ST*>(sb), static_cast<OT*>(out), M, N, K,
      qm, qk, qn);
  return cudaGetLastError();
}

template <Src S>
cudaError_t launch_dtypes(const void* a, const void* b, const void* sa, const void* sb, void* out,
                          int M, int N, int K, int qm, int qk, int qn, int scale_bf16, int out_bf16,
                          cudaStream_t s) {
  using BF = __nv_bfloat16;
  if (scale_bf16)
    return out_bf16 ? launch<S, BF, BF>(a, b, sa, sb, out, M, N, K, qm, qk, qn, s)
                    : launch<S, BF, float>(a, b, sa, sb, out, M, N, K, qm, qk, qn, s);
  return out_bf16 ? launch<S, float, BF>(a, b, sa, sb, out, M, N, K, qm, qk, qn, s)
                  : launch<S, float, float>(a, b, sa, sb, out, M, N, K, qm, qk, qn, s);
}

// The same on the sm90 mainloop (Form S8MnB or E4m3F16).
template <class Form>
cudaError_t launch_sm90(const void* a, const void* b, const void* sa, const void* sb, void* out, int M, int N,
                        int K, int qm, int qk, int qn, int scale_bf16, int out_bf16, cudaStream_t s) {
  using BF = __nv_bfloat16;
  using qt_sm90::tile_scaled;
  if (scale_bf16)
    return out_bf16 ? tile_scaled<Form, BF, BF>(a, b, sa, sb, out, M, N, K, qm, qk, qn, s)
                    : tile_scaled<Form, BF, float>(a, b, sa, sb, out, M, N, K, qm, qk, qn, s);
  return out_bf16 ? tile_scaled<Form, float, BF>(a, b, sa, sb, out, M, N, K, qm, qk, qn, s)
                  : tile_scaled<Form, float, float>(a, b, sa, sb, out, M, N, K, qm, qk, qn, s);
}

}  // namespace

// Returns the launch's cudaError_t (0 on success). a [M, K] and b [K, N]
// contiguous, 16-byte aligned, int8 (is_fp8 = 0) or e4m3 (is_fp8 = 1); qk
// a multiple of 64 dividing K, qm dividing M, qn dividing N, N % 16 == 0. sa
// [M / qm, K / qk] and sb [K / qk, N / qn] contiguous, bf16 if scale_bf16
// else fp32; out [M, N] bf16 if out_bf16 else fp32. sm90: on the
// sm90_gemm.cuh mainloop, which needs qk % 128 == 0; else on the wmma
// kernel.
extern "C" int qt_tile_scaled_mm(const void* a, const void* b, const void* sa, const void* sb,
                                 void* out, int M, int N, int K, int qm, int qk, int qn, int is_fp8,
                                 int scale_bf16, int out_bf16, int sm90, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (qk % BK || K % qk || M % qm || N % qn || N % 16) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (sm90) {
    err = is_fp8 ? launch_sm90<qt_sm90::E4m3F16>(a, b, sa, sb, out, M, N, K, qm, qk, qn, scale_bf16, out_bf16, s)
                 : launch_sm90<qt_sm90::S8MnB>(a, b, sa, sb, out, M, N, K, qm, qk, qn, scale_bf16, out_bf16, s);
  } else {
    err = is_fp8 ? launch_dtypes<Src::E4M3>(a, b, sa, sb, out, M, N, K, qm, qk, qn, scale_bf16, out_bf16, s)
                 : launch_dtypes<Src::S8>(a, b, sa, sb, out, M, N, K, qm, qk, qn, scale_bf16, out_bf16, s);
  }
  return static_cast<int>(err);
}
