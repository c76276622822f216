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
// layout); K2 at M <= 16 on the split-K weight stream (decode_stream below);
// the caller decides those routes and passes them in (ops/scaled_mm.py::
// sm90_route, ::decode_route, ::rhs_mn_sm90_route and ::lhs_t_sm90_route,
// ops/int4_mm.py::sm90_route).
//
// K2 at decode sizes (decode_stream). At M <= 16 (a decode step's slots) K2
// moves the int8 weight b [N, K] once and does 2 M N K operations on it, so
// its bound is b's bytes (1.3 us at q/o [2048, 2048]), which only a grid that
// keeps some 2-3 MB of b in flight across the card (3.35 TB/s times about a
// microsecond of latency) comes near; the wmma tile below had 8 KB a CTA in
// flight on N / 32 CTAs (8 at k/v) and reached 0.02-0.23 of it. Here a CTA
// of two warps takes 16 rows of b (one m16 tile) over one of `splits` runs
// of its K, and the splits of a tile form a thread-block cluster
// (ops/scaled_mm.py::decode_route picks splits so that the grid holds about
// four CTAs an SM). The producer warp's lane 0 keeps a ring of kDecodeStages
// stages full by TMA, each stage 128 bytes of K for the tile's rows of b and
// x's 8 NT rows (NT n8 tiles: 1 up to 8 rows, else 2; rows past M or N and
// columns past K land as zeros), with the 128-byte swizzle, the stage's full
// mbarrier counting the bytes. The consumer warp multiplies b's rows by x's
// with mma.sync m16n8k32 (b as A, x as B, s32 sums), reading both through
// ldmatrix (conflict-free under the swizzle), and releases the stage on its
// empty mbarrier. int32 sums are exact, so the splits' partial sums add in
// any order: each CTA leaves its [16][8 NT] sums in shared memory, and after
// one cluster barrier CTA k of the cluster sums the k-th share of the tile's
// outputs over the cluster's CTAs through distributed shared memory and
// applies the epilogue, ((float)acc * sa[m]) * sb[n] rounded once to the
// output dtype: the wmma tile's bits. ab_sm90_forms.py timed wider tiles (2
// and 4 consumer warps, 32 and 64 rows), rings of 8 and 12 stages and
// clusters of 1-8 on the H100: one warp at four CTAs an SM was the fastest
// or within 0.1 us of it at every serving shape (PERF.md).
//
// The wmma kernel below serves B16's decode tiles and B16 at a K that TMA
// cannot describe packed (K % 32 != 0), past the mainloop's exact range (K >=
// 2^17), or on operands off a 16-byte boundary; and K2 where the decode route
// is refused (its first design): both operands K-major. Tiles go through shared memory in 16x16
// blocks of 16-byte rows (mm_tiles.cuh), so that every wmma fragment load is
// 256-bit aligned with a leading dimension of 16. wmma m16n16k16
// signed-char fragments accumulate in int32; one kernel, templated on
// packed operands, serves both GEMMs; B16's load stage unpacks each 8-byte
// chunk to 16 sign-extended int8 values in registers (mm_tiles.cuh). Tiles:
// 64x64 with a K step of 64, and at M <= 16 a 16x32 tile with a K step of
// 256, so a decode call keeps more weight bytes in flight per block. Ragged
// rows are zero-filled on load and masked on store. The next K tile is
// fetched into registers while the current one runs through the MMAs.

#include <cooperative_groups.h>
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
  if constexpr (S == Src::S8) {  // K2 off the sm90 route and the decode stream (its first design)
    return launch_tiles<16, 32, 256, 1, 2, S, ST, OT>(a, b, sa, sb, out, M, N, K, stream);
  } else {
    if (M <= 16) return launch_tiles<16, 32, 256, 1, 2, S, ST, OT>(a, b, sa, sb, out, M, N, K, stream);
    return launch_tiles<64, 64, 64, 2, 2, S, ST, OT>(a, b, sa, sb, out, M, N, K, stream);
  }
}

// ---- K2 at decode sizes: the split-K weight stream --------------------------

constexpr int kDecodeBK = 128;       // K bytes a stage row: the swizzle span
constexpr int kDecodeStages = 4;     // the ring
constexpr int kDecodeMaxSplits = 8;  // CTAs a cluster: the portable size
constexpr int kDecodeRows = 16;      // rows of b a CTA: one m16 tile

// A CTA: a consumer warp on kDecodeRows rows of b, NT n8 tiles of x's rows,
// and a producer warp
template <int NT>
struct DecodeTile {
  static constexpr int kThreads = 64, kCols = 8 * NT;
  static constexpr int kWBytes = kDecodeRows * kDecodeBK, kXBytes = kCols * kDecodeBK;
  static constexpr int kStage = kWBytes + kXBytes;             // each part a whole number of 1 KB swizzle atoms
  static constexpr int kSmem = kDecodeStages * kStage + 1024;  // and the ring's alignment to one
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];" : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}

// d += a . b: a 16 rows x 32 K (rows lane / 4 (+ 8 in a[1], a[3]), K 4 (lane
// % 4) .. + 3 (+ 16 in a[2], a[3])), b 32 K x 8 columns (column lane / 4, K
// 4 (lane % 4) .. + 3 (+ 16 in b1)), int8, int32 sums
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The byte offset of 16-byte chunk c of row r in a tile of 128-byte rows with
// the 128-byte swizzle (TMA's layout)
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  return static_cast<uint32_t>(r * kDecodeBK + ((c ^ (r & 7)) << 4));
}

// out [M, N] = epilogue(a [M, K] . b [N, K]^T) at M <= 8 NT; CTA rank k of
// cluster t takes rows [16 t, 16 t + 16) of b over K steps [k kblocks /
// splits, (k + 1) kblocks / splits) of 128 bytes.
template <int NT, typename ST, typename OT>
__global__ void __launch_bounds__(DecodeTile<NT>::kThreads)
decode_stream(const __grid_constant__ CUtensorMap tb, const __grid_constant__ CUtensorMap ta,
              const qt_sm90::ScaledOut<ST, OT> epi, int M, int N, int kblocks) {
  using G = DecodeTile<NT>;
  using namespace qt_sm90;
  constexpr int kCols = G::kCols;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kDecodeStages], empty_bar[kDecodeStages];
  __shared__ int part[kDecodeRows * kCols];  // this CTA's sums, [row][column]: its cluster reads them
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks()), split = static_cast<int>(cluster.block_rank());
  const int n0 = static_cast<int>(blockIdx.x) / splits * kDecodeRows;
  const int kb0 = split * kblocks / splits, kb1 = (split + 1) * kblocks / splits;
  uint8_t* ring_ptr = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t ring = smem_u32(ring_ptr), full0 = smem_u32(full_bar), empty0 = smem_u32(empty_bar);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDecodeStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (warp == 1) {  // the producer: one lane keeps the ring full
    if (lane == 0)
      for (int kb = kb0, i = 0; kb < kb1; ++kb, ++i) {
        const int s = i % kDecodeStages, use = i / kDecodeStages;
        if (use > 0) mbar_wait(empty0 + 8 * s, (use - 1) & 1);
        const uint32_t bar = full0 + 8 * s, dst = ring + s * G::kStage;
        mbar_expect_tx(bar, G::kStage);
        tma_load(dst, &tb, kb * kDecodeBK, n0, bar);
        tma_load(dst + G::kWBytes, &ta, kb * kDecodeBK, 0, bar);
      }
  } else {  // the consumer
    int acc[NT][4] = {};
    // the row and 16-byte half of a k32 step whose address this lane gives
    // ldmatrix: for b's four 8 x 16-byte matrices (rows 0-7 and 8-15, each
    // half) and for x's two (rows 0-7, each half) or four (and rows 8-15)
    const int ra = lane & 15, ha = lane >> 4;
    const int rx = (lane & 7) + (NT == 2 ? (lane >> 4) << 3 : 0), hx = (lane >> 3) & 1;
    for (int kb = kb0, i = 0; kb < kb1; ++kb, ++i) {
      const int s = i % kDecodeStages;
      mbar_wait(full0 + 8 * s, (i / kDecodeStages) & 1);
      const uint32_t ws = ring + s * G::kStage, xs = ws + G::kWBytes;
#pragma unroll
      for (int c = 0; c < kDecodeBK / 32; ++c) {
        uint32_t a[4];
        ldmatrix_x4(a, ws + swizzled(ra, 2 * c + ha));
        if constexpr (NT == 2) {
          uint32_t x[4];
          ldmatrix_x4(x, xs + swizzled(rx, 2 * c + hx));
          mma_s8(acc[0], a, x[0], x[1]);
          mma_s8(acc[1], a, x[2], x[3]);
        } else {
          uint32_t x[2];
          ldmatrix_x2(x, xs + swizzled(rx, 2 * c + hx));
          mma_s8(acc[0], a, x[0], x[1]);
        }
      }
      __syncwarp();  // every lane's reads of the stage are done
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
    }
    // the accumulators: rows lane / 4 (+ 8 in acc[t][2..3]), columns 8 t + 2
    // (lane % 4) (+ 1)
    int* p = part + (lane / 4) * kCols + 2 * (lane % 4);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      p[8 * t] = acc[t][0];
      p[8 * t + 1] = acc[t][1];
      p[8 * kCols + 8 * t] = acc[t][2];
      p[8 * kCols + 8 * t + 1] = acc[t][3];
    }
  }
  cluster.sync();  // every CTA's sums are written and visible to the cluster
  // this CTA's share of the tile's outputs, e = m kDecodeRows + row:
  // consecutive threads on consecutive columns of out; every peer's sum
  // loaded before any is added, so that the remote loads overlap
  constexpr int E = kDecodeRows * kCols;
  for (int e = split * E / splits + static_cast<int>(threadIdx.x); e < (split + 1) * E / splits; e += G::kThreads) {
    const int m = e / kDecodeRows, row = e % kDecodeRows, n = n0 + row;
    if (m < M && n < N) {
      int sum = 0, v[kDecodeMaxSplits];
#pragma unroll
      for (int k = 0; k < kDecodeMaxSplits; ++k)
        if (k < splits) v[k] = cluster.map_shared_rank(part, k)[row * kCols + m];
#pragma unroll
      for (int k = 0; k < kDecodeMaxSplits; ++k)
        if (k < splits) sum += v[k];
      const auto rw = epi.row(m, N);
      store1(rw.p + n, epi.value(rw, n, sum));
    }
  }
  cluster.sync();  // no CTA leaves while a peer still reads its sums
}

template <int NT, typename ST, typename OT>
cudaError_t launch_decode_tile(const void* a, const void* b, const void* sa, const void* sb, void* out, int M, int N,
                               int K, int splits, cudaStream_t stream) {
  using G = DecodeTile<NT>;
  CUtensorMap tb, ta;
  cudaError_t err = qt_sm90::encode_2d(&tb, CU_TENSOR_MAP_DATA_TYPE_UINT8, b, K, N, K, kDecodeBK, kDecodeRows);
  if (err == cudaSuccess) err = qt_sm90::encode_2d(&ta, CU_TENSOR_MAP_DATA_TYPE_UINT8, a, K, M, K, kDecodeBK, G::kCols);
  if (err != cudaSuccess) return err;
  const auto kernel = decode_stream<NT, ST, OT>;
  const qt_sm90::ScaledOut<ST, OT> epi{static_cast<const ST*>(sa), static_cast<const ST*>(sb), static_cast<OT*>(out)};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned int>(splits);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>((N + kDecodeRows - 1) / kDecodeRows * splits));
  cfg.blockDim = dim3(G::kThreads);
  cfg.dynamicSmemBytes = G::kSmem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, tb, ta, epi, M, N, (K + kDecodeBK - 1) / kDecodeBK);
}

template <typename ST, typename OT>
cudaError_t launch_decode(const void* a, const void* b, const void* sa, const void* sb, void* out, int M, int N, int K,
                          int splits, cudaStream_t s) {
  return M > 8 ? launch_decode_tile<2, ST, OT>(a, b, sa, sb, out, M, N, K, splits, s)
               : launch_decode_tile<1, ST, OT>(a, b, sa, sb, out, M, N, K, splits, s);
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

// K2 at decode sizes on the split-K weight stream (decode_stream): a [M, K]
// and b [N, K] int8, contiguous, 16-byte aligned, 1 <= M <= 16, K > 0 and K %
// 16 == 0; sa [M], sb [N], out [M, N] as for qt_scaled_mm_s8. splits (1-8, at
// most K's 128-byte steps): the CTAs of a cluster, each a run of K, that
// share 16 rows of b (ops/scaled_mm.py::decode_route). Returns the launch's
// cudaError_t.
extern "C" int qt_scaled_mm_decode(const void* a, const void* b, const void* sa, const void* sb, void* out, int M,
                                   int N, int K, int scale_bf16, int out_bf16, int splits, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const bool aligned = reinterpret_cast<uintptr_t>(a) % 16 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  if (M > 16 || K <= 0 || K % 16 || !aligned || splits < 1 || splits > kDecodeMaxSplits ||
      splits > (K + kDecodeBK - 1) / kDecodeBK)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using BF = __nv_bfloat16;
  cudaError_t err;
  if (scale_bf16)
    err = out_bf16 ? launch_decode<BF, BF>(a, b, sa, sb, out, M, N, K, splits, s)
                   : launch_decode<BF, float>(a, b, sa, sb, out, M, N, K, splits, s);
  else
    err = out_bf16 ? launch_decode<float, BF>(a, b, sa, sb, out, M, N, K, splits, s)
                   : launch_decode<float, float>(a, b, sa, sb, out, M, N, K, splits, s);
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
