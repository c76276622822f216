// B19: the causal int8 flash-attention forward of
// quantized_training_tpu/ops/int8_attention.py::int8_flash_fwd (:117), which
// it replaces, on grouped GQA instances: per (instance, group) q_i8 [S, hd]
// with per-row scales q_s, and the instance's k_i8 / v_i8 [S, hd] with per-row
// scales k_s / v_s. For each kv block of BKV columns (the JAX block_kv):
//
//   s      = ((float)(q_i8 . k_i8^T) * q_s) * k_s, -1e30 above the diagonal
//   m_new  = max(m, max_row s);  alpha = exp(m - m_new);  p = exp(s - m_new)
//   l      = l * alpha + sum_row p                 (the unquantized fp32 p)
//   ps     = p * v_s;  pscale = max_row ps * (1/127)
//   p_i8   = rint(ps * (1 / max(pscale, 1e-30)))
//   acc    = acc * alpha + (float)(p_i8 . v_i8) * pscale
//
// and at the end out = bf16(acc / max(l, 1e-20)), lse = m + log(max(l, 1e-20)).
// p's row absmax is taken over exactly BKV columns, so BKV is part of the
// numerics: the kernels walk the block in sub-tiles of 64 or 128 columns but
// quantize p over the whole block. The q tile changes no number (a kv block
// wholly in a row's future is an exact no-op: alpha = 1, p = 0, p_i8 = 0), so
// the kernels take 64 q rows at a time whatever block_q the caller names.
// Every product, sum and exponential is a separate IEEE fp32 operation in the
// JAX order (__fmul_rn / __fadd_rn: no contraction into FMAs; expf / logf,
// not the approximate intrinsics; true divisions), so a kernel differs from
// its plain version only in the order of the row sums of p. Both designs
// below run the same operations on the same values, so m, p, ps, pscale,
// p_i8 and acc are bit for bit the same in both; only l's order differs.
//
// Bound on the H100 at Llama2-1B's attention (16 instances = batch 4 x 4 kv
// heads, G 8, S 2048, hd 64): the ~268 M exponentials of the causal triangle
// at the special-function units' rate (16 a clock per SM: 4.18 T/s at
// 1,980 MHz), ~64 us; the int8 tensor-core work (~69 GOP, 35 us) and the
// bytes (~57 MB, 17 us) are below it. The fp32 pipe's ~16 other operations
// an element (scale, max, subtract, sum, v-scale multiply, absmax, cast)
// take about twice the exponentials' time at 4 warp instructions a clock.
//
// Two designs; the wrapper picks one (ops/int8_attention.py::
// int8_flash_sm90_route) and passes the sm90 design's grid, or 0 for the
// first.
//
// The sm90 design (flash_sm90: hd 64 or 128, BKV a multiple of kFlashChunk
// up to kFlashMaxBkv). One CTA an SM of 384 threads, a producer warpgroup and
// two consumer warpgroups, walks its share of the work items (instance,
// group, 64-row q tile) heaviest first: causal tiles at the end of S hold the
// most kv chunks. CTA b takes items b, 2 grid - 1 - b, 2 grid + b, ...: a
// static stride that turns back each round, so the CTAs' shares differ by
// about one light item (an atomic counter would need a zeroed scratch each
// launch). A block's columns go in chunks of 128 (kFlashChunk); chunks wholly
// in the future of the tile's last row are never loaded.
//
// - The producer: one thread keeps TMA loads in flight into mbarrier rings:
//   the q tile [64, hd], each k chunk [128, hd] (K-major as stored; rows of
//   64 bytes at hd 64 take the 64-byte swizzle, in the tensor map and in the
//   wgmma descriptors alike, rows of 128 the 128-byte one) with the chunk's
//   128 k_s and 128 v_s copied into the same stage (so no consumer loads a
//   scale from device memory per element), and each v chunk [128, hd] raw.
//   The other three warps transpose each raw v chunk into a K-major [hd, 128]
//   stage (S8MnB's rewrite with N = hd: 8-bit wgmma reads K-major operands
//   only), fence it into the async proxy and arrive on its barrier. The
//   loading thread and the transposers wait on different barriers, so
//   neither holds the other up.
// - The consumers share the q tile and split each block's chunks: warpgroup
//   w takes chunks w and w + 2, which balances the diagonal block. Each holds
//   its chunks' scores in registers (2 x 64 int32 a thread from m64n128k32,
//   turned in place into s, then ps), so the scores never touch shared
//   memory; the second chunk's QK^T runs on the tensor cores while the
//   first's scores are scaled. Per block the two warpgroups exchange three
//   [64]-float partials through shared memory under a named barrier (the row
//   max, the row sum of p, the row absmax of ps), each first reduced over
//   the quad of lanes that holds a row.
// - p_i8 stays in registers as wgmma's A operand. The accumulator layout
//   gives a thread two adjacent columns (8 j + 2 q, + 1) where the register
//   A form wants four adjacent k, so a thread's A word takes columns 8 j +
//   2 q, + 1, 8 j + 8 + 2 q, + 1 as its k 4 q .. 4 q + 3, and the transpose
//   writes v's rows in that order within each 16-byte chunk (permute16): the
//   same terms, so the same exact int32 sum, with no pass of p through shared
//   memory. Each warpgroup's p_i8 . v^T over its chunks (m64n{hd}k32) is
//   added exactly to the other's through shared memory; each then keeps the
//   fp32 acc of half of hd and stores that half of out.
// - Registers: launched at 168 a thread (__launch_bounds__(384, 1)), the
//   producer gives registers back down to kProducerRegs and the consumers
//   take kConsumerRegs (setmaxnreg): 128 for the scores, hd / 4 for acc, the
//   int32 product once the scores are dead.
// - Every mbarrier wait traps after 2 s (sm90_gemm.cuh::mbar_wait), so a
//   fault ends the launch with an error rather than hanging the card.
//
// The first design (int8_flash_fwd_kernel: every other shape, and the route
// forced to 0). The scores of a 64-row tile over one kv block are needed
// before any of them can be quantized, and at BKV = 512 they are 128 KB of
// fp32, so they live in shared memory (dynamic, up to 227 KB), computed once.
// One CTA of 8 warps takes 64 q rows of one (instance, group): (A) the score
// tile, q [64, hd] . k^T over 64-column sub-tiles on int8 wmma (k K-major,
// as stored), int32 into shared memory; (B) one warp per 8 rows runs the
// softmax statistics, p and its quantize in place (warp-shuffle sums in a
// fixed order); (C) p_i8 . v over the same sub-tiles on int8 wmma (v
// MN-major, as stored) and the rescaled fp32 accumulate, 16-32 values a
// thread in registers. Sub-tiles wholly in the future of the tile's last row
// are skipped in (A) and (C). The k/v sub-tiles load synchronously (no
// cp.async or TMA), and a causal tile still runs the exponentials of its
// masked columns.

#include <mma.h>

#include "mm_tiles.cuh"
#include "row_common.cuh"  // kMagic, kInv127, pack4
#include "sm90_gemm.cuh"

using namespace nvcuda;
using qt_mm::frag;
using qt_mm::TileCopy;

namespace {

constexpr int BQ = 64;   // q rows a CTA
constexpr int BT = 64;   // kv rows a sub-tile
constexpr int NW = 8;    // warps
constexpr int NT = NW * 32;
constexpr float NEG_INF = -1e30f;

__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

// dynamic shared memory of one CTA: the fp32 score tile (also the int32
// scratch of both products, [BQ][HD + 4] for p_i8 . v), p_i8, the q tile,
// one k or v sub-tile, and four row statistics
template <int HD>
__host__ __device__ constexpr size_t score_bytes(int bkv) {
  return align128(static_cast<size_t>(BQ) * ((bkv > HD ? bkv : HD) + 4) * 4);
}

template <int HD>
constexpr size_t smem_bytes(int bkv) {
  return score_bytes<HD>(bkv) + static_cast<size_t>(BQ) * bkv + BQ * HD + BT * HD + 4 * BQ * 4;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int HD>
__global__ void __launch_bounds__(NT)
int8_flash_fwd_kernel(const int8_t* __restrict__ q, const float* __restrict__ qs, const int8_t* __restrict__ k,
                      const float* __restrict__ ks, const int8_t* __restrict__ v, const float* __restrict__ vs,
                      __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int G, int S, int bkv, bool causal) {
  static_assert(HD % 16 == 0 && HD <= 128, "head dims 16-128 in steps of 16");
  constexpr int PER = BQ * HD / NT;  // accumulator values a thread
  constexpr int FN = HD / 2 / 16;    // PV fragments a warp (2 x 4 warps over [64, HD])

  extern __shared__ __align__(128) unsigned char smem[];
  const int lds = bkv + 4;  // row stride of the score tile
  float* sf = reinterpret_cast<float*>(smem);
  int* si = reinterpret_cast<int*>(smem);
  int8_t* p8 = reinterpret_cast<int8_t*>(smem + score_bytes<HD>(bkv));
  int8_t* qt = p8 + BQ * bkv;
  int8_t* kv = qt + BQ * HD;
  float* m_s = reinterpret_cast<float*>(kv + BT * HD);
  float* l_s = m_s + BQ;
  float* alpha_s = l_s + BQ;
  float* pscale_s = alpha_s + BQ;

  const int r0 = blockIdx.x * BQ, g = blockIdx.y, inst = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2;  // (A) and (C): 16 rows x half the columns a warp
  const int64_t qrow0 = (static_cast<int64_t>(inst) * G + g) * S;  // this (instance, group)'s first q row
  const int8_t* q_ig = q + qrow0 * HD;
  const float* qs_ig = qs + qrow0;
  const int8_t* k_i = k + static_cast<int64_t>(inst) * S * HD;
  const int8_t* v_i = v + static_cast<int64_t>(inst) * S * HD;
  const float* ks_i = ks + static_cast<int64_t>(inst) * S;
  const float* vs_i = vs + static_cast<int64_t>(inst) * S;

  {
    TileCopy<BQ, HD, NT, true> tq;
    tq.fetch(q_ig, r0, S, 0, HD);
    tq.store(qt);
  }
  if (threadIdx.x < BQ) {
    m_s[threadIdx.x] = NEG_INF;
    l_s[threadIdx.x] = 0.f;
  }
  float acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = 0.f;

  const int last_row = r0 + BQ - 1;
  const int n_blocks = causal ? last_row / bkv + 1 : S / bkv;
  const int n_sub = bkv / BT;
  for (int j = 0; j < n_blocks; ++j) {
    const int c0 = j * bkv;
    // (A) int32 scores of the block, sub-tile by sub-tile
    for (int t = 0; t < n_sub; ++t) {
      if (causal && c0 + t * BT > last_row) break;  // masked for every row of the tile
      TileCopy<BT, HD, NT, true> tk;
      tk.fetch(k_i, c0 + t * BT, S, 0, HD);
      __syncthreads();  // the previous sub-tile's MMAs are done with kv
      tk.store(kv);
      __syncthreads();
      wmma::fragment<wmma::accumulator, 16, 16, 16, int> sacc[2];
      wmma::fill_fragment(sacc[0], 0);
      wmma::fill_fragment(sacc[1], 0);
#pragma unroll
      for (int c = 0; c < HD / 16; ++c) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, frag<BQ, HD, true>(qt, c, wm * 16), 16);
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> fb;
          wmma::load_matrix_sync(fb, frag<BT, HD, true>(kv, c, wn * 32 + f * 16), 16);
          wmma::mma_sync(sacc[f], fa, fb, sacc[f]);
        }
      }
#pragma unroll
      for (int f = 0; f < 2; ++f)
        wmma::store_matrix_sync(si + (wm * 16) * lds + t * BT + wn * 32 + f * 16, sacc[f], lds, wmma::mem_row_major);
    }
    __syncthreads();

    // (B) one warp per 8 rows: scale and mask, the statistics, p, its quantize
    for (int rr = warp; rr < BQ; rr += NW) {
      const int r = r0 + rr;
      const float qs_r = qs_ig[r];
      float* srow = sf + rr * lds;
      const int* irow = si + rr * lds;
      float mx = NEG_INF;
      for (int cc = lane; cc < bkv; cc += 32) {
        const int gc = c0 + cc;
        const float s = (causal && gc > r) ? NEG_INF : __fmul_rn(__fmul_rn(static_cast<float>(irow[cc]), qs_r), ks_i[gc]);
        srow[cc] = s;
        mx = fmaxf(mx, s);
      }
      const float m_prev = m_s[rr];
      const float m_new = fmaxf(m_prev, warp_max(mx));
      const float alpha = expf(m_prev - m_new);
      float sum = 0.f, pm = 0.f;
      for (int cc = lane; cc < bkv; cc += 32) {
        const float p = expf(srow[cc] - m_new);
        sum = __fadd_rn(sum, p);
        const float ps = __fmul_rn(p, vs_i[c0 + cc]);
        srow[cc] = ps;
        pm = fmaxf(pm, ps);
      }
      sum = warp_sum(sum);
      const float pscale = __fmul_rn(warp_max(pm), 1.0f / 127.0f);
      const float rcp = 1.0f / fmaxf(pscale, 1e-30f);
      for (int cc = lane; cc < bkv; cc += 32)
        p8[((cc / 16) * BQ + rr) * 16 + cc % 16] = static_cast<int8_t>(rintf(__fmul_rn(srow[cc], rcp)));
      if (lane == 0) {
        l_s[rr] = __fadd_rn(__fmul_rn(l_s[rr], alpha), sum);
        m_s[rr] = m_new;
        alpha_s[rr] = alpha;
        pscale_s[rr] = pscale;
      }
    }
    __syncthreads();

    // (C) p_i8 . v over the same sub-tiles, then the rescaled accumulate
    wmma::fragment<wmma::accumulator, 16, 16, 16, int> pacc[FN];
#pragma unroll
    for (int f = 0; f < FN; ++f) wmma::fill_fragment(pacc[f], 0);
    for (int t = 0; t < n_sub; ++t) {
      if (causal && c0 + t * BT > last_row) break;  // p_i8 is zero there
      TileCopy<HD, BT, NT, false> tv;
      tv.fetch(v_i, 0, HD, c0 + t * BT, S);
      __syncthreads();
      tv.store(kv);
      __syncthreads();
#pragma unroll
      for (int c = 0; c < BT / 16; ++c) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, p8 + ((t * BT / 16 + c) * BQ + wm * 16) * 16, 16);
#pragma unroll
        for (int f = 0; f < FN; ++f) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, frag<HD, BT, false>(kv, c, wn * (HD / 2) + f * 16), 16);
          wmma::mma_sync(pacc[f], fa, fb, pacc[f]);
        }
      }
    }
    // the score tile is spent (p_i8 holds it): its memory takes the int32 products
#pragma unroll
    for (int f = 0; f < FN; ++f)
      wmma::store_matrix_sync(si + (wm * 16) * (HD + 4) + wn * (HD / 2) + f * 16, pacc[f], HD + 4,
                              wmma::mem_row_major);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int idx = threadIdx.x + i * NT, rr = idx / HD, d = idx % HD;
      acc[i] = __fadd_rn(__fmul_rn(acc[i], alpha_s[rr]),
                         __fmul_rn(static_cast<float>(si[rr * (HD + 4) + d]), pscale_s[rr]));
    }
    __syncthreads();  // the next block's scores overwrite the scratch
  }

#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int idx = threadIdx.x + i * NT, rr = idx / HD, d = idx % HD;
    const float l = fmaxf(l_s[rr], 1e-20f);
    out[(qrow0 + r0 + rr) * HD + d] = __float2bfloat16_rn(acc[i] / l);
  }
  if (threadIdx.x < BQ) {
    const float l = fmaxf(l_s[threadIdx.x], 1e-20f);
    lse[qrow0 + r0 + threadIdx.x] = __fadd_rn(m_s[threadIdx.x], logf(l));
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* qs, const void* k, const void* ks, const void* v, const void* vs,
                   void* out, void* lse, int n_inst, int G, int S, int bkv, bool causal, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>(bkv);
  cudaError_t err = cudaFuncSetAttribute(int8_flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(S / BQ, G, n_inst);
  int8_flash_fwd_kernel<HD><<<grid, NT, smem, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(qs), static_cast<const int8_t*>(k),
      static_cast<const float*>(ks), static_cast<const int8_t*>(v), static_cast<const float*>(vs),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), G, S, bkv, causal);
  return cudaGetLastError();
}

}  // namespace

// ---- the sm90 design ---------------------------------------------------------

namespace flash {

using qt_sm90::fence_proxy_async;
using qt_sm90::mbar_arrive;
using qt_sm90::mbar_expect_tx;
using qt_sm90::mbar_init;
using qt_sm90::mbar_wait;
using qt_sm90::smem_u32;
using qt_sm90::tma_load;
using qt_sm90::wgmma_commit;
using qt_sm90::wgmma_fence;
using qt_sm90::wgmma_wait;

constexpr int kFlashRows = 64;     // q rows a work item: wgmma's M
constexpr int kFlashChunk = 128;   // kv columns a chunk: QK^T's N and p_i8 . v^T's K
constexpr int kFlashMaxBkv = 512;  // four chunks a block, two for each consumer warpgroup
constexpr int kFlashThreads = 384;  // consumer warpgroups 0 and 1, producer 2
constexpr int kConsumerRegs = 224, kProducerRegs = 56;
constexpr float kNegInf = -1e30f;

// The shared-memory rings at head dim HD, byte offsets from a 1 KB boundary
// (every tile starts on one: the swizzle atoms are 512 and 1024 bytes). A k
// stage's scales (the chunk's k_s, then its v_s) sit apart from its tile.
// The v stages are at least the chunks of a block, and the k stages at least
// that too: a consumer then waits on a stage's next phase only once every
// consumer has seen its previous one (they meet every block), which the
// parity waits need. At hd 128 the k ring holds one block, at hd 64 two.
template <int HD>
struct Ring {
  static constexpr int kQSlots = 2, kKStages = HD == 64 ? 8 : 4, kVStages = 4, kRawSlots = HD == 64 ? 4 : 2;
  static constexpr int kQBytes = kFlashRows * HD, kKBytes = kFlashChunk * HD, kVBytes = kFlashChunk * HD;
  static constexpr int kScaleBytes = 2 * kFlashChunk * 4;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQSlots * kQBytes;
  static constexpr int kScales = kK + kKStages * kKBytes;
  static constexpr int kV = kScales + kKStages * kScaleBytes;
  static constexpr int kRaw = kV + kVStages * kVBytes;
  static constexpr int kXchg = kRaw + kRawSlots * kVBytes;  // the int32 halves of p_i8 . v^T, one set a warpgroup
  static constexpr int kBytes = kXchg + 2 * kFlashRows * (HD / 2) * 4;
  // the mbarriers: q full / empty, k full / empty, raw full / empty, v full / empty
  static constexpr int kQFull = 0, kQEmpty = kQFull + kQSlots, kKFull = kQEmpty + kQSlots;
  static constexpr int kKEmpty = kKFull + kKStages, kRawFull = kKEmpty + kKStages;
  static constexpr int kRawEmpty = kRawFull + kRawSlots, kVFull = kRawEmpty + kRawSlots;
  static constexpr int kVEmpty = kVFull + kVStages, kBars = kVEmpty + kVStages;
  static_assert(kVStages * kFlashChunk >= kFlashMaxBkv && kKStages * kFlashChunk >= kFlashMaxBkv,
                "a ring holds at least a block's chunks");
  static_assert(kBytes + 1024 + 3 * 2 * kFlashRows * 4 + kBars * 8 <= 232448, "over 227 KB of shared memory");
};

constexpr int kTransposers = 96;  // producer warps 1-3

// The work items, (instance, group, q tile), and the kv chunks of each.
struct Walk {
  int n_ig, G, S, tiles, items, bkv, causal;
  // this CTA's i-th item, or -1 past its last: round i takes items i grid
  // .. i grid + grid - 1, forward in even rounds and backward in odd ones
  __device__ int item(int i) const {
    const int pos = (i & 1) ? static_cast<int>(gridDim.x) - 1 - static_cast<int>(blockIdx.x)
                            : static_cast<int>(blockIdx.x);
    const int64_t idx = static_cast<int64_t>(i) * gridDim.x + pos;
    return idx < items ? static_cast<int>(idx) : -1;
  }
  // item idx: (instance, group) idx % n_ig (in q's order), tile tiles - 1 -
  // idx / n_ig: the last tiles first, the heaviest where causal
  __device__ int ig(int idx) const { return idx % n_ig; }
  __device__ int row0(int idx) const { return (tiles - 1 - idx / n_ig) * kFlashRows; }
  __device__ int blocks(int r0) const { return causal ? (r0 + kFlashRows - 1) / bkv + 1 : S / bkv; }
  // the chunks of block j that hold a column at or before the tile's last row
  __device__ int chunks(int r0, int j) const {
    const int n = bkv / kFlashChunk;
    return causal ? min(n, (r0 + kFlashRows - 1 - j * bkv) / kFlashChunk + 1) : n;
  }
};

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

// The two consumer warpgroups' 256 threads meet (named barrier 1).
__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 1, 256;" ::: "memory"); }

template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
__device__ __forceinline__ void fence_frags(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(a[i / 4][i % 4])::"memory");
}

#define QT_ACC8(c, i) c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3]), c(d[i + 4]), c(d[i + 5]), c(d[i + 6]), c(d[i + 7])
#define QT_ACC32(c) QT_ACC8(c, 0), QT_ACC8(c, 8), QT_ACC8(c, 16), QT_ACC8(c, 24)
#define QT_ACC64(c) QT_ACC32(c), QT_ACC8(c, 32), QT_ACC8(c, 40), QT_ACC8(c, 48), QT_ACC8(c, 56)
#define QT_D32                                                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, " \
  "%23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define QT_D64                                                                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, "  \
  "%23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// QK^T's K step: d (+)= a . b, m64n128k32, both from shared memory; acc 0
// overwrites d.
__device__ __forceinline__ void wgmma_ss(int (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " QT_D64 ", %64, %65, p;\n}"
      : QT_ACC64("+r")
      : "l"(da), "l"(db), "r"(acc));
}

// p_i8 . v^T's K step, A from registers: m64n64k32 (hd 64) or m64n128k32
// (hd 128); acc 0 overwrites d.
__device__ __forceinline__ void wgmma_rs(int (&d)[32], const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " QT_D32 ", {%32, %33, %34, %35}, %36, p;\n}"
      : QT_ACC32("+r")
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}
__device__ __forceinline__ void wgmma_rs(int (&d)[64], const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " QT_D64 ", {%64, %65, %66, %67}, %68, p;\n}"
      : QT_ACC64("+r")
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

#undef QT_ACC8
#undef QT_ACC32
#undef QT_ACC64
#undef QT_D32
#undef QT_D64

// A K-major q or k tile's descriptor at head dim HD: rows of 64 bytes with
// the 64-byte swizzle (layout type 2; 8 rows are 512 bytes), or of 128 with
// the 128-byte one (sm90_gemm.cuh's smem_desc).
template <int HD>
__device__ __forceinline__ uint64_t qk_desc(uint32_t addr) {
  if constexpr (HD == 64) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (static_cast<uint64_t>(512 >> 4) << 32) |
           (2ull << 62);
  } else {
    return qt_sm90::smem_desc(addr, 16, 1024);
  }
}

// 16 bytes k 0..15 of one stage row (words k 0-3, 4-7, 8-11, 12-15) in the
// order of the consumers' A fragments: word q holds k 2 q, 2 q + 1, 8 + 2 q,
// 9 + 2 q.
__device__ __forceinline__ uint4 permute16(uint32_t w0, uint32_t w1, uint32_t w2, uint32_t w3) {
  return make_uint4(__byte_perm(w0, w2, 0x5410), __byte_perm(w0, w2, 0x7632), __byte_perm(w1, w3, 0x5410),
                    __byte_perm(w1, w3, 0x7632));
}

// A raw v chunk [128 k][HD n] -> its stage [HD n][128 k], 128-byte rows
// swizzled as wgmma's B reads them, k permuted within each 16-byte chunk
// (permute16). Unit u (0 .. HD - 1) is half of one 16 x 16 byte block,
// S8MnB's rewrite with raw rows of HD bytes: K chunk kb by N chunk nb, its 8
// n columns 8 h .. 8 h + 7.
template <int HD>
__device__ __forceinline__ void rewrite_v(const uint8_t* raw, uint8_t* stage, int unit) {
  constexpr int kNb = HD / 16;
  const int h = unit & 1, u = unit >> 1, kb = u & 7, nb = (kb + (u >> 3)) % kNb;
  const uint8_t* src = raw + kb * 16 * HD + nb * 16 + h * 8;
  uint32_t v[16][2];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const uint2 x = *reinterpret_cast<const uint2*>(src + i * HD);
    v[i][0] = h ? x.y : x.x, v[i][1] = h ? x.x : x.y;
  }
#pragma unroll
  for (int w = 0; w < 4; ++w)
#pragma unroll
    for (int q = 0; q < 2; ++q) qt_sm90::transpose4x4(v[4 * w][q], v[4 * w + 1][q], v[4 * w + 2][q], v[4 * w + 3][q]);
  uint8_t* dst = stage + nb * 16 * 128;
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = 8 * h + 4 * (q ^ h) + c;
      *reinterpret_cast<uint4*>(dst + j * 128 + ((kb ^ (j & 7)) << 4)) =
          permute16(v[c][q], v[4 + c][q], v[8 + c][q], v[12 + c][q]);
    }
}

// The producer's loading thread: per item its q tile, then per block its k
// chunks (with their scales) and its raw v chunks, each into the next slot
// of its ring once the slot is free.
template <int HD>
__device__ void load(const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv, const float* ks,
                     const float* vs, uint32_t base, uint32_t bars, const Walk& walk) {
  using R = Ring<HD>;
  const auto bar = [&](int i) { return bars + 8 * i; };
  int gk = 0;
  for (int i = 0;; ++i) {
    const int idx = walk.item(i);
    if (idx < 0) return;
    const int ig = walk.ig(idx), r0 = walk.row0(idx), kv0 = (ig / walk.G) * walk.S;
    const int qs = i % R::kQSlots;
    if (i >= R::kQSlots) mbar_wait(bar(R::kQEmpty + qs), (i / R::kQSlots - 1) & 1);
    mbar_expect_tx(bar(R::kQFull + qs), R::kQBytes);
    tma_load(base + R::kQ + qs * R::kQBytes, tq, 0, ig * walk.S + r0, bar(R::kQFull + qs));
    for (int j = 0, nb = walk.blocks(r0); j < nb; ++j) {
      const int n = walk.chunks(r0, j), c0 = kv0 + j * walk.bkv;
      for (int c = 0; c < n; ++c) {
        const int g = gk + c, s = g % R::kKStages, row = c0 + c * kFlashChunk;
        if (g >= R::kKStages) mbar_wait(bar(R::kKEmpty + s), (g / R::kKStages - 1) & 1);
        const uint32_t full = bar(R::kKFull + s), sc = base + R::kScales + s * R::kScaleBytes;
        mbar_expect_tx(full, R::kKBytes + R::kScaleBytes);
        tma_load(base + R::kK + s * R::kKBytes, tk, 0, row, full);
        bulk_load(sc, ks + row, kFlashChunk * 4, full);
        bulk_load(sc + kFlashChunk * 4, vs + row, kFlashChunk * 4, full);
      }
      for (int c = 0; c < n; ++c) {
        const int g = gk + c, s = g % R::kRawSlots;
        if (g >= R::kRawSlots) mbar_wait(bar(R::kRawEmpty + s), (g / R::kRawSlots - 1) & 1);
        mbar_expect_tx(bar(R::kRawFull + s), R::kVBytes);
        tma_load(base + R::kRaw + s * R::kVBytes, tv, 0, c0 + c * kFlashChunk, bar(R::kRawFull + s));
      }
      gk += n;
    }
  }
}

// The producer's transposing warps (thread t of kTransposers): each raw v
// chunk into its stage, in the loading thread's order.
template <int HD>
__device__ void transpose(uint8_t* ring, uint32_t bars, const Walk& walk, int t) {
  using R = Ring<HD>;
  const auto bar = [&](int i) { return bars + 8 * i; };
  int g = 0;
  for (int i = 0;; ++i) {
    const int idx = walk.item(i);
    if (idx < 0) return;
    const int r0 = walk.row0(idx);
    for (int j = 0, nb = walk.blocks(r0); j < nb; ++j) {
      for (int c = walk.chunks(r0, j); c > 0; --c, ++g) {
        const int rs = g % R::kRawSlots, s = g % R::kVStages;
        mbar_wait(bar(R::kRawFull + rs), (g / R::kRawSlots) & 1);
        if (g >= R::kVStages) mbar_wait(bar(R::kVEmpty + s), (g / R::kVStages - 1) & 1);
        for (int u = t; u < HD; u += kTransposers)
          rewrite_v<HD>(ring + R::kRaw + rs * R::kVBytes, ring + R::kV + s * R::kVBytes, u);
        mbar_arrive(bar(R::kRawEmpty + rs));
        fence_proxy_async();
        mbar_arrive(bar(R::kVFull + s));
      }
    }
  }
}

// fp32 of an int32 |x| < 2^22 by two full-rate adds (the conversion
// instruction runs at a quarter of the rate): exact
__device__ __forceinline__ float i2f(int x) { return __fsub_rn(__int_as_float(x + 0x4B400000), kMagic); }

// A chunk's scores in place, d (wgmma's layout: row h = (e / 2) % 2, column 8
// j + 2 q + e % 2 of d[4 j + e]) -> s = ((float)d * q_s) * k_s, kNegInf
// above the diagonal (kMask: column > lim_h, lim_h the row less the chunk's
// first column); the row maxima folded into mx.
template <bool kMask>
__device__ __forceinline__ void scores(int (&d)[64], const float (&qsr)[2], const float* ksc, int quad, int lim0,
                                       float (&mx)[2]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 kc = *reinterpret_cast<const float2*>(ksc + 8 * j + 2 * quad);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      float s = __fmul_rn(__fmul_rn(i2f(d[4 * j + e]), qsr[h]), (e & 1) ? kc.y : kc.x);
      if (kMask && 8 * j + 2 * quad + (e & 1) > lim0 + 8 * h) s = kNegInf;
      d[4 * j + e] = __float_as_int(s);
      mx[h] = fmaxf(mx[h], s);
    }
  }
}

// A chunk's s in place -> ps = exp(s - m_new) * v_s; the row sums of p and
// the row maxima of ps folded into sum and pm.
__device__ __forceinline__ void probs(int (&d)[64], const float (&mn)[2], const float* vsc, int quad,
                                      float (&sum)[2], float (&pm)[2]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 vc = *reinterpret_cast<const float2*>(vsc + 8 * j + 2 * quad);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const float p = expf(__fsub_rn(__int_as_float(d[4 * j + e]), mn[h]));
      sum[h] = __fadd_rn(sum[h], p);
      const float ps = __fmul_rn(p, (e & 1) ? vc.y : vc.x);
      pm[h] = fmaxf(pm[h], ps);
      d[4 * j + e] = __float_as_int(ps);
    }
  }
}

// rint(ps * rcp) in the low byte of the word: one add (|ps * rcp| <= 127)
__device__ __forceinline__ uint32_t q8(int ps, float rcp) {
  return __float_as_uint(__fadd_rn(__fmul_rn(__int_as_float(ps), rcp), kMagic));
}

// A chunk's ps -> p_i8 as the A fragments of its four K steps (32 columns
// each). Word w of fragment kk holds row w % 2 (+ 8) and columns 32 kk + 16
// (w / 2) + 2 q, + 1, + 8, + 9: d[o], d[o + 1], d[o + 4], d[o + 5] at o = 16
// kk + 8 (w / 2) + 2 (w % 2), permute16's k order.
__device__ __forceinline__ void pack(const int (&d)[64], const float (&rcp)[2], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int o = 16 * kk + 8 * (w >> 1) + 2 * (w & 1);
      const float r = rcp[w & 1];
      a[kk][w] = pack4(q8(d[o], r), q8(d[o + 1], r), q8(d[o + 4], r), q8(d[o + 5], r));
    }
  }
}

__device__ __forceinline__ void zero(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) a[i / 4][i % 4] = 0;
}

// A consumer warpgroup w (0 or 1): per item, per block, QK^T of its chunks,
// the softmax statistics exchanged with the other warpgroup, p_i8 . v^T of
// its chunks, the two products' halves exchanged, and the rescaled
// accumulate of its half of hd; then its half of out (and from warpgroup 0,
// lse).
template <int HD>
__device__ void consume(uint8_t* ring, uint32_t base, uint32_t bars, float (*red)[2][kFlashRows],
                        const float* __restrict__ qs, __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                        const Walk& walk, int w) {
  using R = Ring<HD>;
  constexpr int kHalf = HD / 4;  // accumulators a thread keeps: two rows of its columns in half of hd
  const auto bar = [&](int i) { return bars + 8 * i; };
  const int t = threadIdx.x % 128, lane = t % 32, quad = lane % 4;
  const int rl = 16 * (t / 32) + lane / 4;  // the thread's tile rows rl and rl + 8
  int* xchg = reinterpret_cast<int*>(ring + R::kXchg);
  const float* scales = reinterpret_cast<const float*>(ring + R::kScales);
  int g = 0;  // chunks of the CTA's earlier blocks
  for (int i = 0;; ++i) {
    const int idx = walk.item(i);
    if (idx < 0) return;
    const int r0 = walk.row0(idx);
    const int64_t row = static_cast<int64_t>(walk.ig(idx)) * walk.S + r0 + rl;  // q's row of tile row rl
    const float qsr[2] = {qs[row], qs[row + 8]};
    const int slot = i % R::kQSlots;
    const uint32_t qa = base + R::kQ + slot * R::kQBytes;
    mbar_wait(bar(R::kQFull + slot), (i / R::kQSlots) & 1);
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f}, acc[kHalf];
#pragma unroll
    for (int k = 0; k < kHalf; ++k) acc[k] = 0.0f;
    for (int j = 0, nb = walk.blocks(r0); j < nb; ++j) {
      const int n = walk.chunks(r0, j);
      // This warpgroup's chunks w and w + 2 of the block's n. The branches
      // around the MMAs depend on n alone, the same in both warpgroups:
      // under a branch ptxas sees as divergent it serializes every wgmma.
      // So both warpgroups take a second chunk where n > 2, and a chunk past
      // n (warpgroup 1's at n = 1 and n = 3) is a dummy: its MMAs read the
      // block's last chunk's stages, and it skips the arithmetic (its scores
      // count as all masked: p = 0, p_i8 = 0, it adds nothing) and releases
      // no stage. The branches that skip it hold no MMA and run while none
      // is in flight.
      const bool two = n > 2, real0 = w < n, real1 = w + 2 < n;
      const int g0 = g + min(w, n - 1), g1 = g + min(w + 2, n - 1);
      int s0[64], s1[64];
      const auto issue = [&](int (&d)[64], int gc) {
        const int s = gc % R::kKStages;
        mbar_wait(bar(R::kKFull + s), (gc / R::kKStages) & 1);
        const uint32_t kb = base + R::kK + s * R::kKBytes;
        fence_acc(d);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 32; ++kk) wgmma_ss(d, qk_desc<HD>(qa + 32 * kk), qk_desc<HD>(kb + 32 * kk), kk);
        wgmma_commit();
        fence_acc(d);
      };
      // s of chunk c from its scores. Only the item's last block holds
      // columns past a row where causal; lim0 is the column of row rl's
      // diagonal in the chunk.
      const bool masked = walk.causal && j == nb - 1;
      const auto scale = [&](int (&d)[64], int gc, int c, float (&mx)[2]) {
        const float* ksc = scales + (gc % R::kKStages) * (2 * kFlashChunk);
        const int lim0 = r0 + rl - (j * walk.bkv + c * kFlashChunk);
        if (masked) {
          scores<true>(d, qsr, ksc, quad, lim0, mx);
        } else {
          scores<false>(d, qsr, ksc, quad, lim0, mx);
        }
      };
      float mx[2] = {kNegInf, kNegInf};
      issue(s0, g0);
      if (two) {  // then the first chunk is real
        issue(s1, g1);
        wgmma_wait<1>();  // the first chunk's MMAs are done; the second's run on under its scaling
        fence_acc(s0);
        scale(s0, g0, w, mx);
        wgmma_wait<0>();
        fence_acc(s1);
        if (real1) scale(s1, g1, w + 2, mx);
      } else {
        wgmma_wait<0>();
        fence_acc(s0);
        if (real0) scale(s0, g0, w, mx);
      }
      // exchange 1: the row max
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        if (quad == 0) red[0][w][rl + 8 * h] = mx[h];
      }
      consumers_sync();
      float mn[2], alpha[2], sum[2] = {0.0f, 0.0f}, pm[2] = {0.0f, 0.0f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mn[h] = fmaxf(m[h], fmaxf(red[0][0][rl + 8 * h], red[0][1][rl + 8 * h]));
        alpha[h] = expf(__fsub_rn(m[h], mn[h]));
      }
      if (real0) probs(s0, mn, scales + (g0 % R::kKStages) * (2 * kFlashChunk) + kFlashChunk, quad, sum, pm);
      if (real1) probs(s1, mn, scales + (g1 % R::kKStages) * (2 * kFlashChunk) + kFlashChunk, quad, sum, pm);
      __syncwarp();
      if (lane == 0) {  // the warp is done with its chunks' k stages
        if (real0) mbar_arrive(bar(R::kKEmpty + g0 % R::kKStages));
        if (real1) mbar_arrive(bar(R::kKEmpty + g1 % R::kKStages));
      }
      // exchange 2: the row sum of p and the row max of ps
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] = __fadd_rn(sum[h], __shfl_xor_sync(0xffffffffu, sum[h], 1));
        sum[h] = __fadd_rn(sum[h], __shfl_xor_sync(0xffffffffu, sum[h], 2));
        pm[h] = fmaxf(pm[h], __shfl_xor_sync(0xffffffffu, pm[h], 1));
        pm[h] = fmaxf(pm[h], __shfl_xor_sync(0xffffffffu, pm[h], 2));
        if (quad == 0) red[1][w][rl + 8 * h] = sum[h], red[2][w][rl + 8 * h] = pm[h];
      }
      consumers_sync();
      float pscale[2], rcp[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = rl + 8 * h;
        l[h] = __fadd_rn(__fmul_rn(l[h], alpha[h]), __fadd_rn(red[1][0][r], red[1][1][r]));
        pscale[h] = __fmul_rn(fmaxf(red[2][0][r], red[2][1][r]), kInv127);
        rcp[h] = 1.0f / fmaxf(pscale[h], 1e-30f);
        m[h] = mn[h];
      }
      // p_i8 . v^T over this warpgroup's chunks (a dummy's p_i8 is zero:
      // whatever its stage holds adds nothing)
      int pv[HD / 2];
      uint32_t a0[4][4], a1[4][4];
      if (real0) {
        pack(s0, rcp, a0);
      } else {
        zero(a0);
      }
      if (real1) {
        pack(s1, rcp, a1);
      } else {
        zero(a1);
      }
      // A dummy waits on the item's q barrier, a phase already seen: its
      // stage's owner may have released it, and the stage's barrier moved on
      // by two phases, before this warpgroup looks.
      const auto v_ready = [&](bool real, int gc) {
        mbar_wait(real ? bar(R::kVFull + gc % R::kVStages) : bar(R::kQFull + slot),
                  real ? (gc / R::kVStages) & 1 : (i / R::kQSlots) & 1);
      };
      v_ready(real0, g0);
      if (two) v_ready(real1, g1);
      const uint32_t v0 = base + R::kV + (g0 % R::kVStages) * R::kVBytes;
      const uint32_t v1 = base + R::kV + (g1 % R::kVStages) * R::kVBytes;
      fence_acc(pv);
      fence_frags(a0);
      fence_frags(a1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs(pv, a0[kk], qt_sm90::smem_desc(v0 + 32 * kk, 16, 1024), kk);
      if (two) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs(pv, a1[kk], qt_sm90::smem_desc(v1 + 32 * kk, 16, 1024), 1);
      }
      wgmma_commit();
      fence_acc(pv);
      wgmma_wait<0>();
      fence_acc(pv);
      fence_frags(a0);
      fence_frags(a1);
      __syncwarp();
      if (lane == 0) {
        if (real0) mbar_arrive(bar(R::kVEmpty + g0 % R::kVStages));
        if (real1) mbar_arrive(bar(R::kVEmpty + g1 % R::kVStages));
      }
      // exchange 3: each warpgroup hands the other the half of its product
      // that the other keeps (accumulators 4 j + 2 h + e hold column 8 j + 2 q
      // + e: warpgroup 0 keeps j < HD / 16, the first kHalf)
#pragma unroll
      for (int k = 0; k < kHalf; ++k) xchg[(w * kHalf + k) * 128 + t] = w ? pv[k] : pv[kHalf + k];
      consumers_sync();
#pragma unroll
      for (int k = 0; k < kHalf; ++k) {
        const int h = (k >> 1) & 1;
        const int both = (w ? pv[kHalf + k] : pv[k]) + xchg[((1 - w) * kHalf + k) * 128 + t];
        acc[k] = __fadd_rn(__fmul_rn(acc[k], alpha[h]), __fmul_rn(__int2float_rn(both), pscale[h]));
      }
      g += n;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar(R::kQEmpty + slot));  // the item's QK^T MMAs are done with its q tile
    float lc[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) lc[h] = fmaxf(l[h], 1e-20f);
    __nv_bfloat16* o = out + row * HD + w * (HD / 2) + 2 * quad;
#pragma unroll
    for (int jj = 0; jj < HD / 16; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<__nv_bfloat162*>(o + 8 * h * HD + 8 * jj) =
            __floats2bfloat162_rn(acc[4 * jj + 2 * h] / lc[h], acc[4 * jj + 2 * h + 1] / lc[h]);
    if (w == 0 && quad == 0) {
      lse[row] = __fadd_rn(m[0], logf(lc[0]));
      lse[row + 8] = __fadd_rn(m[1], logf(lc[1]));
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kFlashThreads, 1)
flash_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv, const float* __restrict__ qs, const float* __restrict__ ks,
           const float* __restrict__ vs, __nv_bfloat16* __restrict__ out, float* __restrict__ lse, const Walk walk) {
  using R = Ring<HD>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_mem[R::kBars];
  __shared__ float red[3][2][kFlashRows];  // per warpgroup: row max, row sum of p, row max of ps
  uint8_t* ring = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(ring), bars = smem_u32(bar_mem);
  if (threadIdx.x == 0) {
    const auto init = [&](int first, int n, uint32_t count) {
      for (int i = 0; i < n; ++i) mbar_init(bars + 8 * (first + i), count);
    };
    init(R::kQFull, R::kQSlots, 1);
    init(R::kQEmpty, R::kQSlots, 8);  // the consumers' 8 warps
    init(R::kKFull, R::kKStages, 1);
    init(R::kKEmpty, R::kKStages, 4);  // the 4 warps of the chunk's warpgroup
    init(R::kRawFull, R::kRawSlots, 1);
    init(R::kRawEmpty, R::kRawSlots, kTransposers);
    init(R::kVFull, R::kVStages, kTransposers);
    init(R::kVEmpty, R::kVStages, 4);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    qt_sm90::setmaxnreg_dec<kProducerRegs>();
    const int t = threadIdx.x - 256;
    if (t == 0) {
      load<HD>(&tq, &tk, &tv, ks, vs, base, bars, walk);
    } else if (t >= 32) {
      transpose<HD>(ring, bars, walk, t - 32);
    }
    return;
  }
  qt_sm90::setmaxnreg_inc<kConsumerRegs>();
  // the warpgroup's index through a shuffle, so that ptxas sees it is the
  // same in every lane: branches on it are then not divergent, and the MMAs
  // inside them are not serialized
  consume<HD>(ring, base, bars, red, qs, out, lse, walk, __shfl_sync(0xffffffffu, wg, 0));
}

template <int HD>
cudaError_t launch(const void* q, const void* qs, const void* k, const void* ks, const void* v, const void* vs,
                   void* out, void* lse, int n_inst, int G, int S, int bkv, int causal, int ctas,
                   cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  const CUtensorMapSwizzle swizzle = HD == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
  const uint64_t q_rows = static_cast<uint64_t>(n_inst) * G * S, kv_rows = static_cast<uint64_t>(n_inst) * S;
  cudaError_t err = qt_sm90::encode_2d(&tq, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, HD, q_rows, HD, HD, kFlashRows, swizzle);
  if (err == cudaSuccess)
    err = qt_sm90::encode_2d(&tk, CU_TENSOR_MAP_DATA_TYPE_UINT8, k, HD, kv_rows, HD, HD, kFlashChunk, swizzle);
  if (err == cudaSuccess)
    err = qt_sm90::encode_2d(&tv, CU_TENSOR_MAP_DATA_TYPE_UINT8, v, HD, kv_rows, HD, HD, kFlashChunk,
                             CU_TENSOR_MAP_SWIZZLE_NONE);
  constexpr int smem = Ring<HD>::kBytes + 1024;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_sm90<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles = S / kFlashRows;
  const Walk walk{n_inst * G, G, S, tiles, n_inst * G * tiles, bkv, causal};
  flash_sm90<HD><<<ctas, kFlashThreads, smem, stream>>>(
      tq, tk, tv, static_cast<const float*>(qs), static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), walk);
  return cudaGetLastError();
}

}  // namespace flash

// Returns the launch's cudaError_t (0 on success). q [n_inst, G, S, hd] and
// k, v [n_inst, S, hd] int8, 16-byte aligned; qs [n_inst, G, S], ks, vs
// [n_inst, S] fp32; out [n_inst, G, S, hd] bf16, lse [n_inst, G, S] fp32; all
// contiguous. hd is 64 or 128, S % 64 == 0, bkv a multiple of 64 that
// divides S, at most 512. ctas > 0: the sm90 design on that many CTAs (bkv a
// multiple of 128, ks and vs 16-byte aligned); 0: the first design.
extern "C" int qt_int8_flash_fwd(const void* q, const void* qs, const void* k, const void* ks, const void* v,
                                 const void* vs, void* out, void* lse, int n_inst, int G, int S, int hd, int bkv,
                                 int causal, int ctas, void* stream) {
  if (n_inst <= 0 || G <= 0 || S <= 0) return 0;
  if (S % BQ || bkv % BT || bkv > 512 || S % bkv) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ctas > 0) {
    const bool aligned = (reinterpret_cast<uintptr_t>(ks) | reinterpret_cast<uintptr_t>(vs)) % 16 == 0;
    if (bkv % flash::kFlashChunk || bkv > flash::kFlashMaxBkv || !aligned)
      return static_cast<int>(cudaErrorInvalidValue);
    if (hd == 64)
      return static_cast<int>(flash::launch<64>(q, qs, k, ks, v, vs, out, lse, n_inst, G, S, bkv, causal, ctas, s));
    if (hd == 128)
      return static_cast<int>(flash::launch<128>(q, qs, k, ks, v, vs, out, lse, n_inst, G, S, bkv, causal, ctas, s));
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (hd == 64) return static_cast<int>(launch<64>(q, qs, k, ks, v, vs, out, lse, n_inst, G, S, bkv, causal, s));
  if (hd == 128) return static_cast<int>(launch<128>(q, qs, k, ks, v, vs, out, lse, n_inst, G, S, bkv, causal, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
