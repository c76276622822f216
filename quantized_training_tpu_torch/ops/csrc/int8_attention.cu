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
// numerics: the kernel walks the block in 64-column sub-tiles but quantizes p
// over the whole block. The q tile changes no number (a kv block wholly in a
// row's future is an exact no-op: alpha = 1, p = 0, p_i8 = 0), so the kernel
// takes 64 q rows a block whatever block_q the caller names. Every product,
// sum and exponential is a separate IEEE fp32 operation in the JAX order
// (__fmul_rn / __fadd_rn: no contraction into FMAs; expf / logf, not the
// approximate intrinsics; true divisions), so the kernel differs from its
// plain version only in the order of the row sums of p.
//
// Bound on the H100 at Llama2-1B's attention (16 instances = batch 4 x 4 kv
// heads, G 8, S 2048, hd 64): the ~268 M exponentials of the causal triangle
// at the special-function units' rate (16 a clock per SM: 4.18 T/s at
// 1,980 MHz), ~64 us; the int8
// tensor-core work (~69 GOP, 35 us) and the bytes (~57 MB, 17 us) are below
// it. Design: the scores of a 64-row tile over one kv block are needed
// before any of them can be quantized (the max and absmax run over the whole
// block), and at BKV = 512 they are 128 KB of fp32: too many for registers,
// so they live in shared memory (dynamic, up to 227 KB), computed once. One
// CTA of 8 warps takes 64 q rows of one (instance, group): (A) the score
// tile, q [64, hd] . k^T over 64-column sub-tiles on int8 wmma (k K-major, as
// stored), int32 into shared memory; (B) one warp per 8 rows runs the
// softmax statistics, p and its quantize in place (warp-shuffle sums in a
// fixed order); (C) p_i8 . v over the same sub-tiles on int8 wmma (v MN-major,
// as stored) and the rescaled fp32 accumulate, 16-32 values a thread in
// registers. Sub-tiles wholly in the future of the tile's last row are
// skipped in (A) and (C): their scores are masked, their p_i8 zero. Simple
// first: the k/v sub-tiles load synchronously (no cp.async or TMA), and a
// causal tile still runs the exponentials of its masked columns.

#include <mma.h>

#include "mm_tiles.cuh"

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

// Returns the launch's cudaError_t (0 on success). q [n_inst, G, S, hd] and
// k, v [n_inst, S, hd] int8, 16-byte aligned; qs [n_inst, G, S], ks, vs
// [n_inst, S] fp32; out [n_inst, G, S, hd] bf16, lse [n_inst, G, S] fp32; all
// contiguous. hd is 64 or 128, S % 64 == 0, bkv a multiple of 64 that
// divides S, at most 512 (the score tile's shared memory).
extern "C" int qt_int8_flash_fwd(const void* q, const void* qs, const void* k, const void* ks, const void* v,
                                 const void* vs, void* out, void* lse, int n_inst, int G, int S, int hd, int bkv,
                                 int causal, void* stream) {
  if (n_inst <= 0 || G <= 0 || S <= 0) return 0;
  if (S % BQ || bkv % BT || bkv > 512 || S % bkv) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64) return static_cast<int>(launch<64>(q, qs, k, ks, v, vs, out, lse, n_inst, G, S, bkv, causal, s));
  if (hd == 128) return static_cast<int>(launch<128>(q, qs, k, ks, v, vs, out, lse, n_inst, G, S, bkv, causal, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
