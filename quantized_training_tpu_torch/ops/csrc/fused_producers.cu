// Producer-fused int8 quantize kernels, the one-pass RMSNorm backward and the
// silu backward fused into the int8 quantizes of its two outputs.
//
// The ViT's block has the same shape of work: affine LayerNorm makes the qkv
// and fc1 inputs and tanh-GELU the fc2 input (B18 below, two more producers
// of the same row and column templates).
// In the int8 decoder layer every quantized linear's input is made by a
// cheap op, the "producer": RMSNorm (the q/k/v and gate/up inputs) or
// silu(gate) * up (the down projection's input). Unfused, the producer writes
// its bf16 output and the quantize reads it back, in the forward, in the
// remat replay and in the backward's column quantize. These kernels run the
// producer inside the quantize, so the producer's output never reaches
// device memory and the quantize sees its unrounded fp32 values. The same
// holds in the backward of silu(gate) * up: (dgate, dup) are computed in
// fp32 from (gate, up, dy) and quantized along both axes without ever being
// written in bf16.
//
// Numerics are the Pallas bodies' (ops/pallas_fused.py:95-132 with
// pallas_quant.py:75-87), not quant/core.py's: scale = absmax * (1/127) in
// fp32, q = rint(y * (1 / max(scale, eps))) with a correctly rounded
// reciprocal, or with SR floor(y * inv + u), u the uniform at element (r, c)'s
// index r * K + c of the key's Philox stream (philox.cuh), clamped to int8.
// The producers, in fp32 with every operation rounded once (no contraction):
//   rmsnorm: y = (x * rstd) * g, rstd = rsqrt(sum(x * x) / K + norm_eps);
//   silu:    y = (a * s) * b, s = 1 / (1 + exp(-a));
//   its backward at dy: da = ((dy * b) * s) * (1 + a * (1 - s)),
//                       db = (dy * a) * s;
//   layernorm: y = ((x - mean) * rstd) * g + b, mean = sum(x) / K,
//              rstd = rsqrt(sum((x - mean)^2) / K + norm_eps);
//   gelu:    y = a * ((tanh(inner) + 1) * 0.5),
//            inner = (a + ((a * a) * a) * 0.044715) * sqrt(2/pi).
// The row's sum of squares runs in one fixed order (each thread its own
// vectors, a butterfly across the warp, the warps in order), so the same row
// gives the same y in every kernel here: the column maxima that B7, the row
// form of B9 and B11 forward give the column quantizes the exact scale of the
// two-pass form.
//
// Kernels, what they replace (quantized_training_tpu/ops/pallas_fused.py):
// - B7 rmsnorm_rows, or row_quant<NormProducer> at widths the row walk does
//   not take: rmsnorm_quant_rowwise (:154), x [M, K] -> q int8 [M, K],
//   scale fp32 [M], optionally the column absmax fp32 [K];
// - B9 elementwise_rows<SiluMulOp>, or row_quant<SiluProducer> at widths the
//   row walk does not take: silu_mul_quant_rowwise (:325), a, b [M, K];
// - B8 rmsnorm_cols, or col_quant<NormProducer> at widths the row walk does
//   not take and in the two-pass form (after producer_col_absmax):
//   rmsnorm_quant_colwise (:246), column int8 given the column scales;
// - B9 elementwise_cols<SiluMulOp> given scales, or col_quant<SiluProducer>
//   at widths the row walk does not take and in the two-pass form:
//   silu_mul_quant_colwise (:409), the same;
// - B10 rmsnorm_bwd_walk, or rmsnorm_bwd_rows at widths the row walk does
//   not take, then reduce_parts: rmsnorm_bwd (:491), dx in x's dtype and
//   dgamma fp32 [K] in one read of x and dy;
// - B11 silu_bwd_rows, or silu_bwd_row_quant at widths the row walk does
//   not take: silu_mul_bwd_quant_rowwise (:631), (a, b, dy) [M, K] -> the
//   row int8 of da and of db with fp32 row scales, optionally the column
//   absmax of each and their copies in the inputs' dtype;
// - B12 silu_bwd_cols, or silu_bwd_col_quant at widths the row walk does
//   not take: silu_mul_bwd_quant_colwise (:704), the column int8 of da and
//   db given their column scales;
// - B18 _producer_quant_call (:803) through layernorm_quant (:918) and
//   gelu_quant (:952), x [M, K] with g, b [K], or a [M, K]: its row body
//   (:848) layernorm_rows and elementwise_rows<GeluOp>, its column body
//   given scales (:898) layernorm_cols and elementwise_cols<GeluOp>, or
//   row_quant / col_quant over LayerNormProducer and GeluProducer at widths
//   the row walk does not take, and with producer_col_absmax in the
//   two-pass column form; the JAX package's SR salts 17 and 19 fold into its
//   TPU seed, so here the key alone picks the stream.
// B11 and B12 draw SR noise for da at r * K + c and for db at M * K + r * K +
// c of their key's stream.
//
// What bounds them on the H100: bytes. B7 at [8192, 2048] bf16 moves 50 MB
// (x read, q written), B9-row at [8192, 5632] 231 MB (a and b read), B10 101
// MB (x, dy read, dx written), B11 and B12 at [8192, 5632] 369 MB ((a, b, dy)
// read, two int8 written): 15, 69, 30 and 110 us at 3.35 TB/s; the exp of the
// sigmoid is about 20 fp32 operations per element, under a third of B9's
// memory time. B18 at ViT-Giant's 6,400 padded tokens: LayerNorm [6400, 1536]
// 29.5 MB, 8.8 us; GELU [6400, 6144] 118 MB, 35.2 us, with a tanh of some 25
// fp32 operations per element, near the memory time. Design: a block of 256 threads walks a run of rows; a thread
// owns the same 16-byte vectors (8 bf16 or 4 fp32) of every row, so its
// loads are coalesced and the column maxima (B7, B9 and B11 with column
// absmax) and the dgamma partial sums (B10) it keeps in shared memory need no
// atomics inside the block. The producer writes the row's y once into shared
// memory (fp32, element j of vector i at [j * nv + i], so a warp's accesses
// hit distinct banks); the absmax pass and the cast read it back from there
// (B11 keeps two such rows, da and db). Each block writes its column maxima
// or dgamma partial sums to an fp32 [blocks, K] buffer, which reduce_parts
// folds over the blocks in a fixed order: dgamma is a function of its
// inputs, and no atomics are used. (Merging the maxima by atomicMax instead,
// K per block on the same K addresses, serializes: B7 with the column absmax
// took 103 us that way at [8192, 2048], against 56 us for B8, on an H100
// 80GB HBM3 at 700 W.) B12 needs no row state: each element's (da, db) is
// cast with its column's inverse scale, kept in shared memory. wgmma and TMA
// do not apply.
//
// B7, B8 given scales, B9's row form and its given-scales column form, B10,
// B11, B12 and B18's row and given-scales column forms, the paths' producer
// kernels with the most lost time, were redesigned for the H100's memory system
// (ops/fused_producers.py's routes choose them where their layout leaves no
// lane idle; the first design above stays for the other widths):
// a persistent grid of a few CTAs an SM (RowWalk, row_common.cuh) whose
// groups of whole warps take one row at a time, every lane holding the same
// kNormV (B7, B8), kNormBwdV (B10), three or four (B18's LayerNorm) or one
// or two (B9, B11, B12, B18's GELU) 16-byte vectors of each row, the next row's
// loaded before this row is worked on; the
// producer's values stay in registers from the load to the cast, row sums
// and maxima reduce by warp shuffles and a named barrier a group, the
// column state (maxima, the column forms' inverse scales, B10's dgamma sums) stays in
// registers and meets once a CTA (one row of partials a CTA, 264 at [8192,
// 2048], not 547), and the casts round and convert by one add (byte_rn,
// byte_sr) where rintf and the float -> int cast each took a quarter-rate
// conversion. The first design loaded one row's vectors, then waited at
// four __syncthreads before it cast and stored, with y and the column state
// in shared memory; B10's read x and dy twice and added into a shared dgamma
// row for every element.

#include <type_traits>

#include "row_common.cuh"

namespace {

// ---- the producers ----------------------------------------------------------
// fill(row, ybuf, red): write the row's y into this thread's entries of ybuf
// ([j * nv + i] for its vectors i) and return the max |y| over them.

template <typename T>
struct NormProducer {
  static constexpr int N = 16 / sizeof(T);
  const T* __restrict__ x;
  const float* __restrict__ g;  // gamma, widened to fp32 by the wrapper (exact)
  int64_t K;
  float norm_eps;

  __device__ __forceinline__ float fill(int64_t row, float* ybuf, float* red) const {
    const int64_t nv = K / N;
    const T* xr = x + row * K;
    float ss = 0.0f;
    for (int64_t i = threadIdx.x; i < nv; i += kThreads) {
      float v[N];
      load_vec<T, N>(xr + i * N, v);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        ybuf[j * nv + i] = v[j];
        ss = __fmaf_rn(v[j], v[j], ss);
      }
    }
    ss = block_reduce<false>(ss, red);
    const float rstd = __frsqrt_rn(__fadd_rn(__fdiv_rn(ss, static_cast<float>(K)), norm_eps));
    float amax = 0.0f;
    for (int64_t i = threadIdx.x; i < nv; i += kThreads) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float y = __fmul_rn(__fmul_rn(ybuf[j * nv + i], rstd), g[i * N + j]);
        ybuf[j * nv + i] = y;
        amax = fmaxf(amax, fabsf(y));
      }
    }
    return amax;
  }
};

// The sigmoid as 1 / (1 + exp(-a)), IEEE division: the plain versions
// (ops/fused_producers.py::silu_mul_f32, ::silu_mul_bwd_f32) compute the same
// operations in the same order, so B9, B11 and B12 are bit-exact with them on
// the card.
__device__ __forceinline__ float sigmoid(float a) { return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-a))); }

__device__ __forceinline__ float silu_mul(float a, float b) { return __fmul_rn(__fmul_rn(a, sigmoid(a)), b); }

// (da, db) of y = silu(a) * b at the upstream gradient dy.
__device__ __forceinline__ void silu_mul_bwd(float a, float b, float dy, float& da, float& db) {
  const float s = sigmoid(a);
  da = __fmul_rn(__fmul_rn(__fmul_rn(dy, b), s), __fadd_rn(1.0f, __fmul_rn(a, __fsub_rn(1.0f, s))));
  db = __fmul_rn(__fmul_rn(dy, a), s);
}

template <typename T>
struct SiluProducer {
  static constexpr int N = 16 / sizeof(T);
  const T* __restrict__ a;
  const T* __restrict__ b;
  int64_t K;

  __device__ __forceinline__ float fill(int64_t row, float* ybuf, float*) const {
    const int64_t nv = K / N;
    float amax = 0.0f;
    for (int64_t i = threadIdx.x; i < nv; i += kThreads) {
      float va[N], vb[N];
      load_vec<T, N>(a + row * K + i * N, va);
      load_vec<T, N>(b + row * K + i * N, vb);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float y = silu_mul(va[j], vb[j]);
        ybuf[j * nv + i] = y;
        amax = fmaxf(amax, fabsf(y));
      }
    }
    return amax;
  }
};

// B18's LayerNorm: two fixed-order block sums over the row held in ybuf, the
// mean, then the mean of (x - mean)^2; y = ((x - mean) * rstd) * g + b.
template <typename T>
struct LayerNormProducer {
  static constexpr int N = 16 / sizeof(T);
  const T* __restrict__ x;
  const float* __restrict__ g;  // gamma and beta, widened to fp32 by the wrapper (exact)
  const float* __restrict__ b;
  int64_t K;
  float norm_eps;

  __device__ __forceinline__ float fill(int64_t row, float* ybuf, float* red) const {
    const int64_t nv = K / N;
    const T* xr = x + row * K;
    const float kf = static_cast<float>(K);
    float s = 0.0f;
    for (int64_t i = threadIdx.x; i < nv; i += kThreads) {
      float v[N];
      load_vec<T, N>(xr + i * N, v);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        ybuf[j * nv + i] = v[j];
        s = __fadd_rn(s, v[j]);
      }
    }
    const float mean = __fdiv_rn(block_reduce<false>(s, red), kf);
    float ss = 0.0f;
    for (int64_t i = threadIdx.x; i < nv; i += kThreads)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float c = __fsub_rn(ybuf[j * nv + i], mean);
        ybuf[j * nv + i] = c;
        ss = __fmaf_rn(c, c, ss);
      }
    const float rstd = __frsqrt_rn(__fadd_rn(__fdiv_rn(block_reduce<false>(ss, red), kf), norm_eps));
    float amax = 0.0f;
    for (int64_t i = threadIdx.x; i < nv; i += kThreads)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float y = __fadd_rn(__fmul_rn(__fmul_rn(ybuf[j * nv + i], rstd), g[i * N + j]), b[i * N + j]);
        ybuf[j * nv + i] = y;
        amax = fmaxf(amax, fabsf(y));
      }
    return amax;
  }
};

// B18's GELU, the tanh form, in the plain version's order
// (ops/fused_producers.py::gelu_f32): inner = (a + ((a * a) * a) * 0.044715)
// * sqrt(2/pi), y = a * ((tanh(inner) + 1) * 0.5), each operation rounded
// once; tanhf is the libdevice function PyTorch's tanh calls, so the kernel
// is bit-exact with the plain version on the card.
__device__ __forceinline__ float gelu_tanh(float a) {
  constexpr float kSqrt2OverPi = 0.7978845608028654f;
  const float cube = __fmul_rn(__fmul_rn(a, a), a);
  const float inner = __fmul_rn(__fadd_rn(a, __fmul_rn(cube, 0.044715f)), kSqrt2OverPi);
  return __fmul_rn(a, __fmul_rn(__fadd_rn(tanhf(inner), 1.0f), 0.5f));
}

template <typename T>
struct GeluProducer {
  static constexpr int N = 16 / sizeof(T);
  const T* __restrict__ a;
  int64_t K;

  __device__ __forceinline__ float fill(int64_t row, float* ybuf, float*) const {
    const int64_t nv = K / N;
    float amax = 0.0f;
    for (int64_t i = threadIdx.x; i < nv; i += kThreads) {
      float v[N];
      load_vec<T, N>(a + row * K + i * N, v);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float y = gelu_tanh(v[j]);
        ybuf[j * nv + i] = y;
        amax = fmaxf(amax, fabsf(y));
      }
    }
    return amax;
  }
};

// ---- B7, the row form of B9 and of B18 --------------------------------------

// Rows [rpb * blockIdx.x, +rpb): the row quantize of the producer's y; with
// COLMAX also this block's column absmax of |y| into parts[blockIdx.x].
// Dynamic shared memory: ybuf [K], then (COLMAX) colmax [K], both fp32.
template <class P, bool SR, bool COLMAX>
__global__ void __launch_bounds__(kThreads)
row_quant(P p, int8_t* __restrict__ q, float* __restrict__ s_row, float* __restrict__ parts, int64_t M,
          int64_t rpb, float eps, uint64_t key) {
  constexpr int N = P::N;
  using Pack = typename PackOf<N>::type;
  extern __shared__ float smem[];
  __shared__ float red[kWarps];
  const int64_t K = p.K, nv = K / N;
  float* ybuf = smem;
  float* colmax = smem + K;
  if (COLMAX)
    for (int64_t i = threadIdx.x; i < nv; i += kThreads)
#pragma unroll
      for (int j = 0; j < N; ++j) colmax[j * nv + i] = 0.0f;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rpb;
  const int64_t r1 = r0 + rpb < M ? r0 + rpb : M;
  for (int64_t row = r0; row < r1; ++row) {
    const float s = __fmul_rn(block_reduce<true>(p.fill(row, ybuf, red), red), kInv127);
    const float inv = __frcp_rn(fmaxf(s, eps));
    for (int64_t i = threadIdx.x; i < nv; i += kThreads) {
      uint32_t w[N];
      vec_words<SR, N>(row * K + i * N, key, w);
      union {
        Pack pack;
        int8_t c[N];
      } out;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float y = ybuf[j * nv + i];
        out.c[j] = quant<SR>(y, inv, w[j]);
        if (COLMAX) colmax[j * nv + i] = fmaxf(colmax[j * nv + i], fabsf(y));
      }
      *reinterpret_cast<Pack*>(q + row * K + i * N) = out.pack;
    }
    if (threadIdx.x == 0) s_row[row] = s;
  }
  if (COLMAX) store_part<N>(colmax, parts, K);
}

// The group's totals of S row sums, each held by a lane as C chains (chain c
// of lane t: the vectors of NormProducer::fill's thread t + c TPR, in that
// thread's order), in fill's order: each chain butterflied across its warp
// (the old warp h + c W), then the old warps' sums in order, through ``red``
// (S kWarps floats of shared memory for this group) and the group's named
// barrier; a group of one warp needs neither.
template <int TPR, int C, int S>
__device__ __forceinline__ void chain_totals(float (&s)[S][C], float (&tot)[S], float* red, int grp) {
  constexpr int W = TPR / 32;
  const int h = (threadIdx.x % TPR) / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int k = 0; k < S; ++k)
#pragma unroll
    for (int c = 0; c < C; ++c) s[k][c] = warp_reduce<false>(s[k][c]);
  if constexpr (W == 1) {
#pragma unroll
    for (int k = 0; k < S; ++k) {
      tot[k] = s[k][0];
#pragma unroll
      for (int c = 1; c < C; ++c) tot[k] = __fadd_rn(tot[k], s[k][c]);
    }
  } else {
    if (lane == 0)
#pragma unroll
      for (int k = 0; k < S; ++k)
#pragma unroll
        for (int c = 0; c < C; ++c) red[k * kWarps + h + c * W] = s[k][c];
    group_sync(grp, TPR);
#pragma unroll
    for (int k = 0; k < S; ++k) {
      tot[k] = red[k * kWarps];
#pragma unroll
      for (int w = 1; w < C * W; ++w) tot[k] = __fadd_rn(tot[k], red[k * kWarps + w]);
    }
  }
}

// B7 on the persistent row walk (RowWalk; the route ops/fused_producers.py::
// norm_rows_sm90_route picks): a CTA of kThreads threads in groups of TPR,
// kNormV vectors a thread a row. y, the cast's input, stays in registers from
// the load to the store; the row's sum of squares and max reduce by warp
// shuffles, across the group's warps through a few shared words and the
// group's named barrier (each of the row's two exchanges is read before the
// group's next barrier, so the next row's writes never meet it); with COLMAX
// each thread keeps its columns' maxima in registers and the CTA merges its
// groups' once, into parts[blockIdx.x].
//
// The sum of squares is NormProducer::fill's to the bit (so the column
// maxima are the two-pass form's, producer_col_absmax's): there thread u <
// 256 fma's its vectors u, u + 256, ... in element order, a 32-lane
// butterfly sums each warp, and warp 0's sum adds warps 1 .. 7 in order.
// Here vector t + p TPR of the row is that of thread (t + p TPR) % 256, so
// with TPR dividing 256 a lane keeps one chain a thread it stands for (the
// chains of p, p + 256 / TPR, ...), butterflies each across its warp, and the
// old warps' sums meet in their order.
// Dynamic shared memory: g (element j of vector v at j nv + v), then (COLMAX)
// the CTA's column maxima, as bits.
constexpr int kNormV = 4;  // vectors a thread a row

template <typename T, bool SR, bool COLMAX, int TPR>
__global__ void __launch_bounds__(kThreads, 2)
rmsnorm_rows(const T* __restrict__ x, const float* __restrict__ g, int8_t* __restrict__ q, float* __restrict__ s_row,
             float* __restrict__ parts, int64_t M, int64_t K, float norm_eps, float eps, uint64_t key) {
  constexpr int N = 16 / sizeof(T), V = kNormV, W = TPR / 32, R = kThreads / TPR;
  constexpr int C = V < R ? V : R;  // sum-of-squares chains a thread
  static_assert(kThreads % TPR == 0 && TPR % 32 == 0, "whole warps, whole groups");
  using Walk = RowWalk<V, 1>;
  extern __shared__ float smem[];
  __shared__ float red_ss[R][kWarps];
  __shared__ unsigned int red_max[R][W];
  const Walk walk(TPR);
  const int h = walk.t / 32, lane = walk.t % 32;
  const int64_t nv = K / N;  // TPR V
  float* gs = smem;
  unsigned int* cmax = reinterpret_cast<unsigned int*>(smem + K);
  for (int64_t c = threadIdx.x; c < K; c += kThreads) {
    gs[(c % N) * nv + c / N] = g[c];
    if (COLMAX) cmax[c] = 0u;
  }
  __syncthreads();
  float cm[COLMAX ? V : 1][N];
#pragma unroll
  for (int p = 0; p < (COLMAX ? V : 1); ++p)
#pragma unroll
    for (int j = 0; j < N; ++j) cm[p][j] = 0.0f;
  const uint4* const in[1] = {reinterpret_cast<const uint4*>(x)};
  walk.run(in, M, nv, [&](int64_t row, const uint4 (&u)[1][V]) {
    float y[V][N], ss[1][C], tot[1];
#pragma unroll
    for (int c = 0; c < C; ++c) ss[0][c] = 0.0f;
#pragma unroll
    for (int p = 0; p < V; ++p) {
      const T* e = reinterpret_cast<const T*>(&u[0][p]);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        y[p][j] = to_f32(e[j]);
        ss[0][p % R] = __fmaf_rn(y[p][j], y[p][j], ss[0][p % R]);
      }
    }
    chain_totals<TPR, C, 1>(ss, tot, red_ss[walk.grp], walk.grp);
    const float rstd = __frsqrt_rn(__fadd_rn(__fdiv_rn(tot[0], static_cast<float>(K)), norm_eps));
    float amax = 0.0f;
#pragma unroll
    for (int p = 0; p < V; ++p)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        y[p][j] = __fmul_rn(__fmul_rn(y[p][j], rstd), gs[j * nv + walk.vec(p)]);
        amax = fmaxf(amax, fabsf(y[p][j]));
        if (COLMAX) cm[p][j] = fmaxf(cm[p][j], fabsf(y[p][j]));
      }
    unsigned int m = __reduce_max_sync(0xFFFFFFFFu, __float_as_uint(amax));  // non-negative: bits order as floats
    if constexpr (W > 1) {
      if (lane == 0) red_max[walk.grp][h] = m;
      group_sync(walk.grp, TPR);
#pragma unroll
      for (int w = 0; w < W; ++w) m = ::max(m, red_max[walk.grp][w]);
    }
    const float s = __fmul_rn(__uint_as_float(m), kInv127);
    const float inv = inv_scale(s, eps);
#pragma unroll
    for (int p = 0; p < V; ++p) {
      const int64_t off = row * K + walk.vec(p) * N;
      cast_pack<SR, N>(y[p], inv, off, key, q + off);
    }
    if (walk.t == 0) s_row[row] = s;
  });
  if (COLMAX) {
#pragma unroll
    for (int p = 0; p < V; ++p)
#pragma unroll
      for (int j = 0; j < N; ++j) atomicMax(cmax + walk.vec(p) * N + j, __float_as_uint(cm[p][j]));
    __syncthreads();
    for (int64_t c = threadIdx.x; c < K; c += kThreads) parts[blockIdx.x * K + c] = __uint_as_float(cmax[c]);
  }
}

// ---- B8 and the column form of B9 -------------------------------------------

// Pass 1 of the two-pass form: this block's column absmax of |y| into
// parts[blockIdx.x]. Dynamic shared memory: ybuf [K], colmax [K].
template <class P>
__global__ void __launch_bounds__(kThreads)
producer_col_absmax(P p, float* __restrict__ parts, int64_t M, int64_t rpb) {
  constexpr int N = P::N;
  extern __shared__ float smem[];
  __shared__ float red[kWarps];
  const int64_t K = p.K, nv = K / N;
  float* ybuf = smem;
  float* colmax = smem + K;
  for (int64_t i = threadIdx.x; i < nv; i += kThreads)
#pragma unroll
    for (int j = 0; j < N; ++j) colmax[j * nv + i] = 0.0f;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rpb;
  const int64_t r1 = r0 + rpb < M ? r0 + rpb : M;
  for (int64_t row = r0; row < r1; ++row) {
    p.fill(row, ybuf, red);
    for (int64_t i = threadIdx.x; i < nv; i += kThreads)
#pragma unroll
      for (int j = 0; j < N; ++j) colmax[j * nv + i] = fmaxf(colmax[j * nv + i], fabsf(ybuf[j * nv + i]));
  }
  store_part<N>(colmax, parts, K);
}

// The column quantize of y with the column scales ``scale`` [K]; with
// FROM_AMAX ``scale`` holds the column absmax and the scale is amax * (1/127),
// which the first row of blocks stores into s_out [K]. Dynamic shared
// memory: ybuf [K], inv [K] (1 / max(scale, eps) of this thread's columns).
template <class P, bool SR, bool FROM_AMAX>
__global__ void __launch_bounds__(kThreads)
col_quant(P p, const float* __restrict__ scale, float* __restrict__ s_out, int8_t* __restrict__ q, int64_t M,
          int64_t rpb, float eps, uint64_t key) {
  constexpr int N = P::N;
  using Pack = typename PackOf<N>::type;
  extern __shared__ float smem[];
  __shared__ float red[kWarps];
  const int64_t K = p.K, nv = K / N;
  float* ybuf = smem;
  float* inv = smem + K;
  for (int64_t i = threadIdx.x; i < nv; i += kThreads)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float s = FROM_AMAX ? __fmul_rn(scale[i * N + j], kInv127) : scale[i * N + j];
      inv[j * nv + i] = __frcp_rn(fmaxf(s, eps));
      if (FROM_AMAX && blockIdx.x == 0) s_out[i * N + j] = s;
    }
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rpb;
  const int64_t r1 = r0 + rpb < M ? r0 + rpb : M;
  for (int64_t row = r0; row < r1; ++row) {
    p.fill(row, ybuf, red);
    for (int64_t i = threadIdx.x; i < nv; i += kThreads) {
      uint32_t w[N];
      vec_words<SR, N>(row * K + i * N, key, w);
      union {
        Pack pack;
        int8_t c[N];
      } out;
#pragma unroll
      for (int j = 0; j < N; ++j) out.c[j] = quant<SR>(ybuf[j * nv + i], inv[j * nv + i], w[j]);
      *reinterpret_cast<Pack*>(q + row * K + i * N) = out.pack;
    }
  }
}

// B8 given the column scales, on the persistent row walk (the route
// ops/fused_producers.py::norm_cols_sm90_route picks): B7's geometry, a CTA
// of kThreads threads in groups of TPR, kNormV vectors a thread a row. A
// thread owns the same columns in every row, so it computes their inverse
// scales once, into registers; the row's sum of squares is B7's (and so
// NormProducer::fill's) to the bit, through one exchange a row (alternating
// between two shared arrays by row parity, so that one barrier a row
// suffices); y = (x * rstd) * g is recomputed from the loaded vectors and
// cast at once, so no row of y stays in registers. q is col_quant's bit for
// bit. Dynamic shared memory: g (element j of vector v at j nv + v).
template <typename T, bool SR, int TPR>
__global__ void __launch_bounds__(kThreads, 2)
rmsnorm_cols(const T* __restrict__ x, const float* __restrict__ g, const float* __restrict__ scale,
             int8_t* __restrict__ q, int64_t M, int64_t K, float norm_eps, float eps, uint64_t key) {
  constexpr int N = 16 / sizeof(T), V = kNormV, R = kThreads / TPR;
  constexpr int C = V < R ? V : R;  // sum-of-squares chains a thread
  static_assert(kThreads % TPR == 0 && TPR % 32 == 0, "whole warps, whole groups");
  using Walk = RowWalk<V, 1>;
  extern __shared__ float gs[];
  __shared__ float red[2][R][kWarps];
  const Walk walk(TPR);
  const int64_t nv = K / N;  // TPR V
  for (int64_t c = threadIdx.x; c < K; c += kThreads) gs[(c % N) * nv + c / N] = g[c];
  float inv[V][N];
#pragma unroll
  for (int p = 0; p < V; ++p)
#pragma unroll
    for (int j = 0; j < N; ++j) inv[p][j] = inv_scale(scale[walk.vec(p) * N + j], eps);
  __syncthreads();
  int parity = 0;
  const uint4* const in[1] = {reinterpret_cast<const uint4*>(x)};
  walk.run(in, M, nv, [&](int64_t row, const uint4 (&u)[1][V]) {
    float ss[1][C], tot[1];
#pragma unroll
    for (int c = 0; c < C; ++c) ss[0][c] = 0.0f;
#pragma unroll
    for (int p = 0; p < V; ++p) {
      const T* e = reinterpret_cast<const T*>(&u[0][p]);
#pragma unroll
      for (int j = 0; j < N; ++j) ss[0][p % R] = __fmaf_rn(to_f32(e[j]), to_f32(e[j]), ss[0][p % R]);
    }
    chain_totals<TPR, C, 1>(ss, tot, red[parity][walk.grp], walk.grp);
    parity ^= 1;
    const float rstd = __frsqrt_rn(__fadd_rn(__fdiv_rn(tot[0], static_cast<float>(K)), norm_eps));
#pragma unroll
    for (int p = 0; p < V; ++p) {
      const T* e = reinterpret_cast<const T*>(&u[0][p]);
      float y[N];
#pragma unroll
      for (int j = 0; j < N; ++j) y[j] = __fmul_rn(__fmul_rn(to_f32(e[j]), rstd), gs[j * nv + walk.vec(p)]);
      const int64_t off = row * K + walk.vec(p) * N;
      cast_pack<SR, N>(y, inv[p], off, key, q + off);
    }
  });
}

// ---- B18's LayerNorm on the row walk -------------------------------------------

// B18's LayerNorm rows on the persistent row walk (the route
// ops/fused_producers.py::layernorm_rows_sm90_route picks): B7's geometry
// (rmsnorm_rows), a CTA of kThreads threads in groups of TPR, V vectors a
// thread a row, TPR V the row's vectors, V one of kLayerNormVs: at bf16 K
// 1536 (192 vectors) 64 threads a row, three vectors each, four groups a
// CTA. Thread t of a group holds vectors t, t + TPR, t + 2 TPR, which are
// the first design's threads t + c TPR (row_quant<LayerNormProducer> runs
// thread u < 256 over vectors u, u + 256, ...), so chain_totals (B7's chain
// mapping) takes both row sums in LayerNormProducer::fill's order, each
// operation as there: the sum by __fadd_rn, the mean by __fdiv_rn, the
// centred values' squares by __fmaf_rn, rsqrt by __frsqrt_rn, y = ((x -
// mean) rstd) g + b. q, the row scales and the column maxima are the first
// design's bit for bit. y stays in registers from the load to the cast; a
// row takes three exchanges (sum, centred sum of squares, max), each
// through its own shared words and the group's named barrier: an
// exchange's words are read before the group's next barrier, and written
// again only after it. With COLMAX each thread keeps its columns' maxima in
// registers and the CTA merges its groups' once, into parts[blockIdx.x].
// Two CTAs an SM, the SR form one: at two (128 registers) it spilled 40
// bytes and ran 1.1 us slower at [6400, 1536] (ab_sm90_forms.py's
// ln_one_cta). Dynamic shared memory: g, b (element j of vector v at j nv +
// v), then (COLMAX) the CTA's column maxima, as bits.
constexpr int kLayerNormVs[] = {4, 3};  // the vectors a thread the route tries, in order
constexpr int kLayerNormCtasPerSm = 2;  // CTAs an SM the launch bounds keep resident (the SR rows form: one)

template <bool SR>
constexpr int layernorm_rows_ctas() { return SR ? 1 : kLayerNormCtasPerSm; }

template <typename T, bool SR, bool COLMAX, int V, int TPR>
__global__ void __launch_bounds__(kThreads, layernorm_rows_ctas<SR>())
layernorm_rows(const T* __restrict__ x, const float* __restrict__ g, const float* __restrict__ b,
               int8_t* __restrict__ q, float* __restrict__ s_row, float* __restrict__ parts, int64_t M, int64_t K,
               float norm_eps, float eps, uint64_t key) {
  constexpr int N = 16 / sizeof(T), W = TPR / 32, R = kThreads / TPR;
  constexpr int C = V < R ? V : R;  // chains a thread of each row sum
  static_assert(kThreads % TPR == 0 && TPR % 32 == 0, "whole warps, whole groups");
  using Walk = RowWalk<V, 1>;
  extern __shared__ float smem[];
  __shared__ float red_s[R][kWarps], red_ss[R][kWarps];
  __shared__ unsigned int red_max[R][W];
  const Walk walk(TPR);
  const int h = walk.t / 32, lane = walk.t % 32;
  const int64_t nv = K / N;  // TPR V
  float* gs = smem;
  float* bs = smem + K;
  unsigned int* cmax = reinterpret_cast<unsigned int*>(smem + 2 * K);
  for (int64_t c = threadIdx.x; c < K; c += kThreads) {
    gs[(c % N) * nv + c / N] = g[c];
    bs[(c % N) * nv + c / N] = b[c];
    if (COLMAX) cmax[c] = 0u;
  }
  __syncthreads();
  float cm[COLMAX ? V : 1][N];
#pragma unroll
  for (int p = 0; p < (COLMAX ? V : 1); ++p)
#pragma unroll
    for (int j = 0; j < N; ++j) cm[p][j] = 0.0f;
  const float kf = static_cast<float>(K);
  const uint4* const in[1] = {reinterpret_cast<const uint4*>(x)};
  walk.run(in, M, nv, [&](int64_t row, const uint4 (&u)[1][V]) {
    float y[V][N], s[1][C], tot[1];
#pragma unroll
    for (int c = 0; c < C; ++c) s[0][c] = 0.0f;
#pragma unroll
    for (int p = 0; p < V; ++p) {
      const T* e = reinterpret_cast<const T*>(&u[0][p]);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        y[p][j] = to_f32(e[j]);
        s[0][p % R] = __fadd_rn(s[0][p % R], y[p][j]);
      }
    }
    chain_totals<TPR, C, 1>(s, tot, red_s[walk.grp], walk.grp);
    const float mean = __fdiv_rn(tot[0], kf);
#pragma unroll
    for (int c = 0; c < C; ++c) s[0][c] = 0.0f;
#pragma unroll
    for (int p = 0; p < V; ++p)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        y[p][j] = __fsub_rn(y[p][j], mean);
        s[0][p % R] = __fmaf_rn(y[p][j], y[p][j], s[0][p % R]);
      }
    chain_totals<TPR, C, 1>(s, tot, red_ss[walk.grp], walk.grp);
    const float rstd = __frsqrt_rn(__fadd_rn(__fdiv_rn(tot[0], kf), norm_eps));
    float amax = 0.0f;
#pragma unroll
    for (int p = 0; p < V; ++p)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const int64_t at = j * nv + walk.vec(p);
        y[p][j] = __fadd_rn(__fmul_rn(__fmul_rn(y[p][j], rstd), gs[at]), bs[at]);
        amax = fmaxf(amax, fabsf(y[p][j]));
        if (COLMAX) cm[p][j] = fmaxf(cm[p][j], fabsf(y[p][j]));
      }
    unsigned int m = __reduce_max_sync(0xFFFFFFFFu, __float_as_uint(amax));  // non-negative: bits order as floats
    if constexpr (W > 1) {
      if (lane == 0) red_max[walk.grp][h] = m;
      group_sync(walk.grp, TPR);
#pragma unroll
      for (int w = 0; w < W; ++w) m = ::max(m, red_max[walk.grp][w]);
    }
    const float sc = __fmul_rn(__uint_as_float(m), kInv127);
    const float inv = inv_scale(sc, eps);
#pragma unroll
    for (int p = 0; p < V; ++p) {
      const int64_t off = row * K + walk.vec(p) * N;
      cast_pack<SR, N>(y[p], inv, off, key, q + off);
    }
    if (walk.t == 0) s_row[row] = sc;
  });
  if (COLMAX) {
#pragma unroll
    for (int p = 0; p < V; ++p)
#pragma unroll
      for (int j = 0; j < N; ++j) atomicMax(cmax + walk.vec(p) * N + j, __float_as_uint(cm[p][j]));
    __syncthreads();
    for (int64_t c = threadIdx.x; c < K; c += kThreads) parts[blockIdx.x * K + c] = __uint_as_float(cmax[c]);
  }
}

// B18's LayerNorm columns given the column scales, on the row walk (the
// route ops/fused_producers.py::layernorm_cols_sm90_route picks):
// layernorm_rows' layout and both row sums in its order (two exchanges a
// row, each through its own shared words), a thread's inverse column scales
// computed once into registers, y recomputed from the loaded vectors and
// cast at once, so no row of y stays in registers. q is
// col_quant<LayerNormProducer>'s bit for bit. Dynamic shared memory: g, b
// (element j of vector v at j nv + v).
template <typename T, bool SR, int V, int TPR>
__global__ void __launch_bounds__(kThreads, kLayerNormCtasPerSm)
layernorm_cols(const T* __restrict__ x, const float* __restrict__ g, const float* __restrict__ b,
               const float* __restrict__ scale, int8_t* __restrict__ q, int64_t M, int64_t K, float norm_eps,
               float eps, uint64_t key) {
  constexpr int N = 16 / sizeof(T), R = kThreads / TPR;
  constexpr int C = V < R ? V : R;  // chains a thread of each row sum
  static_assert(kThreads % TPR == 0 && TPR % 32 == 0, "whole warps, whole groups");
  using Walk = RowWalk<V, 1>;
  extern __shared__ float smem[];
  __shared__ float red_s[R][kWarps], red_ss[R][kWarps];
  const Walk walk(TPR);
  const int64_t nv = K / N;  // TPR V
  float* gs = smem;
  float* bs = smem + K;
  for (int64_t c = threadIdx.x; c < K; c += kThreads) {
    gs[(c % N) * nv + c / N] = g[c];
    bs[(c % N) * nv + c / N] = b[c];
  }
  float inv[V][N];
#pragma unroll
  for (int p = 0; p < V; ++p)
#pragma unroll
    for (int j = 0; j < N; ++j) inv[p][j] = inv_scale(scale[walk.vec(p) * N + j], eps);
  __syncthreads();
  const float kf = static_cast<float>(K);
  const uint4* const in[1] = {reinterpret_cast<const uint4*>(x)};
  walk.run(in, M, nv, [&](int64_t row, const uint4 (&u)[1][V]) {
    float s[1][C], tot[1];
#pragma unroll
    for (int c = 0; c < C; ++c) s[0][c] = 0.0f;
#pragma unroll
    for (int p = 0; p < V; ++p) {
      const T* e = reinterpret_cast<const T*>(&u[0][p]);
#pragma unroll
      for (int j = 0; j < N; ++j) s[0][p % R] = __fadd_rn(s[0][p % R], to_f32(e[j]));
    }
    chain_totals<TPR, C, 1>(s, tot, red_s[walk.grp], walk.grp);
    const float mean = __fdiv_rn(tot[0], kf);
#pragma unroll
    for (int c = 0; c < C; ++c) s[0][c] = 0.0f;
#pragma unroll
    for (int p = 0; p < V; ++p) {
      const T* e = reinterpret_cast<const T*>(&u[0][p]);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float c = __fsub_rn(to_f32(e[j]), mean);
        s[0][p % R] = __fmaf_rn(c, c, s[0][p % R]);
      }
    }
    chain_totals<TPR, C, 1>(s, tot, red_ss[walk.grp], walk.grp);
    const float rstd = __frsqrt_rn(__fadd_rn(__fdiv_rn(tot[0], kf), norm_eps));
#pragma unroll
    for (int p = 0; p < V; ++p) {
      const T* e = reinterpret_cast<const T*>(&u[0][p]);
      float y[N];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const int64_t at = j * nv + walk.vec(p);
        y[j] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(to_f32(e[j]), mean), rstd), gs[at]), bs[at]);
      }
      const int64_t off = row * K + walk.vec(p) * N;
      cast_pack<SR, N>(y, inv[p], off, key, q + off);
    }
  });
}

// ---- B10 --------------------------------------------------------------------

// Rows [rpb * blockIdx.x, +rpb) of the RMSNorm backward (the closed form of
// quant/fused.py::_rmsnorm_bwd_math): rstd = rsqrt(sum(x * x) / K + eps),
// xn = x * rstd, dxn = dy * g, c = sum(dxn * xn) / K taken as
// (sum(dy * g * x) * rstd) / K, dx = (dxn - xn * c) * rstd in x's dtype; this
// block's partial sum of dy * xn over its rows goes to dg_part[blockIdx.x]
// [K]. Pass 2 re-reads the row, which the pass before left in L1/L2.
// Dynamic shared memory: dgacc [K].
template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_rows(const T* __restrict__ x, const float* __restrict__ g, const T* __restrict__ dy,
                 T* __restrict__ dx, float* __restrict__ dg_part, int64_t M, int64_t K, int64_t rpb,
                 float norm_eps) {
  constexpr int N = 16 / sizeof(T);
  extern __shared__ float dgacc[];
  __shared__ float red[kWarps];
  const int64_t nv = K / N;
  for (int64_t i = threadIdx.x; i < nv; i += kThreads)
#pragma unroll
    for (int j = 0; j < N; ++j) dgacc[j * nv + i] = 0.0f;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rpb;
  const int64_t r1 = r0 + rpb < M ? r0 + rpb : M;
  for (int64_t row = r0; row < r1; ++row) {
    const T* xr = x + row * K;
    const T* dyr = dy + row * K;
    float ss = 0.0f, sd = 0.0f;
    for (int64_t i = threadIdx.x; i < nv; i += kThreads) {
      float vx[N], vd[N];
      load_vec<T, N>(xr + i * N, vx);
      load_vec<T, N>(dyr + i * N, vd);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        ss = __fmaf_rn(vx[j], vx[j], ss);
        sd = __fmaf_rn(__fmul_rn(vd[j], g[i * N + j]), vx[j], sd);
      }
    }
    ss = block_reduce<false>(ss, red);
    sd = block_reduce<false>(sd, red);
    const float kf = static_cast<float>(K);
    const float rstd = __frsqrt_rn(__fadd_rn(__fdiv_rn(ss, kf), norm_eps));
    const float c = __fdiv_rn(__fmul_rn(sd, rstd), kf);
    for (int64_t i = threadIdx.x; i < nv; i += kThreads) {
      float vx[N], vd[N];
      load_vec<T, N>(xr + i * N, vx);
      load_vec<T, N>(dyr + i * N, vd);
      uint4 out;
      T* e = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float xn = __fmul_rn(vx[j], rstd);
        const float dxn = __fmul_rn(vd[j], g[i * N + j]);
        store_elem(&e[j], __fmul_rn(__fsub_rn(dxn, __fmul_rn(xn, c)), rstd));
        dgacc[j * nv + i] = __fadd_rn(dgacc[j * nv + i], __fmul_rn(vd[j], xn));
      }
      *reinterpret_cast<uint4*>(dx + row * K + i * N) = out;
    }
  }
  store_part<N>(dgacc, dg_part, K);
}

// B10 on the persistent row walk (the route ops/fused_producers.py::
// rmsnorm_bwd_sm90_route picks): a CTA of kThreads threads in groups of TPR,
// kNormBwdV vectors of x and of dy a thread a row, each loaded once. Both row
// sums, sum(x * x) and sum((dy * g) * x), keep rmsnorm_bwd_rows' order by
// B7's chain mapping (chain_totals, one exchange a row for both, alternating
// between two shared arrays by row parity), so dx is the first design's bit
// for bit. Each thread sums its columns' dy * xn over its rows in registers;
// the CTA merges its groups' sums in group order through shared memory and
// writes one row of parts [CTAs, K], which reduce_parts folds in order: no
// atomics, so dgamma is a function of the inputs and the grid (its order,
// and so its last bits, differ from the first design's). Dynamic shared
// memory: g, then the groups' sums [R][K] (element j of vector v at j nv + v).
constexpr int kNormBwdV = 2;  // vectors of each input a thread a row

template <typename T, int TPR>
__global__ void __launch_bounds__(kThreads, 2)
rmsnorm_bwd_walk(const T* __restrict__ x, const float* __restrict__ g, const T* __restrict__ dy, T* __restrict__ dx,
                 float* __restrict__ parts, int64_t M, int64_t K, float norm_eps) {
  constexpr int N = 16 / sizeof(T), V = kNormBwdV, R = kThreads / TPR;
  constexpr int C = V < R ? V : R;  // chains a thread of each row sum
  static_assert(kThreads % TPR == 0 && TPR % 32 == 0, "whole warps, whole groups");
  using Walk = RowWalk<V, 2>;
  extern __shared__ float smem[];
  __shared__ float red[2][R][2 * kWarps];
  const Walk walk(TPR);
  const int64_t nv = K / N;  // TPR V
  float* gs = smem;
  float* sums = smem + K;
  for (int64_t c = threadIdx.x; c < K; c += kThreads) gs[(c % N) * nv + c / N] = g[c];
  __syncthreads();
  float acc[V][N];
#pragma unroll
  for (int p = 0; p < V; ++p)
#pragma unroll
    for (int j = 0; j < N; ++j) acc[p][j] = 0.0f;
  int parity = 0;
  const float kf = static_cast<float>(K);
  const uint4* const in[2] = {reinterpret_cast<const uint4*>(x), reinterpret_cast<const uint4*>(dy)};
  walk.run(in, M, nv, [&](int64_t row, const uint4 (&u)[2][V]) {
    float s[2][C], tot[2];
#pragma unroll
    for (int c = 0; c < C; ++c) s[0][c] = s[1][c] = 0.0f;
#pragma unroll
    for (int p = 0; p < V; ++p) {
      const T* ex = reinterpret_cast<const T*>(&u[0][p]);
      const T* ed = reinterpret_cast<const T*>(&u[1][p]);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float vx = to_f32(ex[j]);
        s[0][p % R] = __fmaf_rn(vx, vx, s[0][p % R]);
        s[1][p % R] = __fmaf_rn(__fmul_rn(to_f32(ed[j]), gs[j * nv + walk.vec(p)]), vx, s[1][p % R]);
      }
    }
    chain_totals<TPR, C, 2>(s, tot, red[parity][walk.grp], walk.grp);
    parity ^= 1;
    const float rstd = __frsqrt_rn(__fadd_rn(__fdiv_rn(tot[0], kf), norm_eps));
    const float c = __fdiv_rn(__fmul_rn(tot[1], rstd), kf);
#pragma unroll
    for (int p = 0; p < V; ++p) {
      const T* ex = reinterpret_cast<const T*>(&u[0][p]);
      const T* ed = reinterpret_cast<const T*>(&u[1][p]);
      float o[N];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float vd = to_f32(ed[j]);
        const float xn = __fmul_rn(to_f32(ex[j]), rstd);
        const float dxn = __fmul_rn(vd, gs[j * nv + walk.vec(p)]);
        o[j] = __fmul_rn(__fsub_rn(dxn, __fmul_rn(xn, c)), rstd);
        acc[p][j] = __fadd_rn(acc[p][j], __fmul_rn(vd, xn));
      }
      store_vec<T, N>(dx + row * K + walk.vec(p) * N, o);
    }
  });
#pragma unroll
  for (int p = 0; p < V; ++p)
#pragma unroll
    for (int j = 0; j < N; ++j) sums[walk.grp * K + j * nv + walk.vec(p)] = acc[p][j];
  __syncthreads();
  for (int64_t c = threadIdx.x; c < K; c += kThreads) {
    const int64_t at = (c % N) * nv + c / N;
    float r = sums[at];
#pragma unroll
    for (int grp = 1; grp < R; ++grp) r = __fadd_rn(r, sums[grp * K + at]);
    parts[blockIdx.x * K + c] = r;
  }
}

// ---- B11 and B12 ------------------------------------------------------------

// B11: rows [rpb * blockIdx.x, +rpb) of (da, db): each row's values go to
// shared memory, then both row quantizes; with AMAX this block's column
// maxima of |da| and |db| go to parts[blockIdx.x] ([blocks, 2K]: da's at
// [0, K), db's at [K, 2K)); with COPY both are also written in T.
// Dynamic shared memory: the da and db rows [2K], then (AMAX) their column
// maxima [2K], all fp32.
template <typename T, bool SR, bool AMAX, bool COPY>
__global__ void __launch_bounds__(kThreads)
silu_bwd_row_quant(const T* __restrict__ a, const T* __restrict__ b, const T* __restrict__ dy,
                   int8_t* __restrict__ qa, float* __restrict__ sa, int8_t* __restrict__ qb, float* __restrict__ sb,
                   float* __restrict__ parts, T* __restrict__ ca, T* __restrict__ cb, int64_t M, int64_t K,
                   int64_t rpb, float eps, uint64_t key) {
  constexpr int N = 16 / sizeof(T);
  using Pack = typename PackOf<N>::type;
  extern __shared__ float smem[];
  __shared__ float red[kWarps];
  const int64_t nv = K / N;
  float* ya = smem;
  float* yb = smem + K;
  float* ma = smem + 2 * K;
  float* mb = smem + 3 * K;
  if (AMAX) {
    zero_cols<N>(ma, K);
    zero_cols<N>(mb, K);
  }
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rpb;
  const int64_t r1 = r0 + rpb < M ? r0 + rpb : M;
  for (int64_t row = r0; row < r1; ++row) {
    float amax_a = 0.0f, amax_b = 0.0f;
    for (int64_t i = threadIdx.x; i < nv; i += kThreads) {
      const int64_t off = row * K + i * N;
      float va[N], vb[N], vd[N], da[N], db[N];
      load_vec<T, N>(a + off, va);
      load_vec<T, N>(b + off, vb);
      load_vec<T, N>(dy + off, vd);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        silu_mul_bwd(va[j], vb[j], vd[j], da[j], db[j]);
        ya[j * nv + i] = da[j];
        yb[j * nv + i] = db[j];
        amax_a = fmaxf(amax_a, fabsf(da[j]));
        amax_b = fmaxf(amax_b, fabsf(db[j]));
      }
      if (COPY) {
        store_vec<T, N>(ca + off, da);
        store_vec<T, N>(cb + off, db);
      }
    }
    const float s_a = __fmul_rn(block_reduce<true>(amax_a, red), kInv127);
    const float s_b = __fmul_rn(block_reduce<true>(amax_b, red), kInv127);
    const float inv_a = inv_scale(s_a, eps), inv_b = inv_scale(s_b, eps);
    for (int64_t i = threadIdx.x; i < nv; i += kThreads) {
      const int64_t off = row * K + i * N;
      uint32_t wa[N], wb[N];
      vec_words<SR, N>(off, key, wa);
      vec_words<SR, N>(M * K + off, key, wb);
      Int8Pack<N> oa, ob;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float da = ya[j * nv + i], db = yb[j * nv + i];
        oa.c[j] = quant<SR>(da, inv_a, wa[j]);
        ob.c[j] = quant<SR>(db, inv_b, wb[j]);
        if (AMAX) {
          ma[j * nv + i] = fmaxf(ma[j * nv + i], fabsf(da));
          mb[j * nv + i] = fmaxf(mb[j * nv + i], fabsf(db));
        }
      }
      *reinterpret_cast<Pack*>(qa + off) = oa.pack;
      *reinterpret_cast<Pack*>(qb + off) = ob.pack;
    }
    if (threadIdx.x == 0) {
      sa[row] = s_a;
      sb[row] = s_b;
    }
  }
  if (AMAX) {
    store_part<N>(ma, parts, K, 2 * K, 0);
    store_part<N>(mb, parts, K, 2 * K, K);
  }
}

// B11 on the persistent row walk (the route ops/fused_producers.py::
// silu_bwd_rows_sm90_route picks): groups of tpr threads (a CTA of tpr, or of
// kThreads when tpr divides it), V vectors a thread a row, tpr V the row's
// vectors: at K = 5632 bf16 one row of 704 vectors a CTA of 352 threads.
// (da, db) stay in registers from the load to the casts; the two row maxima
// reduce by warp shuffles, across the group's warps through shared words
// (alternating between rows, so one barrier a row suffices); with AMAX each
// thread keeps its columns' maxima in registers and the CTA writes them, its
// groups merged, to parts[blockIdx.x] ([CTAs, 2K]: da's at [0, K), db's at
// [K, 2K)); with COPY (da, db) are also written in T. The sigmoid stays
// silu_mul_bwd's IEEE division: __frcp_rn rounds 1 / d the same, but ran
// B11 3% slower (ab_sm90_forms.py's b11_rcp). Dynamic shared memory: with
// more than one group, the CTA's column maxima [2K], as bits.

// The largest CTA of each layout: 22 warps (6 on some of the SM's four
// schedulers) leave 80 registers a thread, 12 warps 168.
constexpr int kSiluRowsMaxCta = 704, kSiluRowsMaxCta2 = 384;

template <typename T, bool SR, bool AMAX, bool COPY, int V>
__global__ void __launch_bounds__(V == 1 ? kSiluRowsMaxCta : kSiluRowsMaxCta2)
silu_bwd_rows(const T* __restrict__ a, const T* __restrict__ b, const T* __restrict__ dy, int8_t* __restrict__ qa,
              float* __restrict__ sa, int8_t* __restrict__ qb, float* __restrict__ sb, float* __restrict__ parts,
              T* __restrict__ ca, T* __restrict__ cb, int64_t M, int64_t K, int tpr, float eps, uint64_t key) {
  constexpr int N = 16 / sizeof(T);
  using Walk = RowWalk<V, 3>;
  extern __shared__ unsigned int cmax[];  // [2K]
  __shared__ uint2 red[2][kSiluRowsMaxCta / 32];  // each warp's (max |da|, max |db|) bits, by row parity
  const Walk walk(tpr);
  const int warps = tpr / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool merge = AMAX && blockDim.x > tpr;
  const int64_t nv = K / N;  // tpr V
  if (merge) {
    for (int64_t c = threadIdx.x; c < 2 * K; c += blockDim.x) cmax[c] = 0u;
    __syncthreads();
  }
  float ma[AMAX ? V : 1][N], mb[AMAX ? V : 1][N];
#pragma unroll
  for (int p = 0; p < (AMAX ? V : 1); ++p)
#pragma unroll
    for (int j = 0; j < N; ++j) ma[p][j] = mb[p][j] = 0.0f;
  int parity = 0;
  const uint4* const in[3] = {reinterpret_cast<const uint4*>(a), reinterpret_cast<const uint4*>(b),
                              reinterpret_cast<const uint4*>(dy)};
  walk.run(in, M, nv, [&](int64_t row, const uint4 (&u)[3][V]) {
    float da[V][N], db[V][N], am_a = 0.0f, am_b = 0.0f;
#pragma unroll
    for (int p = 0; p < V; ++p) {
      const T* ea = reinterpret_cast<const T*>(&u[0][p]);
      const T* eb = reinterpret_cast<const T*>(&u[1][p]);
      const T* ed = reinterpret_cast<const T*>(&u[2][p]);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        silu_mul_bwd(to_f32(ea[j]), to_f32(eb[j]), to_f32(ed[j]), da[p][j], db[p][j]);
        am_a = fmaxf(am_a, fabsf(da[p][j]));
        am_b = fmaxf(am_b, fabsf(db[p][j]));
        if (AMAX) {
          ma[p][j] = fmaxf(ma[p][j], fabsf(da[p][j]));
          mb[p][j] = fmaxf(mb[p][j], fabsf(db[p][j]));
        }
      }
      if (COPY) {
        const int64_t off = row * K + walk.vec(p) * N;
        store_vec<T, N>(ca + off, da[p]);
        store_vec<T, N>(cb + off, db[p]);
      }
    }
    // non-negative: the bits order as the floats
    unsigned int mx = __reduce_max_sync(0xFFFFFFFFu, __float_as_uint(am_a));
    unsigned int my = __reduce_max_sync(0xFFFFFFFFu, __float_as_uint(am_b));
    if (warps > 1) {
      if (lane == 0) red[parity][warp] = make_uint2(mx, my);
      group_sync(walk.grp, tpr);
      for (int w = walk.grp * warps; w < (walk.grp + 1) * warps; ++w) {
        mx = ::max(mx, red[parity][w].x);
        my = ::max(my, red[parity][w].y);
      }
      parity ^= 1;
    }
    const float s_a = __fmul_rn(__uint_as_float(mx), kInv127), s_b = __fmul_rn(__uint_as_float(my), kInv127);
    const float inv_a = inv_scale(s_a, eps), inv_b = inv_scale(s_b, eps);
#pragma unroll
    for (int p = 0; p < V; ++p) {
      const int64_t off = row * K + walk.vec(p) * N;
      cast_pack<SR, N>(da[p], inv_a, off, key, qa + off);
      cast_pack<SR, N>(db[p], inv_b, M * K + off, key, qb + off);
    }
    if (walk.t == 0) {
      sa[row] = s_a;
      sb[row] = s_b;
    }
  });
  if (!AMAX) return;
  float* part = parts + blockIdx.x * 2 * K;
#pragma unroll
  for (int p = 0; p < V; ++p)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int64_t c = walk.vec(p) * N + j;
      if (merge) {
        atomicMax(cmax + c, __float_as_uint(ma[p][j]));
        atomicMax(cmax + K + c, __float_as_uint(mb[p][j]));
      } else {
        part[c] = ma[p][j];
        part[K + c] = mb[p][j];
      }
    }
  if (merge) {
    __syncthreads();
    for (int64_t c = threadIdx.x; c < 2 * K; c += blockDim.x) part[c] = __uint_as_float(cmax[c]);
  }
}

// The elementwise producers of the walks below: y of the fp32 values of
// kIn inputs at one element.
struct SiluMulOp {  // B9
  static constexpr int kIn = 2;
  __device__ static float y(const float (&v)[2]) { return silu_mul(v[0], v[1]); }
};

struct GeluOp {  // B18's GELU
  static constexpr int kIn = 1;
  __device__ static float y(const float (&v)[1]) { return gelu_tanh(v[0]); }
};

// Element j of vector p of each of the Op's inputs, as fp32, through the Op.
template <class Op, typename T, int V>
__device__ __forceinline__ float op_at(const uint4 (&u)[Op::kIn][V], int p, int j) {
  float v[Op::kIn];
#pragma unroll
  for (int k = 0; k < Op::kIn; ++k) v[k] = to_f32(reinterpret_cast<const T*>(&u[k][p])[j]);
  return Op::y(v);
}

// B9's row form and B18's GELU rows on the persistent row walk (the routes
// ops/fused_producers.py::silu_rows_sm90_route and ::gelu_rows_sm90_route
// pick): groups of tpr threads (a CTA of tpr, or of kThreads when tpr
// divides it), V vectors a thread a row, tpr V the row's vectors: at K =
// 5632 bf16 one row of 704 vectors a CTA of 352 threads, two vectors each;
// at K = 6144 (GELU) 768 vectors, 384 threads. y = Op::y of the inputs (a,
// b for silu_mul, a for GELU) stays in registers from the load to the
// cast; the row max reduces by warp shuffles, across the group's warps
// through shared words (alternating between rows, so one barrier a row
// suffices); with COLMAX the CTA writes its columns' maxima, its groups
// merged, to parts[blockIdx.x]. The RN form runs two CTAs an SM (80
// registers a thread) with each group's column maxima in shared memory,
// updated in place (a thread owns its columns there); the SR form one CTA
// an SM, the maxima in registers (its Philox words would spill at 80).
// ab_sm90_forms.py times the other layouts (b9_one_cta, b9_reg_max,
// b9_v1; gelu_one_cta, gelu_v3). The max is order-free, so the outputs are
// row_quant<SiluProducer>'s (row_quant<GeluProducer>'s) bit for bit.
// Dynamic shared memory: with COLMAX, the RN form's groups' column maxima
// [groups][K] (fp32, element j of vector v at j nv + v), or the SR form's
// merge of more than one group's [K], as bits.
constexpr int kSiluCtasPerSm = 2;  // CTAs an SM the launch bounds keep resident (the RN form at V = 2)

template <bool SR, int V>
constexpr int silu_rows_ctas() { return V == 1 || SR ? 1 : kSiluCtasPerSm; }

template <class Op, typename T, bool SR, bool COLMAX, int V>
__global__ void __launch_bounds__(V == 1 ? kSiluRowsMaxCta : kSiluRowsMaxCta2, silu_rows_ctas<SR, V>())
elementwise_rows(const T* __restrict__ a, const T* __restrict__ b, int8_t* __restrict__ q,
                 float* __restrict__ s_row, float* __restrict__ parts, int64_t M, int64_t K, int tpr, float eps,
                 uint64_t key) {
  constexpr int N = 16 / sizeof(T), NIN = Op::kIn;
  constexpr bool kShared = COLMAX && !SR, kRegs = COLMAX && !kShared;  // where the column maxima live
  using Walk = RowWalk<V, NIN>;
  extern __shared__ unsigned int cmax[];  // [K], or [groups][K] with kShared
  __shared__ unsigned int red[2][kSiluRowsMaxCta / 32];  // each warp's max |y| bits, by row parity
  const Walk walk(tpr);
  const int warps = tpr / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int groups = blockDim.x / tpr;
  const bool merge = kRegs && groups > 1;
  const int64_t nv = K / N;  // tpr V
  if (merge || kShared) {
    for (int64_t c = threadIdx.x; c < (kShared ? groups : 1) * K; c += blockDim.x) cmax[c] = 0u;
    __syncthreads();
  }
  float* gmax = reinterpret_cast<float*>(cmax) + walk.grp * K;  // kShared: this group's, [j nv + vector]
  float cm[kRegs ? V : 1][N];
#pragma unroll
  for (int p = 0; p < (kRegs ? V : 1); ++p)
#pragma unroll
    for (int j = 0; j < N; ++j) cm[p][j] = 0.0f;
  int parity = 0;
  const uint4* const ab[2] = {reinterpret_cast<const uint4*>(a), reinterpret_cast<const uint4*>(b)};
  const uint4* in[NIN];
#pragma unroll
  for (int k = 0; k < NIN; ++k) in[k] = ab[k];
  walk.run(in, M, nv, [&](int64_t row, const uint4 (&u)[NIN][V]) {
    float y[V][N], am = 0.0f;
#pragma unroll
    for (int p = 0; p < V; ++p)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        y[p][j] = op_at<Op, T, V>(u, p, j);
        am = fmaxf(am, fabsf(y[p][j]));
        if constexpr (kRegs) cm[p][j] = fmaxf(cm[p][j], fabsf(y[p][j]));
        if constexpr (kShared) {
          float* g = gmax + j * nv + walk.vec(p);
          *g = fmaxf(*g, fabsf(y[p][j]));
        }
      }
    unsigned int m = __reduce_max_sync(0xFFFFFFFFu, __float_as_uint(am));  // non-negative: bits order as floats
    if (warps > 1) {
      if (lane == 0) red[parity][warp] = m;
      group_sync(walk.grp, tpr);
      for (int w = walk.grp * warps; w < (walk.grp + 1) * warps; ++w) m = ::max(m, red[parity][w]);
      parity ^= 1;
    }
    const float s = __fmul_rn(__uint_as_float(m), kInv127);
    const float inv = inv_scale(s, eps);
#pragma unroll
    for (int p = 0; p < V; ++p) {
      const int64_t off = row * K + walk.vec(p) * N;
      cast_pack<SR, N>(y[p], inv, off, key, q + off);
    }
    if (walk.t == 0) s_row[row] = s;
  });
  if (!COLMAX) return;
  float* part = parts + blockIdx.x * K;
  if constexpr (kShared) {
    __syncthreads();
    const float* all = reinterpret_cast<const float*>(cmax);
    for (int64_t c = threadIdx.x; c < K; c += blockDim.x) {
      float r = 0.0f;
      for (int g = 0; g < groups; ++g) r = fmaxf(r, all[g * K + (c % N) * nv + c / N]);
      part[c] = r;
    }
    return;
  }
#pragma unroll
  for (int p = 0; p < V; ++p)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int64_t c = walk.vec(p) * N + j;
      if (merge)
        atomicMax(cmax + c, __float_as_uint(cm[p][j]));
      else
        part[c] = cm[p][j];
    }
  if (merge) {
    __syncthreads();
    for (int64_t c = threadIdx.x; c < K; c += blockDim.x) part[c] = __uint_as_float(cmax[c]);
  }
}

// B9's columns and B18's GELU columns given the column scales, on the row
// walk (the routes ops/fused_producers.py::silu_cols_sm90_route and
// ::gelu_cols_sm90_route pick): the geometry of elementwise_rows and its
// CTAs an SM, a thread's inverse column scales computed once into
// registers, y = Op::y of the loaded vectors cast at once, no row state. q
// is col_quant<SiluProducer>'s (col_quant<GeluProducer>'s) bit for bit.
template <class Op, typename T, bool SR, int V>
__global__ void __launch_bounds__(V == 1 ? kSiluRowsMaxCta : kSiluRowsMaxCta2, silu_rows_ctas<SR, V>())
elementwise_cols(const T* __restrict__ a, const T* __restrict__ b, const float* __restrict__ scale,
                 int8_t* __restrict__ q, int64_t M, int64_t K, int tpr, float eps, uint64_t key) {
  constexpr int N = 16 / sizeof(T), NIN = Op::kIn;
  using Walk = RowWalk<V, NIN>;
  const Walk walk(tpr);
  const int64_t nv = K / N;  // tpr V
  float inv[V][N];
#pragma unroll
  for (int p = 0; p < V; ++p)
#pragma unroll
    for (int j = 0; j < N; ++j) inv[p][j] = inv_scale(scale[walk.vec(p) * N + j], eps);
  const uint4* const ab[2] = {reinterpret_cast<const uint4*>(a), reinterpret_cast<const uint4*>(b)};
  const uint4* in[NIN];
#pragma unroll
  for (int k = 0; k < NIN; ++k) in[k] = ab[k];
  walk.run(in, M, nv, [&](int64_t row, const uint4 (&u)[NIN][V]) {
#pragma unroll
    for (int p = 0; p < V; ++p) {
      float y[N];
#pragma unroll
      for (int j = 0; j < N; ++j) y[j] = op_at<Op, T, V>(u, p, j);
      const int64_t off = row * K + walk.vec(p) * N;
      cast_pack<SR, N>(y, inv[p], off, key, q + off);
    }
  });
}

// B12 given the column scales on the persistent row walk (the route
// ops/fused_producers.py::silu_bwd_cols_sm90_route picks): B11's walk
// (RowWalk<V, 3> over a, b, dy) at one vector a thread where a row's
// vectors fit a CTA (at K = 5632 bf16 one row of 704 vectors a CTA of 704
// threads), else two, one CTA an SM; (da, db) of the loaded vectors cast at
// once with each thread's inverse column scales, 2 V N floats in
// registers: no row state, no barrier a row, no scratch. The Philox words
// and the casts are silu_bwd_col_quant's, so qa and qb are its bits.
// ab_sm90_forms.py times the other layouts: B11's two vectors a thread
// (b12_v2), and the inverse scales in shared memory [2K] at two CTAs an SM
// or one (b12_smem, b12_smem_one_cta), each slower at [8192, 5632] on an
// H100 (PERF.md).
template <typename T, bool SR, int V>
__global__ void __launch_bounds__(V == 1 ? kSiluRowsMaxCta : kSiluRowsMaxCta2)
silu_bwd_cols(const T* __restrict__ a, const T* __restrict__ b, const T* __restrict__ dy,
              const float* __restrict__ scale_a, const float* __restrict__ scale_b, int8_t* __restrict__ qa,
              int8_t* __restrict__ qb, int64_t M, int64_t K, int tpr, float eps, uint64_t key) {
  constexpr int N = 16 / sizeof(T);
  using Walk = RowWalk<V, 3>;
  const Walk walk(tpr);
  const int64_t nv = K / N;  // tpr V
  float inv_a[V][N], inv_b[V][N];
#pragma unroll
  for (int p = 0; p < V; ++p)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      inv_a[p][j] = inv_scale(scale_a[walk.vec(p) * N + j], eps);
      inv_b[p][j] = inv_scale(scale_b[walk.vec(p) * N + j], eps);
    }
  const uint4* const in[3] = {reinterpret_cast<const uint4*>(a), reinterpret_cast<const uint4*>(b),
                              reinterpret_cast<const uint4*>(dy)};
  walk.run(in, M, nv, [&](int64_t row, const uint4 (&u)[3][V]) {
#pragma unroll
    for (int p = 0; p < V; ++p) {
      const T* ea = reinterpret_cast<const T*>(&u[0][p]);
      const T* eb = reinterpret_cast<const T*>(&u[1][p]);
      const T* ed = reinterpret_cast<const T*>(&u[2][p]);
      float da[N], db[N];
#pragma unroll
      for (int j = 0; j < N; ++j) silu_mul_bwd(to_f32(ea[j]), to_f32(eb[j]), to_f32(ed[j]), da[j], db[j]);
      const int64_t off = row * K + walk.vec(p) * N;
      cast_pack<SR, N>(da, inv_a[p], off, key, qa + off);
      cast_pack<SR, N>(db, inv_b[p], M * K + off, key, qb + off);
    }
  });
}

// B12: rows [rpb * blockIdx.x, +rpb) of (da, db), each cast with its
// column's scale (scale_a, scale_b [K]); SR words as B11's. Dynamic shared
// memory: the inverse scales of da's and db's columns [2K], fp32.
template <typename T, bool SR>
__global__ void __launch_bounds__(kThreads)
silu_bwd_col_quant(const T* __restrict__ a, const T* __restrict__ b, const T* __restrict__ dy,
                   const float* __restrict__ scale_a, const float* __restrict__ scale_b, int8_t* __restrict__ qa,
                   int8_t* __restrict__ qb, int64_t M, int64_t K, int64_t rpb, float eps, uint64_t key) {
  constexpr int N = 16 / sizeof(T);
  using Pack = typename PackOf<N>::type;
  extern __shared__ float smem[];
  const int64_t nv = K / N;
  float* inv_a = smem;
  float* inv_b = smem + K;
  for (int64_t i = threadIdx.x; i < nv; i += kThreads)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      inv_a[j * nv + i] = inv_scale(scale_a[i * N + j], eps);
      inv_b[j * nv + i] = inv_scale(scale_b[i * N + j], eps);
    }
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rpb;
  const int64_t r1 = r0 + rpb < M ? r0 + rpb : M;
  for (int64_t row = r0; row < r1; ++row) {
    for (int64_t i = threadIdx.x; i < nv; i += kThreads) {
      const int64_t off = row * K + i * N;
      float va[N], vb[N], vd[N];
      load_vec<T, N>(a + off, va);
      load_vec<T, N>(b + off, vb);
      load_vec<T, N>(dy + off, vd);
      uint32_t wa[N], wb[N];
      vec_words<SR, N>(off, key, wa);
      vec_words<SR, N>(M * K + off, key, wb);
      Int8Pack<N> oa, ob;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float da, db;
        silu_mul_bwd(va[j], vb[j], vd[j], da, db);
        oa.c[j] = quant<SR>(da, inv_a[j * nv + i], wa[j]);
        ob.c[j] = quant<SR>(db, inv_b[j * nv + i], wb[j]);
      }
      *reinterpret_cast<Pack*>(qa + off) = oa.pack;
      *reinterpret_cast<Pack*>(qb + off) = ob.pack;
    }
  }
}

// ---- launchers --------------------------------------------------------------

template <class P, bool SR, bool COLMAX>
cudaError_t launch_row(const P& p, void* q, void* s_row, void* amax, void* parts, int64_t M, int64_t rpb,
                       float eps, uint64_t key, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(p.K) * sizeof(float) * (COLMAX ? 2 : 1);
  float* pt = static_cast<float*>(parts);
  cudaError_t err;
  if ((err = allow_smem(row_quant<P, SR, COLMAX>, smem)) != cudaSuccess) return err;
  row_quant<P, SR, COLMAX><<<n_blocks(M, rpb), kThreads, smem, stream>>>(
      p, static_cast<int8_t*>(q), static_cast<float*>(s_row), pt, M, rpb, eps, key);
  if ((err = cudaGetLastError()) != cudaSuccess || !COLMAX) return err;
  return launch_reduce(true, pt, static_cast<float*>(amax), n_blocks(M, rpb), p.K, stream);
}

// launch(std::integral_constant<int, TPR>{}) for the RMSNorm walks' tpr
// threads a row: 32, 64, 128 or 256 (groups that divide the block, so that
// the row sums keep the first design's order) with K / N == tpr v, on
// ctas >= 1 CTAs; cudaErrorInvalidValue for any other layout.
template <typename T, class Launch>
cudaError_t with_norm_tpr(int tpr, int v, int64_t K, int64_t ctas, Launch&& launch) {
  if (K / (16 / static_cast<int64_t>(sizeof(T))) != static_cast<int64_t>(tpr) * v || ctas < 1)
    return cudaErrorInvalidValue;
  switch (tpr) {
    case 32: return launch(std::integral_constant<int, 32>{});
    case 64: return launch(std::integral_constant<int, 64>{});
    case 128: return launch(std::integral_constant<int, 128>{});
    case 256: return launch(std::integral_constant<int, 256>{});
    default: return cudaErrorInvalidValue;
  }
}

// B7 on the row walk: tpr threads a row (kNormV vectors each), ctas CTAs,
// parts [ctas, K].
template <typename T, bool SR, bool COLMAX>
cudaError_t launch_norm_rows(int tpr, const void* x, const float* g, void* q, void* s_row, void* amax, void* parts,
                             int64_t M, int64_t K, int64_t ctas, float norm_eps, float eps, uint64_t key,
                             cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(K) * sizeof(float) * (COLMAX ? 2 : 1);
  float* pt = static_cast<float*>(parts);
  return with_norm_tpr<T>(tpr, kNormV, K, ctas, [&](auto t) {
    const auto kernel = rmsnorm_rows<T, SR, COLMAX, decltype(t)::value>;
    cudaError_t err;
    if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
    kernel<<<static_cast<unsigned int>(ctas), kThreads, smem, stream>>>(
        static_cast<const T*>(x), g, static_cast<int8_t*>(q), static_cast<float*>(s_row), pt, M, K, norm_eps, eps,
        key);
    if ((err = cudaGetLastError()) != cudaSuccess || !COLMAX) return err;
    return launch_reduce(true, pt, static_cast<float*>(amax), ctas, K, stream);
  });
}

// scale: the column scales [K], or nullptr for the two-pass form, which
// computes the column absmax into amax [K] (by way of parts) and the scales
// into s_out [K].
template <class P, bool SR>
cudaError_t launch_col(const P& p, const float* scale, void* q, void* s_out, void* amax, void* parts, int64_t M,
                       int64_t rpb, float eps, uint64_t key, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(p.K) * sizeof(float) * 2;
  int8_t* qt = static_cast<int8_t*>(q);
  cudaError_t err;
  if (scale != nullptr) {
    if ((err = allow_smem(col_quant<P, SR, false>, smem)) != cudaSuccess) return err;
    col_quant<P, SR, false><<<n_blocks(M, rpb), kThreads, smem, stream>>>(p, scale, nullptr, qt, M, rpb, eps, key);
    return cudaGetLastError();
  }
  float* am = static_cast<float*>(amax);
  float* pt = static_cast<float*>(parts);
  if ((err = allow_smem(producer_col_absmax<P>, smem)) != cudaSuccess) return err;
  producer_col_absmax<P><<<n_blocks(M, rpb), kThreads, smem, stream>>>(p, pt, M, rpb);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = launch_reduce(true, pt, am, n_blocks(M, rpb), p.K, stream)) != cudaSuccess) return err;
  if ((err = allow_smem(col_quant<P, SR, true>, smem)) != cudaSuccess) return err;
  col_quant<P, SR, true><<<n_blocks(M, rpb), kThreads, smem, stream>>>(p, am, static_cast<float*>(s_out), qt, M,
                                                                       rpb, eps, key);
  return cudaGetLastError();
}

// B8 given scales on the row walk: tpr threads a row (kNormV vectors each),
// ctas CTAs.
template <typename T, bool SR>
cudaError_t launch_norm_cols(int tpr, const void* x, const float* g, const float* scale, void* q, int64_t M,
                             int64_t K, int64_t ctas, float norm_eps, float eps, uint64_t key, cudaStream_t stream) {
  if (scale == nullptr) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(K) * sizeof(float);
  return with_norm_tpr<T>(tpr, kNormV, K, ctas, [&](auto t) {
    const auto kernel = rmsnorm_cols<T, SR, decltype(t)::value>;
    cudaError_t err;
    if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
    kernel<<<static_cast<unsigned int>(ctas), kThreads, smem, stream>>>(
        static_cast<const T*>(x), g, scale, static_cast<int8_t*>(q), M, K, norm_eps, eps, key);
    return cudaGetLastError();
  });
}

// launch(std::integral_constant<int, V>{}, std::integral_constant<int,
// TPR>{}) for B18's LayerNorm walks: V = K / N / tpr one of kLayerNormVs,
// tpr as with_norm_tpr takes it; cudaErrorInvalidValue for any other
// layout.
template <typename T, class Launch>
cudaError_t with_layernorm_layout(int tpr, int64_t K, int64_t ctas, Launch&& launch) {
  const int64_t nv = K / (16 / static_cast<int64_t>(sizeof(T)));
  constexpr int V0 = kLayerNormVs[0], V1 = kLayerNormVs[1];
  if (tpr > 0 && nv == static_cast<int64_t>(tpr) * V0)
    return with_norm_tpr<T>(tpr, V0, K, ctas, [&](auto t) { return launch(std::integral_constant<int, V0>{}, t); });
  if (tpr > 0 && nv == static_cast<int64_t>(tpr) * V1)
    return with_norm_tpr<T>(tpr, V1, K, ctas, [&](auto t) { return launch(std::integral_constant<int, V1>{}, t); });
  return cudaErrorInvalidValue;
}

// B18's LayerNorm rows on the row walk: tpr threads a row, ctas CTAs, parts
// [ctas, K].
template <typename T, bool SR, bool COLMAX>
cudaError_t launch_layernorm_rows(int tpr, const void* x, const float* g, const float* b, void* q, void* s_row,
                                  void* amax, void* parts, int64_t M, int64_t K, int64_t ctas, float norm_eps,
                                  float eps, uint64_t key, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(K) * sizeof(float) * (COLMAX ? 3 : 2);
  float* pt = static_cast<float*>(parts);
  return with_layernorm_layout<T>(tpr, K, ctas, [&](auto v, auto t) {
    const auto kernel = layernorm_rows<T, SR, COLMAX, decltype(v)::value, decltype(t)::value>;
    cudaError_t err;
    if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
    kernel<<<static_cast<unsigned int>(ctas), kThreads, smem, stream>>>(
        static_cast<const T*>(x), g, b, static_cast<int8_t*>(q), static_cast<float*>(s_row), pt, M, K, norm_eps, eps,
        key);
    if ((err = cudaGetLastError()) != cudaSuccess || !COLMAX) return err;
    return launch_reduce(true, pt, static_cast<float*>(amax), ctas, K, stream);
  });
}

// B18's LayerNorm columns given scales on the row walk: tpr threads a row,
// ctas CTAs, no scratch.
template <typename T, bool SR>
cudaError_t launch_layernorm_cols(int tpr, const void* x, const float* g, const float* b, const float* scale,
                                  void* q, int64_t M, int64_t K, int64_t ctas, float norm_eps, float eps,
                                  uint64_t key, cudaStream_t stream) {
  if (scale == nullptr) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(K) * sizeof(float) * 2;
  return with_layernorm_layout<T>(tpr, K, ctas, [&](auto v, auto t) {
    const auto kernel = layernorm_cols<T, SR, decltype(v)::value, decltype(t)::value>;
    cudaError_t err;
    if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
    kernel<<<static_cast<unsigned int>(ctas), kThreads, smem, stream>>>(
        static_cast<const T*>(x), g, b, scale, static_cast<int8_t*>(q), M, K, norm_eps, eps, key);
    return cudaGetLastError();
  });
}

// B10 on the row walk: tpr threads a row (kNormBwdV vectors of x and of dy
// each), ctas CTAs, dg_part [ctas, K].
template <typename T>
cudaError_t launch_bwd_walk(int tpr, const void* x, const float* g, const void* dy, void* dx, void* dg,
                            void* dg_part, int64_t M, int64_t K, int64_t ctas, float norm_eps, cudaStream_t stream) {
  float* pt = static_cast<float*>(dg_part);
  return with_norm_tpr<T>(tpr, kNormBwdV, K, ctas, [&](auto t) {
    constexpr int TPR = decltype(t)::value;
    const auto kernel = rmsnorm_bwd_walk<T, TPR>;
    const size_t smem = static_cast<size_t>(K) * sizeof(float) * (1 + kThreads / TPR);
    cudaError_t err;
    if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
    kernel<<<static_cast<unsigned int>(ctas), kThreads, smem, stream>>>(
        static_cast<const T*>(x), g, static_cast<const T*>(dy), static_cast<T*>(dx), pt, M, K, norm_eps);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    return launch_reduce(false, pt, static_cast<float*>(dg), ctas, K, stream);
  });
}

template <typename T>
cudaError_t launch_bwd(const void* x, const float* g, const void* dy, void* dx, void* dg, void* dg_part, int64_t M,
                       int64_t K, int64_t rpb, float norm_eps, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(K) * sizeof(float);
  cudaError_t err;
  if ((err = allow_smem(rmsnorm_bwd_rows<T>, smem)) != cudaSuccess) return err;
  const unsigned int blocks = n_blocks(M, rpb);
  rmsnorm_bwd_rows<T><<<blocks, kThreads, smem, stream>>>(static_cast<const T*>(x), g, static_cast<const T*>(dy),
                                                          static_cast<T*>(dx), static_cast<float*>(dg_part), M, K,
                                                          rpb, norm_eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_reduce(false, static_cast<const float*>(dg_part), static_cast<float*>(dg), blocks, K, stream);
}

template <typename T, bool SR, bool AMAX, bool COPY>
cudaError_t launch_silu_bwd_row(const void* a, const void* b, const void* dy, void* qa, void* sa, void* qb, void* sb,
                                void* amax, void* parts, void* ca, void* cb, int64_t M, int64_t K, int64_t rpb,
                                float eps, uint64_t key, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(K) * sizeof(float) * (AMAX ? 4 : 2);
  auto kernel = silu_bwd_row_quant<T, SR, AMAX, COPY>;
  cudaError_t err;
  if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
  float* pt = static_cast<float*>(parts);
  kernel<<<n_blocks(M, rpb), kThreads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const T*>(dy), static_cast<int8_t*>(qa),
      static_cast<float*>(sa), static_cast<int8_t*>(qb), static_cast<float*>(sb), pt, static_cast<T*>(ca),
      static_cast<T*>(cb), M, K, rpb, eps, key);
  if ((err = cudaGetLastError()) != cudaSuccess || !AMAX) return err;
  return launch_reduce(true, pt, static_cast<float*>(amax), n_blocks(M, rpb), 2 * K, stream);
}

// B11 on the row walk: tpr threads a row, V = K / N / tpr vectors a thread
// (1 or 2), ctas CTAs of max(tpr, kThreads) threads, parts [ctas, 2K].
template <typename T, bool SR, bool AMAX, bool COPY>
cudaError_t launch_silu_bwd_rows(const void* a, const void* b, const void* dy, void* qa, void* sa, void* qb, void* sb,
                                 void* amax, void* parts, void* ca, void* cb, int64_t M, int64_t K, int tpr,
                                 int64_t ctas, float eps, uint64_t key, cudaStream_t stream) {
  const int64_t nv = K / (16 / static_cast<int64_t>(sizeof(T)));
  const int cta = tpr > kThreads ? tpr : kThreads;
  const int64_t V = tpr > 0 && nv % tpr == 0 ? nv / tpr : 0;
  if (tpr % 32 != 0 || cta % tpr != 0 || ctas < 1 ||
      !((V == 1 && cta <= kSiluRowsMaxCta) || (V == 2 && cta <= kSiluRowsMaxCta2)))
    return cudaErrorInvalidValue;
  const size_t smem = AMAX && cta > tpr ? static_cast<size_t>(2 * K) * sizeof(unsigned int) : 0;
  const auto kernel = V == 1 ? silu_bwd_rows<T, SR, AMAX, COPY, 1> : silu_bwd_rows<T, SR, AMAX, COPY, 2>;
  float* pt = static_cast<float*>(parts);
  cudaError_t err;
  if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
  kernel<<<static_cast<unsigned int>(ctas), cta, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const T*>(dy), static_cast<int8_t*>(qa),
      static_cast<float*>(sa), static_cast<int8_t*>(qb), static_cast<float*>(sb), pt, static_cast<T*>(ca),
      static_cast<T*>(cb), M, K, tpr, eps, key);
  if ((err = cudaGetLastError()) != cudaSuccess || !AMAX) return err;
  return launch_reduce(true, pt, static_cast<float*>(amax), ctas, 2 * K, stream);
}

// The elementwise walks' layout: tpr threads a row, V = K / N / tpr vectors
// a thread (1 or 2), a CTA of max(tpr, kThreads) threads made of whole
// groups, within the largest CTA of that V; 0 where the layout is none.
template <typename T>
int elementwise_v(int tpr, int64_t K, int64_t ctas) {
  const int64_t nv = K / (16 / static_cast<int64_t>(sizeof(T)));
  const int cta = tpr > kThreads ? tpr : kThreads;
  const int64_t V = tpr > 0 && nv % tpr == 0 ? nv / tpr : 0;
  if (tpr % 32 != 0 || cta % tpr != 0 || ctas < 1 ||
      !((V == 1 && cta <= kSiluRowsMaxCta) || (V == 2 && cta <= kSiluRowsMaxCta2)))
    return 0;
  return static_cast<int>(V);
}

// B9's row form and B18's GELU rows on the walk (elementwise_rows over Op,
// its inputs a and, for two, b): tpr threads a row, ctas CTAs, parts
// [ctas, K].
template <class Op, typename T, bool SR, bool COLMAX>
cudaError_t launch_elementwise_rows(const void* a, const void* b, void* q, void* s_row, void* amax, void* parts,
                                    int64_t M, int64_t K, int tpr, int64_t ctas, float eps, uint64_t key,
                                    cudaStream_t stream) {
  const int V = elementwise_v<T>(tpr, K, ctas);
  if (V == 0) return cudaErrorInvalidValue;
  const int cta = tpr > kThreads ? tpr : kThreads;
  const size_t smem = !COLMAX    ? 0
                      : !SR       ? static_cast<size_t>(cta / tpr * K) * sizeof(float)
                      : cta > tpr ? static_cast<size_t>(K) * sizeof(unsigned int)
                                  : 0;
  const auto kernel = V == 1 ? elementwise_rows<Op, T, SR, COLMAX, 1> : elementwise_rows<Op, T, SR, COLMAX, 2>;
  float* pt = static_cast<float*>(parts);
  cudaError_t err;
  if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
  kernel<<<static_cast<unsigned int>(ctas), cta, smem, stream>>>(static_cast<const T*>(a), static_cast<const T*>(b),
                                                                 static_cast<int8_t*>(q), static_cast<float*>(s_row),
                                                                 pt, M, K, tpr, eps, key);
  err = cudaGetLastError();
  return err != cudaSuccess || !COLMAX ? err : launch_reduce(true, pt, static_cast<float*>(amax), ctas, K, stream);
}

// B9's and B18's GELU columns given scales on the walk (elementwise_cols
// over Op, its inputs a and, for two, b): tpr threads a row, ctas CTAs, no
// scratch.
template <class Op, typename T, bool SR>
cudaError_t launch_elementwise_cols(const void* a, const void* b, const float* scale, void* q, int64_t M, int64_t K,
                                    int tpr, int64_t ctas, float eps, uint64_t key, cudaStream_t stream) {
  const int V = elementwise_v<T>(tpr, K, ctas);
  if (V == 0 || scale == nullptr) return cudaErrorInvalidValue;
  const auto kernel = V == 1 ? elementwise_cols<Op, T, SR, 1> : elementwise_cols<Op, T, SR, 2>;
  kernel<<<static_cast<unsigned int>(ctas), tpr > kThreads ? tpr : kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), scale, static_cast<int8_t*>(q), M, K, tpr, eps, key);
  return cudaGetLastError();
}

// B12 given scales on the walk (silu_bwd_cols): tpr threads a row, ctas
// CTAs, no scratch.
template <typename T, bool SR>
cudaError_t launch_silu_bwd_cols(const void* a, const void* b, const void* dy, const void* scale_a,
                                 const void* scale_b, void* qa, void* qb, int64_t M, int64_t K, int tpr, int64_t ctas,
                                 float eps, uint64_t key, cudaStream_t stream) {
  const int V = elementwise_v<T>(tpr, K, ctas);
  if (V == 0) return cudaErrorInvalidValue;
  const auto kernel = V == 1 ? silu_bwd_cols<T, SR, 1> : silu_bwd_cols<T, SR, 2>;
  kernel<<<static_cast<unsigned int>(ctas), tpr > kThreads ? tpr : kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const T*>(dy),
      static_cast<const float*>(scale_a), static_cast<const float*>(scale_b), static_cast<int8_t*>(qa),
      static_cast<int8_t*>(qb), M, K, tpr, eps, key);
  return cudaGetLastError();
}

template <typename T, bool SR>
cudaError_t launch_silu_bwd_col(const void* a, const void* b, const void* dy, const void* scale_a,
                                const void* scale_b, void* qa, void* qb, int64_t M, int64_t K, int64_t rpb, float eps,
                                uint64_t key, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(K) * sizeof(float) * 2;
  auto kernel = silu_bwd_col_quant<T, SR>;
  cudaError_t err;
  if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
  kernel<<<n_blocks(M, rpb), kThreads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const T*>(dy),
      static_cast<const float*>(scale_a), static_cast<const float*>(scale_b), static_cast<int8_t*>(qa),
      static_cast<int8_t*>(qb), M, K, rpb, eps, key);
  return cudaGetLastError();
}

template <typename T>
NormProducer<T> norm_producer(const void* x, const void* g, int64_t K, float norm_eps) {
  return NormProducer<T>{static_cast<const T*>(x), static_cast<const float*>(g), K, norm_eps};
}

template <typename T>
SiluProducer<T> silu_producer(const void* a, const void* b, int64_t K) {
  return SiluProducer<T>{static_cast<const T*>(a), static_cast<const T*>(b), K};
}

template <typename T>
LayerNormProducer<T> layernorm_producer(const void* x, const void* g, const void* b, int64_t K, float norm_eps) {
  return LayerNormProducer<T>{static_cast<const T*>(x), static_cast<const float*>(g), static_cast<const float*>(b),
                              K, norm_eps};
}

template <typename T>
GeluProducer<T> gelu_producer(const void* a, int64_t K) {
  return GeluProducer<T>{static_cast<const T*>(a), K};
}

}  // namespace

// Every entry point returns the launch's cudaError_t (0 on success). The
// wrapper (ops/fused_producers.py) guarantees: inputs contiguous, 16-byte
// aligned, K % 128 == 0, K * 8 bytes (B11: K * 16) within a block's shared
// memory; g is
// fp32 [K]; is_bf16 selects bf16 (else fp32) inputs; q is int8 [M, K]; scales
// and maxima are fp32; rpb is the number of rows per block; sr rounds
// stochastically from the Philox stream of ``key``.

// B7: q, s_row [M]; with with_amax the column absmax into amax [K], by way
// of parts, fp32 scratch of ceil(M / rpb) * K floats (else both unused).
// tpr (ops/fused_producers.py::norm_rows_sm90_route): 0 takes row_quant with
// rpb rows a block; else rmsnorm_rows with tpr threads a row on ctas CTAs,
// parts then ctas * K floats.
extern "C" int qt_rmsnorm_quant_rowwise(const void* x, const void* g, void* q, void* s_row, void* amax, void* parts,
                                        int64_t M, int64_t K, int64_t rpb, float norm_eps, float eps, int is_bf16,
                                        int sr, int with_amax, uint64_t key, int tpr, int64_t ctas, void* stream) {
  if (M <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  if (tpr != 0) {
#define QT_ROWS(T, SR, AM) launch_norm_rows<T, SR, AM>(tpr, x, gf, q, s_row, amax, parts, M, K, ctas, norm_eps, eps, \
                                                        key, s)
    if (is_bf16)
      return sr ? (with_amax ? QT_ROWS(__nv_bfloat16, true, true) : QT_ROWS(__nv_bfloat16, true, false))
                : (with_amax ? QT_ROWS(__nv_bfloat16, false, true) : QT_ROWS(__nv_bfloat16, false, false));
    return sr ? (with_amax ? QT_ROWS(float, true, true) : QT_ROWS(float, true, false))
              : (with_amax ? QT_ROWS(float, false, true) : QT_ROWS(float, false, false));
#undef QT_ROWS
  }
#define QT_ROW(T, SR, AM) launch_row<NormProducer<T>, SR, AM>(norm_producer<T>(x, g, K, norm_eps), q, s_row, amax, \
                                                              parts, M, rpb, eps, key, s)
  if (is_bf16)
    return sr ? (with_amax ? QT_ROW(__nv_bfloat16, true, true) : QT_ROW(__nv_bfloat16, true, false))
              : (with_amax ? QT_ROW(__nv_bfloat16, false, true) : QT_ROW(__nv_bfloat16, false, false));
  return sr ? (with_amax ? QT_ROW(float, true, true) : QT_ROW(float, true, false))
            : (with_amax ? QT_ROW(float, false, true) : QT_ROW(float, false, false));
#undef QT_ROW
}

// B9, row form: as B7 with the inputs a, b [M, K]. tpr
// (ops/fused_producers.py::silu_rows_sm90_route): 0 takes
// row_quant<SiluProducer> with rpb rows a block; else elementwise_rows<SiluMulOp> with tpr
// threads a row on ctas CTAs, parts then ctas * K floats.
extern "C" int qt_silu_mul_quant_rowwise(const void* a, const void* b, void* q, void* s_row, void* amax, void* parts,
                                         int64_t M, int64_t K, int64_t rpb, float eps, int is_bf16, int sr,
                                         int with_amax, uint64_t key, int tpr, int64_t ctas, void* stream) {
  if (M <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define QT_ROW(T, SR, AM)                                                                                        \
  (tpr != 0 ? launch_elementwise_rows<SiluMulOp, T, SR, AM>(a, b, q, s_row, amax, parts, M, K, tpr, ctas, eps, \
                                                        key, s)                                                \
            : launch_row<SiluProducer<T>, SR, AM>(silu_producer<T>(a, b, K), q, s_row, amax, parts, M, rpb, eps, \
                                                  key, s))
  if (is_bf16)
    return sr ? (with_amax ? QT_ROW(__nv_bfloat16, true, true) : QT_ROW(__nv_bfloat16, true, false))
              : (with_amax ? QT_ROW(__nv_bfloat16, false, true) : QT_ROW(__nv_bfloat16, false, false));
  return sr ? (with_amax ? QT_ROW(float, true, true) : QT_ROW(float, true, false))
            : (with_amax ? QT_ROW(float, false, true) : QT_ROW(float, false, false));
#undef QT_ROW
}

// B8: scale [K] given, or nullptr for the two-pass form, which writes the
// column absmax into the scratch amax [K] (by way of parts, as B7) and the
// scales into s_out [K]. tpr (ops/fused_producers.py::norm_cols_sm90_route,
// given scales only): 0 takes col_quant with rpb rows a block; else
// rmsnorm_cols with tpr threads a row on ctas CTAs (no scratch).
extern "C" int qt_rmsnorm_quant_colwise(const void* x, const void* g, const void* scale, void* q, void* s_out,
                                        void* amax, void* parts, int64_t M, int64_t K, int64_t rpb, float norm_eps,
                                        float eps, int is_bf16, int sr, uint64_t key, int tpr, int64_t ctas,
                                        void* stream) {
  if (M <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  if (tpr != 0) {
    const float* gf = static_cast<const float*>(g);
#define QT_COLS(T, SR) launch_norm_cols<T, SR>(tpr, x, gf, sc, q, M, K, ctas, norm_eps, eps, key, s)
    if (is_bf16) return sr ? QT_COLS(__nv_bfloat16, true) : QT_COLS(__nv_bfloat16, false);
    return sr ? QT_COLS(float, true) : QT_COLS(float, false);
#undef QT_COLS
  }
#define QT_COL(T, SR) launch_col<NormProducer<T>, SR>(norm_producer<T>(x, g, K, norm_eps), sc, q, s_out, amax, \
                                                      parts, M, rpb, eps, key, s)
  if (is_bf16) return sr ? QT_COL(__nv_bfloat16, true) : QT_COL(__nv_bfloat16, false);
  return sr ? QT_COL(float, true) : QT_COL(float, false);
#undef QT_COL
}

// B9, column form: as B8 with the inputs a, b [M, K]. tpr
// (ops/fused_producers.py::silu_cols_sm90_route, given scales only): 0
// takes col_quant with rpb rows a block; else elementwise_cols<SiluMulOp>
// with tpr threads a row on ctas CTAs (no scratch).
extern "C" int qt_silu_mul_quant_colwise(const void* a, const void* b, const void* scale, void* q, void* s_out,
                                         void* amax, void* parts, int64_t M, int64_t K, int64_t rpb, float eps,
                                         int is_bf16, int sr, uint64_t key, int tpr, int64_t ctas, void* stream) {
  if (M <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
#define QT_COL(T, SR)                                                                                                 \
  (tpr != 0 ? launch_elementwise_cols<SiluMulOp, T, SR>(a, b, sc, q, M, K, tpr, ctas, eps, key, s)                    \
            : launch_col<SiluProducer<T>, SR>(silu_producer<T>(a, b, K), sc, q, s_out, amax, parts, M, rpb, eps, key, \
                                              s))
  if (is_bf16) return sr ? QT_COL(__nv_bfloat16, true) : QT_COL(__nv_bfloat16, false);
  return sr ? QT_COL(float, true) : QT_COL(float, false);
#undef QT_COL
}

// B10: dx [M, K] in x's dtype, dg fp32 [K]. tpr
// (ops/fused_producers.py::rmsnorm_bwd_sm90_route): 0 takes
// rmsnorm_bwd_rows with rpb rows a block, dg_part fp32 scratch of
// ceil(M / rpb) * K floats; else rmsnorm_bwd_walk with tpr threads a row on
// ctas CTAs, dg_part then ctas * K floats.
extern "C" int qt_rmsnorm_bwd(const void* x, const void* g, const void* dy, void* dx, void* dg, void* dg_part,
                              int64_t M, int64_t K, int64_t rpb, float norm_eps, int is_bf16, int tpr, int64_t ctas,
                              void* stream) {
  if (M <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  if (tpr != 0)
    return static_cast<int>(is_bf16 ? launch_bwd_walk<__nv_bfloat16>(tpr, x, gf, dy, dx, dg, dg_part, M, K, ctas,
                                                                     norm_eps, s)
                                    : launch_bwd_walk<float>(tpr, x, gf, dy, dx, dg, dg_part, M, K, ctas, norm_eps, s));
  return static_cast<int>(is_bf16 ? launch_bwd<__nv_bfloat16>(x, gf, dy, dx, dg, dg_part, M, K, rpb, norm_eps, s)
                                  : launch_bwd<float>(x, gf, dy, dx, dg, dg_part, M, K, rpb, norm_eps, s));
}

// B11: qa, qb int8 [M, K], sa, sb fp32 [M]; with with_amax the column absmax
// of da and of db into amax [2K] (da's first), by way of parts, fp32 scratch
// of ceil(M / rpb) * 2K floats; with with_copy da and db in the inputs'
// dtype into ca, cb [M, K] (else those are unused). tpr
// (ops/fused_producers.py::silu_bwd_rows_sm90_route): 0 takes
// silu_bwd_row_quant with rpb rows a block; else silu_bwd_rows with tpr
// threads a row on ctas CTAs, parts then ctas * 2K floats.
extern "C" int qt_silu_mul_bwd_quant_rowwise(const void* a, const void* b, const void* dy, void* qa, void* sa, void* qb,
                                             void* sb, void* amax, void* parts, void* ca, void* cb, int64_t M,
                                             int64_t K, int64_t rpb, float eps, int is_bf16, int sr, int with_amax,
                                             int with_copy, uint64_t key, int tpr, int64_t ctas, void* stream) {
  if (M <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define QT_ROW(T, SR, AM, CP)                                                                                    \
  (tpr != 0 ? launch_silu_bwd_rows<T, SR, AM, CP>(a, b, dy, qa, sa, qb, sb, amax, parts, ca, cb, M, K, tpr, ctas, \
                                                  eps, key, s)                                                  \
            : launch_silu_bwd_row<T, SR, AM, CP>(a, b, dy, qa, sa, qb, sb, amax, parts, ca, cb, M, K, rpb, eps, key, s))
#define QT_FORMS(T, SR) (with_amax ? (with_copy ? QT_ROW(T, SR, true, true) : QT_ROW(T, SR, true, false)) \
                                   : (with_copy ? QT_ROW(T, SR, false, true) : QT_ROW(T, SR, false, false)))
  if (is_bf16) return sr ? QT_FORMS(__nv_bfloat16, true) : QT_FORMS(__nv_bfloat16, false);
  return sr ? QT_FORMS(float, true) : QT_FORMS(float, false);
#undef QT_FORMS
#undef QT_ROW
}

// B12: qa, qb int8 [M, K] given the column scales scale_a, scale_b fp32 [K].
// tpr (ops/fused_producers.py::silu_bwd_cols_sm90_route): 0 takes
// silu_bwd_col_quant with rpb rows a block; else silu_bwd_cols with tpr
// threads a row on ctas CTAs (no scratch).
extern "C" int qt_silu_mul_bwd_quant_colwise(const void* a, const void* b, const void* dy, const void* scale_a,
                                             const void* scale_b, void* qa, void* qb, int64_t M, int64_t K,
                                             int64_t rpb, float eps, int is_bf16, int sr, uint64_t key, int tpr,
                                             int64_t ctas, void* stream) {
  if (M <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define QT_COL(T, SR)                                                                                              \
  (tpr != 0 ? launch_silu_bwd_cols<T, SR>(a, b, dy, scale_a, scale_b, qa, qb, M, K, tpr, ctas, eps, key, s)        \
            : launch_silu_bwd_col<T, SR>(a, b, dy, scale_a, scale_b, qa, qb, M, K, rpb, eps, key, s))
  if (is_bf16) return sr ? QT_COL(__nv_bfloat16, true) : QT_COL(__nv_bfloat16, false);
  return sr ? QT_COL(float, true) : QT_COL(float, false);
#undef QT_COL
}

// B18, LayerNorm along rows: as B7 with beta b [K] (fp32, as g). tpr
// (ops/fused_producers.py::layernorm_rows_sm90_route): 0 takes
// row_quant<LayerNormProducer> with rpb rows a block; else layernorm_rows
// with tpr threads a row on ctas CTAs, parts then ctas * K floats.
extern "C" int qt_layernorm_quant_rowwise(const void* x, const void* g, const void* b, void* q, void* s_row,
                                          void* amax, void* parts, int64_t M, int64_t K, int64_t rpb, float norm_eps,
                                          float eps, int is_bf16, int sr, int with_amax, uint64_t key, int tpr,
                                          int64_t ctas, void* stream) {
  if (M <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  const float* bf = static_cast<const float*>(b);
#define QT_ROW(T, SR, AM)                                                                                         \
  (tpr != 0 ? launch_layernorm_rows<T, SR, AM>(tpr, x, gf, bf, q, s_row, amax, parts, M, K, ctas, norm_eps, eps, \
                                               key, s)                                                           \
            : launch_row<LayerNormProducer<T>, SR, AM>(layernorm_producer<T>(x, g, b, K, norm_eps), q, s_row,    \
                                                       amax, parts, M, rpb, eps, key, s))
  if (is_bf16)
    return sr ? (with_amax ? QT_ROW(__nv_bfloat16, true, true) : QT_ROW(__nv_bfloat16, true, false))
              : (with_amax ? QT_ROW(__nv_bfloat16, false, true) : QT_ROW(__nv_bfloat16, false, false));
  return sr ? (with_amax ? QT_ROW(float, true, true) : QT_ROW(float, true, false))
            : (with_amax ? QT_ROW(float, false, true) : QT_ROW(float, false, false));
#undef QT_ROW
}

// B18, GELU along rows: as B7 with the input a [M, K]. tpr
// (ops/fused_producers.py::gelu_rows_sm90_route): 0 takes
// row_quant<GeluProducer> with rpb rows a block; else
// elementwise_rows<GeluOp> with tpr threads a row on ctas CTAs, parts then
// ctas * K floats.
extern "C" int qt_gelu_quant_rowwise(const void* a, void* q, void* s_row, void* amax, void* parts, int64_t M,
                                     int64_t K, int64_t rpb, float eps, int is_bf16, int sr, int with_amax,
                                     uint64_t key, int tpr, int64_t ctas, void* stream) {
  if (M <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define QT_ROW(T, SR, AM)                                                                                          \
  (tpr != 0 ? launch_elementwise_rows<GeluOp, T, SR, AM>(a, nullptr, q, s_row, amax, parts, M, K, tpr, ctas, eps, \
                                                         key, s)                                                  \
            : launch_row<GeluProducer<T>, SR, AM>(gelu_producer<T>(a, K), q, s_row, amax, parts, M, rpb, eps, key, s))
  if (is_bf16)
    return sr ? (with_amax ? QT_ROW(__nv_bfloat16, true, true) : QT_ROW(__nv_bfloat16, true, false))
              : (with_amax ? QT_ROW(__nv_bfloat16, false, true) : QT_ROW(__nv_bfloat16, false, false));
  return sr ? (with_amax ? QT_ROW(float, true, true) : QT_ROW(float, true, false))
            : (with_amax ? QT_ROW(float, false, true) : QT_ROW(float, false, false));
#undef QT_ROW
}

// B18, LayerNorm along columns: as B8 with beta b [K]. tpr
// (ops/fused_producers.py::layernorm_cols_sm90_route, given scales only): 0
// takes col_quant with rpb rows a block; else layernorm_cols with tpr
// threads a row on ctas CTAs (no scratch).
extern "C" int qt_layernorm_quant_colwise(const void* x, const void* g, const void* b, const void* scale, void* q,
                                          void* s_out, void* amax, void* parts, int64_t M, int64_t K, int64_t rpb,
                                          float norm_eps, float eps, int is_bf16, int sr, uint64_t key, int tpr,
                                          int64_t ctas, void* stream) {
  if (M <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  if (tpr != 0) {
    const float* gf = static_cast<const float*>(g);
    const float* bf = static_cast<const float*>(b);
#define QT_COLS(T, SR) launch_layernorm_cols<T, SR>(tpr, x, gf, bf, sc, q, M, K, ctas, norm_eps, eps, key, s)
    if (is_bf16) return sr ? QT_COLS(__nv_bfloat16, true) : QT_COLS(__nv_bfloat16, false);
    return sr ? QT_COLS(float, true) : QT_COLS(float, false);
#undef QT_COLS
  }
#define QT_COL(T, SR) launch_col<LayerNormProducer<T>, SR>(layernorm_producer<T>(x, g, b, K, norm_eps), sc, q, s_out, \
                                                           amax, parts, M, rpb, eps, key, s)
  if (is_bf16) return sr ? QT_COL(__nv_bfloat16, true) : QT_COL(__nv_bfloat16, false);
  return sr ? QT_COL(float, true) : QT_COL(float, false);
#undef QT_COL
}

// B18, GELU along columns: as B8 with the input a [M, K]. tpr
// (ops/fused_producers.py::gelu_cols_sm90_route, given scales only): 0
// takes col_quant with rpb rows a block; else elementwise_cols<GeluOp> with
// tpr threads a row on ctas CTAs (no scratch).
extern "C" int qt_gelu_quant_colwise(const void* a, const void* scale, void* q, void* s_out, void* amax, void* parts,
                                     int64_t M, int64_t K, int64_t rpb, float eps, int is_bf16, int sr, uint64_t key,
                                     int tpr, int64_t ctas, void* stream) {
  if (M <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
#define QT_COL(T, SR)                                                                                                 \
  (tpr != 0 ? launch_elementwise_cols<GeluOp, T, SR>(a, nullptr, sc, q, M, K, tpr, ctas, eps, key, s)                 \
            : launch_col<GeluProducer<T>, SR>(gelu_producer<T>(a, K), sc, q, s_out, amax, parts, M, rpb, eps, key, s))
  if (is_bf16) return sr ? QT_COL(__nv_bfloat16, true) : QT_COL(__nv_bfloat16, false);
  return sr ? QT_COL(float, true) : QT_COL(float, false);
#undef QT_COL
}
