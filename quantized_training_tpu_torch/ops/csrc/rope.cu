// RoPE with the head grouping of grouped-query attention (B13), and the int8
// quantize of the attention output with its ungrouping (B14).
//
// What they replace (quantized_training_tpu/ops/pallas_rope.py):
// - B13 rope_relayout: rope_group_kernel (:140) and rope_ungroup_kernel
//   (:203): rotate-half RoPE from fp32 tables (any pre-scale folded in), its
//   inverse rot^T, or none (a plain grouping), while the heads move between
//   the projections' [B, S, H, hd] and attention's [B, KV, G, S, hd];
// - B14 ungroup_absmax: ungroup_amax (:334), the row absmax [B * S] and the
//   column absmax [H * hd] of the ungrouped [B * S, H * hd] view of the
//   attention output, in one read;
// - B14 ungroup_quant: ungroup_quant (:365), that view's int8 given row
//   scales (axis 1) or column scales (axis 0), or with SR floor(y * inv + u),
//   u of element (r, c) the uniform at r * K + c of the key's Philox stream.
//
// On the TPU the grouping is a layout change that XLA lowered as slow copies,
// and the Pallas kernels move lanes with selector matmuls on the MXU. Here it
// is index arithmetic: every kernel addresses the grouped side through
// (b, h, s) strides with a unit hd stride, so it reads and writes the layout
// PyTorch's attention takes or returns, whether [B, H, S, hd] or [B, S, H, hd]
// memory (h = kv * G + g), and no copy sits beside attention. The rotation
// runs in fp32, every operation rounded once (y = x * c + rot(x) * s; no
// contraction), then y is rounded to the output's dtype: the plain versions
// (ops/rope.py) compute the same operations, so B13 and B14 are bit-exact
// with them on the card.
//
// What bounds them on the H100: bytes. B13 on q at [4, 2048, 32, 64] bf16
// reads and writes 67 MB (20 us at 3.35 TB/s; the fp32 tables, 1 MB each, are
// read from L2); B14's absmax reads the attention output once (34 MB, 10 us)
// and its quantize reads it and writes int8 (50 MB, 15 us). Design: B13 gives
// each thread one pair of 16-byte vectors of a head row, (d, d + hd / 2), the
// two halves rotate-half mixes. B14's first design (ungroup_absmax,
// ungroup_quant) gave a block of 256 threads a run of about 15 rows, one
// vector a thread a row at bf16 K 2048: each row ended in a block reduction
// (two __syncthreads) with no next row in flight, every vector updated the
// column maxima in shared memory and divided by hd for its column, the
// column form filled the K inverse scales in every block, the casts took
// rintf and a float -> int conversion, and the column maxima of 547 blocks
// went through a [547, K] scratch. B14 now takes the persistent row walk
// (RowWalk, row_common.cuh; the route ops/rope.py::ungroup_sm90_route picks,
// the first design stays for widths it does not tile): groups of whole warps
// take one row at a time, four vectors a thread at bf16 K 2048 (64
// threads), the next row's vectors (and its scale) in flight while this
// row's are reduced or cast; a thread owns the same columns in every row, so
// their strided offsets are computed once and a row adds only b sb + s ss;
// the row max reduces by shuffles and one named barrier a group, the column
// maxima and inverse column scales stay in registers, the casts round by one
// add (cast_pack), and one row of column partials a CTA is folded in a fixed
// order (reduce_parts).

#include <type_traits>

#include "row_common.cuh"

namespace {

// The N fp32 values at p (16-byte aligned).
template <int N>
__device__ __forceinline__ void load_f32(const float* __restrict__ p, float (&v)[N]) {
#pragma unroll
  for (int k = 0; k < N / 4; ++k) {
    const float4 u = reinterpret_cast<const float4*>(p)[k];
    v[4 * k] = u.x;
    v[4 * k + 1] = u.y;
    v[4 * k + 2] = u.z;
    v[4 * k + 3] = u.w;
  }
}

enum RopeMode { kCopy = 0, kRotate = 1, kRotateInverse = 2 };

// B13: out[b, s, h, :] = rope(in[b, s, h, :]) for every (b, s, h). Item t is
// the vector pair p of row (b, s, h), in (b, s, h, p) order: the elements
// [d, d + N) and [d + hd / 2, +N), d = p * N. rot(x) = (-x2, x1) for x = (x1,
// x2) halves, rot^T(x) = (x2, -x1); the tables cos, sin are fp32 [S, ldt].
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
rope_relayout(const T* __restrict__ in, int64_t isb, int64_t iss, int64_t ish, T* __restrict__ out, int64_t osb,
              int64_t oss, int64_t osh, const float* __restrict__ cos, const float* __restrict__ sin, int64_t ldt,
              uint32_t S, uint32_t H, uint32_t hd, uint32_t n_items) {
  constexpr int N = 16 / sizeof(T);
  const uint32_t half = hd / 2, P = half / N;
  for (uint32_t t = blockIdx.x * kThreads + threadIdx.x; t < n_items; t += gridDim.x * kThreads) {
    const uint32_t p = t % P, bsh = t / P;
    const uint32_t h = bsh % H, bs = bsh / H;
    const uint32_t s = bs % S, b = bs / S;
    const uint32_t d = p * N;
    const T* src = in + b * isb + s * iss + h * ish + d;
    T* dst = out + b * osb + s * oss + h * osh + d;
    if (MODE == kCopy) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      *reinterpret_cast<uint4*>(dst + half) = *reinterpret_cast<const uint4*>(src + half);
      continue;
    }
    float lo[N], hi[N], c_lo[N], c_hi[N], s_lo[N], s_hi[N];
    load_vec<T, N>(src, lo);
    load_vec<T, N>(src + half, hi);
    load_f32<N>(cos + s * ldt + d, c_lo);
    load_f32<N>(cos + s * ldt + half + d, c_hi);
    load_f32<N>(sin + s * ldt + d, s_lo);
    load_f32<N>(sin + s * ldt + half + d, s_hi);
    float y_lo[N], y_hi[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float r_lo = MODE == kRotate ? -hi[j] : hi[j];
      const float r_hi = MODE == kRotate ? lo[j] : -lo[j];
      y_lo[j] = __fadd_rn(__fmul_rn(lo[j], c_lo[j]), __fmul_rn(r_lo, s_lo[j]));
      y_hi[j] = __fadd_rn(__fmul_rn(hi[j], c_hi[j]), __fmul_rn(r_hi, s_hi[j]));
    }
    store_vec<T, N>(dst, y_lo);
    store_vec<T, N>(dst + half, y_hi);
  }
}

// The grouped attention output y, addressed as [B, S, H, hd] through (b, s, h)
// strides: element (r, c) of its ungrouped [B * S, H * hd] view.
template <typename T>
struct Ungrouped {
  const T* __restrict__ y;
  int64_t sb, ss, sh;
  uint32_t S, hd;

  __device__ __forceinline__ const T* row(int64_t r) const {
    return y + (r / S) * sb + (r % S) * ss;
  }
  __device__ __forceinline__ int64_t col(int64_t c) const {
    const uint32_t cc = static_cast<uint32_t>(c);
    return (cc / hd) * sh + cc % hd;
  }
};

// B14, absmax: rows [rpb * blockIdx.x, +rpb) of the view; each row's absmax to
// rmax[r], this block's column maxima to parts[blockIdx.x] [K]. Dynamic
// shared memory: the column maxima [K], fp32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ungroup_absmax(Ungrouped<T> u, float* __restrict__ rmax, float* __restrict__ parts, int64_t M, int64_t K,
               int64_t rpb) {
  constexpr int N = 16 / sizeof(T);
  extern __shared__ float colmax[];
  __shared__ float red[kWarps];
  const int64_t nv = K / N;
  zero_cols<N>(colmax, K);
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rpb;
  const int64_t r1 = r0 + rpb < M ? r0 + rpb : M;
  for (int64_t r = r0; r < r1; ++r) {
    const T* yr = u.row(r);
    float m = 0.0f;
    for (int64_t i = threadIdx.x; i < nv; i += kThreads) {
      float v[N];
      load_vec<T, N>(yr + u.col(i * N), v);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float a = fabsf(v[j]);
        m = fmaxf(m, a);
        colmax[j * nv + i] = fmaxf(colmax[j * nv + i], a);
      }
    }
    m = block_reduce<true>(m, red);
    if (threadIdx.x == 0) rmax[r] = m;
  }
  store_part<N>(colmax, parts, K);
}

// B14, quantize: rows [rpb * blockIdx.x, +rpb) of the view to q int8 [M, K],
// with the row scales scale [M] (AXIS 1) or the column scales scale [K] (AXIS
// 0). Dynamic shared memory (AXIS 0): the columns' inverse scales [K], fp32.
template <typename T, bool SR, int AXIS>
__global__ void __launch_bounds__(kThreads)
ungroup_quant(Ungrouped<T> u, const float* __restrict__ scale, int8_t* __restrict__ q, int64_t M, int64_t K,
              int64_t rpb, float eps, uint64_t key) {
  constexpr int N = 16 / sizeof(T);
  using Pack = typename PackOf<N>::type;
  extern __shared__ float inv_col[];
  const int64_t nv = K / N;
  if (AXIS == 0)
    for (int64_t i = threadIdx.x; i < nv; i += kThreads)
#pragma unroll
      for (int j = 0; j < N; ++j) inv_col[j * nv + i] = inv_scale(scale[i * N + j], eps);
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rpb;
  const int64_t r1 = r0 + rpb < M ? r0 + rpb : M;
  for (int64_t r = r0; r < r1; ++r) {
    const T* yr = u.row(r);
    const float inv_row = AXIS == 1 ? inv_scale(scale[r], eps) : 0.0f;
    for (int64_t i = threadIdx.x; i < nv; i += kThreads) {
      float v[N];
      load_vec<T, N>(yr + u.col(i * N), v);
      uint32_t w[N];
      vec_words<SR, N>(r * K + i * N, key, w);
      Int8Pack<N> o;
#pragma unroll
      for (int j = 0; j < N; ++j) o.c[j] = quant<SR>(v[j], AXIS == 1 ? inv_row : inv_col[j * nv + i], w[j]);
      *reinterpret_cast<Pack*>(q + r * K + i * N) = o.pack;
    }
  }
}

// ---- B14 on the persistent row walk ------------------------------------------

// The vectors a thread a row the route tries, in order
// (ops/rope.py::UNGROUP_VECTORS), and the CTAs an SM the walks keep
// resident (::UNGROUP_CTAS_PER_SM): bf16 K 2048, 256 vectors, takes 64
// threads of four, B7's geometry.
constexpr int kUngroupVs[] = {4, 2, 1};
constexpr int kUngroupCtasPerSm = 2;

// A thread's columns of the ungrouped view: it owns vectors t + p tpr (p <
// V) of every row, so their offsets from a row's start, (c / hd) sh + c % hd
// at c = (t + p tpr) N, are computed once; a row r adds (r / S) sb + (r % S)
// ss (the wrapper takes the walk only where the offsets stay below 2**31).
template <typename T, int V>
struct UngroupCols {
  static constexpr int N = 16 / sizeof(T);
  const T* __restrict__ y;
  int64_t sb, ss;
  uint32_t S, off[V];

  __device__ UngroupCols(const Ungrouped<T>& u, const RowWalk<V, 1>& walk) : y(u.y), sb(u.sb), ss(u.ss), S(u.S) {
#pragma unroll
    for (int p = 0; p < V; ++p) off[p] = static_cast<uint32_t>(u.col(walk.vec(p) * N));
  }
  __device__ __forceinline__ void load(int64_t r, uint4 (&v)[V]) const {
    const uint32_t rr = static_cast<uint32_t>(r);
    const T* row = y + (rr / S) * sb + (rr % S) * ss;
#pragma unroll
    for (int p = 0; p < V; ++p) v[p] = *reinterpret_cast<const uint4*>(row + off[p]);
  }
};

// A row of the walk: this thread's vectors, and the row's scale (the
// quantize along rows), loaded a row ahead.
template <int V>
struct UngroupRow {
  uint4 v[V];
  float scale;
};

// B14's absmax on the persistent row walk (the route
// ops/rope.py::ungroup_sm90_route picks): a CTA of kThreads threads in groups
// of tpr, V vectors a thread a row. The row's max reduces by a warp shuffle,
// then across the group's warps through one shared word a warp (two sets,
// alternating by row parity, so that one named barrier a row suffices), and
// its first thread writes rmax[r]; each thread keeps its columns' maxima in
// registers, and the CTA merges its groups' once, into parts[blockIdx.x]. A
// max is exact and order-free: rmax and the folded column maxima are the
// first design's bit for bit. Dynamic shared memory: the CTA's column maxima
// [K], as bits (non-negative floats order as their bits).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, kUngroupCtasPerSm)
ungroup_absmax_walk(Ungrouped<T> u, float* __restrict__ rmax, float* __restrict__ parts, int64_t M, int64_t K,
                    int tpr) {
  constexpr int N = 16 / sizeof(T);
  extern __shared__ unsigned int cmax[];
  __shared__ unsigned int red[2][kWarps];
  const RowWalk<V, 1> walk(tpr);
  const UngroupCols<T, V> cols(u, walk);
  const int lane = threadIdx.x % 32, w0 = walk.grp * (tpr / 32), W = tpr / 32;
  for (int64_t c = threadIdx.x; c < K; c += kThreads) cmax[c] = 0u;
  __syncthreads();
  float cm[V][N];
#pragma unroll
  for (int p = 0; p < V; ++p)
#pragma unroll
    for (int j = 0; j < N; ++j) cm[p][j] = 0.0f;
  int parity = 0;
  walk.template run_by<UngroupRow<V>>(
      M, [&](int64_t row, UngroupRow<V>& b) { cols.load(row, b.v); },
      [&](int64_t row, const UngroupRow<V>& b) {
        float m = 0.0f;
#pragma unroll
        for (int p = 0; p < V; ++p) {
          const T* e = reinterpret_cast<const T*>(&b.v[p]);
#pragma unroll
          for (int j = 0; j < N; ++j) {
            const float a = fabsf(to_f32(e[j]));
            m = fmaxf(m, a);
            cm[p][j] = fmaxf(cm[p][j], a);
          }
        }
        unsigned int mb = __reduce_max_sync(0xFFFFFFFFu, __float_as_uint(m));
        if (W > 1) {
          if (lane == 0) red[parity][w0 + walk.t / 32] = mb;
          group_sync(walk.grp, tpr);
          if (walk.t == 0)
            for (int w = 0; w < W; ++w) mb = ::max(mb, red[parity][w0 + w]);
          parity ^= 1;
        }
        if (walk.t == 0) rmax[row] = __uint_as_float(mb);
      });
#pragma unroll
  for (int p = 0; p < V; ++p)
#pragma unroll
    for (int j = 0; j < N; ++j) atomicMax(cmax + walk.vec(p) * N + j, __float_as_uint(cm[p][j]));
  __syncthreads();
  for (int64_t c = threadIdx.x; c < K; c += kThreads) parts[blockIdx.x * K + c] = __uint_as_float(cmax[c]);
}

// B14's quantize on the persistent row walk: the absmax walk's geometry, the
// row's inverse scale from its scale loaded with its vectors (AXIS 1), or the
// thread's inverse column scales in registers (AXIS 0), their loads issued
// with the first rows' and inverted at the first row (inverting them before
// the walk's first loads cost 3 us at [8192, 2048] on an H100:
// ab_sm90_forms.py's b14_cols_eager); the cast by cast_pack (one add an
// element), each element's SR word at r K + c, as the first design draws
// it. No shared memory.
template <typename T, bool SR, int AXIS, int V>
__global__ void __launch_bounds__(kThreads, kUngroupCtasPerSm)
ungroup_quant_walk(Ungrouped<T> u, const float* __restrict__ scale, int8_t* __restrict__ q, int64_t M, int64_t K,
                   int tpr, float eps, uint64_t key) {
  constexpr int N = 16 / sizeof(T);
  const RowWalk<V, 1> walk(tpr);
  const UngroupCols<T, V> cols(u, walk);
  float inv[AXIS == 0 ? V : 1][N];
  bool inverted = false;
  if constexpr (AXIS == 0) {  // the loads of the scales, then of the first rows, in flight together
#pragma unroll
    for (int p = 0; p < V; ++p)
#pragma unroll
      for (int j = 0; j < N; ++j) inv[p][j] = scale[walk.vec(p) * N + j];
  }
  walk.template run_by<UngroupRow<V>>(
      M,
      [&](int64_t row, UngroupRow<V>& b) {
        cols.load(row, b.v);
        if constexpr (AXIS == 1) b.scale = scale[row];
      },
      [&](int64_t row, const UngroupRow<V>& b) {
        if constexpr (AXIS == 0) {
          if (!inverted) {  // the first row: the scales have arrived
#pragma unroll
            for (int p = 0; p < V; ++p)
#pragma unroll
              for (int j = 0; j < N; ++j) inv[p][j] = inv_scale(inv[p][j], eps);
            inverted = true;
          }
        }
        const float inv_row = AXIS == 1 ? inv_scale(b.scale, eps) : 0.0f;
#pragma unroll
        for (int p = 0; p < V; ++p) {
          float y[N];
          load_vec<T, N>(reinterpret_cast<const T*>(&b.v[p]), y);
          const int64_t off = row * K + walk.vec(p) * N;
          if constexpr (AXIS == 1) {
            cast_pack<SR, N>(y, inv_row, off, key, q + off);
          } else {
            cast_pack<SR, N>(y, inv[p], off, key, q + off);
          }
        }
      });
}

template <typename T, int MODE>
cudaError_t launch_relayout(const void* in, const int64_t (&is)[3], void* out, const int64_t (&os)[3],
                            const float* cos, const float* sin, int64_t ldt, int64_t B, int64_t S, int64_t H,
                            int64_t hd, cudaStream_t stream) {
  constexpr int N = 16 / sizeof(T);
  const int64_t n_items = B * S * H * (hd / (2 * N));
  const unsigned int blocks = static_cast<unsigned int>((n_items + kThreads - 1) / kThreads);
  rope_relayout<T, MODE><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(in), is[0], is[1], is[2], static_cast<T*>(out), os[0], os[1], os[2], cos, sin, ldt,
      static_cast<uint32_t>(S), static_cast<uint32_t>(H), static_cast<uint32_t>(hd), static_cast<uint32_t>(n_items));
  return cudaGetLastError();
}

template <typename T>
Ungrouped<T> ungrouped(const void* y, const int64_t (&st)[3], int64_t S, int64_t hd) {
  return Ungrouped<T>{static_cast<const T*>(y), st[0], st[1], st[2], static_cast<uint32_t>(S),
                      static_cast<uint32_t>(hd)};
}

template <typename T>
cudaError_t launch_absmax(const void* y, const int64_t (&st)[3], int64_t S, int64_t hd, void* rmax, void* cmax,
                          void* parts, int64_t M, int64_t K, int64_t rpb, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(K) * sizeof(float);
  cudaError_t err;
  if ((err = allow_smem(ungroup_absmax<T>, smem)) != cudaSuccess) return err;
  float* pt = static_cast<float*>(parts);
  ungroup_absmax<T><<<n_blocks(M, rpb), kThreads, smem, stream>>>(ungrouped<T>(y, st, S, hd),
                                                                 static_cast<float*>(rmax), pt, M, K, rpb);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_reduce(true, pt, static_cast<float*>(cmax), n_blocks(M, rpb), K, stream);
}

template <typename T, bool SR, int AXIS>
cudaError_t launch_quant(const void* y, const int64_t (&st)[3], int64_t S, int64_t hd, const void* scale, void* q,
                         int64_t M, int64_t K, int64_t rpb, float eps, uint64_t key, cudaStream_t stream) {
  const size_t smem = AXIS == 0 ? static_cast<size_t>(K) * sizeof(float) : 0;
  cudaError_t err;
  if ((err = allow_smem(ungroup_quant<T, SR, AXIS>, smem)) != cudaSuccess) return err;
  ungroup_quant<T, SR, AXIS><<<n_blocks(M, rpb), kThreads, smem, stream>>>(
      ungrouped<T>(y, st, S, hd), static_cast<const float*>(scale), static_cast<int8_t*>(q), M, K, rpb, eps, key);
  return cudaGetLastError();
}

// launch(std::integral_constant<int, V>{}) for the walks' tpr threads a row:
// whole warps in groups that divide the block, V = K / N / tpr one of
// kUngroupVs, whole vectors within a head (hd % N == 0), on ctas >= 1 CTAs;
// cudaErrorInvalidValue for any other layout.
template <typename T, class Launch>
cudaError_t with_ungroup_layout(int tpr, int64_t K, int64_t hd, int64_t ctas, Launch&& launch) {
  constexpr int64_t N = 16 / sizeof(T);
  if (tpr <= 0 || tpr % 32 || kThreads % tpr || K % N || hd % N || (K / N) % tpr || ctas < 1)
    return cudaErrorInvalidValue;
  switch ((K / N) / tpr) {
    case kUngroupVs[0]: return launch(std::integral_constant<int, kUngroupVs[0]>{});
    case kUngroupVs[1]: return launch(std::integral_constant<int, kUngroupVs[1]>{});
    case kUngroupVs[2]: return launch(std::integral_constant<int, kUngroupVs[2]>{});
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_absmax_walk(const void* y, const int64_t (&st)[3], int64_t S, int64_t hd, void* rmax, void* cmax,
                               void* parts, int64_t M, int64_t K, int tpr, int64_t ctas, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(K) * sizeof(float);
  float* pt = static_cast<float*>(parts);
  return with_ungroup_layout<T>(tpr, K, hd, ctas, [&](auto v) {
    const auto kernel = ungroup_absmax_walk<T, decltype(v)::value>;
    cudaError_t err;
    if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
    kernel<<<static_cast<unsigned int>(ctas), kThreads, smem, stream>>>(ungrouped<T>(y, st, S, hd),
                                                                        static_cast<float*>(rmax), pt, M, K, tpr);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    return launch_reduce(true, pt, static_cast<float*>(cmax), ctas, K, stream);
  });
}

template <typename T, bool SR, int AXIS>
cudaError_t launch_quant_walk(const void* y, const int64_t (&st)[3], int64_t S, int64_t hd, const void* scale,
                              void* q, int64_t M, int64_t K, int tpr, int64_t ctas, float eps, uint64_t key,
                              cudaStream_t stream) {
  return with_ungroup_layout<T>(tpr, K, hd, ctas, [&](auto v) {
    ungroup_quant_walk<T, SR, AXIS, decltype(v)::value><<<static_cast<unsigned int>(ctas), kThreads, 0, stream>>>(
        ungrouped<T>(y, st, S, hd), static_cast<const float*>(scale), static_cast<int8_t*>(q), M, K, tpr, eps, key);
    return cudaGetLastError();
  });
}

}  // namespace

// Every entry point returns the launch's cudaError_t (0 on success). The
// wrapper (ops/rope.py) guarantees: the grouped and ungrouped tensors are
// addressed as [B, S, H, hd] through the strides of b, s and h, given in
// elements, with a unit hd stride; every stride a multiple of the 16-byte
// vector and every pointer 16-byte aligned; hd a multiple of two vectors;
// B * S * H * hd < 2**31; is_bf16 selects bf16 (else fp32).

// B13: out = rope(in) with mode 0 (copy: the plain grouping), 1 (rot) or 2
// (rot^T); cos and sin are fp32 [S, ldt] (unused in mode 0).
extern "C" int qt_rope_relayout(const void* in, int64_t isb, int64_t iss, int64_t ish, void* out, int64_t osb,
                                int64_t oss, int64_t osh, const void* cos, const void* sin, int64_t ldt, int64_t B,
                                int64_t S, int64_t H, int64_t hd, int mode, int is_bf16, void* stream) {
  if (B * S * H == 0) return 0;
  const int64_t in_strides[3] = {isb, iss, ish}, out_strides[3] = {osb, oss, osh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(cos);
  const float* s = static_cast<const float*>(sin);
#define QT_RELAYOUT(T, MODE) launch_relayout<T, MODE>(in, in_strides, out, out_strides, c, s, ldt, B, S, H, hd, st)
  if (is_bf16)
    return mode == kCopy ? QT_RELAYOUT(__nv_bfloat16, kCopy)
                         : mode == kRotate ? QT_RELAYOUT(__nv_bfloat16, kRotate)
                                           : QT_RELAYOUT(__nv_bfloat16, kRotateInverse);
  return mode == kCopy ? QT_RELAYOUT(float, kCopy)
                       : mode == kRotate ? QT_RELAYOUT(float, kRotate) : QT_RELAYOUT(float, kRotateInverse);
#undef QT_RELAYOUT
}

// B14, absmax: rmax fp32 [B * S], cmax fp32 [H * hd], by way of parts, fp32
// scratch. tpr (ops/rope.py::ungroup_sm90_route): 0 takes ungroup_absmax with
// rpb rows a block, parts ceil(B * S / rpb) * H * hd floats; else
// ungroup_absmax_walk with tpr threads a row on ctas CTAs, parts ctas * H *
// hd floats.
extern "C" int qt_ungroup_amax(const void* y, int64_t sb, int64_t ss, int64_t sh, int64_t B, int64_t S, int64_t H,
                               int64_t hd, void* rmax, void* cmax, void* parts, int64_t rpb, int is_bf16, int tpr,
                               int64_t ctas, void* stream) {
  if (B * S == 0) return 0;
  const int64_t strides[3] = {sb, ss, sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t M = B * S, K = H * hd;
  if (tpr != 0)
    return is_bf16 ? launch_absmax_walk<__nv_bfloat16>(y, strides, S, hd, rmax, cmax, parts, M, K, tpr, ctas, st)
                   : launch_absmax_walk<float>(y, strides, S, hd, rmax, cmax, parts, M, K, tpr, ctas, st);
  return is_bf16 ? launch_absmax<__nv_bfloat16>(y, strides, S, hd, rmax, cmax, parts, M, K, rpb, st)
                 : launch_absmax<float>(y, strides, S, hd, rmax, cmax, parts, M, K, rpb, st);
}

// B14, quantize: q int8 [B * S, H * hd] given scale fp32 [B * S] (axis 1) or
// [H * hd] (axis 0). tpr (ops/rope.py::ungroup_sm90_route): 0 takes
// ungroup_quant with rpb rows a block; else ungroup_quant_walk with tpr
// threads a row on ctas CTAs.
extern "C" int qt_ungroup_quant(const void* y, int64_t sb, int64_t ss, int64_t sh, int64_t B, int64_t S, int64_t H,
                                int64_t hd, const void* scale, void* q, int64_t rpb, int axis, float eps, int is_bf16,
                                int sr, uint64_t key, int tpr, int64_t ctas, void* stream) {
  if (B * S == 0) return 0;
  const int64_t strides[3] = {sb, ss, sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t M = B * S, K = H * hd;
#define QT_QUANT(T, SR, AXIS)                                                                                  \
  (tpr != 0 ? launch_quant_walk<T, SR, AXIS>(y, strides, S, hd, scale, q, M, K, tpr, ctas, eps, key, st) \
            : launch_quant<T, SR, AXIS>(y, strides, S, hd, scale, q, M, K, rpb, eps, key, st))
#define QT_AXES(T, SR) (axis == 1 ? QT_QUANT(T, SR, 1) : QT_QUANT(T, SR, 0))
  if (is_bf16) return sr ? QT_AXES(__nv_bfloat16, true) : QT_AXES(__nv_bfloat16, false);
  return sr ? QT_AXES(float, true) : QT_AXES(float, false);
#undef QT_AXES
#undef QT_QUANT
}
