// The pipelined Hopper GEMM mainloop: TMA loads into a ring of shared-memory
// stages, mbarriers between one producer warp and two consumer warpgroups,
// and wgmma on the tensor cores. It serves
//
// - K2 at M > 16 (scaled_mm.cu): out = ((float)(a . b^T) * sa[m]) * sb[n],
//   a [M, K] and b [N, K] int8, both K-major, int32 accumulators. Replaces
//   quantized_training_tpu/ops/pallas_mm.py::scaled_mm_dims (:192), dims
//   (1, 1), at its training and prefill sizes;
// - B17's bf16 forms (matmul.cu): out = a . b in fp32, a [M, K] K-major and
//   b [K, N] MN-major, rounded once to fp32 or bf16. Replaces
//   quantized_training_tpu/ops/pallas_mm.py::matmul (:537).
//
// Bound on the H100: the tensor cores, 1,979 int8 TOP/s and 989 bf16 TFLOP/s
// dense (K2 at M 8192, N 5632, K 2048: 95.5 us; B17 at 4096^3: 139.0 us).
// Only wgmma reaches that rate, and only with its operands fed from shared
// memory faster than one warp's loads can: so the operands move by TMA,
// with no thread spending registers or issue slots on a copy.
//
// Design. A CTA computes one 128 x 128 output tile with 384 threads: two
// consumer warpgroups of 64 rows each and one producer warpgroup, of which
// one thread issues the loads. Each of the kStages stages holds 128 bytes of
// K for 128 rows of a and 128 rows (or columns) of b: 16 KB each, loaded by
// cp.async.bulk.tensor with the 128-byte swizzle that wgmma's descriptors
// read. A stage's full mbarrier counts the bytes landed (expect_tx); its
// empty mbarrier counts the 8 consumer warps that are done with it. The
// consumers keep one wgmma group in flight: they issue stage k's MMAs, wait
// for stage k - 1's, and release stage k - 1, so the tensor cores never wait
// for a release and the producer runs up to kStages tiles ahead. The
// accumulators stay in registers, and the epilogue writes them to device
// memory from there in wgmma's layout (row 16 warp + lane / 4 (+ 8), column
// 8 j + 2 (lane % 4) (+ 1)), masked at the ragged edge. TMA zero-fills
// loads outside the tensor, so a ragged M, N or K adds exact zeros. The
// consumers need about 100 registers (64 accumulators), under the 168 that
// __launch_bounds__(384, 1) gives every thread, so setmaxnreg is not used.
// Not yet: a persistent tile scheduler, clusters with TMA multicast, a TMA
// store of the output.
//
// 8-bit wgmma takes its operands K-major only (bf16 also MN-major, through
// the transpose bit, which B17's b uses). So B1 and B2, whose int8 operands
// are MN-major as B4 and B5 write them, and B17's int8 form do not take this
// mainloop yet: they stay on mm_tiles.cuh's wmma tiles.
//
// The tensor maps are encoded on the host per call by
// cuTensorMapEncodeTiled, fetched from the driver by cudaGetDriverEntryPoint
// (the library links no -lcuda), and passed by value as __grid_constant__
// parameters. A wait on an mbarrier that has not completed in 2 s traps, so
// a fault in the pipeline ends the launch with an error instead of hanging
// the card.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace qt_sm90 {

constexpr int kBM = 128, kBN = 128;
constexpr int kRowBytes = 128;                    // K bytes of a stage row: the swizzle span
constexpr int kTileBytes = 128 * kRowBytes;       // a's (or b's) share of a stage: 16 KB
constexpr int kStageBytes = 2 * kTileBytes;
constexpr int kStages = 5;
constexpr int kThreads = 384;                     // consumer warpgroups 0 and 1, producer 2
constexpr int kSmem = kStages * kStageBytes + 1024;  // + the slack to align the ring to 1 KB
constexpr int kConsumerWarps = 8;

// The operand forms. A stage row is 128 bytes of K: BK values.
struct S8KMajor {   // a [M, K], b [N, K] int8
  using Acc = int;
  static constexpr int BK = 128;
  static constexpr bool kMnB = false;
};
struct Bf16MnB {    // a [M, K], b [K, N] bf16
  using Acc = float;
  static constexpr int BK = 64;
  static constexpr bool kMnB = true;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// ---- epilogues: one output row, then its values ---------------------------

// K2: ((float)acc * sa[r]) * sb[c] in fp32, rounded once to OT.
template <typename ST, typename OT>
struct ScaledOut {
  const ST* sa;
  const ST* sb;
  OT* out;
  struct Row {
    float s;
    OT* p;
  };
  __device__ Row row(int r, int N) const { return {qt_sm90::to_f32(sa[r]), out + static_cast<int64_t>(r) * N}; }
  __device__ float value(const Row& rw, int c, int acc) const {
    return (static_cast<float>(acc) * rw.s) * qt_sm90::to_f32(sb[c]);
  }
};

// B17: the fp32 sum, rounded once to OT.
template <typename OT>
struct PlainOut {
  OT* out;
  struct Row {
    OT* p;
  };
  __device__ Row row(int r, int N) const { return {out + static_cast<int64_t>(r) * N}; }
  __device__ float value(const Row&, int, float acc) const { return acc; }
};

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// ---- PTX: shared addresses, mbarriers, TMA, wgmma --------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait until the phase of parity `parity` of the barrier has completed;
// trap after 2 s (a pipeline fault, not a slow load).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t t0 = 0;
  for (uint32_t spins = 1;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if ((spins & 0x3FF) == 0) {
      const uint64_t now = global_ns();
      if (t0 == 0) {
        t0 = now;
      } else if (now - t0 > 2000000000ull) {
        __trap();
      }
    }
  }
}

// A 2-D box of the tensor map at (inner, outer) into shared memory, counted
// on the barrier's transaction bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int inner, int outer, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(inner), "r"(outer)
      : "memory");
}

// A wgmma shared-memory descriptor with the 128-byte swizzle: start address,
// leading and stride byte offsets, each in 16-byte units. K-major (a, and
// S8KMajor's b): the stride is 1024 bytes (8 rows of 128 bytes) and the
// leading offset unused. MN-major (Bf16MnB's b): the leading offset is the
// distance between the two 64-column halves of the tile, the stride again 8
// rows (of K) of 128 bytes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// A compiler fence on the accumulators: no instruction that reads or writes
// them moves across it. wgmma writes them asynchronously, so without it the
// compiler may read one (the epilogue's int -> float conversions, say) before
// the wgmma.wait_group that completes it.
__device__ __forceinline__ void fence_operands(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define QT_ACC8(c, i) c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3]), c(d[i + 4]), c(d[i + 5]), c(d[i + 6]), c(d[i + 7])
#define QT_ACC64(c) \
  QT_ACC8(c, 0), QT_ACC8(c, 8), QT_ACC8(c, 16), QT_ACC8(c, 24), QT_ACC8(c, 32), QT_ACC8(c, 40), QT_ACC8(c, 48), \
      QT_ACC8(c, 56)
#define QT_D64                                                                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, "  \
  "%23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d += a . b over one K step (the scale-d predicate on: accumulate):
// m64n128k32 int8 (both K-major), or m64n128k16 bf16 with b MN-major (the
// transpose bit of b set).
__device__ __forceinline__ void wgmma(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " QT_D64 ", %64, %65, p;\n}"
      : QT_ACC64("+r")
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " QT_D64 ", %64, %65, p, 1, 1, 0, 1;\n}"
      : QT_ACC64("+f")
      : "l"(da), "l"(db), "r"(1));
}

#undef QT_ACC8
#undef QT_ACC64
#undef QT_D64

// ---- the kernel -------------------------------------------------------------

// nk: the K steps, ceil(K / Form::BK).
template <class Form, class Epi>
__global__ void __launch_bounds__(kThreads, 1)
gemm_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb, const Epi epi, int M,
            int N, int nk) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kStages], empty_bar[kStages];
  // the ring: stage s holds a's tile at ring + s * kStageBytes and b's
  // kTileBytes above it; every tile starts on a 1 KB boundary (the swizzle atom)
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full0 = smem_u32(full_bar), empty0 = smem_u32(empty_bar);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // the producer: one thread keeps the ring full
    if (threadIdx.x == 256) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kStages, use = kt / kStages;
        if (use > 0) mbar_wait(empty0 + 8 * s, (use - 1) & 1);
        const uint32_t bar = full0 + 8 * s, sa = ring + s * kStageBytes, sb = sa + kTileBytes;
        const int k = kt * Form::BK;
        mbar_expect_tx(bar, kStageBytes);
        tma_load(sa, &ta, k, m0, bar);
        if constexpr (Form::kMnB) {  // two 64-column halves of b's [64 k][128 n] tile
          tma_load(sb, &tb, n0, k, bar);
          tma_load(sb + kTileBytes / 2, &tb, n0 + 64, k, bar);
        } else {
          tma_load(sb, &tb, k, n0, bar);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: rows [64 wg, 64 wg + 64) of the tile
  typename Form::Acc d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kStages;
    mbar_wait(full0 + 8 * s, (kt / kStages) & 1);
    const uint32_t sa = ring + s * kStageBytes + wg * 64 * kRowBytes, sb = ring + s * kStageBytes + kTileBytes;
    fence_operands(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // four 32-byte K steps of the 128-byte row
      const uint64_t da = smem_desc(sa + 32 * kk, 16, 1024);
      const uint64_t db = Form::kMnB ? smem_desc(sb + 16 * kRowBytes * kk, kTileBytes / 2, 1024)
                                     : smem_desc(sb + 32 * kk, 16, 1024);
      wgmma(d, da, db);
    }
    wgmma_commit();
    fence_operands(d);
    wgmma_wait<1>();  // stage kt - 1's MMAs are done: release it
    if (kt > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((kt - 1) % kStages));
  }
  wgmma_wait<0>();
  fence_operands(d);

  const int r0 = m0 + wg * 64 + (warp % 4) * 16 + lane / 4, c0 = n0 + 2 * (lane % 4);
  const bool pairs = (N % 2) == 0;  // a pair of columns is one aligned 2-value store
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= M) continue;
    const auto rw = epi.row(r, N);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = c0 + 8 * j;
      const auto a0 = d[4 * j + 2 * h], a1 = d[4 * j + 2 * h + 1];
      if (pairs && c + 1 < N) {
        store2(rw.p + c, epi.value(rw, c, a0), epi.value(rw, c + 1, a1));
      } else {
        if (c < N) store1(rw.p + c, epi.value(rw, c, a0));
        if (c + 1 < N) store1(rw.p + c + 1, epi.value(rw, c + 1, a1));
      }
    }
  }
}

// ---- host side -------------------------------------------------------------

inline PFN_cuTensorMapEncodeTiled encode_fn() {
  static const PFN_cuTensorMapEncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled>(p);
  }();
  return fn;
}

// A row-major [outer, inner] tensor with rows of row_bytes, read in boxes of
// [box_outer, box_inner] with the 128-byte swizzle (box_inner values are 128
// bytes). Out-of-bounds elements of a box load as zeros.
inline cudaError_t encode_2d(CUtensorMap* map, CUtensorMapDataType dtype, const void* base, uint64_t inner,
                             uint64_t outer, uint64_t row_bytes, uint32_t box_inner, uint32_t box_outer) {
  const PFN_cuTensorMapEncodeTiled encode = encode_fn();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {inner, outer}, strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer}, elem_strides[2] = {1, 1};
  const CUresult r = encode(map, dtype, 2, const_cast<void*>(base), dims, strides, box, elem_strides,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <class Form, class Epi>
cudaError_t launch(const CUtensorMap& ta, const CUtensorMap& tb, const Epi& epi, int M, int N, int K,
                   cudaStream_t stream) {
  auto kernel = gemm_kernel<Form, Epi>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  kernel<<<grid, kThreads, kSmem, stream>>>(ta, tb, epi, M, N, (K + Form::BK - 1) / Form::BK);
  return cudaGetLastError();
}

// K2: a [M, K], b [N, K] int8, K % 16 == 0, 16-byte aligned.
template <typename ST, typename OT>
cudaError_t scaled_s8(const void* a, const void* b, const void* sa, const void* sb, void* out, int M, int N, int K,
                      cudaStream_t stream) {
  CUtensorMap ta, tb;
  cudaError_t err = encode_2d(&ta, CU_TENSOR_MAP_DATA_TYPE_UINT8, a, K, M, K, kRowBytes, kBM);
  if (err == cudaSuccess) err = encode_2d(&tb, CU_TENSOR_MAP_DATA_TYPE_UINT8, b, K, N, K, kRowBytes, kBN);
  if (err != cudaSuccess) return err;
  const ScaledOut<ST, OT> epi{static_cast<const ST*>(sa), static_cast<const ST*>(sb), static_cast<OT*>(out)};
  return launch<S8KMajor>(ta, tb, epi, M, N, K, stream);
}

// B17 bf16: a [M, K], b [K, N] bf16, each 16-byte aligned with rows a
// multiple of 16 bytes long.
template <typename OT>
cudaError_t matmul_bf16(const void* a, const void* b, void* out, int M, int N, int K, cudaStream_t stream) {
  CUtensorMap ta, tb;
  constexpr uint32_t kBk = Bf16MnB::BK;
  cudaError_t err = encode_2d(&ta, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a, K, M, 2ull * K, kBk, kBM);
  if (err == cudaSuccess) err = encode_2d(&tb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, b, N, K, 2ull * N, 64, kBk);
  if (err != cudaSuccess) return err;
  return launch<Bf16MnB>(ta, tb, PlainOut<OT>{static_cast<OT*>(out)}, M, N, K, stream);
}

}  // namespace qt_sm90
