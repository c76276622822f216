// The pipelined Hopper GEMM mainloop: TMA loads into a ring of shared-memory
// stages, mbarriers between a producer warpgroup and two consumer
// warpgroups, and wgmma on the tensor cores. It serves
//
// - K2 at M > 16 (scaled_mm.cu, S8KMajor): out = ((float)(a . b^T) * sa[m])
//   * sb[n], a [M, K] and b [N, K] int8, both K-major, int32 accumulators.
//   Replaces quantized_training_tpu/ops/pallas_mm.py::scaled_mm_dims (:192),
//   dims (1, 1), at its training and prefill sizes;
// - B1 (scaled_mm.cu, S8MnB): the same epilogue over a [M, K] K-major . b
//   [K, N] MN-major, int8 (the grad_input g . w, w [out, in] contracted over
//   out). Replaces pallas_mm.py::scaled_mm (:85);
// - B2 (scaled_mm.cu, S8MnMajor): the same epilogue over a [K, M]^T . b
//   [K, N], both int8 MN-major (tokens x features, as the column quantizes
//   write them). Replaces pallas_mm.py::scaled_mm_dims (:192), dims (0, 0);
// - B15 at QK % 128 == 0 (tile_scaled_mm.cu, with the TileScaledOut
//   epilogue): B1's operand layout, int8 (S8MnB) or e4m3 widened to fp16 on
//   chip (E4m3F16), each quant block's partial folded into a second, fp32
//   accumulator with its tile scales. Replaces pallas_mm.py::tile_scaled_mm
//   (:378);
// - B16 at M > 16 (scaled_mm.cu, S4KMajor): the same epilogue over packed
//   signed int4 a [M, K / 2] and b [N, K / 2] (two values a byte, the even one
//   in the high nibble), widened to int8 on chip. Replaces pallas_mm.py::
//   scaled_int4_mm (:636);
// - B17's bf16 forms (matmul.cu, Bf16MnB): out = a . b in fp32, a [M, K]
//   K-major and b [K, N] MN-major, rounded once to fp32 or bf16; and its int8
//   form (matmul.cu, S8MnB with the IntOut epilogue): the exact int32 sum of
//   B1's operand layout, stored as it is. Replaces quantized_training_tpu/
//   ops/pallas_mm.py::matmul (:537).
//
// Bound on the H100: the tensor cores, 1,979 int8 TOP/s and 989 bf16 TFLOP/s
// dense (K2 at M 8192, N 5632, K 2048: 95.5 us; B17 at 4096^3: 139.0 us).
// Only wgmma reaches that rate, and only with its operands fed from shared
// memory faster than one warp's loads can: so the operands move by TMA,
// with no thread spending registers or issue slots on a copy.
//
// Design. A CTA computes 128 x 128 output tiles with 384 threads: two
// consumer warpgroups of 64 rows each and one producer warpgroup. Each stage
// holds 128 bytes of K for 128 rows of a and 128 rows (or columns) of b: 16
// KB each, with the 128-byte swizzle that wgmma's descriptors read (the
// 16-byte chunk c of row r at r * 128 + (c ^ r % 8) * 16). A stage's empty
// mbarrier counts the 8 consumer warps that are done with it. The consumers
// keep one wgmma group in flight: they issue stage k's MMAs, wait for stage
// k - 1's, and release stage k - 1, so the tensor cores never wait for a
// release and the producer runs ahead by the whole ring. The accumulators
// stay in registers, and the epilogue writes them to device memory from
// there in wgmma's layout (row 16 warp + lane / 4 (+ 8), column 8 j + 2
// (lane % 4) (+ 1)), masked at the ragged edge. TMA zero-fills loads outside
// the tensor, so a ragged M, N or K adds exact zeros. The consumers need
// about 100 registers (64 accumulators; B16's two sets of a's fragments
// take the rest), within the 168 that __launch_bounds__(384, 1) gives
// every thread, so only B15's fold (below) uses setmaxnreg. The kernel is
// persistent: one CTA an SM walks its share of the tiles (TileWalk), so a
// tile's loads (and
// rewrites) overlap the previous tile's last MMAs and epilogue, where a CTA
// a tile would fill and drain its rings alone (ab_sm90_forms.py's
// one_tile: 1-12% slower for B2, B16 and K2, the most at K 2048). The
// producer steps through its tiles' K steps with StepCursor, since a
// division a step to find a step's tile sits on the path to each load. Not
// yet: clusters with TMA multicast, a TMA store of the output.
//
// Two kinds of operand form fill a stage:
//
// - TMA lands it as it is (S8KMajor, Bf16MnB; 5 stages, 160 KB): one thread
//   of the producer issues the loads, and the stage's full mbarrier counts
//   the bytes landed (expect_tx). 8-bit wgmma reads its operands K-major
//   only; bf16 also MN-major, through the transpose bit, which B17's b uses.
// - The producer rewrites it (S8MnMajor, S4KMajor, S8MnB, E4m3F16). TMA
//   cannot change a layout or a type, and 8-bit wgmma takes neither packed
//   int4 nor an MN-major 8-bit operand. So one producer thread lands each K step's
//   operands as they are stored in a raw ring (its slot's full mbarrier
//   counts the bytes), and the producer's 4 warps rewrite the raw slot into
//   the stage, in exactly the layout TMA gives K2: B2 transposes 16 x 16
//   byte blocks of a and b with prmt; B1 and B15 transpose b alone, while
//   their K-major a lands by TMA straight into the stage (its full mbarrier
//   then counts 129 arrivals: the TMA thread's arrive.expect_tx for a's
//   bytes and the 128 writers of b); B15's e4m3 form widens both operands
//   to fp16 (see E4m3F16); B16 widens b's nibbles to bytes, while the
//   consumers build a's fragments in registers from the raw slot themselves
//   (wgmma's register-A form; see S4KMajor). Then each writer
//   fences its stores into the async proxy (fence.proxy.async.shared::cta:
//   wgmma reads shared memory through it; ab_sm90_forms.py's variant
//   without the fence is not bit-exact at B2's training shapes on the H100)
//   and arrives on the stage's full mbarrier (a count of 128 threads). The
//   consumers, the descriptors and the epilogue are K2's. The rewrite is
//   shared-memory traffic beside wgmma's own reads of the stage (B2: 32 KB
//   read and 32 KB written a K step), the price of keeping every operand in
//   its stored layout in device memory (B1 with the roles swapped instead,
//   the consumers building fragments of b^T, ran 8-18% slower:
//   ab_sm90_forms.py's b1_swap). The raw
//   reads and the stage writes are laid out so that each 8-lane phase of a
//   16-byte access touches 8 distinct bank groups (see each rewrite).
//   Depths, under the 227 KB a CTA can have, the fastest of those
//   ab_sm90_forms.py times on the H100: B2's raw slot is 32 KB (128 K rows
//   x 128 bytes of M or N per operand), 4 stages and 2 raw slots (192 KB);
//   B16 takes 256 values of K a step (half the barrier round trips of 128,
//   and 128-byte TMA rows): its raw slot is 32 KB and its stage, b alone,
//   32 KB, 3 stages and 4 raw slots (224 KB), the most that fit. S8MnB's
//   raw slot is b's 16 KB: 4 stages and 4 raw slots (192 KB; 5 + 3 and 6 +
//   1 ran 2-7% slower for B1); E4m3F16's is a's and b's 8 KB each: 5
//   stages and 3 raw slots (208 KB; 6 + 1 ran 2-9% slower with B15's
//   overlapped fold, though 3% faster with the fold that waits).
//
// B15's fold. A stage is 128 bytes of K, one quant block at QK = 128 for
// int8 (QK / 128 stages at a larger multiple; the e4m3 form's 64-value
// stages, two). The producer also writes the block's 128 row scales of a
// and 128 column scales of b into shared memory beside the block's last
// stage. Each consumer keeps two partial sets: while one takes block b's
// MMAs, the other's block b - 1 is folded into 64 fp32 accumulators, acc +
// (part * sa) * sb, each product and sum rounded on its own (no FMA),
// block after block: so the int8 form, whose int32 partials are exact, is
// bit-exact with the plain version. 192 accumulators take the consumers
// past the 168 registers a thread has at launch: the producer gives
// registers back (setmaxnreg.dec to 56) and the consumers take them
// (setmaxnreg.inc to 224).
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

#include <type_traits>

namespace qt_sm90 {

constexpr int kBM = 128, kBN = 128;
constexpr int kRowBytes = 128;                    // K bytes of a stage row: the swizzle span
constexpr int kTileBytes = 128 * kRowBytes;       // a's (or b's) share of a stage: 16 KB
constexpr int kStageBytes = 2 * kTileBytes;
constexpr int kThreads = 384;                     // consumer warpgroups 0 and 1, producer 2
constexpr int kConsumerWarps = 8;
constexpr int kProducerThreads = 128;

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

// Shared-memory stores of this thread become visible to the async proxy
// (wgmma's operand reads, TMA).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// The producer warpgroup's 128 threads meet (named barrier 1; 0 is
// __syncthreads').
__device__ __forceinline__ void producer_sync() { asm volatile("bar.sync 1, 128;" ::: "memory"); }

// A wgmma shared-memory descriptor with the 128-byte swizzle: start address,
// leading and stride byte offsets, each in 16-byte units. K-major (a, and
// b of every 8-bit form): the stride is 1024 bytes (8 rows of 128 bytes) and
// the leading offset unused. MN-major (Bf16MnB's b): the leading offset is
// the distance between the two 64-column halves of the tile, the stride
// again 8 rows (of K) of 128 bytes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// This warpgroup's registers a thread, moved to N (a multiple of 8) from the
// pool the CTA's warpgroups share.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
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
template <int N>
__device__ __forceinline__ void fence_operands(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < 4 * N; ++i) asm volatile("" : "+r"(a[i / 4][i % 4])::"memory");
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

// The bf16 MMA's fp16 twin, b MN-major: B15's e4m3 operands widened on chip.
__device__ __forceinline__ void wgmma_f16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 " QT_D64 ", %64, %65, p, 1, 1, 0, 1;\n}"
      : QT_ACC64("+f")
      : "l"(da), "l"(db), "r"(1));
}

// The same int8 MMA with A from registers: per warp of the warpgroup, rows
// 16 w + lane / 4 (+ 8 in a[1], a[3]), K 4 (lane % 4) .. + 3 (+ 16 in a[2],
// a[3]).
__device__ __forceinline__ void wgmma(int (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " QT_D64 ", {%64, %65, %66, %67}, %68, p;\n}"
      : QT_ACC64("+r")
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef QT_ACC8
#undef QT_ACC64
#undef QT_D64

// ---- host: tensor maps ------------------------------------------------------

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
// [box_outer, box_inner], with the 128-byte swizzle (box_inner values are 128
// bytes: a wgmma stage) or none (a raw slot, rewritten by the producer).
// Out-of-bounds elements of a box load as zeros.
inline cudaError_t encode_2d(CUtensorMap* map, CUtensorMapDataType dtype, const void* base, uint64_t inner,
                             uint64_t outer, uint64_t row_bytes, uint32_t box_inner, uint32_t box_outer,
                             CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const PFN_cuTensorMapEncodeTiled encode = encode_fn();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {inner, outer}, strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer}, elem_strides[2] = {1, 1};
  const CUresult r = encode(map, dtype, 2, const_cast<void*>(base), dims, strides, box, elem_strides,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---- the operand forms ------------------------------------------------------
//
// Each form says how many values of K a stage row holds (BK), how deep its
// rings are, how a K step's operands are loaded (load: into a stage, or into
// a raw slot where kRewrite), and, where kRewrite, how a raw slot becomes a
// stage (rewrite, run by each of the producer's 128 threads t). encode
// describes one operand of `rows` rows (M or N) over K for the 8-bit forms.

struct S8KMajor {  // K2: a [M, K], b [N, K] int8
  using Acc = int;
  static constexpr int BK = 128, kStages = 5, kRawSlots = 0, kLoadBytes = kStageBytes, kAccShift = 0;
  static constexpr int kStageSize = kStageBytes;
  static constexpr bool kMnB = false, kRewrite = false, kAInRegs = false, kATma = false;
  static cudaError_t encode(CUtensorMap* map, const void* base, int rows, int K, int /*operand*/) {
    return encode_2d(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, base, K, rows, K, kRowBytes, 128);
  }
  __device__ static void load(uint32_t dst, const CUtensorMap* ta, const CUtensorMap* tb, int kt, int m0, int n0,
                              uint32_t bar) {
    tma_load(dst, ta, kt * BK, m0, bar);
    tma_load(dst + kTileBytes, tb, kt * BK, n0, bar);
  }
};

struct Bf16MnB {  // B17: a [M, K], b [K, N] bf16
  using Acc = float;
  static constexpr int BK = 64, kStages = 5, kRawSlots = 0, kLoadBytes = kStageBytes, kAccShift = 0;
  static constexpr int kStageSize = kStageBytes;
  static constexpr bool kMnB = true, kRewrite = false, kAInRegs = false, kATma = false;
  __device__ static void load(uint32_t dst, const CUtensorMap* ta, const CUtensorMap* tb, int kt, int m0, int n0,
                              uint32_t bar) {
    tma_load(dst, ta, kt * BK, m0, bar);
    tma_load(dst + kTileBytes, tb, n0, kt * BK, bar);  // two 64-column halves of b's [64 k][128 n] tile
    tma_load(dst + kTileBytes + kTileBytes / 2, tb, n0 + 64, kt * BK, bar);
  }
};

// The high and the low nibbles of 4 packed bytes, each in the high half of
// its byte: 16 times its value, exact in int8 (-128..112).
__device__ __forceinline__ uint32_t hi_nibbles(uint32_t w) { return w & 0xF0F0F0F0u; }
__device__ __forceinline__ uint32_t lo_nibbles(uint32_t w) { return (w << 4) & 0xF0F0F0F0u; }

// B16: a [M, K / 2], b [N, K / 2] packed int4; K % 32 == 0, K < 2^17. The
// consumers build wgmma's A fragments of a straight from the raw slot, and
// the producer widens b alone into a stage that holds only b: half the
// rewrite, and no shared-memory pass over a at all. Each value is widened
// by one or two instructions a word into the high half of its byte
// (hi_nibbles, lo_nibbles), where sign-extending it to the low half takes
// three or four (ab_sm90_forms.py times both). The K order within a 32-value wgmma
// step is all the high nibbles of its 16 packed bytes, then all the low
// ones, the same for a's fragments and b's stage, so the sum is unchanged;
// each product is 256 times the true one, and the epilogue shifts the int32
// sum back right by 8 (kAccShift): exact, as every term is a multiple of
// 256 and |sum| <= 256 * 64 * K < 2^31 for K < 2^17.
template <int kBK>
struct S4KMajorT {
  using Acc = int;
  static constexpr int BK = kBK, kAccShift = 8;
  static constexpr int kSub = BK / 128;       // 128-value sub-tiles of b's stage
  static constexpr int kRowPacked = BK / 2;   // bytes of a raw row
  static constexpr int kStages = kSub == 1 ? 4 : 3, kRawSlots = kSub == 1 ? 8 : 4;
  static constexpr int kRawTile = 128 * kRowPacked;  // one operand's packed K step
  static constexpr int kLoadBytes = 2 * kRawTile, kStageSize = kSub * kTileBytes;
  static constexpr bool kMnB = false, kRewrite = true, kAInRegs = true, kATma = false;
  static_assert(kSub == 1 || kSub == 2, "a raw row is one swizzle span at most");
  // a's tile lands with the swizzle of its row length (64 bytes: the 16-byte
  // chunk c of row r at c ^ (r / 2) % 4; 128: c ^ r % 8), so that a warp's
  // fragment loads hit 32 distinct banks; b's dense
  static cudaError_t encode(CUtensorMap* map, const void* base, int rows, int K, int operand) {
    const CUtensorMapSwizzle a_swizzle = kSub == 1 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
    return encode_2d(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, base, K / 2, rows, K / 2, kRowPacked, 128,
                     operand == 0 ? a_swizzle : CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  __device__ static void load(uint32_t dst, const CUtensorMap* ta, const CUtensorMap* tb, int kt, int m0, int n0,
                              uint32_t bar) {
    tma_load(dst, ta, kt * kRowPacked, m0, bar);
    tma_load(dst + kRawTile, tb, kt * kRowPacked, n0, bar);
  }
  // b's raw [128 rows][kRowPacked bytes] -> the stage's kSub sub-tiles of
  // [128 rows][128 values]: thread t takes BK / 32 of the 16-byte chunks,
  // one 16-byte load each, and writes its 32 values as two 16-byte chunks of
  // the swizzled stage row, the high nibbles of the 16 bytes, then the low
  // ones. Each 8 lanes read 128 consecutive bytes and write 8 distinct bank
  // groups: the even chunks of one row and the odd ones of the next, or
  // (two sub-tiles) one row's chunks, the second sub-tile's lanes storing
  // their odd chunk first.
  __device__ __forceinline__ static void rewrite(const uint8_t* raw, uint8_t* stage, int t) {
    constexpr int kChunks = kRowPacked / 16;  // 16-byte chunks of a raw row
#pragma unroll
    for (int it = 0; it < BK / 32; ++it) {
      const int u = it * 128 + t, r = u / kChunks, c = u % kChunks, sub = c / 4, cc = c % 4;
      const uint4 p = *reinterpret_cast<const uint4*>(raw + kRawTile + r * kRowPacked + c * 16);
      const uint4 hi = make_uint4(hi_nibbles(p.x), hi_nibbles(p.y), hi_nibbles(p.z), hi_nibbles(p.w));
      const uint4 lo = make_uint4(lo_nibbles(p.x), lo_nibbles(p.y), lo_nibbles(p.z), lo_nibbles(p.w));
      uint8_t* row = stage + sub * kTileBytes + r * kRowBytes;
      *reinterpret_cast<uint4*>(row + (((2 * cc + sub) ^ (r & 7)) << 4)) = sub ? lo : hi;
      *reinterpret_cast<uint4*>(row + (((2 * cc + 1 - sub) ^ (r & 7)) << 4)) = sub ? hi : lo;
    }
  }
  // The A fragments of the BK / 32 wgmma K steps (32 values each) for tile
  // rows r and r + 8 of the raw slot: register i of step kk holds, for lane
  // % 4 = q, the high (i = 0, 1) or low (i = 2, 3) nibbles of packed bytes
  // 16 kk + 4 q .. + 3 of row r (i even) or r + 8, at wgmma's K positions 4 q
  // .. 4 q + 3 (+ 16 for the low ones): the K order of b's stage.
  __device__ __forceinline__ static void a_frags(const uint8_t* raw, int r, int q, uint32_t (&a)[BK / 32][4]) {
    const int sw = kSub == 1 ? (r >> 1) & 3 : r & 7;  // the swizzle of rows r and r + 8
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      const int off = r * kRowPacked + ((kk ^ sw) << 4) + 4 * q;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(raw + off);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(raw + off + 8 * kRowPacked);
      a[kk][0] = hi_nibbles(w0), a[kk][1] = hi_nibbles(w1), a[kk][2] = lo_nibbles(w0), a[kk][3] = lo_nibbles(w1);
    }
  }
};
using S4KMajor = S4KMajorT<256>;

// 4 words holding rows 0-3 of a 4 x 4 byte block -> its columns, in place.
__device__ __forceinline__ void transpose4x4(uint32_t& a, uint32_t& b, uint32_t& c, uint32_t& d) {
  const uint32_t t0 = __byte_perm(a, b, 0x5140), t1 = __byte_perm(a, b, 0x7362);  // a0 b0 a1 b1 / a2 b2 a3 b3
  const uint32_t t2 = __byte_perm(c, d, 0x5140), t3 = __byte_perm(c, d, 0x7362);  // c0 d0 c1 d1 / c2 d2 c3 d3
  a = __byte_perm(t0, t2, 0x5410);  // a0 b0 c0 d0
  b = __byte_perm(t0, t2, 0x7632);  // a1 b1 c1 d1
  c = __byte_perm(t1, t3, 0x5410);
  d = __byte_perm(t1, t3, 0x7632);
}

struct S8MnMajor {  // B2: a [K, M], b [K, N] int8
  using Acc = int;
  static constexpr int BK = 128, kStages = 4, kRawSlots = 2, kAccShift = 0;
  static constexpr int kRawTile = BK * 128;  // one operand's K step: 128 K rows x 128 bytes of M (N)
  static constexpr int kLoadBytes = 2 * kRawTile, kStageSize = kStageBytes;
  static constexpr bool kMnB = false, kRewrite = true, kAInRegs = false, kATma = false;
  static cudaError_t encode(CUtensorMap* map, const void* base, int rows, int K, int /*operand*/) {
    return encode_2d(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, base, rows, K, rows, 128, BK, CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  __device__ static void load(uint32_t dst, const CUtensorMap* ta, const CUtensorMap* tb, int kt, int m0, int n0,
                              uint32_t bar) {
    tma_load(dst, ta, m0, kt * BK, bar);
    tma_load(dst + kRawTile, tb, n0, kt * BK, bar);
  }
  // Raw: per operand [128 k][128 m], dense. Thread t transposes one 16 x 16
  // byte block of operand t / 64: K chunk kb (16 k) by M chunk mb (16 m),
  // sixteen 16-byte loads down its k rows, sixteen 4 x 4 transposes in
  // registers, sixteen 16-byte stores along its m rows (stage chunk kb of
  // row m, swizzled). Within each 8 lanes kb runs over 0..7 and mb = kb + i
  // (mod 8) for the 8-lane group i, so every load phase reads 8 distinct M
  // chunks and every store phase writes 8 distinct K chunks: no bank
  // conflict either way.
  __device__ __forceinline__ static void rewrite(const uint8_t* raw, uint8_t* stage, int t) {
    const int op = t >> 6, u = t & 63, kb = u & 7, mb = (kb + (u >> 3)) & 7;
    const uint8_t* src = raw + op * kRawTile + kb * 16 * 128 + mb * 16;
    uint32_t v[16][4];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const uint4 x = *reinterpret_cast<const uint4*>(src + i * 128);
      v[i][0] = x.x, v[i][1] = x.y, v[i][2] = x.z, v[i][3] = x.w;
    }
    // word q of k row 4 w + r holds m 4 q .. 4 q + 3: after the transpose,
    // v[4 w + c][q] holds k 4 w .. 4 w + 3 of m row 4 q + c
#pragma unroll
    for (int w = 0; w < 4; ++w)
#pragma unroll
      for (int q = 0; q < 4; ++q) transpose4x4(v[4 * w][q], v[4 * w + 1][q], v[4 * w + 2][q], v[4 * w + 3][q]);
    uint8_t* dst = stage + op * kTileBytes + mb * 16 * kRowBytes;
#pragma unroll
    for (int j = 0; j < 16; ++j) {  // m row 16 mb + j = 4 q + c: words k 4 w.. of v[4 w + c][q]
      const int q = j / 4, c = j % 4;
      *reinterpret_cast<uint4*>(dst + j * kRowBytes + ((kb ^ (j & 7)) << 4)) =
          make_uint4(v[c][q], v[4 + c][q], v[8 + c][q], v[12 + c][q]);
    }
  }
};

// B1, B15's int8 form and B17's: a [M, K] K-major lands by TMA in the stage,
// as K2's; b [K, N] MN-major lands raw and the producer transposes it into
// the stage's b half.
struct S8MnB {
  using Acc = int;
  static constexpr int BK = 128, kStages = 4, kRawSlots = 4, kAccShift = 0;
  static constexpr int kRawTile = BK * 128;  // b's K step: 128 K rows x 128 bytes of N
  static constexpr int kLoadBytes = kRawTile, kStageSize = kStageBytes;
  static constexpr bool kMnB = false, kRewrite = true, kAInRegs = false, kATma = true;
  static cudaError_t encode(CUtensorMap* map, const void* base, int rows, int K, int operand) {
    return operand == 0 ? encode_2d(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, base, K, rows, K, kRowBytes, 128)
                        : encode_2d(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, base, rows, K, rows, 128, BK,
                                    CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  __device__ static void load(uint32_t dst, const CUtensorMap*, const CUtensorMap* tb, int kt, int, int n0,
                              uint32_t bar) {
    tma_load(dst, tb, n0, kt * BK, bar);
  }
  __device__ static void load_a(uint32_t dst, const CUtensorMap* ta, int kt, int m0, uint32_t bar) {
    tma_load(dst, ta, kt * BK, m0, bar);
  }
  // Raw: b's [128 k][128 n], dense. Thread t transposes half of one 16 x 16
  // byte block, K chunk kb by N chunk nb: its 8 n columns 8 h .. 8 h + 7 (h
  // = t % 2), sixteen 8-byte loads down its k rows, eight 4 x 4 transposes
  // in registers, eight 16-byte stores along its n rows (stage chunk kb of
  // row n, swizzled). Within each 16 lanes kb runs over 0..7 and nb = kb + i
  // (mod 8) for the 16-lane group i, so each load phase (16 lanes of 8
  // bytes) reads 16 distinct 8-byte columns. Lane h = 1 keeps its two words
  // swapped, so that in each store where an h = 0 lane writes row r of its
  // half, its neighbour writes row r ^ 4: each 8-lane store phase writes 8
  // distinct K chunks.
  __device__ __forceinline__ static void rewrite(const uint8_t* raw, uint8_t* stage, int t) {
    const int h = t & 1, u = t >> 1, kb = u & 7, nb = (kb + (u >> 3)) & 7;
    const uint8_t* src = raw + kb * 16 * 128 + nb * 16 + h * 8;
    uint32_t v[16][2];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const uint2 x = *reinterpret_cast<const uint2*>(src + i * 128);
      v[i][0] = h ? x.y : x.x, v[i][1] = h ? x.x : x.y;
    }
    // word q of k row 4 w + r holds n 4 (q ^ h) .. + 3 of the half: after the
    // transpose, v[4 w + c][q] holds k 4 w .. 4 w + 3 of n row 8 h + 4 (q ^
    // h) + c of the block
#pragma unroll
    for (int w = 0; w < 4; ++w)
#pragma unroll
      for (int q = 0; q < 2; ++q) transpose4x4(v[4 * w][q], v[4 * w + 1][q], v[4 * w + 2][q], v[4 * w + 3][q]);
    uint8_t* dst = stage + kTileBytes + nb * 16 * kRowBytes;
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = 8 * h + 4 * (q ^ h) + c;
        *reinterpret_cast<uint4*>(dst + j * kRowBytes + ((kb ^ (j & 7)) << 4)) =
            make_uint4(v[c][q], v[4 + c][q], v[8 + c][q], v[12 + c][q]);
      }
  }
};

// 4 e4m3 bytes -> 4 fp16 values in order, as two words (exact: fp16 holds
// every e4m3 value).
__device__ __forceinline__ uint2 widen_e4m3(uint32_t w) {
  uint32_t lo, hi;
  asm("{\n .reg .b16 l, h;\n mov.b32 {l, h}, %2;\n cvt.rn.f16x2.e4m3x2 %0, l;\n cvt.rn.f16x2.e4m3x2 %1, h;\n}"
      : "=r"(lo), "=r"(hi)
      : "r"(w));
  return make_uint2(lo, hi);
}

// B15's e4m3 form: a [M, K] and b [K, N] e4m3 land raw, 64 values of K a
// step, and the producer widens both to fp16, into exactly the stage TMA
// gives B17's bf16 a and b (Bf16MnB): a's [128 m][64 k] and b's two [64
// k][64 n] halves, 128-byte rows swizzled. The consumers run fp16 wgmma
// with b MN-major (the transpose bit), whose fp32 sums keep the products
// exact: e4m3 wgmma's own accumulation rounds more coarsely than the fp32
// roundings B15's tolerance allows (ab_sm90_forms.py's diag_b15_e4m3_wgmma).
struct E4m3F16 {
  using Acc = float;
  static constexpr int BK = 64, kStages = 5, kRawSlots = 3, kAccShift = 0;
  static constexpr int kRawA = 128 * BK;  // a's K step: 128 rows x 64 bytes (64-byte swizzle); b's: 64 x 128
  static constexpr int kLoadBytes = 2 * kRawA, kStageSize = kStageBytes;
  static constexpr bool kMnB = true, kRewrite = true, kAInRegs = false, kATma = false;
  static cudaError_t encode(CUtensorMap* map, const void* base, int rows, int K, int operand) {
    return operand == 0 ? encode_2d(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, base, K, rows, K, BK, 128,
                                    CU_TENSOR_MAP_SWIZZLE_64B)
                        : encode_2d(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, base, rows, K, rows, 128, BK,
                                    CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  __device__ static void load(uint32_t dst, const CUtensorMap* ta, const CUtensorMap* tb, int kt, int m0, int n0,
                              uint32_t bar) {
    tma_load(dst, ta, kt * BK, m0, bar);
    tma_load(dst + kRawA, tb, n0, kt * BK, bar);
  }
  // 16 e4m3 bytes -> the two 16-byte chunks of 8 fp16 values each, at p0 and p1.
  __device__ __forceinline__ static void widen16(uint4 x, uint8_t* p0, uint8_t* p1) {
    const uint2 w0 = widen_e4m3(x.x), w1 = widen_e4m3(x.y), w2 = widen_e4m3(x.z), w3 = widen_e4m3(x.w);
    *reinterpret_cast<uint4*>(p0) = make_uint4(w0.x, w0.y, w1.x, w1.y);
    *reinterpret_cast<uint4*>(p1) = make_uint4(w2.x, w2.y, w3.x, w3.y);
  }
  // Thread t widens a's row t (4 chunks of 16 bytes, swizzled by the TMA's
  // 64-byte pattern, c ^ (r / 2) % 4) and b's k row t / 2, n half t % 2
  // (64 bytes, chunk (i + k + 2 hf) % 4 in its turn i); each 16 bytes make
  // the stage chunks 2 c and 2 c + 1 of its row. Every 8-lane phase of a
  // 16-byte load or store touches 8 distinct bank groups.
  __device__ __forceinline__ static void rewrite(const uint8_t* raw, uint8_t* stage, int t) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint4 x = *reinterpret_cast<const uint4*>(raw + t * 64 + ((c ^ ((t >> 1) & 3)) << 4));
      uint8_t* row = stage + t * kRowBytes;
      widen16(x, row + (((2 * c) ^ (t & 7)) << 4), row + (((2 * c + 1) ^ (t & 7)) << 4));
    }
    const int k = t >> 1, hf = t & 1;
    uint8_t* row = stage + kTileBytes + hf * (kTileBytes / 2) + k * kRowBytes;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = (i + k + 2 * hf) & 3;
      const uint4 x = *reinterpret_cast<const uint4*>(raw + kRawA + k * 128 + hf * 64 + c * 16);
      widen16(x, row + (((2 * c) ^ (k & 7)) << 4), row + (((2 * c + 1) ^ (k & 7)) << 4));
    }
  }
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// ---- epilogues: one output row, then its values ---------------------------

// K2, B1, B2, B16: ((float)acc * sa[r]) * sb[c] in fp32, rounded once to
// OT.
template <typename ST, typename OT>
struct ScaledOut {
  static constexpr bool kFold = false;
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
  static constexpr bool kFold = false;
  OT* out;
  struct Row {
    OT* p;
  };
  __device__ Row row(int r, int N) const { return {out + static_cast<int64_t>(r) * N}; }
  __device__ float value(const Row&, int, float acc) const { return acc; }
};

// B17's int8 form: the int32 sum as it is. An fp32 value would be exact only
// below 2^24, and 4096 products of int8 values reach 6.7e7.
struct IntOut {
  static constexpr bool kFold = false;
  int* out;
  struct Row {
    int* p;
  };
  __device__ Row row(int r, int N) const { return {out + static_cast<int64_t>(r) * N}; }
  __device__ int value(const Row&, int, int acc) const { return acc; }
};

// B15: the folded fp32 sum, rounded once to OT. sa [M / qm, n_qk] and sb
// [n_qk, N / qn] are the tile scales, kq the stages of a quant block (QK /
// 128).
template <typename ST, typename OT>
struct TileScaledOut {
  static constexpr bool kFold = true;
  const ST* sa;
  const ST* sb;
  OT* out;
  int M, N, qm, qn, n_qk, kq;
  struct Row {
    OT* p;
  };
  __device__ Row row(int r, int N_) const { return {out + static_cast<int64_t>(r) * N_}; }
  __device__ float value(const Row&, int, float acc) const { return acc; }
  // The producer's thread t (0..127): the scales of tile row t and tile
  // column t for K step kt's quant block (ragged rows and columns take the
  // last one's).
  __device__ float2 scales_of(int2 o, int kt, int t) const {
    const int kb = kt / kq, m = min(o.x + t, M - 1), n = min(o.y + t, N - 1);
    return make_float2(qt_sm90::to_f32(sa[static_cast<int64_t>(m / qm) * n_qk + kb]),
                       qt_sm90::to_f32(sb[static_cast<int64_t>(kb) * (N / qn) + n / qn]));
  }
};

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ void store1(int* p, int v) { *p = v; }
__device__ __forceinline__ void store2(int* p, int v0, int v1) { *reinterpret_cast<int2*>(p) = make_int2(v0, v1); }

// An accumulator as the epilogue takes it: an int32 sum shifted back by the
// form's kAccShift (exact: B16's sums are multiples of 256), an fp32 one as
// it is.
template <int Shift>
__device__ __forceinline__ int unscaled(int v) {
  return v >> Shift;
}
template <int Shift>
__device__ __forceinline__ float unscaled(float v) {
  return v;
}

// ---- the kernel -------------------------------------------------------------

template <class Form>
constexpr int smem_bytes() {  // the stages, the raw slots, and the slack to align the ring to 1 KB
  return Form::kStages * Form::kStageSize + Form::kRawSlots * Form::kLoadBytes + 1024;
}

// The output tiles a CTA computes: tiles run row-major over the grid of 128 x
// 128 tiles (tiles_n of them a row), and CTA b takes tiles b, b + gridDim.x,
// ... (one each where the grid has a CTA a tile). Its K steps are numbered
// on through its tiles, step g being K step g % nk of its tile g / nk, so
// the rings and their mbarrier phases run on across tiles: the producer
// fills the next tile's stages while the consumers finish this one's.
struct TileWalk {
  int tiles_n, tiles, nk;
  __device__ int count() const {
    return (tiles - static_cast<int>(blockIdx.x) + static_cast<int>(gridDim.x) - 1) / static_cast<int>(gridDim.x);
  }
  __device__ int2 origin(int i) const {  // (m0, n0) of the CTA's tile i
    const int t = blockIdx.x + i * gridDim.x;
    return make_int2((t / tiles_n) * kBM, (t % tiles_n) * kBN);
  }
};

// The place of a CTA's K steps in turn: its K step kt of tile i at o = (m0,
// n0). It moves one step at a time, dividing once a tile rather than once a
// step: the producer's loads of the next step wait on it.
struct StepCursor {
  TileWalk walk;
  int kt = 0, i = 0;
  int2 o;
  __device__ explicit StepCursor(const TileWalk& w) : walk(w), o(w.origin(0)) {}
  __device__ void next() {
    if (++kt == walk.nk) {
      kt = 0;
      o = walk.origin(++i);
    }
  }
};

// The producer of a rewrite form: thread 0 keeps K steps of loads in flight
// in the raw ring; all 128 threads rewrite each raw slot into its stage, in
// order. A raw slot is loaded again once nothing reads it: with a in
// registers, once the consumers have taken a's fragments from it (raw_empty,
// a count of 8 warps; they do so as they start the step, so by the time the
// producer may refill stage s, every raw slot up to that stage's last step is
// free, and the ring runs kRawSlots - kStages loads ahead of the rewrite);
// otherwise once the producer itself is done with it (a named barrier).
// Where a lands by TMA (kATma), thread 0 loads it into the stage as soon as
// the stage is free, counted on the stage's full mbarrier. With a fold
// epilogue the 128 threads also write the scales beside a quant block's last
// stage, loaded from device memory as the step starts, so that their
// latency passes under the wait for the stage and the rewrite.
template <class Form, class Epi>
__device__ __forceinline__ void produce_rewritten(const CUtensorMap* ta, const CUtensorMap* tb, uint8_t* ring,
                                                  uint32_t full0, uint32_t empty0, uint32_t raw_full0,
                                                  uint32_t raw_empty0, const TileWalk& walk, const Epi& epi,
                                                  float* scales) {
  constexpr int S = Form::kStages, R = Form::kRawSlots;
  static_assert(!Form::kAInRegs || R >= S, "a raw slot is free once the consumers start its step");
  const int t = threadIdx.x % 128, steps = walk.count() * walk.nk;
  uint8_t* raw = ring + S * Form::kStageSize;
  const uint32_t raw_u32 = smem_u32(raw), ring_u32 = smem_u32(ring);
  StepCursor load(walk);  // the next step to load: steps load in order
  StepCursor at(walk);    // the step being rewritten
  const auto issue = [&](int g) {
    const uint32_t bar = raw_full0 + 8 * (g % R);
    mbar_expect_tx(bar, Form::kLoadBytes);
    Form::load(raw_u32 + (g % R) * Form::kLoadBytes, ta, tb, load.kt, load.o.x, load.o.y, bar);
    load.next();
  };
  if (t == 0)
    for (int g = 0; g < R && g < steps; ++g) issue(g);
  for (int g = 0; g < steps; ++g, at.next()) {
    const int s = g % S, use = g / S;
    float2 sc = make_float2(0.0f, 0.0f);
    bool fold_stage = false;  // the quant block's last stage: its scales go beside it
    if constexpr (Epi::kFold) {
      fold_stage = (at.kt + 1) % epi.kq == 0;
      if (fold_stage) sc = epi.scales_of(at.o, at.kt, t);
    }
    if (use > 0) mbar_wait(empty0 + 8 * s, (use - 1) & 1);
    if constexpr (Form::kATma) {
      if (t == 0) {
        mbar_expect_tx(full0 + 8 * s, kTileBytes);
        Form::load_a(ring_u32 + s * Form::kStageSize, ta, at.kt, at.o.x, full0 + 8 * s);
      }
    }
    if constexpr (Form::kAInRegs) {
      const int j = g - S + R;  // into the raw slot of step g - S, which the consumers are done with
      if (t == 0 && use > 0 && j < steps) {
        mbar_wait(raw_empty0 + 8 * (j % R), (j / R - 1) & 1);
        issue(j);
      }
    }
    mbar_wait(raw_full0 + 8 * (g % R), (g / R) & 1);
    Form::rewrite(raw + (g % R) * Form::kLoadBytes, ring + s * Form::kStageSize, t);
    if (fold_stage) scales[s * 256 + t] = sc.x, scales[s * 256 + 128 + t] = sc.y;
    fence_proxy_async();
    mbar_arrive(full0 + 8 * s);
    if constexpr (!Form::kAInRegs) {
      producer_sync();  // every thread is done reading the raw slot: load it again
      if (t == 0 && g + R < steps) issue(g + R);
    }
  }
}

// One K step's MMAs of a consumer warpgroup on stage s (its a rows at sa, b
// at sb): four 32-byte K steps of the 128-byte rows, or of bf16 b MN-major
// four 16-row K steps.
template <class Form>
__device__ __forceinline__ void stage_mma(typename Form::Acc (&d)[64], uint32_t sa, uint32_t sb) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t da = smem_desc(sa + 32 * kk, 16, 1024);
    const uint64_t db = Form::kMnB ? smem_desc(sb + 16 * kRowBytes * kk, kTileBytes / 2, 1024)
                                   : smem_desc(sb + 32 * kk, 16, 1024);
    if constexpr (std::is_same_v<Form, E4m3F16>) {
      wgmma_f16(d, da, db);
    } else {
      wgmma(d, da, db);
    }
  }
}

// A consumer warpgroup's 64 rows of a 128 x 128 tile at o, from v (wgmma's
// layout), through the epilogue, masked at the ragged edge.
template <int Shift, class Epi, typename V>
__device__ __forceinline__ void store_tile(const Epi& epi, const V (&v)[64], int2 o, int wg, int M, int N) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = o.x + wg * 64 + (warp % 4) * 16 + lane / 4, c0 = o.y + 2 * (lane % 4);
  const bool pairs = (N % 2) == 0;  // a pair of columns is one aligned 2-value store
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= M) continue;
    const auto rw = epi.row(r, N);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = c0 + 8 * j;
      const auto v0 = unscaled<Shift>(v[4 * j + 2 * h]);
      const auto v1 = unscaled<Shift>(v[4 * j + 2 * h + 1]);
      if (pairs && c + 1 < N) {
        store2(rw.p + c, epi.value(rw, c, v0), epi.value(rw, c + 1, v1));
      } else {
        if (c < N) store1(rw.p + c, epi.value(rw, c, v0));
        if (c + 1 < N) store1(rw.p + c + 1, epi.value(rw, c + 1, v1));
      }
    }
  }
}

__device__ __forceinline__ float as_f32(int v) { return __int2float_rn(v); }
__device__ __forceinline__ float as_f32(float v) { return v; }

// B15's fold of a consumer thread's 64 values: acc + (part * sa) * sb, each
// product and sum rounded on its own, with the scales of its rows (sc[rl],
// sc[rl + 8]) and columns (sc[cl + 8 j], + 1); part is zeroed.
template <typename P>
__device__ __forceinline__ void fold_block(float (&acc)[64], P (&part)[64], const float* sc, int rl, int cl) {
  const float s0 = sc[rl], s1 = sc[rl + 8];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 cb = *reinterpret_cast<const float2*>(sc + cl + 8 * j);
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // rows h = e / 2 (+ 8), columns + e % 2
      const int x = 4 * j + e;
      acc[x] = __fadd_rn(acc[x], __fmul_rn(__fmul_rn(as_f32(part[x]), e < 2 ? s0 : s1), e % 2 ? cb.y : cb.x));
      part[x] = 0;
    }
  }
}

// walk.nk: the K steps of a tile, ceil(K / Form::BK).
template <class Form, class Epi>
__global__ void __launch_bounds__(kThreads, 1)
gemm_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb, const Epi epi, int M,
            int N, const TileWalk walk) {
  constexpr int S = Form::kStages, R = Form::kRawSlots > 0 ? Form::kRawSlots : 1, kStage = Form::kStageSize;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[S], empty_bar[S], raw_full_bar[R], raw_empty_bar[R];
  // a fold's scales: per stage a's 128 row scales, then b's 128 column scales
  __shared__ float scales[Epi::kFold ? S : 1][Epi::kFold ? 256 : 1];
  // the ring: stage s holds a's tile at ring + s * kStage and b's kTileBytes
  // above it (b's alone where a is in registers); every tile starts on a 1
  // KB boundary (the swizzle atom); the raw slots of a rewrite form follow
  // the stages
  uint8_t* ring_ptr = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t ring = smem_u32(ring_ptr);
  const uint32_t full0 = smem_u32(full_bar), empty0 = smem_u32(empty_bar);
  const uint32_t raw_full0 = smem_u32(raw_full_bar), raw_empty0 = smem_u32(raw_empty_bar);
  const int wg = threadIdx.x / 128, nk = walk.nk;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, Form::kRewrite ? kProducerThreads + Form::kATma : 1);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    for (int s = 0; s < Form::kRawSlots; ++s) {
      mbar_init(raw_full0 + 8 * s, 1);
      mbar_init(raw_empty0 + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // the producer
    if constexpr (Epi::kFold) setmaxnreg_dec<56>();
    if constexpr (Form::kRewrite) {
      produce_rewritten<Form>(&ta, &tb, ring_ptr, full0, empty0, raw_full0, raw_empty0, walk, epi, &scales[0][0]);
    } else if (threadIdx.x == 256) {  // one thread keeps the ring full
      const int steps = walk.count() * nk;
      StepCursor load(walk);
      for (int g = 0; g < steps; ++g, load.next()) {
        const int s = g % S, use = g / S;
        if (use > 0) mbar_wait(empty0 + 8 * s, (use - 1) & 1);
        const uint32_t bar = full0 + 8 * s;
        mbar_expect_tx(bar, kStageBytes);
        Form::load(ring + s * kStage, &ta, &tb, load.kt, load.o.x, load.o.y, bar);
      }
    }
    return;
  }

  // a consumer warpgroup: rows [64 wg, 64 wg + 64) of each tile
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, tiles = walk.count();
  if constexpr (Epi::kFold) {
    // B15: per quant block (kq stages) the block's partial in one of two
    // sets, part0 for even blocks, part1 for odd ones; block b is folded
    // into acc once block b + 1's first MMAs are issued and block b's are
    // done, with the scales the producer wrote beside block b's last stage,
    // so that the fold runs under the next block's MMAs (ab_sm90_forms.py's
    // fold_wait waits for the block's own MMAs instead: int8 7-9% slower,
    // e4m3 within 4% either way)
    setmaxnreg_inc<224>();
    typename Form::Acc part0[64], part1[64];
    float acc[64];
    const int rl = wg * 64 + (warp % 4) * 16 + lane / 4, cl = 128 + 2 * (lane % 4);  // this thread's scales
    for (int i = 0; i < tiles; ++i) {
      const int g0 = i * nk, nb = nk / epi.kq;
#pragma unroll
      for (int j = 0; j < 64; ++j) part0[j] = 0, part1[j] = 0, acc[j] = 0.0f;
      const auto block = [&](int b, auto& cur, auto& prev) {
        for (int j = 0; j < epi.kq; ++j) {
          const int kt = b * epi.kq + j, g = g0 + kt, s = g % S;
          mbar_wait(full0 + 8 * s, (g / S) & 1);
          fence_operands(cur);
          fence_operands(prev);
          wgmma_fence();
          stage_mma<Form>(cur, ring + s * kStage + wg * 64 * kRowBytes, ring + s * kStage + kTileBytes);
          wgmma_commit();
          fence_operands(cur);
          wgmma_wait<1>();  // step g - 1's MMAs are done
          fence_operands(prev);
          if (kt == 0) continue;
          if (j == 0) {  // step g - 1 ended block b - 1
            fold_block(acc, prev, scales[(g - 1) % S], rl, cl);
            __syncwarp();  // every lane has read the stage's scales
          }
          if (lane == 0) mbar_arrive(empty0 + 8 * ((g - 1) % S));
        }
      };
      for (int b = 0; b < nb; b += 2) {
        block(b, part0, part1);
        if (b + 1 < nb) block(b + 1, part1, part0);
      }
      wgmma_wait<0>();
      fence_operands(part0);
      fence_operands(part1);
      const int last = (g0 + nk - 1) % S;  // the tile's last block, in part0 where nb is odd
      if (nb & 1) {
        fold_block(acc, part0, scales[last], rl, cl);
      } else {
        fold_block(acc, part1, scales[last], rl, cl);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * last);
      store_tile<0>(epi, acc, walk.origin(i), wg, M, N);
    }
  } else {
    typename Form::Acc d[64];
    for (int i = 0; i < tiles; ++i) {
      const int g0 = i * nk;  // the tile's first step
#pragma unroll
      for (int j = 0; j < 64; ++j) d[j] = 0;
      if constexpr (Form::kAInRegs) {
        // a's fragments from the raw slot, held until the step's MMAs are done:
        // two sets, for steps kt and kt + 1, so the loop runs two steps a turn
        constexpr int kSteps = Form::BK / 32;  // wgmma K steps a stage
        const uint8_t* raw = ring_ptr + S * kStage;
        const int ra = wg * 64 + (warp % 4) * 16 + lane / 4;
        uint32_t a0[kSteps][4], a1[kSteps][4];
        const auto step = [&](int kt, uint32_t (&a)[kSteps][4]) {
          const int g = g0 + kt, s = g % S, rs = g % R;
          mbar_wait(full0 + 8 * s, (g / S) & 1);
          mbar_wait(raw_full0 + 8 * rs, (g / R) & 1);
          Form::a_frags(raw + rs * Form::kLoadBytes, ra, lane % 4, a);
          __syncwarp();
          if (lane == 0) mbar_arrive(raw_empty0 + 8 * rs);  // a's fragments are in registers
          const uint32_t sb = ring + s * kStage;
          fence_operands(d);
          fence_operands(a);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kSteps; ++kk)  // b's sub-tile kk / 4, 32-byte K step kk % 4
            wgmma(d, a[kk], smem_desc(sb + (kk / 4) * kTileBytes + 32 * (kk % 4), 16, 1024));
          wgmma_commit();
          fence_operands(d);
          wgmma_wait<1>();  // step g - 1's MMAs are done: release its stage
          if (kt > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((g - 1) % S));
        };
        for (int kt = 0; kt < nk; kt += 2) {
          step(kt, a0);
          if (kt + 1 < nk) step(kt + 1, a1);
        }
        wgmma_wait<0>();
        fence_operands(a0);
        fence_operands(a1);
      } else {
        for (int kt = 0; kt < nk; ++kt) {
          const int g = g0 + kt, s = g % S;
          mbar_wait(full0 + 8 * s, (g / S) & 1);
          fence_operands(d);
          wgmma_fence();
          stage_mma<Form>(d, ring + s * kStage + wg * 64 * kRowBytes, ring + s * kStage + kTileBytes);
          wgmma_commit();
          fence_operands(d);
          wgmma_wait<1>();  // step g - 1's MMAs are done: release its stage
          if (kt > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((g - 1) % S));
        }
        wgmma_wait<0>();
      }
      fence_operands(d);
      if (lane == 0) mbar_arrive(empty0 + 8 * ((g0 + nk - 1) % S));  // the tile's last stage
      store_tile<Form::kAccShift>(epi, d, walk.origin(i), wg, M, N);
    }
  }
}

// ---- host side -------------------------------------------------------------

template <class Form, class Epi>
cudaError_t launch(const CUtensorMap& ta, const CUtensorMap& tb, const Epi& epi, int M, int N, int K,
                   cudaStream_t stream) {
  auto kernel = gemm_kernel<Form, Epi>;
  constexpr int smem = smem_bytes<Form>();
  static_assert(smem + (Epi::kFold ? 1024 * Form::kStages : 0) <= 232448,
                "over the 227 KB of shared memory a CTA can have");
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int tiles_n = (N + kBN - 1) / kBN;
  const TileWalk walk{tiles_n, ((M + kBM - 1) / kBM) * tiles_n, (K + Form::BK - 1) / Form::BK};
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int ctas = walk.tiles < sms ? walk.tiles : sms;  // one CTA an SM, each walking its tiles
  kernel<<<ctas, kThreads, smem, stream>>>(ta, tb, epi, M, N, walk);
  return cudaGetLastError();
}

// K2 (S8KMajor: a [M, K], b [N, K], K % 16 == 0), B1 (S8MnB: a [M, K], b
// [K, N], K % 16 == N % 16 == 0), B2 (S8MnMajor: a [K, M], b [K, N], M % 16
// == N % 16 == 0) and B16 (S4KMajor: a [M, K / 2], b [N, K / 2] packed, K %
// 32 == 0): int8 or packed operands, each 16-byte aligned, with the row x
// col scale epilogue; K > 0.
template <class Form, typename ST, typename OT>
cudaError_t scaled(const void* a, const void* b, const void* sa, const void* sb, void* out, int M, int N, int K,
                   cudaStream_t stream) {
  CUtensorMap ta, tb;
  cudaError_t err = Form::encode(&ta, a, M, K, 0);
  if (err == cudaSuccess) err = Form::encode(&tb, b, N, K, 1);
  if (err != cudaSuccess) return err;
  const ScaledOut<ST, OT> epi{static_cast<const ST*>(sa), static_cast<const ST*>(sb), static_cast<OT*>(out)};
  return launch<Form>(ta, tb, epi, M, N, K, stream);
}

// B15 at QK % 128 == 0 (S8MnB int8, E4m3F16 e4m3): a [M, K] and b [K, N],
// each 16-byte aligned, N % 16 == 0; sa [M / qm, K / qk] and sb [K / qk, N /
// qn], with qm dividing M, qk dividing K, qn dividing N.
template <class Form, typename ST, typename OT>
cudaError_t tile_scaled(const void* a, const void* b, const void* sa, const void* sb, void* out, int M, int N,
                        int K, int qm, int qk, int qn, cudaStream_t stream) {
  if (qk % Form::BK || K % qk || M % qm || N % qn) return cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  cudaError_t err = Form::encode(&ta, a, M, K, 0);
  if (err == cudaSuccess) err = Form::encode(&tb, b, N, K, 1);
  if (err != cudaSuccess) return err;
  const TileScaledOut<ST, OT> epi{static_cast<const ST*>(sa), static_cast<const ST*>(sb), static_cast<OT*>(out),
                                  M, N, qm, qn, K / qk, qk / Form::BK};
  return launch<Form>(ta, tb, epi, M, N, K, stream);
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

// B17 int8: a [M, K], b [K, N] int8, each 16-byte aligned, K % 16 == N % 16
// == 0, K > 0; out [M, N] int32, exact.
inline cudaError_t matmul_s8(const void* a, const void* b, void* out, int M, int N, int K, cudaStream_t stream) {
  CUtensorMap ta, tb;
  cudaError_t err = S8MnB::encode(&ta, a, M, K, 0);
  if (err == cudaSuccess) err = S8MnB::encode(&tb, b, N, K, 1);
  if (err != cudaSuccess) return err;
  return launch<S8MnB>(ta, tb, IntOut{static_cast<int*>(out)}, M, N, K, stream);
}

}  // namespace qt_sm90
