// Building blocks of the wmma GEMMs (scaled_mm.cu, tile_scaled_mm.cu,
// matmul.cu, int8_attention.cu): a
// thread's share of an operand tile, copied from device memory through
// registers into shared memory in 16x16 fragment blocks, and the address of
// one fragment there.
//
// An operand is stored K-major (its rows run along the contraction axis) or
// MN-major (the contraction axis is its slow axis). In shared memory a K-major
// tile is [K / 16][rows][16] (16-value chunks along K), an MN-major one
// [rows / 16][K][16] (16-value chunks along M or N), so every wmma fragment
// load is 256-bit aligned with a leading dimension of 16 and either layout is
// a plain row_major / col_major fragment.
//
// What device memory holds (Src) and what shared memory holds:
// - S8: int8, copied as it is;
// - S4: signed int4, two per byte, the even element in the high nibble
//   (K-major only): half the bytes cross device memory, and the load stage
//   sign-extends each 8-byte chunk to 16 int8 values in registers;
// - E4M3: fp8 e4m3, widened to fp16 on the way into shared memory (exact:
//   every e4m3 value is an fp16 value), since wmma has no fp8 fragment;
// - BF16: bf16, copied as it is (a 16-value chunk is 32 bytes).
//
// fetch() needs whole, 16-byte aligned chunks (K % 16 == 0 along a K-major
// operand, rows % 16 == 0 along an MN-major one) of 1-byte or packed values;
// fetch_masked() takes int8 or bf16 at any shape and zero-fills value by
// value at a ragged edge (matmul.cu).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace qt_mm {

enum class Src { S8, S4, E4M3, BF16 };

template <Src S>
using SmemT = std::conditional_t<S == Src::E4M3, __half, std::conditional_t<S == Src::BF16, __nv_bfloat16, int8_t>>;

// 16 bf16 values in registers
struct Raw32 {
  uint4 lo, hi;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// 8 packed bytes (16 signed nibbles, high nibble first) -> 16 int8 values.
// Per byte lane: (n ^ 8) - 8 sign-extends a nibble n; __byte_perm then
// interleaves the high and the low nibbles back into element order.
__device__ __forceinline__ uint4 unpack_s4(uint2 p) {
  uint32_t w[2] = {p.x, p.y}, o[4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint32_t hi = __vsub4(((w[i] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
    const uint32_t lo = __vsub4((w[i] & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
    o[2 * i] = __byte_perm(hi, lo, 0x5140);      // hi0 lo0 hi1 lo1
    o[2 * i + 1] = __byte_perm(hi, lo, 0x7362);  // hi2 lo2 hi3 lo3
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// 4 e4m3 bytes -> 4 fp16 values, in order, as two 32-bit words.
__device__ __forceinline__ uint2 widen_e4m3(uint32_t w) {
  const __half2_raw lo = __nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(w & 0xFFFFu), __NV_E4M3);
  const __half2_raw hi = __nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(w >> 16), __NV_E4M3);
  return make_uint2(lo.x | (static_cast<uint32_t>(lo.y) << 16), hi.x | (static_cast<uint32_t>(hi.y) << 16));
}

// One thread's share of an operand tile, rows [r0, r0 + R) x contraction
// [k0, k0 + BK): fetch() reads its chunks of 16 values into registers,
// zero-filling outside [0, rows) x [0, K); store() writes them to shared
// memory, unpacked or widened. K-major: src is [rows, K] (K / 2 bytes a row
// for S4); MN-major: src is [K, rows] with rows % 16 == 0. Consecutive threads
// read consecutive chunks, and a thread issues all of its loads before it
// waits on any.
template <int R, int BK, int NT, bool KMAJOR, Src S = Src::S8>
struct TileCopy {
  static_assert(S != Src::S4 || KMAJOR, "packed int4 operands are K-major");
  static constexpr int CH = KMAJOR ? BK / 16 : R / 16;  // chunks along the contiguous axis
  static constexpr int ITERS = R * BK / 16 / NT;
  static_assert(R * BK / 16 % NT == 0, "every thread copies the same number of chunks");
  // 16 values in device memory
  using Raw = std::conditional_t<S == Src::S4, uint2, std::conditional_t<S == Src::BF16, Raw32, uint4>>;
  Raw v[ITERS];

  __device__ __forceinline__ void fetch(const void* __restrict__ src, int r0, int rows, int k0, int K) {
    static_assert(S != Src::BF16, "bf16 operands load through fetch_masked");
    const uint8_t* base = static_cast<const uint8_t*>(src);
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int idx = threadIdx.x + it * NT, slow = idx / CH, c = idx % CH;
      bool inside;
      int64_t off;  // in values
      if constexpr (KMAJOR) {  // slow: the tile row; c: the K chunk
        const int gr = r0 + slow, gk = k0 + c * 16;
        inside = gr < rows && gk < K;  // K % 16 == 0: a chunk is wholly inside or outside
        off = static_cast<int64_t>(gr) * K + gk;
      } else {  // slow: the k index; c: the row chunk
        const int gk = k0 + slow, gr = r0 + c * 16;
        inside = gk < K && gr < rows;  // rows % 16 == 0: likewise
        off = static_cast<int64_t>(gk) * rows + gr;
      }
      if constexpr (S == Src::S4) {
        v[it] = inside ? *reinterpret_cast<const uint2*>(base + off / 2) : make_uint2(0u, 0u);
      } else {
        v[it] = inside ? *reinterpret_cast<const uint4*>(base + off) : make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }

  // fetch() for any shape (S8 and BF16): a chunk wholly inside [0, rows) x
  // [0, K) is one vector load where ``vec`` (the operand's rows start on
  // 16-byte boundaries), every other chunk is read value by value, zero
  // outside.
  __device__ __forceinline__ void fetch_masked(const void* __restrict__ src, int r0, int rows, int k0, int K,
                                               bool vec) {
    static_assert(S == Src::S8 || S == Src::BF16, "masked loads of unpacked operands");
    using V = std::conditional_t<S == Src::BF16, uint16_t, uint8_t>;
    const V* base = static_cast<const V*>(src);
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int idx = threadIdx.x + it * NT, slow = idx / CH, c = idx % CH;
      // the chunk's first value (gr, gk), its offset, and how many of its
      // (consecutive) values lie inside
      int gr, gk, n_in;
      int64_t off;
      if constexpr (KMAJOR) {
        gr = r0 + slow, gk = k0 + c * 16;
        n_in = gr < rows ? min(16, max(0, K - gk)) : 0;
        off = static_cast<int64_t>(gr) * K + gk;
      } else {
        gk = k0 + slow, gr = r0 + c * 16;
        n_in = gk < K ? min(16, max(0, rows - gr)) : 0;
        off = static_cast<int64_t>(gk) * rows + gr;
      }
      if (n_in == 16 && vec) {
        const uint4* p = reinterpret_cast<const uint4*>(base + off);
        if constexpr (S == Src::BF16) {
          v[it] = Raw32{p[0], p[1]};
        } else {
          v[it] = p[0];
        }
      } else {
        V vals[16];
#pragma unroll
        for (int e = 0; e < 16; ++e) vals[e] = e < n_in ? base[off + e] : V(0);
        uint32_t w[8];
#pragma unroll
        for (int e = 0; e < 16 / (4 / sizeof(V)); ++e) {
          if constexpr (sizeof(V) == 2) {
            w[e] = vals[2 * e] | (static_cast<uint32_t>(vals[2 * e + 1]) << 16);
          } else {
            w[e] = vals[4 * e] | (static_cast<uint32_t>(vals[4 * e + 1]) << 8) |
                   (static_cast<uint32_t>(vals[4 * e + 2]) << 16) | (static_cast<uint32_t>(vals[4 * e + 3]) << 24);
          }
        }
        if constexpr (S == Src::BF16) {
          v[it] = Raw32{make_uint4(w[0], w[1], w[2], w[3]), make_uint4(w[4], w[5], w[6], w[7])};
        } else {
          v[it] = make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
    }
  }

  __device__ __forceinline__ void store(SmemT<S>* __restrict__ dst) const {
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int idx = threadIdx.x + it * NT, slow = idx / CH, c = idx % CH;
      SmemT<S>* p = dst + (KMAJOR ? c * R + slow : c * BK + slow) * 16;
      if constexpr (S == Src::S8) {
        *reinterpret_cast<uint4*>(p) = v[it];
      } else if constexpr (S == Src::BF16) {
        reinterpret_cast<uint4*>(p)[0] = v[it].lo;
        reinterpret_cast<uint4*>(p)[1] = v[it].hi;
      } else if constexpr (S == Src::S4) {
        *reinterpret_cast<uint4*>(p) = unpack_s4(v[it]);
      } else {
        const uint2 h0 = widen_e4m3(v[it].x), h1 = widen_e4m3(v[it].y);
        const uint2 h2 = widen_e4m3(v[it].z), h3 = widen_e4m3(v[it].w);
        reinterpret_cast<uint4*>(p)[0] = make_uint4(h0.x, h0.y, h1.x, h1.y);
        reinterpret_cast<uint4*>(p)[1] = make_uint4(h2.x, h2.y, h3.x, h3.y);
      }
    }
  }
};

// The 16x16 fragment at contraction chunk c and tile row r (a multiple of 16).
template <int R, int BK, bool KMAJOR, typename T>
__device__ __forceinline__ const T* frag(const T* tile, int c, int r) {
  return tile + (KMAJOR ? (c * R + r) * 16 : ((r / 16) * BK + c * 16) * 16);
}

}  // namespace qt_mm
