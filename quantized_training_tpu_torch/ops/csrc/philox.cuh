// The port's random stream on the card: Philox4x32-10 (Salmon et al.,
// SC'11; the Random123 constants), the counterpart of the TPU's in-kernel
// generator (pltpu.prng_seed / prng_random_bits in ops/pallas_quant.py and
// ops/pallas_optim.py). ops/random.py computes the same words in torch, so
// a kernel that draws from here is bit-exact with its plain version.
//
// A key is a 64-bit value (two 32-bit key words, low first). Element i of
// the key's stream is word i % 4 of the block at counter (i / 4 low word,
// i / 4 high word, 0, 0): one Philox call feeds four elements. A Philox call
// is 10 rounds of two 32x32->64 multiplies and four xors, so the kernels
// that call it once per four elements stay bound by memory.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace qt {

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

// Words 4 * block .. 4 * block + 3 of the stream of ``key``.
__device__ __forceinline__ uint4 philox_block(uint64_t block, uint64_t key) {
  return philox4x32_10(make_uint4(static_cast<uint32_t>(block), static_cast<uint32_t>(block >> 32), 0u, 0u),
                       static_cast<uint32_t>(key), static_cast<uint32_t>(key >> 32));
}

__device__ __forceinline__ uint32_t word_of(const uint4& r, int j) {
  return j == 0 ? r.x : j == 1 ? r.y : j == 2 ? r.z : r.w;
}

// Word ``idx`` of the stream (one Philox call for one element: the ragged
// paths only).
__device__ __forceinline__ uint32_t philox_word(uint64_t idx, uint64_t key) {
  return word_of(philox_block(idx >> 2, key), static_cast<int>(idx & 3));
}

// U[0, 1) = (word >> 8) * 2^-24, exact in fp32 (ops/random.py::uniform).
__device__ __forceinline__ float uniform_of(uint32_t w) {
  return __fmul_rn(static_cast<float>(w >> 8), 5.9604644775390625e-08f);
}

// Words idx0 .. idx0 + N - 1 of the stream, for idx0 % 4 == 0 and N % 4 == 0.
template <int N>
__device__ __forceinline__ void stream_words(uint64_t idx0, uint64_t key, uint32_t (&w)[N]) {
#pragma unroll
  for (int b = 0; b < N / 4; ++b) {
    const uint4 r = philox_block((idx0 >> 2) + b, key);
    w[4 * b] = r.x;
    w[4 * b + 1] = r.y;
    w[4 * b + 2] = r.z;
    w[4 * b + 3] = r.w;
  }
}

}  // namespace qt
