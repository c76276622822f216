// B6: the AdamW update of one parameter tensor on bf16 optimizer state, in
// one pass. Replaces quantized_training_tpu/ops/pallas_optim.py::
// fused_adamw_update (:79), the update of optim/adamw.py::adamw_bf16_sr.
//
// Per element, in the Pallas body's order (pallas_optim.py:52-75), every
// operation an IEEE fp32 intrinsic so that nvcc contracts nothing into an
// FMA and eager torch ops on the card give the same bits:
//   ea  = ea  + (1 - b1) * (g - ea)          stored bf16, used in fp32
//   eas = eas + (1 - b2) * (g * g - eas)     stored bf16, used in fp32
//   p'  = p - (lr * wd) * p - (lr * (ea / bc1)) / (sqrt(eas) / sqrt(bc2) + eps)
// with 1 - b1 and 1 - b2 formed in fp32 from the fp32 scalars, as the
// kernel forms them (the XLA path of adamw_bf16_sr takes Python doubles
// instead). With SR, the 16 low bits of element i's word of the Philox
// stream (philox.cuh) are added to p''s fp32 bit pattern, which is then cut
// to bf16 (pallas_optim.py:67-74); without it p' rounds to nearest even.
//
// What bounds it: device memory. A bf16 parameter costs 4 x 2 bytes read
// (p, g, ea, eas) and 3 x 2 bytes written, about 15 GB per step over the
// 1.1 B parameters of Llama2-1B, 5 ms at 3 TB/s; the math is ~20 flops and,
// with SR, two Philox calls per 8 elements. Design: a grid-stride loop in
// which each thread owns 8 consecutive elements, loaded as one 16-byte
// vector per bf16 tensor (two for fp32 p and g) and stored the same way;
// the tail of fewer than 8 elements, and any tensor not 16-byte aligned,
// takes a scalar loop.
//
// In place (new_p == p, new_ea == ea, new_eas == eas: a donated train
// state, optim/adamw.py) is an instantiation of its own (InPlace): p, ea
// and eas are read-write and the stores go through them, so no two of the
// kernel's __restrict__ pointers name one buffer. Each thread loads its
// elements of every input before it stores the same elements, and no
// thread touches another's, so the update gives the out-of-place bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;  // elements per thread and step: 16 bytes of bf16
constexpr int kMaxBlocks = 132 * 16;

struct Scalars {
  float lr, omb1, omb2, eps, bc1, sqrt_bc2, lr_wd;
};

// scalars: [7] fp32 on the device, (lr, b1, b2, wd, eps, bc1, bc2)
__device__ __forceinline__ Scalars load_scalars(const float* __restrict__ s) {
  return {s[0], __fsub_rn(1.0f, s[1]), __fsub_rn(1.0f, s[2]), s[4], s[5], __fsqrt_rn(s[6]), __fmul_rn(s[0], s[3])};
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// One element: returns p' and writes the new state to ea / eas (fp32,
// before the bf16 store).
template <typename P, bool SR>
__device__ __forceinline__ P step_one(float p, float g, float& ea, float& eas, const Scalars& s, uint32_t word) {
  ea = __fadd_rn(ea, __fmul_rn(s.omb1, __fsub_rn(g, ea)));
  eas = __fadd_rn(eas, __fmul_rn(s.omb2, __fsub_rn(__fmul_rn(g, g), eas)));
  const float denom = __fadd_rn(__fdiv_rn(__fsqrt_rn(eas), s.sqrt_bc2), s.eps);
  const float upd = __fdiv_rn(__fmul_rn(s.lr, __fdiv_rn(ea, s.bc1)), denom);
  const float np = __fsub_rn(__fsub_rn(p, __fmul_rn(s.lr_wd, p)), upd);
  if constexpr (sizeof(P) == 4) {
    return np;
  } else if constexpr (SR) {
    const uint32_t bits = (__float_as_uint(np) + (word & 0xFFFFu)) & 0xFFFF0000u;
    return __ushort_as_bfloat16(static_cast<unsigned short>(bits >> 16));
  } else {
    return __float2bfloat16_rn(np);
  }
}

// 8 elements of a P tensor as fp32, from 16 (bf16) or 32 (fp32) bytes.
__device__ __forceinline__ void load8(const __nv_bfloat16* __restrict__ x, int64_t c, float (&v)[kVec]) {
  const uint4 u = reinterpret_cast<const uint4*>(x)[c];
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int j = 0; j < kVec; ++j) v[j] = __bfloat162float(e[j]);
}

__device__ __forceinline__ void load8(const float* __restrict__ x, int64_t c, float (&v)[kVec]) {
  const uint4 a = reinterpret_cast<const uint4*>(x)[2 * c], b = reinterpret_cast<const uint4*>(x)[2 * c + 1];
  v[0] = __uint_as_float(a.x), v[1] = __uint_as_float(a.y), v[2] = __uint_as_float(a.z), v[3] = __uint_as_float(a.w);
  v[4] = __uint_as_float(b.x), v[5] = __uint_as_float(b.y), v[6] = __uint_as_float(b.z), v[7] = __uint_as_float(b.w);
}

__device__ __forceinline__ void store8(__nv_bfloat16* __restrict__ x, int64_t c, const __nv_bfloat16 (&v)[kVec]) {
  union {
    uint4 u;
    __nv_bfloat16 h[kVec];
  } pk;
#pragma unroll
  for (int j = 0; j < kVec; ++j) pk.h[j] = v[j];
  reinterpret_cast<uint4*>(x)[c] = pk.u;
}

__device__ __forceinline__ void store8(float* __restrict__ x, int64_t c, const float (&v)[kVec]) {
  reinterpret_cast<uint4*>(x)[2 * c] = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                                                  __float_as_uint(v[2]), __float_as_uint(v[3]));
  reinterpret_cast<uint4*>(x)[2 * c + 1] = make_uint4(__float_as_uint(v[4]), __float_as_uint(v[5]),
                                                      __float_as_uint(v[6]), __float_as_uint(v[7]));
}

// An operand the kernel also writes in place, else read-only.
template <typename T, bool InPlace>
using In = std::conditional_t<InPlace, T, const T>;

// Where a result goes: its operand in place, else its output.
template <bool InPlace, typename T>
__device__ __forceinline__ T* dest(In<T, InPlace>* in, T* out) {
  if constexpr (InPlace) {
    return in;
  } else {
    return out;
  }
}

template <typename P, bool SR, bool InPlace>
__global__ void __launch_bounds__(kThreads)
fused_adamw(In<P, InPlace>* __restrict__ p, const P* __restrict__ g, In<__nv_bfloat16, InPlace>* __restrict__ ea,
            In<__nv_bfloat16, InPlace>* __restrict__ eas, const float* __restrict__ scalars,
            P* __restrict__ out_p, __nv_bfloat16* __restrict__ out_ea, __nv_bfloat16* __restrict__ out_eas, int64_t n,
            bool vec, uint64_t key) {
  P* const new_p = dest<InPlace>(p, out_p);
  __nv_bfloat16* const new_ea = dest<InPlace>(ea, out_ea);
  __nv_bfloat16* const new_eas = dest<InPlace>(eas, out_eas);
  const Scalars s = load_scalars(scalars);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t full = vec ? n / kVec : 0;  // chunks of 8 taken as vectors
  for (int64_t c = first; c < full; c += stride) {
    float pv[kVec], gv[kVec], av[kVec], sv[kVec];
    load8(p, c, pv);
    load8(g, c, gv);
    load8(ea, c, av);
    load8(eas, c, sv);
    uint32_t w[kVec];
    if (SR) {
      qt::stream_words<kVec>(static_cast<uint64_t>(c) * kVec, key, w);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) w[j] = 0u;
    }
    P out[kVec];
    __nv_bfloat16 oa[kVec], os[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      out[j] = step_one<P, SR>(pv[j], gv[j], av[j], sv[j], s, w[j]);
      oa[j] = __float2bfloat16_rn(av[j]);
      os[j] = __float2bfloat16_rn(sv[j]);
    }
    store8(new_p, c, out);
    store8(new_ea, c, oa);
    store8(new_eas, c, os);
  }
  for (int64_t i = full * kVec + first; i < n; i += stride) {  // the ragged rest, one element each
    float a = __bfloat162float(ea[i]), v = __bfloat162float(eas[i]);
    new_p[i] = step_one<P, SR>(to_f32(p[i]), to_f32(g[i]), a, v, s, SR ? qt::philox_word(i, key) : 0u);
    new_ea[i] = __float2bfloat16_rn(a);
    new_eas[i] = __float2bfloat16_rn(v);
  }
}

bool aligned16(const void* x) { return reinterpret_cast<uintptr_t>(x) % 16 == 0; }

template <typename P, bool SR>
cudaError_t launch(const void* p, const void* g, const void* ea, const void* eas, const float* scalars,
                   void* new_p, void* new_ea, void* new_eas, int64_t n, uint64_t key, cudaStream_t stream) {
  const bool in_place = new_p == p && new_ea == ea && new_eas == eas;
  if (!in_place && (new_p == p || new_ea == ea || new_eas == eas)) return cudaErrorInvalidValue;
  const bool vec = aligned16(p) && aligned16(g) && aligned16(ea) && aligned16(eas) && aligned16(new_p) &&
                   aligned16(new_ea) && aligned16(new_eas);
  const int64_t work = vec ? (n + kVec - 1) / kVec : n;
  const unsigned int blocks =
      static_cast<unsigned int>(std::min<int64_t>(kMaxBlocks, (work + kThreads - 1) / kThreads));
  using B = __nv_bfloat16;
  if (in_place) {
    fused_adamw<P, SR, true><<<blocks, kThreads, 0, stream>>>(
        static_cast<P*>(new_p), static_cast<const P*>(g), static_cast<B*>(new_ea), static_cast<B*>(new_eas), scalars,
        nullptr, nullptr, nullptr, n, vec, key);
  } else {
    fused_adamw<P, SR, false><<<blocks, kThreads, 0, stream>>>(
        static_cast<const P*>(p), static_cast<const P*>(g), static_cast<const B*>(ea), static_cast<const B*>(eas),
        scalars, static_cast<P*>(new_p), static_cast<B*>(new_ea), static_cast<B*>(new_eas), n, vec, key);
  }
  return cudaGetLastError();
}

}  // namespace

// Returns the launch's cudaError_t (0 on success). p, g and new_p hold n
// elements of bf16 (p_is_bf16) or fp32; ea, eas, new_ea and new_eas n bf16;
// new_p, new_ea and new_eas are all p, ea and eas (in place) or none of them;
// scalars is [7] fp32 on the device: lr, b1, b2, wd, eps, bc1, bc2. sr (bf16
// p only): write p' back with stochastic rounding from the stream of key.
extern "C" int qt_fused_adamw(const void* p, const void* g, const void* ea, const void* eas, const void* scalars,
                              void* new_p, void* new_ea, void* new_eas, int64_t n, int p_is_bf16, int sr,
                              uint64_t key, void* stream) {
  if (n <= 0) return 0;
  if (sr && !p_is_bf16) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scalars);
  if (!p_is_bf16) return static_cast<int>(launch<float, false>(p, g, ea, eas, sc, new_p, new_ea, new_eas, n, key, s));
  return static_cast<int>(sr ? launch<__nv_bfloat16, true>(p, g, ea, eas, sc, new_p, new_ea, new_eas, n, key, s)
                             : launch<__nv_bfloat16, false>(p, g, ea, eas, sc, new_p, new_ea, new_eas, n, key, s));
}
