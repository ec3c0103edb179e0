// attn_elem: element access shared by the attention kernels (sm_90a).
//
// Shared by decode_attention.cu and flash_attention.cu. Inputs are f32 or
// bf16; bf16 is handled as its raw 16 bits (unsigned short) and widened
// with the cuda_bf16.h intrinsics, so no __nv_bfloat16 sits in a union or
// an array. Arithmetic is f32 throughout; an output is rounded to the
// input's type once, round-to-nearest-even (as torch's .to(bfloat16)).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

constexpr float kNegInf = -1e30f;  // repro_torch.constants.NEG_INF

template <typename Raw>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ float unpack(float r) { return r; }
  static __device__ __forceinline__ float pack(float x) { return x; }
};

template <>
struct Elem<unsigned short> {  // bf16 bits
  static __device__ __forceinline__ float load(const unsigned short* p) {
    return __bfloat162float(__ushort_as_bfloat16(*p));
  }
  static __device__ __forceinline__ float unpack(unsigned short r) {
    return __bfloat162float(__ushort_as_bfloat16(r));
  }
  static __device__ __forceinline__ unsigned short pack(float x) {
    return __bfloat16_as_ushort(__float2bfloat16(x));
  }
};

// N consecutive elements starting at p, widened to f32. With vec the
// caller guarantees that p is aligned to N * sizeof(Raw) bytes (N is a
// power of two, at most 16 bytes a load) and all N are in bounds; without
// it, elements at or past `limit` read as 0.
template <typename Raw, int N>
__device__ __forceinline__ void load_n(const Raw* __restrict__ p, bool vec,
                                       int limit, float (&out)[N]) {
  constexpr int kBytes = N * (int)sizeof(Raw);
  if (vec) {
    if constexpr (kBytes % 16 == 0) {
      union {
        uint4 u[kBytes / 16];
        Raw r[N];
      } buf;
#pragma unroll
      for (int i = 0; i < kBytes / 16; ++i)
        buf.u[i] = reinterpret_cast<const uint4*>(p)[i];
#pragma unroll
      for (int e = 0; e < N; ++e) out[e] = Elem<Raw>::unpack(buf.r[e]);
      return;
    } else if constexpr (kBytes == 8) {
      union {
        uint2 u;
        Raw r[N];
      } buf;
      buf.u = *reinterpret_cast<const uint2*>(p);
#pragma unroll
      for (int e = 0; e < N; ++e) out[e] = Elem<Raw>::unpack(buf.r[e]);
      return;
    } else if constexpr (kBytes == 4) {
      union {
        uint32_t u;
        Raw r[N];
      } buf;
      buf.u = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
      for (int e = 0; e < N; ++e) out[e] = Elem<Raw>::unpack(buf.r[e]);
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < N; ++e) out[e] = e < limit ? Elem<Raw>::load(p + e) : 0.f;
}

}  // namespace attn
