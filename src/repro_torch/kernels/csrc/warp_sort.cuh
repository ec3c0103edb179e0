// warp_sort: one row of up to 512 (value, index) pairs sorted by one warp,
// a bitonic network on 64-bit keys held in registers (sm_90a).
//
// The key of element i with value v is (orderable(v) << 32) | i, where
// orderable maps the f32 bits to an unsigned order equal to the float
// order: -0.0 is first folded to +0.0 (the float compare ties them, so
// they must tie here and fall to the index), then a clear sign bit is set
// and a set one flips every bit. Keys are unique (the index is in the low
// word), so their ascending order is exactly the rank order of
// block_topk.cuh: rank_i = #{j : d_j < d_i or (d_j == d_i and j < i)}.
// INF (a finite 3.4e38) is an ordinary value. The low word gives back the
// index; the caller reads the value again from its row, so the output
// keeps each value's own bits (a -0.0 stays -0.0).
//
// Lane l holds positions l*R .. l*R+R-1 of the N = 32*R keys (R a power
// of two). A compare-exchange at partner distance j < R stays inside the
// lane's registers; a longer one swaps with lane l ^ (j/R) by
// __shfl_xor_sync and keeps the min or the max. N = 256 takes 36 steps,
// 15 of them shuffles.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace warp_sort {

// larger than every element's key: pads the row to N
constexpr unsigned long long kPad = ~0ull;

__device__ __forceinline__ unsigned long long key_of(float v, int i) {
  uint32_t u = __float_as_uint(v);
  if (u == 0x80000000u) u = 0u;  // -0.0 -> +0.0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) | static_cast<uint32_t>(i);
}

__device__ __forceinline__ int index_of(unsigned long long key) {
  return static_cast<int>(static_cast<uint32_t>(key));
}

// Sorts the warp's 32*R keys ascending into positions lane*R + r. The
// whole warp calls it.
template <int R>
__device__ __forceinline__ void bitonic_sort(unsigned long long (&key)[R],
                                             int lane) {
  constexpr int N = 32 * R;
#pragma unroll
  for (int size = 2; size <= N; size <<= 1) {
#pragma unroll
    for (int j = size >> 1; j > 0; j >>= 1) {
      if (j < R) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r & j) continue;  // each pair (r, r | j) once
          const bool up = ((lane * R + r) & size) == 0;
          const unsigned long long a = key[r], b = key[r | j];
          const bool swap = (a > b) == up;
          key[r] = swap ? b : a;
          key[r | j] = swap ? a : b;
        }
      } else {
        const int lj = j / R;
        const bool lower = (lane & lj) == 0;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const bool up = ((lane * R + r) & size) == 0;
          const unsigned long long o = __shfl_xor_sync(0xffffffffu, key[r],
                                                       lj);
          const bool keep_min = lower == up;
          key[r] = keep_min ? (o < key[r] ? o : key[r])
                            : (o > key[r] ? o : key[r]);
        }
      }
    }
  }
}

}  // namespace warp_sort
