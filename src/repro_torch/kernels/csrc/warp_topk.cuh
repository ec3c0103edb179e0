// warp_topk: the one kSort.L of the port's expand kernels (sm_90a).
//
// Shared by filter_rows.cuh (fused_expand.cu, fused_filter.cu) and
// pq_adc_expand.cu, as the reference keeps one ksort_block
// (repro/kernels/fused_filter.py:18-24) for both expands: merge
// determinism depends on the exact (dist, index) order.
//
// One warp holds the M <= 32*PER_LANE distances of a row, lane l owning
// elements l, l+32, ... Each element's rank is #{j : d_j < d_i or
// (d_j == d_i and j < i)}, counted by broadcasting every d_j through warp
// shuffles; ranks are a permutation of 0..M-1, so the lanes whose rank is
// below k write slot `rank` directly: no sort network, no shared memory.
// The 32 shuffles of each source register are unrolled with the j < M
// test as a predicate (no break), so they issue back to back instead of
// one shuffle latency after another.
// Rows wider than the warp's tiers take block_topk.cuh, the same rank
// count with the row in shared (or global) memory.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace warp_topk {

constexpr float kInf = 3.4e38f;        // repro_torch.constants.INF

// The whole warp must call this (the shuffles are full-warp). Writes the
// k smallest (d[e], e*32 + lane) pairs of the row ascending, ties to the
// lower index, into out_d[0..k); out_i gets pay[e] of each winner (the
// index itself for the plain expands, a neighbour id for the gathering
// ones).
template <int PER_LANE>
__device__ __forceinline__ void write_topk(const float (&d)[PER_LANE],
                                           const int32_t (&pay)[PER_LANE],
                                           int M, int k, int lane,
                                           float* __restrict__ out_d,
                                           int32_t* __restrict__ out_i) {
  int rank[PER_LANE];
#pragma unroll
  for (int e = 0; e < PER_LANE; ++e) rank[e] = 0;
#pragma unroll
  for (int e2 = 0; e2 < PER_LANE; ++e2) {
    if (e2 * 32 >= M) break;  // uniform across the warp
#pragma unroll
    for (int src = 0; src < 32; ++src) {
      const float dj = __shfl_sync(0xffffffffu, d[e2], src);
      const int j = e2 * 32 + src;
      const bool in = j < M;  // uniform: j does not depend on the lane
#pragma unroll
      for (int e = 0; e < PER_LANE; ++e) {
        const int i = e * 32 + lane;
        rank[e] += in & ((dj < d[e]) | ((dj == d[e]) & (j < i)));
      }
    }
  }
#pragma unroll
  for (int e = 0; e < PER_LANE; ++e) {
    const int i = e * 32 + lane;
    if (i < M && rank[e] < k) {
      out_d[rank[e]] = d[e];
      out_i[rank[e]] = pay[e];
    }
  }
}

// The index-payload form: out_i gets the winner's index e*32 + lane.
template <int PER_LANE>
__device__ __forceinline__ void write_topk(const float (&d)[PER_LANE],
                                           int M, int k, int lane,
                                           float* __restrict__ out_d,
                                           int32_t* __restrict__ out_i) {
  int32_t pay[PER_LANE];
#pragma unroll
  for (int e = 0; e < PER_LANE; ++e) pay[e] = e * 32 + lane;
  write_topk<PER_LANE>(d, pay, M, k, lane, out_d, out_i);
}

}  // namespace warp_topk
