// block_topk: kSort.L of one row by a whole block, for rows wider than
// warp_topk.cuh's tiers (sm_90a).
//
// The row's M distances lie in `buf`: shared memory where they fit
// (48 KB by default, up to the card's opt-in maximum, 227 KB on an
// H100), else a global scratch row the wrapper allocates. Thread t ranks
// elements t, t + blockDim.x, ... against the whole row with the order of
// warp_topk.cuh, rank_i = #{j : d_j < d_i or (d_j == d_i and j < i)};
// every thread of a warp reads the same d_j at once (a broadcast). Ranks
// are a permutation of 0..M-1, so the elements ranked below k write their
// slot directly. The compares are float compares: -0.0 == 0.0 ties by
// index, and INF (a finite 3.4e38) is an ordinary value.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace block_topk {

// The index itself as the payload.
struct Index {
  __device__ __forceinline__ int32_t operator()(int i) const { return i; }
};

// The whole block calls this once buf[0..M) is written and a
// __syncthreads has passed. Writes the k smallest (buf[i], pay(i))
// ascending, ties to the lower index, into out_d[0..k), out_i[0..k).
template <class Pay>
__device__ __forceinline__ void write_topk(const float* buf, int M, int k,
                                           float* __restrict__ out_d,
                                           int32_t* __restrict__ out_i,
                                           Pay pay) {
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    const float v = buf[i];
    int rank = 0;
    for (int j = 0; j < M; ++j) {
      const float w = buf[j];
      rank += (w < v) | ((w == v) & (j < i));
    }
    if (rank < k) {
      out_d[rank] = v;
      out_i[rank] = pay(i);
    }
  }
}

// Dynamic shared memory above the default 48 KB must be opted into per
// kernel; returns the CUDA error of the attribute call (0 below 48 KB).
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace block_topk
