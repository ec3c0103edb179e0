// ksort_l: kSort.L, the k smallest (value, index) pairs of each row, for
// sm_90a.
//
// Replaces repro/kernels/ksort_l.py: ksort_l_pallas. d [B, M] f32 ->
// vals [B, k] ascending, idx [B, k] int32, ties to the lower index. On
// the search path it is the cross-shard merge of core/distributed.py
// (M = shards * list width, k = list width).
//
// Bound on the card: bytes (each value is read once from device memory
// and each output written once; the O(M^2) compares run on a row held in
// shared memory). The TPU kernel builds an [M, M] comparison matrix in
// VMEM and extracts the top k with a one-hot contraction; here one block
// holds one row in shared memory and one thread ranks one element:
//   rank_i = #{j : d_j < d_i or (d_j == d_i and j < i)},
// a permutation of 0..M-1 (the (value, index) order is total). Element i
// is written to slot rank_i iff rank_i < k, so every output slot is
// written exactly once when k <= M. Every thread of a warp reads the same
// d_j at the same time (a shared-memory broadcast). The compares are
// float compares, as the reference's: -0.0 == 0.0 ties by index, and
// INF (a finite 3.4e38) is an ordinary value. No arithmetic touches a
// value, so the output equals the plain version bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void ksort_l_kernel(const float* __restrict__ d,
                               float* __restrict__ ov,
                               int32_t* __restrict__ oi, int M, int k) {
  extern __shared__ float sh[];
  const size_t row = blockIdx.x;
  const float* dr = d + row * M;
  for (int t = threadIdx.x; t < M; t += blockDim.x) sh[t] = dr[t];
  __syncthreads();
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    const float v = sh[i];
    int rank = 0;
    for (int j = 0; j < M; ++j) {
      const float w = sh[j];
      rank += (w < v) | ((w == v) & (j < i));
    }
    if (rank < k) {
      ov[row * k + rank] = v;
      oi[row * k + rank] = i;
    }
  }
}

}  // namespace

extern "C" int ksort_l_launch(const void* d, void* ov, void* oi, int B, int M,
                              int k, void* stream) {
  int threads = ((M + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const size_t smem = sizeof(float) * (size_t)M;
  ksort_l_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(d), static_cast<float*>(ov),
      static_cast<int32_t*>(oi), M, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ksort_l_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
