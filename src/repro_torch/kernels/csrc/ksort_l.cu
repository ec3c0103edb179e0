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
// value, so the output equals the plain version bit for bit. The rank
// count is block_topk.cuh's. Rows of up to 12288 values stage in the
// default 48 KB of shared memory; longer ones opt into the card's larger
// maximum (227 KB on an H100), and past that the block ranks the row in
// global memory (`staged` 0). The host plan (kernels/ksort_l.py:
// ksort_plan) picks the tier.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_topk.cuh"

namespace {

__global__ void ksort_l_kernel(const float* __restrict__ d,
                               float* __restrict__ ov,
                               int32_t* __restrict__ oi, int M, int k,
                               int staged) {
  extern __shared__ float sh[];
  const size_t row = blockIdx.x;
  const float* dr = d + row * M;
  const float* buf = dr;
  if (staged) {  // uniform across the block
    for (int t = threadIdx.x; t < M; t += blockDim.x) sh[t] = dr[t];
    __syncthreads();
    buf = sh;
  }
  block_topk::write_topk(buf, M, k, ov + row * k, oi + row * k,
                         block_topk::Index());
}

}  // namespace

extern "C" int ksort_l_launch(const void* d, void* ov, void* oi, int B, int M,
                              int k, int staged, void* stream) {
  int threads = ((M + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const size_t smem = staged ? sizeof(float) * (size_t)M : 0;
  const cudaError_t err = block_topk::allow_smem(ksort_l_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ksort_l_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(d), static_cast<float*>(ov),
      static_cast<int32_t*>(oi), M, k, staged);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ksort_l_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
