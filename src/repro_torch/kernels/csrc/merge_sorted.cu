// merge_sorted: the O(Na + Nb) sorted frontier merge for sm_90a.
//
// Replaces repro/kernels/merge_sorted.py: merge_sorted_pallas. Two
// ascending (dist, idx) lists per row are merged and the k smallest
// kept; ties go to the a side, then to the lower slot.
//
// Bound on the card: bytes (each element is read once and written at
// most once; the binary searches are a few compares in shared memory).
// Design: one block per row, one thread per element. Both lists are
// staged in shared memory; an a-element lands at pos = i + #{b < a_i}
// (lower bound in b), a b-element at pos = j + #{a <= b_j} (upper bound
// in a). These are the reference's tie rules, the positions form a
// permutation of 0..Na+Nb-1, and the element is written iff pos < k.
// INF pads tie among themselves and resolve by the same rule. Rows of up
// to 12288 elements stage in the default 48 KB of shared memory; longer
// ones opt into the card's larger maximum (227 KB on an H100), and past
// that the binary searches run on the rows in global memory (`staged`
// 0). The host plan (kernels/merge_sorted.py: merge_plan) picks the tier.
// On the search path trip_fold.cu folds a trip's merges into one launch;
// this kernel stays the counterpart of the reference's op.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_topk.cuh"

namespace {

__global__ void merge_sorted_kernel(const float* __restrict__ da,
                                    const int32_t* __restrict__ ia,
                                    const float* __restrict__ db,
                                    const int32_t* __restrict__ ib,
                                    float* __restrict__ od,
                                    int32_t* __restrict__ oi, int Na,
                                    int Nb, int k, int staged) {
  extern __shared__ float sh[];
  const size_t row = blockIdx.x;
  const float* dar = da + row * Na;
  const float* dbr = db + row * Nb;
  const float* sa = dar;
  const float* sb = dbr;
  if (staged) {  // uniform across the block
    for (int t = threadIdx.x; t < Na; t += blockDim.x) sh[t] = dar[t];
    for (int t = threadIdx.x; t < Nb; t += blockDim.x) sh[Na + t] = dbr[t];
    __syncthreads();
    sa = sh;
    sb = sh + Na;
  }
  for (int t = threadIdx.x; t < Na + Nb; t += blockDim.x) {
    float v;
    int32_t id;
    int pos;
    if (t < Na) {
      v = sa[t];
      id = ia[row * Na + t];
      int lo = 0, hi = Nb;  // #{b < v}
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (sb[mid] < v) lo = mid + 1; else hi = mid;
      }
      pos = t + lo;
    } else {
      const int j = t - Na;
      v = sb[j];
      id = ib[row * Nb + j];
      int lo = 0, hi = Na;  // #{a <= v}
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (sa[mid] <= v) lo = mid + 1; else hi = mid;
      }
      pos = j + lo;
    }
    if (pos < k) {
      od[row * k + pos] = v;
      oi[row * k + pos] = id;
    }
  }
}

}  // namespace

extern "C" int merge_sorted_launch(const void* da, const void* ia,
                                   const void* db, const void* ib, void* od,
                                   void* oi, int B, int Na, int Nb, int k,
                                   int staged, void* stream) {
  int threads = ((Na + Nb + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const size_t smem = staged ? sizeof(float) * (size_t)(Na + Nb) : 0;
  const cudaError_t err = block_topk::allow_smem(merge_sorted_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_sorted_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(da), static_cast<const int32_t*>(ia),
      static_cast<const float*>(db), static_cast<const int32_t*>(ib),
      static_cast<float*>(od), static_cast<int32_t*>(oi), Na, Nb, k, staged);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* merge_sorted_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
