// filter_rows: Dist.L then kSort.L per query row, the one body of
// fused_expand.cu and fused_filter.cu (sm_90a).
//
// Per query row: Dist.L of the M rows [M, dl] to q in f32, then the k
// smallest (dist, index) pairs ascending with ties to the lower index.
// With kMasked (fused_expand) a distance counts only where valid[m] != 0
// and d < th[row], else it is INF; without it (fused_filter) every
// distance counts and valid/th are not read.
//
// Bound on the card: bytes. The row block is M*dl*4 bytes (1.9 KB at
// M=32, dl=15) and the work is ~3*M*dl flops plus M*M compares, far
// below Hopper's operations-per-byte line. Design: one warp per query
// row, so the distances never leave registers (the point of the TPU
// kernels' single VMEM residency). Lane l owns elements l, l+32, ...
// (PER_LANE of them, M <= 32*PER_LANE); the top-k is the warp-shuffle
// rank count of warp_topk.cuh, shared with pq_adc_expand.cu.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_topk.cuh"

namespace filter_rows {

constexpr int kWarpsPerBlock = 4;

template <bool kMasked, int PER_LANE>
__global__ void kernel(const float* __restrict__ x,
                       const float* __restrict__ q,
                       const uint8_t* __restrict__ valid,
                       const float* __restrict__ th,
                       float* __restrict__ out_d,
                       int32_t* __restrict__ out_i, int B, int M, int dl,
                       int k) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= B) return;  // uniform per warp: shuffles below stay full-warp
  const float* xr = x + (size_t)row * M * dl;
  const float* qr = q + (size_t)row * dl;

  float d[PER_LANE];
#pragma unroll
  for (int e = 0; e < PER_LANE; ++e) {
    const int m = e * 32 + lane;
    float v = warp_topk::kInf;  // never ranked: only m < M are written
    if (m < M) {
      const float* xm = xr + (size_t)m * dl;
      float acc = 0.f;
      for (int c = 0; c < dl; ++c) {
        const float df = xm[c] - qr[c];
        acc += df * df;
      }
      if (!kMasked || (valid[(size_t)row * M + m] != 0 && acc < th[row]))
        v = acc;
    }
    d[e] = v;
  }

  warp_topk::write_topk<PER_LANE>(d, M, k, lane, out_d + (size_t)row * k,
                                  out_i + (size_t)row * k);
}

// Launch on `stream`; valid and th may be null without kMasked.
template <bool kMasked>
int launch(const void* x, const void* q, const void* valid, const void* th,
           void* out_d, void* out_i, int B, int M, int dl, int k,
           void* stream) {
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const float* qp = static_cast<const float*>(q);
  const uint8_t* vp = static_cast<const uint8_t*>(valid);
  const float* tp = static_cast<const float*>(th);
  float* od = static_cast<float*>(out_d);
  int32_t* oi = static_cast<int32_t*>(out_i);
  if (M <= 32) {
    kernel<kMasked, 1><<<grid, block, 0, s>>>(xp, qp, vp, tp, od, oi, B, M,
                                              dl, k);
  } else if (M <= 64) {
    kernel<kMasked, 2><<<grid, block, 0, s>>>(xp, qp, vp, tp, od, oi, B, M,
                                              dl, k);
  } else if (M <= 128) {
    kernel<kMasked, 4><<<grid, block, 0, s>>>(xp, qp, vp, tp, od, oi, B, M,
                                              dl, k);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace filter_rows
