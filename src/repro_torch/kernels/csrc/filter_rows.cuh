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
// (PER_LANE of them, M <= 32*PER_LANE <= 128); the top-k is the
// warp-shuffle rank count of warp_topk.cuh, shared with pq_adc_expand.cu.
// Wider rows (M > 128: expand_width * M0 past four warps' worth) take the
// wide tier, one block per row, the distances in shared memory or, past
// the card's opt-in maximum, a global scratch row (block_topk.cuh). The
// host plan (kernels/fused_filter.py: expand_plan) picks the tier.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_topk.cuh"
#include "warp_topk.cuh"

namespace filter_rows {

constexpr int kWarpsPerBlock = 4;

template <bool kMasked>
__device__ __forceinline__ float row_dist(const float* __restrict__ xr,
                                          const float* __restrict__ qr,
                                          const uint8_t* __restrict__ vr,
                                          float t, int m, int dl) {
  const float* xm = xr + (size_t)m * dl;
  float acc = 0.f;
  for (int c = 0; c < dl; ++c) {
    const float df = xm[c] - qr[c];
    acc += df * df;
  }
  if (!kMasked || (vr[m] != 0 && acc < t)) return acc;
  return warp_topk::kInf;
}

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
  const uint8_t* vr = kMasked ? valid + (size_t)row * M : nullptr;
  const float t = kMasked ? th[row] : 0.f;

  float d[PER_LANE];
#pragma unroll
  for (int e = 0; e < PER_LANE; ++e) {
    const int m = e * 32 + lane;
    // never ranked past M: only m < M are written
    d[e] = m < M ? row_dist<kMasked>(xr, qr, vr, t, m, dl)
                 : warp_topk::kInf;
  }

  warp_topk::write_topk<PER_LANE>(d, M, k, lane, out_d + (size_t)row * k,
                                  out_i + (size_t)row * k);
}

// The wide tier: one block per row; scratch is null when the row's M
// distances fit in the block's dynamic shared memory.
template <bool kMasked>
__global__ void kernel_wide(const float* __restrict__ x,
                            const float* __restrict__ q,
                            const uint8_t* __restrict__ valid,
                            const float* __restrict__ th,
                            float* __restrict__ scratch,
                            float* __restrict__ out_d,
                            int32_t* __restrict__ out_i, int M, int dl,
                            int k) {
  extern __shared__ float sh[];
  const size_t row = blockIdx.x;
  float* buf = scratch != nullptr ? scratch + row * M : sh;
  const float* xr = x + row * M * dl;
  const float* qr = q + row * dl;
  const uint8_t* vr = kMasked ? valid + row * M : nullptr;
  const float t = kMasked ? th[row] : 0.f;
  for (int m = threadIdx.x; m < M; m += blockDim.x)
    buf[m] = row_dist<kMasked>(xr, qr, vr, t, m, dl);
  __syncthreads();
  block_topk::write_topk(buf, M, k, out_d + row * k, out_i + row * k,
                         block_topk::Index());
}

// Launch on `stream` in the tier the host plan chose: per_lane 1, 2 or 4
// (a warp per row, M <= 32 * per_lane), or 0 (a block of `threads` per
// row, the row in M*4 bytes of dynamic shared memory, or in `scratch`
// [B, M] f32 when that is not null). valid and th may be null without
// kMasked.
template <bool kMasked>
int launch(const void* x, const void* q, const void* valid, const void* th,
           void* out_d, void* out_i, int B, int M, int dl, int k,
           int per_lane, int threads, void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const float* qp = static_cast<const float*>(q);
  const uint8_t* vp = static_cast<const uint8_t*>(valid);
  const float* tp = static_cast<const float*>(th);
  float* od = static_cast<float*>(out_d);
  int32_t* oi = static_cast<int32_t*>(out_i);
  if (per_lane > 0 && M > 32 * per_lane)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  if (per_lane == 1) {
    kernel<kMasked, 1><<<grid, block, 0, s>>>(xp, qp, vp, tp, od, oi, B, M,
                                              dl, k);
  } else if (per_lane == 2) {
    kernel<kMasked, 2><<<grid, block, 0, s>>>(xp, qp, vp, tp, od, oi, B, M,
                                              dl, k);
  } else if (per_lane == 4) {
    kernel<kMasked, 4><<<grid, block, 0, s>>>(xp, qp, vp, tp, od, oi, B, M,
                                              dl, k);
  } else if (per_lane == 0 && threads > 0 && threads <= 1024) {
    float* sc = static_cast<float*>(scratch);
    const size_t smem = sc != nullptr ? 0 : sizeof(float) * (size_t)M;
    const cudaError_t err = block_topk::allow_smem(kernel_wide<kMasked>,
                                                   smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel_wide<kMasked><<<B, threads, smem, s>>>(xp, qp, vp, tp, sc, od, oi,
                                                  M, dl, k);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace filter_rows
