// pq_adc_expand: the PQ filter's whole expansion step for sm_90a.
//
// Replaces repro/kernels/pq_adc.py: pq_adc_expand_pallas. Per query row:
// the ADC distance d[m] = sum_s lut[s, codes[m, s]] of the M neighbors,
// summed over s = 0..S-1 in f32, INF unless valid & d < th, then the k
// smallest (dist, index) pairs ascending with ties to the lower index.
//
// Bound on the card: bytes. A row reads its M*S uint8 codes (512 B at
// M=32, S=16) and, at most, its whole [S, 256] f32 table (16 KB); the
// work is M*S adds. The TPU kernel scores codes with a one-hot
// contraction against the 256 slots because VMEM has no gather; Hopper
// gathers, so each lane looks its S entries up directly through the
// read-only cache and touches only the table entries its codes name.
// Design: one warp per query row (the shape of fused_expand.cu), lane l
// owning neighbors l, l+32, ...; at S = 16 a lane loads its 16 codes as
// one 16-byte vector. The table is addressed through an explicit row
// stride, so the cascade's tables stay a strided view of its flat
// per-query row [S*256 + d_low] and are never copied per step. The top-k
// is warp_topk.cuh, shared with fused_expand.cu.
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_topk.cuh"

namespace {

using warp_topk::kInf;
constexpr int kWarpsPerBlock = 4;

template <int PER_LANE, bool VEC16>
__global__ void pq_adc_expand_kernel(const uint8_t* __restrict__ codes,
                                     const float* __restrict__ lut,
                                     long long lut_stride,
                                     const uint8_t* __restrict__ valid,
                                     const float* __restrict__ th,
                                     float* __restrict__ out_d,
                                     int32_t* __restrict__ out_i, int B,
                                     int M, int S, int k) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= B) return;  // uniform per warp: shuffles below stay full-warp
  const uint8_t* cr = codes + (size_t)row * M * S;
  const float* lr = lut + (size_t)row * lut_stride;
  const uint8_t* vr = valid + (size_t)row * M;
  const float t = th[row];

  float d[PER_LANE];
#pragma unroll
  for (int e = 0; e < PER_LANE; ++e) {
    const int m = e * 32 + lane;
    float v = kInf;
    if (m < M) {
      const uint8_t* cm = cr + (size_t)m * S;
      float acc = 0.f;
      if (VEC16) {
        const uint4 w = __ldg(reinterpret_cast<const uint4*>(cm));
        const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int s = 0; s < 16; ++s) {
          const uint32_t c = (words[s / 4] >> (8 * (s % 4))) & 0xffu;
          acc += __ldg(lr + s * 256 + c);
        }
      } else {
        for (int s = 0; s < S; ++s) acc += __ldg(lr + s * 256 + cm[s]);
      }
      if (vr[m] != 0 && acc < t) v = acc;
    }
    d[e] = v;
  }

  warp_topk::write_topk<PER_LANE>(d, M, k, lane, out_d + (size_t)row * k,
                                  out_i + (size_t)row * k);
}

template <int PER_LANE>
void launch(bool vec16, dim3 grid, dim3 block, cudaStream_t s,
            const uint8_t* c, const float* l, long long ls, const uint8_t* v,
            const float* t, float* od, int32_t* oi, int B, int M, int S,
            int k) {
  if (vec16) {
    pq_adc_expand_kernel<PER_LANE, true>
        <<<grid, block, 0, s>>>(c, l, ls, v, t, od, oi, B, M, S, k);
  } else {
    pq_adc_expand_kernel<PER_LANE, false>
        <<<grid, block, 0, s>>>(c, l, ls, v, t, od, oi, B, M, S, k);
  }
}

}  // namespace

extern "C" int pq_adc_expand_launch(const void* codes, const void* lut,
                                    long long lut_stride, const void* valid,
                                    const void* th, void* out_d, void* out_i,
                                    int B, int M, int S, int k,
                                    void* stream) {
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* cp = static_cast<const uint8_t*>(codes);
  const float* lp = static_cast<const float*>(lut);
  const uint8_t* vp = static_cast<const uint8_t*>(valid);
  const float* tp = static_cast<const float*>(th);
  float* od = static_cast<float*>(out_d);
  int32_t* oi = static_cast<int32_t*>(out_i);
  const bool vec16 = S == 16 && reinterpret_cast<uintptr_t>(codes) % 16 == 0;
  if (M <= 32) {
    launch<1>(vec16, grid, block, s, cp, lp, lut_stride, vp, tp, od, oi, B, M,
              S, k);
  } else if (M <= 64) {
    launch<2>(vec16, grid, block, s, cp, lp, lut_stride, vp, tp, od, oi, B, M,
              S, k);
  } else if (M <= 128) {
    launch<4>(vec16, grid, block, s, cp, lp, lut_stride, vp, tp, od, oi, B, M,
              S, k);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pq_adc_expand_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
