// pq_adc_expand: the PQ filter's whole expansion step for sm_90a, with
// or without the row gathers in front of it.
//
// Replaces repro/kernels/pq_adc.py: pq_adc_expand_pallas. Per query row:
// the ADC distance d[m] = sum_s lut[s, codes[m, s]] of the M neighbors,
// summed over s = 0..S-1 in f32, INF unless valid & d < th, then the k
// smallest (dist, index) pairs ascending with ties to the lower index.
// Two entry points share the body (expand_rows.cuh says where slot m
// lives): pq_adc_expand_launch takes the gathered [B, M, S] code block
// and its [B, M] mask, as the reference's op; pq_expand_rows_launch
// takes the layer itself (adj [N, M0], packed codes [N, M0, S]) with the
// popped ids and their gates, reads each popped node's adjacency row and
// its neighbours' codes in place, and writes the winners' neighbour ids.
// That removes the search's index_select of the [B, W*M0, S] code block
// (written, then read back by the kernel), the mask's ops and the id
// gather around the kernel (kernels/pq_adc.py says which). Stacked (adj
// [P, N, M0], codes [P, N, M0, S], rows shard-major: expand_rows.cuh's
// Rows adds each row's shard offset), one launch serves every shard of
// the slotted sharded programs.
//
// Bound on the card: bytes. A row reads its M*S uint8 codes (512 B at
// M=32, S=16) and, at most, its whole [S, 256] f32 table (16 KB); the
// work is M*S adds. The TPU kernel scores codes with a one-hot
// contraction against the 256 slots because VMEM has no gather; Hopper
// gathers, so each lane looks its S entries up directly through the
// read-only cache and touches only the table entries its codes name
// (each a 32-byte sector for 4 bytes). Copying the row's whole table
// into shared memory first was slower at the search's widths (PERF.md).
// Design: one warp per query row (the shape of fused_expand.cu), lane l
// owning neighbors l, l+32, ... (M <= 128); at S = 16 a lane loads its 16
// codes as one 16-byte vector. Wider rows take one block per row with
// the distances in shared or global memory (block_topk.cuh). The table is
// addressed through an explicit row stride, so the cascade's tables stay
// a strided view of its flat per-query row [S*256 + d_low] and are never
// copied per step. The top-k is warp_topk.cuh, shared with
// fused_expand.cu.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_topk.cuh"
#include "expand_rows.cuh"
#include "warp_topk.cuh"

namespace {

using warp_topk::kInf;
constexpr int kWarpsPerBlock = 4;

// The ADC sum of one slot's S codes, s ascending (the plain version's
// order), masked by ok and the threshold. The table is read through the
// read-only cache.
template <bool VEC16>
__device__ __forceinline__ float adc(const uint8_t* __restrict__ cm,
                                     const float* __restrict__ lr, int S,
                                     bool ok, float t) {
  auto at = [lr](int i) { return __ldg(lr + i); };
  float acc = 0.f;
  if (VEC16) {
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(cm));
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int s = 0; s < 16; ++s) {
      const uint32_t c = (words[s / 4] >> (8 * (s % 4))) & 0xffu;
      acc += at(s * 256 + c);
    }
  } else {
    for (int s = 0; s < S; ++s) acc += at(s * 256 + cm[s]);
  }
  return ok && acc < t ? acc : kInf;
}

template <class Src, int PER_LANE, bool VEC16>
__device__ __forceinline__ void warp_body(const Src& src,
                                          const uint8_t* __restrict__ codes,
                                          const float* __restrict__ lut,
                                          long long lut_stride,
                                          const float* __restrict__ th,
                                          long long th_stride,
                                          float* __restrict__ out_d,
                                          int32_t* __restrict__ out_i,
                                          int B, int M, int S, int k) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= B) return;  // uniform per warp: shuffles below stay full-warp
  const float* lr = lut + (size_t)row * lut_stride;
  const float t = th[(size_t)row * th_stride];
  float d[PER_LANE];
  int32_t pay[PER_LANE];
#pragma unroll
  for (int e = 0; e < PER_LANE; ++e) {
    const int m = e * 32 + lane;
    d[e] = kInf;  // never ranked past M: only m < M are written
    pay[e] = 0;
    if (m < M) {
      const expand_rows::Slot sl = src.at(row, m);
      d[e] = adc<VEC16>(codes + sl.pay_row * S, lr, S, sl.ok, t);
      pay[e] = sl.id;
    }
  }
  warp_topk::write_topk<PER_LANE>(d, pay, M, k, lane,
                                  out_d + (size_t)row * k,
                                  out_i + (size_t)row * k);
}

template <class Src, bool VEC16>
__device__ __forceinline__ void wide_body(const Src& src,
                                          const uint8_t* __restrict__ codes,
                                          const float* __restrict__ lut,
                                          long long lut_stride,
                                          const float* __restrict__ th,
                                          long long th_stride,
                                          float* __restrict__ scratch,
                                          float* __restrict__ out_d,
                                          int32_t* __restrict__ out_i, int M,
                                          int S, int k) {
  extern __shared__ __align__(16) float sh[];
  const int row = blockIdx.x;
  float* buf = scratch != nullptr ? scratch + (size_t)row * M : sh;
  const float* lr = lut + (size_t)row * lut_stride;
  const float t = th[(size_t)row * th_stride];
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    const expand_rows::Slot sl = src.at(row, m);
    buf[m] = adc<VEC16>(codes + sl.pay_row * S, lr, S, sl.ok, t);
  }
  __syncthreads();
  block_topk::write_topk(buf, M, k, out_d + (size_t)row * k,
                         out_i + (size_t)row * k,
                         expand_rows::SrcId<Src>{src, row});
}

// The two entry points' kernels, named apart so a profile tells them
// apart ("pq_adc_expand_kernel", "pq_expand_rows_kernel").
template <int PER_LANE, bool VEC16>
__global__ void pq_adc_expand_kernel(expand_rows::Blocks src,
                                     const uint8_t* __restrict__ codes,
                                     const float* __restrict__ lut,
                                     long long lut_stride,
                                     const float* __restrict__ th,
                                     long long th_stride,
                                     float* __restrict__ out_d,
                                     int32_t* __restrict__ out_i, int B,
                                     int M, int S, int k) {
  warp_body<expand_rows::Blocks, PER_LANE, VEC16>(
      src, codes, lut, lut_stride, th, th_stride, out_d, out_i, B, M, S, k);
}

template <int PER_LANE, bool VEC16>
__global__ void pq_expand_rows_kernel(expand_rows::Rows src,
                                      const uint8_t* __restrict__ codes,
                                      const float* __restrict__ lut,
                                      long long lut_stride,
                                      const float* __restrict__ th,
                                      long long th_stride,
                                      float* __restrict__ out_d,
                                      int32_t* __restrict__ out_i, int B,
                                      int M, int S, int k) {
  warp_body<expand_rows::Rows, PER_LANE, VEC16>(
      src, codes, lut, lut_stride, th, th_stride, out_d, out_i, B, M, S, k);
}

template <bool VEC16>
__global__ void pq_adc_expand_kernel_wide(expand_rows::Blocks src,
                                          const uint8_t* __restrict__ codes,
                                          const float* __restrict__ lut,
                                          long long lut_stride,
                                          const float* __restrict__ th,
                                          long long th_stride,
                                          float* __restrict__ scratch,
                                          float* __restrict__ out_d,
                                          int32_t* __restrict__ out_i, int M,
                                          int S, int k) {
  wide_body<expand_rows::Blocks, VEC16>(src, codes, lut, lut_stride, th,
                                        th_stride, scratch, out_d, out_i, M,
                                        S, k);
}

template <bool VEC16>
__global__ void pq_expand_rows_kernel_wide(expand_rows::Rows src,
                                           const uint8_t* __restrict__ codes,
                                           const float* __restrict__ lut,
                                           long long lut_stride,
                                           const float* __restrict__ th,
                                           long long th_stride,
                                           float* __restrict__ scratch,
                                           float* __restrict__ out_d,
                                           int32_t* __restrict__ out_i,
                                           int M, int S, int k) {
  wide_body<expand_rows::Rows, VEC16>(src, codes, lut, lut_stride, th,
                                      th_stride, scratch, out_d, out_i, M, S,
                                      k);
}

// Selects the kernel of source Src for the plan's tier: per_lane 1, 2 or
// 4 (a warp per row), or 0 (a block of `threads` per row, the distances
// in M*4 bytes of shared memory or in `scratch` [B, M] f32 when that is
// not null).
template <class Src, class Warp, class Wide>
struct Launch {
  Src src;
  const uint8_t* codes;
  const float* lut;
  long long ls;
  const float* th;
  long long ts;
  float* od;
  int32_t* oi;
  int B, M, S, k;

  template <int PER_LANE, bool VEC16>
  int warp(cudaStream_t s) const {
    Warp::template get<PER_LANE, VEC16>()
        <<<(B + kWarpsPerBlock - 1) / kWarpsPerBlock, 32 * kWarpsPerBlock, 0,
           s>>>(src, codes, lut, ls, th, ts, od, oi, B, M, S, k);
    return static_cast<int>(cudaGetLastError());
  }

  template <bool VEC16>
  int run(int per_lane, int threads, float* scratch, cudaStream_t s) const {
    if (per_lane > 0 && M > 32 * per_lane)
      return static_cast<int>(cudaErrorInvalidValue);
    if (per_lane == 1) return warp<1, VEC16>(s);
    if (per_lane == 2) return warp<2, VEC16>(s);
    if (per_lane == 4) return warp<4, VEC16>(s);
    if (per_lane != 0 || threads <= 0 || threads > 1024)
      return static_cast<int>(cudaErrorInvalidValue);
    auto kern = Wide::template get<VEC16>();
    const size_t smem = scratch != nullptr ? 0 : sizeof(float) * (size_t)M;
    const cudaError_t err = block_topk::allow_smem(kern, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<B, threads, smem, s>>>(src, codes, lut, ls, th, ts, scratch, od,
                                  oi, M, S, k);
    return static_cast<int>(cudaGetLastError());
  }

  int operator()(int per_lane, int threads, void* scratch,
                 void* stream) const {
    // 16-byte code vectors need S == 16 and every slot's row aligned
    const bool vec16 = S == 16 && reinterpret_cast<uintptr_t>(codes) % 16 == 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* sc = static_cast<float*>(scratch);
    return vec16 ? run<true>(per_lane, threads, sc, s)
                 : run<false>(per_lane, threads, sc, s);
  }
};

struct BlocksWarp {
  template <int P, bool V>
  static auto get() { return pq_adc_expand_kernel<P, V>; }
};
struct BlocksWide {
  template <bool V>
  static auto get() { return pq_adc_expand_kernel_wide<V>; }
};
struct RowsWarp {
  template <int P, bool V>
  static auto get() { return pq_expand_rows_kernel<P, V>; }
};
struct RowsWide {
  template <bool V>
  static auto get() { return pq_expand_rows_kernel_wide<V>; }
};

}  // namespace

extern "C" int pq_adc_expand_launch(const void* codes, const void* lut,
                                    long long lut_stride, const void* valid,
                                    const void* th, void* out_d, void* out_i,
                                    int B, int M, int S, int k, int per_lane,
                                    int threads, void* scratch,
                                    void* stream) {
  const Launch<expand_rows::Blocks, BlocksWarp, BlocksWide> l{
      {static_cast<const uint8_t*>(valid), M},
      static_cast<const uint8_t*>(codes),
      static_cast<const float*>(lut), lut_stride,
      static_cast<const float*>(th), 1, static_cast<float*>(out_d),
      static_cast<int32_t*>(out_i), B, M, S, k};
  return l(per_lane, threads, scratch, stream);
}

extern "C" int pq_expand_rows_launch(const void* adj, const void* codes,
                                     const void* cw, long long cw_stride,
                                     const void* gate, const void* lut,
                                     long long lut_stride, const void* th,
                                     long long th_stride, void* out_d,
                                     void* out_i, int B, int W, int M0,
                                     int S, int k, int shard_b,
                                     long long shard_n, int per_lane,
                                     int threads, void* scratch,
                                     void* stream) {
  // shard_b: rows a shard (B unstacked); shard_n: nodes a shard's table
  // (0 unstacked)
  if (shard_b < 1 || shard_n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch<expand_rows::Rows, RowsWarp, RowsWide> l{
      {static_cast<const int32_t*>(adj), static_cast<const int32_t*>(cw),
       cw_stride, static_cast<const uint8_t*>(gate), W, M0, shard_b,
       shard_n},
      static_cast<const uint8_t*>(codes),
      static_cast<const float*>(lut), lut_stride,
      static_cast<const float*>(th), th_stride, static_cast<float*>(out_d),
      static_cast<int32_t*>(out_i), B, W * M0, S, k};
  return l(per_lane, threads, scratch, stream);
}

extern "C" const char* pq_adc_expand_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
