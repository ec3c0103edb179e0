// ksort_l: kSort.L, the k smallest (value, index) pairs of each row, for
// sm_90a.
//
// Replaces repro/kernels/ksort_l.py: ksort_l_pallas. d [B, M] f32 ->
// vals [B, k] ascending, idx [B, k] int32, ties to the lower index. On
// the search path it is the cross-shard merge of core/distributed.py
// (M = shards * list width, k = list width: 40, 120 and 240 at P = 4).
//
// Bound on the card: bytes (each value read once, each output written
// once). The TPU kernel builds an [M, M] comparison matrix in VMEM and
// extracts the top k with a one-hot contraction; counting ranks that way
// here costs M^2 compares and shared-memory reads a row (57,600 at
// M = 240), bound by instructions. Two tiers, picked by the host plan
// (kernels/ksort_l.py: ksort_plan):
//
// * warp (M <= 512, every main-path width): one warp per row, several
//   rows a block. Each lane loads a run of R = 1..16 consecutive values
//   (a power of two, 32*R >= M; float4 loads where the run is aligned and
//   in bounds), makes warp_sort.cuh's 64-bit keys, pads with the largest
//   key, and the warp sorts them with a bitonic network (36 steps at
//   M = 240, 15 of them shuffles). Lanes write the first k positions; each
//   winner's value is read again from the row, so the output keeps the
//   input's bits.
// * block (M > 512): block_topk.cuh's rank count, one block per row, the
//   row staged in shared memory (the default 48 KB up to 12288 values, the
//   card's opt-in maximum past that) or read in place from global memory
//   past 227 KB (`mode` 0).
//
// Both tiers order exactly as the reference's float compares: -0.0 ties
// 0.0 and falls to the index; no arithmetic touches a value.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_topk.cuh"
#include "warp_sort.cuh"

namespace {

constexpr int kModeGlobal = 0, kModeStaged = 1, kModeWarp = 2;

template <int R>
__global__ void ksort_l_kernel_warp(const float* __restrict__ d,
                                    float* __restrict__ ov,
                                    int32_t* __restrict__ oi, int B, int M,
                                    int k) {
  const int lane = threadIdx.x & 31;
  const size_t row = static_cast<size_t>(blockIdx.x) * (blockDim.x / 32) +
                     threadIdx.x / 32;
  if (row >= static_cast<size_t>(B)) return;  // whole warps leave
  const float* dr = d + row * M;
  const int base = lane * R;
  unsigned long long key[R];
  bool loaded = false;
  if constexpr (R >= 4) {
    if (base + R <= M &&
        (reinterpret_cast<uintptr_t>(dr + base) & 15) == 0) {
#pragma unroll
      for (int r = 0; r < R; r += 4) {
        const float4 x = *reinterpret_cast<const float4*>(dr + base + r);
        key[r] = warp_sort::key_of(x.x, base + r);
        key[r + 1] = warp_sort::key_of(x.y, base + r + 1);
        key[r + 2] = warp_sort::key_of(x.z, base + r + 2);
        key[r + 3] = warp_sort::key_of(x.w, base + r + 3);
      }
      loaded = true;
    }
  }
  if (!loaded) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      key[r] = base + r < M ? warp_sort::key_of(dr[base + r], base + r)
                            : warp_sort::kPad;
  }
  warp_sort::bitonic_sort<R>(key, lane);
  float* vr = ov + row * k;
  int32_t* ir = oi + row * k;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (base + r < k) {
      const int i = warp_sort::index_of(key[r]);
      ir[base + r] = i;
      vr[base + r] = dr[i];
    }
  }
}

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

template <int R>
int launch_warp(const float* d, float* ov, int32_t* oi, int B, int M, int k,
                int rows, cudaStream_t s) {
  const int blocks = (B + rows - 1) / rows;
  ksort_l_kernel_warp<R><<<blocks, 32 * rows, 0, s>>>(d, ov, oi, B, M, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mode: 2 warp tier (`run` values a lane, `rows` rows a block), 1 block
// tier staged in shared memory, 0 block tier in global memory.
extern "C" int ksort_l_launch(const void* d_, void* ov_, void* oi_, int B,
                              int M, int k, int mode, int run, int rows,
                              void* stream) {
  const float* d = static_cast<const float*>(d_);
  float* ov = static_cast<float*>(ov_);
  int32_t* oi = static_cast<int32_t*>(oi_);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > M) return static_cast<int>(cudaErrorInvalidValue);
  if (mode == kModeWarp) {
    if (32 * run < M || rows < 1 || rows > 32)
      return static_cast<int>(cudaErrorInvalidValue);
    switch (run) {
      case 1: return launch_warp<1>(d, ov, oi, B, M, k, rows, s);
      case 2: return launch_warp<2>(d, ov, oi, B, M, k, rows, s);
      case 4: return launch_warp<4>(d, ov, oi, B, M, k, rows, s);
      case 8: return launch_warp<8>(d, ov, oi, B, M, k, rows, s);
      case 16: return launch_warp<16>(d, ov, oi, B, M, k, rows, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  int threads = ((M + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const size_t smem = mode == kModeStaged ? sizeof(float) * (size_t)M : 0;
  const cudaError_t err = block_topk::allow_smem(ksort_l_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ksort_l_kernel<<<B, threads, smem, s>>>(d, ov, oi, M, k,
                                          mode == kModeStaged);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ksort_l_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
