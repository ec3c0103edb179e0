// dist_h: high-dimensional squared L2 distances (paper Dist.H) for sm_90a.
//
// Replaces repro/kernels/dist_h.py: dist_h_pallas. x [B, K, D] against
// q [B, D] -> [B, K], accumulated in f32.
//
// Bound on the card: bytes. Every x element is read once and used for 3
// flops (0.75 flop per byte). Design: one warp per (b, K-row); at D=128
// each lane loads one float4 of the row and one of q (16-byte accesses,
// neighbouring lanes on neighbouring addresses, so a row is one 512-byte
// coalesced read), and a shuffle tree reduces the 32 partial sums. The
// gather of candidate rows stays outside, as in the reference.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

template <bool VEC4>
__global__ void dist_h_kernel(const float* __restrict__ x,
                              const float* __restrict__ q,
                              float* __restrict__ out, long long rows, int K,
                              int D) {
  const long long r =
      (long long)blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;  // uniform per warp
  const float* xr = x + r * D;
  const float* qr = q + (r / K) * D;
  float acc = 0.f;
  if (VEC4) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    const float4* q4 = reinterpret_cast<const float4*>(qr);
    for (int c = lane; c < D / 4; c += 32) {
      const float4 a = x4[c];
      const float4 b = q4[c];
      const float d0 = a.x - b.x, d1 = a.y - b.y;
      const float d2 = a.z - b.z, d3 = a.w - b.w;
      acc += d0 * d0 + d1 * d1 + d2 * d2 + d3 * d3;
    }
  } else {
    for (int c = lane; c < D; c += 32) {
      const float df = xr[c] - qr[c];
      acc += df * df;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) out[r] = acc;
}

}  // namespace

extern "C" int dist_h_launch(const void* x, const void* q, void* out, int B,
                             int K, int D, void* stream) {
  const long long rows = (long long)B * K;
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((unsigned)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = D % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(q) % 16 == 0;
  if (vec4) {
    dist_h_kernel<true><<<grid, block, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(q),
        static_cast<float*>(out), rows, K, D);
  } else {
    dist_h_kernel<false><<<grid, block, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(q),
        static_cast<float*>(out), rows, K, D);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dist_h_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
