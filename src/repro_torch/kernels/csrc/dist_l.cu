// dist_l: low-dimensional squared L2 distances (paper Dist.L) for sm_90a.
//
// Replaces repro/kernels/dist_l.py: dist_l_pallas. x [B, K, dl] against
// q [B, dl] -> [B, K], accumulated in f32 over c = 0..dl-1 (the order
// fused_expand.cu sums its Dist.L in).
//
// Bound on the card: bytes. Every x element is read once and used for 3
// flops. Design: dl is 15 on the path, too short to spread over a warp
// as dist_h.cu does, so one thread scores one (b, K-row). Neighbouring
// threads read neighbouring rows, so a warp's loads fall in one
// contiguous 32*dl*4-byte span and the L1 serves the rest of each line;
// q's row is read through the read-only cache by every thread of the row.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreadsPerBlock = 256;

__global__ void dist_l_kernel(const float* __restrict__ x,
                              const float* __restrict__ q,
                              float* __restrict__ out, long long rows, int K,
                              int dl) {
  const long long r = (long long)blockIdx.x * kThreadsPerBlock + threadIdx.x;
  if (r >= rows) return;
  const float* xr = x + r * dl;
  const float* qr = q + (r / K) * dl;
  float acc = 0.f;
  for (int c = 0; c < dl; ++c) {
    const float df = xr[c] - __ldg(qr + c);
    acc += df * df;
  }
  out[r] = acc;
}

}  // namespace

extern "C" int dist_l_launch(const void* x, const void* q, void* out, int B,
                             int K, int dl, void* stream) {
  const long long rows = (long long)B * K;
  const dim3 grid((unsigned)((rows + kThreadsPerBlock - 1) / kThreadsPerBlock));
  dist_l_kernel<<<grid, kThreadsPerBlock, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(q),
      static_cast<float*>(out), rows, K, dl);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dist_l_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
