// dist_l: low-dimensional squared L2 distances (paper Dist.L) for sm_90a.
//
// Replaces repro/kernels/dist_l.py: dist_l_pallas. x [B, K, dl] (f32 or
// bf16, widened in registers as the TPU kernel widens its block) against
// q [B, dl] f32 -> [B, K] f32, accumulated in f32 over c = 0..dl-1 (the
// order of every Dist.L body here, filter_rows.cuh: dist()).
//
// Bound on the card: bytes. Every x element is read once and used for 3
// flops. Design: one thread scores one row, dl a compile-time 15 or 16
// (the configs' widths; any other width a runtime loop), so the row's dl
// loads (through the read-only cache, as are q's) are unrolled and all
// in flight before the first subtraction; neighbouring threads read
// neighbouring rows, so a warp's loads fall in one contiguous span of 32
// rows that L1 serves line by line. A bf16 row is half the bytes. The
// host plan (kernels/dist_l.py: dist_l_plan) spreads a small batch over
// the SMs with narrower blocks.
//
// The design that gives each block a tile of rows, copied into shared
// memory with coalesced 16-byte loads and summed from there, is built and
// timed beside this kernel by bench/dist_l_designs.py (its figures in
// PERF.md). It is slower at every shape the search runs: the copy, the
// block barrier and the shared-memory reads cost more than the unrolled
// row loads they replace, which L1 already serves line by line.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <class Pay, int DL>
__global__ void dist_l_kernel(const Pay* __restrict__ x,
                              const float* __restrict__ q,
                              float* __restrict__ out, long long rows, int K,
                              int dl_rt) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const int dl = DL > 0 ? DL : dl_rt;
  const Pay* xr = x + r * dl;
  const float* qr = q + (r / K) * dl;
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < dl; ++c) {
    const float df = widen(__ldg(xr + c)) - __ldg(qr + c);
    acc += df * df;
  }
  out[r] = acc;
}

template <class Pay>
int run(const void* x, const void* q, void* out, int B, int K, int dl,
        int threads, void* stream) {
  if (threads < 32 || threads > 1024 || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  void (*kern)(const Pay*, const float*, float*, long long, int, int) =
      &dist_l_kernel<Pay, 0>;
  if (dl == 15) kern = &dist_l_kernel<Pay, 15>;
  if (dl == 16) kern = &dist_l_kernel<Pay, 16>;
  const long long rows = (long long)B * K;
  kern<<<(unsigned)((rows + threads - 1) / threads), threads, 0,
         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Pay*>(x), static_cast<const float*>(q),
      static_cast<float*>(out), rows, K, dl);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// threads: the host plan's (kernels/dist_l.py: dist_l_plan); bf16: x is
// bf16, else f32.
extern "C" int dist_l_launch(const void* x, const void* q, void* out, int B,
                             int K, int dl, int threads, int bf16,
                             void* stream) {
  return bf16 ? run<__nv_bfloat16>(x, q, out, B, K, dl, threads, stream)
              : run<float>(x, q, out, B, K, dl, threads, stream);
}

extern "C" const char* dist_l_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
