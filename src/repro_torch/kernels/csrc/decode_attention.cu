// decode_attention: one query token against a KV cache, masked by a
// per-batch valid prefix `length`, for sm_90a.
//
// Replaces repro/kernels/decode_attention.py: decode_attention_pallas.
// q [B, H, d], k/v [B, H, T, d] (f32 or bf16), length [B] int32 ->
// out [B, H, d] in q's type: softmax over the keys t < length of
// (q . k_t) * d^-0.5 in f32, times v. A row that sees no key (length <= 0)
// gives 0, as the TPU kernel does by skipping every block.
//
// Bound on the card: bytes. Each valid K/V element is read once and used
// for one multiply-add, far below Hopper's operations-per-byte line, so
// the kernel has to keep enough loads in flight to fill the memory
// system. The TPU kernel walks the cache of one (b, h) in order on one
// core; one block per (b, h) here would occupy 4 of 132 SMs at the
// bench's B*H = 4. Design (flash-decoding): the cache axis is split into
// `n_split` chunks of `chunk` keys (the wrapper picks them so that B*H *
// n_split blocks fill the card); a block of four warps owns one (b*h,
// chunk) and each warp walks tiles of 32 keys: lane l holds d/32 of q's
// elements, one warp-wide dot and shuffle reduction per key, the 32
// logits of a tile in one register each, one online-softmax rescale per
// tile, and the key and value rows loaded 8 at a time so that several
// rows are in flight per warp. The four warps merge through shared
// memory into one partial (max, sum, accumulator) per chunk; a second
// kernel merges the chunks. `length` is read on the card (no host sync);
// chunks past it only write an empty partial. Arithmetic in f32.
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_elem.cuh"

namespace {

using attn::kNegInf;
constexpr int kWarps = 4;
constexpr int kGroup = 8;  // key rows loaded together per warp

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// grid (B*H, n_split), block 32*kWarps. E = padded d / 32 elements a lane.
template <typename Raw, int E>
__global__ void __launch_bounds__(32 * kWarps)
    decode_partial_kernel(const Raw* __restrict__ q, const Raw* __restrict__ k,
                          const Raw* __restrict__ v,
                          const int32_t* __restrict__ length,
                          float* __restrict__ part_ml,
                          float* __restrict__ part_acc, int H, int T, int d,
                          int chunk, float scale, bool vec) {
  __shared__ float sh_m[kWarps], sh_l[kWarps];
  __shared__ float sh_acc[kWarps][32 * E];
  const int bh = blockIdx.x;
  const int split = blockIdx.y, n_split = gridDim.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int len = min(max(length[bh / H], 0), T);
  const int t0 = split * chunk;
  const int t1 = min(t0 + chunk, len);
  const int c0 = lane * E;  // this lane's first element of a row
  const int lim = d - c0;   // how many of its E elements exist

  float qv[E];
  attn::load_n<Raw, E>(q + (size_t)bh * d + c0, vec, lim, qv);
  const Raw* kb = k + (size_t)bh * T * d + c0;
  const Raw* vb = v + (size_t)bh * T * d + c0;

  float m = kNegInf, l = 0.f, acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;

  for (int tb = t0 + warp * 32; tb < t1; tb += kWarps * 32) {
    // logits of keys tb .. tb+31: key tb+j ends up in lane j
    float lg = kNegInf;
#pragma unroll
    for (int g = 0; g < 32; g += kGroup) {
      float kr[kGroup][E];
#pragma unroll
      for (int jj = 0; jj < kGroup; ++jj) {
        const int t = tb + g + jj;
        if (t < t1) {
          attn::load_n<Raw, E>(kb + (size_t)t * d, vec, lim, kr[jj]);
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e) kr[jj][e] = 0.f;
        }
      }
#pragma unroll
      for (int jj = 0; jj < kGroup; ++jj) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) s += qv[e] * kr[jj][e];
        s = warp_sum(s) * scale;
        if (lane == g + jj) lg = s;
      }
    }
    const bool vis = tb + lane < t1;
    const float m_new = fmaxf(m, warp_max(vis ? lg : kNegInf));
    const float p = vis ? expf(lg - m_new) : 0.f;
    const float corr = expf(m - m_new);
    l = l * corr + warp_sum(p);
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] *= corr;
    m = m_new;
#pragma unroll
    for (int g = 0; g < 32; g += kGroup) {
      float vr[kGroup][E];
#pragma unroll
      for (int jj = 0; jj < kGroup; ++jj) {
        const int t = tb + g + jj;
        if (t < t1) {
          attn::load_n<Raw, E>(vb + (size_t)t * d, vec, lim, vr[jj]);
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e) vr[jj][e] = 0.f;
        }
      }
#pragma unroll
      for (int jj = 0; jj < kGroup; ++jj) {
        const float pj = __shfl_sync(0xffffffffu, p, g + jj);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] += pj * vr[jj][e];
      }
    }
  }

  // merge the four warps' partials into this chunk's
  if (lane == 0) {
    sh_m[warp] = m;
    sh_l[warp] = l;
  }
#pragma unroll
  for (int e = 0; e < E; ++e) sh_acc[warp][c0 + e] = acc[e];
  __syncthreads();
  float mm = sh_m[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) mm = fmaxf(mm, sh_m[w]);
  float sc[kWarps];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) sc[w] = expf(sh_m[w] - mm);
  const size_t part = (size_t)bh * n_split + split;
  if (threadIdx.x == 0) {
    float ll = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) ll += sh_l[w] * sc[w];
    part_ml[2 * part] = mm;
    part_ml[2 * part + 1] = ll;
  }
  for (int c = threadIdx.x; c < d; c += 32 * kWarps) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += sh_acc[w][c] * sc[w];
    part_acc[part * d + c] = a;
  }
}

// grid B*H, block 128: merge the n_split partials of one (b, h).
template <typename Raw>
__global__ void decode_combine_kernel(const float* __restrict__ part_ml,
                                      const float* __restrict__ part_acc,
                                      Raw* __restrict__ out, int n_split,
                                      int d) {
  const int bh = blockIdx.x;
  const float* ml = part_ml + (size_t)bh * n_split * 2;
  const float* pa = part_acc + (size_t)bh * n_split * d;
  float mm = kNegInf;
  for (int s = 0; s < n_split; ++s) mm = fmaxf(mm, ml[2 * s]);
  float ll = 0.f;
  for (int s = 0; s < n_split; ++s) ll += ml[2 * s + 1] * expf(ml[2 * s] - mm);
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float a = 0.f;
    for (int s = 0; s < n_split; ++s)
      a += pa[(size_t)s * d + c] * expf(ml[2 * s] - mm);
    out[(size_t)bh * d + c] = attn::Elem<Raw>::pack(a / fmaxf(ll, 1e-30f));
  }
}

template <typename Raw, int E>
int launch_typed(const void* q, const void* k, const void* v,
                 const int32_t* length, float* part_ml, float* part_acc,
                 void* out, int B, int H, int T, int d, int chunk,
                 int n_split, float scale, bool vec, cudaStream_t s) {
  const dim3 grid(B * H, n_split);
  decode_partial_kernel<Raw, E><<<grid, 32 * kWarps, 0, s>>>(
      static_cast<const Raw*>(q), static_cast<const Raw*>(k),
      static_cast<const Raw*>(v), length, part_ml, part_acc, H, T, d, chunk,
      scale, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<Raw><<<B * H, 128, 0, s>>>(part_ml, part_acc,
                                                  static_cast<Raw*>(out),
                                                  n_split, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename Raw>
int launch_d(const void* q, const void* k, const void* v,
             const int32_t* length, float* part_ml, float* part_acc,
             void* out, int B, int H, int T, int d, int chunk, int n_split,
             float scale, bool aligned, cudaStream_t s) {
  // vec loads need every lane's E elements in bounds and aligned
#define DECODE_CASE(E)                                                      \
  if (d <= 32 * (E))                                                        \
    return launch_typed<Raw, E>(q, k, v, length, part_ml, part_acc, out, B, \
                                H, T, d, chunk, n_split, scale,             \
                                aligned && d == 32 * (E), s);
  DECODE_CASE(1)
  DECODE_CASE(2)
  DECODE_CASE(4)
  DECODE_CASE(8)
#undef DECODE_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Static shared memory of one partial block at head dim d (bytes), for
// callers that report it.
extern "C" int decode_attention_smem_bytes(int d) {
  const int e = d <= 32 ? 1 : d <= 64 ? 2 : d <= 128 ? 4 : 8;
  return (int)sizeof(float) * (2 * kWarps + kWarps * 32 * e);
}

// dtype: 0 = f32, 1 = bf16. part_ml [B*H*n_split*2] and part_acc
// [B*H*n_split*d] are f32 scratch allocated by the caller.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* length,
                                       void* part_ml, void* part_acc,
                                       void* out, int B, int H, int T, int d,
                                       int chunk, int n_split, float scale,
                                       int dtype, void* stream) {
  if (d < 1 || d > 256 || chunk < 1 || n_split < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = ((reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v)) % 16) == 0;
  const int32_t* len = static_cast<const int32_t*>(length);
  float* ml = static_cast<float*>(part_ml);
  float* pa = static_cast<float*>(part_acc);
  if (dtype == 0)
    return launch_d<float>(q, k, v, len, ml, pa, out, B, H, T, d, chunk,
                           n_split, scale, aligned, s);
  if (dtype == 1)
    return launch_d<unsigned short>(q, k, v, len, ml, pa, out, B, H, T, d,
                                    chunk, n_split, scale, aligned, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
