// fused_filter: Dist.L + kSort.L in one kernel (no mask, no threshold)
// for sm_90a.
//
// Replaces repro/kernels/fused_filter.py: fused_filter_pallas. Per query
// row: Dist.L of the M rows [M, dl] to q in f32 (the rows f32 or bf16,
// widened in registers as the TPU kernel widens its block), then the k
// smallest (dist, index) pairs ascending with ties to the lower index.
//
// Bound on the card: bytes (M*dl*itemsize a row), but at the shapes the
// footprint bench runs ([64, 32, 15]: 123 KB in f32) the time is a chain
// of latencies under the launch: the row's loads, the sums and the rank
// count. Design of the warp tier (M <= 128), one warp a row, four rows a
// block:
//
//   * the row's [M, dl] block is contiguous, so the warp reads it in
//     chunks of four elements (16 bytes in f32, 8 in bf16), lane l taking
//     chunks l, l + 32, ... (four a lane at [32, 15]), all in flight
//     before the first store, together with q; a block that does not
//     start on a chunk's alignment is read element by element, still
//     coalesced. Reading each slot's row in place instead costs dl scalar
//     loads a lane at a dl-element lane stride, each warp load touching
//     dl sectors;
//   * each chunk is widened to four f32 and stored in the warp's slice of
//     shared memory, slot m's row at word m * rw with rw = dl | 1 (odd:
//     lane l's reads of column c fall in 32 distinct banks), one dense
//     16-byte store a chunk where rw == dl (the warp's stores then cover
//     512 contiguous bytes, in either type);
//   * after __syncwarp lane l sums its slots' rows c ascending (dist(),
//     the order of every Dist.L body here, so the result is the other
//     bodies' bits); dl is a compile-time 15 (the configs' d_low) or a
//     runtime width;
//   * the top-k is warp_topk.cuh's rank count, its shuffles unrolled.
//
// The copy goes through registers so that a bf16 chunk is widened once,
// where it is loaded; a cp.async copy would keep the stored type.
//
// Rows past 128 slots take filter_rows.cuh's block tier, and a warp tier
// whose slices would not fit the card's shared memory reads the rows in
// place (filter_rows.cuh's warp body); both over a Blocks source with no
// mask and kMasked off (kernels "fused_filter_kernel_*").
#include "filter_rows.cuh"

namespace {

using expand_rows::Blocks;
using filter_rows::Args;
using filter_rows::round4;
using warp_topk::kInf;

// The staged warp tier's arguments.
template <class Pay>
struct RowArgs {
  const Pay* x;          // [B, M, dl]
  const float* q;        // [B, dl]
  float* out_d;          // [B, k]
  int32_t* out_i;        // [B, k]
  int B, M, dl, k;
  int rw;                // f32 row stride in shared memory (odd, >= dl)
  int words;             // 4-byte words of one warp's slice
  int vec;               // 1: every row's block starts on a chunk boundary
};

// A chunk of four elements as loaded (16 bytes of f32, 8 of bf16), and
// the same four widened to f32.
template <class Pay>
struct Chunk;
template <>
struct Chunk<float> {
  using T = uint4;
  static __device__ __forceinline__ float4 widen(const uint4& w) {
    return make_float4(__uint_as_float(w.x), __uint_as_float(w.y),
                       __uint_as_float(w.z), __uint_as_float(w.w));
  }
};
template <>
struct Chunk<__nv_bfloat16> {
  using T = uint2;                        // little-endian: low half first
  static __device__ __forceinline__ float4 widen(const uint2& w) {
    return make_float4(__uint_as_float(w.x << 16),
                       __uint_as_float(w.x & 0xffff0000u),
                       __uint_as_float(w.y << 16),
                       __uint_as_float(w.y & 0xffff0000u));
  }
};

// Store flat elements e0 .. e0 + 3 of the block as f32 rows at stride rw.
__device__ __forceinline__ void store(float* pay, const float4& v, int e0,
                                      int dl, int rw) {
  if (rw == dl) {                         // dense: one 16-byte store
    *reinterpret_cast<float4*>(pay + e0) = v;
    return;
  }
  const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = e0 + i, m = e / dl;
    pay[m * rw + (e - m * dl)] = f[i];
  }
}

template <class Pay, int PER_LANE, int DL>
__global__ void fused_filter_kernel_rows(RowArgs<Pay> a) {
  extern __shared__ __align__(16) float sh[];
  const int wid = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * filter_rows::kWarpsPerBlock + wid;
  if (row >= a.B) return;  // uniform per warp: shuffles stay full-warp
  const int dl = DL > 0 ? DL : a.dl, M = a.M, rw = a.rw;
  float* qs = sh + (size_t)wid * a.words;
  float* pay = qs + round4(dl);
  const float* qg = a.q + (size_t)row * dl;
  const float q0 = lane < dl ? __ldg(qg + lane) : 0.f;
  const int n = M * dl;                   // elements of the row's block
  const Pay* src = a.x + (size_t)row * n;
  if (a.vec) {
    using C = Chunk<Pay>;
    const int nv = n / 4;
    const typename C::T* v = reinterpret_cast<const typename C::T*>(src);
    for (int i0 = lane; i0 < nv; i0 += 4 * 32) {
      typename C::T w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)         // all four loads before a store
        if (i0 + 32 * j < nv) w[j] = __ldg(v + i0 + 32 * j);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (i0 + 32 * j < nv)
          store(pay, C::widen(w[j]), 4 * (i0 + 32 * j), dl, rw);
    }
  } else {
    for (int e = lane; e < n; e += 32) {
      const int m = e / dl;
      pay[m * rw + (e - m * dl)] = filter_rows::widen(src[e]);
    }
  }
  if (lane < dl) qs[lane] = q0;
  for (int c = lane + 32; c < dl; c += 32) qs[c] = __ldg(qg + c);
  __syncwarp();
  float d[PER_LANE];
#pragma unroll
  for (int e = 0; e < PER_LANE; ++e) {
    const int m = e * 32 + lane;
    d[e] = m < M ? filter_rows::dist(pay + m * rw, qs, dl) : kInf;
  }
  warp_topk::write_topk<PER_LANE>(d, M, a.k, lane,
                                  a.out_d + (size_t)row * a.k,
                                  a.out_i + (size_t)row * a.k);
}

// the warp tier's fallback, in place
template <class Pay, int PER_LANE>
__global__ void fused_filter_kernel_direct(Args<Blocks, Pay> a) {
  filter_rows::warp_body<false, PER_LANE, false>(a);
}

template <class Pay>
__global__ void fused_filter_kernel_wide(Args<Blocks, Pay> a) {
  filter_rows::wide_body<false, false>(a);
}

template <class Pay>
struct Kernels {
  static constexpr bool kStages = false;
  template <int P, bool S>
  static auto warp() { return fused_filter_kernel_direct<Pay, P>; }
  template <bool S>
  static auto wide() { return fused_filter_kernel_wide<Pay>; }
};

template <class Pay, int DL>
auto rows_kernel(int per_lane) -> void (*)(RowArgs<Pay>) {
  if (per_lane == 1) return fused_filter_kernel_rows<Pay, 1, DL>;
  if (per_lane == 2) return fused_filter_kernel_rows<Pay, 2, DL>;
  if (per_lane == 4) return fused_filter_kernel_rows<Pay, 4, DL>;
  return nullptr;
}

template <class Pay>
int run(const void* x, const void* q, void* out_d, void* out_i, int B,
        int M, int dl, int k, int per_lane, int threads, int staged,
        int vec, int rw, void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!staged) {
    const Args<Blocks, Pay> a{{nullptr, M},
                              static_cast<const Pay*>(x),
                              static_cast<const float*>(q), nullptr, 0,
                              static_cast<float*>(out_d),
                              static_cast<int32_t*>(out_i),
                              static_cast<float*>(scratch), B, M, dl, k,
                              {0, 0}};
    return filter_rows::launch<Kernels<Pay>>(a, per_lane, threads, false,
                                             stream);
  }
  // chunk loads need every row's block on a 4-element boundary
  const bool vec_ok =
      reinterpret_cast<uintptr_t>(x) % (4 * sizeof(Pay)) == 0
      && ((long long)M * dl) % 4 == 0;
  if (M > 32 * per_lane || rw < dl || rw % 2 == 0 || (vec && !vec_ok))
    return static_cast<int>(cudaErrorInvalidValue);
  void (*kern)(RowArgs<Pay>) = dl == 15 ? rows_kernel<Pay, 15>(per_lane)
                                        : rows_kernel<Pay, 0>(per_lane);
  if (kern == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int words = round4(dl) + round4(M * rw);
  const RowArgs<Pay> a{static_cast<const Pay*>(x),
                       static_cast<const float*>(q),
                       static_cast<float*>(out_d),
                       static_cast<int32_t*>(out_i), B, M, dl, k, rw, words,
                       vec};
  constexpr int W = filter_rows::kWarpsPerBlock;
  const size_t smem = sizeof(float) * (size_t)W * words;
  const cudaError_t err = block_topk::allow_smem(kern, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<(B + W - 1) / W, 32 * W, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The host plan (kernels/fused_filter.py: fused_filter_plan) sets the
// tier: staged (the warp tier above: per_lane, vec, rw) or not
// (filter_rows.cuh: per_lane 1/2/4 in place, or 0 for the block tier of
// `threads`, the distances in scratch [B, M] when it is not null). bf16:
// the rows are bf16, else f32.
extern "C" int fused_filter_launch(const void* x, const void* q, void* out_d,
                                   void* out_i, int B, int M, int dl, int k,
                                   int per_lane, int threads, int staged,
                                   int vec, int rw, int bf16, void* scratch,
                                   void* stream) {
  return bf16 ? run<__nv_bfloat16>(x, q, out_d, out_i, B, M, dl, k, per_lane,
                                   threads, staged, vec, rw, scratch, stream)
              : run<float>(x, q, out_d, out_i, B, M, dl, k, per_lane, threads,
                           staged, vec, rw, scratch, stream);
}

extern "C" const char* fused_filter_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
