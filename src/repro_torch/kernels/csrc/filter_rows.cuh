// filter_rows: Dist.L then kSort.L per query row, the one body of
// fused_expand.cu (the reference's op over a gathered block, and the
// search's expand that reads the popped rows in place) and
// fused_filter.cu (sm_90a).
//
// Per query row: Dist.L of the M payload rows [dl] of its slots to q in
// f32, then the k smallest (dist, index) pairs ascending with ties to the
// lower index. Where slot m's payload lives, whether it counts and what a
// winner writes is the row source's (expand_rows.cuh: Blocks, a gathered
// [B, M, dl] block; Rows, the layer's [N, M0, dl] table through the
// popped ids). With kMasked (the expands) a distance counts only where
// the slot is ok and d < th[row], else it is INF; without it
// (fused_filter) every distance counts and th is not read. The slots of a
// gated-off popped node load no payload: their distance is INF whatever
// the payload. Any other slot's row is read whether or not the slot is ok
// (a -1 neighbour, a masked slot) and masked after, so the read waits on
// nothing but the row's address.
//
// Bound on the card: bytes. A row's payload is M*dl*4 bytes (1.9 KB at
// M=32, dl=15) and the work is ~3*M*dl flops plus M*M compares, far
// below Hopper's operations-per-byte line. Design: one warp per query
// row, lane l owning slots l, l+32, ... (PER_LANE of them, M <= 32 *
// PER_LANE <= 128), the distances in registers and the top-k the
// warp-shuffle rank count of warp_topk.cuh (shared with pq_adc_expand.cu).
//
// Staged or direct is fixed per source, at compile time (K::kStages):
// Rows (the search's expand, its popped nodes' blocks scattered over the
// layer) stages, Blocks (the gathered block of the reference's op and of
// fused_filter) reads in place: each the body that was faster where the
// main path runs it (PERF.md: Rows at W = 1, Blocks at the footprint
// bench's row). Staged: the warp first copies q and each
// gated popped node's contiguous [M0, dl] block into its slice of shared
// memory with cp.async, coalesced: 16-byte copies that bypass L1
// (cp.async.cg) when every block is 16-byte aligned and dl is odd, else
// 4-byte copies with each slot row at an odd stride rw = dl | 1.
// Gated-off nodes are not copied. The slots' adjacency words are loaded
// while the copies fly; then cp.async.wait_all and __syncwarp, and lane
// l reads its slot's row from shared memory at word l * rw + c: an odd
// stride, so the 32 lanes hit 32 distinct banks. Where a row's staging
// area does not fit the card's shared memory (the host plan,
// kernels/fused_filter.py: filter_plan), Rows reads in place too.
// Direct: each lane reads its slot's row in place, dl loads a lane. The
// sum runs c ascending either way (dist()), so both give the same bits,
// and the same bits as the gathered-block op on the same rows.
//
// Wider rows (M > 128: expand_width * M0 past four warps' worth) take the
// wide tier, one block per row, the distances in shared memory or, past
// the card's opt-in maximum, a global scratch row (block_topk.cuh), the
// payload staged by the whole block or read in place.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_topk.cuh"
#include "expand_rows.cuh"
#include "warp_topk.cuh"

namespace filter_rows {

using warp_topk::kInf;
constexpr int kWarpsPerBlock = 4;

__host__ __device__ __forceinline__ int round4(int n) {
  return (n + 3) & ~3;
}

// How a row's payload is staged: cp.async copies of `copy` bytes (16 or
// 4), slot m's row at word m * rw of the payload area (rw == dl for
// 16-byte copies).
struct Stage {
  int copy;
  int rw;
};

// Words of one row's staging area: q, then the G * S slot rows, each
// part a whole number of 16-byte chunks (kernels/fused_filter.py:
// stage_words).
__host__ __device__ __forceinline__ int stage_words(int G, int S, int dl,
                                                    int rw) {
  return round4(dl) + round4(G * S * rw);
}

template <class Src>
struct Args {
  Src src;
  const float* x;        // the payload table, row pay_row at x + pay_row*dl
  const float* q;        // [B, dl]
  const float* th;       // [B] through th_stride; null when unmasked
  long long th_stride;
  float* out_d;          // [B, k]
  int32_t* out_i;        // [B, k]
  float* scratch;        // [B, M] for the global tier, else null
  int B, M, dl, k;
  Stage st;
};

// Dist.L of one payload row to q, summed c ascending in f32: the one
// order of every body here, staged or not.
__device__ __forceinline__ float dist(const float* __restrict__ xm,
                                      const float* __restrict__ qr, int dl) {
  float acc = 0.f;
  for (int c = 0; c < dl; ++c) {
    const float df = xm[c] - qr[c];
    acc += df * df;
  }
  return acc;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The staged row loader (Rows only): threads t = 0..T-1 of the row's
// warp or block issue the copies of q (words 0..dl) and of every gated
// popped node's contiguous payload block (slot m at word round4(dl) + m *
// rw) into sh. Only issues them: the caller waits (cp_async_wait_all)
// and syncs.
template <class Src>
__device__ __forceinline__ void stage_row(const Args<Src>& a, int row,
                                          float* sh, int t, int T) {
  const int dl = a.dl, S = a.src.group_size(), G = a.src.groups();
  const float* qr = a.q + (size_t)row * dl;
  for (int c = t; c < dl; c += T) cp_async4(sh + c, qr + c);
  float* pay = sh + round4(dl);
  const int n = S * dl;                 // floats of one group's block
  for (int g = 0; g < G; ++g) {
    bool gate;
    const size_t r0 = a.src.group_row(row, g, gate);
    if (!gate) continue;                // uniform: no load for its slots
    const float* src = a.x + r0 * dl;
    float* dst = pay + (size_t)g * S * a.st.rw;
    if (a.st.copy == 16) {
      for (int i = 4 * t; i < n; i += 4 * T) cp_async16(dst + i, src + i);
    } else {
      for (int i = t; i < n; i += T) {
        const int j = i / dl;
        cp_async4(dst + j * a.st.rw + (i - j * dl), src + i);
      }
    }
  }
}

// One slot's distance: INF unless live (else no payload load), ok and,
// masked, below t.
template <bool kMasked>
__device__ __forceinline__ float slot_dist(const expand_rows::Slot& sl,
                                           const float* xm, const float* qs,
                                           int dl, float t) {
  if (!sl.live) return kInf;
  const float d = dist(xm, qs, dl);
  return sl.ok && (!kMasked || d < t) ? d : kInf;
}

// A warp per row (the caller names the kernel).
template <bool kMasked, int PER_LANE, bool kStaged, class Src>
__device__ __forceinline__ void warp_body(const Args<Src>& a) {
  extern __shared__ __align__(16) float sh[];
  const int wid = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarpsPerBlock + wid;
  if (row >= a.B) return;  // uniform per warp: shuffles below stay full-warp
  const int M = a.M, dl = a.dl;
  float* ws = sh;
  if constexpr (kStaged) {
    ws += (size_t)wid * stage_words(a.src.groups(), a.src.group_size(), dl,
                                    a.st.rw);
    stage_row(a, row, ws, lane, 32);
  }
  const float t = kMasked ? a.th[(size_t)row * a.th_stride] : 0.f;
  expand_rows::Slot sl[PER_LANE];
#pragma unroll
  for (int e = 0; e < PER_LANE; ++e) {
    const int m = e * 32 + lane;
    sl[e] = m < M ? a.src.at(row, m)
                  : expand_rows::Slot{0, 0, false, false};
  }
  if constexpr (kStaged) {
    cp_async_wait_all();
    __syncwarp();
  }
  const float* qs = kStaged ? ws : a.q + (size_t)row * dl;
  float d[PER_LANE];
  int32_t pay[PER_LANE];
#pragma unroll
  for (int e = 0; e < PER_LANE; ++e) {
    const int m = e * 32 + lane;
    const float* xm = kStaged ? ws + round4(dl) + m * a.st.rw
                              : a.x + sl[e].pay_row * dl;
    // never ranked past M: only m < M are written
    d[e] = slot_dist<kMasked>(sl[e], xm, qs, dl, t);
    pay[e] = sl[e].id;
  }
  warp_topk::write_topk<PER_LANE>(d, pay, M, a.k, lane,
                                  a.out_d + (size_t)row * a.k,
                                  a.out_i + (size_t)row * a.k);
}

// A block per row (the caller names the kernel): the distances in shared
// memory, or in the global scratch row when a.scratch is set; staged, the
// payload after them.
template <bool kMasked, bool kStaged, class Src>
__device__ __forceinline__ void wide_body(const Args<Src>& a) {
  extern __shared__ __align__(16) float sh[];
  const int row = blockIdx.x, M = a.M, dl = a.dl;
  float* buf = a.scratch != nullptr ? a.scratch + (size_t)row * M : sh;
  float* ws = a.scratch != nullptr ? sh : sh + round4(M);
  if constexpr (kStaged) {
    stage_row(a, row, ws, threadIdx.x, blockDim.x);
    cp_async_wait_all();
    __syncthreads();
  }
  const float* qs = kStaged ? ws : a.q + (size_t)row * dl;
  const float t = kMasked ? a.th[(size_t)row * a.th_stride] : 0.f;
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    const expand_rows::Slot sl = a.src.at(row, m);
    const float* xm = kStaged ? ws + round4(dl) + m * a.st.rw
                              : a.x + sl.pay_row * dl;
    buf[m] = slot_dist<kMasked>(sl, xm, qs, dl, t);
  }
  __syncthreads();
  block_topk::write_topk(buf, M, a.k, a.out_d + (size_t)row * a.k,
                         a.out_i + (size_t)row * a.k,
                         expand_rows::SrcId<Src>{a.src, row});
}

// The warp and wide kernels of K for a launch, staged only where K's
// source stages (K::kStages) and the host plan staged the row.
template <class K, int P, class Src>
auto warp_kernel(bool staged) -> void (*)(Args<Src>) {
  if constexpr (K::kStages) {
    if (staged) return K::template warp<P, true>();
  }
  return K::template warp<P, false>();
}

template <class K, class Src>
auto wide_kernel(bool staged) -> void (*)(Args<Src>) {
  if constexpr (K::kStages) {
    if (staged) return K::template wide<true>();
  }
  return K::template wide<false>();
}

// Launch on `s` in the tier the host plan chose: per_lane 1, 2 or 4 (a
// warp per row, M <= 32 * per_lane), or 0 (a block of `threads` per row,
// the distances in shared memory, or in a.scratch [B, M] when that is
// not null); `staged` (only where K::kStages) stages each row's payload
// by a.st. K names the kernels: K::warp<PER_LANE, STAGED>() and
// K::wide<STAGED>().
template <class K, class Src>
int launch(const Args<Src>& a, int per_lane, int threads, bool staged,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (per_lane > 0 && a.M > 32 * per_lane)
    return static_cast<int>(cudaErrorInvalidValue);
  size_t words = 0;
  if (staged) {
    if constexpr (!K::kStages) {
      return static_cast<int>(cudaErrorInvalidValue);
    } else {
      // 16-byte copies need every node's block 16-byte aligned; 4-byte
      // ones a row stride of at least dl
      const int S = a.src.group_size();
      const bool ok16 = a.st.copy == 16 && a.st.rw == a.dl
          && (S * a.dl) % 4 == 0
          && reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
      if (!(ok16 || (a.st.copy == 4 && a.st.rw >= a.dl)))
        return static_cast<int>(cudaErrorInvalidValue);
      words = stage_words(a.src.groups(), S, a.dl, a.st.rw);
    }
  }
  void (*kern)(Args<Src>) = nullptr;
  size_t smem = 0;
  dim3 grid, block;
  if (per_lane == 1 || per_lane == 2 || per_lane == 4) {
    if (per_lane == 1) kern = warp_kernel<K, 1, Src>(staged);
    if (per_lane == 2) kern = warp_kernel<K, 2, Src>(staged);
    if (per_lane == 4) kern = warp_kernel<K, 4, Src>(staged);
    smem = sizeof(float) * kWarpsPerBlock * words;
    grid = dim3((a.B + kWarpsPerBlock - 1) / kWarpsPerBlock);
    block = dim3(32 * kWarpsPerBlock);
  } else if (per_lane == 0 && threads > 0 && threads <= 1024) {
    kern = wide_kernel<K, Src>(staged);
    smem = sizeof(float) * ((a.scratch != nullptr ? 0 : round4(a.M))
                            + words);
    grid = dim3(a.B);
    block = dim3(threads);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = block_topk::allow_smem(kern, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, block, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace filter_rows
