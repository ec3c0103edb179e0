// trip_fold: one traversal trip's whole frontier update for sm_90a, in
// one launch.
//
// Replaces, on the search path, the three merges of a trip and the glue
// around them (repro/core/search_jax.py:_layer_body's accept test, its
// stacked stable sort of the feeds and its three merge_topk_sorted calls
// into F, C and the C_pca heap; each merge is
// repro/kernels/merge_sorted.py: merge_sorted_pallas). Per query row:
//
//   1. accept = dh < F_d[ef - 1] (F's bound before the trip), or, with
//      the per-row `ef_eff` (the slotted search's effective ef, in
//      [1, ef]), dh < F_d[ef_eff - 1];
//   2. the feeds: the C row (where(accept, dh, INF), where(accept, cand,
//      -1)); the F row, the C row with tombstoned ids masked out too when
//      `deleted` is given, else the C row itself; the heap row
//      where(accept, kv, INF) when kv is given, else the C row's dists;
//   3. each feed ranked by (dist, slot), the order of a stable sort:
//      rank_s = #{j : f_j < f_s or (f_j == f_s and j < s)};
//   4. each feed merged into its frontier, k-bounded, with the tie rules
//      of merge_sorted.cu: frontier element i lands at i + #{feed < a_i},
//      feed element s at rank_s + #{a <= f_s} (ties to the frontier, then
//      the lower slot). C's frontier is C[W:] followed by W (INF, -1)
//      pads (the trip's pop), or C as it is on a row whose `pop` byte is
//      0 (a slot that is done or frozen at its step budget keeps its
//      frontier); the heap keeps only dists;
//   5. new F, C and heap tensors: the state is read by all three merges,
//      so it is never written in place.
//
// Stacked (the slotted sharded programs: every shard's slots in one
// launch, as the reference's vmap adds a shard axis to its Pallas grid),
// `deleted` is [P, nw] and the B rows shard-major: row r reads the words
// of shard r / shard_b (at r / shard_b * del_stride); unstacked,
// del_stride is 0. Nothing else of the fold depends on the shard.
//
// The fold compares and moves; it does no arithmetic, so it equals its
// plain version (kernels/ref.py: trip_fold_ref) bit for bit on any data
// whose frontiers are ascending, -0.0 beside 0.0 (equal, resolved by
// slot), INF pads and -1 ids included. With `ef_eff` and `pop` null it
// runs the synchronous search's fold unchanged.
//
// Bound on the card: the launch. A row moves ~1-3 KB and makes a few
// hundred compares, so the kernel costs about one launch, against the
// six to ten launches (accept, where rows, cats, sort, gather, three
// merges) it replaces. Design: one warp per query row. Every word of the
// row (frontiers and feed, dists and ids) is copied into the warp's slice
// of shared memory with 4-byte cp.async before the first compare, so the
// row costs one global round trip (tombstone words, indexed by the
// candidates, a second) and only warp barriers. The feed ranks are counts
// over the slice; the sorted feeds are scattered back into it, and both
// sides of each merge find their positions by binary search. Rows whose
// slice would not fit four to a block (long frontiers or W*k > 64) take
// one block per row, the slice in shared memory up to the card's opt-in
// maximum and past it in a global scratch row. The host plan
// (kernels/trip_fold.py: fold_plan) picks the tier.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_topk.cuh"

namespace {

constexpr float kInf = 3.4e38f;  // repro_torch.constants.INF
constexpr int kWarpsPerBlock = 4;

struct Args {
  const float* Fd;
  const int32_t* Fi;
  const float* Cd;
  const int32_t* Ci;
  const float* Cp;       // null: the filter bypass keeps no heap
  const float* dh;
  const int32_t* cand;
  const float* kv;       // null: the heap is fed the C row's dists
  const int32_t* deleted;  // null: no tombstone masking of the F feed
  long long del_stride;    // words a shard's bitmap (0: one bitmap)
  int shard_b;             // rows a shard (B: one bitmap)
  const int32_t* ef_eff;   // null: the bound is F_d[ef - 1]
  const uint8_t* pop;      // null: every row pops W
  float* oFd;
  int32_t* oFi;
  float* oCd;
  int32_t* oCi;
  float* oCp;
  float* scratch;        // null: the slice lies in shared memory
  int B, ef, cap, k, kk, W;
};

// Words of one row's slice (see the layout in fold_row).
__host__ __device__ inline int slice_words(int ef, int cap, int k, int kk) {
  return 2 * ef + 2 * cap + k + 8 * kk;
}

// #{a[i] <= v} and #{a[i] < v} over an ascending a[0..n).
__device__ __forceinline__ int count_le(const float* a, int n, float v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}
__device__ __forceinline__ int count_lt(const float* a, int n, float v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// rank of f[s] among f[0..n) by (value, slot)
__device__ __forceinline__ int rank_of(const float* f, int n, int s) {
  const float v = f[s];
  int r = 0;
  for (int j = 0; j < n; ++j) {
    const float w = f[j];
    r += (w < v) | ((w == v) & (j < s));
  }
  return r;
}

__device__ __forceinline__ void copy_word(uint32_t* dst, const void* src,
                                          bool async) {
  if (async) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
  } else {
    *dst = *static_cast<const uint32_t*>(src);
  }
}

// One row by a group of G threads (thread t of the group); sync is the
// group's barrier. sl is the row's slice of slice_words() words.
template <class Sync>
__device__ __forceinline__ void fold_row(const Args& a, int row, int t,
                                         int G, uint32_t* sl, bool async,
                                         Sync sync) {
  const int ef = a.ef, cap = a.cap, k = a.k, kk = a.kk, W = a.W;
  const bool has_cp = a.Cp != nullptr;
  // the slice: frontiers, the feed as read, the masked feeds, the sorted
  // feeds
  float* Fd = reinterpret_cast<float*>(sl);
  int32_t* Fi = reinterpret_cast<int32_t*>(sl + ef);
  float* Cd = reinterpret_cast<float*>(sl + 2 * ef);
  int32_t* Ci = reinterpret_cast<int32_t*>(sl + 2 * ef + cap);
  float* Pd = reinterpret_cast<float*>(sl + 2 * ef + 2 * cap);
  uint32_t* feed = sl + 2 * ef + 2 * cap + k;
  float* cv = reinterpret_cast<float*>(feed);            // dh, then C row
  int32_t* ci = reinterpret_cast<int32_t*>(feed + kk);   // cand, then C ids
  float* pv = reinterpret_cast<float*>(feed + 2 * kk);   // kv, then heap
  float* fv = reinterpret_cast<float*>(feed + 3 * kk);   // F row
  int32_t* fi = reinterpret_cast<int32_t*>(feed + 4 * kk);
  float* sC = reinterpret_cast<float*>(feed + 5 * kk);   // sorted feeds
  float* sF = reinterpret_cast<float*>(feed + 6 * kk);
  float* sP = reinterpret_cast<float*>(feed + 7 * kk);
  const size_t r = row;
  // the trip's pop (slotted: only where the row's pop byte is set) and
  // the bound's slot (slotted: the row's effective ef)
  const int shift = (a.pop == nullptr || a.pop[r] != 0) ? W : 0;
  const int bslot =
      a.ef_eff == nullptr ? ef - 1 : min(max(a.ef_eff[r], 1), ef) - 1;
  // the row's shard's tombstone words
  const int32_t* del = a.deleted == nullptr
      ? nullptr
      : a.deleted + (size_t)(row / a.shard_b) * (size_t)a.del_stride;

  // -- one round trip: every word of the row, then the barrier --
  for (int i = t; i < ef; i += G) {
    copy_word(sl + i, a.Fd + r * ef + i, async);
    copy_word(sl + ef + i, a.Fi + r * ef + i, async);
  }
  for (int i = t; i < cap; i += G) {
    if (i + shift < cap) {   // the pop: C[W:], then W (INF, -1) pads
      copy_word(sl + 2 * ef + i, a.Cd + r * cap + i + shift, async);
      copy_word(sl + 2 * ef + cap + i, a.Ci + r * cap + i + shift, async);
    } else {
      Cd[i] = kInf;
      Ci[i] = -1;
    }
  }
  if (has_cp)
    for (int i = t; i < k; i += G) copy_word(sl + 2 * ef + 2 * cap + i,
                                             a.Cp + r * k + i, async);
  for (int s = t; s < kk; s += G) {
    copy_word(feed + s, a.dh + r * kk + s, async);
    copy_word(feed + kk + s, a.cand + r * kk + s, async);
    if (a.kv != nullptr) copy_word(feed + 2 * kk + s, a.kv + r * kk + s,
                                   async);
  }
  if (async) asm volatile("cp.async.wait_all;\n" ::);
  sync();

  // -- the feeds, each slot by its own thread --
  const float bnd = Fd[bslot];
  for (int s = t; s < kk; s += G) {
    const float v = cv[s];
    const int32_t id = ci[s];
    const bool acc = v < bnd;
    bool okF = acc;
    if (del != nullptr) {
      const uint32_t safe = static_cast<uint32_t>(max(id, 0));
      const uint32_t word = static_cast<uint32_t>(del[safe >> 5]);
      okF = acc && ((word >> (safe & 31u)) & 1u) == 0u;
    }
    pv[s] = a.kv != nullptr ? (acc ? pv[s] : kInf) : (acc ? v : kInf);
    cv[s] = acc ? v : kInf;
    ci[s] = acc ? id : -1;
    fv[s] = okF ? v : kInf;
    fi[s] = okF ? id : -1;
  }
  sync();

  // -- feed side: rank, place, and scatter the sorted dists --
  for (int s = t; s < kk; s += G) {
    const int rc = rank_of(cv, kk, s);
    const int rf = a.deleted != nullptr ? rank_of(fv, kk, s) : rc;
    const int rp = a.kv != nullptr ? rank_of(pv, kk, s) : rc;
    sC[rc] = cv[s];
    sF[rf] = fv[s];
    sP[rp] = pv[s];
    int pos = rc + count_le(Cd, cap, cv[s]);
    if (pos < cap) {
      a.oCd[r * cap + pos] = cv[s];
      a.oCi[r * cap + pos] = ci[s];
    }
    pos = rf + count_le(Fd, ef, fv[s]);
    if (pos < ef) {
      a.oFd[r * ef + pos] = fv[s];
      a.oFi[r * ef + pos] = fi[s];
    }
    if (has_cp) {
      pos = rp + count_le(Pd, k, pv[s]);
      if (pos < k) a.oCp[r * k + pos] = pv[s];
    }
  }
  sync();

  // -- frontier side: each element past the feed entries below it --
  for (int i = t; i < ef; i += G) {
    const int pos = i + count_lt(sF, kk, Fd[i]);
    if (pos < ef) {
      a.oFd[r * ef + pos] = Fd[i];
      a.oFi[r * ef + pos] = Fi[i];
    }
  }
  for (int i = t; i < cap; i += G) {
    const int pos = i + count_lt(sC, kk, Cd[i]);
    if (pos < cap) {
      a.oCd[r * cap + pos] = Cd[i];
      a.oCi[r * cap + pos] = Ci[i];
    }
  }
  if (has_cp)
    for (int i = t; i < k; i += G) {
      const int pos = i + count_lt(sP, kk, Pd[i]);
      if (pos < k) a.oCp[r * k + pos] = Pd[i];
    }
}

struct WarpSync {
  __device__ __forceinline__ void operator()() const { __syncwarp(); }
};
struct BlockSync {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};

// a warp per row, four rows a block, each warp's slice in shared memory
__global__ void trip_fold_kernel(Args a) {
  extern __shared__ uint32_t words[];
  const int warp = threadIdx.x / 32;
  const int row = blockIdx.x * kWarpsPerBlock + warp;
  if (row >= a.B) return;  // uniform per warp: only warp barriers below
  const int n = slice_words(a.ef, a.cap, a.k, a.kk);
  fold_row(a, row, threadIdx.x % 32, 32, words + (size_t)warp * n, true,
           WarpSync());
}

// a block per row, the slice in shared memory or a global scratch row
__global__ void trip_fold_kernel_wide(Args a) {
  extern __shared__ uint32_t words[];
  const int row = blockIdx.x;
  const int n = slice_words(a.ef, a.cap, a.k, a.kk);
  const bool in_smem = a.scratch == nullptr;
  uint32_t* sl = in_smem ? words
                         : reinterpret_cast<uint32_t*>(a.scratch) +
                               (size_t)row * n;
  fold_row(a, row, threadIdx.x, blockDim.x, sl, in_smem, BlockSync());
}

}  // namespace

// threads == 0: the warp tier; else a block of `threads` per row, the
// slice in scratch ([B, slice words] f32) when that is not null.
// shard_b: rows a shard (B with one bitmap); del_stride: words a shard's
// bitmap (0 with one bitmap).
extern "C" int trip_fold_launch(const void* Fd, const void* Fi,
                                const void* Cd, const void* Ci,
                                const void* Cp, const void* dh,
                                const void* cand, const void* kv,
                                const void* deleted, long long del_stride,
                                int shard_b, const void* ef_eff,
                                const void* pop, void* oFd, void* oFi,
                                void* oCd, void* oCi, void* oCp, int B,
                                int ef, int cap, int k, int kk, int W,
                                int threads, void* scratch, void* stream) {
  if (ef < 1 || cap < 1 || kk < 1 || W < 0 || (Cp != nullptr && k < 1) ||
      (kv != nullptr && Cp == nullptr) || threads < 0 || threads > 1024 ||
      shard_b < 1 || del_stride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(Fd), static_cast<const int32_t*>(Fi),
               static_cast<const float*>(Cd), static_cast<const int32_t*>(Ci),
               static_cast<const float*>(Cp), static_cast<const float*>(dh),
               static_cast<const int32_t*>(cand),
               static_cast<const float*>(kv),
               static_cast<const int32_t*>(deleted), del_stride, shard_b,
               static_cast<const int32_t*>(ef_eff),
               static_cast<const uint8_t*>(pop),
               static_cast<float*>(oFd), static_cast<int32_t*>(oFi),
               static_cast<float*>(oCd), static_cast<int32_t*>(oCi),
               static_cast<float*>(oCp), static_cast<float*>(scratch),
               B, ef, cap, Cp != nullptr ? k : 0, kk, W};
  const size_t n = slice_words(ef, cap, a.k, kk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (threads == 0) {
    const size_t smem = sizeof(uint32_t) * n * kWarpsPerBlock;
    const cudaError_t err = block_topk::allow_smem(trip_fold_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    trip_fold_kernel<<<(B + kWarpsPerBlock - 1) / kWarpsPerBlock,
                       32 * kWarpsPerBlock, smem, s>>>(a);
  } else {
    const size_t smem = scratch != nullptr ? 0 : sizeof(uint32_t) * n;
    const cudaError_t err =
        block_topk::allow_smem(trip_fold_kernel_wide, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    trip_fold_kernel_wide<<<B, threads, smem, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* trip_fold_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
