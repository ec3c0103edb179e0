// decode_attention: one query token against a KV cache, masked by a
// per-batch valid prefix `length`, in one launch, for sm_90a.
//
// Replaces repro/kernels/decode_attention.py: decode_attention_pallas.
// q [B, H, d], k/v [B, KV, T, d] (f32 or bf16), length [B] int32 ->
// out [B, H, d] in q's type: softmax over the keys t < length of
// (q . k_t) * d^-0.5 in f32, times v. H = KV * group (grouped-query
// attention): query row bh = b * H + h reads the cache of kv head
// h / group, row bh / group of the [B*KV, T, d] caches. A row that sees
// no key (length <= 0) gives 0, as the TPU kernel does by skipping every
// block.
//
// Bound on the card: bytes. Each valid K/V element is read once and used
// for one multiply-add, far below Hopper's operations-per-byte line, so
// what matters is how many bytes are in flight, how many dependent round
// trips a block makes and how many warps hide the compute's latency. The
// TPU kernel walks the cache of one (b, h) in order on one core. Design:
//
// * Split. The cache axis is cut into n_split chunks (the host plan,
//   kernels/decode_attention.py: split_plan), one block each. Chunks past
//   `length` (read on the card) exit at once.
// * Copy first. One warp copies the chunk's K and V tiles (`tile` rows
//   each) into shared memory before any arithmetic: V does not depend on
//   the logits, so it travels with K. Each stage's copies complete on its
//   `full` mbarrier: one TMA bulk copy per tile where rows are 16-byte
//   multiples and the caches 16-byte aligned, 4-byte cp.async where rows
//   are 4-byte multiples, plain loads otherwise (bf16 at odd d). A chunk
//   of at most `stages` tiles is in flight at once; longer ones stream
//   through a ring whose `empty` mbarriers the compute warps release.
//   Tiles past `length` are not copied.
// * Compute from shared memory. G lanes read one key's row (E elements
//   each, a 16-byte vector where the stage allows), so a warp takes 32/G
//   keys a step and kSteps steps a tile: the steps' K and V rows load
//   together, independent dots and G-lane shuffle sums, then one
//   online-softmax update a tile per lane group (no shuffle across
//   groups until the warp's end), exponentials in base 2 on log2-scaled
//   logits, the PV sum in f32. Each warp's work is a latency-bound chain
//   of loads, shuffles and exponentials, so an SM needs many warps: 8
//   compute warps a block, two blocks an SM (with 4, one warp a
//   scheduler, the compute and not the copies set a tile's time).
// * Merge in the same launch. Each block folds its warps' (m, l, acc[d])
//   in shared memory. A row with one busy chunk writes out directly;
//   otherwise each block publishes its state to global scratch, fences,
//   and takes a ticket from its row's counter (atomicAdd). The block that
//   draws the last ticket merges the states (warp w chunks w, w + 8, ...
//   in order, then the warps in order), writes out and resets the counter
//   to 0, so the next call and every CUDA-graph replay find it zeroed (the
//   wrapper zeroes it once, at allocation). The merge order is fixed: the
//   result is deterministic. Calls that share the counter must not
//   overlap (one stream at a time on a device).
//
// (A thread block cluster per row, merging through distributed shared
// memory, was tried first: clusters of up to 8 one-SM blocks strand SMs of
// each GPC, and a chunk past `length` holds its SM until block 0 merges,
// so at starcoder2-3b's width even its copies alone stayed far from the
// bound.)
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_elem.cuh"

namespace {

using attn::kNegInf;
constexpr int kWarps = 8;                     // compute warps
constexpr int kThreads = 32 * (kWarps + 1);   // + the copying warp
constexpr int kSteps = 4;      // key groups a compute warp takes a tile
constexpr int kMaxSplit = 64;  // chunks a row
constexpr int kCopyBulk = 0, kCopyAsync4 = 1, kCopyLd = 2;

// floats of one softmax state: m, l, acc[d] (d padded to 4)
__host__ __device__ inline int state_floats(int d) {
  return ((d + 3) & ~3) + 2;
}

__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }

// byte offsets in dynamic shared memory: barriers (full[stages],
// empty[stages]), the (kWarps + 1) softmax states, the stages
struct Layout {
  int state, stage, total;
};

__host__ __device__ inline Layout layout(int d, int elem, int tile,
                                         int stages) {
  Layout L;
  L.state = round16(16 * stages);
  L.stage = L.state + round16(4 * (kWarps + 1) * state_floats(d));
  L.total = L.stage + stages * 2 * tile * d * elem;
  return L;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n .reg .b64 state;\n"
      " mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
      : "memory");
}

// one arrival that also expects `bytes` of bulk copies on this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA 1-D bulk copy global -> this block's shared memory, completing
// `bytes` (a multiple of 16, both addresses 16-byte aligned) on bar
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src,
                                         uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// arrive on bar once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// The whole block folds the kWarps softmax states (m in log2 units, l,
// acc[d]) at state[w * sf] into `to`, in warp order.
__device__ __forceinline__ void fold_warps(const float* state, int sf, int d,
                                           float* to) {
  float mm = state[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) mm = fmaxf(mm, state[w * sf]);
  float sc[kWarps];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) sc[w] = exp2f(state[w * sf] - mm);
  for (int c = threadIdx.x; c < d; c += kThreads) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += state[w * sf + 2 + c] * sc[w];
    to[2 + c] = a;
  }
  if (threadIdx.x == 0) {
    float ll = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) ll += state[w * sf + 1] * sc[w];
    to[0] = mm;
    to[1] = ll;
  }
}

// grid B*H*n_split, block kThreads. G lanes of E elements read one key's
// row; a tile is kWarps * kSteps * (32 / G) keys. group: query heads a
// kv head. part: [B*H, n_split,
// state_floats(d)] f32 scratch; counter: [B*H] int32, zero between calls.
template <typename Raw, int E, int G>
__global__ void __launch_bounds__(kThreads, 2)
    decode_attention_kernel(const Raw* __restrict__ q,
                            const Raw* __restrict__ k,
                            const Raw* __restrict__ v,
                            const int32_t* __restrict__ length,
                            Raw* __restrict__ out, float* __restrict__ part,
                            int* __restrict__ counter, int H, int group,
                            int T, int d, int chunk, int n_split, int tile,
                            int stages, float scale, int copy) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bh = blockIdx.x / n_split;
  const int split = blockIdx.x % n_split;
  const int len = min(max(length[bh / H], 0), T);
  const int n_busy = (len + chunk - 1) / chunk;  // chunks with a valid key
  Raw* o = out + static_cast<size_t>(bh) * d;
  if (n_busy == 0) {  // the row sees no key: 0
    if (split == 0)
      for (int c = threadIdx.x; c < d; c += kThreads)
        o[c] = attn::Elem<Raw>::pack(0.f);
    return;
  }
  if (split >= n_busy) return;  // past `length`: nothing to do

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Layout L = layout(d, sizeof(Raw), tile, stages);
  const uint32_t full0 = smem_u32(smem), empty0 = full0 + 8 * stages;
  float* state = reinterpret_cast<float*>(smem + L.state);
  Raw* stage0 = reinterpret_cast<Raw*>(smem + L.stage);
  const int sf = state_floats(d);
  const size_t tile_elems = static_cast<size_t>(tile) * d;
  const int t0 = split * chunk;
  const int t1 = min(t0 + chunk, len);
  const int ntiles = (t1 - t0 + tile - 1) / tile;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, copy == kCopyBulk ? 1 : 32);
      mbar_init(empty0 + 8 * s, kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kWarps) {
    // the copying warp: every tile of the chunk, `stages` at a time
    const size_t row0 = static_cast<size_t>(bh / group) * T + t0;
    const Raw* kg0 = k + row0 * d;
    const Raw* vg0 = v + row0 * d;
    for (int i = 0; i < ntiles; ++i) {
      const int s = i % stages;
      if (i >= stages) mbar_wait(empty0 + 8 * s, ((i / stages) - 1) & 1);
      const int n = min(tile, t1 - t0 - i * tile) * d;  // elements
      Raw* ks = stage0 + s * 2 * tile_elems;
      Raw* vs = ks + tile_elems;
      const Raw* kg = kg0 + i * tile_elems;
      const Raw* vg = vg0 + i * tile_elems;
      const uint32_t bar = full0 + 8 * s;
      if (copy == kCopyBulk) {
        if (lane == 0) {
          const uint32_t bytes = n * sizeof(Raw);
          mbar_arrive_expect_tx(bar, 2 * bytes);
          bulk_g2s(smem_u32(ks), kg, bytes, bar);
          bulk_g2s(smem_u32(vs), vg, bytes, bar);
        }
      } else if (copy == kCopyAsync4) {
        const int words = n * static_cast<int>(sizeof(Raw)) / 4;
        const uint32_t ka = smem_u32(ks), va = smem_u32(vs);
        const char* kc = reinterpret_cast<const char*>(kg);
        const char* vc = reinterpret_cast<const char*>(vg);
        for (int w = lane; w < words; w += 32) {
          cp_async4(ka + 4 * w, kc + 4 * w);
          cp_async4(va + 4 * w, vc + 4 * w);
        }
        cp_async_arrive(bar);
      } else {
        for (int e = lane; e < n; e += 32) {
          ks[e] = kg[e];
          vs[e] = vg[e];
        }
        mbar_arrive(bar);
      }
    }
  } else {
    // a compute warp: keys [warp * kSteps * KP, (warp + 1) * kSteps * KP)
    // of every tile. Each group of G lanes keeps its own online-softmax
    // state (m, l, acc; m in log2 units) over the keys it reads, so the
    // loop has no shuffle across groups; the groups fold at the end.
    constexpr int KP = 32 / G;  // keys a step
    const int grp = lane / G;
    const int c0 = (lane % G) * E;  // this lane's first element of a row
    const int lim = d - c0;         // how many of its E elements exist
    const bool vec = copy == kCopyBulk && lim >= E;
    const float scale2 = scale * 1.4426950408889634f;  // * log2(e)
    float qv[E];
#pragma unroll
    for (int e = 0; e < E; ++e)
      qv[e] = e < lim ? attn::Elem<Raw>::load(
                            q + static_cast<size_t>(bh) * d + c0 + e)
                      : 0.f;
    float m = kNegInf, l = 0.f, acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.f;
    const int j0 = warp * kSteps * KP + grp;
    for (int i = 0; i < ntiles; ++i) {
      const int s = i % stages;
      mbar_wait(full0 + 8 * s, (i / stages) & 1);
      const Raw* ks = stage0 + s * 2 * tile_elems;
      const Raw* vs = ks + tile_elems;
      const int rows = min(tile, t1 - t0 - i * tile);  // rows past: not copied
      // K and V rows of every step first: V does not wait for the logits
      float kr[kSteps][E], vr[kSteps][E], lg[kSteps];
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        const int j = j0 + st * KP;
        if (j < rows) {
          attn::load_n<Raw, E>(ks + static_cast<size_t>(j) * d + c0, vec, lim,
                               kr[st]);
          attn::load_n<Raw, E>(vs + static_cast<size_t>(j) * d + c0, vec, lim,
                               vr[st]);
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e) kr[st][e] = vr[st][e] = 0.f;
        }
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) dot += qv[e] * kr[st][e];
        lg[st] = dot;
      }
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1) {
#pragma unroll
        for (int st = 0; st < kSteps; ++st)
          lg[st] += __shfl_xor_sync(0xffffffffu, lg[st], o);
      }
      float mx = kNegInf;
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        lg[st] = j0 + st * KP < rows ? lg[st] * scale2 : kNegInf;
        mx = fmaxf(mx, lg[st]);
      }
      const float m_new = fmaxf(m, mx);
      const float corr = exp2f(m - m_new);
      l *= corr;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] *= corr;
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        const float p = j0 + st * KP < rows ? exp2f(lg[st] - m_new) : 0.f;
        l += p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] += p * vr[st][e];
      }
      m = m_new;
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
    }
    // fold the warp's KP groups, then leave the warp's state
    float mw = m;
#pragma unroll
    for (int o = G; o < 32; o <<= 1)
      mw = fmaxf(mw, __shfl_xor_sync(0xffffffffu, mw, o));
    const float sc = exp2f(m - mw);
    l *= sc;
#pragma unroll
    for (int o = G; o < 32; o <<= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      acc[e] *= sc;
#pragma unroll
      for (int o = G; o < 32; o <<= 1)
        acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
    }
    float* ws = state + warp * sf;
    if (lane == 0) {
      ws[0] = mw;
      ws[1] = l;
    }
    if (grp == 0) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (e < lim) ws[2 + c0 + e] = acc[e];
    }
  }
  __syncthreads();

  // this block's state from its warps'
  float* bs = state + kWarps * sf;
  fold_warps(state, sf, d, bs);
  __syncthreads();

  if (n_busy == 1) {  // the only chunk: its state is the row's
    for (int c = threadIdx.x; c < d; c += kThreads)
      o[c] = attn::Elem<Raw>::pack(bs[2 + c] / fmaxf(bs[1], 1e-30f));
    return;
  }
  // publish this chunk's state, then draw a ticket
  float* row = part + static_cast<size_t>(bh) * n_split * sf;
  for (int c = threadIdx.x; c < d + 2; c += kThreads)
    row[split * sf + c] = bs[c];
  __threadfence();
  __syncthreads();
  __shared__ int last;
  if (threadIdx.x == 0) last = atomicAdd(counter + bh, 1) == n_busy - 1;
  __syncthreads();
  if (!last) return;

  // the last block merges the n_busy states: warp w takes chunks w,
  // w + kWarps, ... in order (their loads independent: one L2 round
  // trip), then the warps' states fold as the block's did
  if (warp < kWarps) {
    constexpr int C = 256 / 32;  // columns a lane, at most
    float m = kNegInf, l = 0.f, acc[C];
#pragma unroll
    for (int j = 0; j < C; ++j) acc[j] = 0.f;
#pragma unroll 4
    for (int r = warp; r < n_busy; r += kWarps) {
      const float* pr = row + r * sf;
      const float mr = __ldcg(pr), lr = __ldcg(pr + 1);
      float ar[C];
#pragma unroll
      for (int j = 0; j < C; ++j)
        ar[j] = lane + 32 * j < d ? __ldcg(pr + 2 + lane + 32 * j) : 0.f;
      const float m_new = fmaxf(m, mr);
      const float c1 = exp2f(m - m_new), c2 = exp2f(mr - m_new);
      l = l * c1 + lr * c2;
#pragma unroll
      for (int j = 0; j < C; ++j) acc[j] = acc[j] * c1 + ar[j] * c2;
      m = m_new;
    }
    float* ws = state + warp * sf;
    if (lane == 0) {
      ws[0] = m;
      ws[1] = l;
    }
#pragma unroll
    for (int j = 0; j < C; ++j)
      if (lane + 32 * j < d) ws[2 + lane + 32 * j] = acc[j];
  }
  __syncthreads();
  fold_warps(state, sf, d, bs);
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += kThreads)
    o[c] = attn::Elem<Raw>::pack(bs[2 + c] / fmaxf(bs[1], 1e-30f));
  if (threadIdx.x == 0) counter[bh] = 0;  // zero again for the next call
}

template <typename Raw, int E, int G>
int launch_typed(const void* q, const void* k, const void* v,
                 const int32_t* length, void* out, float* part, int* counter,
                 int BH, int H, int group, int T, int d, int chunk,
                 int n_split, int tile, int stages, float scale, int copy,
                 cudaStream_t s) {
  if (tile != kWarps * kSteps * (32 / G))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = decode_attention_kernel<Raw, E, G>;
  const int smem = layout(d, sizeof(Raw), tile, stages).total;
  static int opted = 48 * 1024;  // dynamic shared memory allowed so far
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = smem;
  }
  kern<<<BH * n_split, kThreads, smem, s>>>(
      static_cast<const Raw*>(q), static_cast<const Raw*>(k),
      static_cast<const Raw*>(v), length, static_cast<Raw*>(out), part,
      counter, H, group, T, d, chunk, n_split, tile, stages, scale, copy);
  return static_cast<int>(cudaGetLastError());
}

// the (E, G) of kernels/decode_attention.py: lanes
#define DECODE_ARGS q, k, v, length, out, part, counter, BH, H, group, T, d, \
                    chunk, n_split, tile, stages, scale, copy, s

int launch_f32(const void* q, const void* k, const void* v,
               const int32_t* length, void* out, float* part, int* counter,
               int BH, int H, int group, int T, int d, int chunk,
               int n_split, int tile, int stages, float scale, int copy,
               cudaStream_t s) {
  if (d <= 16) return launch_typed<float, 4, 4>(DECODE_ARGS);
  if (d <= 32) return launch_typed<float, 4, 8>(DECODE_ARGS);
  if (d <= 64) return launch_typed<float, 4, 16>(DECODE_ARGS);
  if (d <= 128) return launch_typed<float, 4, 32>(DECODE_ARGS);
  return launch_typed<float, 8, 32>(DECODE_ARGS);
}

int launch_bf16(const void* q, const void* k, const void* v,
                const int32_t* length, void* out, float* part, int* counter,
                int BH, int H, int group, int T, int d, int chunk,
                int n_split, int tile, int stages, float scale, int copy,
                cudaStream_t s) {
  using R = unsigned short;
  if (d <= 32) return launch_typed<R, 8, 4>(DECODE_ARGS);
  if (d <= 64) return launch_typed<R, 8, 8>(DECODE_ARGS);
  if (d <= 128) return launch_typed<R, 8, 16>(DECODE_ARGS);
  return launch_typed<R, 8, 32>(DECODE_ARGS);
}

#undef DECODE_ARGS

}  // namespace

// Dynamic shared memory of one block (bytes); dtype 0 = f32, 1 = bf16.
extern "C" int decode_attention_smem_bytes(int d, int dtype, int tile,
                                           int stages) {
  return layout(d, dtype == 0 ? 4 : 2, tile, stages).total;
}

// dtype: 0 = f32, 1 = bf16; copy: 0 bulk, 1 4-byte cp.async, 2 loads.
// The plan (kernels/decode_attention.py: split_plan) gives chunk,
// n_split, tile and stages. group: query heads a kv head (H a multiple
// of it; k and v are [B, H / group, T, d]). part: [B*H, n_split,
// state_floats(d)] f32 scratch (unused at n_split 1); counter: [B*H]
// int32, zero.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* length,
                                       void* out, void* part, void* counter,
                                       int B, int H, int group, int T, int d,
                                       int chunk, int n_split, int tile,
                                       int stages, int copy, float scale,
                                       int dtype, void* stream) {
  const int elem = dtype == 0 ? 4 : 2;
  const uintptr_t addr =
      reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v);
  const bool ok_copy =
      copy == kCopyBulk ? (d * elem) % 16 == 0 && addr % 16 == 0
      : copy == kCopyAsync4 ? (d * elem) % 4 == 0 && addr % 4 == 0
                            : copy == kCopyLd;
  if (d < 1 || d > 256 || chunk < 1 || tile < 1 || stages < 1 ||
      group < 1 || H % group != 0 || n_split < 1 || n_split > kMaxSplit ||
      (dtype != 0 && dtype != 1) ||
      !ok_copy || static_cast<long long>(B) * H * n_split > 0x7fffffffLL ||
      static_cast<long long>(n_split) * chunk < T)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* len = static_cast<const int32_t*>(length);
  float* pt = static_cast<float*>(part);
  int* ct = static_cast<int*>(counter);
  if (dtype == 0)
    return launch_f32(q, k, v, len, out, pt, ct, B * H, H, group, T, d,
                      chunk, n_split, tile, stages, scale, copy, s);
  return launch_bf16(q, k, v, len, out, pt, ct, B * H, H, group, T, d,
                     chunk, n_split, tile, stages, scale, copy, s);
}

extern "C" const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
