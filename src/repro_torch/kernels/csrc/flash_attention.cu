// flash_attention: tiled online-softmax attention for sm_90a.
//
// Replaces repro/kernels/flash_attention.py: flash_attention_pallas.
// q [B*H, S, d], k/v [B*KV, T, d] (f32 or bf16) -> out [B*H, S, d] in q's
// type, H = KV * group (grouped-query attention: query head h of batch b
// reads kv head h / group, so q row block bh reads kv block bh / group;
// group 1 is plain multi-head attention). Query row i sits at position
// i + T - S (aligned to the END of the kv axis); it sees key t iff
// t <= pos when causal and pos - t < window when window > 0. Logits
// (q . k) * d^-0.5 in f32, softmax in f32, the accumulator in f32, out = acc / max(l, 1e-30). A row that sees no key
// (a causal row of a chunk longer than the cache) gives 0, as the TPU
// kernel does for a query block whose every kv block it skips.
//
// Bound on the card: operations at model widths (4*d flops per visible
// (query, key) pair against the tensor cores' bf16 rate), bytes at small
// S*T. Two kernels, by input type:
//
// bf16 (mma_kernel): Hopper's tensor cores through mma.sync m16n8k16
// (bf16 in, f32 accumulate). A block of 8 warps owns a 128-row query
// tile, 16 rows a warp (Shape). K and V tiles of 64 rows go through a
// ring of shared-memory stages (three; two at DP = 256) filled by
// 16-byte cp.async copies, rows past T and columns past d zero-filled by
// the copy's src-size. Each stage has two mbarriers: `full`, on which
// every thread's copies arrive as they land, and `empty`, on which every
// warp arrives when it is done reading the stage; a warp waits only for
// its data and, before it refills a stage, for the slowest warp of the
// tile before, so no block-wide barrier lines the warps up each tile.
// The tiles stay bf16, rows of DP elements (d padded to 64, 128 or 256,
// the padding computed as zeros) with their 16-byte chunks XOR-swizzled
// by row so that ldmatrix is free of bank conflicts. Q fragments come
// from ldmatrix (kept in registers for the whole loop up to DP = 128,
// read per k-step at 256, where the 16 x 256 f32 accumulator alone is
// 128 registers), K's from ldmatrix, V's from ldmatrix.trans. A warp's
// 16 x 64 f32 logits are masked only on tiles that cross the causal
// diagonal, the window's edge or T (a masked logit is -inf and weighs
// exactly 0); the row max and sum are reduced over each row's 4-thread
// quad; P, rounded to bf16 pairs, is the A operand of PV straight from
// the registers of the logits (the m16n8 C layout is the m16k16 A
// layout), so it never touches shared memory. The k-step loops have no
// branch inside: a branch there splits the products into basic blocks
// that the compiler cannot overlap. Where d % 8 != 0 or a base pointer
// is not 16-byte aligned, the tiles are loaded element by element into
// the same layout. Where the grid would not fill the card (the wrapper's
// split_plan), each query tile's kv range is split over n_split blocks
// that write f32 partial states, merged by a second kernel. The
// kernel rounds the unnormalised p = exp(s - m_running) to bf16 before
// PV, the plain version the normalised weights: both err by at most one
// bf16 ulp per weight.
//
// f32 (fma_kernel): f32 FMA, no tensor cores: TF32 would keep about three
// digits, and the f32 checks hold the kernel to 1e-4 of |want| and of the
// row's RMS. The TPU grid (B*H, S/bq, T/bk) carries m, l and acc in VMEM
// scratch across its sequential kv axis; here one block owns one (b*h,
// 64-row query tile) and loops over the kv tiles itself, so the running
// state stays in registers. Tiles are the kernel's own (64 x 64), not the
// Pallas (128, 128): any S, T and d <= 256 are taken, the ragged edges
// masked. 256 threads as 16 x 16; thread (ty, tx) owns query rows
// 4ty..4ty+3, the logits of kv columns 4tx..4tx+3 and output columns
// 4tx + 64g .. +3. Shared memory holds Q^T [DP][68] for the whole loop and
// per kv tile K^T [DP][68] and V [64][DP+4] (f32, DP = d padded to 64,
// 128 or 256); the probabilities P^T [64][68] reuse K^T's space once the
// logits are done. QK^T and PV read float4 rows of these (a 4 x 4 and a
// 4 x (DP/16) register tile per thread).
//
// Both: tiles wholly masked by causality or the window are skipped (the
// kv loop runs only over [window start, causal end) of the query tile),
// a masked logit gets weight 0 explicitly (in the TPU kernel it gets
// exp(NEG_INF - m), which is 0 once the row has seen a key, and the
// rescale by exp(NEG_INF - m) wipes anything an all-masked leading tile
// added, so both give the same rows), and query tiles run heaviest first
// (the causal tail has the most kv tiles).
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_elem.cuh"

namespace {

using attn::kNegInf;
constexpr int kBQ = 64;       // query rows per block (f32 kernel)
constexpr int kBK = 64;       // kv rows per tile (both kernels)
constexpr int kThreads = 256;
constexpr int kLd = 68;       // row stride of Q^T, K^T and P^T (floats)

template <int DP>
constexpr int smem_floats() {
  return DP * kLd /* Q^T */ + DP * kLd /* K^T, then P^T */ +
         kBK * (DP + 4) /* V */;
}

// Load a [rows, d] tile of a [*, d] matrix starting at row r0 (rows
// r0..r0+rows-1, those >= n_rows read as 0) into shared memory, either
// transposed (dst[c * kLd + r]) or not (dst[r * (DP + 4) + c]), in
// 4-element chunks of one row each.
template <typename Raw, int DP, bool kTransposed>
__device__ __forceinline__ void load_tile(const Raw* __restrict__ src,
                                          int r0, int n_rows, int d,
                                          bool vec, float* __restrict__ dst,
                                          int rows) {
  constexpr int kChunks = DP / 4;  // 4-element chunks per row
  for (int e = threadIdx.x; e < rows * kChunks; e += kThreads) {
    // transposed: consecutive threads take consecutive rows, so the
    // shared-memory stores of one warp are consecutive words
    const int r = kTransposed ? e % rows : e / kChunks;
    const int c = 4 * (kTransposed ? e / rows : e % kChunks);
    float x[4];
    const int gr = r0 + r;
    if (gr < n_rows) {
      // vec holds only for chunks inside the row: with d % 4 == 0 a
      // chunk is wholly in (c < d) or wholly in the padding
      attn::load_n<Raw, 4>(src + (size_t)gr * d + c, vec && c < d, d - c, x);
    } else {
      x[0] = x[1] = x[2] = x[3] = 0.f;
    }
    if (kTransposed) {
#pragma unroll
      for (int i = 0; i < 4; ++i) dst[(c + i) * kLd + r] = x[i];
    } else {
      *reinterpret_cast<float4*>(dst + r * (DP + 4) + c) =
          make_float4(x[0], x[1], x[2], x[3]);
    }
  }
}

template <typename Raw, int DP>
__global__ void __launch_bounds__(kThreads)
    fma_kernel(const Raw* __restrict__ q, const Raw* __restrict__ k,
                 const Raw* __restrict__ v, Raw* __restrict__ out, int S,
                 int T, int d, int group, int causal, int window,
                 float scale, bool vec) {
  constexpr int CG = DP / 64;  // float4 output column groups per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qt = smem;              // [DP][kLd]
  float* kt = qt + DP * kLd;     // [DP][kLd]; P^T [kBK][kLd] after QK
  float* vs = kt + DP * kLd;     // [kBK][DP + 4]
  float* pt = kt;

  const int bh = blockIdx.x;
  const int n_qt = gridDim.y;
  const int q_tile = n_qt - 1 - blockIdx.y;  // heaviest first
  const int r0 = q_tile * kBQ;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int off = T - S;  // position of query row i is i + off

  // kv range that any row of this tile can see
  const int pos_lo = r0 + off;
  const int pos_hi = min(r0 + kBQ, S) - 1 + off;
  int kv_begin = 0, kv_end = T;
  if (window > 0) kv_begin = max(0, (pos_lo - window + 1) / kBK * kBK);
  if (causal) kv_end = min(T, pos_hi + 1);

  const Raw* qb = q + (size_t)bh * S * d;
  const Raw* kb = k + (size_t)(bh / group) * T * d;
  const Raw* vb = v + (size_t)(bh / group) * T * d;

  float m[4], l[4], acc[4][CG][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < CG; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][g][j] = 0.f;
  }

  if (kv_begin < kv_end) load_tile<Raw, DP, true>(qb, r0, S, d, vec, qt, kBQ);

  for (int t0 = kv_begin; t0 < kv_end; t0 += kBK) {
    __syncthreads();  // the previous tile's P^T and V are consumed
    load_tile<Raw, DP, true>(kb, t0, T, d, vec, kt, kBK);
    load_tile<Raw, DP, false>(vb, t0, T, d, vec, vs, kBK);
    __syncthreads();

    // logits of rows 4ty+i, kv columns t0 + 4tx + j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < DP; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(qt + c * kLd + 4 * ty);
      const float4 b = *reinterpret_cast<const float4*>(kt + c * kLd + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += av[i] * bv[j];
    }

    // mask, then the online softmax of each row over its 16 threads
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + 4 * ty + i;
      const int pos = row + off;
      bool vis[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = t0 + 4 * tx + j;
        vis[j] = row < S && t < T && (!causal || t <= pos) &&
                 (window <= 0 || pos - t < window);
        s[i][j] *= scale;
        if (vis[j]) mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = vis[j] ? expf(s[i][j] - m_new) : 0.f;
        ls += p[i][j];
      }
      l[i] = l[i] * corr + ls;  // this thread's share of the row sum
#pragma unroll
      for (int g = 0; g < CG; ++g)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][g][j] *= corr;
      m[i] = m_new;
    }

    __syncthreads();  // every thread is done reading K^T
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt + (4 * tx + j) * kLd + 4 * ty) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    __syncthreads();

    // acc[rows 4ty+i][cols 4tx + 64g + j] += P V
#pragma unroll 4
    for (int t = 0; t < kBK; ++t) {
      const float4 a = *reinterpret_cast<const float4*>(pt + t * kLd + 4 * ty);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int g = 0; g < CG; ++g) {
        const float4 b = *reinterpret_cast<const float4*>(
            vs + t * (DP + 4) + 64 * g + 4 * tx);
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][g][j] += av[i] * bv[j];
      }
    }
  }

  // row sums over the 16 threads of each row, then the output
  Raw* ob = out + (size_t)bh * S * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float ls = l[i];
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) ls += __shfl_xor_sync(0xffffffffu, ls, o);
    const float den = fmaxf(ls, 1e-30f);
    const int row = r0 + 4 * ty + i;
    if (row >= S) continue;
#pragma unroll
    for (int g = 0; g < CG; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 64 * g + 4 * tx + j;
        if (c < d)
          ob[(size_t)row * d + c] = attn::Elem<Raw>::pack(acc[i][g][j] / den);
      }
  }
}


template <int DP>
int fma_launch(const void* q, const void* k, const void* v, void* out,
               int BH, int S, int T, int d, int group, int causal,
               int window, float scale, bool aligned, cudaStream_t s) {
  constexpr size_t kSmem = sizeof(float) * smem_floats<DP>();
  // above 48 KB only after opting in; not a stream operation, so it is
  // also legal while the stream is being captured into a graph
  cudaError_t e = cudaFuncSetAttribute(
      fma_kernel<float, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(BH, (S + kBQ - 1) / kBQ);
  // vec: every 4-element chunk of a row is in bounds (d % 4 == 0) and
  // 16-byte aligned
  fma_kernel<float, DP><<<grid, kThreads, kSmem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, T, d,
      group, causal, window, scale, aligned && d % 4 == 0);
  return static_cast<int>(cudaGetLastError());
}

// --------------------------- bf16: tensor cores ----------------------------

namespace tc {

constexpr float kLog2e = 1.4426950408889634f;

// The block's shape by padded head dim: 8 warps of 16 query rows (one
// m16 tile each), a 128-row tile, so that each K/V tile in shared memory
// serves 128 rows. Up to DP = 128 Q's fragments stay in registers for
// the whole kv loop; at DP = 256 the 16 x 256 f32 accumulator alone is
// 128 registers, so they are read per k-step. Two blocks an SM at DP = 64
// (at most 128 registers a thread), one above.
template <int DP>
struct Shape {
  static constexpr int kWarps = 8;
  static constexpr int kBQ = 16 * kWarps;  // query rows per block
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBlocksPerSM = DP <= 64 ? 2 : 1;
  static constexpr bool kQRegs = DP <= 128;
  static constexpr int kStages = DP <= 128 ? 3 : 2;  // depth of the ring
};

// Bytes of a block's shared memory: Q [kBQ][DP] and per stage K and V
// [kBK][DP] in bf16, then the ring's 2 kStages mbarriers.
template <int DP>
constexpr int smem_bytes() {
  using Sh = Shape<DP>;
  return 2 * DP * (Sh::kBQ + 2 * Sh::kStages * kBK) + 16 * Sh::kStages;
}

// Element offset of the 16-byte chunk c of row r of a [*, DP] tile. The
// chunks are XOR-swizzled by r % 8: the 8 rows that one 8x8 ldmatrix
// reads (one chunk column) sit in 8 different bank groups.
template <int DP>
__device__ __forceinline__ int swz(int r, int c) {
  return r * DP + ((c ^ (r & 7)) << 3);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; !full zero-fills the 16
// bytes and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
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

// arrive on bar once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// wait until bar completes the phase of the given parity
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

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c += a * b: one m16n8k16 product, bf16 A (row-major) and B (column-
// major), f32 C
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two f32 -> a bf16 pair, lo in the low half, round to nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// Rows r0 .. r0 + ROWS - 1 of a [n_rows, d] bf16 matrix into a swizzled
// [ROWS][DP] tile by THREADS threads; rows >= n_rows and columns >= d
// read as 0. A thread copies chunk c = tid % (DP / 8) of rows tid / (DP /
// 8) + i kStep: kStep is a multiple of 8, so those rows share one swizzle
// and the thread's addresses step by constants. vec (d % 8 == 0, src
// 16-byte aligned): one cp.async per 16-byte chunk; otherwise the chunk
// is gathered element by element and stored at once.
template <int DP, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(uint16_t* dst,
                                          const uint16_t* __restrict__ src,
                                          int r0, int n_rows, int d,
                                          bool vec) {
  constexpr int kChunks = DP / 8;
  constexpr int kStep = THREADS / kChunks;
  static_assert(THREADS % kChunks == 0 && kStep % 8 == 0 &&
                    ROWS % kStep == 0,
                "whole chunks a thread, one swizzle a thread");
  const int c = threadIdx.x % kChunks;
  const int r = threadIdx.x / kChunks;
  const uint32_t p0 = smem_addr(dst + swz<DP>(r, c));
  const uint16_t* g0 = src + (size_t)(r0 + r) * d + 8 * c;
  const bool col_in = 8 * c < d;
#pragma unroll
  for (int i = 0; i < ROWS / kStep; ++i) {
    const bool in = col_in && r0 + r + i * kStep < n_rows;
    const uint16_t* g = g0 + (size_t)i * kStep * d;
    if (vec) {
      cp_async16(p0 + 2 * i * kStep * DP, in ? g : src, in);
    } else {
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c0 = 8 * c + 2 * j;
        const uint32_t lo = in && c0 < d ? g[2 * j] : 0u;
        const uint32_t hi = in && c0 + 1 < d ? g[2 * j + 1] : 0u;
        w[j] = lo | (hi << 16);
      }
      *reinterpret_cast<uint4*>(dst + swz<DP>(r + i * kStep, c)) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// grid (B*H * n_split, ceil(S / kBQ)), Shape<DP>::kThreads threads,
// smem_bytes<DP>() of dynamic shared memory. Block (bh * n_split +
// split, y) runs chunk `split` of the kv tiles of query tile (last - y).
// n_split == 1: writes out; otherwise the chunk's partial (m * scale, l)
// and acc for merge_kernel.
template <int DP>
__global__ void __launch_bounds__(Shape<DP>::kThreads,
                                  Shape<DP>::kBlocksPerSM)
    mma_kernel(const uint16_t* __restrict__ q,
               const uint16_t* __restrict__ k,
               const uint16_t* __restrict__ v, uint16_t* __restrict__ out,
               float* __restrict__ part_ml, float* __restrict__ part_acc,
               int S, int T, int d, int group, int causal, int window,
               float scale, int n_split, bool vec) {
  using Sh = Shape<DP>;
  constexpr int NT = Sh::kThreads;
  constexpr int kBQ = Sh::kBQ;
  constexpr int kStages = Sh::kStages;
  constexpr int KS = DP / 16;  // k-steps of QK^T; 16-column pairs of PV
  extern __shared__ uint4 smem_u4[];
  uint16_t* sq = reinterpret_cast<uint16_t*>(smem_u4);
  uint16_t* skv = sq + kBQ * DP;  // stage s: K, then V, at 2 s kBK DP

  const int bh = blockIdx.x / n_split, split = blockIdx.x % n_split;
  const int q_tile = gridDim.y - 1 - blockIdx.y;  // heaviest first
  const int r0 = q_tile * kBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;  // C fragment: rows g, g + 8
  const int off = T - S;  // position of query row i is i + off

  // kv range that any row of this tile can see, in kBK tiles; this
  // block's chunk of them
  const int pos_lo = r0 + off;
  const int pos_hi = min(r0 + kBQ, S) - 1 + off;
  int kv_begin = 0, kv_end = T;
  if (window > 0) kv_begin = max(0, (pos_lo - window + 1) / kBK * kBK);
  if (causal) kv_end = min(T, pos_hi + 1);
  const int n_tiles =
      kv_end > kv_begin ? (kv_end - kv_begin + kBK - 1) / kBK : 0;
  const int j_lo = split * n_tiles / n_split;
  const int j_hi = (split + 1) * n_tiles / n_split;

  const int wr0 = r0 + 16 * warp;  // this warp's first row
  const int w_lo = wr0 + off, w_hi = wr0 + 15 + off;  // its positions

  const uint16_t* qb = q + (size_t)bh * S * d;
  const uint16_t* kb = k + (size_t)(bh / group) * T * d;
  const uint16_t* vb = v + (size_t)(bh / group) * T * d;

  // ldmatrix row addresses of this lane; every row it addresses is
  // lane % 8 modulo 8, so its swizzle is chunk ^ (lane % 8)
  const int l7 = lane & 7;
  // Q, the A operand: row 16 warp + lane % 16, chunk 2 kk + lane / 16
  const uint32_t q_row = smem_addr(sq + (16 * warp + (lane & 15)) * DP);
  const int q_c = lane >> 4;
  // K, the B operand of QK^T: key 16 np + lane % 8 + 8 (lane / 16),
  // chunk 2 kk + (lane / 8) % 2 -> b0, b1 of key tiles 2 np and 2 np + 1
  const int k_r = l7 + ((lane >> 4) << 3), k_c = (lane >> 3) & 1;
  // V, the B operand of PV (transposed): key 16 kk + lane % 8 + 8 ((lane
  // / 8) % 2), chunk 2 np + lane / 16 -> b0, b1 of column tiles 2 np and
  // 2 np + 1
  const int v_r = l7 + (((lane >> 3) & 1) << 3), v_c = lane >> 4;

  const float sl2 = scale * kLog2e;  // logits to log2 units
  const float kMinusInf = -__int_as_float(0x7f800000);
  // per fragment row i (rows g and g + 8): the running max (in logit
  // units before scaling) and this thread's share of the sum
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // The ring: stage st holds K, then V, of one kv tile. full[st]
  // completes when every thread's copies into it have landed (kThreads
  // arrivals), empty[st] when every warp is done reading it (kWarps
  // arrivals), so a warp waits only for the data it reads and for the
  // slowest warp of a tile kStages - 1 behind, never for a block-wide
  // barrier.
  uint64_t* bars = reinterpret_cast<uint64_t*>(skv + 2 * kStages * kBK * DP);
  const uint32_t full0 = smem_addr(bars), empty0 = smem_addr(bars + kStages);
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full0 + 8 * st, NT);
      mbar_init(empty0 + 8 * st, Sh::kWarps);
    }
  }
  __syncthreads();
  // this thread's copies of kv tile jt into stage st, and its arrival on
  // full[st] once they have landed
  const auto fetch = [&](int jt, int st) {
    uint16_t* dst = skv + st * 2 * kBK * DP;
    const int t1 = kv_begin + jt * kBK;
    load_tile<DP, kBK, NT>(dst, kb, t1, T, d, vec);
    load_tile<DP, kBK, NT>(dst + kBK * DP, vb, t1, T, d, vec);
    if (vec)
      cp_async_arrive(full0 + 8 * st);
    else
      mbar_arrive(full0 + 8 * st);  // the stores above are synchronous
  };

  if (j_lo < j_hi) {
    load_tile<DP, kBQ, NT>(sq, qb, r0, S, d, vec);  // lands with stage 0
#pragma unroll
    for (int t = 0; t < kStages - 1; ++t)
      if (j_lo + t < j_hi) fetch(j_lo + t, t);
    uint32_t qf[Sh::kQRegs ? KS : 1][4];
    for (int j = j_lo; j < j_hi; ++j) {
      const int it = j - j_lo, stage = it % kStages;
      // the tile kStages - 1 ahead goes into the stage of tile j - 1, once
      // every warp is done with that
      const auto refill = [&] {
        if (j + kStages - 1 >= j_hi) return;
        const int sn = (it + kStages - 1) % kStages;
        if (it >= 1) mbar_wait(empty0 + 8 * sn, ((it - 1) / kStages) & 1);
        fetch(j + kStages - 1, sn);
      };
      mbar_wait(full0 + 8 * stage, (it / kStages) & 1);
      // a ring of two refills at once, so that the copy has a whole tile
      // to land; a deeper one after the products (below)
      if constexpr (kStages == 2) refill();
      if constexpr (Sh::kQRegs) {
        if (it == 0) {
#pragma unroll
          for (int kk = 0; kk < KS; ++kk)
            ldsm_x4(q_row + (((2 * kk + q_c) ^ l7) << 4), qf[kk]);
        }
      }
      const int t0 = kv_begin + j * kBK;
      // the warp's rows see no key of this tile, or it has no rows
      if (wr0 >= S || (causal && t0 > w_hi) ||
          (window > 0 && t0 + kBK - 1 <= w_lo - window)) {
        if constexpr (kStages > 2) refill();
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * stage);
        continue;
      }
      const uint16_t* kt = skv + stage * 2 * kBK * DP;
      const uint32_t k_base = smem_addr(kt + k_r * DP);
      const uint32_t v_base = smem_addr(kt + kBK * DP + v_r * DP);

      // logits S = Q K^T of the warp's 16 rows and the tile's 64 keys:
      // s[nt] is the C fragment of keys 8 nt .. 8 nt + 7
      float s[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t a[4];
        if constexpr (Sh::kQRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
        } else {
          ldsm_x4(q_row + (((2 * kk + q_c) ^ l7) << 4), a);
        }
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t b[4];
          ldsm_x4(k_base + np * 32 * DP + (((2 * kk + k_c) ^ l7) << 4), b);
          mma_bf16(s[2 * np], a, b[0], b[1]);
          mma_bf16(s[2 * np + 1], a, b[2], b[3]);
        }
      }

      // after the products, when the other warps are likely done with
      // tile j - 1
      if constexpr (kStages > 2) refill();

      // mask only tiles that cross T, the causal diagonal or the
      // window's edge for some row of the warp
      if (t0 + kBK > T || (causal && t0 + kBK - 1 > w_lo) ||
          (window > 0 && t0 <= w_hi - window)) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int pos = w_lo + g + 8 * (e >> 1);
            const int t = t0 + 8 * nt + 2 * tq + (e & 1);
            if (t >= T || (causal && t > pos) ||
                (window > 0 && pos - t >= window))
              s[nt][e] = kMinusInf;  // weighs exactly 0 below
          }
      }

      // online softmax of rows g (i = 0) and g + 8 (i = 1), each over its
      // quad; the running max starts at NEG_INF, finite, so a masked
      // logit gives exp2(-inf) = 0 and a row with no key so far keeps
      // l = 0 and acc = 0
      float ms[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = m[i];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          mx = fmaxf(mx, fmaxf(s[nt][2 * i], s[nt][2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float corr = ex2((m[i] - mx) * sl2);
        l[i] *= corr;
#pragma unroll
        for (int n = 0; n < DP / 8; ++n) {
          acc[n][2 * i] *= corr;
          acc[n][2 * i + 1] *= corr;
        }
        m[i] = mx;
        ms[i] = mx * sl2;
      }

      // acc += P V, 16 keys a k-step: the probabilities of key tiles
      // 2 kk and 2 kk + 1 (exp2 here, so that the exponentials of one
      // k-step overlap the products of the one before), as bf16 pairs,
      // are the A fragment: the C layout of m16n8 is the A layout of
      // m16k16, so P stays in registers
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int nt = 2 * kk; nt < 2 * kk + 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[nt][e] = ex2(fmaf(s[nt][e], sl2, -ms[e >> 1]));
            l[e >> 1] += s[nt][e];
          }
        const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                               pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                               pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int np = 0; np < KS; ++np) {
          uint32_t b[4];
          ldsm_x4_trans(v_base + kk * 32 * DP + (((2 * np + v_c) ^ l7) << 4),
                        b);
          mma_bf16(acc[2 * np], a, b[0], b[1]);
          mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * stage);
    }
  }

  // row sums over the quads, then the output or this chunk's partial
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float ls = l[i];
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    ls += __shfl_xor_sync(0xffffffffu, ls, 2);
    const int row = wr0 + g + 8 * i;
    if (row >= S) continue;
    const size_t gr = (size_t)bh * S + row;
    if (n_split == 1) {
      const float den = fmaxf(ls, 1e-30f);
      uint16_t* o = out + gr * d;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        const int c = 8 * n + 2 * tq;
        if (c >= d) continue;
        const float x0 = acc[n][2 * i] / den, x1 = acc[n][2 * i + 1] / den;
        if (vec) {
          *reinterpret_cast<uint32_t*>(o + c) = pack_bf16(x0, x1);
        } else {
          o[c] = attn::Elem<uint16_t>::pack(x0);
          if (c + 1 < d) o[c + 1] = attn::Elem<uint16_t>::pack(x1);
        }
      }
    } else {
      const size_t p = gr * n_split + split;
      if (tq == 0) {
        part_ml[2 * p] = m[i] * scale;  // the merge's logit units
        part_ml[2 * p + 1] = ls;
      }
      float* pa = part_acc + p * d;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        const int c = 8 * n + 2 * tq;
        if (c >= d) continue;
        if (vec) {
          *reinterpret_cast<float2*>(pa + c) =
              make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
        } else {
          pa[c] = acc[n][2 * i];
          if (c + 1 < d) pa[c + 1] = acc[n][2 * i + 1];
        }
      }
    }
  }
}

// The second pass of a split launch: the n_split partial states of each
// row (m * scale and l in part_ml [rows][n_split][2], the unnormalised
// acc in part_acc [rows][n_split][d], f32), merged as decode_attention.cu
// merges its chunks, but one warp per row (B*H*S rows of a few chunks,
// not B*H rows of many). A chunk that saw no key of the row holds
// (NEG_INF, 0, 0), so a row with no key at all gives 0. Grid ceil(rows /
// 4), 128 threads.
__global__ void __launch_bounds__(128)
    merge_kernel(const float* __restrict__ part_ml,
                 const float* __restrict__ part_acc,
                 uint16_t* __restrict__ out, int rows, int n_split, int d) {
  const int r = blockIdx.x * 4 + threadIdx.x / 32;
  if (r >= rows) return;
  const size_t row = r;
  const float* ml = part_ml + row * n_split * 2;
  const float* pa = part_acc + row * n_split * d;
  float mm = kNegInf;
  for (int s = 0; s < n_split; ++s) mm = fmaxf(mm, ml[2 * s]);
  float ll = 0.f;
  for (int s = 0; s < n_split; ++s) ll += ml[2 * s + 1] * expf(ml[2 * s] - mm);
  for (int c = threadIdx.x % 32; c < d; c += 32) {
    float a = 0.f;
    for (int s = 0; s < n_split; ++s)
      a += pa[(size_t)s * d + c] * expf(ml[2 * s] - mm);
    out[row * d + c] = attn::Elem<uint16_t>::pack(a / fmaxf(ll, 1e-30f));
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* out,
           float* part_ml, float* part_acc, int BH, int S, int T, int d,
           int group, int causal, int window, float scale, int n_split,
           bool aligned, cudaStream_t s) {
  constexpr int kSmem = smem_bytes<DP>();
  cudaError_t e = cudaFuncSetAttribute(
      mma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  constexpr int kBQ = Shape<DP>::kBQ;
  const dim3 grid(BH * n_split, (S + kBQ - 1) / kBQ);
  uint16_t* o = static_cast<uint16_t*>(out);
  mma_kernel<DP><<<grid, Shape<DP>::kThreads, kSmem, s>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), o, part_ml, part_acc, S, T, d, group,
      causal, window, scale, n_split, aligned && d % 8 == 0);
  e = cudaGetLastError();
  if (e != cudaSuccess || n_split == 1) return static_cast<int>(e);
  merge_kernel<<<(BH * S + 3) / 4, 128, 0, s>>>(part_ml, part_acc, o,
                                                 BH * S, n_split, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

int padded_dim(int d) { return d <= 64 ? 64 : d <= 128 ? 128 : 256; }

}  // namespace

// Dynamic shared memory of one block at head dim d (bytes) of the kernel
// for dtype (0 = f32, 1 = bf16), for callers that report it.
extern "C" int flash_attention_smem_bytes(int d, int dtype) {
  const int dp = padded_dim(d);
  if (dtype == 0)
    return (int)sizeof(float) * (dp == 64    ? smem_floats<64>()
                                 : dp == 128 ? smem_floats<128>()
                                             : smem_floats<256>());
  return dp == 64    ? tc::smem_bytes<64>()
         : dp == 128 ? tc::smem_bytes<128>()
                     : tc::smem_bytes<256>();
}

// dtype: 0 = f32, 1 = bf16. window <= 0: no window. group: query heads
// a kv head (BH a multiple of it). n_split > 1 (bf16 only): part_ml
// [B*H*S*n_split*2] and part_acc [B*H*S*n_split*d] are f32 scratch
// allocated by the caller.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out,
                                      void* part_ml, void* part_acc, int BH,
                                      int S, int T, int d, int group,
                                      int causal, int window, float scale,
                                      int dtype, int n_split, void* stream) {
  if (d < 1 || d > 256 || BH < 1 || S < 1 || T < 1 || n_split < 1 ||
      group < 1 || BH % group != 0 ||
      (S + kBQ - 1) / kBQ > 65535 || (long long)BH * n_split > 0x7fffffff ||
      (long long)BH * S > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = ((reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) |
                         reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  const int dp = padded_dim(d);
  if (dtype == 0) {
    if (n_split != 1) return static_cast<int>(cudaErrorInvalidValue);
    if (dp == 64)
      return fma_launch<64>(q, k, v, out, BH, S, T, d, group, causal, window,
                            scale, aligned, s);
    if (dp == 128)
      return fma_launch<128>(q, k, v, out, BH, S, T, d, group, causal,
                             window, scale, aligned, s);
    return fma_launch<256>(q, k, v, out, BH, S, T, d, group, causal, window,
                           scale, aligned, s);
  }
  if (dtype != 1 ||
      (n_split > 1 && (part_ml == nullptr || part_acc == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  float* ml = static_cast<float*>(part_ml);
  float* pa = static_cast<float*>(part_acc);
  if (dp == 64)
    return tc::launch<64>(q, k, v, out, ml, pa, BH, S, T, d, group, causal,
                          window, scale, n_split, aligned, s);
  if (dp == 128)
    return tc::launch<128>(q, k, v, out, ml, pa, BH, S, T, d, group, causal,
                           window, scale, n_split, aligned, s);
  return tc::launch<256>(q, k, v, out, ml, pa, BH, S, T, d, group, causal,
                         window, scale, n_split, aligned, s);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
