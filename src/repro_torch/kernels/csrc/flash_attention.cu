// flash_attention: tiled online-softmax attention for sm_90a.
//
// Replaces repro/kernels/flash_attention.py: flash_attention_pallas.
// q [B*H, S, d], k/v [B*H, T, d] (f32 or bf16) -> out [B*H, S, d] in q's
// type. Query row i sits at position i + T - S (aligned to the END of the
// kv axis); it sees key t iff t <= pos when causal and pos - t < window
// when window > 0. Logits (q . k) * d^-0.5 in f32, softmax in f32, the
// accumulator in f32, out = acc / max(l, 1e-30). A row that sees no key
// (a causal row of a chunk longer than the cache) gives 0, as the TPU
// kernel does for a query block whose every kv block it skips.
//
// Bound on the card: operations at model widths (4*d flops per visible
// (query, key) pair against the tensor cores' bf16 rate), bytes at small
// S*T. This first kernel is the simple right one: f32 FMA, no tensor
// cores, no TMA, loads through registers with no double buffering; it
// runs well above its bound and says so in PERF.md.
//
// Design. The TPU grid (B*H, S/bq, T/bk) carries m, l and acc in VMEM
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
// 4 x (DP/16) register tile per thread). Tiles wholly masked by causality
// or the window are skipped: the kv loop runs only over
// [window start, causal end) of the query tile. Inside a tile a masked
// logit gets weight 0 explicitly; in the TPU kernel it gets exp(NEG_INF -
// m), which is 0 once the row has seen a key, and the rescale by
// exp(NEG_INF - m) wipes anything an all-masked leading tile added, so
// both give the same rows. Query tiles run heaviest first (the causal
// tail has the most kv tiles).
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_elem.cuh"

namespace {

using attn::kNegInf;
constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // kv rows per tile
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
    flash_kernel(const Raw* __restrict__ q, const Raw* __restrict__ k,
                 const Raw* __restrict__ v, Raw* __restrict__ out, int S,
                 int T, int d, int causal, int window, float scale,
                 bool vec) {
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
  const Raw* kb = k + (size_t)bh * T * d;
  const Raw* vb = v + (size_t)bh * T * d;

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

template <typename Raw, int DP>
int launch_typed(const void* q, const void* k, const void* v, void* out,
                 int BH, int S, int T, int d, int causal, int window,
                 float scale, bool aligned, cudaStream_t s) {
  constexpr size_t kSmem = sizeof(float) * smem_floats<DP>();
  // above 48 KB only after opting in; not a stream operation, so it is
  // also legal while the stream is being captured into a graph
  cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<Raw, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(BH, (S + kBQ - 1) / kBQ);
  // vec: every 4-element chunk of a row is in bounds (d % 4 == 0) and
  // 4 * sizeof(Raw)-aligned
  flash_kernel<Raw, DP><<<grid, kThreads, kSmem, s>>>(
      static_cast<const Raw*>(q), static_cast<const Raw*>(k),
      static_cast<const Raw*>(v), static_cast<Raw*>(out), S, T, d, causal,
      window, scale, aligned && d % 4 == 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename Raw>
int launch_d(const void* q, const void* k, const void* v, void* out, int BH,
             int S, int T, int d, int causal, int window, float scale,
             bool aligned, cudaStream_t s) {
  if (d <= 64)
    return launch_typed<Raw, 64>(q, k, v, out, BH, S, T, d, causal, window,
                                 scale, aligned, s);
  if (d <= 128)
    return launch_typed<Raw, 128>(q, k, v, out, BH, S, T, d, causal, window,
                                  scale, aligned, s);
  return launch_typed<Raw, 256>(q, k, v, out, BH, S, T, d, causal, window,
                                scale, aligned, s);
}

}  // namespace

// Dynamic shared memory of one block at head dim d (bytes), for callers
// that report it.
extern "C" int flash_attention_smem_bytes(int d) {
  if (d <= 64) return (int)sizeof(float) * smem_floats<64>();
  if (d <= 128) return (int)sizeof(float) * smem_floats<128>();
  return (int)sizeof(float) * smem_floats<256>();
}

// dtype: 0 = f32, 1 = bf16. window <= 0: no window.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int BH, int S,
                                      int T, int d, int causal, int window,
                                      float scale, int dtype, void* stream) {
  if (d < 1 || d > 256 || S < 1 || T < 1 || (S + kBQ - 1) / kBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = ((reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v)) % 16) == 0;
  if (dtype == 0)
    return launch_d<float>(q, k, v, out, BH, S, T, d, causal, window, scale,
                           aligned, s);
  if (dtype == 1)
    return launch_d<unsigned short>(q, k, v, out, BH, S, T, d, causal, window,
                                    scale, aligned, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
