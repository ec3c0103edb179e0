// fused_expand: one traversal expansion's whole filter stage for sm_90a,
// over a gathered block (the reference's op) or reading the popped rows
// of the layer in place (the search's expand).
//
// Replaces repro/kernels/fused_filter.py: fused_expand_pallas (and its
// helper ksort_block). Per query row: Dist.L of the M neighbor rows
// [M, dl] to q in f32, INF unless valid & d < th, then the k smallest
// (dist, index) pairs ascending with ties to the lower index. The rows
// are f32 or bf16 (layout (3) stored in bf16), read as they are and
// widened in registers, as the TPU kernel widens its block: every kernel
// here is instantiated for both payload types. Two entry
// points share filter_rows.cuh's body, which expand_rows.cuh's sources
// feed:
//
//   * fused_expand_launch takes the gathered [B, M, dl] block and its
//     [B, M] mask, as the reference's op (kernels "fused_expand_kernel*").
//   * fused_expand_rows_launch takes the layer itself (adj [N, M0],
//     layout-(3) packed_low [N, M0, dl]) with the popped ids (a strided
//     view of the frontier) and their gates, stages each gated popped
//     node's contiguous [M0, dl] block in shared memory by cp.async while
//     its adjacency row loads, and writes the winners' neighbour ids
//     (kernels "fused_expand_rows_kernel*"). That removes the search's
//     clamp/where of the popped ids, both index_select (the [B, W*M0, dl]
//     block written, then read back), the mask's ops, the threshold
//     column's copy and the id gather around the kernel: one launch a
//     trip for the pca expand, as pq_expand_rows is for the PQ one.
//     Stacked (adj [P, N, M0], packed_low [P, N, M0, dl], rows
//     shard-major: expand_rows.cuh's Rows adds each row's shard offset),
//     one launch serves every shard of the slotted sharded programs.
//
// The gathered block is read in place and the popped rows are staged
// (where their staging area fits shared memory), each fixed at compile
// time: the faster body where the main path runs each source.
//
// Bound on the card: bytes (filter_rows.cuh says why and how).
#include "filter_rows.cuh"

namespace {

using filter_rows::Args;
using expand_rows::Blocks;
using expand_rows::Rows;

template <class Pay, int PER_LANE>
__global__ void fused_expand_kernel(Args<Blocks, Pay> a) {
  filter_rows::warp_body<true, PER_LANE, false>(a);
}

template <class Pay>
__global__ void fused_expand_kernel_wide(Args<Blocks, Pay> a) {
  filter_rows::wide_body<true, false>(a);
}

template <class Pay, int PER_LANE, bool STAGED>
__global__ void fused_expand_rows_kernel(Args<Rows, Pay> a) {
  filter_rows::warp_body<true, PER_LANE, STAGED>(a);
}

template <class Pay, bool STAGED>
__global__ void fused_expand_rows_kernel_wide(Args<Rows, Pay> a) {
  filter_rows::wide_body<true, STAGED>(a);
}

// the gathered block is read in place (filter_rows.cuh says why)
template <class Pay>
struct BlocksKernels {
  static constexpr bool kStages = false;
  template <int P, bool S>
  static auto warp() { return fused_expand_kernel<Pay, P>; }
  template <bool S>
  static auto wide() { return fused_expand_kernel_wide<Pay>; }
};

// the popped rows are staged where the host plan fits them
template <class Pay>
struct RowsKernels {
  static constexpr bool kStages = true;
  template <int P, bool S>
  static auto warp() { return fused_expand_rows_kernel<Pay, P, S>; }
  template <bool S>
  static auto wide() { return fused_expand_rows_kernel_wide<Pay, S>; }
};

template <class Pay>
int run(const void* x, const void* q, const void* valid, const void* th,
        void* out_d, void* out_i, int B, int M, int dl, int k, int per_lane,
        int threads, void* scratch, void* stream) {
  const Args<Blocks, Pay> a{{static_cast<const uint8_t*>(valid), M},
                            static_cast<const Pay*>(x),
                            static_cast<const float*>(q),
                            static_cast<const float*>(th), 1,
                            static_cast<float*>(out_d),
                            static_cast<int32_t*>(out_i),
                            static_cast<float*>(scratch), B, M, dl, k,
                            {0, 0}};
  return filter_rows::launch<BlocksKernels<Pay>>(a, per_lane, threads, false,
                                                 stream);
}

template <class Pay>
int run_rows(const void* adj, const void* x, const void* cw,
             long long cw_stride, const void* gate, const void* q,
             const void* th, long long th_stride, void* out_d, void* out_i,
             int B, int W, int M0, int dl, int k, int shard_b,
             long long shard_n, int per_lane, int threads, int staged,
             int copy, int rw, void* scratch, void* stream) {
  const Args<Rows, Pay> a{{static_cast<const int32_t*>(adj),
                           static_cast<const int32_t*>(cw), cw_stride,
                           static_cast<const uint8_t*>(gate), W, M0,
                           shard_b, shard_n},
                          static_cast<const Pay*>(x),
                          static_cast<const float*>(q),
                          static_cast<const float*>(th), th_stride,
                          static_cast<float*>(out_d),
                          static_cast<int32_t*>(out_i),
                          static_cast<float*>(scratch), B, W * M0, dl, k,
                          {copy, rw}};
  return filter_rows::launch<RowsKernels<Pay>>(a, per_lane, threads,
                                               staged != 0, stream);
}

}  // namespace

// bf16: the payload x is bf16, else f32
extern "C" int fused_expand_launch(const void* x, const void* q,
                                   const void* valid, const void* th,
                                   void* out_d, void* out_i, int B, int M,
                                   int dl, int k, int per_lane, int threads,
                                   int bf16, void* scratch, void* stream) {
  return bf16 ? run<__nv_bfloat16>(x, q, valid, th, out_d, out_i, B, M, dl,
                                   k, per_lane, threads, scratch, stream)
              : run<float>(x, q, valid, th, out_d, out_i, B, M, dl, k,
                           per_lane, threads, scratch, stream);
}

// shard_b: rows a shard (B unstacked); shard_n: nodes a shard's table
// (0 unstacked)
extern "C" int fused_expand_rows_launch(
    const void* adj, const void* x, const void* cw, long long cw_stride,
    const void* gate, const void* q, const void* th, long long th_stride,
    void* out_d, void* out_i, int B, int W, int M0, int dl, int k,
    int shard_b, long long shard_n, int per_lane, int threads, int staged,
    int copy, int rw, int bf16, void* scratch, void* stream) {
  if (shard_b < 1 || shard_n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return bf16 ? run_rows<__nv_bfloat16>(
                    adj, x, cw, cw_stride, gate, q, th, th_stride, out_d,
                    out_i, B, W, M0, dl, k, shard_b, shard_n, per_lane,
                    threads, staged, copy, rw, scratch, stream)
              : run_rows<float>(adj, x, cw, cw_stride, gate, q, th,
                                th_stride, out_d, out_i, B, W, M0, dl, k,
                                shard_b, shard_n, per_lane, threads, staged,
                                copy, rw, scratch, stream);
}

extern "C" const char* fused_expand_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
