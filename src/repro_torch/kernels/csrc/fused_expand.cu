// fused_expand: one traversal expansion's whole filter stage for sm_90a.
//
// Replaces repro/kernels/fused_filter.py: fused_expand_pallas (and its
// helper ksort_block). Per query row: Dist.L of the M neighbor rows
// [M, dl] to q in f32, INF unless valid & d < th, then the k smallest
// (dist, index) pairs ascending with ties to the lower index. The body
// (one warp per row, the top-k of warp_topk.cuh) is filter_rows.cuh's,
// shared with fused_filter.cu.
#include "filter_rows.cuh"

extern "C" int fused_expand_launch(const void* x, const void* q,
                                   const void* valid, const void* th,
                                   void* out_d, void* out_i, int B, int M,
                                   int dl, int k, int per_lane,
                                   int threads, void* scratch,
                                   void* stream) {
  return filter_rows::launch<true>(x, q, valid, th, out_d, out_i, B, M, dl,
                                   k, per_lane, threads, scratch, stream);
}

extern "C" const char* fused_expand_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
