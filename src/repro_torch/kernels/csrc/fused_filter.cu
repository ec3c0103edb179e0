// fused_filter: Dist.L + kSort.L in one kernel (no mask, no threshold)
// for sm_90a.
//
// Replaces repro/kernels/fused_filter.py: fused_filter_pallas. Per query
// row: Dist.L of the M rows [M, dl] to q in f32, then the k smallest
// (dist, index) pairs ascending with ties to the lower index. It is
// fused_expand.cu without the validity mask and the C_pca threshold: the
// same body, filter_rows.cuh, with kMasked off.
#include "filter_rows.cuh"

extern "C" int fused_filter_launch(const void* x, const void* q, void* out_d,
                                   void* out_i, int B, int M, int dl, int k,
                                   int per_lane, int threads, void* scratch,
                                   void* stream) {
  return filter_rows::launch<false>(x, q, nullptr, nullptr, out_d, out_i, B,
                                    M, dl, k, per_lane, threads, scratch,
                                    stream);
}

extern "C" const char* fused_filter_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
