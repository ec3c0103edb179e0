// fused_filter: Dist.L + kSort.L in one kernel (no mask, no threshold)
// for sm_90a.
//
// Replaces repro/kernels/fused_filter.py: fused_filter_pallas. Per query
// row: Dist.L of the M rows [M, dl] to q in f32, then the k smallest
// (dist, index) pairs ascending with ties to the lower index. It is
// fused_expand.cu's op without the validity mask and the C_pca threshold:
// the same body, filter_rows.cuh, over a Blocks source with no mask and
// kMasked off (kernels "fused_filter_kernel*").
#include "filter_rows.cuh"

namespace {

using filter_rows::Args;
using expand_rows::Blocks;

template <int PER_LANE>
__global__ void fused_filter_kernel(Args<Blocks> a) {
  filter_rows::warp_body<false, PER_LANE, false>(a);
}

__global__ void fused_filter_kernel_wide(Args<Blocks> a) {
  filter_rows::wide_body<false, false>(a);
}

// the block is read in place: faster than staged at the footprint
// bench's row (filter_rows.cuh)
struct Kernels {
  static constexpr bool kStages = false;
  template <int P, bool S>
  static auto warp() { return fused_filter_kernel<P>; }
  template <bool S>
  static auto wide() { return fused_filter_kernel_wide; }
};

}  // namespace

extern "C" int fused_filter_launch(const void* x, const void* q, void* out_d,
                                   void* out_i, int B, int M, int dl, int k,
                                   int per_lane, int threads, void* scratch,
                                   void* stream) {
  const Args<Blocks> a{{nullptr, M},
                       static_cast<const float*>(x),
                       static_cast<const float*>(q), nullptr, 0,
                       static_cast<float*>(out_d),
                       static_cast<int32_t*>(out_i),
                       static_cast<float*>(scratch), B, M, dl, k, {0, 0}};
  return filter_rows::launch<Kernels>(a, per_lane, threads, false, stream);
}

extern "C" const char* fused_filter_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
