// empty: a kernel that does nothing (sm_90a), the launch floor's
// yardstick. A CUDA graph replay of it costs what any kernel of the port
// costs before its first instruction: the launch, the block's start and
// its retirement. chip_smoke.py times it beside the ported kernels
// (kernel_footprint.launch_floor_ms); no op of the port calls it.
#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* empty_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
