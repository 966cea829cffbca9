// An empty kernel, launched through the same library and the same ctypes
// path as the port's kernels: its device time in a profiler window is the
// launch floor, the least device time any kernel of the library shows,
// printed beside the small kernels' device times (chip_smoke.py,
// launch/profile_small_kernels.py). Replaces no TPU kernel.
#include <cuda_runtime.h>

namespace {

__global__ void repro_null_kernel() {}

}  // namespace

extern "C" {

// One block of one warp that does nothing, on `stream`; returns
// cudaGetLastError() after the launch.
int repro_null_launch(void* stream) {
  repro_null_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}

}  // extern "C"
