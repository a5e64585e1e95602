// An empty kernel, one warp: what the card itself spends on a launch.
// chip_smoke.py times it the way it times every kernel row (calls
// captured in one CUDA graph, replays timed between events), so the row
// is the floor under the other rows' device times; a kernel whose bound
// is far below it (the line enhancement at 1.15 µs) is held to bound +
// floor. Not a port of a TPU kernel.
#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int cv_empty_kernel(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
