// A stamp of the card's global timer: the device spans of the port's train
// step (utils/profiling.py: StepSpans) are these stamps, one launch each.
//
// One thread writes %globaltimer (nanoseconds) into slot idx of a buffer.
// The launch is a node between the step's kernels in stream order (and in
// a CUDA graph, one node of the graph that every replay runs again), so a
// stamp reads the time at which the work before it ended and the work
// after it may start.  A kernel and not a CUDA event: on an NVIDIA H100
// 80GB HBM3 at 700 W, a timing event recorded as a graph node added 4.3 us
// to a replay, a minimal kernel node 0.71 us.
//
// No TPU counterpart: the JAX package has no device spans.

#include <cuda_runtime.h>

namespace {

__global__ void timer_stamp_kernel(unsigned long long* buf, int idx) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  buf[idx] = t;
}

}  // namespace

// buf: int64 [>= idx + 1] on the card; stream: the CUDA stream to launch on.
extern "C" int timer_stamp_launch(void* buf, int idx, void* stream) {
  if (idx < 0) return (int)cudaErrorInvalidValue;
  timer_stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((unsigned long long*)buf, idx);
  return (int)cudaGetLastError();
}
