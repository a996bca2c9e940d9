// A hold on a stream that the host releases: one thread spins on a word of
// pinned, mapped host memory until the host writes a nonzero value there,
// or until `max_ns` nanoseconds of the card's global timer have passed, and
// then writes back 1 (released by the host) or 2 (timed out). Work queued
// behind it on the stream waits until then. The card tests use it to hold
// the migration copy stream busy for exactly as long as their assertions
// need, where a timed sleep can end first on a slow host. It replaces no
// TPU kernel and runs on no serving path.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void hold_kernel(volatile int* flag, long long max_ns) {
  const uint64_t t0 = global_ns();
  int state = 1;
  while (*flag == 0) {
    if ((long long)(global_ns() - t0) > max_ns) {
      state = 2;
      break;
    }
    __nanosleep(1000);
  }
  *flag = state;
  __threadfence_system();
}

}  // namespace

// Returns a cudaError_t code (0 = launched). flag: a host pointer of pinned
// memory (cudaHostAlloc; mapped under unified addressing) holding 0.
extern "C" int stream_hold_launch(void* flag, long long max_ns, void* stream) {
  void* dev = nullptr;
  cudaError_t e = cudaHostGetDevicePointer(&dev, flag, 0);
  if (e != cudaSuccess) return (int)e;
  hold_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<volatile int*>(dev), max_ns);
  return (int)cudaGetLastError();
}
