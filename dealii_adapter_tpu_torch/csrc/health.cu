// C1 and C2: build-and-launch health check of the kernel library.
//
//   C1: y = x * salt     C2: y = x + 1     (x an 8 x 128 f32 block)
//
// Replaces: dealii_adapter_tpu/utils/tunecache.py, the two Mosaic canaries
//   (C1: the subprocess canary `mosaic_canary`, pallas_call at :136; C2:
//   the in-process probe of `pallas_healthy`, pallas_call at :414). On the
//   TPU they decided whether Pallas kernels were usable in this process and
//   fell back to XLA when not. Here kernels/_build.py launches both right
//   after loading the library, before any real kernel runs, compares them
//   exactly with the same arithmetic done by PyTorch, and raises on any
//   mismatch or launch error: a library that was built for another card,
//   or a card that cannot run it, stops the program instead of falling
//   back.
//
// What bounds it: launch latency; the block is 4 KB.
//
// Beside them, dat_launch_floor launches an empty kernel of one block:
// chip_smoke.py times it to measure the card's floor for one launch, the
// third term of every kernel's bound in PERF.md. It replaces no TPU
// kernel and no path calls it.

#include <cuda_runtime.h>

namespace {

__global__ void scale_kernel(const float* __restrict__ x, float* __restrict__ y,
                             float salt, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i] * salt;
}

__global__ void add_one_kernel(const float* __restrict__ x,
                               float* __restrict__ y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i] + 1.0f;
}

__global__ void empty_kernel() {}

constexpr int kThreads = 128;

}  // namespace

extern "C" cudaError_t dat_health_scale(const void* x, void* y, float salt,
                                        int n, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  scale_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), salt, n);
  return cudaGetLastError();
}

extern "C" cudaError_t dat_health_add_one(const void* x, void* y, int n,
                                          void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  add_one_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), n);
  return cudaGetLastError();
}

extern "C" cudaError_t dat_launch_floor(void* stream) {
  empty_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}
