// The dynamic shared-memory opt-in of a kernel, once per device.
//
// cudaFuncSetAttribute acts on the current device's context only, so a
// flag per process would grant the larger limit on the first card a
// process launches on and no other (a process that launches on a second
// card, or a rank whose card is not the first, would see its launches
// refused there). The flag is kept per device instead, one bit per device
// index, read from cudaGetDevice at each launch (the launch goes to the
// current device; the Python side makes a rank's card current,
// `parallel/partition.py:make_device_mesh`). A process launches from one
// thread, so the bits need no lock.
#pragma once

#include <cuda_runtime.h>

namespace dat {

template <typename Kernel>
cudaError_t max_dynamic_smem_once(Kernel* kernel, int bytes,
                                  unsigned long long& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit != 0 && (done & bit) != 0) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done |= bit;
  return err;
}

}  // namespace dat
