// The device guard every C entry point of advect.cu and binsplat.cu
// launches under.

#pragma once

#include <cuda_runtime.h>

namespace nfs {

// Runs ``launch`` (which returns a cudaError_t) with ``device`` current,
// and makes the caller's device current again if it was another one.
template <class Launch>
int on_device(int device, Launch launch) {
  int caller = -1;
  cudaError_t err = cudaGetDevice(&caller);
  if (err == cudaSuccess && caller != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch();
  if (caller != device) cudaSetDevice(caller);
  return static_cast<int>(err);
}

}  // namespace nfs
