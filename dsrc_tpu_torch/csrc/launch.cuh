// The launch convention of the port's C entry points (K1-K5).
#pragma once
#include <cuda_runtime.h>

namespace dsrc {

// Runs launch() with `device` current on the calling thread: makes it
// current only when it is not, and sets the thread's earlier device back
// afterwards, so a wrapper needs no device context around the call (the
// block mesh launches on several cards from one thread).  Returns the
// first CUDA error of the three.
template <typename Launch>
cudaError_t on_device(int device, Launch&& launch) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  if (current != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
  }
  err = launch();
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return err;
}

}  // namespace dsrc
