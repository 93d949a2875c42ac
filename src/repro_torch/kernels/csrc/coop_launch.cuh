// A cooperative launch (a grid whose CTAs may all wait at grid.sync()),
// made through cudaLaunchKernelExC with the cooperative launch attribute:
// the launch cudaLaunchCooperativeKernel makes, in the form a CUDA stream
// capture records as a graph node, so a kernel that uses it also runs
// inside a captured CUDA graph.
#pragma once

#include <cuda_runtime.h>

static inline cudaError_t launch_cooperative(const void* kernel, dim3 grid, dim3 block,
                                             void** args, size_t smem,
                                             cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelExC(&cfg, kernel, args);
}
