// The subset of the CUDA runtime that the device code of
// shapeclipper_torch/csrc/fused_sdf_generic.cu uses, for running that code
// on the CPU (tests/test_torch_generic_emulated.py): a block's threads are
// std::threads, __syncthreads a std::barrier over them, blocks run in turn.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>

struct dim3 {
  unsigned x = 0, y = 0, z = 0;
};
extern thread_local dim3 threadIdx;
extern dim3 blockIdx, gridDim, blockDim;

struct float4 {
  float x, y, z, w;
};
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __align__(n) __attribute__((aligned(n)))
#define __restrict__

using std::max;
using std::min;
void __syncthreads();
typedef int cudaError_t;
