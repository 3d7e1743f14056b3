#!/usr/bin/env python3
"""Throughput of `mma.sync` alone on one NVIDIA GPU: tf32 m16n8k8 (the
generic pair's float32 products, three a product) and bf16 m16n8k16 (its
bf16 forms). One block an SM of 128, 256 or 512 threads; each warp runs
2,000 rounds over 16 independent accumulators (tf32: each accumulator's
three products in turn, as `mma3_tiles` issues them), operands in
registers, no memory traffic. Prints TFLOP/s and cycles a mma a
sub-partition at the card's 1.755 GHz boost clock, and the card.

    python scripts/mma_rate.py

Builds with nvcc for sm_90a into build/mma_rate/. Imports no JAX.
"""

import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <bool kTf32>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  if (kTf32)
    asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                 "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                 : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                   "r"(b1));
  else
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                 "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                 : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                   "r"(b1));
}
template <bool kTf32>
__global__ void probe(float* out, int iters) {
  float acc[16][4] = {};
  uint32_t a[4], b0 = (threadIdx.x * 3) & 0x3f00ffffu, b1 = b0 ^ 0x1234u;
  for (int i = 0; i < 4; ++i) a[i] = (threadIdx.x * 7 + i) & 0x3f00ffffu;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int r = 0; r < (kTf32 ? 3 : 1); ++r)
#pragma unroll
      for (int j = 0; j < 16; ++j) mma<kTf32>(acc[j], a, b0, b1);
  float s = 0.f;
  for (int j = 0; j < 16; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" float run(int tf32, int blocks, int threads, int iters) {
  float* out;
  cudaMalloc(&out, blocks * threads * 4);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  float ms = 0.f;
  for (int rep = 0; rep < 2; ++rep) {  // the first warms up
    cudaEventRecord(e0);
    if (tf32) probe<true><<<blocks, threads>>>(out, iters);
    else probe<false><<<blocks, threads>>>(out, iters);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    cudaEventElapsedTime(&ms, e0, e1);
  }
  cudaFree(out);
  return cudaGetLastError() == cudaSuccess ? ms : -1.f;
}
"""


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    from shapeclipper_torch.ops.cuda_lib import _find_nvcc
    out = os.path.join(REPO, "build", "mma_rate")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "mma_rate.cu"), "w") as f:
        f.write(SOURCE)
    lib_path = os.path.join(out, "libmma_rate.so")
    subprocess.run([_find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", lib_path,
                    os.path.join(out, "mma_rate.cu")], check=True)
    lib = ctypes.CDLL(lib_path)
    lib.run.restype = ctypes.c_float
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters = 2000
    for tf32 in (1, 0):
        for threads in (128, 256, 512):
            ms = lib.run(tf32, sms, threads, iters)
            if ms <= 0:
                raise SystemExit("the probe failed to launch")
            mmas = sms * threads // 32 * iters * 16 * (3 if tf32 else 1)
            flop = mmas * 2 * 16 * 8 * (8 if tf32 else 16)
            cycles = ms * 1e-3 * 1.755e9 / (mmas / (4 * sms))
            print(f"{'tf32 m16n8k8' if tf32 else 'bf16 m16n8k16'}, "
                  f"{threads} threads an SM: {ms:.3f} ms, "
                  f"{flop / ms / 1e9:.1f} TFLOP/s, {cycles:.2f} cycles a mma "
                  "a sub-partition", flush=True)
    print(f"card {cs.card_line()}")


if __name__ == "__main__":
    main()
