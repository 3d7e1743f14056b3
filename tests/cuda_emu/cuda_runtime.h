// The subset of the CUDA runtime that the device code of
// shapeclipper_torch/csrc/fused_sdf_generic.cu and fused_sdf_generic_bf16.cu
// uses, for running that code on the CPU
// (tests/test_torch_generic_emulated.py):
// a block's threads are std::threads, __syncthreads a std::barrier over
// them, blocks run in turn. The warp-collective fragment functions
// (ldmatrix, mma.sync m16n8k16 bf16 and m16n8k8 tf32, shuffles) exchange
// through per-warp slots behind a per-warp std::barrier, with the PTX ISA's
// fragment layouts; cp.async copies are queued per thread and land when the
// thread waits for their group. K8-bf16's wgmma form: wgmma reads its
// operands through their descriptors when its group is waited for,
// mbarriers count arrivals and transaction bytes, and a bulk copy lands
// when a thread waits on its barrier (harness.cpp).
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
struct float2 {
  float x, y;
};
inline float2 make_float2(float a, float b) { return {a, b}; }

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
inline float __expf(float x) { return std::exp(x); }
inline float __logf(float x) { return std::log(x); }
inline float __fdividef(float a, float b) { return a / b; }
inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline uint32_t __float_as_uint(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  return u;
}
void __syncthreads();
typedef int cudaError_t;
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
  return 0;
}

// the fragment plumbing of fused_sdf_generic.cu and fused_sdf_generic_bf16.cu
#define SCL_EMULATED 1
// the block's shared memory (run_grid's `smem`); a shared address is the
// offset into it
extern char* emu_smem;
inline uint32_t smem_u32(const void* p) {
  return uint32_t(static_cast<const char*>(p) - emu_smem);
}
void __syncwarp(unsigned mask = 0xffffffffu);
float __shfl_xor_sync(unsigned mask, float v, int lane_mask);
// ldmatrix.m8n8 .x{count} (.trans): `row` is this lane's row address
void emu_ldmatrix(uint32_t* r, const void* row, int count, bool trans);
inline void ldsm2(uint32_t (&r)[2], const void* p) {
  emu_ldmatrix(r, p, 2, false);
}
inline void ldsm2t(uint32_t (&r)[2], const void* p) {
  emu_ldmatrix(r, p, 2, true);
}
inline void ldsm4(uint32_t (&r)[4], const void* p) {
  emu_ldmatrix(r, p, 4, false);
}
inline void ldsm4t(uint32_t (&r)[4], const void* p) {
  emu_ldmatrix(r, p, 4, true);
}
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, c += A B
void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
              uint32_t b1);
// cvt.rna.tf32.f32: x to 10 mantissa bits, nearest, ties away from zero
// (the magnitude's bit 12 added, the low 13 bits cleared); NaN as it is
inline uint32_t tf32_rna(float x) {
  const uint32_t u = __float_as_uint(x);
  if ((u & 0x7fffffffu) > 0x7f800000u) return u;
  return (u + 0x1000u) & 0xffffe000u;
}
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, c += A B, each
// operand register read as the hardware reads it: its top 19 bits
void mma1688(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
             uint32_t b1);
void cp_async16(void* dst, const void* src, bool valid);
void cp_async4(void* dst, const void* src);
void cp_async8(void* dst, const void* src);
void cp_async_commit();
void emu_cp_async_wait(int n);
inline void prefetch_l2(const void*) {}
template <int N>
inline void cp_async_wait() {
  emu_cp_async_wait(N);
}
// mbarrier.init / arrive / arrive.expect_tx / try_wait.parity (blocking
// until the phase of `parity` has completed); fence.mbarrier_init is
// implied
void mbar_init(uint64_t* bar, int count);
inline void mbar_fence_init() {}
void mbar_arrive(uint64_t* bar);
void mbar_expect_tx(uint64_t* bar, int bytes);
void mbar_wait(uint64_t* bar, int parity);
// cp.async.bulk global -> shared, completing on `bar`: queued on the
// barrier, copied when a thread waits on it after its arrivals are in
void bulk_g2s(void* dst, const void* src, int bytes, uint64_t* bar);
// wgmma.mma_async m64nNk16 bf16 -> f32 (N 256 or 16), K-major operands
// through their descriptors (128-byte swizzle), queued in this thread's
// open group and evaluated when the group is waited for
void emu_wgmma(float* d, int n, uint64_t da, uint64_t db, int accumulate);
inline void wgmma_n256(float (&d)[128], uint64_t da, uint64_t db,
                       int accumulate) {
  emu_wgmma(d, 256, da, db, accumulate);
}
inline void wgmma_n16(float (&d)[8], uint64_t da, uint64_t db,
                      int accumulate) {
  emu_wgmma(d, 16, da, db, accumulate);
}
inline void wg_fence() {}
void wg_commit();
void emu_wg_wait(int n);
template <int N>
inline void wg_wait() {
  emu_wg_wait(N);
}
inline void fence_async_smem() {}
template <int N>
inline void wg_keep(float (&)[N]) {}
// bar.sync id, 128
void wg_bar(int id);
