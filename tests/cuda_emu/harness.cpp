// Runs the device code of shapeclipper_torch/csrc/fused_sdf_generic.cu
// (copied above its C entry points into device_part.inc by the test) on the
// CPU: every block of a grid in turn, its 256 threads as std::threads.
// Shared memory starts as NaN patterns, so a read before a write shows.
// The entry points mirror scl_sdf_generic_fwd / _bwd without the stream.
#include "cuda_runtime.h"

#include <functional>
#include <thread>
#include <vector>

thread_local dim3 threadIdx;
dim3 blockIdx, gridDim, blockDim;
static std::barrier<>* g_barrier;
void __syncthreads() { g_barrier->arrive_and_wait(); }
namespace {
alignas(16) float smem[1 << 17];
}
#include "device_part.inc"

static void run_grid(int grid, const std::function<void()>& body) {
  gridDim.x = grid;
  blockDim.x = kThreads;
  for (int b = 0; b < grid; ++b) {
    blockIdx.x = b;
    std::barrier<> barrier(kThreads);
    g_barrier = &barrier;
    std::memset(smem, 0xff, sizeof(smem));
    std::vector<std::thread> threads;
    for (int t = 0; t < kThreads; ++t)
      threads.emplace_back([&, t] {
        threadIdx.x = t;
        body();
      });
    for (auto& t : threads) t.join();
  }
}

static bool arch_of(Arch* a, int f, int l, int w, int m, bool grad,
                    bool backward) {
  if (!make_arch(a, f, l, w, m)) return false;
  const int rows = choose_rows(*a, backward);
  if (!rows) return false;
  set_tile(a, rows, grad);
  return true;
}

extern "C" int emu_tile_points(int f, int l, int w, int m, int grad,
                               int backward) {
  Arch a;
  return arch_of(&a, f, l, w, m, grad || backward, backward) ? a.points : -1;
}

extern "C" int emu_fwd(const float* p, const float* w, const float* bi,
                       float* sdf, float* feat, float* grad, int B, int N,
                       int f, int l, int wd, int m, int compute_grad, int sym,
                       int bf16) {
  Arch a;
  if (!arch_of(&a, f, l, wd, m, compute_grad, false)) return 1;
  run_grid(B * ((N + a.points - 1) / a.points), [&] {
    if (compute_grad && bf16)
      sdf_generic_fwd_kernel<true, true>(p, w, bi, sdf, feat, grad, N, sym, a);
    else if (compute_grad)
      sdf_generic_fwd_kernel<true, false>(p, w, bi, sdf, feat, grad, N, sym,
                                          a);
    else if (bf16)
      sdf_generic_fwd_kernel<false, true>(p, w, bi, sdf, feat, grad, N, sym,
                                          a);
    else
      sdf_generic_fwd_kernel<false, false>(p, w, bi, sdf, feat, grad, N, sym,
                                           a);
  });
  return 0;
}

extern "C" int emu_bwd(const float* p, const float* w, const float* bi,
                       const float* sbar, const float* fbar, const float* gbar,
                       float* dpoints, float* out, float* partials,
                       float* stash, int B, int N, int grid, int f, int l,
                       int wd, int m, int sym, int bf16) {
  Arch a;
  if (!arch_of(&a, f, l, wd, m, true, true)) return 1;
  run_grid(grid, [&] {
    if (bf16)
      sdf_generic_bwd_kernel<true>(p, w, bi, sbar, fbar, gbar, dpoints,
                                   partials, stash, B, N, sym, a);
    else
      sdf_generic_bwd_kernel<false>(p, w, bi, sbar, fbar, gbar, dpoints,
                                    partials, stash, B, N, sym, a);
  });
  const size_t n = (size_t)a.num_weights + (size_t)B * a.bias_width;
  blockDim.x = 256;
  for (unsigned b = 0; b < (n + 255) / 256; ++b) {
    blockIdx.x = b;
    for (int t = 0; t < 256; ++t) {
      threadIdx.x = t;
      sum_partials_kernel(partials, out, n, grid);
    }
  }
  return 0;
}
