// Runs the device code of shapeclipper_torch/csrc/fused_sdf_generic.cu
// (copied above its C entry points into device_part.inc by the test) on the
// CPU, and emulates the warp-collective functions that
// fused_sdf_generic_bf16.cu uses (harness_bf16.cpp runs that file's device
// part). The entry points mirror scl_sdf_generic_fwd / _bwd without the
// stream.
#include "cuda_runtime.h"
#include "harness.h"

#include <thread>
#include <vector>

thread_local dim3 threadIdx;
dim3 blockIdx, gridDim, blockDim;
static std::barrier<>* g_barrier;
void __syncthreads() { g_barrier->arrive_and_wait(); }

// ------------------------------------------------------------------ warps
namespace {

constexpr int kEmuWarps = 8;

// Two slots of each exchange, used in turn by consecutive collectives: a
// lane can write slot k % 2 only after every lane passed collective k - 1's
// barrier, that is after it read slot k % 2 in collective k - 2.
struct Warp {
  std::barrier<>* bar;
  const void* addr[2][32];
  uint32_t regs[2][32][6];
  float val[2][32];
};
Warp g_warps[kEmuWarps];
thread_local int t_slot = 0;

struct Copy {
  void* dst;
  const void* src;
  bool valid;
};
thread_local std::vector<Copy> t_pending;
thread_local std::vector<std::vector<Copy>> t_groups;

Warp& my_warp(int& lane, int& slot) {
  lane = threadIdx.x % 32;
  slot = t_slot;
  t_slot ^= 1;
  return g_warps[threadIdx.x / 32];
}

uint16_t half_of(uint32_t v, int hi) { return uint16_t(hi ? v >> 16 : v); }

float bf16_value(uint16_t h) {
  const uint32_t u = uint32_t(h) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

}  // namespace

void __syncwarp(unsigned) { g_warps[threadIdx.x / 32].bar->arrive_and_wait(); }

float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  int lane, s;
  Warp& w = my_warp(lane, s);
  w.val[s][lane] = v;
  w.bar->arrive_and_wait();
  return w.val[s][lane ^ lane_mask];
}

// Matrix i of .x4 / .x2 / .x1 takes its row addresses from lanes 8 i ..
// 8 i + 7; lane (g = lane / 4, t = lane % 4) receives row g, columns 2 t and
// 2 t + 1 (the lower in the low half), or with .trans rows 2 t and 2 t + 1
// of column g.
void emu_ldmatrix(uint32_t* r, const void* row, int count, bool trans) {
  int lane, s;
  Warp& w = my_warp(lane, s);
  w.addr[s][lane] = row;
  w.bar->arrive_and_wait();
  const int g = lane / 4, t = lane % 4;
  for (int i = 0; i < count; ++i) {
    uint16_t lo, hi;
    if (!trans) {
      const uint16_t* p = static_cast<const uint16_t*>(w.addr[s][8 * i + g]);
      lo = p[2 * t];
      hi = p[2 * t + 1];
    } else {
      lo = static_cast<const uint16_t*>(w.addr[s][8 * i + 2 * t])[g];
      hi = static_cast<const uint16_t*>(w.addr[s][8 * i + 2 * t + 1])[g];
    }
    r[i] = uint32_t(lo) | (uint32_t(hi) << 16);
  }
}

// A (16 x 16): a0 (row g, columns 2t, 2t + 1), a1 (row g + 8), a2 (row g,
// columns 2t + 8, 2t + 9), a3 (row g + 8, those); B (16 x 8): b0 (rows 2t,
// 2t + 1 of column g), b1 (rows 2t + 8, 2t + 9); C: c0, c1 (row g, columns
// 2t, 2t + 1), c2, c3 (row g + 8). The products of bf16 values are exact in
// float32; each output is c + their sum, rounded once.
void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
              uint32_t b1) {
  int lane, s;
  Warp& w = my_warp(lane, s);
  uint32_t* mine = w.regs[s][lane];
  for (int i = 0; i < 4; ++i) mine[i] = a[i];
  mine[4] = b0;
  mine[5] = b1;
  w.bar->arrive_and_wait();
  auto A = [&](int row, int k) {
    const uint32_t v = w.regs[s][4 * (row % 8) + (k % 8) / 2]
                               [(row >= 8 ? 1 : 0) + (k >= 8 ? 2 : 0)];
    return bf16_value(half_of(v, k % 2));
  };
  auto B = [&](int k, int col) {
    const uint32_t v = w.regs[s][4 * col + (k % 8) / 2][4 + (k >= 8 ? 1 : 0)];
    return bf16_value(half_of(v, k % 2));
  };
  const int g = lane / 4, t = lane % 4;
  for (int j = 0; j < 4; ++j) {
    const int row = g + 8 * (j >> 1), col = 2 * t + (j & 1);
    double sum = 0.0;
    for (int k = 0; k < 16; ++k) sum += double(A(row, k)) * B(k, col);
    c[j] = float(double(c[j]) + sum);
  }
}

void cp_async16(void* dst, const void* src, bool valid) {
  t_pending.push_back({dst, src, valid});
}

void cp_async_commit() {
  t_groups.push_back(std::move(t_pending));
  t_pending.clear();
}

// The copies of all but this thread's newest n groups land now.
void emu_cp_async_wait(int n) {
  while ((int)t_groups.size() > n) {
    for (const Copy& c : t_groups.front()) {
      if (c.valid)
        std::memcpy(c.dst, c.src, 16);
      else
        std::memset(c.dst, 0, 16);
    }
    t_groups.erase(t_groups.begin());
  }
}

bool run_grid(int grid, const std::function<void()>& body, void* smem,
              size_t bytes) {
  constexpr int kBlock = 32 * kEmuWarps;
  gridDim.x = grid;
  blockDim.x = kBlock;
  bool clean = true;
  for (int b = 0; b < grid; ++b) {
    blockIdx.x = b;
    std::barrier<> barrier(kBlock);
    g_barrier = &barrier;
    std::vector<std::barrier<>*> warp_bars;
    for (int i = 0; i < kEmuWarps; ++i) {
      warp_bars.push_back(new std::barrier<>(32));
      g_warps[i].bar = warp_bars.back();
    }
    std::memset(smem, 0xff, bytes);
    std::vector<char> done(kBlock, 1);
    std::vector<std::thread> threads;
    for (int t = 0; t < kBlock; ++t)
      threads.emplace_back([&, t] {
        threadIdx.x = t;
        body();
        done[t] = t_pending.empty() && t_groups.empty();
      });
    for (auto& t : threads) t.join();
    for (auto* bar : warp_bars) delete bar;
    for (char d : done) clean = clean && d;
  }
  return clean;
}

// ------------------------------------------------------------- float32 K8 / K9
namespace {
alignas(16) float smem[1 << 17];
}
#include "device_part.inc"

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
                       int f, int l, int wd, int m, int compute_grad,
                       int sym) {
  Arch a;
  if (!arch_of(&a, f, l, wd, m, compute_grad, false)) return 1;
  const bool ok = run_grid(
      B * ((N + a.points - 1) / a.points),
      [&] {
        if (compute_grad)
          sdf_generic_fwd_kernel<true>(p, w, bi, sdf, feat, grad, N, sym, a);
        else
          sdf_generic_fwd_kernel<false>(p, w, bi, sdf, feat, grad, N, sym, a);
      },
      smem, sizeof(smem));
  return ok ? 0 : 2;
}

extern "C" int emu_bwd(const float* p, const float* w, const float* bi,
                       const float* sbar, const float* fbar, const float* gbar,
                       float* dpoints, float* out, float* partials,
                       float* stash, int B, int N, int grid, int f, int l,
                       int wd, int m, int sym) {
  Arch a;
  if (!arch_of(&a, f, l, wd, m, true, true)) return 1;
  const bool ok = run_grid(
      grid,
      [&] {
        sdf_generic_bwd_kernel(p, w, bi, sbar, fbar, gbar, dpoints, partials,
                               stash, B, N, sym, a);
      },
      smem, sizeof(smem));
  const size_t n = (size_t)a.num_weights + (size_t)B * a.bias_width;
  blockDim.x = 256;
  for (unsigned b = 0; b < (n + 255) / 256; ++b) {
    blockIdx.x = b;
    for (int t = 0; t < 256; ++t) {
      threadIdx.x = t;
      sum_partials_kernel(partials, out, n, grid);
    }
  }
  return ok ? 0 : 2;
}
