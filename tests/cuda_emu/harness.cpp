// Runs the device code of shapeclipper_torch/csrc/fused_sdf_generic.cu
// (copied above its C entry points into device_part.inc by the test) on the
// CPU, and emulates the warp-collective functions that it and
// fused_sdf_generic_bf16.cu use (harness_bf16.cpp runs that file's device
// part). The entry points mirror scl_sdf_generic_pack_tf32 / _fwd / _bwd
// without the stream.
#include "cuda_runtime.h"
#include "harness.h"

#include <condition_variable>
#include <map>
#include <mutex>
#include <thread>
#include <vector>

thread_local dim3 threadIdx;
dim3 blockIdx, gridDim, blockDim;
char* emu_smem;
static std::barrier<>* g_barrier;
void __syncthreads() { g_barrier->arrive_and_wait(); }

// ------------------------------------------------------------------ warps
namespace {

constexpr int kEmuWarps = 12;  // the most a block has here

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
  int bytes;  // 0: zero-fill 16
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

// A (16 x 8): a0 (row g, column t), a1 (row g + 8), a2 (row g, column
// t + 4), a3 (row g + 8, column t + 4); B (8 x 8): b0 (row t, column g), b1
// (row t + 4); C as mma16816's. Each operand register counts as its top 19
// bits (the hardware ignores the low 13), so an operand that was not split
// loses them; the products are exact in double, the sum is rounded once.
void mma1688(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
             uint32_t b1) {
  int lane, s;
  Warp& w = my_warp(lane, s);
  uint32_t* mine = w.regs[s][lane];
  for (int i = 0; i < 4; ++i) mine[i] = a[i];
  mine[4] = b0;
  mine[5] = b1;
  w.bar->arrive_and_wait();
  auto tf32 = [](uint32_t v) {
    return double(__uint_as_float(v & 0xffffe000u));
  };
  auto A = [&](int row, int k) {
    return tf32(w.regs[s][4 * (row % 8) + k % 4]
                          [(row >= 8 ? 1 : 0) + (k >= 4 ? 2 : 0)]);
  };
  auto B = [&](int k, int col) {
    return tf32(w.regs[s][4 * col + k % 4][4 + (k >= 4 ? 1 : 0)]);
  };
  const int g = lane / 4, t = lane % 4;
  for (int j = 0; j < 4; ++j) {
    const int row = g + 8 * (j >> 1), col = 2 * t + (j & 1);
    double sum = 0.0;
    for (int k = 0; k < 8; ++k) sum += A(row, k) * B(k, col);
    c[j] = float(double(c[j]) + sum);
  }
}

void cp_async16(void* dst, const void* src, bool valid) {
  t_pending.push_back({dst, src, valid ? 16 : 0});
}

void cp_async4(void* dst, const void* src) {
  t_pending.push_back({dst, src, 4});
}

void cp_async8(void* dst, const void* src) {
  t_pending.push_back({dst, src, 8});
}

void cp_async_commit() {
  t_groups.push_back(std::move(t_pending));
  t_pending.clear();
}

// The copies of all but this thread's newest n groups land now.
void emu_cp_async_wait(int n) {
  while ((int)t_groups.size() > n) {
    for (const Copy& c : t_groups.front()) {
      if (c.bytes)
        std::memcpy(c.dst, c.src, c.bytes);
      else
        std::memset(c.dst, 0, 16);
    }
    t_groups.erase(t_groups.begin());
  }
}

// ------------------------------------------- wgmma, mbarriers, bulk copies
namespace {

struct WgOp {
  float* d;
  int n;
  uint64_t da, db;
  int accumulate;
};
thread_local std::vector<WgOp> t_wg_open;
thread_local std::vector<std::vector<WgOp>> t_wg_groups;

struct Bar {
  int count = 0, pending = 0, phase = 0;
  long tx = 0;
  std::vector<Copy> copies;
};
std::mutex g_mu;
std::condition_variable g_cv;
std::map<uint32_t, Bar> g_bars;
std::map<int, std::barrier<>*> g_named;

// A K-major bf16 operand's element (row, k < 16) through descriptor `desc`:
// start address (bits 0-13, 16-byte units), stride between 8-row groups
// (bits 32-45), 128-byte swizzle (bits 62-63 = 1, the only mode the kernels
// use): the byte address's bits 4-6 XOR its bits 7-9.
bool g_bad_desc = false;  // a descriptor of another mode: the block fails

float desc_elem(uint64_t desc, int row, int k) {
  if ((desc >> 62) != 1 || (desc >> 49 & 7) != 0) {
    g_bad_desc = true;
    return 0.f;
  }
  const uint32_t start = uint32_t(desc & 0x3fff) << 4;
  const uint32_t sbo = uint32_t((desc >> 32) & 0x3fff) << 4;
  uint32_t addr = start + (row / 8) * sbo + (row % 8) * 128 + 2 * k;
  addr ^= ((addr >> 7) & 7) << 4;
  uint16_t v;
  std::memcpy(&v, emu_smem + addr, 2);
  return bf16_value(v);
}

// This thread's part of D (+)= A B: warp w of the warpgroup, lane (g, t)
// holds rows 16 w + g and 16 w + g + 8 at columns 8 j + 2 t, + 1
// (d[4 j + 2 i + e]: row 16 w + g + 8 i, column 8 j + 2 t + e).
void wg_eval(const WgOp& op) {
  const int tw = threadIdx.x % 128, w = tw / 32, lane = tw % 32;
  const int g = lane / 4, t = lane % 4;
  for (int j = 0; j < op.n / 8; ++j)
    for (int i = 0; i < 2; ++i)
      for (int e = 0; e < 2; ++e) {
        const int row = 16 * w + g + 8 * i, col = 8 * j + 2 * t + e;
        double sum = 0.0;
        for (int k = 0; k < 16; ++k)
          sum += double(desc_elem(op.da, row, k)) * desc_elem(op.db, col, k);
        float& d = op.d[4 * j + 2 * i + e];
        d = float((op.accumulate ? double(d) : 0.0) + sum);
      }
}

// the phase completes once its arrivals are in and its bytes have landed
void bar_settle(Bar& b) {
  if (b.pending == 0 && b.tx == 0) {
    b.phase ^= 1;
    b.pending = b.count;
  }
}

}  // namespace

void emu_wgmma(float* d, int n, uint64_t da, uint64_t db, int accumulate) {
  t_wg_open.push_back({d, n, da, db, accumulate});
}

void wg_commit() {
  t_wg_groups.push_back(std::move(t_wg_open));
  t_wg_open.clear();
}

// .sync.aligned: the warp's lanes meet before and after, as converged
// lanes do on the card, so a lane that arrives on a barrier after the wait
// speaks for a warp whose products are all done
void emu_wg_wait(int n) {
  __syncwarp();
  while ((int)t_wg_groups.size() > n) {
    for (const WgOp& op : t_wg_groups.front()) wg_eval(op);
    t_wg_groups.erase(t_wg_groups.begin());
  }
  __syncwarp();
}

void mbar_init(uint64_t* bar, int count) {
  std::lock_guard<std::mutex> lock(g_mu);
  Bar& b = g_bars[smem_u32(bar)];
  b = Bar();
  b.count = b.pending = count;
}

void mbar_arrive(uint64_t* bar) {
  std::lock_guard<std::mutex> lock(g_mu);
  Bar& b = g_bars.at(smem_u32(bar));
  --b.pending;
  bar_settle(b);
  g_cv.notify_all();
}

void mbar_expect_tx(uint64_t* bar, int bytes) {
  std::lock_guard<std::mutex> lock(g_mu);
  Bar& b = g_bars.at(smem_u32(bar));
  b.tx += bytes;
  --b.pending;
  bar_settle(b);
  g_cv.notify_all();
}

void bulk_g2s(void* dst, const void* src, int bytes, uint64_t* bar) {
  std::lock_guard<std::mutex> lock(g_mu);
  g_bars.at(smem_u32(bar)).copies.push_back({dst, src, bytes});
  g_cv.notify_all();
}

// A waiter lands the copies of a phase whose arrivals are in.
void mbar_wait(uint64_t* bar, int parity) {
  std::unique_lock<std::mutex> lock(g_mu);
  Bar& b = g_bars.at(smem_u32(bar));
  for (;;) {
    if (b.pending == 0 && !b.copies.empty()) {
      for (const Copy& c : b.copies) {
        std::memcpy(c.dst, c.src, c.bytes);
        b.tx -= c.bytes;
      }
      b.copies.clear();
      bar_settle(b);
      g_cv.notify_all();
    }
    if (b.phase != parity) return;
    g_cv.wait(lock);
  }
}

void wg_bar(int id) {
  std::barrier<>* bar;
  {
    std::lock_guard<std::mutex> lock(g_mu);
    std::barrier<>*& b = g_named[id];
    if (!b) b = new std::barrier<>(128);
    bar = b;
  }
  bar->arrive_and_wait();
}

bool run_grid(int grid, const std::function<void()>& body, void* smem,
              size_t bytes, int threads) {
  const int warps = threads / 32;
  if (threads % 32 || warps > kEmuWarps) return false;
  gridDim.x = grid;
  blockDim.x = threads;
  emu_smem = static_cast<char*>(smem);
  bool clean = true;
  for (int b = 0; b < grid; ++b) {
    blockIdx.x = b;
    std::barrier<> barrier(threads);
    g_barrier = &barrier;
    std::vector<std::barrier<>*> warp_bars;
    for (int i = 0; i < warps; ++i) {
      warp_bars.push_back(new std::barrier<>(32));
      g_warps[i].bar = warp_bars.back();
    }
    std::memset(smem, 0xff, bytes);
    std::vector<char> done(threads, 1);
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t)
      pool.emplace_back([&, t] {
        threadIdx.x = t;
        body();
        done[t] = t_pending.empty() && t_groups.empty() &&
                  t_wg_open.empty() && t_wg_groups.empty();
      });
    for (auto& t : pool) t.join();
    for (auto* bar : warp_bars) delete bar;
    for (char d : done) clean = clean && d;
    for (auto& kv : g_bars) clean = clean && kv.second.copies.empty();
    clean = clean && !g_bad_desc;
    g_bad_desc = false;
    g_bars.clear();
    for (auto& kv : g_named) delete kv.second;
    g_named.clear();
  }
  return clean;
}

// ------------------------------------------------- float32 (3xTF32) K8 / K9
namespace {
alignas(16) float smem[1 << 17];
}
#include "device_part.inc"

static bool tile_of(Arch* a, Tile* t, int f, int l, int w, int m, bool grad,
                    bool backward) {
  return make_arch(a, f, l, w, m) && make_tile(t, *a, grad, backward) &&
         smem_bytes(*a, *t, backward) <= (int)sizeof(smem);
}

extern "C" int emu_tile_points(int f, int l, int w, int m, int grad,
                               int backward) {
  Arch a;
  Tile t;
  return tile_of(&a, &t, f, l, w, m, grad || backward, backward) ? t.points
                                                                 : -1;
}

extern "C" int emu_stash_floats(int f, int l, int w, int m) {
  Arch a;
  Tile t;
  return tile_of(&a, &t, f, l, w, m, true, true) ? stash_floats(a, t) : -1;
}

extern "C" int emu_packed(int f, int l, int w, int m) {
  Arch a;
  Tile t;
  if (!make_arch(&a, f, l, w, m)) return -1;
  make_layout(&t, a);
  return 2 * t.boff[a.n_hidden + 1];
}

extern "C" int emu_pack(const float* w, float* out, int f, int l, int wd,
                        int m) {
  Arch a;
  Tile t;
  if (!make_arch(&a, f, l, wd, m)) return 1;
  make_layout(&t, a);
  const int n = t.boff[a.n_hidden + 1];
  blockDim.x = kThreads;
  for (int b = 0; b < (n + kThreads - 1) / kThreads; ++b) {
    blockIdx.x = b;
    for (int i = 0; i < kThreads; ++i) {
      threadIdx.x = i;
      sdf_generic_pack_tf32_kernel(w, reinterpret_cast<float2*>(out), a, t);
    }
  }
  return 0;
}

extern "C" int emu_fwd(const float* p, const float* w, const float* bi,
                       float* sdf, float* feat, float* grad, int B, int N,
                       int f, int l, int wd, int m, int compute_grad,
                       int sym) {
  Arch a;
  Tile t;
  if (!tile_of(&a, &t, f, l, wd, m, compute_grad, false)) return 1;
  const float2* w2 = reinterpret_cast<const float2*>(w);
  const bool ok = run_grid(
      B * ((N + t.points - 1) / t.points),
      [&] {
        if (compute_grad)
          sdf_generic_fwd_tf32_kernel<true>(p, w2, bi, sdf, feat, grad, N,
                                            sym, a, t);
        else
          sdf_generic_fwd_tf32_kernel<false>(p, w2, bi, sdf, feat, grad, N,
                                             sym, a, t);
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
  Tile t;
  if (!tile_of(&a, &t, f, l, wd, m, true, true)) return 1;
  const float2* w2 = reinterpret_cast<const float2*>(w);
  const bool ok = run_grid(
      grid,
      [&] {
        sdf_generic_bwd_tf32_kernel(p, w2, bi, sbar, fbar, gbar, dpoints,
                                    partials, stash, B, N, sym, a, t);
      },
      smem, sizeof(smem));
  const size_t n = (size_t)a.num_weights + (size_t)B * a.bias_width;
  blockDim.x = 256;
  for (unsigned b = 0; b < (n + 255) / 256; ++b) {
    blockIdx.x = b;
    for (int i = 0; i < 256; ++i) {
      threadIdx.x = i;
      sum_partials_kernel(partials, out, n, grid);
    }
  }
  return ok ? 0 : 2;
}

// cvt.rna.tf32.f32 of each of x[0 .. n - 1] -> its bits
extern "C" void emu_tf32_rna(const float* x, uint32_t* out, int n) {
  for (int i = 0; i < n; ++i) out[i] = tf32_rna(x[i]);
}

// One warp: D = C + A B by one mma.sync m16n8k8 tf32 on the registers as
// given (A [16][8], B [8][8] as float32 bit patterns, C and D float32
// [16][8]), through the fragment layout.
extern "C" int emu_tf32_mma(const uint32_t* A, const uint32_t* B,
                            const float* C, float* Dout) {
  const bool ok = run_grid(
      1,
      [&] {
        const int lane = threadIdx.x;
        if (lane >= 32) return;
        const int g = lane / 4, t = lane % 4;
        const uint32_t a[4] = {A[g * 8 + t], A[(g + 8) * 8 + t],
                               A[g * 8 + t + 4], A[(g + 8) * 8 + t + 4]};
        float c[4];
        for (int j = 0; j < 4; ++j)
          c[j] = C[(g + 8 * (j >> 1)) * 8 + 2 * t + (j & 1)];
        mma1688(c, a, B[t * 8 + g], B[(t + 4) * 8 + g]);
        for (int j = 0; j < 4; ++j)
          Dout[(g + 8 * (j >> 1)) * 8 + 2 * t + (j & 1)] = c[j];
      },
      smem, sizeof(smem));
  return ok ? 0 : 2;
}

// One warp: D = A B for A [16][K] and B [K][8] float32 (K a multiple of 8)
// as the kernels form a product: A staged as float32 rows in shared memory
// and fetched by `load_a`, B's elements split as the pack splits them and
// taken in the order of a W chunk (k-step index 2t for the mma's t, 2t + 1
// for t + 4), summed by `mma3_tiles` (3xTF32; its tiles (m, 0)); with
// `hi_only` one mma1688 of the hi halves a step instead (plain TF32).
extern "C" int emu_tf32_dot(const float* A, const float* B, float* Dout,
                            int K, int hi_only) {
  const int ld = stride8(K);
  if (16 * ld * 4 > (int)sizeof(smem)) return 1;
  const bool ok = run_grid(
      1,
      [&] {
        const int lane = threadIdx.x;
        if (lane >= 32) return;
        if (lane == 0)
          for (int r = 0; r < 16; ++r)
            for (int k = 0; k < K; ++k) smem[r * ld + k] = A[r * K + k];
        __syncwarp();
        const int g = lane / 4, t = lane % 4;
        float acc[2][kNT][4] = {};
        for (int k0 = 0; k0 < K; k0 += 8) {
          uint32_t ah[2][4], al[2][4], bh[kNT][2] = {}, bl[kNT][2] = {};
          for (int m = 0; m < 2; ++m)
            load_a(ah[m], al[m], smem + k0, ld, lane);
          split(B[(k0 + 2 * t) * 8 + g], bh[0][0], bl[0][0]);
          split(B[(k0 + 2 * t + 1) * 8 + g], bh[0][1], bl[0][1]);
          if (hi_only)
            mma1688(acc[0][0], ah[0], bh[0][0], bh[0][1]);
          else
            mma3_tiles(acc, ah, al, bh, bl, 1);
        }
        for (int j = 0; j < 4; ++j)
          Dout[(g + 8 * (j >> 1)) * 8 + 2 * t + (j & 1)] = acc[0][0][j];
      },
      smem, sizeof(smem));
  return ok ? 0 : 2;
}
