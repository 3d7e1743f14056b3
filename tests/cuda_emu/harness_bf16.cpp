// Runs the device code of shapeclipper_torch/csrc/fused_sdf_generic_bf16.cu
// (copied above its C entry points into device_part_bf16.inc by the test)
// on the CPU with the warp emulation of harness.cpp, and checks that
// emulation through the fragment layouts. The entry points mirror the C
// entry points' launches without the stream.
#include "cuda_runtime.h"
#include "harness.h"

namespace {
alignas(16) float smem[1 << 17];
}
#include "device_part_bf16.inc"

static bool tile_of(Arch* a, Tile* t, int f, int l, int w, int m, bool grad,
                    bool backward) {
  return make_arch(a, f, l, w, m) && make_tile(t, *a, grad, backward) &&
         smem_bytes(*a, *t, backward) <= (int)sizeof(smem);
}

extern "C" int emu_bf16_tile_points(int f, int l, int w, int m, int grad,
                                    int backward) {
  Arch a;
  Tile t;
  return tile_of(&a, &t, f, l, w, m, grad || backward, backward) ? t.points
                                                                 : -1;
}

extern "C" int emu_bf16_stash_floats(int f, int l, int w, int m) {
  Arch a;
  Tile t;
  return tile_of(&a, &t, f, l, w, m, true, true) ? stash_floats(a, t) : -1;
}

extern "C" int emu_bf16_packed(int f, int l, int w, int m) {
  Arch a;
  Tile t;
  if (!make_arch(&a, f, l, w, m)) return -1;
  make_layout(&t, a);
  return t.boff[a.n_hidden + 1];
}

extern "C" int emu_bf16_pack(const float* w, uint16_t* out, int f, int l,
                             int wd, int m) {
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
      sdf_generic_pack_bf16_kernel(w, out, a, t);
    }
  }
  return 0;
}

extern "C" int emu_bf16_fwd(const float* p, const uint16_t* w,
                            const float* bi, float* sdf, float* feat,
                            float* grad, int B, int N, int f, int l, int wd,
                            int m, int compute_grad, int sym) {
  Arch a;
  Tile t;
  if (!tile_of(&a, &t, f, l, wd, m, compute_grad, false)) return 1;
  const bool ok = run_grid(
      B * ((N + t.points - 1) / t.points),
      [&] {
        if (compute_grad)
          sdf_generic_fwd_bf16_kernel<true>(p, w, bi, sdf, feat, grad, N, sym,
                                            a, t);
        else
          sdf_generic_fwd_bf16_kernel<false>(p, w, bi, sdf, feat, grad, N,
                                             sym, a, t);
      },
      smem, sizeof(smem));
  return ok ? 0 : 2;
}

extern "C" int emu_bf16_bwd(const float* p, const uint16_t* w,
                            const float* bi, const float* sbar,
                            const float* fbar, const float* gbar,
                            float* dpoints, float* out, float* partials,
                            float* stash, int B, int N, int grid, int f,
                            int l, int wd, int m, int sym) {
  Arch a;
  Tile t;
  if (!tile_of(&a, &t, f, l, wd, m, true, true)) return 1;
  const bool ok = run_grid(
      grid,
      [&] {
        sdf_generic_bwd_bf16_kernel(p, w, bi, sbar, fbar, gbar, dpoints,
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

// One warp: lane l gives row l of `rows` ([32][8] bf16 in shared memory) to
// ldmatrix .x{count} (.trans) and writes what it receives to out[l][0 ..
// count - 1].
extern "C" int emu_ldmatrix_rows(const uint16_t* rows, int count, int trans,
                                 uint32_t* out) {
  uint16_t* m = reinterpret_cast<uint16_t*>(smem);
  const bool ok = run_grid(
      1,
      [&] {
        const int lane = threadIdx.x;
        if (lane >= 32) return;
        if (lane == 0) std::memcpy(m, rows, 32 * 8 * 2);
        __syncwarp();
        uint32_t r[4] = {0, 0, 0, 0};
        emu_ldmatrix(r, m + 8 * lane, count, trans != 0);
        for (int i = 0; i < count; ++i) out[lane * 4 + i] = r[i];
      },
      smem, sizeof(smem));
  return ok ? 0 : 2;
}

// One warp: d = c + A B through the fragments the kernels use: A [16][16]
// and B [16][8] (bf16, row-major) staged in shared memory, A's fragment by
// ldmatrix.x4, B's by ldmatrix.x2.trans from B [k][n] (`b_from_rows` 0) or
// by plain ldmatrix.x2 from B^T [n][k] (1), then one mma.sync; c and d
// float32 [16][8] through the accumulator's layout.
extern "C" int emu_fragment_product(const uint16_t* A, const uint16_t* B,
                                    const float* C, float* Dout,
                                    int b_from_rows) {
  uint16_t* sa = reinterpret_cast<uint16_t*>(smem);  // [16][24]
  uint16_t* sb = sa + 16 * 24;                      // [16][16] or [8][24]
  const bool ok = run_grid(
      1,
      [&] {
        const int lane = threadIdx.x;
        if (lane >= 32) return;
        if (lane == 0) {
          for (int r = 0; r < 16; ++r)
            for (int k = 0; k < 16; ++k) sa[r * 24 + k] = A[r * 16 + k];
          for (int k = 0; k < 16; ++k)
            for (int n = 0; n < 8; ++n) {
              if (b_from_rows)
                sb[n * 24 + k] = B[k * 8 + n];
              else
                sb[k * 16 + n] = B[k * 8 + n];
            }
        }
        __syncwarp();
        uint32_t a[4], b[2];
        ldsm4(a, sa + (lane & 15) * 24 + (lane >> 4) * 8);
        if (b_from_rows)
          ldsm2(b, sb + (lane & 7) * 24 + ((lane >> 3) & 1) * 8);
        else
          ldsm2t(b, sb + (lane & 15) * 16);
        const int g = lane / 4, t = lane % 4;
        float c[4];
        for (int j = 0; j < 4; ++j)
          c[j] = C[(g + 8 * (j >> 1)) * 8 + 2 * t + (j & 1)];
        mma16816(c, a, b[0], b[1]);
        for (int j = 0; j < 4; ++j)
          Dout[(g + 8 * (j >> 1)) * 8 + 2 * t + (j & 1)] = c[j];
      },
      smem, sizeof(smem));
  return ok ? 0 : 2;
}
