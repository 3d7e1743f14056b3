// Runs the device code of shapeclipper_torch/csrc/fused_sdf_generic_bf16.cu
// (copied above its C entry points into device_part_bf16.inc by the test)
// on the CPU with the warp emulation of harness.cpp, and checks that
// emulation through the fragment layouts. The entry points mirror the C
// entry points' launches without the stream.
#include "cuda_runtime.h"
#include "harness.h"

namespace {
alignas(1024) float smem[1 << 17];
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
  return packed_elems(a, t);
}

// 1 where K8-bf16 (with tangents) takes the wgmma form, else 0
extern "C" int emu_bf16_wgmma_form(int f, int l, int w, int m) {
  Arch a;
  Tile t;
  WgTile wt;
  if (!make_arch(&a, f, l, w, m)) return -1;
  make_layout(&t, a);
  return make_wg(&wt, a, t) && wg_smem_bytes(wt) <= (int)sizeof(smem) ? 1
                                                                       : 0;
}

extern "C" int emu_bf16_pack(const float* w, uint16_t* out, int f, int l,
                             int wd, int m) {
  Arch a;
  Tile t;
  if (!make_arch(&a, f, l, wd, m)) return 1;
  make_layout(&t, a);
  const int n = packed_elems(a, t);
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
  Tile t{};
  WgTile wt;
  if (compute_grad && emu_bf16_wgmma_form(f, l, wd, m) == 1) {
    // the wgmma form: persistent blocks, three here so that each walks
    // several tiles
    make_arch(&a, f, l, wd, m);
    make_layout(&t, a);
    make_wg(&wt, a, t);
    const int tiles = B * ((N + kWgPoints - 1) / kWgPoints);
    const uint16_t* img = w + t.boff[a.n_hidden + 1];
    return run_grid(
               std::min(tiles, 3),
               [&] {
                 sdf_generic_fwd_bf16_kernel(p, img, bi, sdf, feat, grad, B,
                                             N, sym, a, t, wt);
               },
               smem, wg_smem_bytes(wt), kWgThreads)
               ? 0
               : 2;
  }
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

// sw_off(row, k) for rows x ks: the swizzled bf16 offsets the kernels
// store their operand rows at and the pack writes its chunk images at
extern "C" void emu_sw_off(int rows, int ks, int* out) {
  for (int r = 0; r < rows; ++r)
    for (int k = 0; k < ks; ++k) out[r * ks + k] = sw_off(r, k);
}

// One warpgroup: D = A B^T by `atoms` x 4 wgmma k-steps of 16 through the
// kernels' descriptors (`wg_desc`; + 512 an atom of A, + 2 a k-step), on
// the bf16 images as given: A [atoms][64][64] and B [atoms][n][64] (n 256
// or 16), each atom K-major under the 128-byte swizzle; D float32 [64][n]
// written back through the accumulator layout; `late` 1 reads D before
// the wait instead (what a missing wait would see).
extern "C" int emu_wgmma_product(const uint16_t* A, const uint16_t* Bi,
                                 int atoms, int n, float* D, int late) {
  char* base = reinterpret_cast<char*>(smem);
  uint16_t* sa = reinterpret_cast<uint16_t*>(base);
  uint16_t* sb = reinterpret_cast<uint16_t*>(base + atoms * 8192);
  const bool ok = run_grid(
      1,
      [&] {
        const int tw = threadIdx.x, w = tw / 32, lane = tw % 32;
        if (tw == 0) {
          std::memcpy(sa, A, atoms * 8192);
          std::memcpy(sb, Bi, (size_t)atoms * n * 128);
        }
        wg_bar(1);
        float d[128];
        for (float& x : d) x = -1.f;
        const uint64_t da = wg_desc(smem_u32(sa));
        for (int at = 0; at < atoms; ++at) {
          const uint64_t db = wg_desc(smem_u32(sb + (size_t)at * n * 64));
          for (int ks = 0; ks < 4; ++ks) {
            const int acc = at > 0 || ks > 0;
            if (n == 256)
              wgmma_n256(d, da + 512 * at + 2 * ks, db + 2 * ks, acc);
            else
              wgmma_n16(*reinterpret_cast<float(*)[8]>(d),
                        da + 512 * at + 2 * ks, db + 2 * ks, acc);
          }
        }
        wg_commit();
        float seen[128];
        std::memcpy(seen, d, sizeof(d));
        wg_wait<0>();
        if (!late) std::memcpy(seen, d, sizeof(d));
        const int g = lane / 4, t = lane % 4;
        for (int j = 0; j < n / 8; ++j)
          for (int i = 0; i < 4; ++i)
            D[(16 * w + g + 8 * (i / 2)) * n + 8 * j + 2 * t + i % 2] =
                seen[4 * j + i];
      },
      smem, sizeof(smem), 128);
  return ok ? 0 : 2;
}

// A ring of two buffers of `words` floats between one producer lane
// (thread 32) and a consumer warp (threads 0-31) over `rounds` rounds, as
// K8-bf16's wgmma form drives it: the producer waits for a buffer's empty
// barrier (parity flipped), expects its bytes on the full barrier and
// bulk-copies round r's words from src; each consumer lane reads word lane
// of the buffer before (`before` [rounds][32]; all lanes before any
// waits) and after (`after`) waiting on the full barrier, then arrives on
// the empty one (32 arrivals).
extern "C" int emu_mbar_ring(const float* src, int rounds, int words,
                             float* before, float* after) {
  float* buf = smem;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + 2 * words);
  const bool ok = run_grid(
      1,
      [&] {
        const int tid = threadIdx.x;
        if (tid == 0) {
          for (int s = 0; s < 2; ++s) {
            mbar_init(bars + s, 1);
            mbar_init(bars + 2 + s, 32);
          }
          mbar_fence_init();
        }
        __syncthreads();
        int stage = 0, phase = 0;
        for (int r = 0; r < rounds; ++r) {
          if (tid == 32) {
            mbar_wait(bars + 2 + stage, phase ^ 1);
            mbar_expect_tx(bars + stage, 4 * words);
            bulk_g2s(buf + stage * words, src + (size_t)r * words, 4 * words,
                     bars + stage);
          } else if (tid < 32) {
            before[r * 32 + tid] = buf[stage * words + tid];
            __syncwarp();  // every lane has read before any waits
            mbar_wait(bars + stage, phase);
            after[r * 32 + tid] = buf[stage * words + tid];
            mbar_arrive(bars + 2 + stage);
          }
          if (++stage == 2) {
            stage = 0;
            phase ^= 1;
          }
        }
      },
      smem, 2 * words * 4 + 64, 64);
  return ok ? 0 : 2;
}
