// Fused SDF-MLP backward with bf16 products (K2-bf16) on Hopper's tensor
// cores (sm_90a): the hand-derived VJP of the bf16 forward with tangents
// (`fused_sdf_fwd.cu`, `fused_sdf_fwd_bf16_kernel<true>`).
//
// Replaces the Pallas TPU kernel `shapeclipper_tpu/ops/fused_sdf.py::
// _backward_call` (the `pl.pallas_call` at line 617) with
// `_mm_cast("bfloat16")`: every product -- the recomputed H W, the input
// cotangents C W^T and the weight gradients H^T C -- rounds both operands to
// bfloat16 (nearest even) and sums in float32; everything elementwise (bias,
// activation, sigma'' = 100 s (1 - s), the tangents' scaling, the posenc
// backward, the bias gradients) stays float32. `fused_sdf_bwd.cu` holds the
// float32 K2, the C entry point that launches either, and the kernel that
// sums the per-block partials.
//
// What it computes: as K2. Given the cotangents of the forward's outputs
// (sdf [B,N], feature [B,N,64], point gradient [B,N,3]) it returns
// d(weights) [28,032] (packed, flax [in][out]), d(biases) [B,385] and
// d(points) [B,N,3]. The rounding points are those of the plain version
// (`ops/fused_sdf.py::_CastProduct`): H, R and the cotangents are rounded
// where they become product operands; the primal rows' float32 cotangents
// feed the bias gradients (the output bias's is the unrounded sum of
// [sbar | fbar]); the posenc backward reads float32 pe and dpe.
//
// What bounds it on this card: with the products at the bf16 tensor-core
// rate (989 TFLOP/s dense), the elementwise work at the fp32 rate and the
// shared-memory path that feeds mma.sync from ldmatrix (128 bytes a clock an
// SM; an x4 load is 512 bytes for four or fewer m16n8k16 products). In
// practice latency: 8 warps an SM at 236 registers, a dependent chain of
// products, activations and barriers per layer (PERF.md, segment cycles).
//
// The design: 8 warps a block, one persistent block per SM, a tile of 64
// points = 256 rows that never spans two batch rows. Products are
// `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32`.
//   * A warp owns 8 points as two m16 tiles, [primal; t_x] and [t_y; t_z]
//     (row g and g + 8 of each), as in the forward: thread (g = lane / 4,
//     t = lane % 4) holds point g's four rows at the same 16 columns of a
//     layer, so the activation and its backward, which need the primal row's
//     sigmoid for the tangent rows, stay in the thread; the accumulator of
//     n8 tiles 2 kk, 2 kk + 1 is, packed to bf16, the A fragment of k16 step
//     kk of the next product.
//   * One bf16 copy of the weights in shared memory, each matrix [in][out]
//     row-major with 72-element (144-byte) rows, serves both orientations:
//     ldmatrix.trans gives W's B fragments (the forward), plain ldmatrix
//     W^T's (C W^T).
//   * H^T C contracts over the tile's 256 rows: each warp stages its rows
//     of H (bf16) and C (bf16) in shared memory, [row][72], and after a
//     barrier every warp reads them back with ldmatrix.trans as the A
//     fragments of H^T and the B fragments of C, for a fixed 16 x 32 slice of
//     the 64 x 64 gradient (16 k16 steps). The slice is added into this
//     block's [28,032] partial (L2-resident) by the thread that owns it:
//     one read-modify-write per weight per 64 points.
//   * The forward runs once a tile, layers 0-4, each layer's H staged in
//     this warp's rows of two shared buffers in turn (the next layer reads
//     its A fragments back with ldmatrix; H_3 and H_4 stay there for the
//     output layer's and layer 4's weight gradients); layer 4's rows stay in
//     registers. Layers 0-3 go to a per-warp stash in device memory (L2):
//     the float32 rows as the accumulator holds them (sigma in place of
//     the primal), and the bf16 activations, 288 bytes a thread and layer,
//     [layer][word][lane] so each access is one coalesced 512-byte row. The
//     sweep's step l reads layer l's rows back and rebuilds H_{l-1} from
//     layer l-1's (the same products t s, the same rounding): bitwise the
//     forward's, without running it again. The forward's k16 steps add into
//     float32 (`mma_rn`): their pre-activations feed sigma(100 z).
//   * The posenc rows R (39 features padded to 48, [pe; dpe masked by
//     coordinate], no |x| sign: the sign goes onto grad_bar_x and x_bar_x)
//     are staged once a tile [row][56] and read by ldmatrix as the A
//     fragments of the skip layers and as R^T for their weight gradients;
//     each thread's features' float32 pe and dpe wait in shared memory for
//     the posenc backward, C_R = C W_pe^T folded into x_bar per layer.
//   * The output layer's tangent rows carry grad_bar in the sdf column only,
//     so the [t_y; t_z] tile takes one k16 step of C W_5^T; everything else
//     is dense.
// Bias gradients: each warp sums its 8 points' float32 primal cotangents by
// a fixed butterfly, and one fixed thread a column adds the 8 warps' sums, in
// warp order, into the block's [B,385] partial.
//
// Registers. ptxas puts this kernel at 236 a thread with no spills; values
// that hold a lane-dependent address or constant through the tile loop are
// read where used (`lane_id`), or dozens of them stay live and spill.
//
// Barriers a tile: 2 a sweep step (the staged H and C complete; their reads
// done) = 12.
//
// Determinism: fixed tile-to-block assignment, fixed orders inside a block,
// per-block partials summed in block order by `reduce_partials_kernel`
// (fused_sdf_bwd.cu). No atomics: two launches are bitwise equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWidth = 64;
constexpr int kFreqs = 6;
constexpr int kPe = 3 + 6 * kFreqs;          // 39
constexpr int kOut = kWidth + 1;             // 65
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kPoints = 8 * kWarps;          // points a tile, 8 a warp
constexpr int kRows = 4 * kPoints;           // rows a tile

// packed global layout (as fused_sdf_fwd.cu): K0 [39][64] | K1h [64][64] |
// K1pe [39][64] | K2h | K2pe | K3 | K4 [64][64] | K5 [64][65]
constexpr int kOffK0 = 0;
constexpr int kOffK1h = kOffK0 + kPe * kWidth;
constexpr int kOffK1pe = kOffK1h + kWidth * kWidth;
constexpr int kOffK2h = kOffK1pe + kPe * kWidth;
constexpr int kOffK2pe = kOffK2h + kWidth * kWidth;
constexpr int kOffK3 = kOffK2pe + kPe * kWidth;
constexpr int kOffK4 = kOffK3 + kWidth * kWidth;
constexpr int kOffK5 = kOffK4 + kWidth * kWidth;
constexpr int kNumWeights = kOffK5 + kWidth * kOut;   // 28,032
constexpr int kBiasStride = 5 * kWidth + kOut;        // 385

// Shared memory, in bf16 elements. Row strides of 144 and 112 bytes put the
// 8 rows an ldmatrix phase reads (16 bytes each) on 8 distinct 4-bank
// groups (36 and 28 words: 4 r and -4 r mod 32).
constexpr int kLd = 72;      // weights, H and C
constexpr int kLdR = 56;     // posenc rows
// first row of each weight matrix, its rows padded to a multiple of 16
constexpr int kRowK0 = 0;
constexpr int kRowK1h = kRowK0 + 48;
constexpr int kRowK1pe = kRowK1h + kWidth;
constexpr int kRowK2h = kRowK1pe + 48;
constexpr int kRowK2pe = kRowK2h + kWidth;
constexpr int kRowK3 = kRowK2pe + 48;
constexpr int kRowK4 = kRowK3 + kWidth;
constexpr int kRowK5 = kRowK4 + kWidth;
constexpr int kWRows = kRowK5 + kWidth;               // 464
constexpr int kSmH0 = kWRows * kLd;                   // H [256][72] x 2
constexpr int kSmH1 = kSmH0 + kRows * kLd;
constexpr int kSmC = kSmH1 + kRows * kLd;             // C [256][72]
constexpr int kSmR = kSmC + kRows * kLd;              // R [256][56]
constexpr int kSmHalves = kSmR + kRows * kLdR;
constexpr int kBiasLd = 72;                           // float [8][72]
// each thread's float32 (pe, dpe) of its features 8 jj + 2 t + e, jj < 5
// (features 40-47 are padding): float2 [10][256]
constexpr int kPeSlots = 10;
constexpr int kSmPe = 2 * kSmHalves + 4 * kWarps * kBiasLd;      // bytes
// each thread's x_bar partial sums: float [3][256]
constexpr int kSmXb = kSmPe + 8 * kPeSlots * kThreads;
constexpr int kSmBytes = kSmXb + 4 * 3 * kThreads;                // 231,936

static_assert(kSmH0 % 8 == 0 && kSmH1 % 8 == 0 && kSmC % 8 == 0 &&
              kSmR % 8 == 0 && kSmHalves % 8 == 0, "16-byte aligned rows");
static_assert(kSmBytes <= 232448, "fits the 227 KB of a block");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The lane, read where a shared-memory address is formed: the compiler may
// not hoist it, so the dozens of per-lane ldmatrix addresses of the
// unrolled products are not kept live (and spilled) across the tile loop.
__device__ __forceinline__ int lane_id() {
  int lane;
  asm volatile("mov.u32 %0, %%laneid;\n" : "=r"(lane));
  return lane;
}

// ldmatrix: matrix i of an .x4 (.x2) takes its 8 row addresses from lanes
// 8 i .. 8 i + 7; lane (g, t) receives row g, columns 2 t and 2 t + 1, or
// with .trans rows 2 t and 2 t + 1 of column g.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a) : "memory");
}

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, "
               "%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a) : "memory");
}

__device__ __forceinline__ void ldsm2(uint32_t (&r)[2], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(a) : "memory");
}

__device__ __forceinline__ void ldsm2t(uint32_t (&r)[2], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, "
               "[%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(a) : "memory");
}

// c += A (16 x 16, row) x B (16 x 8, col); A: a0 (row g, cols 2t..),
// a1 (row g + 8), a2 (row g, cols 2t + 8..), a3; B: b0 (rows 2t.., col g),
// b1 (rows 2t + 8..); c: c0, c1 (row g, cols 2t..), c2, c3 (row g + 8).
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += A x B with the k16 step's sum from the tensor core and its add into
// c in float32, rounded to nearest. The forward's products take it: the
// tensor core's own accumulation of a chain of k16 steps rounds its sums
// differently from float32 adds, and the pre-activations it makes are
// amplified 25x by sigma(100 z); with these adds the backward lies ~13%
// nearer the plain version's over five draws (PERF.md).
__device__ __forceinline__ void mma_rn(float (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma(d, a, b0, b1);
#pragma unroll
  for (int r = 0; r < 4; ++r) c[r] += d[r];
}

// Two floats rounded to bf16 (nearest even), the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Posenc feature j of a point at x (x[0] already |x0|): its value and its
// derivative along its own coordinate j % 3; 0 past 39.
__device__ __forceinline__ void posenc_feature(int j, const float (&x)[3],
                                               float& pe, float& dpe) {
  // j is lane-dependent: select the coordinate rather than index x
  const int d = j % 3;
  const float xd = d == 0 ? x[0] : d == 1 ? x[1] : x[2];
  if (j < 3) {
    pe = xd;
    dpe = 1.f;
  } else if (j < kPe) {
    const int q = j - 3, k = q / 6, r = q % 6;
    const float f = (float)(1 << k);
    float s, c;
    sincosf(xd * f, &s, &c);
    pe = r < 3 ? s : c;
    dpe = r < 3 ? f * c : -f * s;
  } else {
    pe = 0.f;
    dpe = 0.f;
  }
}

// Address of this lane's row for the A fragment of rows rb + 16 m .. + 15,
// columns c0 .. c0 + 15 of a [row][ld] bf16 buffer (plain ldmatrix.x4).
__device__ __forceinline__ uint32_t a_addr(uint32_t base, int ld, int row0,
                                           int c0, int lane) {
  const int row = row0 + ((lane >> 3) & 1) * 8 + (lane & 7);
  return base + 2 * (row * ld + c0 + (lane >> 4) * 8);
}

// acc += A W[wrow ..] over kSteps k16 steps for this warp's rows: A (the
// previous layer's H, or the posenc rows R) staged [row][lda], its A
// fragments by plain ldmatrix, W's B fragments by ldmatrix.trans, two n8
// tiles a load; each step's sums added into acc in float32 (`mma_rn`).
template <int kSteps>
__device__ __forceinline__ void product_staged(float (&acc)[2][8][4],
                                               uint32_t sA, int lda,
                                               uint32_t sW, int wrow,
                                               int rb) {
  const int lane = lane_id();
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    uint32_t a[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
      ldsm4(a[m], a_addr(sA, lda, rb + 16 * m, 16 * kk, lane));
    const uint32_t row = sW + 2 * ((wrow + 16 * kk + ((lane >> 3) & 1) * 8 +
                                    (lane & 7)) * kLd + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldsm4t(b, row + 2 * 16 * np);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        mma_rn(acc[m][2 * np], a[m], b[0], b[1]);
        mma_rn(acc[m][2 * np + 1], a[m], b[2], b[3]);
      }
    }
  }
}

// acc[m][N tile] += C[rows][n] W[wrow + k][n] over n (the input cotangent
// C W^T): C's A fragments from this warp's rows of the staged C, W^T's B
// fragments by plain ldmatrix, kNT n8 tiles of k (W's rows). kOutLayer: n
// runs over the output layer's 65 columns (5 k16 steps, the last one's
// upper half zero), and the [t_y; t_z] tile, zero past column 0, takes the
// first step only.
template <int kNT, bool kOutLayer>
__device__ __forceinline__ void product_t(float (&acc)[2][kNT][4],
                                          uint32_t sC, uint32_t sW, int wrow,
                                          int rb) {
  const int lane = lane_id();
  constexpr int kSteps = kOutLayer ? 5 : 4;
#pragma unroll 1   // unrolled, it spills (ptxas)
  for (int kk = 0; kk < kSteps; ++kk) {
    const bool tail = kOutLayer && kk == 4;
    constexpr int kM = 2;
    uint32_t a[kM][4];
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      if (kOutLayer && m == 1 && kk > 0) continue;
      if (tail) {
        uint32_t h[2];
        ldsm2(h, a_addr(sC, kLd, rb + 16 * m, 64, lane));
        a[m][0] = h[0];
        a[m][1] = h[1];
        a[m][2] = 0u;
        a[m][3] = 0u;
      } else {
        ldsm4(a[m], a_addr(sC, kLd, rb + 16 * m, 16 * kk, lane));
      }
    }
#pragma unroll
    for (int np = 0; np < kNT / 2; ++np) {
      uint32_t b[4];
      if (tail) {
        uint32_t h[2];
        ldsm2(h, sW + 2 * ((wrow + 16 * np + ((lane >> 3) & 1) * 8 +
                            (lane & 7)) * kLd + 64));
        b[0] = h[0];
        b[1] = 0u;
        b[2] = h[1];
        b[3] = 0u;
      } else {
        ldsm4(b, sW + 2 * ((wrow + 16 * np + (lane >> 4) * 8 + (lane & 7)) *
                               kLd + 16 * kk + ((lane >> 3) & 1) * 8));
      }
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        if (kOutLayer && m == 1 && kk > 0) continue;
        mma(acc[m][2 * np], a[m], b[0], b[1]);
        mma(acc[m][2 * np + 1], a[m], b[2], b[3]);
      }
    }
  }
}

// This warp's rows of a layer, as A-fragment registers [m][kk][4], into a
// [row][72] buffer (reg 2 h + e is row g + 8 e, columns 16 kk + 8 h + 2 t..).
__device__ __forceinline__ void stage(const uint32_t (&h)[2][4][4],
                                      __nv_bfloat16* buf, int rb, int g,
                                      int t) {
  uint32_t* w = reinterpret_cast<uint32_t*>(buf);
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = rb + 16 * m + g + 8 * (r & 1);
        w[row * (kLd / 2) + 8 * kk + 4 * (r >> 1) + t] = h[m][kk][r];
      }
    }
  }
}

// This warp's stash: per hidden layer 0-3 and thread, 18 words of 16 bytes,
// [layer][word][lane] so that every access is a coalesced 512-byte row:
// words 0-15 the layer's float32 rows as the accumulator holds them
// (`cur`: the primal entries their sigmoid, the tangent rows raw), words 16
// and 17 the bf16 activations (the primal row of H).
constexpr int kStashWords = 18;
constexpr int kStashLayers = 4;
constexpr int kStashFloats = kWarps * kStashLayers * kStashWords * 32 * 4;

__device__ __forceinline__ void stash_store(uint4* __restrict__ st, int l,
                                            const float (&cur)[2][8][4],
                                            const uint32_t (&act)[8]) {
  uint4* p = st + l * kStashWords * 32;
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const float* v = cur[q / 8][q % 8];
    p[q * 32] = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                           __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
  p[16 * 32] = make_uint4(act[0], act[1], act[2], act[3]);
  p[17 * 32] = make_uint4(act[4], act[5], act[6], act[7]);
}

// cur of layer l from the stash.
__device__ __forceinline__ void stash_load(const uint4* __restrict__ st,
                                           int l, float (&cur)[2][8][4]) {
  const uint4* p = st + l * kStashWords * 32;
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const uint4 v = p[q * 32];
    float* c = cur[q / 8][q % 8];
    c[0] = __uint_as_float(v.x);
    c[1] = __uint_as_float(v.y);
    c[2] = __uint_as_float(v.z);
    c[3] = __uint_as_float(v.w);
  }
}

// H of layer l from the stash, as the forward built it (the same products
// t s, rounded the same way), staged into `buf`.
__device__ __forceinline__ void stash_stage_h(const uint4* __restrict__ st,
                                              int l, __nv_bfloat16* buf,
                                              int rb, int g, int t) {
  float v[2][8][4];
  stash_load(st, l, v);
  const uint4* p = st + l * kStashWords * 32;
  const uint4 a0 = p[16 * 32], a1 = p[17 * 32];
  const uint32_t act[4][2] = {{a0.x, a0.y}, {a0.z, a0.w}, {a1.x, a1.y},
                              {a1.z, a1.w}};
  uint32_t h[2][4][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float s0 = v[0][j][0], s1 = v[0][j][1];
    h[0][j / 2][2 * (j & 1)] = act[j / 2][j & 1];
    h[0][j / 2][2 * (j & 1) + 1] =
        pack_bf16(v[0][j][2] * s0, v[0][j][3] * s1);
    h[1][j / 2][2 * (j & 1)] = pack_bf16(v[1][j][0] * s0, v[1][j][1] * s1);
    h[1][j / 2][2 * (j & 1) + 1] =
        pack_bf16(v[1][j][2] * s0, v[1][j][3] * s1);
  }
  stage(h, buf, rb, g, t);
}

// The forward of hidden layers 0-4 for this warp's 8 points, once a tile.
// cur: layer 4's pre-activation rows (the accumulator layout: [0][j][e]
// primal, [0][j][2+e] t_x, [1][j][e] t_y, [1][j][2+e] t_z at column
// 8 j + 2 t + e) with the primal entries replaced by their sigmoid; layers
// 0-3 go to the stash the same way, with their activations. Each layer's H
// goes to this warp's rows of h_even (layers 0, 2, 4) or h_odd (1, 3),
// where the next layer reads it back; H_3 and H_4 stay there.
__device__ __forceinline__ void forward(float (&cur)[2][8][4],
                                        __nv_bfloat16* h_even,
                                        __nv_bfloat16* h_odd,
                                        uint4* __restrict__ st, uint32_t sW,
                                        uint32_t sR,
                                        const float* __restrict__ bias,
                                        int rb) {
  const int lane = lane_id();
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int l = 0; l < 5; ++l) {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int r = 0; r < 4; ++r) cur[m][j][r] = 0.f;
      }
    }
    if (l > 0) {
      const int wrow = l == 1 ? kRowK1h : l == 2 ? kRowK2h
                       : l == 3 ? kRowK3 : kRowK4;
      product_staged<4>(cur, smem_u32(l % 2 ? h_even : h_odd), kLd, sW,
                        wrow, rb);
    }
    if (l < 3) {
      const int wrow = l == 0 ? kRowK0 : l == 1 ? kRowK1pe : kRowK2pe;
      product_staged<3>(cur, sR, kLdR, sW, wrow, rb);
    }
    const float* bl = bias + l * kWidth;
    uint32_t* hout = reinterpret_cast<uint32_t*>(l % 2 ? h_odd : h_even);
    uint32_t act[8];
    __syncwarp();   // this warp's reads of the previous layer's H are done
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float o[2][4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // sigma in float32 as the JAX kernel (it feeds the float32
        // backward); softplus only ever feeds a bf16 operand
        const float z = 100.f * (cur[0][j][e] + __ldg(bl + 8 * j + 2 * t + e));
        const float ex = expf(-fabsf(z));
        const float inv = 1.f / (1.f + ex);
        const float s = z >= 0.f ? inv : 1.f - inv;
        o[0][e] = (fmaxf(z, 0.f) + __logf(1.f + ex)) * 0.01f;
        o[0][2 + e] = cur[0][j][2 + e] * s;
        o[1][e] = cur[1][j][e] * s;
        o[1][2 + e] = cur[1][j][2 + e] * s;
        cur[0][j][e] = s;
      }
      // H: rows g and g + 8 of each m16 tile, columns 8 j + 2 t ..
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const uint32_t lo = pack_bf16(o[m][0], o[m][1]);
        const uint32_t hi = pack_bf16(o[m][2], o[m][3]);
        hout[(rb + 16 * m + g) * (kLd / 2) + 4 * j + t] = lo;
        hout[(rb + 16 * m + g + 8) * (kLd / 2) + 4 * j + t] = hi;
        if (m == 0) act[j] = lo;
      }
    }
    if (l < 4) stash_store(st, l, cur, act);
    __syncwarp();   // H of this layer complete for the next one's reads
  }
}

// One fixed slice of a weight gradient over the tile's 256 rows:
// dW[k][n] += sum_r A[r][k] C[r][n] for k in m0 .. m0 + 16 kM, n in
// n0 .. n0 + 8 kN, A ([row][lda]) and C ([row][kLd]) staged bf16, both read
// by ldmatrix.trans (as H^T's A and C's B fragments); added into the
// packed [kin][nout] matrix at dst (this block's partial), entries past
// kin / nout (the padding) dropped. The thread owning an entry is fixed.
template <int kM, int kN>
__device__ __forceinline__ void weight_grad(uint32_t sA, int lda, int m0,
                                            uint32_t sC, int n0,
                                            float* __restrict__ dst, int kin,
                                            int nout) {
  const int lane = lane_id();
  const int g = lane >> 2, t = lane & 3;
  float prev[kM][kN][4], acc[kM][kN][4];
#pragma unroll
  for (int mi = 0; mi < kM; ++mi) {
#pragma unroll
    for (int ni = 0; ni < kN; ++ni) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int k = m0 + 16 * mi + g + 8 * (r >> 1);
        const int n = n0 + 8 * ni + 2 * t + (r & 1);
        prev[mi][ni][r] = (k < kin && n < nout) ? dst[k * nout + n] : 0.f;
        acc[mi][ni][r] = 0.f;
      }
    }
  }
  // lane rows: A^T's x4 (rows r0 + 8 (i >> 1), columns + 8 (i & 1)); C's x4
  // (rows r0 + 8 (i & 1), columns + 8 (i >> 1)); C's x2 (rows r0 + 8 i)
  const int i = lane >> 3;
  const uint32_t pa = sA + 2 * (((i >> 1) * 8 + (lane & 7)) * lda + m0 +
                                (i & 1) * 8);
  const uint32_t pc4 = sC + 2 * (((i & 1) * 8 + (lane & 7)) * kLd + n0 +
                                 (i >> 1) * 8);
  const uint32_t pc2 = sC + 2 * (((i & 1) * 8 + (lane & 7)) * kLd + n0);
#pragma unroll 1   // unrolled, it spills (ptxas)
  for (int r0 = 0; r0 < kRows; r0 += 16) {
    uint32_t a[kM][4];
#pragma unroll
    for (int mi = 0; mi < kM; ++mi)
      ldsm4t(a[mi], pa + 2 * (r0 * lda + 16 * mi));
#pragma unroll
    for (int np = 0; np < kN / 2; ++np) {
      uint32_t b[4];
      ldsm4t(b, pc4 + 2 * (r0 * kLd + 16 * np));
#pragma unroll
      for (int mi = 0; mi < kM; ++mi) {
        mma(acc[mi][2 * np], a[mi], b[0], b[1]);
        mma(acc[mi][2 * np + 1], a[mi], b[2], b[3]);
      }
    }
    if (kN % 2) {
      uint32_t b[2];
      ldsm2t(b, pc2 + 2 * (r0 * kLd + 8 * (kN - 1)));
#pragma unroll
      for (int mi = 0; mi < kM; ++mi)
        mma(acc[mi][kN - 1], a[mi], b[0], b[1]);
    }
  }
#pragma unroll
  for (int mi = 0; mi < kM; ++mi) {
#pragma unroll
    for (int ni = 0; ni < kN; ++ni) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int k = m0 + 16 * mi + g + 8 * (r >> 1);
        const int n = n0 + 8 * ni + 2 * t + (r & 1);
        if (k < kin && n < nout)
          dst[k * nout + n] = prev[mi][ni][r] + acc[mi][ni][r];
      }
    }
  }
}

// A 64 x 64 (or, with kOutLayer, 64 x 65) gradient from staged H and C:
// warp w owns rows 16 (w % 4) .. + 15 x columns 32 (w / 4) .. + 31, and for
// the output layer warps 0-3 also rows 16 w .. x column 64.
template <bool kOutLayer>
__device__ __forceinline__ void weight_grad_hidden(uint32_t sH, uint32_t sC,
                                                   float* dst, int warp) {
  constexpr int nout = kOutLayer ? kOut : kWidth;
  weight_grad<1, 4>(sH, kLd, 16 * (warp & 3), sC, 32 * (warp >> 2), dst,
                    kWidth, nout);
  if (kOutLayer && warp < 4)
    weight_grad<1, 1>(sH, kLd, 16 * warp, sC, 64, dst, kWidth, nout);
}

// A posenc kernel's gradient R^T C (39 x 64): warp w owns column tile w.
__device__ __forceinline__ void weight_grad_posenc(uint32_t sR, uint32_t sC,
                                                   float* dst, int warp) {
  weight_grad<3, 1>(sR, kLdR, 0, sC, 8 * warp, dst, kPe, kWidth);
}

// Sum of v over the warp's 8 points (lanes differing in g), by a fixed
// butterfly; every lane gets the sum of its column.
__device__ __forceinline__ float sum_points(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

__global__ void __launch_bounds__(kThreads, 1)
    fused_sdf_bwd_bf16_kernel(const float* __restrict__ points,
                              const __nv_bfloat16* __restrict__ weights,
                              const float* __restrict__ biases,
                              const float* __restrict__ sbar,
                              const float* __restrict__ fbar,
                              const float* __restrict__ gbar,
                              float* __restrict__ dpoints,
                              float* __restrict__ dk_partial,
                              float* __restrict__ db_partial,
                              uint4* __restrict__ stash, int B, int N,
                              int tiles_per_batch, int total_tiles,
                              int force_symmetry) {
  extern __shared__ __align__(16) uint4 smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sH0 = smem + kSmH0;
  __nv_bfloat16* sH1 = smem + kSmH1;
  __nv_bfloat16* sCp = smem + kSmC;
  __nv_bfloat16* sRp = smem + kSmR;
  float* sBias = reinterpret_cast<float*>(smem + kSmHalves);
  const uint32_t sW = smem_u32(smem);
  const uint32_t sC = smem_u32(sCp);
  const uint32_t sR = smem_u32(sRp);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int rb = 32 * warp;                // this warp's first row
  float2* sPe = reinterpret_cast<float2*>(
      reinterpret_cast<unsigned char*>(smem) + kSmPe) + tid;
  float* sXb = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(smem) + kSmXb) + tid;
  float* dkp = dk_partial + (size_t)blockIdx.x * kNumWeights;
  float* dbp = db_partial + (size_t)blockIdx.x * B * kBiasStride;
  uint4* st = stash + (size_t)blockIdx.x * (kStashFloats / 4) +
              warp * (kStashLayers * kStashWords * 32) + lane;

  // ---- the weights into shared memory ([in][72] per matrix, zero-padded),
  // this block's partials to zero
  {
    const unsigned short* w = reinterpret_cast<const unsigned short*>(weights);
    uint32_t* s32 = reinterpret_cast<uint32_t*>(smem);
    for (int i = tid; i < kWRows * kLd / 2; i += kThreads) {
      const int row = i / (kLd / 2), c = 2 * (i % (kLd / 2));
      // (first row, packed offset, rows) of the matrix holding `row`
      const int row0 = row >= kRowK5 ? kRowK5 : row >= kRowK4 ? kRowK4
                       : row >= kRowK3 ? kRowK3 : row >= kRowK2pe ? kRowK2pe
                       : row >= kRowK2h ? kRowK2h : row >= kRowK1pe ? kRowK1pe
                       : row >= kRowK1h ? kRowK1h : kRowK0;
      const int off = row0 == kRowK5 ? kOffK5 : row0 == kRowK4 ? kOffK4
                      : row0 == kRowK3 ? kOffK3 : row0 == kRowK2pe ? kOffK2pe
                      : row0 == kRowK2h ? kOffK2h : row0 == kRowK1pe ? kOffK1pe
                      : row0 == kRowK1h ? kOffK1h : kOffK0;
      const bool posenc = row0 == kRowK0 || row0 == kRowK1pe ||
                          row0 == kRowK2pe;
      const int k = row - row0;
      const int nout = row0 == kRowK5 ? kOut : kWidth;
      const bool in = k < (posenc ? kPe : kWidth);
      const int src = off + k * nout + c;
      const uint32_t lo = in && c < nout ? w[src] : 0u;
      const uint32_t hi = in && c + 1 < nout ? w[src + 1] : 0u;
      s32[i] = lo | (hi << 16);
    }
  }
  for (int i = tid; i < kNumWeights; i += kThreads) dkp[i] = 0.f;
  for (int i = tid; i < B * kBiasStride; i += kThreads) dbp[i] = 0.f;
  __syncthreads();

  const int t_begin = (int)((long long)total_tiles * blockIdx.x / gridDim.x);
  const int t_end =
      (int)((long long)total_tiles * (blockIdx.x + 1) / gridDim.x);
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int b = tile / tiles_per_batch;
    const int n = (tile % tiles_per_batch) * kPoints + 8 * warp + g;
    const bool valid = n < N;
    const size_t bn = (size_t)b * N + n;
    const float* bias_b = biases + (size_t)b * kBiasStride;
    float* dbp_b = dbp + (size_t)b * kBiasStride;

    // ---- this thread's point and its 12 posenc features j = 8 jj + 2 t + e:
    // R staged as bf16, (pe, dpe) kept in float32 for the posenc backward
    float x[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) x[d] = valid ? points[bn * 3 + d] : 0.f;
    const float sgn = (force_symmetry && x[0] < 0.f) ? -1.f : 1.f;
    if (force_symmetry) x[0] = fabsf(x[0]);
#pragma unroll
    for (int d = 0; d < 3; ++d) sXb[d * kThreads] = 0.f;
    {
      // the lane read here, not hoisted: the features' frequencies and
      // coordinates (12 of each a thread) would otherwise stay in registers
      // through the tile loop
      const int tl = lane_id() & 3;
      uint32_t* w = reinterpret_cast<uint32_t*>(sRp);
#pragma unroll
      for (int jj = 0; jj < 6; ++jj) {
        float v[4][2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 8 * jj + 2 * tl + e;
          float pe, dpe;
          posenc_feature(j, x, pe, dpe);
          if (jj < kPeSlots / 2)
            sPe[(2 * jj + e) * kThreads] = make_float2(pe, dpe);
          v[0][e] = pe;
#pragma unroll
          for (int d = 0; d < 3; ++d) v[1 + d][e] = j % 3 == d ? dpe : 0.f;
        }
        // rows: primal g, t_x 8 + g, t_y 16 + g, t_z 24 + g
#pragma unroll
        for (int q = 0; q < 4; ++q)
          w[(rb + 8 * q + g) * (kLdR / 2) + 4 * jj + tl] =
              pack_bf16(v[q][0], v[q][1]);
      }
    }
    __syncwarp();

    float cur[2][8][4];

    // ---- the forward (layers 0-3 to the stash, H_3 and H_4 staged, layer
    // 4 kept); the output layer's cotangents [sbar | fbar] and grad_bar in
    // the sdf column of the tangent rows as A fragments, staged
    forward(cur, sH0, sH1, st, sW, sR, bias_b, rb);
    {
      uint32_t c5[2][5][4];
      float cs[5][4];    // the primal row's float32 values at cols c(kk, r)
#pragma unroll
      for (int kk = 0; kk < 5; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int c = 16 * kk + 2 * t + (r & 1) + 8 * (r >> 1);
          cs[kk][r] = !valid ? 0.f : c == 0 ? sbar[bn]
                      : c <= kWidth ? fbar[bn * kWidth + c - 1] : 0.f;
        }
        const bool col0 = kk == 0 && t == 0;   // (r & 1) == 0, r >> 1 == 0
        const float gx = valid && col0 ? gbar[bn * 3] * sgn : 0.f;
        const float gy = valid && col0 ? gbar[bn * 3 + 1] : 0.f;
        const float gz = valid && col0 ? gbar[bn * 3 + 2] : 0.f;
        c5[0][kk][0] = pack_bf16(cs[kk][0], cs[kk][1]);
        c5[0][kk][1] = pack_bf16(gx, 0.f);
        c5[0][kk][2] = pack_bf16(cs[kk][2], cs[kk][3]);
        c5[0][kk][3] = 0u;
        c5[1][kk][0] = pack_bf16(gy, 0.f);
        c5[1][kk][1] = pack_bf16(gz, 0.f);
        c5[1][kk][2] = 0u;
        c5[1][kk][3] = 0u;
      }
      // columns 64 .. 79 of step 4: only 64 .. 71 are staged
      uint32_t* w = reinterpret_cast<uint32_t*>(sCp);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int kk = 0; kk < 5; ++kk) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            if (kk == 4 && r >= 2) continue;
            const int row = rb + 16 * m + g + 8 * (r & 1);
            w[row * (kLd / 2) + 8 * kk + 4 * (r >> 1) + t] = c5[m][kk][r];
          }
        }
      }
#pragma unroll
      for (int kk = 0; kk < 5; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int c = 16 * kk + 2 * t + (r & 1) + 8 * (r >> 1);
          const float v = sum_points(cs[kk][r]);
          if (g == 0 && c < kBiasLd) sBias[warp * kBiasLd + c] = v;
        }
      }
    }
    __syncthreads();
    if (tid < kOut) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += sBias[w * kBiasLd + tid];
      dbp_b[5 * kWidth + tid] += s;
    }
    weight_grad_hidden<true>(smem_u32(sH0), sC, dkp + kOffK5, warp);
    __syncthreads();

    // ---- hidden layers 4 .. 0: C_H = C_{l+1} W_{l+1}^T, the activation's
    // backward, the bias and posenc cotangents, the weight gradients
#pragma unroll 1
    for (int l = 4; l >= 0; --l) {
      if (l < 4) {
        // H_{l-1} staged and layer l's rows back from the stash
        if (l >= 1) stash_stage_h(st, l - 1, sH0, rb, g, t);
        stash_load(st, l, cur);
      }
      float ch[2][8][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int r = 0; r < 4; ++r) ch[m][j][r] = 0.f;
        }
      }
      if (l == 4) {
        product_t<8, true>(ch, sC, sW, kRowK5, rb);
      } else {
        const int wrow = l == 3 ? kRowK4 : l == 2 ? kRowK3
                         : l == 1 ? kRowK2h : kRowK1h;
        product_t<8, false>(ch, sC, sW, wrow, rb);
      }
      // C_prim = C_a s + (sum_d C_t,d t_d) 100 s (1 - s), C_t = C_t s
      uint32_t co[2][4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float s = cur[0][j][e];
          const float tx = cur[0][j][2 + e], ty = cur[1][j][e],
                      tz = cur[1][j][2 + e];
          const float cx = ch[0][j][2 + e], cy = ch[1][j][e],
                      cz = ch[1][j][2 + e];
          const float acc_t = cx * tx + cy * ty + cz * tz;
          ch[0][j][e] = ch[0][j][e] * s + acc_t * (100.f * s * (1.f - s));
          ch[0][j][2 + e] = cx * s;
          ch[1][j][e] = cy * s;
          ch[1][j][2 + e] = cz * s;
          const float v = sum_points(ch[0][j][e]);
          if (g == 0) sBias[warp * kBiasLd + 8 * j + 2 * t + e] = v;
        }
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          co[m][j / 2][2 * (j & 1)] = pack_bf16(ch[m][j][0], ch[m][j][1]);
          co[m][j / 2][2 * (j & 1) + 1] = pack_bf16(ch[m][j][2], ch[m][j][3]);
        }
      }
      __syncwarp();   // this warp's reads of the staged C are done
      stage(co, sCp, rb, g, t);
      if (l <= 2) {
        // C_R = C W_pe^T into x_bar: feature j of coordinate j % 3 adds
        // C_R[primal][j] dpe_j + C_R[t_{j % 3}][j] d2pe_j,
        // d2pe_j = -f_j^2 pe_j (0 for the raw coordinates)
        __syncwarp();
        float cr[2][6][4];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
#pragma unroll
          for (int jj = 0; jj < 6; ++jj) {
#pragma unroll
            for (int r = 0; r < 4; ++r) cr[m][jj][r] = 0.f;
          }
        }
        product_t<6, false>(cr, sC, sW,
                            l == 0 ? kRowK0 : l == 1 ? kRowK1pe : kRowK2pe,
                            rb);
        float xb[3] = {0.f, 0.f, 0.f};
        const int tl = lane_id() & 3;   // as in the posenc rows
#pragma unroll
        for (int jj = 0; jj < kPeSlots / 2; ++jj) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = 8 * jj + 2 * tl + e;
            const int d = j % 3;
            const float2 p = sPe[(2 * jj + e) * kThreads];   // (pe, dpe)
            const float tang = d == 0 ? cr[0][jj][2 + e]
                               : d == 1 ? cr[1][jj][e] : cr[1][jj][2 + e];
            const float f = (float)(1 << ((j < 3 ? 0 : j - 3) / 6));
            const float d2pe = j < 3 ? 0.f : -f * f * p.x;
            const float v = cr[0][jj][e] * p.y + tang * d2pe;
            xb[0] += d == 0 ? v : 0.f;
            xb[1] += d == 1 ? v : 0.f;
            xb[2] += d == 2 ? v : 0.f;
          }
        }
#pragma unroll
        for (int d = 0; d < 3; ++d) sXb[d * kThreads] += xb[d];
      }
      __syncthreads();
      if (tid < kWidth) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += sBias[w * kBiasLd + tid];
        dbp_b[l * kWidth + tid] += s;
      }
      if (l == 4) {
        weight_grad_hidden<false>(smem_u32(sH1), sC, dkp + kOffK4, warp);
      } else if (l == 3) {
        weight_grad_hidden<false>(smem_u32(sH0), sC, dkp + kOffK3, warp);
      } else if (l >= 1) {
        weight_grad_hidden<false>(smem_u32(sH0), sC,
                                  dkp + (l == 2 ? kOffK2h : kOffK1h), warp);
        weight_grad_posenc(sR, sC, dkp + (l == 2 ? kOffK2pe : kOffK1pe),
                           warp);
      } else {
        weight_grad_posenc(sR, sC, dkp + kOffK0, warp);
      }
      __syncthreads();
    }

    // ---- x_bar: the 4 lanes t of a point, by a fixed butterfly; the sign
    // of |x0| on x_bar_x
    float xb[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      xb[d] = sXb[d * kThreads];
      xb[d] += __shfl_xor_sync(0xffffffffu, xb[d], 1);
      xb[d] += __shfl_xor_sync(0xffffffffu, xb[d], 2);
    }
    if (t == 0 && valid) {
      // the sign of x0 read again rather than held through the sweep
      const float s0 = force_symmetry && points[bn * 3] < 0.f ? -1.f : 1.f;
      float* dst = dpoints + bn * 3;
      dst[0] = xb[0] * s0;
      dst[1] = xb[1];
      dst[2] = xb[2];
    }
  }
}

}  // namespace

// The bf16-product main kernel of `scl_fused_sdf_bwd` (fused_sdf_bwd.cu,
// which then launches the partials' sum): the same arguments, the stash
// [grid, scl_fused_sdf_bwd_bf16_stash_floats()] (16-byte aligned).
extern "C" int scl_fused_sdf_bwd_bf16_launch(
    const void* points, const void* weights, const void* biases,
    const void* sbar, const void* fbar, const void* gbar, void* dpoints,
    void* dk_partial, void* db_partial, void* stash, int B, int N, int grid,
    int force_symmetry, void* stream) {
  const int tiles_per_batch = (N + kPoints - 1) / kPoints;
  if ((long long)tiles_per_batch * B > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_sdf_bwd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmBytes);
  if (err != cudaSuccess) return (int)err;
  fused_sdf_bwd_bf16_kernel<<<grid, kThreads, kSmBytes,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points),
      static_cast<const __nv_bfloat16*>(weights),
      static_cast<const float*>(biases), static_cast<const float*>(sbar),
      static_cast<const float*>(fbar), static_cast<const float*>(gbar),
      static_cast<float*>(dpoints), static_cast<float*>(dk_partial),
      static_cast<float*>(db_partial), static_cast<uint4*>(stash), B, N,
      tiles_per_batch, tiles_per_batch * B, force_symmetry);
  return (int)cudaGetLastError();
}

// Points a tile of the bf16 kernel holds (the grid is capped at the tiles)
// and the floats of a block's stash.
extern "C" int scl_fused_sdf_bwd_bf16_tile_points() { return kPoints; }

extern "C" int scl_fused_sdf_bwd_bf16_stash_floats() { return kStashFloats; }
