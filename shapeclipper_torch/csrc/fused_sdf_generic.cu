// Architecture-generic fused SDF-MLP pair for Hopper (sm_90a): K8, the
// forward with or without forward-mode point tangents, K9, its hand-derived
// VJP, and the pack of their weights, for every SDF MLP of
// `models/implicit.py::SDFNetwork` (weight_norm off) inside the envelope
// below, with float32-accurate products on the tensor cores (3xTF32). The
// flagship architecture (posenc 6, skips {1, 2}, 5 hidden x 64) keeps its
// tuned kernels, `fused_sdf_fwd.cu` (K1 / K3), `fused_sdf_bwd.cu` (K2) and
// `fused_sdf_bwd_bf16.cu` (K2-bf16); `ops/fused_sdf.py::sdf_route` sends
// every other architecture here.
//
// Replaces the Pallas TPU kernels `shapeclipper_tpu/ops/fused_sdf.py::
// _forward_call` (the `pl.pallas_call` at line 311) and `_backward_call`
// (line 617) under any `cfg = (n_freqs, skip_in, n_hidden, ...)` and any
// widths of their weights, with float32 products. Their bf16 forms
// (`_mm_cast("bfloat16")`) run in `fused_sdf_generic_bf16.cu`, built into
// the same library; the C entry points below dispatch on `mm_bf16`.
//
// The architecture arrives at run time (`Arch`): F frequencies (posenc
// width D = 3 + 6F), L hidden layers of width W, a bitmask of the skip
// layers, the output layer of width W + 1 ([sdf | feature]). Envelope:
// 1 <= W <= 512, 1 <= L <= 16, 0 <= F <= 16, skips in {1 .. L}. One build
// serves every architecture.
//
// What it computes. The weights are the packed layer kernels (flax [in][out]
// layout, `ops/fused_sdf.py::pack_fused_params`): layer l reads
// [h_(l-1) (W rows, l > 0); posenc (D rows, l = 0 or a skip layer)] -- the
// two kernels of a skip layer sit back to back, so each layer is one
// [K_l][N_l] matrix (the skip scale 1/sqrt(2) is folded in). The biases are
// per sample, [B, L W + W + 1], with the latent folded in. A point's rows
// are [primal; t_x; t_y; t_z] (with tangents) or [primal]; a hidden layer
// gives h = softplus(100 prim) / 100 on the primal row and t * sigma(100
// prim) on the tangent rows (`_act_pair`), the output layer sdf, feature
// and the point gradient (tangent rows' sdf column, |x0| sign applied).
// K9 takes the cotangents of (sdf, feature, gradient) and returns
// d(weights), d(biases) and d(points):
//   C_prim = D_a s + (sum_d D_t,d t_d) 100 s (1 - s),  C_tang = D_t s
// for the cotangent D of a hidden layer's output rows (s = sigma(100 prim),
// t_d the raw tangent rows), the posenc rows' cotangent reversed through
// dpe and d2pe, then the |x0| sign.
//
// The products. Every product is `mma.sync.aligned.m16n8k8.row.col.f32.
// tf32.tf32.f32` in three parts: each float32 operand x is split into
// hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi), and a b is summed as
// hi_a lo_b + lo_a hi_b + hi_a hi_b (the small terms first) in the float32
// accumulator, which keeps float32's precision where plain TF32 (10-bit
// operands) would break the forward's atol of 2e-5. The weights are split
// once a call by the pack (`sdf_generic_pack_tf32_kernel`: each layer a
// zero-padded [kp][np] matrix of (hi, lo) pairs, widths padded to multiples
// of 8); activation and cotangent rows stay float32 in shared memory and are
// split in registers as their fragments are loaded.
//
// What bounds it on this card: the products, 3 x the MLP's multiply-adds
// at the TF32 tensor-core rate (495 TFLOP/s dense; `mma.sync` reaches part
// of it), against K9's bytes: its float32 stash (16 bytes a point, hidden
// channel and layer, written once and read twice) and its weight-gradient
// partials (a float32 copy of every weight a block, read and written once
// a tile). The FMA bound (the products at 67 TFLOP/s) stands beside it.
//
// The design, the bf16 forms' tiling (`fused_sdf_generic_bf16.cu`) with
// float32 rows. 8 warps a block; a tile of R rows (R = 4 P with tangents, P
// without), R the largest of 128, 64, 32 whose buffers fit in shared memory
// (64 at width 256: two float32 row buffers at R = 128 would take 270 KB):
//   * Row-kind layout: warp row group rw holds 8 points as two m16 tiles,
//     [primal; t_x] and [t_y; t_z]; the thread (g = lane / 4, t = lane % 4)
//     then holds point g's four rows at the same columns, so the
//     activation, and its backward, which need the primal row's sigmoid for
//     the tangent rows, stay in the thread. Without tangents rows are points.
//   * Warps: R / 32 across the rows, the rest across the columns, 64
//     columns a warp (acc[2][8][4]); a pass covers 64 x 8 / (R / 32)
//     columns of a layer's output.
//   * Fragments. A tf32 fragment element is one 32-bit value (a0 = A[g][t],
//     a2 = A[g][t + 4], b0 = B[t][g], b1 = B[t + 4][g]), and ldmatrix moves
//     16-bit halves, so every fragment is fetched by plain shared loads. A
//     product's k-step of 8 takes reduction indices (2t, 2t + 1) for the
//     mma's (t, t + 4): a0 / a2 are then one 8-byte load of a row, and so
//     are a1 / a3; b0 / b1 of a W chunk ([kc][cs] (hi, lo) pairs) two 8-byte
//     loads, of a W^T chunk ([npass][kc], odd rows' 16-byte units swapped
//     in halves, `tswz`) one 16-byte load. The weight gradient H^T C reads
//     both operands down the rows, one float each, in the mma's own order.
//     Row strides are 8 mod 16 floats (activation, cotangent and posenc
//     rows) and cs 2 mod 4 pairs, so that none of these loads has a bank
//     conflict.
//   * A k-step's 48 mma are issued as every tile's first product, then
//     every tile's second, then third (`mma3_tiles`), with no branch
//     between them: a warp issues in order, and three products into one
//     accumulator back to back would each wait for the one before.
//   * Weights stream through shared memory in k-chunks of kc rows by
//     16-byte `cp.async`, in a ring of 3 buffers where they fit, else 2 (at
//     width 256 K8 2 x 32 rows, K9 2 x 16): the next chunks are in flight
//     while chunk i's products run, one barrier a chunk. Fewer, larger
//     chunks are faster here than more stages of smaller ones.
//   K8: one block a tile; layer by layer, pass by pass, the product, then
//       bias and activation into the other buffer -- or, where a layer is
//       one pass (width 256 at R = 64), into the same one after a barrier,
//       which frees a buffer's 68 KB for the 32-row chunks; the output layer
//       writes sdf, feature and gradient.
//   K9: persistent blocks. Per tile: the forward again, each hidden layer's
//       [prim; raw tangents] into the block's stash in the thread's own
//       order (each warp store one coalesced 512-byte row); then from the
//       output layer down: the weight gradient H^T C (`weight_grad`, added
//       into the block's float32 partial by the thread that owns each
//       entry, its old values copied into the idle chunk buffers by
//       cp.async before the products and added after), the input
//       cotangent C W_h^T with the activation backward from the stash
//       (prefetched into L2 a pass ahead, with the rows the rebuild reads;
//       its primal rows' sums, by a fixed butterfly and the row groups in
//       order, are the bias gradient), C W_pe^T into the posenc rows'
//       cotangent, H_(l-2) rebuilt from the stash (the forward's own
//       arithmetic, so bitwise its rows); the posenc's reverse; the points'
//       gradient. A second launch sums the blocks' partials in block order:
//       no atomics, two launches bitwise equal.
// Bytes at 24 x 32,768, 8 x 256 (R = 64, 16 points a tile): partials 2.18
// MB x 2 a tile x 49,152 tiles = 216 GB a launch (the bf16 form's 32-point
// tiles: 108 GB); stash 74 GB, as every form. Both counts are modelled
// (`chip_smoke.generic_traffic`). The weight gradient took 220 of K9's 529
// ms before its old values were staged by cp.async (PERF.md).

#include "fused_sdf_generic.cuh"

namespace {

constexpr int kWarps = kThreads / 32;
constexpr int kNT = 8;        // n-tiles of 8 columns a warp
constexpr int kWC = 8 * kNT;  // columns a warp

// ---------------------------------------------------------- fragment plumbing
// (warp-collective where it says so; tests/cuda_emu/ emulates the same
// functions on the CPU).
#ifndef SCL_EMULATED
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// x rounded to tf32 (10 mantissa bits, nearest, ties away from zero): its
// top 19 bits, the low 13 cleared (the instruction leaves them unspecified).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

// c += A (16 x 8, row) B (8 x 8, col), tf32 operands (the hardware reads
// the top 19 bits of each register): A: a0 (row g, column t), a1 (row
// g + 8, column t), a2 (row g, column t + 4), a3 (row g + 8, column t + 4);
// B: b0 (row t, column g), b1 (row t + 4); c: c0, c1 (row g, columns 2t,
// 2t + 1), c2, c3 (row g + 8). Warp-collective.
__device__ __forceinline__ void mma1688(float (&c)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes from global to shared memory, asynchronously; zeros when not
// `valid` (a source size of 0).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 or 8 bytes from global to shared memory, asynchronously (through L1).
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Asks L2 for the 128-byte line holding p; no register waits for it.
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}
#endif

// x = hi + lo: hi = x rounded to tf32, lo = the rest rounded to tf32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// acc[m][j] += A_m B_j for a warp's tiles m < 2, j < nj (kNT, or fewer at
// an edge of the output) from the operands' tf32 halves, the small products
// first:
// hi_a lo_b + lo_a hi_b + hi_a hi_b (3xTF32), every tile's first product,
// then every tile's second, then third: a warp issues its mma in order (the
// asm is volatile), so a product right after the one whose sum it takes
// would wait out that one's latency. Warp-collective.
__device__ __forceinline__ void mma3_tiles(float (&acc)[2][kNT][4],
                                           const uint32_t (&ah)[2][4],
                                           const uint32_t (&al)[2][4],
                                           const uint32_t (&bh)[kNT][2],
                                           const uint32_t (&bl)[kNT][2],
                                           int nj) {
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    if (j >= nj) break;
#pragma unroll
    for (int m = 0; m < 2; ++m) mma1688(acc[m][j], ah[m], bl[j][0], bl[j][1]);
  }
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    if (j >= nj) break;
#pragma unroll
    for (int m = 0; m < 2; ++m) mma1688(acc[m][j], al[m], bh[j][0], bh[j][1]);
  }
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    if (j >= nj) break;
#pragma unroll
    for (int m = 0; m < 2; ++m) mma1688(acc[m][j], ah[m], bh[j][0], bh[j][1]);
  }
}

// The A fragment of a k-step: rows 0 .. 15 of `a` ([row][ld] float32, at
// the step's first row and column), the mma's column t from column 2t and
// t + 4 from 2t + 1, split into tf32 halves. Two 8-byte loads a thread.
__device__ __forceinline__ void load_a(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                       const float* a, int ld, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float2 x = *reinterpret_cast<const float2*>(a + g * ld + 2 * t);
  const float2 y = *reinterpret_cast<const float2*>(a + (g + 8) * ld + 2 * t);
  split(x.x, hi[0], lo[0]);
  split(y.x, hi[1], lo[1]);
  split(x.y, hi[2], lo[2]);
  split(y.y, hi[3], lo[3]);
}

// The halves of a pack element, (hi, lo).
__device__ __forceinline__ uint32_t hi_of(float2 v) {
  return __float_as_uint(v.x);
}
__device__ __forceinline__ uint32_t lo_of(float2 v) {
  return __float_as_uint(v.y);
}

// ------------------------------------------------------------------ tiling
__host__ __device__ inline int round8(int x) { return (x + 7) & ~7; }

// A row stride of at least x floats (x a multiple of 8) that is 8 mod 16.
__host__ __device__ inline int stride8(int x) { return x | 8; }

struct Tile {
  int rows;       // R: 128, 64 or 32
  int points;     // P: R / 4 with tangents, R without
  int row_warps;  // R / 32: warps across the rows
  int npass;      // columns of a pass: kWC x (kWarps / row_warps)
  int kc;         // reduction rows of a weight chunk: 32, 16 or 8
  int stages;     // chunk buffers: 3 where they fit, else 2
  int cs;         // pair stride of a W chunk's rows: npass + 2 (a W^T
                  // chunk's is kc, `tswz`)
  int npass_shift, kc_shift;  // log2 of npass / 2 and of kc / 2
  int bufs;       // row buffers: K8 1 where a layer is one pass (written in
                  // place), else 2
  int wp, dp, op; // W, D and W + 1 rounded up to 8
  int lda;        // row stride (floats) of an activation / cotangent buffer
  int ldp;        // of the posenc rows
  int boff[kMaxHidden + 2];  // each layer's offset (pairs) in the pack
};

// Layer l of the pack: [kp_h + kp_pe][np] (hi, lo) pairs
__host__ __device__ inline int kp_h(const Tile& t, int l) {
  return l > 0 ? t.wp : 0;
}
__host__ __device__ inline int np_of(const Arch& a, const Tile& t, int l) {
  return l == a.n_hidden ? t.op : t.wp;
}

inline void make_layout(Tile* t, const Arch& a) {
  t->wp = round8(a.width);
  t->dp = round8(a.pe_dim);
  t->op = round8(a.width + 1);
  t->ldp = stride8(t->dp);
  int off = 0;
  for (int l = 0; l <= a.n_hidden; ++l) {
    t->boff[l] = off;
    off += (kp_h(*t, l) + (layer_pe(a, l) ? t->dp : 0)) * np_of(a, *t, l);
  }
  t->boff[a.n_hidden + 1] = off;
}

// pairs of one chunk buffer (K9 also stages W^T chunks)
__host__ __device__ inline int chunk_elems(const Tile& t, bool backward) {
  const int fwd = t.kc * t.cs, trans = t.npass * t.kc;
  return backward && trans > fwd ? trans : fwd;
}

// Pairs of the chunk buffers; in K9 at least the weight gradient's staging
// of the partial's old values (`weight_grad`: 32 pairs a thread), which
// uses them between products.
__host__ __device__ inline int chunk_area(const Tile& t, bool backward) {
  const int n = t.stages * chunk_elems(t, backward);
  return backward && n < 32 * kThreads ? 32 * kThreads : n;
}

// Shared memory of a block: `bufs` row buffers [R][lda] and the posenc rows
// [R][ldp] (float32), the chunks, the x0 signs; K9 also the posenc rows'
// cotangent [P][dp][2] and the bias gradient's row-group sums [R/32][op].
inline int smem_bytes(const Arch& a, const Tile& t, bool backward) {
  const int R = t.rows, P = t.points;
  int bytes = 4 * (t.bufs * R * t.lda + R * t.ldp) +
              8 * chunk_area(t, backward);
  bytes += 4 * P;
  if (backward) bytes += 4 * (2 * P * t.dp + t.row_warps * t.op);
  return bytes;
}

// The largest tile, then the largest chunk, then the most chunk buffers
// that fit, or false.
inline bool make_tile(Tile* t, const Arch& a, bool grad, bool backward) {
  make_layout(t, a);
  t->lda = stride8(backward ? t->op : t->wp);
  for (int rows = 128; rows >= 32; rows /= 2)
    for (int kc = 32; kc >= 8; kc /= 2)
      for (int stages = 3; stages >= 2; --stages) {
        t->rows = rows;
        t->points = grad ? rows / 4 : rows;
        t->row_warps = rows / 32;
        t->npass = kWC * (kWarps / t->row_warps);
        t->bufs = backward || t->npass < t->wp ? 2 : 1;
        t->kc = kc;
        t->stages = stages;
        t->cs = t->npass + 2;
        t->npass_shift = t->kc_shift = 0;
        while (2 << t->npass_shift < t->npass) ++t->npass_shift;
        while (2 << t->kc_shift < kc) ++t->kc_shift;
        if (smem_bytes(a, *t, backward) <= kSmemLimit) return true;
      }
  return false;
}

__host__ __device__ inline int npasses(const Tile& t) {
  return (t.wp + t.npass - 1) / t.npass;
}

// Floats of K9's stash a block: a float4 per point, hidden channel and
// layer, in the product's thread order (`stash_at`).
__host__ __device__ inline int stash_floats(const Arch& a, const Tile& t) {
  return a.n_hidden * npasses(t) * kWarps * 2 * kNT * 128;
}

// Layer l's [prim; t_x; t_y; t_z] of the thread's point at slot 2 nt + e
// of pass `pass` of `passes` (column pass n0 + kWC cw + 8 nt + 2 t + e).
__device__ __forceinline__ size_t stash_at(int passes, int l, int pass,
                                           int warp, int slot, int lane) {
  return ((((size_t)l * passes + pass) * kWarps + warp) * 2 * kNT + slot) *
             128 +
         lane * 4;
}

// Where 16-byte unit u (two pairs) of row r of a W^T chunk with kc pairs a
// row lies: with kc >= 16 an odd row's units are swapped in halves of 4, so
// that the 16-byte loads of rows r and r + 1 (one quarter warp) fall on
// distinct banks (with kc = 8 a row is 4 units and they already do).
__device__ __forceinline__ int tswz(int r, int u, int kc) {
  return kc >= 16 ? u ^ ((r & 1) << 2) : u;
}

// Row of point p's kind q (0 the primal, 1-3 the tangents along x, y, z)
// in a tile with tangents.
__device__ __forceinline__ int trow(int p, int q) {
  return (p >> 3) * 32 + q * 8 + (p & 7);
}

// ----------------------------------------------------------------- products
// One A operand of a product: `k` columns (a multiple of 8) of the float32
// rows `a` [row][lda] in shared memory, and the weights that pair with them
// in the pack: B(k, n) = w[k ldw + n], or for a kTrans product w[n ldw + k].
struct Operand {
  const float* a;
  int lda, k;
  const float2* w;
};

// acc[m][j] = this warp's 32 rows x kWC columns (from n0 + kWC cw) of
// sum over the operands of A B, zero past column nmax (a multiple of 8): a
// warp runs its tiles before nmax, all of them with no branch between them
// where its kWC columns lie before nmax. Every thread of the block calls
// it: it opens with a barrier (the A rows written before are complete, the
// previous product is done with the chunks) and synchronises once a chunk;
// chunks i + 1 .. i + stages - 1 are in flight while chunk i's products run
// (a group is committed for each, empty past the last chunk, so that the
// wait counts stay fixed).
template <bool kTrans>
__device__ void product(float (&acc)[2][kNT][4], const Tile& t,
                        const Operand* ops, int nops, int ldw, int n0,
                        int nmax, float2* chunk, int celems) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
  // the operands and the tiling in registers
  const Operand o0 = ops[0], o1 = ops[nops > 1 ? 1 : 0];
  const int stages = t.stages, kc = t.kc, npass = t.npass;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int rw = warp % t.row_warps, cw = warp / t.row_warps;
  const int cs = kTrans ? t.kc : t.cs;
  const int nch0 = (o0.k + kc - 1) / kc;
  const int nch = nch0 + (nops > 1 ? (o1.k + kc - 1) / kc : 0);
  // chunk i: operand o, its rows k0 .. k0 + kl, by 16-byte copies of 2
  // pairs (copy e of a row's `per`: row e >> sh, pair 2 (e & (per - 1));
  // per = npass / 2 or kc / 2, both powers of two)
  const int sh = kTrans ? t.kc_shift : t.npass_shift, per = 1 << sh;
  auto load = [&](int i, float2* dst) {
    const bool second = i >= nch0;
    const Operand o = second ? o1 : o0;
    const int k0 = (second ? i - nch0 : i) * kc, kl = min(kc, o.k - k0);
    if (!kTrans) {
      for (int e = threadIdx.x; e < kl << sh; e += kThreads) {
        const int r = e >> sh, c = (e & (per - 1)) * 2;
        const bool ok = n0 + c < nmax;
        cp_async16(dst + r * cs + c,
                   o.w + (size_t)(k0 + r) * ldw + (ok ? n0 + c : 0), ok);
      }
    } else {
      for (int e = threadIdx.x; e < npass << sh; e += kThreads) {
        const int r = e >> sh, c = (e & (per - 1)) * 2;
        if (c >= kl) continue;
        const bool ok = n0 + r < nmax;
        cp_async16(dst + r * cs + 2 * tswz(r, c / 2, kc),
                   o.w + (size_t)(ok ? n0 + r : 0) * ldw + k0 + c, ok);
      }
    }
  };
  const int wn0 = n0 + kWC * cw;  // this warp's first column
  const int nv = min(kNT, (nmax - wn0) / 8);  // its tiles before nmax
  __syncthreads();
  for (int i = 0; i < stages - 1; ++i) {
    if (i < nch) load(i, chunk + i * celems);
    cp_async_commit();
  }
  for (int i = 0; i < nch; ++i) {
    if (stages == 3)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();  // chunk i is in; every warp is done with chunk i - 1
    const int next = i + stages - 1;
    if (next < nch) load(next, chunk + (next % stages) * celems);
    cp_async_commit();
    if (wn0 >= nmax) continue;
    const bool second = i >= nch0;
    const Operand o = second ? o1 : o0;
    const int k0 = (second ? i - nch0 : i) * kc, kl = min(kc, o.k - k0);
    const float2* c = chunk + (i % stages) * celems;
    // tile nt's B fragment halves of k-step ks
    auto load_b = [&](int ks, int nt, uint32_t (&bh)[2], uint32_t (&bl)[2]) {
      if (!kTrans) {
        const float2* b = c + (ks + 2 * tq) * cs + kWC * cw + 8 * nt + g;
        const float2 u = b[0], v = b[cs];
        bh[0] = hi_of(u);
        bl[0] = lo_of(u);
        bh[1] = hi_of(v);
        bl[1] = lo_of(v);
      } else {
        const int r = kWC * cw + 8 * nt + g;
        const float4 u = *reinterpret_cast<const float4*>(
            c + r * cs + 2 * tswz(r, ks / 2 + tq, kc));
        bh[0] = __float_as_uint(u.x);
        bl[0] = __float_as_uint(u.y);
        bh[1] = __float_as_uint(u.z);
        bl[1] = __float_as_uint(u.w);
      }
    };
#pragma unroll
    for (int ks = 0; ks < 32; ks += 8) {
      if (ks >= kl) break;
      uint32_t ah[2][4], al[2][4], bh[kNT][2], bl[kNT][2];
#pragma unroll
      for (int m = 0; m < 2; ++m)
        load_a(ah[m], al[m],
               o.a + (size_t)(rw * 32 + m * 16) * o.lda + k0 + ks, o.lda,
               lane);
      if (nv == kNT) {
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) load_b(ks, nt, bh[nt], bl[nt]);
        mma3_tiles(acc, ah, al, bh, bl, kNT);
      } else {
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          if (nt >= nv) break;
          load_b(ks, nt, bh[nt], bl[nt]);
        }
        mma3_tiles(acc, ah, al, bh, bl, nv);
      }
    }
  }
  cp_async_wait<0>();  // the trailing groups are empty
}

// dk[k][n] += sum over the tile's rows of [h | posenc](r, k) cot(r, n) for
// layer l (dk: the block's partial of layer l's float32 weights, flax
// [K_l][N_l]): warp tiles of 32 x 64 entries, A = [h | posenc]^T and B = cot
// read down the staged rows (the mma's column t from row t, t + 4 from row
// t + 4), split in registers; a tile runs its columns before Np (all with
// no branch between its products where it lies inside, `mma3_tiles`), its
// rows past Kp reading channel 0 and their sums dropped. Each entry
// is always added to by the same thread, which copies its old values into
// `stage` (the idle chunk buffers, 32 pairs a thread, [pair][thread]) by
// cp.async before the tile's products and adds them after (two columns an
// 8-byte copy where N_l is even and the partial 8-byte aligned), so that the
// partial's round trip to memory overlaps the products and holds no
// registers.
__device__ void weight_grad(const Arch& a, const Tile& t, int l,
                            const float* h, const float* pe, const float* cot,
                            float* dk, float2* stage) {
  const int W = a.width, D = a.pe_dim, Nl = layer_out(a, l);
  const int Kh = layer_h(a, l), khp = kp_h(t, l);
  const bool has_pe = layer_pe(a, l);
  const bool pairs =
      Nl % 2 == 0 && (reinterpret_cast<uintptr_t>(dk) & 7) == 0;
  const int Kp = khp + (has_pe ? t.dp : 0), Np = np_of(a, t, l);
  const int nkt = (Kp + 31) / 32, nnt = (Np + kWC - 1) / kWC;
  const int rows = t.rows, lda = t.lda;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  // flax row offset of the pack's row k of layer l, or -1 for padding
  auto flax_row = [&](int k) {
    const int d = k - khp;
    const int kr = k >= Kp    ? -1
                   : k < khp ? (k < W ? k : -1)
                             : (d < D ? Kh + d : -1);
    return kr >= 0 ? kr * Nl : -1;
  };
  float2* mine = stage + threadIdx.x;  // slot e at mine[e * kThreads]
  for (int wt = warp; wt < nkt * nnt; wt += kWarps) {
    const int kb = (wt / nnt) * 32, nb = (wt % nnt) * kWC + 2 * tq;
    // this thread's entries: rows kb + 16 m + 8 hf + g (their flax row
    // offsets, or -1 for padding) x columns nb + 8 j + e; the A rows they
    // read
    int ro[2][2], ld[2][2];
    const float* src[2][2];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int k = kb + 16 * m + 8 * hf + g;
        ro[m][hf] = flax_row(k);
        const int kk = k < Kp ? k : 0;
        src[m][hf] = kk < khp ? h + kk : pe + (kk - khp);
        ld[m][hf] = kk < khp ? lda : t.ldp;
      }
    // this thread's old values, slot (m kNT + j) 2 + hf
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int n = nb + 8 * j, r = ro[m][hf];
          float2* slot = mine + ((m * kNT + j) * 2 + hf) * kThreads;
          if (r < 0 || n >= Nl) continue;
          if (pairs) {
            cp_async8(slot, dk + r + n);
          } else {
            cp_async4(&slot->x, dk + r + n);
            if (n + 1 < Nl) cp_async4(&slot->y, dk + r + n + 1);
          }
        }
    cp_async_commit();
    float acc[2][kNT][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
    const float* b = cot + (size_t)tq * lda + nb - 2 * tq + g;
    const int nv = min(kNT, (Np - (nb - 2 * tq)) / 8);  // tiles before Np
    for (int r = 0; r < rows; r += 8) {
      uint32_t ah[2][4], al[2][4], bh[kNT][2], bl[kNT][2];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int hf = i & 1, kr = r + tq + 4 * (i >> 1);
          split(src[m][hf][kr * ld[m][hf]], ah[m][i], al[m][i]);
        }
      if (nv == kNT) {
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          split(b[(size_t)r * lda + 8 * nt], bh[nt][0], bl[nt][0]);
          split(b[(size_t)(r + 4) * lda + 8 * nt], bh[nt][1], bl[nt][1]);
        }
        mma3_tiles(acc, ah, al, bh, bl, kNT);
      } else {
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          if (nt >= nv) break;
          split(b[(size_t)r * lda + 8 * nt], bh[nt][0], bl[nt][0]);
          split(b[(size_t)(r + 4) * lda + 8 * nt], bh[nt][1], bl[nt][1]);
        }
        mma3_tiles(acc, ah, al, bh, bl, nv);
      }
    }
    cp_async_wait<0>();
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int n = nb + 8 * j, r = ro[m][hf];
          if (r < 0 || n >= Nl) continue;
          const float2 v = mine[((m * kNT + j) * 2 + hf) * kThreads];
          const float x = v.x + acc[m][j][2 * hf];
          const float y = v.y + acc[m][j][2 * hf + 1];
          if (pairs) {
            *reinterpret_cast<float2*>(dk + r + n) = make_float2(x, y);
          } else {
            dk[r + n] = x;
            if (n + 1 < Nl) dk[r + n + 1] = y;
          }
        }
  }
}

// --------------------------------------------------------------- the forward
// The tile's posenc rows (float32, [R][ldp], zero past D) and the x0 signs;
// with tangents the tangent row along coordinate q holds dpe where feature
// d reads coordinate q, else 0.
template <bool kGrad>
__device__ void build_posenc(const Arch& a, const Tile& t,
                             const float* points, int b, int N, int n0,
                             int force_symmetry, float* pe, float* sign) {
  const int P = t.points, D = a.pe_dim, Dp = t.dp;
  for (int e = threadIdx.x; e < P * Dp; e += kThreads) {
    const int p = e / Dp, d = e % Dp, n = n0 + p;
    float v = 0.f, dv = 0.f;
    int coord = -1;
    if (d < D) {
      int kind;
      float freq;
      pe_feature(d, coord, kind, freq);
      float x = n < N ? points[((size_t)b * N + n) * 3 + coord] : 0.f;
      if (force_symmetry && coord == 0 && x < 0.f) x = -x;
      if (kind == 0) {
        v = x;
        dv = 1.f;
      } else {
        const float xf = x * freq;
        const float s = sinf(xf), c = cosf(xf);
        v = kind == 1 ? s : c;
        dv = kind == 1 ? freq * c : -freq * s;
      }
    }
    if (kGrad) {
      pe[(size_t)trow(p, 0) * t.ldp + d] = v;
      for (int q = 0; q < 3; ++q)
        pe[(size_t)trow(p, q + 1) * t.ldp + d] = q == coord ? dv : 0.f;
    } else {
      pe[(size_t)p * t.ldp + d] = v;
    }
  }
  for (int p = threadIdx.x; p < P; p += kThreads) {
    const int n = n0 + p;
    const float x0 = n < N ? points[((size_t)b * N + n) * 3] : 0.f;
    sign[p] = (force_symmetry && x0 < 0.f) ? -1.f : 1.f;
  }
}

// The hidden layers 0 .. L-1 of a tile: h_l = act(layer l of [h_(l-1);
// posenc]) into the other buffer (with one buffer, t.bufs == 1, in place:
// a layer is then one pass, written after every warp has read its input),
// each layer's [prim; raw tangents] into `stash` (`stash_at`) when given.
// Returns the buffer that holds h_(L-1).
template <bool kGrad>
__device__ float* forward_hidden(const Arch& a, const Tile& t,
                                 const float2* wts, const float* bias_row,
                                 float* hin, float* hout, const float* pe,
                                 float2* chunk, int celems, float* stash) {
  const int W = a.width;
  const int lda = t.lda, ldp = t.ldp, wp = t.wp, dp = t.dp;
  const int npass = t.npass, passes = npasses(t);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int rw = warp % t.row_warps, cw = warp / t.row_warps;
  const bool in_place = t.bufs == 1;
  if (in_place) hout = hin;
  for (int l = 0; l < a.n_hidden; ++l) {
    const float2* w = wts + t.boff[l];
    Operand ops[2];
    int nops = 0;
    if (l > 0) ops[nops++] = Operand{hin, lda, wp, w};
    if (layer_pe(a, l))
      ops[nops++] = Operand{pe, ldp, dp, w + (size_t)kp_h(t, l) * wp};
    const float* bias = bias_row + l * W;
    for (int pass = 0; pass < passes; ++pass) {
      const int n0 = pass * npass;
      float acc[2][kNT][4];
      product<false>(acc, t, ops, nops, wp, n0, wp, chunk, celems);
      if (in_place) __syncthreads();  // every warp is done with the input
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int n = n0 + kWC * cw + 8 * nt + 2 * tq;
        if (n >= wp) break;
        if (kGrad) {
          float o[4][2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = n + e;
            const float tx = acc[0][nt][2 + e], ty = acc[1][nt][e],
                        tz = acc[1][nt][2 + e];
            if (c < W) {
              const float prim = acc[0][nt][e] + bias[c];
              float act, sig;
              act_pair(prim, act, sig);
              if (stash)
                *reinterpret_cast<float4*>(
                    stash + stash_at(passes, l, pass, warp, 2 * nt + e,
                                     lane)) = make_float4(prim, tx, ty, tz);
              o[0][e] = act;
              o[1][e] = tx * sig;
              o[2][e] = ty * sig;
              o[3][e] = tz * sig;
            } else {
              o[0][e] = o[1][e] = o[2][e] = o[3][e] = 0.f;
            }
          }
          const int p = 8 * rw + g;
#pragma unroll
          for (int q = 0; q < 4; ++q)
            *reinterpret_cast<float2*>(hout + (size_t)trow(p, q) * lda + n) =
                make_float2(o[q][0], o[q][1]);
        } else {
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              float o[2], sig;
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int c = n + e;
                o[e] = 0.f;
                if (c < W)
                  act_pair(acc[m][nt][2 * half + e] + bias[c], o[e], sig);
              }
              const int row = rw * 32 + m * 16 + 8 * half + g;
              *reinterpret_cast<float2*>(hout + (size_t)row * lda + n) =
                  make_float2(o[0], o[1]);
            }
        }
      }
    }
    float* tmp = hin;
    hin = hout;
    hout = tmp;
  }
  return hin;
}

// K8 (with tangents) and K8-nograd: one block a tile.
template <bool kGrad>
__global__ void __launch_bounds__(kThreads, 1)
    sdf_generic_fwd_tf32_kernel(const float* __restrict__ points,
                                const float2* __restrict__ wts,
                                const float* __restrict__ biases,
                                float* __restrict__ sdf,
                                float* __restrict__ feat,
                                float* __restrict__ grad, int N,
                                int force_symmetry, Arch a, Tile t) {
  extern __shared__ __align__(16) float smem[];
  const int celems = chunk_elems(t, false);
  float* buf0 = smem;
  float* buf1 = buf0 + (size_t)(t.bufs - 1) * t.rows * t.lda;
  float* pe = buf1 + (size_t)t.rows * t.lda;
  float2* chunk = reinterpret_cast<float2*>(pe + (size_t)t.rows * t.ldp);
  float* sign = reinterpret_cast<float*>(chunk + t.stages * celems);
  const int tiles_per_batch = (N + t.points - 1) / t.points;
  const int b = blockIdx.x / tiles_per_batch;
  const int p0 = (blockIdx.x % tiles_per_batch) * t.points;
  const float* bias_row = biases + (size_t)b * a.bias_width;
  const int W = a.width, L = a.n_hidden;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int rw = warp % t.row_warps, cw = warp / t.row_warps;

  build_posenc<kGrad>(a, t, points, b, N, p0, force_symmetry, pe, sign);
  const float* h = forward_hidden<kGrad>(a, t, wts, bias_row, buf0, buf1, pe,
                                         chunk, celems, nullptr);
  // the output layer: [sdf | feature] on the primal rows, the gradient from
  // the tangent rows' sdf column
  const float2* w = wts + t.boff[L];
  Operand ops[2];
  int nops = 0;
  ops[nops++] = Operand{h, t.lda, t.wp, w};
  if (layer_pe(a, L))
    ops[nops++] = Operand{pe, t.ldp, t.dp, w + (size_t)t.wp * t.op};
  const float* bias = bias_row + L * W;
  for (int n0 = 0; n0 < t.op; n0 += t.npass) {
    float acc[2][kNT][4];
    product<false>(acc, t, ops, nops, t.op, n0, t.op, chunk, celems);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = n0 + kWC * cw + 8 * nt + 2 * tq + e;
        if (c > W) continue;
        if (kGrad) {
          const int p = 8 * rw + g, n = p0 + p;
          if (n >= N) continue;
          const size_t pn = (size_t)b * N + n;
          const float prim = acc[0][nt][e] + bias[c];
          if (c == 0) {
            sdf[pn] = prim;
            grad[pn * 3 + 0] = acc[0][nt][2 + e] * sign[p];
            grad[pn * 3 + 1] = acc[1][nt][e];
            grad[pn * 3 + 2] = acc[1][nt][2 + e];
          } else {
            feat[pn * W + c - 1] = prim;
          }
        } else {
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int n = p0 + rw * 32 + m * 16 + 8 * half + g;
              if (n >= N) continue;
              const size_t pn = (size_t)b * N + n;
              const float prim = acc[m][nt][2 * half + e] + bias[c];
              if (c == 0)
                sdf[pn] = prim;
              else
                feat[pn * W + c - 1] = prim;
            }
        }
      }
  }
}

// --------------------------------------------------------------------- K9
// K9: persistent blocks over the tiles; the block's slices: part
// [num_weights + B bias_width] (d weights, then d biases) and stash
// [stash_floats].
__global__ void __launch_bounds__(kThreads, 1)
    sdf_generic_bwd_tf32_kernel(const float* __restrict__ points,
                                const float2* __restrict__ wts,
                                const float* __restrict__ biases,
                                const float* __restrict__ sbar,
                                const float* __restrict__ fbar,
                                const float* __restrict__ gbar,
                                float* __restrict__ dpoints,
                                float* __restrict__ partials,
                                float* __restrict__ stash_all, int B, int N,
                                int force_symmetry, Arch a, Tile t) {
  extern __shared__ __align__(16) float smem[];
  const int celems = chunk_elems(t, true);
  const int lda = t.lda, wp = t.wp, dp = t.dp, op = t.op;
  const int npass = t.npass, row_warps = t.row_warps;
  const int passes = npasses(t);
  const int W = a.width, D = a.pe_dim, L = a.n_hidden, P = t.points;
  float* bufa = smem;
  float* bufb = bufa + (size_t)t.rows * lda;
  float* pe = bufb + (size_t)t.rows * lda;
  float2* chunk = reinterpret_cast<float2*>(pe + (size_t)t.rows * t.ldp);
  float* gt = reinterpret_cast<float*>(chunk + chunk_area(t, true));
  float* bsum = gt + 2 * P * dp;  // gt: [P][dp][2], bsum: [R/32][op]
  float* sign = bsum + row_warps * op;
  const size_t part_size = (size_t)a.num_weights + (size_t)B * a.bias_width;
  float* dk = partials + blockIdx.x * part_size;
  float* db = dk + a.num_weights;
  float* stash = stash_all + (size_t)blockIdx.x * stash_floats(a, t);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int rw = warp % row_warps, cw = warp / row_warps;

  for (size_t e = threadIdx.x; e < part_size; e += kThreads) dk[e] = 0.f;

  const int tiles_per_batch = (N + P - 1) / P;
  const int tiles = B * tiles_per_batch;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b = tile / tiles_per_batch;
    const int p0 = (tile % tiles_per_batch) * P;
    const float* bias_row = biases + (size_t)b * a.bias_width;
    float* db_row = db + (size_t)b * a.bias_width;
    __syncthreads();  // the previous tile is done with every buffer
    build_posenc<true>(a, t, points, b, N, p0, force_symmetry, pe, sign);
    for (int e = threadIdx.x; e < 2 * P * dp; e += kThreads) gt[e] = 0.f;
    float* h = forward_hidden<true>(a, t, wts, bias_row, bufa, bufb, pe,
                                    chunk, celems, stash);
    float* cot = h == bufa ? bufb : bufa;
    __syncthreads();
    // the output layer's cotangent rows: [sdf_bar | feat_bar] on the primal
    // row, grad_bar (x0 sign applied) in the tangent rows' sdf column
    for (int e = threadIdx.x; e < P * op; e += kThreads) {
      const int p = e / op, c = e % op, n = p0 + p;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (n < N && c <= W) {
        const size_t pn = (size_t)b * N + n;
        if (c == 0) {
          v[0] = sbar[pn];
          v[1] = gbar[pn * 3] * sign[p];
          v[2] = gbar[pn * 3 + 1];
          v[3] = gbar[pn * 3 + 2];
        } else {
          v[0] = fbar[pn * W + c - 1];
        }
      }
      for (int q = 0; q < 4; ++q) cot[(size_t)trow(p, q) * lda + c] = v[q];
    }
    // its bias gradient: [sdf_bar | feat_bar] over the points
    for (int c = threadIdx.x; c <= W; c += kThreads) {
      float s = 0.f;
      for (int p = 0; p < P; ++p) {
        const int n = p0 + p;
        const size_t pn = (size_t)b * N + n;
        s += n >= N ? 0.f : c == 0 ? sbar[pn] : fbar[pn * W + c - 1];
      }
      db_row[L * W + c] += s;
    }
    for (int l = L; l >= 0; --l) {
      const int Np = np_of(a, t, l);
      const float2* w = wts + t.boff[l];
      __syncthreads();  // cot and h are complete
      weight_grad(a, t, l, h, pe, cot, dk + a.woff[l], chunk);
      if (l > 0) {
        // C_(l-1) = act'(C_l W_h^T) into h's buffer; product() opens with a
        // barrier, so every warp is done with h first
        const Operand o{cot, lda, Np, w};
        for (int pass = 0; pass < passes; ++pass) {
          const int n0 = pass * npass;
          // this pass's stash of layers l - 1 (its epilogue) and l - 2 (the
          // rebuild below) into L2 while the products run: 64 KB each
          constexpr int kLines = kWarps * 2 * kNT * 4;  // a layer's pass
          for (int i = threadIdx.x; i < 2 * kLines; i += kThreads) {
            const int layer = l - 1 - i / kLines;
            if (layer >= 0)
              prefetch_l2(stash + stash_at(passes, layer, pass, 0, 0, 0) +
                          32 * (i % kLines));
          }
          float acc[2][kNT][4];
          product<true>(acc, t, &o, 1, Np, n0, wp, chunk, celems);
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            const int n = n0 + kWC * cw + 8 * nt + 2 * tq;
            if (n >= wp) break;
            float v[4][2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = n + e;
              const float dp_ = acc[0][nt][e], dx = acc[0][nt][2 + e],
                          dy = acc[1][nt][e], dz = acc[1][nt][2 + e];
              if (c < W) {
                const float4 s4 = *reinterpret_cast<const float4*>(
                    stash +
                    stash_at(passes, l - 1, pass, warp, 2 * nt + e, lane));
                float act, sig;
                act_pair(s4.x, act, sig);
                const float sp = kBeta * sig * (1.f - sig);
                const float tsum = dx * s4.y + dy * s4.z + dz * s4.w;
                v[0][e] = dp_ * sig + tsum * sp;
                v[1][e] = dx * sig;
                v[2][e] = dy * sig;
                v[3][e] = dz * sig;
              } else {
                v[0][e] = v[1][e] = v[2][e] = v[3][e] = 0.f;
              }
              // the bias gradient: the warp's 8 points by a fixed butterfly
              float s = v[0][e];
              s += __shfl_xor_sync(0xffffffffu, s, 4);
              s += __shfl_xor_sync(0xffffffffu, s, 8);
              s += __shfl_xor_sync(0xffffffffu, s, 16);
              if (g == 0) bsum[rw * op + c] = s;
            }
            const int p = 8 * rw + g;
#pragma unroll
            for (int q = 0; q < 4; ++q)
              *reinterpret_cast<float2*>(h + (size_t)trow(p, q) * lda + n) =
                  make_float2(v[q][0], v[q][1]);
          }
        }
        __syncthreads();
        for (int c = threadIdx.x; c < W; c += kThreads) {
          float s = 0.f;
          for (int r = 0; r < row_warps; ++r) s += bsum[r * op + c];
          db_row[(l - 1) * W + c] += s;
        }
      }
      if (layer_pe(a, l)) {
        // the posenc rows' cotangent: C_l W_pe^T, the primal row and the
        // tangent row of each feature's own coordinate
        const Operand o{cot, lda, Np, w + (size_t)kp_h(t, l) * Np};
        for (int n0 = 0; n0 < dp; n0 += npass) {
          float acc[2][kNT][4];
          product<true>(acc, t, &o, 1, Np, n0, dp, chunk, celems);
          const int p = 8 * rw + g;
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int d = n0 + kWC * cw + 8 * nt + 2 * tq + e;
              if (d >= D) continue;
              const int coord = d % 3;
              const float gtan = coord == 0   ? acc[0][nt][2 + e]
                                 : coord == 1 ? acc[1][nt][e]
                                              : acc[1][nt][2 + e];
              float* x = gt + ((size_t)p * dp + d) * 2;
              x[0] += acc[0][nt][e];
              x[1] += gtan;
            }
        }
      }
      if (l >= 2) {
        // h_(l-2), the next layer's input, rebuilt from the stash into the
        // free buffer, as the forward computed it
        __syncthreads();
        for (int pass = 0; pass < passes; ++pass)
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            const int n = pass * npass + kWC * cw + 8 * nt + 2 * tq;
            if (n >= wp) break;
            float v[4][2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (n + e < W) {
                const float4 s4 = *reinterpret_cast<const float4*>(
                    stash +
                    stash_at(passes, l - 2, pass, warp, 2 * nt + e, lane));
                float act, sig;
                act_pair(s4.x, act, sig);
                v[0][e] = act;
                v[1][e] = s4.y * sig;
                v[2][e] = s4.z * sig;
                v[3][e] = s4.w * sig;
              } else {
                v[0][e] = v[1][e] = v[2][e] = v[3][e] = 0.f;
              }
            }
            const int p = 8 * rw + g;
#pragma unroll
            for (int q = 0; q < 4; ++q)
              *reinterpret_cast<float2*>(cot + (size_t)trow(p, q) * lda +
                                         n) = make_float2(v[q][0], v[q][1]);
          }
      }
      float* tmp = cot;  // C_(l-1) is in h now, h_(l-2) in cot
      cot = h;
      h = tmp;
    }
    __syncthreads();
    // the posenc rows' cotangent back to the points: sum over the features
    // of coordinate q of G_prim dpe + G_tangent(q) d2pe
    for (int e = threadIdx.x; e < P * 3; e += kThreads) {
      const int p = e / 3, q = e % 3, n = p0 + p;
      if (n >= N) continue;
      const size_t pn = (size_t)b * N + n;
      float x = points[pn * 3 + q];
      if (force_symmetry && q == 0 && x < 0.f) x = -x;
      const float* gp = gt + (size_t)p * dp * 2;
      float s = gp[2 * q];
      for (int f = 0; f < a.n_freqs; ++f) {
        const float freq = (float)(1 << f), xf = x * freq;
        const float sn = sinf(xf), cs = cosf(xf);
        const float* gs = gp + 2 * (3 + 6 * f + q);
        const float* gc = gs + 6;
        s += gs[0] * (freq * cs) + gs[1] * (-(freq * freq) * sn);
        s += gc[0] * (-freq * sn) + gc[1] * (-(freq * freq) * cs);
      }
      dpoints[pn * 3 + q] = q == 0 ? s * sign[p] : s;
    }
  }
}

// The pack: the packed float32 weights -> each layer as a zero-padded
// [kp_h + kp_pe][np] matrix (rows: h, then posenc) of (hi, lo) tf32 pairs.
__global__ void sdf_generic_pack_tf32_kernel(const float* __restrict__ w,
                                             float2* __restrict__ out, Arch a,
                                             Tile t) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= t.boff[a.n_hidden + 1]) return;
  int l = 0;
  while (i >= t.boff[l + 1]) ++l;
  const int Np = np_of(a, t, l), khp = kp_h(t, l), Nl = layer_out(a, l);
  const int k = (i - t.boff[l]) / Np, n = (i - t.boff[l]) % Np;
  int kr = -1;
  if (n < Nl) {
    if (k < khp)
      kr = k < a.width ? k : -1;
    else if (k - khp < a.pe_dim)
      kr = layer_h(a, l) + k - khp;
  }
  uint32_t hi = 0, lo = 0;
  if (kr >= 0) split(w[a.woff[l] + (size_t)kr * Nl + n], hi, lo);
  out[i] = make_float2(__uint_as_float(hi), __uint_as_float(lo));
}

}  // namespace

// ---------------------------------------------------------------- C entry

namespace {

bool arch_tile(Arch* a, Tile* t, int f, int l, int w, int m, bool grad,
               bool backward) {
  return make_arch(a, f, l, w, m) && make_tile(t, *a, grad, backward);
}

}  // namespace

// Packed weights of the architecture, or -1 outside the envelope.
extern "C" int scl_sdf_generic_num_weights(int n_freqs, int n_hidden,
                                           int width, int skip_mask) {
  Arch a;
  return make_arch(&a, n_freqs, n_hidden, width, skip_mask) ? a.num_weights
                                                            : -1;
}

// The float32 forms' weights (`scl_sdf_generic_pack_tf32`, floats: two a
// padded element), or -1 outside the envelope.
extern "C" int scl_sdf_generic_packed_tf32(int n_freqs, int n_hidden,
                                           int width, int skip_mask) {
  Arch a;
  Tile t;
  if (!make_arch(&a, n_freqs, n_hidden, width, skip_mask)) return -1;
  make_layout(&t, a);
  return 2 * t.boff[a.n_hidden + 1];
}

// The bf16 forms' packed weights (`scl_sdf_generic_pack_bf16`, bf16
// elements), or -1 outside the envelope.
extern "C" int scl_sdf_generic_packed_bf16(int n_freqs, int n_hidden,
                                           int width, int skip_mask) {
  return sdf_generic_bf16_packed(n_freqs, n_hidden, width, skip_mask);
}

// Which form a K8 launch takes: 1 for K8-bf16's wgmma form (bf16 products
// with tangents at a width that pads to 256), 0 for the mma.sync forms, -1
// outside the envelope.
extern "C" int scl_sdf_generic_fwd_form(int n_freqs, int n_hidden, int width,
                                        int skip_mask, int compute_grad,
                                        int mm_bf16) {
  if (mm_bf16)
    return sdf_generic_bf16_fwd_form(n_freqs, n_hidden, width, skip_mask,
                                     compute_grad != 0);
  Arch a;
  return make_arch(&a, n_freqs, n_hidden, width, skip_mask) ? 0 : -1;
}

// Points of a tile: K8 (`backward` 0, with or without tangents) or K9, with
// float32 (3xTF32) or (mm_bf16) bf16 products, or -1 outside the envelope.
extern "C" int scl_sdf_generic_tile_points(int n_freqs, int n_hidden,
                                           int width, int skip_mask,
                                           int compute_grad, int backward,
                                           int mm_bf16) {
  if (mm_bf16)
    return sdf_generic_bf16_tile_points(n_freqs, n_hidden, width, skip_mask,
                                        compute_grad || backward, backward);
  Arch a;
  Tile t;
  return arch_tile(&a, &t, n_freqs, n_hidden, width, skip_mask,
                   compute_grad || backward, backward)
             ? t.points
             : -1;
}

// Floats of K9's stash a block (float32 or bf16 products), or -1 outside
// the envelope.
extern "C" int scl_sdf_generic_stash_floats(int n_freqs, int n_hidden,
                                            int width, int skip_mask,
                                            int mm_bf16) {
  if (mm_bf16)
    return sdf_generic_bf16_stash_floats(n_freqs, n_hidden, width,
                                         skip_mask);
  Arch a;
  Tile t;
  return arch_tile(&a, &t, n_freqs, n_hidden, width, skip_mask, true, true)
             ? stash_floats(a, t)
             : -1;
}

// K9's blocks that fit on one SM at once (its grid is that times the SMs,
// capped at the tiles), or -1 outside the envelope / a cudaError_t < 0.
extern "C" int scl_sdf_generic_bwd_blocks_per_sm(int n_freqs, int n_hidden,
                                                 int width, int skip_mask,
                                                 int mm_bf16) {
  if (mm_bf16)
    return sdf_generic_bf16_bwd_blocks_per_sm(n_freqs, n_hidden, width,
                                              skip_mask);
  Arch a;
  Tile t;
  if (!arch_tile(&a, &t, n_freqs, n_hidden, width, skip_mask, true, true))
    return -1;
  const size_t smem = smem_bytes(a, t, true);
  int blocks = 0;
  cudaError_t err = allow_smem(sdf_generic_bwd_tf32_kernel, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, sdf_generic_bwd_tf32_kernel, kThreads, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

// The float32 forms' weights: the packed float32 weights [num_weights] ->
// `packed` [scl_sdf_generic_packed_tf32] floats, each layer zero-padded to
// multiples of 8, each element its (hi, lo) tf32 pair. One launch on
// `stream`; returns a cudaError_t.
extern "C" int scl_sdf_generic_pack_tf32(const void* weights, void* packed,
                                         int n_freqs, int n_hidden, int width,
                                         int skip_mask, void* stream) {
  Arch a;
  Tile t;
  if (!make_arch(&a, n_freqs, n_hidden, width, skip_mask))
    return (int)cudaErrorInvalidValue;
  make_layout(&t, a);
  const int n = t.boff[a.n_hidden + 1];
  sdf_generic_pack_tf32_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(weights), static_cast<float2*>(packed), a, t);
  return (int)cudaGetLastError();
}

// The bf16 forms' weights: the packed float32 weights [num_weights] ->
// `packed` [scl_sdf_generic_packed_bf16] bf16, each layer zero-padded to
// multiples of 16 (`fused_sdf_generic_bf16.cu`). One launch on `stream`;
// returns a cudaError_t.
extern "C" int scl_sdf_generic_pack_bf16(const void* weights, void* packed,
                                         int n_freqs, int n_hidden, int width,
                                         int skip_mask, void* stream) {
  return sdf_generic_bf16_pack(static_cast<const float*>(weights), packed,
                               n_freqs, n_hidden, width, skip_mask,
                               static_cast<cudaStream_t>(stream));
}

// K8: points [B,N,3], weights, biases [B, L W + W + 1] -> sdf [B,N], feat
// [B,N,W], grad [B,N,3] (with compute_grad); float32, contiguous, on the
// current device. The weights are their tf32 pack
// (`scl_sdf_generic_pack_tf32`), or with mm_bf16 (bf16 products) their
// bf16 pack. One launch on `stream`; returns a cudaError_t.
extern "C" int scl_sdf_generic_fwd(const void* points, const void* weights,
                                   const void* biases, void* sdf, void* feat,
                                   void* grad, int B, int N, int n_freqs,
                                   int n_hidden, int width, int skip_mask,
                                   int compute_grad, int force_symmetry,
                                   int mm_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(points);
  const float* bi = static_cast<const float*>(biases);
  float* so = static_cast<float*>(sdf);
  float* fo = static_cast<float*>(feat);
  float* go = static_cast<float*>(grad);
  if (mm_bf16)
    return sdf_generic_bf16_fwd(p, weights, bi, so, fo, go, B, N,
                                compute_grad != 0, force_symmetry, n_freqs,
                                n_hidden, width, skip_mask, s);
  Arch a;
  Tile t;
  if (B <= 0 || N <= 0 ||
      !arch_tile(&a, &t, n_freqs, n_hidden, width, skip_mask,
                 compute_grad != 0, false))
    return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)B * ((N + t.points - 1) / t.points);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(a, t, false);
  const float2* w = static_cast<const float2*>(weights);
  cudaError_t err;
#define SCL_FWD(G)                                                        \
  err = allow_smem(sdf_generic_fwd_tf32_kernel<G>, smem);                 \
  if (err != cudaSuccess) return (int)err;                                \
  sdf_generic_fwd_tf32_kernel<G><<<(int)tiles, kThreads, smem, s>>>(        \
      p, w, bi, so, fo, go, N, force_symmetry, a, t);
  if (compute_grad) {
    SCL_FWD(true)
  } else {
    SCL_FWD(false)
  }
#undef SCL_FWD
  return (int)cudaGetLastError();
}

// K9: points [B,N,3], weights, biases (as K8), the cotangents sbar [B,N],
// fbar [B,N,W], gbar [B,N,3] -> dpoints [B,N,3] and out [num_weights +
// B (L W + W + 1)] (d weights, then d biases); partials [grid][the same]
// and stash [grid][scl_sdf_generic_stash_floats] are scratch, one slice a
// block. Any grid >= 1 is correct; the caller passes
// `scl_sdf_generic_bwd_blocks_per_sm` x the SMs, capped at the tiles. Two
// launches on `stream`; returns a cudaError_t.
extern "C" int scl_sdf_generic_bwd(const void* points, const void* weights,
                                   const void* biases, const void* sbar,
                                   const void* fbar, const void* gbar,
                                   void* dpoints, void* out, void* partials,
                                   void* stash, int B, int N, int grid,
                                   int n_freqs, int n_hidden, int width,
                                   int skip_mask, int force_symmetry,
                                   int mm_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(points);
  const float* bi = static_cast<const float*>(biases);
  const float* sb = static_cast<const float*>(sbar);
  const float* fb = static_cast<const float*>(fbar);
  const float* gb = static_cast<const float*>(gbar);
  float* dp = static_cast<float*>(dpoints);
  float* o = static_cast<float*>(out);
  float* part = static_cast<float*>(partials);
  float* st = static_cast<float*>(stash);
  if (mm_bf16)
    return sdf_generic_bf16_bwd(p, weights, bi, sb, fb, gb, dp, o, part, st,
                                B, N, grid, force_symmetry, n_freqs, n_hidden,
                                width, skip_mask, s);
  Arch a;
  Tile t;
  if (B <= 0 || N <= 0 || grid <= 0 ||
      !arch_tile(&a, &t, n_freqs, n_hidden, width, skip_mask, true, true))
    return (int)cudaErrorInvalidValue;
  if ((long long)B * ((N + t.points - 1) / t.points) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(a, t, true);
  cudaError_t err = allow_smem(sdf_generic_bwd_tf32_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  sdf_generic_bwd_tf32_kernel<<<grid, kThreads, smem, s>>>(
      p, static_cast<const float2*>(weights), bi, sb, fb, gb, dp, part, st, B,
      N, force_symmetry, a, t);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)a.num_weights + (size_t)B * a.bias_width;
  sum_partials_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(part, o, n,
                                                                  grid);
  return (int)cudaGetLastError();
}
