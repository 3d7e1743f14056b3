// The generic fused SDF pair's bf16 forms on Hopper's tensor cores
// (sm_90a): K8-bf16, the forward with or without forward-mode point tangents,
// K9-bf16, its hand-derived VJP, and the pack of their weights, for every
// SDF MLP of the envelope of `fused_sdf_generic.cu` (which holds the float32
// K8 / K9, the architecture and the C entry points that dispatch here).
//
// Replaces the Pallas TPU kernels `shapeclipper_tpu/ops/fused_sdf.py::
// _forward_call` (`pl.pallas_call` at line 311) and `_backward_call` (line
// 617) under `_mm_cast("bfloat16")`, for any `cfg` of the envelope. Every
// product's operands are rounded to bf16 (nearest even) where they become
// operands -- the weights once a call (the pack), the activation and posenc
// rows where they are staged, the cotangent rows after the bias gradient has
// read their float32 values -- and every sum is float32, as
// `ops/fused_sdf.py::_CastProduct`; biases, activations, sigma'', the
// posenc backward and the bias gradients stay float32.
//
// What bounds it on this card: the products, at the bf16 tensor-core rate
// (989 TFLOP/s dense; `mma.sync` reaches part of it), against K9's bytes:
// its float32 stash (16 bytes a point, hidden channel and layer, written
// once and read twice) and its weight-gradient partials (a float32 copy of
// every weight a block, read and written once a tile).
//
// The design. 8 warps a block; a tile of R rows (R = 4 P with tangents, P
// without), R the largest of 256, 128, 64, 32 whose buffers fit in shared
// memory (128 at width 256). Products are
// `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32`, one routine
// (`product`) for H W and C W^T:
//   * Row-kind layout (as K2-bf16): warp row group rw holds 8 points as two
//     m16 tiles, [primal; t_x] and [t_y; t_z]; the thread (g = lane / 4,
//     t = lane % 4) then holds point g's four rows at the same columns, so
//     the activation, and its backward, which need the primal row's sigmoid
//     for the tangent rows, stay in the thread. Without tangents rows are
//     points.
//   * Warps: R / 32 across the rows, the rest across the columns, 64
//     columns a warp (acc[2][8][4]); a pass covers 64 x 8 / (R / 32)
//     columns of a layer's output.
//   * Widths are padded to multiples of 16 with zeros (W -> wp, D = 3 + 6 F
//     -> dp, W + 1 -> op): the pack writes each layer as a zero-padded bf16
//     [Kp][Np] matrix, [h rows (wp); posenc rows (dp)] x Np; padding columns
//     of every staged row are written as zeros.
//   * Weights stream through shared memory in k-chunks of kc rows (64 where
//     it fits) by 16-byte `cp.async`, in a ring of 3 buffers where they fit
//     (K8 at width 256), else 2 (K9): the next chunks are in flight while
//     chunk i's products run, one barrier a chunk. A chunk is
//     [kc][pass + 8] (B fragments by `ldmatrix.trans`: W) or [pass][kc + 8]
//     (plain `ldmatrix`: W^T, the input cotangent): one layout of the pack
//     serves both.
//   * The tile's activation / cotangent rows are bf16 in shared memory, row
//     stride (columns + 8) so that the 8 rows of an ldmatrix phase fall in 8
//     distinct bank groups; the A fragments come from them by `ldmatrix`.
//   K8: one block a tile; layer by layer, pass by pass, the product, then
//       bias and activation into the other buffer; the output layer writes
//       sdf, feature and gradient.
//   K9: persistent blocks. Per tile: the forward again, each hidden layer's
//       [prim; raw tangents] (float32) into the block's stash in the
//       thread's own order (each warp store one coalesced 512-byte row);
//       then from the output layer down: the weight gradient H^T C on the
//       tensor cores (`weight_grad`: both operands by ldmatrix.trans from
//       the staged rows, contracting over the tile's R rows, added into the
//       block's float32 partial by the thread that owns each entry, its old
//       values loaded before the products), the input cotangent C W_h^T with
//       the activation backward from the stash (prefetched into L2 a pass
//       ahead, with the rows the rebuild reads; C_(l-1) in float32: its
//       primal rows' sums, by a fixed butterfly and the row groups in order,
//       are the bias gradient; then bf16), C W_pe^T into the posenc rows'
//       float32 cotangent, H_(l-2) rebuilt from the stash (the forward's
//       own arithmetic, so bitwise its bf16 rows); the posenc's reverse; the
//       points' gradient. A second launch sums the blocks' partials in
//       block order: no atomics, two launches bitwise equal.
// Bytes at 24 x 32,768, 8 x 256 (R = 128, 32 points a tile): partials 2.18
// MB x 2 a tile x 24,576 tiles = 107 GB a launch (the FMA form's 16-point
// tiles: 214 GB); stash 8 layers x 256 x 16 bytes a point, written once,
// read by the activation backward and, but for the last layer, by the
// rebuild = 74 GB, as in the FMA form: a float32 state the VJP reads,
// whatever the tile. Both counts are modelled (`chip_smoke.generic_traffic`). Both run near
// the memory rate; they, not the tensor cores, hold K9 (PERF.md).
//
// K8-bf16's wgmma form (`wg_form`: the width pads to 256, VolSDF's 8 x 256
// among them; every other width, and K8-nograd-bf16 and K9-bf16 at every
// width, keep the mma.sync form above). The mma.sync form stays at a tenth
// of the bf16 rate there: 8 warps an SM issuing m16n8k16 products one
// ldmatrix pair at a time, one barrier a weight chunk, and a block a tile
// of 32 points, so 8,192 blocks a render each stream all nine layers. The
// wgmma form computes the same function with the same rounding points:
//   * Blocks of 288 threads, one an SM, persistent over the tiles of 32
//     points: two consumer warpgroups of 64 rows (16 points x 4 kinds: row
//     16 (p / 4) + 4 q + p % 4 for point p's kind q) and a producer warp.
//   * Each hidden layer is one m64n256k16 wgmma a k-step of 16 (bf16
//     operands, float32 sums in 128 registers a thread); the output layer
//     adds an m64n16 product for columns 256 .. 271 (width 256). Both
//     operands are K-major under the 128-byte swizzle (`sw_off`): A is the
//     warpgroup's rows in shared memory, h (4 atoms of [64 rows][64 k]) and
//     the posenc rows (dp / 64 atoms, up); B is a weight chunk.
//   * The weights reach shared memory as chunk images: the pack writes,
//     after the [kp][np] layers, each layer's 64 reduction rows at a time as
//     the [np][64] swizzled image the ring holds, in the order the kernel
//     takes them. One producer lane streams them by `cp.async.bulk` into a
//     ring of up to 4 buffers (an mbarrier pair each: full, with the
//     copy's bytes; empty, one arrival a consumer warp), across tiles, so
//     the next tile's first chunks load while this tile's output layer
//     writes. Both warpgroups read each chunk: it serves the block's 128
//     rows, and a render reads ~9 GB of weights from L2.
//   * Each warpgroup starts a chunk's k-steps, commits, and releases the
//     previous chunk's buffer once `wgmma.wait_group 1` says it is read.
//     After a layer's last chunk the epilogue adds the bias and applies
//     the activation over the accumulators and writes h_l (bf16) over
//     h_(l-1) in place (a named barrier per warpgroup first; the
//     generic-to-async proxy fence after).
//   * sigma' stays float32: lanes g < 4 hold a point's primal and y-tangent
//     rows, lane ^ 16 the x- and z-tangent rows of the same point and
//     columns; of each column pair the primal lane takes the activation of
//     the first, its partner (sent the second primal by a shuffle) the
//     second, and two shuffles trade sigma and the activation back.
// What bounds it (PERF.md): registers. ptxas budgets a wgmma kernel by
// whole warpgroups, so 288 threads get 168 registers a thread (65,536 /
// 384), and the 128 float32 sums spill: the products run ~7x below the
// tensor rate, far from the L2 weight traffic's limit. A producer
// warpgroup that hands its registers to the consumers (`setmaxnreg`, 232
// a consumer thread) is the next step; then the L2 traffic (a 2-block
// cluster with TMA multicast would halve it) and the epilogue.

#include "fused_sdf_generic.cuh"

namespace {

constexpr int kWarps = kThreads / 32;

// ---------------------------------------------------------- fragment plumbing
// (warp-collective; tests/cuda_emu/ emulates the same functions on the CPU).
// No "memory" clobbers, as CUTLASS's: the asm statements keep their order
// (volatile), __syncthreads orders them against the other threads' shared
// stores, and a clobber would make the compiler reload every operand
// pointer and tile field from local memory after each ldmatrix (PERF.md).
#ifndef SCL_EMULATED
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ldmatrix .x4: matrix i takes its 8 row addresses (16 bytes each) from
// lanes 8 i .. 8 i + 7; lane (g, t) receives row g, columns 2 t and 2 t + 1
// of each, or with .trans rows 2 t and 2 t + 1 of column g.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, "
               "%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += A (16 x 16, row) B (16 x 8, col); A: a0 (row g, columns 2t, 2t + 1),
// a1 (row g + 8), a2 (row g, columns 2t + 8, 2t + 9), a3; B: b0 (rows 2t,
// 2t + 1, column g), b1 (rows 2t + 8, 2t + 9); c: c0, c1 (row g, columns
// 2t, 2t + 1), c2, c3 (row g + 8). Low halves hold the lower index.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
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

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// Two floats rounded to bf16, the first in the low half.
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return bf16_bits(lo) | (bf16_bits(hi) << 16);
}

// (softplus(100 p) / 100, sigmoid(100 p)) with the fast exp and division,
// for the forward's activations, which are only ever bf16 operands (the
// tangents scaled by sigma, then rounded). The softplus takes log1pf, as
// `act_pair`, so a small activation (p well below 0) keeps float32's relative
// precision, where log(1 + e) would lose e. K9 rebuilds its rows with the
// same function, and its activation backward takes the exact `act_pair`.
__device__ __forceinline__ void act_pair_fast(float prim, float& act,
                                              float& sig) {
  const float z = kBeta * prim;
  const float e = __expf(-fabsf(z));
  const float inv = __fdividef(1.f, 1.f + e);
  sig = z >= 0.f ? inv : 1.f - inv;
  act = (fmaxf(z, 0.f) + log1pf(e)) / kBeta;
}

// ------------------------------------------------------------------ tiling
__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }

struct Tile {
  int rows;       // R: 256, 128, 64 or 32
  int points;     // P: R / 4 with tangents, R without
  int row_warps;  // R / 32: warps across the rows
  int npass;      // columns of a pass: 64 x (8 / row_warps)
  int kc;         // reduction rows of a weight chunk: 64, 32 or 16
  int stages;     // chunk buffers: 3 where they fit, else 2
  int wp, dp, op; // W, D and W + 1 rounded up to 16
  int lda;        // row stride (bf16) of an activation / cotangent buffer
  int ldp;        // of the posenc rows: dp + 8
  int boff[kMaxHidden + 2];  // each layer's offset in the bf16 pack
};

// Layer l of the pack: [kp_h + kp_pe][np] bf16
__host__ __device__ inline int kp_h(const Tile& t, int l) {
  return l > 0 ? t.wp : 0;
}
__host__ __device__ inline int np_of(const Arch& a, const Tile& t, int l) {
  return l == a.n_hidden ? t.op : t.wp;
}

inline void make_layout(Tile* t, const Arch& a) {
  t->wp = round16(a.width);
  t->dp = round16(a.pe_dim);
  t->op = round16(a.width + 1);
  t->ldp = t->dp + 8;
  int off = 0;
  for (int l = 0; l <= a.n_hidden; ++l) {
    t->boff[l] = off;
    off += (kp_h(*t, l) + (layer_pe(a, l) ? t->dp : 0)) * np_of(a, *t, l);
  }
  t->boff[a.n_hidden + 1] = off;
}

// bf16 elements of one chunk buffer (K9 also stages W^T chunks)
__host__ __device__ inline int chunk_elems(const Tile& t, bool backward) {
  const int fwd = t.kc * (t.npass + 8), trans = t.npass * (t.kc + 8);
  return backward && trans > fwd ? trans : fwd;
}

// Shared memory of a block: two row buffers [R][lda] and the posenc rows
// [R][ldp] (bf16), the chunks, the x0 signs; K9 also the posenc rows'
// cotangent [P][dp][2] and the bias gradient's row-group sums [R/32][op]
// (float32).
inline int smem_bytes(const Arch& a, const Tile& t, bool backward) {
  const int R = t.rows, P = t.points;
  int bytes = 2 * (2 * R * t.lda + R * t.ldp +
                   t.stages * chunk_elems(t, backward));
  bytes += 4 * P;
  if (backward) bytes += 4 * (2 * P * t.dp + t.row_warps * t.op);
  return bytes;
}

// The largest tile, then the largest chunk, then the most chunk buffers
// that fit, or false.
inline bool make_tile(Tile* t, const Arch& a, bool grad, bool backward) {
  make_layout(t, a);
  t->lda = (backward ? t->op : t->wp) + 8;
  for (int rows = 256; rows >= 32; rows /= 2)
    for (int kc = 64; kc >= 16; kc /= 2)
      for (int stages = 3; stages >= 2; --stages) {
        t->rows = rows;
        t->points = grad ? rows / 4 : rows;
        t->row_warps = rows / 32;
        t->npass = 64 * (kWarps / t->row_warps);
        t->kc = kc;
        t->stages = stages;
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
  return a.n_hidden * npasses(t) * kWarps * 16 * 128;
}

// Layer l's [prim; t_x; t_y; t_z] of the thread's point at slot 2 nt + e
// of pass `pass` of `passes` (column pass n0 + 64 cw + 8 nt + 2 t + e).
__device__ __forceinline__ size_t stash_at(int passes, int l, int pass,
                                           int warp, int slot, int lane) {
  return ((((size_t)l * passes + pass) * kWarps + warp) * 16 + slot) * 128 +
         lane * 4;
}

// Row of point p's kind q (0 the primal, 1-3 the tangents along x, y, z)
// in a tile with tangents.
__device__ __forceinline__ int trow(int p, int q) {
  return (p >> 3) * 32 + q * 8 + (p & 7);
}

// ----------------------------------------------------------------- products
// One A operand of a product: `k` columns (a multiple of 16) of the bf16
// rows `a` [row][lda] in shared memory, and the weights that pair with them
// in global memory: B(k, n) = w[k ldw + n], or for a kTrans product
// w[n ldw + k].
struct Operand {
  const uint16_t* a;
  int lda, k;
  const uint16_t* w;
};

// acc[m][j] = this warp's 32 rows x 64 columns (from n0 + 64 cw) of
// sum over the operands of A B, zero past column nmax (a multiple of 16).
// Every thread of the block calls it: it opens with a barrier (the A rows
// written before are complete, the previous product is done with the
// chunks) and synchronises once a chunk; chunks i + 1 .. i + stages - 1
// are in flight while chunk i's products run (a group is committed for
// each, empty past the last chunk, so that the wait counts stay fixed).
template <bool kTrans>
__device__ void product(float (&acc)[2][8][4], const Tile& t,
                        const Operand* ops, int nops, int ldw, int n0,
                        int nmax, uint16_t* chunk, int celems) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
  // the operands and the tiling in registers
  const Operand o0 = ops[0], o1 = ops[nops > 1 ? 1 : 0];
  const int stages = t.stages, kc = t.kc, npass = t.npass;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rw = warp % t.row_warps, cw = warp / t.row_warps;
  const int cs = kTrans ? kc + 8 : npass + 8;
  const int nch0 = (o0.k + kc - 1) / kc;
  const int nch = nch0 + (nops > 1 ? (o1.k + kc - 1) / kc : 0);
  // chunk i: operand o, its rows k0 .. k0 + kl
  auto load = [&](int i, uint16_t* dst) {
    const bool second = i >= nch0;
    const Operand o = second ? o1 : o0;
    const int k0 = (second ? i - nch0 : i) * kc, kl = min(kc, o.k - k0);
    if (!kTrans) {
      const int per = npass / 8;
      for (int e = threadIdx.x; e < kl * per; e += kThreads) {
        const int r = e / per, c = (e % per) * 8;
        const bool ok = n0 + c < nmax;
        cp_async16(dst + r * cs + c,
                   o.w + (size_t)(k0 + r) * ldw + (ok ? n0 + c : 0), ok);
      }
    } else {
      const int per = kl / 8;
      for (int e = threadIdx.x; e < npass * per; e += kThreads) {
        const int r = e / per, c = (e % per) * 8;
        const bool ok = n0 + r < nmax;
        cp_async16(dst + r * cs + c,
                   o.w + (size_t)(ok ? n0 + r : 0) * ldw + k0 + c, ok);
      }
    }
  };
  const int wn0 = n0 + 64 * cw;  // this warp's first column
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
    const uint16_t* c = chunk + (i % stages) * celems;
#pragma unroll
    for (int ks = 0; ks < 64; ks += 16) {
      if (ks >= kl) break;
      uint32_t a[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
        ldsm4(a[m], o.a + (size_t)(rw * 32 + m * 16 + (lane & 15)) * o.lda +
                        k0 + ks + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (wn0 + 16 * np >= nmax) break;
        uint32_t b[4];
        if (!kTrans)
          ldsm4t(b, c + (ks + (lane & 15)) * cs + 64 * cw + 16 * np +
                        (lane >> 4) * 8);
        else
          ldsm4(b, c + (64 * cw + 16 * np + (lane >> 4) * 8 + (lane & 7)) * cs +
                       ks + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          mma16816(acc[m][2 * np], a[m], b[0], b[1]);
          mma16816(acc[m][2 * np + 1], a[m], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();  // the trailing groups are empty
}

// dk[k][n] += sum over the tile's rows of [h | posenc](r, k) cot(r, n) for
// layer l (dk: the block's partial of layer l's float32 weights, flax
// [K_l][N_l]): warp tiles of 32 x 64 entries, A = [h | posenc]^T and B = cot
// by ldmatrix.trans from the staged rows; each entry always added to by the
// same thread, its old value loaded before the products (two columns a
// float2 where N_l is even and the partial 8-byte aligned).
__device__ void weight_grad(const Arch& a, const Tile& t, int l,
                            const uint16_t* h, const uint16_t* pe,
                            const uint16_t* cot, float* dk) {
  const int W = a.width, D = a.pe_dim, Nl = layer_out(a, l);
  const int Kh = layer_h(a, l), khp = kp_h(t, l);
  const bool has_pe = layer_pe(a, l);
  const bool pairs =
      Nl % 2 == 0 && (reinterpret_cast<uintptr_t>(dk) & 7) == 0;
  const int Kp = khp + (has_pe ? t.dp : 0), Np = np_of(a, t, l);
  const int nkt = (Kp + 31) / 32, nnt = (Np + 63) / 64;
  const int rows = t.rows, lda = t.lda, ldp = t.ldp;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  for (int wt = warp; wt < nkt * nnt; wt += kWarps) {
    const int kb = (wt / nnt) * 32, nb = (wt % nnt) * 64 + 2 * tq;
    // this thread's entries: rows kb + 16 m + 8 hf + g (their flax row
    // offsets, or -1 for padding) x columns nb + 8 j + e
    int ro[2][2];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int k = kb + 16 * m + 8 * hf + g, d = k - khp;
        const int kr = k < khp ? (k < W ? k : -1)
                               : (has_pe && d < D ? Kh + d : -1);
        ro[m][hf] = kr >= 0 ? kr * Nl : -1;
      }
    float old[2][8][4], acc[2][8][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int n = nb + 8 * j, r = ro[m][hf];
          float2 v = make_float2(0.f, 0.f);
          if (r >= 0 && n < Nl) {
            if (pairs) {
              v = *reinterpret_cast<const float2*>(dk + r + n);
            } else {
              v.x = dk[r + n];
              if (n + 1 < Nl) v.y = dk[r + n + 1];
            }
          }
          old[m][j][2 * hf] = v.x;
          old[m][j][2 * hf + 1] = v.y;
          acc[m][j][2 * hf] = acc[m][j][2 * hf + 1] = 0.f;
        }
    for (int r = 0; r < rows; r += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int k = kb + 16 * m;
        if (k >= Kp) break;
        const uint16_t* src = k < khp ? h + k : pe + (k - khp);
        const int ld = k < khp ? lda : ldp;
        ldsm4t(af[m], src + (size_t)(r + (lane >> 4) * 8 + (lane & 7)) * ld +
                          ((lane >> 3) & 1) * 8);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (nb - 2 * tq + 16 * np >= Np) break;
        uint32_t b[4];
        ldsm4t(b, cot + (size_t)(r + (lane & 15)) * lda + nb - 2 * tq +
                      16 * np + (lane >> 4) * 8);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          if (kb + 16 * m >= Kp) break;
          mma16816(acc[m][2 * np], af[m], b[0], b[1]);
          mma16816(acc[m][2 * np + 1], af[m], b[2], b[3]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int n = nb + 8 * j, r = ro[m][hf];
          if (r < 0 || n >= Nl) continue;
          const float x = old[m][j][2 * hf] + acc[m][j][2 * hf];
          const float y = old[m][j][2 * hf + 1] + acc[m][j][2 * hf + 1];
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
// The tile's posenc rows (bf16, [R][ldp], zero past D) and the x0 signs;
// with tangents the tangent row along coordinate q holds dpe where feature
// d reads coordinate q, else 0.
template <bool kGrad>
__device__ void build_posenc(const Arch& a, const Tile& t,
                             const float* points, int b, int N, int n0,
                             int force_symmetry, uint16_t* pe, float* sign) {
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
      pe[(size_t)trow(p, 0) * t.ldp + d] = bf16_bits(v);
      for (int q = 0; q < 3; ++q)
        pe[(size_t)trow(p, q + 1) * t.ldp + d] =
            q == coord ? bf16_bits(dv) : 0;
    } else {
      pe[(size_t)p * t.ldp + d] = bf16_bits(v);
    }
  }
  for (int p = threadIdx.x; p < P; p += kThreads) {
    const int n = n0 + p;
    const float x0 = n < N ? points[((size_t)b * N + n) * 3] : 0.f;
    sign[p] = (force_symmetry && x0 < 0.f) ? -1.f : 1.f;
  }
}

// The hidden layers 0 .. L-1 of a tile: h_l = act(layer l of [h_(l-1);
// posenc]) (bf16) into the other buffer, each layer's float32 [prim; raw
// tangents] into `stash` (`stash_at`) when given. Returns the buffer that
// holds h_(L-1).
template <bool kGrad>
__device__ uint16_t* forward_hidden(const Arch& a, const Tile& t,
                                    const uint16_t* wts, const float* bias_row,
                                    uint16_t* hin, uint16_t* hout,
                                    const uint16_t* pe, uint16_t* chunk,
                                    int celems, float* stash) {
  const int W = a.width;
  const int lda = t.lda, ldp = t.ldp, wp = t.wp, dp = t.dp;
  const int npass = t.npass, passes = npasses(t);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int rw = warp % t.row_warps, cw = warp / t.row_warps;
  for (int l = 0; l < a.n_hidden; ++l) {
    const uint16_t* w = wts + t.boff[l];
    Operand ops[2];
    int nops = 0;
    if (l > 0) ops[nops++] = Operand{hin, lda, wp, w};
    if (layer_pe(a, l))
      ops[nops++] =
          Operand{pe, ldp, dp, w + (size_t)kp_h(t, l) * wp};
    const float* bias = bias_row + l * W;
    for (int pass = 0; pass < passes; ++pass) {
      const int n0 = pass * npass;
      float acc[2][8][4];
      product<false>(acc, t, ops, nops, wp, n0, wp, chunk, celems);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int n = n0 + 64 * cw + 8 * nt + 2 * tq;
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
              act_pair_fast(prim, act, sig);
              if (stash)
                *reinterpret_cast<float4*>(
                    stash + stash_at(passes, l, pass, warp, 2 * nt + e,
                                     lane)) =
                    make_float4(prim, tx, ty, tz);
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
            *reinterpret_cast<uint32_t*>(hout + (size_t)trow(p, q) * lda +
                                         n) = pack2(o[q][0], o[q][1]);
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
                  act_pair_fast(acc[m][nt][2 * half + e] + bias[c], o[e],
                                sig);
              }
              const int row = rw * 32 + m * 16 + 8 * half + g;
              *reinterpret_cast<uint32_t*>(hout + (size_t)row * lda + n) =
                  pack2(o[0], o[1]);
            }
        }
      }
    }
    uint16_t* tmp = hin;
    hin = hout;
    hout = tmp;
  }
  return hin;
}

// K8-bf16 (with tangents) and K8-nograd-bf16: one block a tile.
template <bool kGrad>
__global__ void __launch_bounds__(kThreads, 1)
    sdf_generic_fwd_bf16_kernel(const float* __restrict__ points,
                                const uint16_t* __restrict__ wts,
                                const float* __restrict__ biases,
                                float* __restrict__ sdf,
                                float* __restrict__ feat,
                                float* __restrict__ grad, int N,
                                int force_symmetry, Arch a, Tile t) {
  extern __shared__ __align__(16) float smem[];
  const int celems = chunk_elems(t, false);
  uint16_t* buf0 = reinterpret_cast<uint16_t*>(smem);
  uint16_t* buf1 = buf0 + (size_t)t.rows * t.lda;
  uint16_t* pe = buf1 + (size_t)t.rows * t.lda;
  uint16_t* chunk = pe + (size_t)t.rows * t.ldp;
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
  const uint16_t* h = forward_hidden<kGrad>(a, t, wts, bias_row, buf0, buf1,
                                            pe, chunk, celems, nullptr);
  // the output layer: [sdf | feature] on the primal rows, the gradient from
  // the tangent rows' sdf column
  const uint16_t* w = wts + t.boff[L];
  Operand ops[2];
  int nops = 0;
  ops[nops++] = Operand{h, t.lda, t.wp, w};
  if (layer_pe(a, L))
    ops[nops++] = Operand{pe, t.ldp, t.dp, w + (size_t)t.wp * t.op};
  const float* bias = bias_row + L * W;
  for (int n0 = 0; n0 < t.op; n0 += t.npass) {
    float acc[2][8][4];
    product<false>(acc, t, ops, nops, t.op, n0, t.op, chunk, celems);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = n0 + 64 * cw + 8 * nt + 2 * tq + e;
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
// K9-bf16: persistent blocks over the tiles; the block's slices: part
// [num_weights + B bias_width] (d weights, then d biases) and stash
// [stash_floats].
__global__ void __launch_bounds__(kThreads, 1)
    sdf_generic_bwd_bf16_kernel(const float* __restrict__ points,
                                const uint16_t* __restrict__ wts,
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
  uint16_t* bufa = reinterpret_cast<uint16_t*>(smem);
  uint16_t* bufb = bufa + (size_t)t.rows * lda;
  uint16_t* pe = bufb + (size_t)t.rows * lda;
  uint16_t* chunk = pe + (size_t)t.rows * t.ldp;
  float* gt = reinterpret_cast<float*>(chunk + t.stages * celems);
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
    uint16_t* h = forward_hidden<true>(a, t, wts, bias_row, bufa, bufb, pe,
                                       chunk, celems, stash);
    uint16_t* cot = h == bufa ? bufb : bufa;
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
      for (int q = 0; q < 4; ++q)
        cot[(size_t)trow(p, q) * lda + c] = bf16_bits(v[q]);
    }
    // its bias gradient: the float32 [sdf_bar | feat_bar] over the points
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
      const uint16_t* w = wts + t.boff[l];
      __syncthreads();  // cot and h are complete
      weight_grad(a, t, l, h, pe, cot, dk + a.woff[l]);
      if (l > 0) {
        // C_(l-1) = act'(C_l W_h^T) into h's buffer; product() opens with a
        // barrier, so every warp is done with h first
        const Operand o{cot, lda, Np, w};
        for (int pass = 0; pass < passes; ++pass) {
          const int n0 = pass * npass;
          // this pass's stash of layers l - 1 (its epilogue) and l - 2 (the
          // rebuild below) into L2 while the products run: 64 KB each
          for (int i = threadIdx.x; i < 2 * kWarps * 16 * 4; i += kThreads) {
            const int layer = l - 1 - i / (kWarps * 16 * 4);
            if (layer >= 0)
              prefetch_l2(stash + stash_at(passes, layer, pass, 0, 0, 0) +
                          32 * (i % (kWarps * 16 * 4)));
          }
          float acc[2][8][4];
          product<true>(acc, t, &o, 1, Np, n0, wp, chunk, celems);
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const int n = n0 + 64 * cw + 8 * nt + 2 * tq;
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
              *reinterpret_cast<uint32_t*>(h + (size_t)trow(p, q) * lda +
                                           n) = pack2(v[q][0], v[q][1]);
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
          float acc[2][8][4];
          product<true>(acc, t, &o, 1, Np, n0, dp, chunk, celems);
          const int p = 8 * rw + g;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int d = n0 + 64 * cw + 8 * nt + 2 * tq + e;
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
          for (int nt = 0; nt < 8; ++nt) {
            const int n = pass * npass + 64 * cw + 8 * nt + 2 * tq;
            if (n >= wp) break;
            float v[4][2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (n + e < W) {
                const float4 s4 = *reinterpret_cast<const float4*>(
                    stash +
                    stash_at(passes, l - 2, pass, warp, 2 * nt + e, lane));
                float act, sig;
                act_pair_fast(s4.x, act, sig);
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
              *reinterpret_cast<uint32_t*>(cot + (size_t)trow(p, q) * lda +
                                           n) = pack2(v[q][0], v[q][1]);
          }
      }
      uint16_t* tmp = cot;  // C_(l-1) is in h now, h_(l-2) in cot
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

// ------------------------------------------------------ K8-bf16 on wgmma
// K8-bf16's form for padded width 256 (the note at the head of the file):
// two consumer warpgroups of 64 rows (16 points x 4 kinds) and a producer
// warp a block, one block an SM, walking the tiles of 32 points.
constexpr int kWgN = 256;            // the padded width the form takes
constexpr int kWgPoints = 32;        // a block's tile: two warpgroups
constexpr int kWgThreads = 288;      // two warpgroups and the producer
constexpr int kAtom = 64 * 64;       // bf16 of a [64 rows][64 k] atom
constexpr int kWgMaxStages = 4;
constexpr int kWgConsumerWarps = 8;  // each releases a ring buffer

struct WgTile {
  int stages;       // chunk buffers of the ring
  int npe;          // posenc atoms of a warpgroup's rows: dp / 64, up
  int stage_bytes;  // a chunk buffer: the largest chunk image, op x 128
};

// Does K8-bf16 take the wgmma form? For a width that pads to 256: one
// m64n256 product covers a hidden layer's columns, so its float32 sums fit
// the registers and a weight chunk serves 128 rows (PERF.md measured this
// width alone; every other width keeps the mma.sync form).
__host__ __device__ inline bool wg_form(const Arch& a) {
  return round16(a.width) == kWgN;
}

// Chunks of layer l: 64 reduction rows each, the h rows (wp / 64), then
// the posenc rows (dp / 64, up) of layer 0 and the skip layers.
__host__ __device__ inline int wg_chunks(const Arch& a, const Tile& t,
                                         int l) {
  return (l > 0 ? t.wp / 64 : 0) + (layer_pe(a, l) ? (t.dp + 63) / 64 : 0);
}

// bf16 of layer l's chunk images: each [np][64] (`sw_off`).
__host__ __device__ inline int wg_layer_elems(const Arch& a, const Tile& t,
                                              int l) {
  return wg_chunks(a, t, l) * np_of(a, t, l) * 64;
}

// bf16 of the whole pack: the [kp][np] layers of every bf16 form, then,
// where K8-bf16 takes the wgmma form, each layer's chunk images.
__host__ __device__ inline int packed_elems(const Arch& a, const Tile& t) {
  int n = t.boff[a.n_hidden + 1];
  if (wg_form(a))
    for (int l = 0; l <= a.n_hidden; ++l) n += wg_layer_elems(a, t, l);
  return n;
}

inline int wg_smem_bytes(const WgTile& w) {
  return 1024 + w.stages * w.stage_bytes +
         2 * (kWgN / 64 + w.npe) * kAtom * 2 + 2 * w.stages * 8;
}

// The ring's depth: the most buffers, up to 4, that fit beside the two
// warpgroups' rows, or false where the form does not apply.
inline bool make_wg(WgTile* w, const Arch& a, const Tile& t) {
  if (!wg_form(a)) return false;
  w->npe = (t.dp + 63) / 64;
  w->stage_bytes = t.op * 128;
  for (int s = kWgMaxStages; s >= 2; --s) {
    w->stages = s;
    if (wg_smem_bytes(*w) <= kSmemLimit) return true;
  }
  return false;
}

// bf16 offset of (row, k) in a K-major operand of 128-byte rows under
// wgmma's 128-byte swizzle: atom k / 64 of [64 rows][64 k] (a chunk image:
// [np][64]), its 16-byte chunk k % 64 / 8 XOR row % 8. The buffers start
// 1024-aligned, so this is the hardware's address swizzle (bits 4-6 XOR
// bits 7-9).
__host__ __device__ __forceinline__ int sw_off(int row, int k) {
  return (k >> 6) * kAtom + row * 64 + ((((k >> 3) & 7) ^ (row & 7)) << 3) +
         (k & 7);
}

// A shared-memory matrix descriptor of a K-major bf16 operand under the
// 128-byte swizzle at shared address `addr`: start address >> 4 (bits
// 0-13), leading offset 1 (unused by swizzled K-major operands), 1024
// bytes between 8-row groups (bits 32-45), swizzle mode 1 (bits 62-63). A
// k-step of 16 adds 2 (32 bytes) to the start.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3fff) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

#ifndef SCL_EMULATED
// wgmma, mbarriers and the bulk copy (tests/cuda_emu/ emulates them on the
// CPU under the same names).
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Arrives and expects `bytes` more of asynchronous copies in this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
}

// `bytes` (a multiple of 16) from global to shared memory by the copy
// engine, completing on `bar`'s transaction count.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N of the warpgroup's committed groups are in flight.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The generic proxy's shared stores before it, visible to wgmma's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The 128 threads of warpgroup `id - 1` meet (named barrier `id`).
__device__ __forceinline__ void wg_bar(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// The accumulators as the compiler must see them around the asynchronous
// products: written here, so no read moves above a wait nor a write below
// a product's start.
template <int N>
__device__ __forceinline__ void wg_keep(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A B over one k-step of 16: A the 64 x 16 K-major rows at `da`, B
// the 16 x N (N-row K-major image) at `db`, both in shared memory;
// `accumulate` 0 overwrites d. Thread (warp w of the warpgroup, g = lane /
// 4, t = lane % 4) holds rows 16 w + g (d[4 j], d[4 j + 1]) and 16 w + g + 8
// (d[4 j + 2], d[4 j + 3]) at columns 8 j + 2 t, 8 j + 2 t + 1.
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_n16(float (&d)[8], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(accumulate));
}
#endif

// A warpgroup's posenc rows: its 16 points from p0, point p's kind q
// (0 the primal, 1-3 the tangents along x, y, z) at row 16 (p / 4) + 4 q +
// p % 4, columns 0 .. dp - 1 (zero past D); values as `build_posenc`.
__device__ void wg_posenc(const Arch& a, const Tile& t, const float* points,
                          int b, int N, int p0, int force_symmetry,
                          uint16_t* pe) {
  const int D = a.pe_dim, dp = t.dp;
  for (int e = threadIdx.x & 127; e < 16 * dp; e += 128) {
    const int p = e / dp, d = e % dp, n = p0 + p;
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
    const int row = 16 * (p >> 2) + (p & 3);
    pe[sw_off(row, d)] = bf16_bits(v);
    for (int q = 0; q < 3; ++q)
      pe[sw_off(row + 4 * (q + 1), d)] = q == coord ? bf16_bits(dv) : 0;
  }
}

// K8-bf16's wgmma form (with tangents): persistent blocks over the tiles
// of 32 points. `img` is the pack's chunk images (`packed_elems`).
__global__ void __launch_bounds__(kWgThreads, 1)
    sdf_generic_fwd_bf16_kernel(const float* __restrict__ points,
                                const uint16_t* __restrict__ img,
                                const float* __restrict__ biases,
                                float* __restrict__ sdf,
                                float* __restrict__ feat,
                                float* __restrict__ grad, int B, int N,
                                int force_symmetry, Arch a, Tile t,
                                WgTile w) {
  extern __shared__ __align__(16) float smem[];
  const uint32_t base = smem_u32(smem);
  char* ring = reinterpret_cast<char*>(smem) +
               (((base + 1023u) & ~1023u) - base);
  const int wg_elems = (kWgN / 64 + w.npe) * kAtom;
  uint16_t* rows = reinterpret_cast<uint16_t*>(ring + w.stages *
                                               w.stage_bytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(rows + 2 * wg_elems);
  uint64_t* empty = full + w.stages;
  const int L = a.n_hidden, W = a.width;
  const int tiles_per_batch = (N + kWgPoints - 1) / kWgPoints;
  const int tiles = B * tiles_per_batch;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < w.stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kWgConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kWgConsumerWarps) {
    // the producer: one lane streams each tile's chunk images, in the
    // order the warpgroups take them, through the ring
    if (lane == 0) {
      int stage = 0, phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const uint16_t* src = img;
        for (int l = 0; l <= L; ++l) {
          const int bytes = np_of(a, t, l) * 128;
          for (int c = wg_chunks(a, t, l); c > 0; --c) {
            mbar_wait(empty + stage, phase ^ 1);
            mbar_expect_tx(full + stage, bytes);
            bulk_g2s(ring + stage * w.stage_bytes, src, bytes, full + stage);
            src += bytes / 2;
            if (++stage == w.stages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg takes points 16 wg .. 16 wg + 15 of each
  // tile; its lanes with g < 4 hold point g % 4's primal and y-tangent
  // rows, their partners (lane ^ 16) its x- and z-tangent rows
  const int wg = warp >> 2, wq = warp & 3;
  const int g = lane >> 2, tq = lane & 3;
  const bool prim_lane = g < 4;
  const int pw = 4 * wq + (g & 3);
  const int r_lo = 16 * wq + g, r_hi = r_lo + 8;
  uint16_t* h = rows + wg * wg_elems;
  uint16_t* pe = h + (kWgN / 64) * kAtom;
  const uint64_t hdesc = wg_desc(smem_u32(h));
  const uint64_t pedesc = wg_desc(smem_u32(pe));
  const uint32_t ring_addr = smem_u32(ring);
  const int nh = t.wp / 64;
  int stage = 0, phase = 0;
  float d[128], d16[8];
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b = tile / tiles_per_batch;
    const int p0 = (tile % tiles_per_batch) * kWgPoints + 16 * wg;
    const float* bias_row = biases + (size_t)b * a.bias_width;
    wg_posenc(a, t, points, b, N, p0, force_symmetry, pe);
    fence_async_smem();
    wg_bar(1 + wg);
    for (int l = 0; l <= L; ++l) {
      const bool last = l == L;
      const bool wide = last && t.op > kWgN;  // columns 256 .. op - 1
      const int hch = l > 0 ? nh : 0, nch = wg_chunks(a, t, l);
      wg_keep(d);
      wg_keep(d16);
      wg_fence();
      int prev = 0;
      for (int c = 0; c < nch; ++c) {
        mbar_wait(full + stage, phase);
        const bool on_h = c < hch;
        const int k0 = (on_h ? c : c - hch) * 64;
        const int ksteps = (min(64, (on_h ? t.wp : t.dp) - k0)) / 16;
        // atom k0 / 64: 8192 bytes, 512 in the descriptor's units
        const uint64_t da = (on_h ? hdesc : pedesc) + (uint64_t)(k0 * 8);
        const uint64_t db = wg_desc(ring_addr + stage * w.stage_bytes);
        for (int ks = 0; ks < ksteps; ++ks) {
          const int acc = c > 0 || ks > 0;
          wgmma_n256(d, da + 2 * ks, db + 2 * ks, acc);
          if (wide) wgmma_n16(d16, da + 2 * ks, db + kWgN * 8 + 2 * ks, acc);
        }
        wg_commit();
        if (c > 0) {
          wg_wait<1>();  // chunk c - 1's products are done with its buffer
          if (lane == 0) mbar_arrive(empty + prev);
        }
        prev = stage;
        if (++stage == w.stages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wg_wait<0>();
      wg_keep(d);
      wg_keep(d16);
      if (lane == 0) mbar_arrive(empty + prev);
      wg_bar(1 + wg);  // every warp's products are done with h
      if (!last) {
        // h_l = act(prim) and the tangents times sigma(100 prim), bf16,
        // over h_(l-1): each lane pair splits the activations of its two
        // columns (the primal lane c, its partner c + 1) by shuffles
        const float* bias = bias_row + l * W;
#pragma unroll
        for (int j = 0; j < kWgN / 8; ++j) {
          const int c0 = 8 * j + 2 * tq;
          float v0 = d[4 * j], v1 = d[4 * j + 1];
          const float u0 = d[4 * j + 2], u1 = d[4 * j + 3];
          if (prim_lane) {
            if (c0 < W) v0 += bias[c0];
            if (c0 + 1 < W) v1 += bias[c0 + 1];
          }
          const float sent = __shfl_xor_sync(0xffffffffu, v1, 16);
          float act = 0.f, sig = 0.f;
          if ((prim_lane ? c0 : c0 + 1) < W)
            act_pair_fast(prim_lane ? v0 : sent, act, sig);
          const float sig_o = __shfl_xor_sync(0xffffffffu, sig, 16);
          const float act_o = __shfl_xor_sync(0xffffffffu, act, 16);
          const float s0 = prim_lane ? sig : sig_o;
          const float s1 = prim_lane ? sig_o : sig;
          *reinterpret_cast<uint32_t*>(h + sw_off(r_lo, c0)) =
              prim_lane ? pack2(act, act_o) : pack2(v0 * s0, v1 * s1);
          *reinterpret_cast<uint32_t*>(h + sw_off(r_hi, c0)) =
              pack2(u0 * s0, u1 * s1);
        }
        fence_async_smem();
        wg_bar(1 + wg);
      } else {
        // [sdf | feature] from the primal rows, the gradient from the
        // tangent rows' sdf column
        const int n = p0 + pw;
        if (n < N) {
          const size_t pn = (size_t)b * N + n;
          const float* bias = bias_row + L * W;
          float sign = 1.f;
          if (!prim_lane && force_symmetry && points[pn * 3] < 0.f)
            sign = -1.f;
#pragma unroll
          for (int j = 0; j < kWgN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = 8 * j + 2 * tq + e;
              if (c > W) continue;
              if (prim_lane) {
                const float prim = d[4 * j + e] + bias[c];
                if (c == 0) {
                  sdf[pn] = prim;
                  grad[pn * 3 + 1] = d[4 * j + 2 + e];
                } else {
                  feat[pn * W + c - 1] = prim;
                }
              } else if (c == 0) {
                grad[pn * 3] = d[4 * j + e] * sign;
                grad[pn * 3 + 2] = d[4 * j + 2 + e];
              }
            }
          if (wide && prim_lane)
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int c = kWgN + 8 * j + 2 * tq + e;
                if (c <= W) feat[pn * W + c - 1] = d16[4 * j + e] + bias[c];
              }
        }
      }
    }
  }
}

// The pack: the packed float32 weights -> each layer as a zero-padded bf16
// [kp_h + kp_pe][np] matrix (rows: h, then posenc); then, where K8-bf16
// takes the wgmma form, each layer's chunk images: chunk c of layer l holds
// reduction rows 64 c' .. 64 c' + 63 of its operand (h, then posenc; zero
// past wp / dp) as the [np][64] K-major image that the ring receives
// (`sw_off`), the layers' chunks in the order the kernel takes them.
__global__ void sdf_generic_pack_bf16_kernel(const float* __restrict__ w,
                                             uint16_t* __restrict__ out,
                                             Arch a, Tile t) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int nl = t.boff[a.n_hidden + 1];
  if (i >= packed_elems(a, t)) return;
  int l = 0, k, n;
  if (i < nl) {
    while (i >= t.boff[l + 1]) ++l;
    const int Np = np_of(a, t, l);
    k = (i - t.boff[l]) / Np;
    n = (i - t.boff[l]) % Np;
  } else {
    int j = i - nl;
    while (j >= wg_layer_elems(a, t, l)) j -= wg_layer_elems(a, t, l++);
    const int Np = np_of(a, t, l), hch = l > 0 ? t.wp / 64 : 0;
    const int c = j / (Np * 64), r = j % (Np * 64), pos = r % 64;
    n = r / 64;
    const int kk = ((((pos >> 3) ^ n) & 7) << 3) | (pos & 7);
    const bool on_h = c < hch;
    const int kop = (on_h ? c : c - hch) * 64 + kk;
    if (kop >= (on_h ? t.wp : t.dp)) {
      out[i] = 0;
      return;
    }
    k = on_h ? kop : kp_h(t, l) + kop;
  }
  const int khp = kp_h(t, l), Nl = layer_out(a, l);
  int kr = -1;
  if (n < Nl) {
    if (k < khp)
      kr = k < a.width ? k : -1;
    else if (k - khp < a.pe_dim)
      kr = layer_h(a, l) + k - khp;
  }
  out[i] = kr >= 0 ? bf16_bits(w[a.woff[l] + (size_t)kr * Nl + n]) : 0;
}

}  // namespace

// ---------------------------------------------------------------- C entry

namespace {

bool arch_tile(Arch* a, Tile* t, int f, int l, int w, int m, bool grad,
               bool backward) {
  return make_arch(a, f, l, w, m) && make_tile(t, *a, grad, backward);
}

// The SMs of the current device (K8-bf16's wgmma form: one block each),
// or 0 if the runtime cannot say.
int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
}

// K8-bf16's wgmma form: a block an SM (at most one a tile), reading the
// pack's chunk images.
int wg_fwd(const float* points, const uint16_t* wts, const float* biases,
           float* sdf, float* feat, float* grad, int B, int N,
           int force_symmetry, const Arch& a, const Tile& t,
           const WgTile& wt, cudaStream_t s) {
  const long long tiles = (long long)B * ((N + kWgPoints - 1) / kWgPoints);
  const int sms = sm_count();
  if (tiles > 0x7fffffffLL || sms <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = wg_smem_bytes(wt);
  void (*kernel)(const float*, const uint16_t*, const float*, float*, float*,
                 float*, int, int, int, Arch, Tile, WgTile) =
      sdf_generic_fwd_bf16_kernel;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  sdf_generic_fwd_bf16_kernel<<<(int)(tiles < sms ? tiles : sms), kWgThreads,
                                smem, s>>>(points,
                                           wts + t.boff[a.n_hidden + 1],
                                           biases, sdf, feat, grad, B, N,
                                           force_symmetry, a, t, wt);
  return (int)cudaGetLastError();
}

}  // namespace

int sdf_generic_bf16_packed(int f, int l, int w, int m) {
  Arch a;
  Tile t;
  if (!make_arch(&a, f, l, w, m)) return -1;
  make_layout(&t, a);
  return packed_elems(a, t);
}

int sdf_generic_bf16_fwd_form(int f, int l, int w, int m, bool grad) {
  Arch a;
  Tile t;
  WgTile wt;
  if (!make_arch(&a, f, l, w, m)) return -1;
  make_layout(&t, a);
  return grad && make_wg(&wt, a, t) ? 1 : 0;
}

int sdf_generic_bf16_tile_points(int f, int l, int w, int m, bool grad,
                                 bool backward) {
  Arch a;
  Tile t;
  return arch_tile(&a, &t, f, l, w, m, grad, backward) ? t.points : -1;
}

int sdf_generic_bf16_stash_floats(int f, int l, int w, int m) {
  Arch a;
  Tile t;
  return arch_tile(&a, &t, f, l, w, m, true, true) ? stash_floats(a, t) : -1;
}

int sdf_generic_bf16_bwd_blocks_per_sm(int f, int l, int w, int m) {
  Arch a;
  Tile t;
  if (!arch_tile(&a, &t, f, l, w, m, true, true)) return -1;
  const size_t smem = smem_bytes(a, t, true);
  int blocks = 0;
  cudaError_t err = allow_smem(sdf_generic_bwd_bf16_kernel, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, sdf_generic_bwd_bf16_kernel, kThreads, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

int sdf_generic_bf16_pack(const float* weights, void* packed, int f, int l,
                          int w, int m, cudaStream_t s) {
  Arch a;
  Tile t;
  if (!make_arch(&a, f, l, w, m)) return (int)cudaErrorInvalidValue;
  make_layout(&t, a);
  const int n = packed_elems(a, t);
  sdf_generic_pack_bf16_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                                 s>>>(weights, static_cast<uint16_t*>(packed),
                                      a, t);
  return (int)cudaGetLastError();
}

int sdf_generic_bf16_fwd(const float* points, const void* packed,
                         const float* biases, float* sdf, float* feat,
                         float* grad, int B, int N, bool compute_grad,
                         int force_symmetry, int f, int l, int w, int m,
                         cudaStream_t s) {
  Arch a;
  Tile t{};
  WgTile wt;
  if (B <= 0 || N <= 0 || !make_arch(&a, f, l, w, m))
    return (int)cudaErrorInvalidValue;
  make_layout(&t, a);
  if (compute_grad && make_wg(&wt, a, t))
    return wg_fwd(points, static_cast<const uint16_t*>(packed), biases, sdf,
                  feat, grad, B, N, force_symmetry, a, t, wt, s);
  if (!make_tile(&t, a, compute_grad, false))
    return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)B * ((N + t.points - 1) / t.points);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(a, t, false);
  const uint16_t* wts = static_cast<const uint16_t*>(packed);
  cudaError_t err;
#define SCL_FWD(G)                                                        \
  err = allow_smem(sdf_generic_fwd_bf16_kernel<G>, smem);                 \
  if (err != cudaSuccess) return (int)err;                                \
  sdf_generic_fwd_bf16_kernel<G><<<(int)tiles, kThreads, smem, s>>>(      \
      points, wts, biases, sdf, feat, grad, N, force_symmetry, a, t);
  if (compute_grad) {
    SCL_FWD(true)
  } else {
    SCL_FWD(false)
  }
#undef SCL_FWD
  return (int)cudaGetLastError();
}

int sdf_generic_bf16_bwd(const float* points, const void* packed,
                         const float* biases, const float* sbar,
                         const float* fbar, const float* gbar, float* dpoints,
                         float* out, float* partials, float* stash, int B,
                         int N, int grid, int force_symmetry, int f, int l,
                         int w, int m, cudaStream_t s) {
  Arch a;
  Tile t;
  if (B <= 0 || N <= 0 || grid <= 0 ||
      !arch_tile(&a, &t, f, l, w, m, true, true))
    return (int)cudaErrorInvalidValue;
  if ((long long)B * ((N + t.points - 1) / t.points) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(a, t, true);
  cudaError_t err = allow_smem(sdf_generic_bwd_bf16_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  sdf_generic_bwd_bf16_kernel<<<grid, kThreads, smem, s>>>(
      points, static_cast<const uint16_t*>(packed), biases, sbar, fbar, gbar,
      dpoints, partials, stash, B, N, force_symmetry, a, t);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)a.num_weights + (size_t)B * a.bias_width;
  sum_partials_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      partials, out, n, grid);
  return (int)cudaGetLastError();
}
