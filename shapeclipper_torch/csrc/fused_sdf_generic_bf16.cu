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

// The pack: the packed float32 weights -> each layer as a zero-padded bf16
// [kp_h + kp_pe][np] matrix (rows: h, then posenc).
__global__ void sdf_generic_pack_bf16_kernel(const float* __restrict__ w,
                                             uint16_t* __restrict__ out,
                                             Arch a, Tile t) {
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
  out[i] = kr >= 0 ? bf16_bits(w[a.woff[l] + (size_t)kr * Nl + n]) : 0;
}

}  // namespace

// ---------------------------------------------------------------- C entry

namespace {

bool arch_tile(Arch* a, Tile* t, int f, int l, int w, int m, bool grad,
               bool backward) {
  return make_arch(a, f, l, w, m) && make_tile(t, *a, grad, backward);
}

}  // namespace

int sdf_generic_bf16_packed(int f, int l, int w, int m) {
  Arch a;
  Tile t;
  if (!make_arch(&a, f, l, w, m)) return -1;
  make_layout(&t, a);
  return t.boff[a.n_hidden + 1];
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
  const int n = t.boff[a.n_hidden + 1];
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
  Tile t;
  if (B <= 0 || N <= 0 ||
      !arch_tile(&a, &t, f, l, w, m, compute_grad, false))
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
