// Architecture-generic fused SDF-MLP pair for Hopper (sm_90a): K8, the
// forward with or without forward-mode point tangents, and K9, its
// hand-derived VJP, for every SDF MLP of `models/implicit.py::SDFNetwork`
// (weight_norm off) inside the envelope below. The flagship architecture
// (posenc 6, skips {1, 2}, 5 hidden x 64) keeps its tuned kernels,
// `fused_sdf_fwd.cu` (K1 / K3), `fused_sdf_bwd.cu` (K2) and
// `fused_sdf_bwd_bf16.cu` (K2-bf16); `ops/fused_sdf.py::sdf_route` sends
// every other architecture here.
//
// Replaces the Pallas TPU kernels `shapeclipper_tpu/ops/fused_sdf.py::
// _forward_call` (the `pl.pallas_call` at line 311) and `_backward_call`
// (line 617) under any `cfg = (n_freqs, skip_in, n_hidden, ...)` and any
// widths of their weights, with float32 or bf16 products (`_mm_cast`).
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
// bf16 (`mm_dtype="bfloat16"`): every product's operands are rounded to
// bfloat16 (nearest even) where they are staged -- the activation rows, the
// posenc rows and the weight chunks, and in K9 the cotangent rows after the
// bias gradient has read them -- and every sum stays float32, as
// `_CastProduct` computes.
//
// What bounds it on this card: arithmetic. With tangents a point needs
// 4 rows x (the MLP's multiply-adds) in the forward and three times that in
// K9 (recompute, input cotangent, weight gradient); bytes are a few hundred
// per point. This first design runs every product as register-blocked
// float32 FMA, at a fraction of the fp32 peak: simple and right first;
// tensor cores (wgmma), cp.async / TMA staging and a resident weight set are
// later work.
//
// The design. 256 threads a block; a tile of P points (R = 4P rows with
// tangents, P without; a tile never spans two batch rows, points past N
// read as 0 and are not written). The tile's activation rows live in shared
// memory, transposed ([channel][row], row stride R + 4, so that a thread
// reads its 4 rows as one float4 and 8 consecutive channels fall in 8
// distinct 4-bank groups); R is the largest of 64, 32, 16 whose buffers fit
// (`choose_rows`). The weights stay in global memory (L2-resident: 8 x 256^2
// float32 is 2 MB against a 50 MB L2) and pass through shared memory 2,048
// at a time (`load_chunk` / `store_chunk`: 8 values a thread, the next
// chunk's loads in flight while the current one is consumed). Each thread
// owns a 4-row x
// 4-column block of a product's output: with tangents its 4 rows are one
// point, so the activation, which needs the primal row's sigmoid for the
// tangent rows, stays in the thread. A warp covers 4 row groups x 8 column
// groups, so that a step of the reduction loads one float4 of rows and one
// of weights per 16 FMAs with at most one shared-memory wavefront each.
//   K8: one block a tile; layer by layer, column pass by column pass (4 x
//       256 / (R / 4) columns a pass), product then bias and activation into
//       the other activation buffer; the output layer writes sdf, feature
//       and gradient.
//   K9: persistent blocks (as many as fit on the card, never more than the
//       tiles). Per tile: the forward again, stashing each hidden layer's
//       [prim; raw tangents] in the block's global scratch; then from the
//       output layer down: the bias gradient from the primal rows, the
//       weight gradient H^T C into the block's slice of the partials (each
//       element always added by the same thread: no atomics), the input
//       cotangent C K^T (into the next layer's cotangent through the stash,
//       and into the posenc rows' cotangent); the posenc's reverse; the
//       points' gradient. A second launch sums the blocks' partials in a
//       fixed order, so the result is deterministic. The partials do not
//       fit in L2 (2.2 MB a block at 8 x 256): each thread loads its
//       entries before the products it adds to them, and the loops that
//       read the stash or the cotangents from global memory are unrolled,
//       so that the loads are in flight together.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// weights a staged chunk holds (kStage / cb reduction rows of a pass's cb
// columns: 32, 16 or 8 rows) and each thread moves
constexpr int kStage = 2048;
constexpr int kStagePerThread = kStage / kThreads;
constexpr int kMaxHidden = 16;
constexpr int kMaxWidth = 512;
constexpr int kMaxFreqs = 16;
constexpr float kBeta = 100.f;      // softplus(100 x) / 100
constexpr int kSmemLimit = 232448;  // bytes of shared memory a block can use

struct Arch {
  int n_freqs, n_hidden, width, skip_mask;
  int pe_dim;      // D = 3 + 6 F
  int rows;        // R: rows of a tile
  int points;      // P: points of a tile (R / 4 with tangents, R without)
  int rs;          // shared row stride, R + 4
  int cgroups;     // column groups: kThreads / (R / 4)
  int bias_width;  // L W + W + 1
  int num_weights;
  int woff[kMaxHidden + 2];  // each layer's offset in the packed weights
};

__host__ __device__ inline bool layer_pe(const Arch& a, int l) {
  return l == 0 || ((a.skip_mask >> l) & 1);
}
__host__ __device__ inline int layer_h(const Arch& a, int l) {
  return l > 0 ? a.width : 0;
}
__host__ __device__ inline int layer_out(const Arch& a, int l) {
  return l == a.n_hidden ? a.width + 1 : a.width;
}

// Shared-memory floats of a block: K8 two activation buffers [W][rs], the
// posenc rows [D][rs]; K9 two buffers [W + 1][rs] (activations or
// cotangents) and the posenc rows and their cotangent; both a weight chunk
// [kStage / cb][cb + 4], a zero row and the tile's x0 signs.
__host__ __device__ inline int chunk_floats(int rows) {
  const int cb = 4 * (kThreads / (rows / 4));
  return kStage / cb * (cb + 4);
}

inline int smem_floats(const Arch& a, int rows, bool backward) {
  const int rs = rows + 4;
  const int act = backward ? 2 * (a.width + 1) * rs + 2 * a.pe_dim * rs
                           : 2 * a.width * rs + a.pe_dim * rs;
  return act + chunk_floats(rows) + rs + 64;
}

// Fills `a` for the architecture, or returns false outside the envelope.
inline bool make_arch(Arch* a, int n_freqs, int n_hidden, int width,
                      int skip_mask) {
  if (width < 1 || width > kMaxWidth || n_hidden < 1 ||
      n_hidden > kMaxHidden || n_freqs < 0 || n_freqs > kMaxFreqs)
    return false;
  const int allowed = ((1 << (n_hidden + 1)) - 1) & ~1;  // bits 1 .. L
  if (skip_mask & ~allowed) return false;
  a->n_freqs = n_freqs;
  a->n_hidden = n_hidden;
  a->width = width;
  a->skip_mask = skip_mask;
  a->pe_dim = 3 + 6 * n_freqs;
  a->bias_width = n_hidden * width + width + 1;
  int off = 0;
  for (int l = 0; l <= n_hidden; ++l) {
    a->woff[l] = off;
    off += (layer_h(*a, l) + (layer_pe(*a, l) ? a->pe_dim : 0)) *
           layer_out(*a, l);
  }
  a->woff[n_hidden + 1] = off;
  a->num_weights = off;
  return true;
}

// The tile's rows: the largest of 64, 32, 16 whose shared memory fits.
inline int choose_rows(const Arch& a, bool backward) {
  for (int rows = 64; rows >= 16; rows /= 2)
    if (smem_floats(a, rows, backward) * (int)sizeof(float) <= kSmemLimit)
      return rows;
  return 0;
}

inline void set_tile(Arch* a, int rows, bool grad) {
  a->rows = rows;
  a->points = grad ? rows / 4 : rows;
  a->rs = rows + 4;
  a->cgroups = kThreads / (rows / 4);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool kBf16>
__device__ __forceinline__ float operand(float x) {
  return kBf16 ? bf16_round(x) : x;
}

// (softplus(100 x) / 100, sigmoid(100 x)) sharing one exp, as `_act_pair`.
__device__ __forceinline__ void act_pair(float prim, float& act, float& sig) {
  const float z = kBeta * prim;
  const float e = expf(-fabsf(z));
  const float inv = 1.f / (1.f + e);
  sig = z >= 0.f ? inv : 1.f - inv;
  act = (fmaxf(z, 0.f) + log1pf(e)) / kBeta;
}

// Posenc feature d: its coordinate, its kind (0 the coordinate itself, 1 a
// sine, 2 a cosine) and its frequency 2^f. Order [x, sin(2^0 x), cos(2^0 x),
// sin(2^1 x), ...], each block of 3 coordinates.
__device__ __forceinline__ void pe_feature(int d, int& coord, int& kind,
                                           float& freq) {
  coord = d % 3;
  if (d < 3) {
    kind = 0;
    freq = 1.f;
    return;
  }
  const int f = (d - 3) / 6;
  kind = ((d - 3) % 6) < 3 ? 1 : 2;
  freq = (float)(1 << f);
}

// This thread's place in a product: row group rg (rows 4 rg .. 4 rg + 3) and
// column group cg (columns 4 cg .. 4 cg + 3 of a pass). A warp holds 4 row
// groups x 8 column groups; the warps tile the rest.
struct Place {
  int rg, cg;
};

__device__ __forceinline__ Place place(const Arch& a) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wc = a.cgroups / 8;  // warps across the column groups
  return Place{(warp / wc) * 4 + lane / 8, (warp % wc) * 8 + lane % 8};
}

// A weight chunk: kStage / cb reduction rows of a pass's cb columns,
// chunk[i][j] (row stride cb + 4) = M(k0 + i, c0 + j), zero outside
// k < kmax, n < nmax; M(k, n) = w[k ld + n], or with `trans` w[n ld + k]
// (the transposed kernel of K9's input cotangent). Each thread moves
// kStagePerThread values: `load_chunk` into registers, `store_chunk` into
// shared memory, so that the next chunk's loads are in flight while the
// current one is consumed.
__device__ __forceinline__ void chunk_place(int e, int cb, bool trans, int& i,
                                            int& j) {
  const int kc = kStage / cb;
  if (trans) {
    j = e / kc;
    i = e % kc;
  } else {
    i = e / cb;
    j = e % cb;
  }
}

template <bool kBf16>
__device__ __forceinline__ void load_chunk(float (&v)[kStagePerThread],
                                           int cb, const float* w, int ld,
                                           bool trans, int k0, int kmax,
                                           int c0, int nmax) {
#pragma unroll
  for (int u = 0; u < kStagePerThread; ++u) {
    int i, j;
    chunk_place(threadIdx.x + u * kThreads, cb, trans, i, j);
    const int k = k0 + i, n = c0 + j;
    float x = 0.f;
    if (k < kmax && n < nmax)
      x = trans ? w[(size_t)n * ld + k] : w[(size_t)k * ld + n];
    v[u] = operand<kBf16>(x);
  }
}

__device__ __forceinline__ void store_chunk(float* chunk,
                                            const float (&v)[kStagePerThread],
                                            int cb, bool trans) {
#pragma unroll
  for (int u = 0; u < kStagePerThread; ++u) {
    int i, j;
    chunk_place(threadIdx.x + u * kThreads, cb, trans, i, j);
    chunk[i * (cb + 4) + j] = v[u];
  }
}

// acc[q][j] += sum_{k < K} src[k][4 rg + q] M(k, c0 + 4 cg + j), src rows of
// stride rs in shared memory. Every thread of the block calls it (it
// synchronises); it starts with a barrier, so a buffer written before the
// call is read only after every thread wrote its part.
template <bool kBf16>
__device__ void accumulate(float (&acc)[4][4], const Arch& a, Place pl,
                           const float* src, int K, const float* w, int ld,
                           bool trans, int c0, int nmax, float* chunk) {
  const int cb = 4 * a.cgroups, cs = cb + 4, kc = kStage / cb;
  float next[kStagePerThread];
  load_chunk<kBf16>(next, cb, w, ld, trans, 0, K, c0, nmax);
  for (int k0 = 0; k0 < K; k0 += kc) {
    __syncthreads();  // every thread is done with the previous chunk
    store_chunk(chunk, next, cb, trans);
    __syncthreads();
    if (k0 + kc < K)
      load_chunk<kBf16>(next, cb, w, ld, trans, k0 + kc, K, c0, nmax);
    const int kn = min(kc, K - k0);
    const float* s = src + (size_t)k0 * a.rs + 4 * pl.rg;
    const float* c = chunk + 4 * pl.cg;
#pragma unroll 4
    for (int i = 0; i < kn; ++i) {
      const float4 x = *reinterpret_cast<const float4*>(s + i * a.rs);
      const float4 y = *reinterpret_cast<const float4*>(c + i * cs);
      const float xv[4] = {x.x, x.y, x.z, x.w};
      const float yv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[q][j] = fmaf(xv[q], yv[j], acc[q][j]);
    }
  }
}

// The tile's posenc rows pt[d][r] (rounded in bf16: they are only ever a
// product's operand) and the x0 signs; with tangents row 4 p + q + 1 holds
// the tangent along coordinate q (dpe where feature d reads coordinate q,
// else 0).
template <bool kGrad, bool kBf16>
__device__ void build_posenc(const Arch& a, const float* points, int b, int N,
                             int n0, int force_symmetry, float* pt,
                             float* sign) {
  const int P = a.points, D = a.pe_dim;
  for (int e = threadIdx.x; e < P * D; e += kThreads) {
    const int p = e / D, d = e % D, n = n0 + p;
    int coord, kind;
    float freq;
    pe_feature(d, coord, kind, freq);
    float x = n < N ? points[((size_t)b * N + n) * 3 + coord] : 0.f;
    if (force_symmetry && coord == 0 && x < 0.f) x = -x;
    float v, dv;
    if (kind == 0) {
      v = x;
      dv = 1.f;
    } else {
      const float xf = x * freq;
      const float s = sinf(xf), c = cosf(xf);
      v = kind == 1 ? s : c;
      dv = kind == 1 ? freq * c : -freq * s;
    }
    if (kGrad) {
      float* row = pt + (size_t)d * a.rs + 4 * p;
      row[0] = operand<kBf16>(v);
      for (int q = 0; q < 3; ++q)
        row[q + 1] = q == coord ? operand<kBf16>(dv) : 0.f;
    } else {
      pt[(size_t)d * a.rs + p] = operand<kBf16>(v);
    }
  }
  for (int p = threadIdx.x; p < P; p += kThreads) {
    const int n = n0 + p;
    const float x0 = n < N ? points[((size_t)b * N + n) * 3] : 0.f;
    sign[p] = (force_symmetry && x0 < 0.f) ? -1.f : 1.f;
  }
}

// The hidden layers 0 .. L-1 of a tile: h_l = act(layer l of [h_(l-1);
// posenc]) into the other buffer, each layer's [prim; raw tangents] into
// `stash` ([l][c][r]) when given. Returns the buffer that holds h_(L-1).
template <bool kGrad, bool kBf16>
__device__ float* forward_hidden(const Arch& a, Place pl,
                                 const float* weights, const float* bias_row,
                                 float* hin, float* hout, const float* pt,
                                 float* chunk, float* stash) {
  const int W = a.width, cb = 4 * a.cgroups;
  for (int l = 0; l < a.n_hidden; ++l) {
    const int Kh = layer_h(a, l);
    const float* w = weights + a.woff[l];
    const float* bias = bias_row + l * W;
    for (int c0 = 0; c0 < W; c0 += cb) {
      float acc[4][4] = {};
      if (Kh) accumulate<kBf16>(acc, a, pl, hin, Kh, w, W, false, c0, W,
                                chunk);
      if (layer_pe(a, l))
        accumulate<kBf16>(acc, a, pl, pt, a.pe_dim, w + (size_t)Kh * W, W,
                          false, c0, W, chunk);
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + 4 * pl.cg + j;
        if (c >= W) break;
        float4 v;
        if (kGrad) {
          const float prim = acc[0][j] + bias[c];
          float act, sig;
          act_pair(prim, act, sig);
          if (stash)
            *reinterpret_cast<float4*>(
                stash + ((size_t)l * W + c) * a.rows + 4 * pl.rg) =
                make_float4(prim, acc[1][j], acc[2][j], acc[3][j]);
          v = make_float4(act, acc[1][j] * sig, acc[2][j] * sig,
                          acc[3][j] * sig);
        } else {
          float o[4], sig;
          for (int q = 0; q < 4; ++q) act_pair(acc[q][j] + bias[c], o[q], sig);
          v = make_float4(o[0], o[1], o[2], o[3]);
        }
        v = make_float4(operand<kBf16>(v.x), operand<kBf16>(v.y),
                        operand<kBf16>(v.z), operand<kBf16>(v.w));
        *reinterpret_cast<float4*>(hout + (size_t)c * a.rs + 4 * pl.rg) = v;
      }
    }
    float* t = hin;
    hin = hout;
    hout = t;
  }
  return hin;
}

// K8 (with tangents) and K8-nograd: one block a tile.
template <bool kGrad, bool kBf16>
__global__ void __launch_bounds__(kThreads)
    sdf_generic_fwd_kernel(const float* __restrict__ points,
                           const float* __restrict__ weights,
                           const float* __restrict__ biases,
                           float* __restrict__ sdf, float* __restrict__ feat,
                           float* __restrict__ grad, int N,
                           int force_symmetry, Arch a) {
  extern __shared__ __align__(16) float smem[];
  const int W = a.width, D = a.pe_dim, rs = a.rs, cb = 4 * a.cgroups;
  float* buf0 = smem;
  float* buf1 = buf0 + (size_t)W * rs;
  float* pt = buf1 + (size_t)W * rs;
  float* chunk = pt + (size_t)D * rs;
  float* sign = chunk + chunk_floats(a.rows) + rs;
  const int tiles_per_batch = (N + a.points - 1) / a.points;
  const int b = blockIdx.x / tiles_per_batch;
  const int n0 = (blockIdx.x % tiles_per_batch) * a.points;
  const Place pl = place(a);
  const float* bias_row = biases + (size_t)b * a.bias_width;

  build_posenc<kGrad, kBf16>(a, points, b, N, n0, force_symmetry, pt, sign);
  const float* h = forward_hidden<kGrad, kBf16>(a, pl, weights, bias_row,
                                                buf0, buf1, pt, chunk,
                                                nullptr);
  // the output layer: [sdf | feature] on the primal rows, the gradient from
  // the tangent rows' sdf column
  const int L = a.n_hidden, Nout = W + 1;
  const float* w = weights + a.woff[L];
  const float* bias = bias_row + L * W;
  for (int c0 = 0; c0 < Nout; c0 += cb) {
    float acc[4][4] = {};
    accumulate<kBf16>(acc, a, pl, h, W, w, Nout, false, c0, Nout, chunk);
    if (layer_pe(a, L))
      accumulate<kBf16>(acc, a, pl, pt, D, w + (size_t)W * Nout, Nout, false,
                        c0, Nout, chunk);
    for (int q = 0; q < 4; ++q) {
      const int p = kGrad ? pl.rg : 4 * pl.rg + q, n = n0 + p;
      if (n >= N) continue;
      const size_t pn = (size_t)b * N + n;
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + 4 * pl.cg + j;
        if (c >= Nout) break;
        const float prim = acc[kGrad ? 0 : q][j] + bias[c];
        if (c == 0) {
          sdf[pn] = prim;
          if (kGrad) {
            grad[pn * 3 + 0] = acc[1][0] * sign[p];
            grad[pn * 3 + 1] = acc[2][0];
            grad[pn * 3 + 2] = acc[3][0];
          }
        } else {
          feat[pn * W + c - 1] = prim;
        }
      }
      if (kGrad) break;  // one point a thread
    }
  }
}

// dk[k][c] += sum_r A[k][r] C[c][r] for k < Kh + (pe ? D : 0), c < Nout:
// A's rows h (k < Kh) then the posenc rows, C the cotangent rows. A warp
// covers 4 groups of 4 input channels x 8 output-channel groups; a thread's
// channels are k = 4 kt + i and c = ct + nct j, so that 8 lanes read 8
// consecutive C rows (distinct bank groups) and add to consecutive columns.
__device__ void weight_grad(const Arch& a, int Kh, bool pe, int Nout,
                            const float* h, const float* pt, const float* cot,
                            const float* zero, float* dk) {
  const int Kin = Kh + (pe ? a.pe_dim : 0);
  const int nkt = (Kin + 3) / 4, nct = (Nout + 3) / 4;
  const int wk = (nkt + 3) / 4, wct = (nct + 7) / 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int wt = warp; wt < wk * wct; wt += kThreads / 32) {
    const int kt = (wt / wct) * 4 + lane / 8, ct = (wt % wct) * 8 + lane % 8;
    if (kt >= nkt || ct >= nct) continue;
    const float* ar[4];
    const float* cr[4];
    for (int i = 0; i < 4; ++i) {
      const int k = 4 * kt + i, c = ct + nct * i;
      ar[i] = k >= Kin ? zero
              : k < Kh ? h + (size_t)k * a.rs
                       : pt + (size_t)(k - Kh) * a.rs;
      cr[i] = c < Nout ? cot + (size_t)c * a.rs : zero;
    }
    // the block's partial sums of these 16 entries, loaded before the
    // products so that their round trip overlaps them (read after the
    // loop, they stalled the block's 8 warps: 215 of K9's 458 ms at 12 x
    // 32,768, width 256, on an H100), added to once after the tile's sum
    float old[4][4], acc[4][4] = {};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = 4 * kt + i, c = ct + nct * j;
        old[i][j] = k < Kin && c < Nout ? dk[(size_t)k * Nout + c] : 0.f;
      }
    for (int r = 0; r < a.rows; r += 4) {
      float4 x[4], y[4];
      for (int i = 0; i < 4; ++i) {
        x[i] = *reinterpret_cast<const float4*>(ar[i] + r);
        y[i] = *reinterpret_cast<const float4*>(cr[i] + r);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(x[i].x, y[j].x, acc[i][j]);
          acc[i][j] = fmaf(x[i].y, y[j].y, acc[i][j]);
          acc[i][j] = fmaf(x[i].z, y[j].z, acc[i][j]);
          acc[i][j] = fmaf(x[i].w, y[j].w, acc[i][j]);
        }
    }
    for (int i = 0; i < 4; ++i) {
      const int k = 4 * kt + i;
      if (k >= Kin) break;
      for (int j = 0; j < 4; ++j) {
        const int c = ct + nct * j;
        if (c < Nout) dk[(size_t)k * Nout + c] = old[i][j] + acc[i][j];
      }
    }
  }
}

// K9: persistent blocks over the tiles (with tangents); the block's slices:
// part [num_weights + B bias_width] (d weights, then d biases) and stash
// [L][W][R].
template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 1)
    sdf_generic_bwd_kernel(const float* __restrict__ points,
                           const float* __restrict__ weights,
                           const float* __restrict__ biases,
                           const float* __restrict__ sbar,
                           const float* __restrict__ fbar,
                           const float* __restrict__ gbar,
                           float* __restrict__ dpoints,
                           float* __restrict__ partials,
                           float* __restrict__ stash_all, int B, int N,
                           int force_symmetry, Arch a) {
  extern __shared__ __align__(16) float smem[];
  const int W = a.width, D = a.pe_dim, rs = a.rs, R = a.rows, P = a.points;
  const int L = a.n_hidden, cb = 4 * a.cgroups;
  float* bufa = smem;
  float* bufb = bufa + (size_t)(W + 1) * rs;
  float* pt = bufb + (size_t)(W + 1) * rs;
  float* gt = pt + (size_t)D * rs;
  float* chunk = gt + (size_t)D * rs;
  float* zero = chunk + chunk_floats(R);
  float* sign = zero + rs;
  const size_t part_size = (size_t)a.num_weights + (size_t)B * a.bias_width;
  float* dk = partials + blockIdx.x * part_size;
  float* db = dk + a.num_weights;
  float* stash = stash_all + (size_t)blockIdx.x * L * W * R;
  const Place pl = place(a);

  for (size_t e = threadIdx.x; e < part_size; e += kThreads) dk[e] = 0.f;
  for (int e = threadIdx.x; e < rs; e += kThreads) zero[e] = 0.f;

  const int tiles_per_batch = (N + P - 1) / P;
  const int tiles = B * tiles_per_batch;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b = tile / tiles_per_batch;
    const int n0 = (tile % tiles_per_batch) * P;
    const float* bias_row = biases + (size_t)b * a.bias_width;
    __syncthreads();  // the previous tile is done with every buffer
    build_posenc<true, kBf16>(a, points, b, N, n0, force_symmetry, pt, sign);
    for (int e = threadIdx.x; e < D * rs; e += kThreads) gt[e] = 0.f;
    float* h = forward_hidden<true, kBf16>(a, pl, weights, bias_row, bufa,
                                           bufb, pt, chunk, stash);
    float* cot = h == bufa ? bufb : bufa;
    __syncthreads();
    // the output layer's cotangent rows: [sdf_bar | feat_bar] on the primal
    // row, grad_bar (x0 sign applied) in the tangent rows' sdf column
#pragma unroll 4
    for (int e = threadIdx.x; e < (W + 1) * P; e += kThreads) {
      const int c = e / P, p = e % P, n = n0 + p;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (n < N) {
        const size_t pn = (size_t)b * N + n;
        if (c == 0)
          v = make_float4(sbar[pn], gbar[pn * 3] * sign[p], gbar[pn * 3 + 1],
                          gbar[pn * 3 + 2]);
        else
          v.x = fbar[pn * W + c - 1];
      }
      *reinterpret_cast<float4*>(cot + (size_t)c * rs + 4 * p) = v;
    }
    for (int l = L; l >= 0; --l) {
      const int Kh = layer_h(a, l), Nout = layer_out(a, l);
      const bool pe = layer_pe(a, l);
      const float* w = weights + a.woff[l];
      __syncthreads();
      // the bias gradient: the primal rows' cotangent, unrounded
      for (int c = threadIdx.x; c < Nout; c += kThreads) {
        float s = 0.f;
        for (int p = 0; p < P; ++p) s += cot[(size_t)c * rs + 4 * p];
        db[(size_t)b * a.bias_width + l * W + c] += s;
      }
      if (kBf16) {
        __syncthreads();
        for (int e = threadIdx.x; e < Nout * R; e += kThreads) {
          float* x = cot + (size_t)(e / R) * rs + e % R;
          *x = bf16_round(*x);
        }
      }
      __syncthreads();
      weight_grad(a, Kh, pe, Nout, h, pt, cot, zero, dk + a.woff[l]);
      // the input cotangent C K^T; accumulate() opens with a barrier, so h
      // is free before the hidden part overwrites it
      if (Kh) {
        const float* st = stash + (size_t)(l - 1) * W * R;
        for (int c0 = 0; c0 < W; c0 += cb) {
          float acc[4][4] = {};
          accumulate<kBf16>(acc, a, pl, cot, Nout, w, Nout, true, c0, W,
                            chunk);
          for (int j = 0; j < 4; ++j) {
            const int k = c0 + 4 * pl.cg + j;
            if (k >= W) break;
            const float4 s4 = *reinterpret_cast<const float4*>(
                st + (size_t)k * R + 4 * pl.rg);
            float act, sig;
            act_pair(s4.x, act, sig);
            const float sp = kBeta * sig * (1.f - sig);
            const float tsum = acc[1][j] * s4.y + acc[2][j] * s4.z +
                               acc[3][j] * s4.w;
            *reinterpret_cast<float4*>(h + (size_t)k * rs + 4 * pl.rg) =
                make_float4(acc[0][j] * sig + tsum * sp, acc[1][j] * sig,
                            acc[2][j] * sig, acc[3][j] * sig);
          }
        }
      }
      if (pe) {
        for (int c0 = 0; c0 < D; c0 += cb) {
          float acc[4][4] = {};
          accumulate<kBf16>(acc, a, pl, cot, Nout, w + (size_t)Kh * Nout,
                            Nout, true, c0, D, chunk);
          for (int j = 0; j < 4; ++j) {
            const int d = c0 + 4 * pl.cg + j;
            if (d >= D) break;
            float* g = gt + (size_t)d * rs + 4 * pl.rg;
            for (int q = 0; q < 4; ++q) g[q] += acc[q][j];
          }
        }
      }
      if (l >= 2) {
        // h_(l-2), the next layer's input, from the stash into the free buffer
        __syncthreads();
        const float* st = stash + (size_t)(l - 2) * W * R;
#pragma unroll 4
        for (int e = threadIdx.x; e < W * P; e += kThreads) {
          const int c = e / P, p = e % P;
          const float4 s4 =
              *reinterpret_cast<const float4*>(st + (size_t)c * R + 4 * p);
          float act, sig;
          act_pair(s4.x, act, sig);
          *reinterpret_cast<float4*>(cot + (size_t)c * rs + 4 * p) =
              make_float4(operand<kBf16>(act), operand<kBf16>(s4.y * sig),
                          operand<kBf16>(s4.z * sig),
                          operand<kBf16>(s4.w * sig));
        }
      }
      float* t = cot;  // C_(l-1) is in h now, h_(l-2) in cot
      cot = h;
      h = t;
    }
    __syncthreads();
    // the posenc rows' cotangent back to the points: sum over the features
    // of coordinate q of G_prim dpe + G_tangent(q) d2pe
    for (int e = threadIdx.x; e < P * 3; e += kThreads) {
      const int p = e / 3, q = e % 3, n = n0 + p;
      if (n >= N) continue;
      const size_t pn = (size_t)b * N + n;
      float x = points[pn * 3 + q];
      if (force_symmetry && q == 0 && x < 0.f) x = -x;
      float s = gt[(size_t)q * rs + 4 * p];
      for (int f = 0; f < a.n_freqs; ++f) {
        const float freq = (float)(1 << f), xf = x * freq;
        const float sn = sinf(xf), cs = cosf(xf);
        const float* gs = gt + (size_t)(3 + 6 * f + q) * rs + 4 * p;
        const float* gc = gs + 3 * rs;
        s += gs[0] * (freq * cs) + gs[q + 1] * (-(freq * freq) * sn);
        s += gc[0] * (-freq * sn) + gc[q + 1] * (-(freq * freq) * cs);
      }
      dpoints[pn * 3 + q] = q == 0 ? s * sign[p] : s;
    }
  }
}

// out[i] = sum over the blocks g of part[g][i], g in order.
__global__ void sum_partials_kernel(const float* __restrict__ part,
                                    float* __restrict__ out, size_t n,
                                    int blocks) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int g = 0; g < blocks; ++g) s += part[(size_t)g * n + i];
  out[i] = s;
}

}  // namespace

// ---------------------------------------------------------------- C entry

namespace {

template <class K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// The architecture and its tile for a launch, or false outside the envelope.
bool launch_arch(Arch* a, int n_freqs, int n_hidden, int width, int skip_mask,
                 bool grad, bool backward) {
  if (!make_arch(a, n_freqs, n_hidden, width, skip_mask)) return false;
  const int rows = choose_rows(*a, backward);
  if (rows == 0) return false;
  set_tile(a, rows, grad);
  return true;
}

}  // namespace

// Packed weights of the architecture, or -1 outside the envelope.
extern "C" int scl_sdf_generic_num_weights(int n_freqs, int n_hidden,
                                           int width, int skip_mask) {
  Arch a;
  return make_arch(&a, n_freqs, n_hidden, width, skip_mask) ? a.num_weights
                                                            : -1;
}

// Points of a tile: K8 (`backward` 0, with or without tangents) or K9, or
// -1 outside the envelope.
extern "C" int scl_sdf_generic_tile_points(int n_freqs, int n_hidden,
                                           int width, int skip_mask,
                                           int compute_grad, int backward) {
  Arch a;
  if (!launch_arch(&a, n_freqs, n_hidden, width, skip_mask,
                   compute_grad || backward, backward))
    return -1;
  return a.points;
}

// K9's blocks that fit on one SM at once (its grid is that times the SMs,
// capped at the tiles), or -1 outside the envelope / a cudaError_t < 0.
extern "C" int scl_sdf_generic_bwd_blocks_per_sm(int n_freqs, int n_hidden,
                                                 int width, int skip_mask,
                                                 int mm_bf16) {
  Arch a;
  if (!launch_arch(&a, n_freqs, n_hidden, width, skip_mask, true, true))
    return -1;
  const size_t smem = smem_floats(a, a.rows, true) * sizeof(float);
  int blocks = 0;
  cudaError_t err;
  if (mm_bf16) {
    err = allow_smem(sdf_generic_bwd_kernel<true>, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, sdf_generic_bwd_kernel<true>, kThreads, smem);
  } else {
    err = allow_smem(sdf_generic_bwd_kernel<false>, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, sdf_generic_bwd_kernel<false>, kThreads, smem);
  }
  return err == cudaSuccess ? blocks : -(int)err;
}

// K8: points [B,N,3], weights [num_weights], biases [B, L W + W + 1] ->
// sdf [B,N], feat [B,N,W], grad [B,N,3] (with compute_grad); float32 (bf16
// products with mm_bf16, the operands rounded inside), contiguous, on the
// current device. One launch on `stream`; returns a cudaError_t.
extern "C" int scl_sdf_generic_fwd(const void* points, const void* weights,
                                   const void* biases, void* sdf, void* feat,
                                   void* grad, int B, int N, int n_freqs,
                                   int n_hidden, int width, int skip_mask,
                                   int compute_grad, int force_symmetry,
                                   int mm_bf16, void* stream) {
  Arch a;
  if (B <= 0 || N <= 0 ||
      !launch_arch(&a, n_freqs, n_hidden, width, skip_mask, compute_grad != 0,
                   false))
    return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)B * ((N + a.points - 1) / a.points);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats(a, a.rows, false) * sizeof(float);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(points);
  const float* w = static_cast<const float*>(weights);
  const float* bi = static_cast<const float*>(biases);
  float* so = static_cast<float*>(sdf);
  float* fo = static_cast<float*>(feat);
  float* go = static_cast<float*>(grad);
  cudaError_t err;
#define SCL_FWD(G, M)                                                    \
  err = allow_smem(sdf_generic_fwd_kernel<G, M>, smem);                  \
  if (err != cudaSuccess) return (int)err;                               \
  sdf_generic_fwd_kernel<G, M><<<(int)tiles, kThreads, smem, s>>>(       \
      p, w, bi, so, fo, go, N, force_symmetry, a);
  if (compute_grad && mm_bf16) {
    SCL_FWD(true, true)
  } else if (compute_grad) {
    SCL_FWD(true, false)
  } else if (mm_bf16) {
    SCL_FWD(false, true)
  } else {
    SCL_FWD(false, false)
  }
#undef SCL_FWD
  return (int)cudaGetLastError();
}

// K9: points [B,N,3], weights, biases (as K8), the cotangents sbar [B,N],
// fbar [B,N,W], gbar [B,N,3] -> dpoints [B,N,3] and out [num_weights +
// B (L W + W + 1)] (d weights, then d biases); partials [grid][the same]
// and stash [grid][L W 4P] are scratch, one slice a block. Any grid >= 1 is
// correct; the caller passes `scl_sdf_generic_bwd_blocks_per_sm` x the SMs,
// capped at the tiles. Two launches on `stream`; returns a cudaError_t.
extern "C" int scl_sdf_generic_bwd(const void* points, const void* weights,
                                   const void* biases, const void* sbar,
                                   const void* fbar, const void* gbar,
                                   void* dpoints, void* out, void* partials,
                                   void* stash, int B, int N, int grid,
                                   int n_freqs, int n_hidden, int width,
                                   int skip_mask, int force_symmetry,
                                   int mm_bf16, void* stream) {
  Arch a;
  if (B <= 0 || N <= 0 || grid <= 0 ||
      !launch_arch(&a, n_freqs, n_hidden, width, skip_mask, true, true))
    return (int)cudaErrorInvalidValue;
  if ((long long)B * ((N + a.points - 1) / a.points) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats(a, a.rows, true) * sizeof(float);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define SCL_BWD(M)                                                        \
  err = allow_smem(sdf_generic_bwd_kernel<M>, smem);                      \
  if (err != cudaSuccess) return (int)err;                                \
  sdf_generic_bwd_kernel<M><<<grid, kThreads, smem, s>>>(                 \
      static_cast<const float*>(points), static_cast<const float*>(weights), \
      static_cast<const float*>(biases), static_cast<const float*>(sbar),  \
      static_cast<const float*>(fbar), static_cast<const float*>(gbar),    \
      static_cast<float*>(dpoints), static_cast<float*>(partials),         \
      static_cast<float*>(stash), B, N, force_symmetry, a);
  if (mm_bf16) {
    SCL_BWD(true)
  } else {
    SCL_BWD(false)
  }
#undef SCL_BWD
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)a.num_weights + (size_t)B * a.bias_width;
  sum_partials_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(partials), static_cast<float*>(out), n, grid);
  return (int)cudaGetLastError();
}
