// Fused SDF-MLP backward (K2) for Hopper (sm_90a): the hand-derived VJP of
// the forward kernel with tangents (`fused_sdf_fwd.cu`, compute_grad=1).
//
// Replaces the Pallas TPU kernel `shapeclipper_tpu/ops/fused_sdf.py::
// _backward_call` (the `pl.pallas_call` at line 617).
//
// What it computes. Given the cotangents of the forward's outputs
// (sdf [B,N], feature [B,N,64], point gradient [B,N,3]) it returns
//   d(weights) [28,032] (the packed layer kernels, flax [in][out] layout),
//   d(biases)  [B, 385] (the per-sample biases the latent was folded into),
//   d(points)  [B, N, 3].
// Per tile of points it (1) re-runs the forward with the rows
// [primal; t_x; t_y; t_z] of every point and stashes each hidden layer's
// pre-activation rows; (2) sweeps back: the output layer's primal row gets
// [sdf_bar | feat_bar] and tangent row d gets grad_bar_d in the sdf column
// only; a hidden layer turns the cotangent C of its output rows into
//   C_prim = C_a * s + (sum_d C_t,d * t_d) * 100 s (1 - s),  C_tang = C_t * s
// (s = sigmoid(100 prim), t_d the raw tangent rows); skip layers add their
// posenc cotangent; (3) reverses the posenc with dpe and d2pe; (4) applies
// the |x0| symmetry sign to grad_bar_x and x_bar_x. Points past N read as 0,
// get zero cotangents and are not written (no padding).
//
// What bounds it on this card: arithmetic. A point needs 3 x the forward
// with tangents, 509,184 FLOP (the tangent rows' structural zeros not
// counted, though this kernel multiplies them), against ~290 bytes of
// cotangents read and 12 written: fp32 FMA throughput is the roof (no
// tensor cores here).
//
// Where things live (the choice the 227 KB shared-memory limit forces):
//   * Weights: all 28,032 floats in shared memory, every matrix with a row
//     stride of 65 floats, so that both the forward product (threads over
//     output columns) and the transposed backward product (threads over
//     input rows) read without bank conflicts: 437 rows x 65 = 111 KB.
//   * The tile is 8 points = 32 rows. Its stash is the five hidden layers'
//     pre-activation rows (primal and raw tangents), 5 x 32 x 64 floats =
//     40 KB; activations and sigmoids are recomputed from it. Transposed
//     operand buffers (activations, posenc rows, output cotangents; row
//     stride 36) take 24 KB more: 184 KB in all, one block per SM.
//   * d(weights) does not fit beside the weights (another 112 KB) and is too
//     large for registers (110 floats per thread on top of the working set).
//     Each block owns a slice of a [grid, 28,032] scratch in device memory
//     (L2-resident: 132 x 112 KB = 15 MB), and each entry of it is
//     read-modify-written by one fixed thread after every tile; d(biases)
//     likewise into a [grid, B, 385] slice. No atomics.
//   * A second kernel in this file sums the per-block slices in block order.
//     Together with the fixed tile-to-block assignment and fixed in-block
//     summation orders, the result is deterministic for a given grid (the
//     grid is one block per SM, fixed per card).

#include <cuda_runtime.h>

namespace {

constexpr int kWidth = 64;
constexpr int kFreqs = 6;
constexpr int kPe = 3 + 6 * kFreqs;         // 39
constexpr int kOut = kWidth + 1;            // 65
constexpr int kThreads = 256;
constexpr int kPoints = 8;                  // points per tile
constexpr int kRows = 4 * kPoints;          // rows per tile, r = 4 p + q
constexpr int kLd = 36;                     // row stride of transposed buffers
constexpr int kWld = 65;                    // row stride of weights in smem
constexpr int kHidden = 5;

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

// first shared-memory row of each matrix (rows of kWld floats)
constexpr int kRowK0 = 0;
constexpr int kRowK1h = kRowK0 + kPe;
constexpr int kRowK1pe = kRowK1h + kWidth;
constexpr int kRowK2h = kRowK1pe + kPe;
constexpr int kRowK2pe = kRowK2h + kWidth;
constexpr int kRowK3 = kRowK2pe + kPe;
constexpr int kRowK4 = kRowK3 + kWidth;
constexpr int kRowK5 = kRowK4 + kWidth;
constexpr int kWRows = kRowK5 + kWidth;               // 437

// shared-memory carve-up, in floats
constexpr int kSmW = 0;
constexpr int kSmA = (kSmW + kWRows * kWld + 3) / 4 * 4;  // [5][32][64] stash
constexpr int kSmHT = kSmA + kHidden * kRows * kWidth; // [64][kLd]
constexpr int kSmRT = kSmHT + kWidth * kLd;           // [40][kLd] posenc rows
constexpr int kSmCoT = kSmRT + 40 * kLd;              // [65][kLd] cotangents
constexpr int kSmDpe = kSmCoT + kOut * kLd;           // [8][40]
constexpr int kSmD2 = kSmDpe + kPoints * 40;          // [8][40]
constexpr int kSmContrib = kSmD2 + kPoints * 40;      // [8][40]
constexpr int kSmSign = kSmContrib + kPoints * 40;    // [8]
constexpr int kSmFloats = kSmSign + kPoints;

static_assert(kSmW % 4 == 0 && kSmA % 4 == 0 && kSmHT % 4 == 0 &&
              kSmRT % 4 == 0 && kSmCoT % 4 == 0, "16-byte alignment");
static_assert(kSmFloats * 4 <= 232448, "fits the 227 KB per block");

__device__ __forceinline__ void act_pair(float prim, float& act, float& sig) {
  const float z = 100.f * prim;
  const float e = expf(-fabsf(z));
  const float inv = 1.f / (1.f + e);
  sig = z >= 0.f ? inv : 1.f - inv;
  act = (fmaxf(z, 0.f) + log1pf(e)) / 100.f;
}

// acc[i] += sum_k inT[k][rows rq*8+i] * W[k][col] over k < K (smem rows
// starting at wrow, stride kWld).
template <int K>
__device__ __forceinline__ void fwd_product(const float* __restrict__ inT,
                                            const float* __restrict__ sW,
                                            int wrow, int col, int rq,
                                            float (&acc)[8]) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(inT + k * kLd + rq * 8);
    const float4 a1 =
        *reinterpret_cast<const float4*>(inT + k * kLd + rq * 8 + 4);
    const float w = sW[(wrow + k) * kWld + col];
    acc[0] = fmaf(a0.x, w, acc[0]);
    acc[1] = fmaf(a0.y, w, acc[1]);
    acc[2] = fmaf(a0.z, w, acc[2]);
    acc[3] = fmaf(a0.w, w, acc[3]);
    acc[4] = fmaf(a1.x, w, acc[4]);
    acc[5] = fmaf(a1.y, w, acc[5]);
    acc[6] = fmaf(a1.z, w, acc[6]);
    acc[7] = fmaf(a1.w, w, acc[7]);
  }
}

// acc[i] += sum_c coT[c][rows rq*8+i] * W[k][c] over c < C: the cotangent
// of the layer's input column k (W rows starting at wrow).
template <int C>
__device__ __forceinline__ void bwd_product(const float* __restrict__ coT,
                                            const float* __restrict__ sW,
                                            int wrow, int k, int rq,
                                            float (&acc)[8]) {
  const float* wr = sW + (wrow + k) * kWld;
#pragma unroll 4
  for (int c = 0; c < C; ++c) {
    const float4 a0 = *reinterpret_cast<const float4*>(coT + c * kLd + rq * 8);
    const float4 a1 =
        *reinterpret_cast<const float4*>(coT + c * kLd + rq * 8 + 4);
    const float w = wr[c];
    acc[0] = fmaf(a0.x, w, acc[0]);
    acc[1] = fmaf(a0.y, w, acc[1]);
    acc[2] = fmaf(a0.z, w, acc[2]);
    acc[3] = fmaf(a0.w, w, acc[3]);
    acc[4] = fmaf(a1.x, w, acc[4]);
    acc[5] = fmaf(a1.y, w, acc[5]);
    acc[6] = fmaf(a1.z, w, acc[6]);
    acc[7] = fmaf(a1.w, w, acc[7]);
  }
}

// dK[k][c] += sum_r inT[k][r] * coT[c][r] over the tile's 32 rows, for a
// [KIN][KOUT] matrix at global offset goff of this block's scratch slice.
// Thread t owns columns (t % 16) * 4 .. +3 of rows t / 16 + 16 i; with
// KOUT = 65 the threads t < KIN also own column 64 of row t.
template <int KIN, int KOUT>
__device__ __forceinline__ void dk_accumulate(const float* __restrict__ inT,
                                              const float* __restrict__ coT,
                                              float* __restrict__ dkp,
                                              int goff, int tid) {
  constexpr int kIter = (KIN + 15) / 16;
  const int cg = tid % 16, kb = tid / 16;
  float s[kIter][4];
#pragma unroll
  for (int i = 0; i < kIter; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  }
#pragma unroll
  for (int r = 0; r < kRows; r += 4) {
    float4 b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(coT + (cg * 4 + j) * kLd + r);
#pragma unroll
    for (int i = 0; i < kIter; ++i) {
      const int k = kb + 16 * i;
      if (k < KIN) {
        const float4 a = *reinterpret_cast<const float4*>(inT + k * kLd + r);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a.x, b[j].x, s[i][j]);
          s[i][j] = fmaf(a.y, b[j].y, s[i][j]);
          s[i][j] = fmaf(a.z, b[j].z, s[i][j]);
          s[i][j] = fmaf(a.w, b[j].w, s[i][j]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kIter; ++i) {
    const int k = kb + 16 * i;
    if (k < KIN) {
#pragma unroll
      for (int j = 0; j < 4; ++j) dkp[goff + k * KOUT + cg * 4 + j] += s[i][j];
    }
  }
  if (KOUT == kOut && tid < KIN) {
    float t = 0.f;
#pragma unroll 8
    for (int r = 0; r < kRows; ++r)
      t = fmaf(inT[tid * kLd + r], coT[kWidth * kLd + r], t);
    dkp[goff + tid * KOUT + kWidth] += t;
  }
}

// d(bias of layer l)[c] += sum over the tile's points of the primal-row
// cotangent; one fixed thread per column.
template <int COLS>
__device__ __forceinline__ void db_accumulate(const float* __restrict__ coT,
                                              float* __restrict__ dbp_b,
                                              int l, int tid) {
  if (tid < COLS) {
    float s = 0.f;
#pragma unroll
    for (int p = 0; p < kPoints; ++p) s += coT[tid * kLd + 4 * p];
    dbp_b[l * kWidth + tid] += s;
  }
}

// The backward of one hidden layer's activation for this thread's 8 rows
// (2 points x [primal, t_x, t_y, t_z]) at column c; ch holds the
// cotangent of the activation rows and becomes the cotangent of the
// pre-activation rows.
__device__ __forceinline__ void act_backward(const float* __restrict__ sAl,
                                             int rq, int c, float (&ch)[8]) {
#pragma unroll
  for (int pi = 0; pi < 2; ++pi) {
    const int r0 = rq * 8 + 4 * pi;
    float act, sig;
    act_pair(sAl[r0 * kWidth + c], act, sig);
    const float dsig = 100.f * sig * (1.f - sig);
    const float t1 = sAl[(r0 + 1) * kWidth + c];
    const float t2 = sAl[(r0 + 2) * kWidth + c];
    const float t3 = sAl[(r0 + 3) * kWidth + c];
    const float acc_t =
        ch[4 * pi + 1] * t1 + ch[4 * pi + 2] * t2 + ch[4 * pi + 3] * t3;
    ch[4 * pi] = ch[4 * pi] * sig + acc_t * dsig;
    ch[4 * pi + 1] *= sig;
    ch[4 * pi + 2] *= sig;
    ch[4 * pi + 3] *= sig;
  }
}

// H_l (post-activation rows) from the stash, transposed into sHT.
__device__ __forceinline__ void build_h(const float* __restrict__ sAl,
                                       float* __restrict__ sHT, int tid) {
  for (int i = tid; i < kRows * kWidth; i += kThreads) {
    const int r = i / kWidth, c = i % kWidth;
    const int r0 = r & ~3;
    float act, sig;
    act_pair(sAl[r0 * kWidth + c], act, sig);
    sHT[c * kLd + r] = (r == r0) ? act : sAl[r * kWidth + c] * sig;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    fused_sdf_bwd_kernel(const float* __restrict__ points,
                         const float* __restrict__ weights,
                         const float* __restrict__ biases,
                         const float* __restrict__ sbar,
                         const float* __restrict__ fbar,
                         const float* __restrict__ gbar,
                         float* __restrict__ dpoints,
                         float* __restrict__ dk_partial,
                         float* __restrict__ db_partial, int B, int N,
                         int tiles_per_batch, int total_tiles,
                         int force_symmetry) {
  extern __shared__ __align__(16) float smem[];
  float* sW = smem + kSmW;
  float* sA = smem + kSmA;
  float* sHT = smem + kSmHT;
  float* sRT = smem + kSmRT;
  float* sCoT = smem + kSmCoT;
  float* sDpe = smem + kSmDpe;
  float* sD2 = smem + kSmD2;
  float* sContrib = smem + kSmContrib;
  float* sSign = smem + kSmSign;

  const int tid = threadIdx.x;
  const int rq = tid / kWidth;     // rows rq*8 .. rq*8+7 (points 2rq, 2rq+1)
  const int col = tid % kWidth;    // output / input column
  float* dkp = dk_partial + (size_t)blockIdx.x * kNumWeights;
  float* dbp = db_partial + (size_t)blockIdx.x * B * kBiasStride;

  // ---- weights into smem (row stride 65), this block's scratch to zero
  {
    const int offs[8] = {kOffK0, kOffK1h, kOffK1pe, kOffK2h,
                         kOffK2pe, kOffK3, kOffK4, kOffK5};
    const int rows0[8] = {kRowK0, kRowK1h, kRowK1pe, kRowK2h,
                          kRowK2pe, kRowK3, kRowK4, kRowK5};
    const int nin[8] = {kPe, kWidth, kPe, kWidth, kPe, kWidth, kWidth,
                        kWidth};
    for (int m = 0; m < 8; ++m) {
      const int nout = m == 7 ? kOut : kWidth;
      for (int i = tid; i < nin[m] * kWld; i += kThreads) {
        const int k = i / kWld, c = i % kWld;
        sW[(rows0[m] + k) * kWld + c] =
            c < nout ? weights[offs[m] + k * nout + c] : 0.f;
      }
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
    const int n0 = (tile % tiles_per_batch) * kPoints;
    const float* bias_b = biases + (size_t)b * kBiasStride;
    float* dbp_b = dbp + (size_t)b * kBiasStride;

    // ---- posenc rows R^T [j][r], dpe, d2pe, sign
    for (int i = tid; i < kPoints * 3; i += kThreads) {
      const int p = i / 3, d = i % 3;
      const int n = n0 + p;
      float x = n < N ? points[((size_t)b * N + n) * 3 + d] : 0.f;
      if (d == 0) {
        sSign[p] = (force_symmetry && x < 0.f) ? -1.f : 1.f;
        if (force_symmetry) x = fabsf(x);
      }
      const int r = 4 * p;
      sRT[d * kLd + r] = x;
#pragma unroll
      for (int e = 0; e < 3; ++e) sRT[d * kLd + r + 1 + e] = e == d ? 1.f : 0.f;
      sDpe[p * 40 + d] = 1.f;
      sD2[p * 40 + d] = 0.f;
      float f = 1.f;
#pragma unroll
      for (int k = 0; k < kFreqs; ++k, f *= 2.f) {
        float s, c;
        sincosf(x * f, &s, &c);
        const int js = 3 + 6 * k + d, jc = js + 3;
        sRT[js * kLd + r] = s;
        sRT[jc * kLd + r] = c;
#pragma unroll
        for (int e = 0; e < 3; ++e) {
          sRT[js * kLd + r + 1 + e] = e == d ? f * c : 0.f;
          sRT[jc * kLd + r + 1 + e] = e == d ? -f * s : 0.f;
        }
        sDpe[p * 40 + js] = f * c;
        sDpe[p * 40 + jc] = -f * s;
        sD2[p * 40 + js] = -f * f * s;
        sD2[p * 40 + jc] = -f * f * c;
      }
    }
    __syncthreads();

    // ---- output cotangents, transposed [65][r]
    for (int i = tid; i < kPoints * kOut; i += kThreads) {
      const int p = i / kOut, c = i % kOut;
      const int n = n0 + p;
      const size_t bn = (size_t)b * N + n;
      float v = 0.f;
      if (n < N) v = c == 0 ? sbar[bn] : fbar[bn * kWidth + c - 1];
      sCoT[c * kLd + 4 * p] = v;
      if (c == 0) {
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          float g = n < N ? gbar[bn * 3 + d] : 0.f;
          if (d == 0) g *= sSign[p];
          sCoT[4 * p + 1 + d] = g;
        }
      } else {
#pragma unroll
        for (int d = 0; d < 3; ++d) sCoT[c * kLd + 4 * p + 1 + d] = 0.f;
      }
    }

    // ---- forward recompute of the hidden layers, stashing pre-activations
#pragma unroll 1
    for (int l = 0; l < kHidden; ++l) {
      float acc[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = 0.f;
      if (l == 0) {
        fwd_product<kPe>(sRT, sW, kRowK0, col, rq, acc);
      } else if (l == 1) {
        fwd_product<kWidth>(sHT, sW, kRowK1h, col, rq, acc);
        fwd_product<kPe>(sRT, sW, kRowK1pe, col, rq, acc);
      } else if (l == 2) {
        fwd_product<kWidth>(sHT, sW, kRowK2h, col, rq, acc);
        fwd_product<kPe>(sRT, sW, kRowK2pe, col, rq, acc);
      } else {
        fwd_product<kWidth>(sHT, sW, l == 3 ? kRowK3 : kRowK4, col, rq, acc);
      }
      float* sAl = sA + l * kRows * kWidth;
      float h[8];
#pragma unroll
      for (int pi = 0; pi < 2; ++pi) {
        const float prim = acc[4 * pi] + __ldg(bias_b + l * kWidth + col);
        float act, sig;
        act_pair(prim, act, sig);
        acc[4 * pi] = prim;
        h[4 * pi] = act;
#pragma unroll
        for (int d = 1; d < 4; ++d) h[4 * pi + d] = acc[4 * pi + d] * sig;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) sAl[(rq * 8 + i) * kWidth + col] = acc[i];
      __syncthreads();  // every thread has read sHT
#pragma unroll
      for (int i = 0; i < 8; ++i) sHT[col * kLd + rq * 8 + i] = h[i];
      __syncthreads();
    }

    // ---- reverse sweep. sHT = H_4, sCoT = output-layer cotangents.
    dk_accumulate<kWidth, kOut>(sHT, sCoT, dkp, kOffK5, tid);
    db_accumulate<kOut>(sCoT, dbp_b, 5, tid);
    float ch[8], cr[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      ch[i] = 0.f;
      cr[i] = 0.f;
    }
    bwd_product<kOut>(sCoT, sW, kRowK5, col, rq, ch);
#pragma unroll 1
    for (int l = kHidden - 1; l >= 0; --l) {
      act_backward(sA + l * kRows * kWidth, rq, col, ch);
      __syncthreads();  // every thread has read sCoT and sHT
#pragma unroll
      for (int i = 0; i < 8; ++i) sCoT[col * kLd + rq * 8 + i] = ch[i];
      if (l >= 1) build_h(sA + (l - 1) * kRows * kWidth, sHT, tid);
      __syncthreads();
      db_accumulate<kWidth>(sCoT, dbp_b, l, tid);
#pragma unroll
      for (int i = 0; i < 8; ++i) ch[i] = 0.f;
      if (l == 0) {
        dk_accumulate<kPe, kWidth>(sRT, sCoT, dkp, kOffK0, tid);
        if (col < kPe) bwd_product<kWidth>(sCoT, sW, kRowK0, col, rq, cr);
      } else if (l == 1 || l == 2) {
        const int offh = l == 1 ? kOffK1h : kOffK2h;
        const int offpe = l == 1 ? kOffK1pe : kOffK2pe;
        const int rowh = l == 1 ? kRowK1h : kRowK2h;
        const int rowpe = l == 1 ? kRowK1pe : kRowK2pe;
        dk_accumulate<kWidth, kWidth>(sHT, sCoT, dkp, offh, tid);
        dk_accumulate<kPe, kWidth>(sRT, sCoT, dkp, offpe, tid);
        if (col < kPe) bwd_product<kWidth>(sCoT, sW, rowpe, col, rq, cr);
        bwd_product<kWidth>(sCoT, sW, rowh, col, rq, ch);
      } else {
        dk_accumulate<kWidth, kWidth>(sHT, sCoT, dkp,
                                      l == 3 ? kOffK3 : kOffK4, tid);
        bwd_product<kWidth>(sCoT, sW, l == 3 ? kRowK3 : kRowK4, col, rq, ch);
      }
    }

    // ---- posenc reverse: x_bar_d = sum_{j = d mod 3} C_R[prim][j] dpe[j]
    //      + C_R[tangent d][j] d2pe[j]; sign on x_bar_x
    if (col < kPe) {
      const int d = col % 3;
#pragma unroll
      for (int pi = 0; pi < 2; ++pi) {
        const int p = 2 * rq + pi;
        sContrib[p * 40 + col] = cr[4 * pi] * sDpe[p * 40 + col] +
                                 cr[4 * pi + 1 + d] * sD2[p * 40 + col];
      }
    }
    __syncthreads();
    if (tid < kPoints * 3) {
      const int p = tid / 3, d = tid % 3;
      float xb = 0.f;
      for (int j = d; j < kPe; j += 3) xb += sContrib[p * 40 + j];
      if (d == 0) xb *= sSign[p];
      const int n = n0 + p;
      if (n < N) dpoints[((size_t)b * N + n) * 3 + d] = xb;
    }
    __syncthreads();  // the next tile overwrites every buffer
  }
}

// out[i] = sum over blocks g of partial[g][i], in block order.
__global__ void reduce_partials_kernel(const float* __restrict__ dk_partial,
                                       const float* __restrict__ db_partial,
                                       float* __restrict__ dweights,
                                       float* __restrict__ dbiases, int grid,
                                       int B) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int nb = B * kBiasStride;
  if (i < kNumWeights) {
    float s = 0.f;
    for (int g = 0; g < grid; ++g) s += dk_partial[(size_t)g * kNumWeights + i];
    dweights[i] = s;
  } else if (i < kNumWeights + nb) {
    const int j = i - kNumWeights;
    float s = 0.f;
    for (int g = 0; g < grid; ++g) s += db_partial[(size_t)g * nb + j];
    dbiases[j] = s;
  }
}

}  // namespace

// points [B,N,3], weights [28,032], biases [B,385], sbar [B,N],
// fbar [B,N,64], gbar [B,N,3] -> dpoints [B,N,3], dweights [28,032],
// dbiases [B,385]; dk_partial [grid,28,032] and db_partial [grid,B,385] are
// scratch, one slice per block. Any grid >= 1 is correct (a block zeroes its
// slice before it takes tiles); the caller passes one block per SM, capped
// at the number of 8-point tiles. All float32, contiguous, on the current
// device. Two launches on `stream`; returns a cudaError_t.
extern "C" int scl_fused_sdf_bwd(const void* points, const void* weights,
                                 const void* biases, const void* sbar,
                                 const void* fbar, const void* gbar,
                                 void* dpoints, void* dweights, void* dbiases,
                                 void* dk_partial, void* db_partial, int B,
                                 int N, int grid, int force_symmetry,
                                 void* stream) {
  if (B <= 0 || N <= 0 || grid <= 0) return (int)cudaErrorInvalidValue;
  const int tiles_per_batch = (N + kPoints - 1) / kPoints;
  if ((long long)tiles_per_batch * B > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_sdf_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(kSmFloats * sizeof(float)));
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  fused_sdf_bwd_kernel<<<grid, kThreads, kSmFloats * sizeof(float), s>>>(
      static_cast<const float*>(points), static_cast<const float*>(weights),
      static_cast<const float*>(biases), static_cast<const float*>(sbar),
      static_cast<const float*>(fbar), static_cast<const float*>(gbar),
      static_cast<float*>(dpoints), static_cast<float*>(dk_partial),
      static_cast<float*>(db_partial), B, N, tiles_per_batch,
      tiles_per_batch * B, force_symmetry);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int total = kNumWeights + B * kBiasStride;
  reduce_partials_kernel<<<(total + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(dk_partial),
      static_cast<const float*>(db_partial), static_cast<float*>(dweights),
      static_cast<float*>(dbiases), grid, B);
  return (int)cudaGetLastError();
}

extern "C" int scl_fused_sdf_bwd_num_weights() { return kNumWeights; }
