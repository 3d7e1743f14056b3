// Fused SDF-MLP backward (K2) for Hopper (sm_90a): the hand-derived VJP of
// the forward kernel with tangents (`fused_sdf_fwd.cu`, compute_grad=1).
//
// Replaces the Pallas TPU kernel `shapeclipper_tpu/ops/fused_sdf.py::
// _backward_call` (the `pl.pallas_call` at line 617) with float32 products.
// Its bf16-product form (`_mm_cast("bfloat16")`, K2-bf16) runs on the tensor
// cores in `fused_sdf_bwd_bf16.cu`; the C entry point below launches either,
// then the sum of the per-block partials that both write.
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
// get zero cotangents and are not written (no padding). A tile never spans
// two batch rows.
//
// What bounds it on this card: arithmetic. A point needs 3 x the forward
// with tangents, 509,184 FLOP (the tangent rows' structural zeros not
// counted; this kernel multiplies them, ~1.26x more), against ~290 bytes of
// cotangents read and 12 written: fp32 FMA throughput is the roof. Below it,
// the FMAs share the issue slots with the shared-memory loads that feed them
// (a warp-wide float4 load returns 512 bytes through a path of 128 bytes a
// clock), and with the barriers of one block of 8 warps per SM.
//
// The design: 256 threads, one persistent block per SM, a tile of 32 points
// = 128 rows (row r = 4 p + q). Every product is register-blocked, and each
// thread's rows are two whole points (rows 8 rg .. 8 rg + 7, rg = tid / 16),
// so the activation and its backward, which need the primal row's sigmoid
// for the tangent rows, stay in the thread.
//   * Forward recompute, out = H W: thread (rg, cg = tid % 16) owns 8 rows x
//     columns 4 cg .. 4 cg + 3; per input channel one float4 weight load and
//     two float4 row loads feed 32 FMAs.
//   * Input cotangent, C W^T: thread (rg, kg = tid % 16) owns 8 rows x input
//     channels kg + 16 i; per 4 output channels 8 float4 cotangent loads and
//     4 float4 weight loads feed 128 FMAs.
//   * Weight gradient, H^T C over the tile's 128 rows: thread (kq = tid / 16,
//     cg) owns input channels 4 kq .. 4 kq + 3 x output channels cg + 16 j;
//     per 4 rows 8 float4 loads feed 64 FMAs. The 16 sums per thread are
//     added into the block's slice of d(weights) once per 32 points.
// Larger blocks per thread (8 x 8 with the reduction split over 2 or 4
// threads) reach the 255-register limit, and 512 threads with 4-row blocks
// load more per FMA: both ran slower on the card. So did the three products
// on the tensor cores as 3xTF32 with mma.sync (two conversions per operand
// and three passes per product); the tensor-core route left is wgmma.
//
// Latency. A thread loads its stash entries of the next layer (below) and
// the slice entries it will add to while it computes: the L2 round trips
// overlap the products instead of stalling the block.
//
// Shared memory (floats; 232,448-byte limit):
//   weights  437 rows x 68      = 29,716  (118,864 B), loaded once per block
//   HT       [64][132]          =  8,448  ( 33,792 B)  activations, transposed
//   CT       [65][132]          =  8,580  ( 34,320 B)  cotangents, transposed
//   RT       [40][132]          =  5,280  ( 21,120 B)  posenc rows (row 39 = 0)
//   sign     [32]               =     32  (    128 B)
//   total                         52,056  (208,224 B)
// Strides. The weight row stride 68 is a multiple of 4 (16-byte rows) with
// 68 / 4 = 17 odd: the forward read W[k][4 cg ..] walks 8 consecutive float4
// of one row per quarter-warp, and the transposed read W[kg + 16 i][4 c ..]
// walks 8 consecutive rows, whose float4 land in 8 distinct 4-bank groups
// because 17 kg mod 8 = kg mod 8; both are free of bank conflicts. The
// transposed buffers' stride 132 (132 / 4 = 33, odd) does the same for the
// weight gradient's reads CT[cg + 16 j][r ..] and for the cotangent stores
// CT[kg + 16 i][8 rg ..]; the forward's row loads are broadcasts.
//
// The stash. The five hidden layers' pre-activation rows of one 32-point
// tile are 5 x 128 x 64 floats = 160 KB, which does not fit beside the
// resident weights. It goes to this block's slice of a [grid][5][128][64]
// device scratch (21 MB at 132 blocks, L2-resident): coalesced float4
// stores in the recompute; in the sweep each thread loads its (point,
// channel) pairs of a layer once, a step ahead, builds that layer's H from
// them and keeps them, the sigmoid in place of the primal, for the
// activation's backward one step later. Streaming the weights instead would
// reload each layer's matrices four times per tile (forward, then C W^T and
// H^T C in the sweep) and cost a ring buffer; the stash is read once.
//
// Barriers per tile: 18. Posenc rows 1; forward 5 (one per layer: its output
// ping-pongs between HT and CT, which holds no cotangent until the forward
// ends); output-layer cotangents 1; sweep 2 per hidden layer (one buffer
// each for the cotangents and the activations: the stores of layer l-1's
// operands must wait until every thread has read layer l's) = 10; end of
// tile 1.
//
// Determinism. d(weights) and d(biases) go to per-block slices of
// [grid, 28,032] and [grid, B, 385] scratch, each entry read-modify-written
// by one fixed thread after every tile; a second kernel in this file sums
// the slices in block order. With the fixed tile-to-block assignment and
// fixed in-block orders (the point gradient's 16-lane butterfly included)
// the result is bitwise the same for a given grid (one block per SM, fixed
// per card). No atomics.

#include <cuda_runtime.h>

namespace {

constexpr int kWidth = 64;
constexpr int kFreqs = 6;
constexpr int kPe = 3 + 6 * kFreqs;         // 39
constexpr int kOut = kWidth + 1;            // 65
constexpr int kThreads = 256;
constexpr int kPoints = 32;                 // points per tile
constexpr int kRows = 4 * kPoints;          // rows per tile, r = 4 p + q
constexpr int kLd = kRows + 4;              // row stride of transposed buffers
constexpr int kWld = 68;                    // row stride of weights in smem
constexpr int kHidden = 5;
constexpr int kStashFloats = kHidden * kRows * kWidth;  // per block

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
constexpr int kSmHT = kSmW + kWRows * kWld;           // [64][kLd]
constexpr int kSmCT = kSmHT + kWidth * kLd;           // [65][kLd]
constexpr int kSmRT = kSmCT + kOut * kLd;             // [40][kLd]
constexpr int kSmSign = kSmRT + 40 * kLd;             // [32]
constexpr int kSmFloats = kSmSign + kPoints;

static_assert(kSmHT % 4 == 0 && kSmCT % 4 == 0 && kSmRT % 4 == 0 &&
              kWld % 4 == 0 && (kWld / 4) % 2 == 1 && kLd % 4 == 0 &&
              (kLd / 4) % 2 == 1, "16-byte rows, conflict-free strides");
static_assert(kSmFloats * 4 <= 232448, "fits the 227 KB per block");
static_assert((kRows / 8) * (kWidth / 4) == kThreads, "thread tiling");

__device__ __forceinline__ void act_pair(float prim, float& act, float& sig) {
  const float z = 100.f * prim;
  const float e = expf(-fabsf(z));
  const float inv = 1.f / (1.f + e);
  sig = z >= 0.f ? inv : 1.f - inv;
  act = (fmaxf(z, 0.f) + log1pf(e)) / 100.f;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c,
                                    float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// Forward product: acc[i][j] += sum_k inT[k][r0 + i] * W[wrow + k][c0 + j]
// over k < K.
template <int K>
__device__ __forceinline__ void fwd_product(const float* __restrict__ inT,
                                            const float* __restrict__ sW,
                                            int wrow, int c0, int r0,
                                            float (&acc)[8][4]) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float4 a0 = ld4(inT + k * kLd + r0);
    const float4 a1 = ld4(inT + k * kLd + r0 + 4);
    const float4 w = ld4(sW + (wrow + k) * kWld + c0);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], wv[j], acc[i][j]);
    }
  }
}

// Input cotangent: acc[i][rr] += sum_c coT[c][r0 + rr] * W[wrow + kg + 16 i][c]
// over c < C, for i < NI. Rows of W past the matrix belong to the next one
// (or the padding) and give sums the caller discards.
template <int C, int NI>
__device__ __forceinline__ void bwd_product(const float* __restrict__ coT,
                                            const float* __restrict__ sW,
                                            int wrow, int kg, int r0,
                                            float (&acc)[NI][8]) {
  const float* wr = sW + (wrow + kg) * kWld;
#pragma unroll 2
  for (int c = 0; c + 4 <= C; c += 4) {
    float cv[4][8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 a0 = ld4(coT + (c + j) * kLd + r0);
      const float4 a1 = ld4(coT + (c + j) * kLd + r0 + 4);
      cv[j][0] = a0.x; cv[j][1] = a0.y; cv[j][2] = a0.z; cv[j][3] = a0.w;
      cv[j][4] = a1.x; cv[j][5] = a1.y; cv[j][6] = a1.z; cv[j][7] = a1.w;
    }
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const float4 w = ld4(wr + 16 * i * kWld + c);
      const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int rr = 0; rr < 8; ++rr)
          acc[i][rr] = fmaf(cv[j][rr], wv[j], acc[i][rr]);
      }
    }
  }
  if (C % 4 == 1) {   // the output layer's last column
    constexpr int c = C - 1;
    const float4 a0 = ld4(coT + c * kLd + r0);
    const float4 a1 = ld4(coT + c * kLd + r0 + 4);
    const float cv[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const float w = wr[16 * i * kWld + c];
#pragma unroll
      for (int rr = 0; rr < 8; ++rr) acc[i][rr] = fmaf(cv[rr], w, acc[i][rr]);
    }
  }
}

// Weight gradient: dK[k][c] += sum_r inT[k][r] * coT[c][r] over the tile's
// 128 rows, for a [KIN][KOUT] matrix at offset goff of this block's slice;
// thread (kq, cg) owns k = 4 kq + i, c = cg + 16 j (c < 64). inT has
// 4 * ceil(KIN / 4) readable rows.
template <int KIN, int KOUT>
__device__ __forceinline__ void dk_accumulate(const float* __restrict__ inT,
                                              const float* __restrict__ coT,
                                              float* __restrict__ dkp,
                                              int goff, int tid) {
  const int kq = tid / 16, cg = tid % 16;
  if (4 * kq < KIN) {
    // the slice entries are read first, so their L2 latency overlaps the
    // product
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = 4 * kq + i;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s[i][j] = k < KIN ? dkp[goff + k * KOUT + cg + 16 * j] : 0.f;
    }
    float d[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) d[i][j] = 0.f;
    }
    const float* ip = inT + 4 * kq * kLd;
    const float* cp = coT + cg * kLd;
#pragma unroll 2
    for (int r = 0; r < kRows; r += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ld4(ip + i * kLd + r);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = ld4(cp + 16 * j * kLd + r);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          d[i][j] = fmaf(a[i].x, b[j].x, d[i][j]);
          d[i][j] = fmaf(a[i].y, b[j].y, d[i][j]);
          d[i][j] = fmaf(a[i].z, b[j].z, d[i][j]);
          d[i][j] = fmaf(a[i].w, b[j].w, d[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = 4 * kq + i;
      if (k < KIN) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          dkp[goff + k * KOUT + cg + 16 * j] = s[i][j] + d[i][j];
      }
    }
  }
  if (KOUT == kOut) {
    // column 64 of the output layer: four threads per input channel k, 32
    // rows each, summed by a fixed butterfly
    const int k = tid / 4, seg = tid % 4;
    const float prev = seg == 0 ? dkp[goff + k * KOUT + kWidth] : 0.f;
    float t = 0.f;
#pragma unroll
    for (int r = 32 * seg; r < 32 * seg + 32; r += 4) {
      const float4 a = ld4(inT + k * kLd + r);
      const float4 b = ld4(coT + kWidth * kLd + r);
      t = fmaf(a.x, b.x, t);
      t = fmaf(a.y, b.y, t);
      t = fmaf(a.z, b.z, t);
      t = fmaf(a.w, b.w, t);
    }
    t += __shfl_xor_sync(0xffffffffu, t, 1);
    t += __shfl_xor_sync(0xffffffffu, t, 2);
    if (seg == 0) dkp[goff + k * KOUT + kWidth] = prev + t;
  }
}

// d(bias of layer l)[c] += sum over the tile's points of the primal-row
// cotangent; one fixed thread per column.
template <int COLS>
__device__ __forceinline__ void db_accumulate(const float* __restrict__ coT,
                                              float* __restrict__ dbp_b,
                                              int l, int tid) {
  if (tid < COLS) {
    const float prev = dbp_b[l * kWidth + tid];
    float s = 0.f;
#pragma unroll 8
    for (int p = 0; p < kPoints; ++p) s += coT[tid * kLd + 4 * p];
    dbp_b[l * kWidth + tid] = prev + s;
  }
}

// A layer's stash at this thread's (point, channel) pairs: pre[i][4 pi + q]
// is row 8 rg + 4 pi + q, channel kg + 16 i. Issued early: the loads run
// while the thread computes.
__device__ __forceinline__ void load_stash(const float* __restrict__ stl,
                                           int r0, int kg,
                                           float (&pre)[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int rr = 0; rr < 8; ++rr)
      pre[i][rr] = stl[(r0 + rr) * kWidth + kg + 16 * i];
  }
}

// H (post-activation rows) of this thread's pairs into sHT, one float4 per
// (point, channel); the primal entries of pre become the sigmoid, which the
// activation's backward reads.
__device__ __forceinline__ void build_h(float (&pre)[4][8],
                                       float* __restrict__ sHT, int r0,
                                       int kg) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int pi = 0; pi < 2; ++pi) {
      float* v = pre[i] + 4 * pi;
      float act, sig;
      act_pair(v[0], act, sig);
      st4(sHT + (kg + 16 * i) * kLd + r0 + 4 * pi, act, v[1] * sig,
          v[2] * sig, v[3] * sig);
      v[0] = sig;
    }
  }
}

// The backward of one hidden layer's activation for this thread's 8 rows
// (2 points x [primal, t_x, t_y, t_z]) at channels kg + 16 i, from its
// stash pairs with the sigmoid in place of the primal (`build_h`); ch holds
// the cotangent of the activation rows and becomes the cotangent of the
// pre-activation rows.
__device__ __forceinline__ void act_backward(const float (&pre)[4][8],
                                             float (&ch)[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int pi = 0; pi < 2; ++pi) {
      const float* v = pre[i] + 4 * pi;
      const float sig = v[0];
      const float dsig = 100.f * sig * (1.f - sig);
      float* c = ch[i] + 4 * pi;
      const float acc_t = c[1] * v[1] + c[2] * v[2] + c[3] * v[3];
      c[0] = c[0] * sig + acc_t * dsig;
      c[1] *= sig;
      c[2] *= sig;
      c[3] *= sig;
    }
  }
}

// The posenc cotangent of a skip or input layer, C W_pe^T for this thread's
// rows and posenc features j = kg + 16 i (j < 39), folded straight into the
// thread's point-gradient sums: xb[pi][i] += C_R[prim][j] dpe_j +
// C_R[tangent d_j][j] d2pe_j, with dpe_j the tangent row's entry in RT and
// d2pe_j = -f_j^2 pe_j (0 for the raw coordinates).
__device__ __forceinline__ void posenc_cotangent(
    const float* __restrict__ sCT, const float* __restrict__ sW, int wrow,
    const float* __restrict__ sRT, int kg, int r0, const int (&dj)[3],
    const float (&f2)[3], float (&xb)[2][3]) {
  float cr[3][8];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int rr = 0; rr < 8; ++rr) cr[i][rr] = 0.f;
  }
  bwd_product<kWidth, 3>(sCT, sW, wrow, kg, r0, cr);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int j = kg + 16 * i;
    if (j < kPe) {
#pragma unroll
      for (int pi = 0; pi < 2; ++pi) {
        const float* rt = sRT + j * kLd + r0 + 4 * pi;
        const float* c = cr[i] + 4 * pi;
        const float tang = dj[i] == 0 ? c[1] : dj[i] == 1 ? c[2] : c[3];
        xb[pi][i] += c[0] * rt[1 + dj[i]] + tang * (-f2[i] * rt[0]);
      }
    }
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
                         float* __restrict__ db_partial,
                         float* __restrict__ stash, int B, int N,
                         int tiles_per_batch, int total_tiles,
                         int force_symmetry) {
  extern __shared__ __align__(16) float smem[];
  float* sW = smem + kSmW;
  float* sHT = smem + kSmHT;
  float* sCT = smem + kSmCT;
  float* sRT = smem + kSmRT;
  float* sSign = smem + kSmSign;

  const int tid = threadIdx.x;
  const int rg = tid / 16;         // rows 8 rg .. 8 rg + 7 (points 2rg, 2rg+1)
  const int r0 = 8 * rg;
  const int cg = tid % 16;         // forward: columns 4 cg .. 4 cg + 3
  const int kg = cg;               // sweep: input channels kg + 16 i
  float* dkp = dk_partial + (size_t)blockIdx.x * kNumWeights;
  float* dbp = db_partial + (size_t)blockIdx.x * B * kBiasStride;
  float* st = stash + (size_t)blockIdx.x * kStashFloats;

  // posenc feature j = kg + 16 i: its coordinate and -d2pe / pe = f^2
  int dj[3];
  float f2[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int j = kg + 16 * i;
    dj[i] = j % 3;
    const float f = (float)(1 << ((j < 3 ? 0 : j - 3) / 6));
    f2[i] = j < 3 ? 0.f : f * f;
  }

  // ---- weights into smem (row stride 68, zero-padded), RT's padding row,
  // this block's scratch to zero
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
  for (int i = tid; i < kLd; i += kThreads) sRT[kPe * kLd + i] = 0.f;
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

    // ---- posenc rows R^T [j][4p .. 4p+3] = [pe_j, dpe_j on row 1 + d_j]
    if (tid < kPoints * 3) {
      const int p = tid / 3, d = tid % 3;
      const int n = n0 + p;
      float x = n < N ? points[((size_t)b * N + n) * 3 + d] : 0.f;
      if (d == 0) {
        sSign[p] = (force_symmetry && x < 0.f) ? -1.f : 1.f;
        if (force_symmetry) x = fabsf(x);
      }
      const int r = 4 * p;
      st4(sRT + d * kLd + r, x, d == 0 ? 1.f : 0.f, d == 1 ? 1.f : 0.f,
          d == 2 ? 1.f : 0.f);
      float f = 1.f;
#pragma unroll
      for (int k = 0; k < kFreqs; ++k, f *= 2.f) {
        float s, c;
        sincosf(x * f, &s, &c);
        const int js = 3 + 6 * k + d, jc = js + 3;
        const float ds = f * c, dc = -f * s;
        st4(sRT + js * kLd + r, s, d == 0 ? ds : 0.f, d == 1 ? ds : 0.f,
            d == 2 ? ds : 0.f);
        st4(sRT + jc * kLd + r, c, d == 0 ? dc : 0.f, d == 1 ? dc : 0.f,
            d == 2 ? dc : 0.f);
      }
    }
    __syncthreads();

    // ---- forward recompute of the hidden layers: stash the pre-activation
    // rows, H_l into HT (l even) or CT (l odd)
#pragma unroll 1
    for (int l = 0; l < kHidden; ++l) {
      float acc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      }
      const float* hin = (l % 2 == 1) ? sHT : sCT;
      float* hout = (l % 2 == 0) ? sHT : sCT;
      const int c0 = 4 * cg;
      float bv[4];   // scalar loads: the bias rows (385) are not 16-byte aligned
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = __ldg(bias_b + l * kWidth + c0 + j);
      if (l == 0) {
        fwd_product<kPe>(sRT, sW, kRowK0, c0, r0, acc);
      } else if (l == 1) {
        fwd_product<kWidth>(hin, sW, kRowK1h, c0, r0, acc);
        fwd_product<kPe>(sRT, sW, kRowK1pe, c0, r0, acc);
      } else if (l == 2) {
        fwd_product<kWidth>(hin, sW, kRowK2h, c0, r0, acc);
        fwd_product<kPe>(sRT, sW, kRowK2pe, c0, r0, acc);
      } else {
        fwd_product<kWidth>(hin, sW, l == 3 ? kRowK3 : kRowK4, c0, r0, acc);
      }
      float* stl = st + l * kRows * kWidth;
#pragma unroll
      for (int pi = 0; pi < 2; ++pi) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[4 * pi][j] += bv[j];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
        st4(stl + (r0 + i) * kWidth + c0, acc[i][0], acc[i][1], acc[i][2],
            acc[i][3]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float h[8];
#pragma unroll
        for (int pi = 0; pi < 2; ++pi) {
          float act, sig;
          act_pair(acc[4 * pi][j], act, sig);
          h[4 * pi] = act;
#pragma unroll
          for (int d = 1; d < 4; ++d) h[4 * pi + d] = acc[4 * pi + d][j] * sig;
        }
        float* dst = hout + (c0 + j) * kLd + r0;
        st4(dst, h[0], h[1], h[2], h[3]);
        st4(dst + 4, h[4], h[5], h[6], h[7]);
      }
      __syncthreads();
    }

    // ---- output cotangents, transposed into CT [65][4p .. 4p+3]
    for (int it = tid; it < kPoints * kOut; it += kThreads) {
      const int p = it / kOut, c = it % kOut;
      const int n = n0 + p;
      const size_t bn = (size_t)b * N + n;
      float* dst = sCT + c * kLd + 4 * p;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (n < N && c == 0)
        v = make_float4(sbar[bn], gbar[bn * 3] * sSign[p], gbar[bn * 3 + 1],
                        gbar[bn * 3 + 2]);
      else if (n < N)
        v.x = fbar[bn * kWidth + c - 1];
      *reinterpret_cast<float4*>(dst) = v;
    }
    __syncthreads();

    // ---- reverse sweep. HT = H_4, CT = output-layer cotangents.
    // cur: the stash of the layer whose activation is reversed next; nxt:
    // that of the layer below, whose H the next step builds
    float cur[4][8], nxt[4][8];
    load_stash(st + (kHidden - 1) * kRows * kWidth, r0, kg, cur);
    dk_accumulate<kWidth, kOut>(sHT, sCT, dkp, kOffK5, tid);
    db_accumulate<kOut>(sCT, dbp_b, 5, tid);
    float ch[4][8];
    float xb[2][3];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int rr = 0; rr < 8; ++rr) ch[i][rr] = 0.f;
    }
#pragma unroll
    for (int pi = 0; pi < 2; ++pi) {
#pragma unroll
      for (int i = 0; i < 3; ++i) xb[pi][i] = 0.f;
    }
    bwd_product<kOut, 4>(sCT, sW, kRowK5, kg, r0, ch);
    // layer 4's H was built in the forward: only its sigmoid goes in place
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int pi = 0; pi < 2; ++pi) {
        float act, sig;
        act_pair(cur[i][4 * pi], act, sig);
        cur[i][4 * pi] = sig;
      }
    }
    load_stash(st + (kHidden - 2) * kRows * kWidth, r0, kg, nxt);
#pragma unroll 1
    for (int l = kHidden - 1; l >= 0; --l) {
      act_backward(cur, ch);
      __syncthreads();  // every thread has read CT and HT
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float* dst = sCT + (kg + 16 * i) * kLd + r0;
        st4(dst, ch[i][0], ch[i][1], ch[i][2], ch[i][3]);
        st4(dst + 4, ch[i][4], ch[i][5], ch[i][6], ch[i][7]);
      }
      if (l >= 1) {
        build_h(nxt, sHT, r0, kg);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int rr = 0; rr < 8; ++rr) cur[i][rr] = nxt[i][rr];
        }
      }
      __syncthreads();
      if (l >= 2) load_stash(st + (l - 2) * kRows * kWidth, r0, kg, nxt);
      db_accumulate<kWidth>(sCT, dbp_b, l, tid);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int rr = 0; rr < 8; ++rr) ch[i][rr] = 0.f;
      }
      if (l == 0) {
        dk_accumulate<kPe, kWidth>(sRT, sCT, dkp, kOffK0, tid);
        posenc_cotangent(sCT, sW, kRowK0, sRT, kg, r0, dj, f2, xb);
      } else if (l == 1 || l == 2) {
        dk_accumulate<kWidth, kWidth>(sHT, sCT, dkp,
                                      l == 1 ? kOffK1h : kOffK2h, tid);
        dk_accumulate<kPe, kWidth>(sRT, sCT, dkp,
                                   l == 1 ? kOffK1pe : kOffK2pe, tid);
        posenc_cotangent(sCT, sW, l == 1 ? kRowK1pe : kRowK2pe, sRT, kg, r0,
                         dj, f2, xb);
        bwd_product<kWidth, 4>(sCT, sW, l == 1 ? kRowK1h : kRowK2h, kg, r0,
                               ch);
      } else {
        dk_accumulate<kWidth, kWidth>(sHT, sCT, dkp,
                                      l == 3 ? kOffK3 : kOffK4, tid);
        bwd_product<kWidth, 4>(sCT, sW, l == 3 ? kRowK3 : kRowK4, kg, r0,
                               ch);
      }
    }

    // ---- point gradient: x_bar_d = sum over the features j of coordinate
    // d, summed over the 16 threads kg of each row group by a fixed
    // butterfly; sign on x_bar_x
#pragma unroll
    for (int pi = 0; pi < 2; ++pi) {
      float xd[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        float v = 0.f;
#pragma unroll
        for (int i = 0; i < 3; ++i) v += dj[i] == d ? xb[pi][i] : 0.f;
#pragma unroll
        for (int m = 8; m >= 1; m /= 2) v += __shfl_xor_sync(0xffffffffu, v, m);
        xd[d] = v;
      }
      const int p = 2 * rg + pi;
      const int n = n0 + p;
      if (kg == 0 && n < N) {
        float* dst = dpoints + ((size_t)b * N + n) * 3;
        dst[0] = xd[0] * sSign[p];
        dst[1] = xd[1];
        dst[2] = xd[2];
      }
    }
    __syncthreads();  // the next tile overwrites RT and the signs
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

// The bf16-product kernel (fused_sdf_bwd_bf16.cu): its main launch and its
// tile in points.
extern "C" int scl_fused_sdf_bwd_bf16_launch(
    const void* points, const void* weights, const void* biases,
    const void* sbar, const void* fbar, const void* gbar, void* dpoints,
    void* dk_partial, void* db_partial, void* stash, int B, int N, int grid,
    int force_symmetry, void* stream);
extern "C" int scl_fused_sdf_bwd_bf16_tile_points();
extern "C" int scl_fused_sdf_bwd_bf16_stash_floats();

// points [B,N,3], weights [28,032] (float32, or their bfloat16 copy with
// mm_bf16), biases [B,385], sbar [B,N], fbar [B,N,64], gbar [B,N,3] ->
// dpoints [B,N,3], dweights [28,032], dbiases [B,385]; dk_partial
// [grid,28,032] and db_partial [grid,B,385] are scratch, one slice per
// block, and so is stash [grid, scl_fused_sdf_bwd_stash_floats(mm_bf16)]
// (float32 products: 5 x 128 x 64 pre-activations; bf16 ones: each warp's
// layers 0-3, `fused_sdf_bwd_bf16.cu`). Any grid >= 1 is correct
// (a block zeroes its slices before it takes tiles); the caller passes one
// block per SM, capped at the number of tiles
// (`scl_fused_sdf_bwd_tile_points`). Float32 but for the bf16 weights,
// contiguous, on the current device. Two launches on `stream`; returns a
// cudaError_t.
extern "C" int scl_fused_sdf_bwd(const void* points, const void* weights,
                                 const void* biases, const void* sbar,
                                 const void* fbar, const void* gbar,
                                 void* dpoints, void* dweights, void* dbiases,
                                 void* dk_partial, void* db_partial,
                                 void* stash, int B, int N, int grid,
                                 int force_symmetry, int mm_bf16,
                                 void* stream) {
  if (B <= 0 || N <= 0 || grid <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (mm_bf16) {
    err = (cudaError_t)scl_fused_sdf_bwd_bf16_launch(
        points, weights, biases, sbar, fbar, gbar, dpoints, dk_partial,
        db_partial, stash, B, N, grid, force_symmetry, stream);
    if (err != cudaSuccess) return (int)err;
  } else {
    const int tiles_per_batch = (N + kPoints - 1) / kPoints;
    if ((long long)tiles_per_batch * B > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
    const size_t smem = kSmFloats * sizeof(float);
    err = cudaFuncSetAttribute(fused_sdf_bwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    fused_sdf_bwd_kernel<<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(points), static_cast<const float*>(weights),
        static_cast<const float*>(biases), static_cast<const float*>(sbar),
        static_cast<const float*>(fbar), static_cast<const float*>(gbar),
        static_cast<float*>(dpoints), static_cast<float*>(dk_partial),
        static_cast<float*>(db_partial), static_cast<float*>(stash), B, N,
        tiles_per_batch, tiles_per_batch * B, force_symmetry);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const int total = kNumWeights + B * kBiasStride;
  reduce_partials_kernel<<<(total + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(dk_partial),
      static_cast<const float*>(db_partial), static_cast<float*>(dweights),
      static_cast<float*>(dbiases), grid, B);
  return (int)cudaGetLastError();
}

extern "C" int scl_fused_sdf_bwd_num_weights() { return kNumWeights; }

extern "C" int scl_fused_sdf_bwd_stash_floats(int mm_bf16) {
  return mm_bf16 ? scl_fused_sdf_bwd_bf16_stash_floats() : kStashFloats;
}

// Points a tile holds: a block's tile of the float32 kernel or of the bf16
// one.
extern "C" int scl_fused_sdf_bwd_tile_points(int mm_bf16) {
  return mm_bf16 ? scl_fused_sdf_bwd_bf16_tile_points() : kPoints;
}
