// Fused SDF-MLP forward (+ forward-mode point gradient) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `shapeclipper_tpu/ops/fused_sdf.py::
// _forward_call` (the `pl.pallas_call` at line 311): both instantiations,
// with tangents (K1: render / turntable normals / training) and without
// (K3: the dense SDF grid).
//
// What it computes, per point x of batch row b (default architecture):
//   |x| symmetry on x0 (sign kept for the chain rule), posenc with 6
//   frequencies -> 39 features, 6 linear layers of width 64 with softplus(100)
//   between them, skips at layers 1 and 2 (kernels pre-scaled by 1/sqrt 2),
//   the latent folded into per-sample biases by the caller. With tangents,
//   every point carries four rows [primal; t_x; t_y; t_z] through the
//   products, so d sdf / dx falls out of the tangent rows' sdf column.
//   Outputs are written unpadded: sdf [B,N], feat [B,N,64], grad [B,N,3].
//
// What bounds it on this card: arithmetic. A point needs 84,864 multiply-adds
// with tangents (28,032 without) against 12 bytes read and 260-272 written;
// fp32 FMA throughput is the roof (no tensor cores: the sdf / feature
// tolerance of 2e-5 rules out plain TF32).
//
// What the design does about it:
//   * All 28,032 layer weights (112 KB) are staged once per persistent block
//     in shared memory, reordered there (never in the packed buffer, which
//     the backward reads too): the posenc rows of K0, K1pe and K2pe grouped
//     by coordinate (x's 13 features, then y's, then z's), and K5's sdf
//     column moved behind its 64 feature columns.
//   * 512 threads (16 warps per SM) on a 256-row tile of four groups of 64
//     rows, one warp-uniform group per quarter of the block. With tangents
//     the groups are the row kinds of 64 points (primal, t_x, t_y, t_z);
//     without, 64 more points each.
//   * Tangent-aware products: a tangent row of coordinate d is non-zero at
//     13 of the 39 posenc features, so its group multiplies only those 13
//     weight rows; in the output layer the tangent rows compute the sdf
//     column alone. The dense work is exactly the function's 84,864 MACs a
//     point, not the 112,128 of four full rows.
//   * Each thread owns an 8-row x 4-channel register tile (rows rg*4..+3 and
//     32 + rg*4..+3 of its group, so a warp's float4 row loads cover 32
//     consecutive floats and hit every bank once): 3 vector shared loads per
//     32 FMAs. Activations stay transposed in shared memory between layers.
//   * softplus(100 z)/100 and sigmoid(100 z) share one exp and round as the
//     plain version does; the two divisions are a correctly rounded
//     reciprocal and a product with one fmaf correction, without the IEEE
//     division's slow path. (Approximate __logf / __expf run faster and
//     stay within the tolerance, but move the vox-32 mesh far enough from
//     the CPU plain path's to fail the evaluation's card-vs-CPU check.)
//   * With tangents the primal rows' epilogue is cooperative: the primal
//     group writes its pre-activations, all 512 threads turn them into
//     activations and sigmoids (8 each), and the tangent groups scale their
//     rows by the sigmoids, all through shared memory (three barriers a
//     layer; without tangents every thread activates its own tile, two).
//   * The sdf column is split over two threads per row (32 deep each, four
//     independent sums) for every row of the tile; no thread runs a serial
//     tail. Features are staged row-major with an XOR swizzle (conflict-free
//     float4 writes from the register tiles and float4 reads) and stored
//     with coalesced float4 writes.
//   * sign(x0) is folded into the x-tangent row's posenc (a factor of +-1,
//     exact), so the gradient needs no fix-up at the end.
//   * The ragged tail of N is masked in the kernel (points past N read as 0
//     and are not written); no padding of the inputs or outputs. No atomics:
//     two launches are bitwise equal.

#include <cuda_runtime.h>

namespace {

constexpr int kWidth = 64;                 // hidden width
constexpr int kFreqs = 6;
constexpr int kPe = 3 + 6 * kFreqs;        // 39 posenc features
constexpr int kPeD = 1 + 2 * kFreqs;       // 13 features per coordinate
constexpr int kOut = kWidth + 1;           // sdf + 64 feature channels
constexpr int kG = 64;                     // rows per group
constexpr int kRows = 4 * kG;              // rows per tile
constexpr int kThreads = 8 * kG;           // 128 threads per group
constexpr int kRM = 8;                     // rows per thread
constexpr int kRN = 4;                     // channels per thread

// Packed weights, every kernel [in][out] row-major (flax layout):
// K0 [39][64] | K1h [64][64] | K1pe [39][64] | K2h [64][64] | K2pe [39][64] |
// K3 [64][64] | K4 [64][64] | K5 [64][65]
constexpr int kOffK0 = 0;
constexpr int kOffK1h = kOffK0 + kPe * kWidth;
constexpr int kOffK1pe = kOffK1h + kWidth * kWidth;
constexpr int kOffK2h = kOffK1pe + kPe * kWidth;
constexpr int kOffK2pe = kOffK2h + kWidth * kWidth;
constexpr int kOffK3 = kOffK2pe + kPe * kWidth;
constexpr int kOffK4 = kOffK3 + kWidth * kWidth;
constexpr int kOffK5 = kOffK4 + kWidth * kWidth;
constexpr int kNumWeights = kOffK5 + kWidth * kOut;   // 28,032
// In shared memory K5 is its 64 feature columns [64][64] (packed columns
// 1..64) followed by its sdf column [64] (packed column 0).
constexpr int kOffK5sdf = kOffK5 + kWidth * kWidth;

// Packed per-sample biases [B][5*64 + 65]; layer 5's are [sdf, feat 0..63].
constexpr int kBiasStride = 5 * kWidth + kOut;

static_assert(kOffK5 % 4 == 0 && kNumWeights % 4 == 0, "16-byte alignment");
static_assert(kG % 32 == 0, "every warp lies in one row group");

// Hidden-input kernel of layer l in 1..4, posenc kernel of layer l in 0..2.
__host__ __device__ constexpr int hidden_offset(int l) {
  return l == 1 ? kOffK1h : l == 2 ? kOffK2h : l == 3 ? kOffK3 : kOffK4;
}
__host__ __device__ constexpr int posenc_offset(int l) {
  return l == 0 ? kOffK0 : l == 1 ? kOffK1pe : kOffK2pe;
}

// Shared memory of one instantiation, in floats: weights, the activations
// [64][kRows] (the feature staging after the last layer), the posenc rows,
// the primal rows' pre-activations, then sigmoids [64][kG] (with tangents),
// the sdf halves [2][kRows] and the tile's biases.
template <bool kGrad>
struct Smem {
  static constexpr int kPoints = kGrad ? kG : kRows;   // points per tile
  static constexpr int kH = kNumWeights;
  static constexpr int kPE = kH + kWidth * kRows;
  static constexpr int kSig = kPE + (kGrad ? kPe + 3 * kPeD : 4 * kPe) * kG;
  static constexpr int kPart = kSig + (kGrad ? kWidth * kG : 0);
  static constexpr int kBias = kPart + 2 * kRows;
  static constexpr int kFloats = kBias + kBiasStride;
  static_assert(kPoints * kWidth <= kWidth * kRows, "feature staging fits");
  static_assert(kSig % 4 == 0 && kPart % 4 == 0, "16-byte alignment");
};

// Posenc feature of shared-memory row q (coordinate d = q / 13, then the
// coordinate's 13 features: itself, and sin, cos at each frequency).
__device__ __forceinline__ int posenc_source(int q) {
  const int d = q / kPeD, m = q % kPeD;
  if (m == 0) return d;
  const int k = (m - 1) / 2;
  return (m & 1) ? 3 + 6 * k + d : 6 + 6 * k + d;
}

// Packed index of shared-memory weight j.
__device__ __forceinline__ int weight_source(int j) {
  for (int l = 0; l < 3; ++l) {
    const int off = posenc_offset(l);
    if (j >= off && j < off + kPe * kWidth)
      return off + posenc_source((j - off) / kWidth) * kWidth +
             (j - off) % kWidth;
  }
  if (j >= kOffK5sdf) return kOffK5 + (j - kOffK5sdf) * kOut;
  if (j >= kOffK5) return kOffK5 + (j - kOffK5) / kWidth * kOut +
                          (j - kOffK5) % kWidth + 1;
  return j;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c,
                                    float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// Row of register-tile row i within the thread's group.
__device__ __forceinline__ int tile_row(int rg, int i) {
  return (i < 4 ? 0 : kG / 2) + rg * 4 + (i & 3);
}

// XOR swizzle of the 16-byte column units of the feature staging: the
// units a quarter-warp writes (eight row groups) or reads (eight units of
// one point) fall in eight different bank groups.
__device__ __forceinline__ int swizzle(int p) { return (p >> 2) & 7; }

// acc[i][j] += srcT[k][rows of i] * w[k][channels cg*4 + j] over k < K;
// srcT is transposed with leading dimension LD.
template <int K, int LD, int kUnroll>
__device__ __forceinline__ void accumulate(const float* __restrict__ srcT,
                                           const float* __restrict__ w,
                                           float (&acc)[kRM][kRN], int rg,
                                           int cg) {
#pragma unroll kUnroll
  for (int k = 0; k < K; ++k) {
    const float4 a0 = ld4(srcT + k * LD + rg * 4);
    const float4 a1 = ld4(srcT + k * LD + kG / 2 + rg * 4);
    const float4 wv = ld4(w + k * kWidth + cg * kRN);
    const float a[kRM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[kRN] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
#pragma unroll
      for (int j = 0; j < kRN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[kRM][kRN]) {
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
#pragma unroll
    for (int j = 0; j < kRN; ++j) acc[i][j] = 0.f;
  }
}

// x / 100, rounded as the IEEE division (a product and one fmaf correction;
// checked bit for bit against x / 100.f over every float whose quotient is
// normal), without the division's slow path.
__device__ __forceinline__ float div100(float x) {
  const float q = x * 0.01f;
  return fmaf(fmaf(-q, 100.f, x), 0.01f, q);
}

// (softplus(100 p)/100, sigmoid(100 p)) of a pre-activation p from z = 100 p
// and one exp, rounded as the plain version's (__frcp_rn is the IEEE 1 / x).
__device__ __forceinline__ void act_pair(float z, float& act, float& sig) {
  const float e = expf(-fabsf(z));
  const float inv = __frcp_rn(1.f + e);
  sig = z >= 0.f ? inv : 1.f - inv;
  act = div100(fmaxf(z, 0.f) + log1pf(e));
}

// Without tangents: bias and activation of the register tile.
__device__ __forceinline__ void activate(float (&acc)[kRM][kRN],
                                         const float* bias, int cg) {
#pragma unroll
  for (int j = 0; j < kRN; ++j) {
    const float bj = bias[cg * kRN + j];
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      float sig;
      act_pair(100.f * (acc[i][j] + bj), acc[i][j], sig);
    }
  }
}

// With tangents, the primal rows: z = 100 (acc + bias) to sZ.
__device__ __forceinline__ void store_z(const float (&acc)[kRM][kRN],
                                        const float* bias, float* sZ, int rg,
                                        int cg) {
#pragma unroll
  for (int j = 0; j < kRN; ++j) {
    const float bj = bias[cg * kRN + j];
    float* dst = sZ + (cg * kRN + j) * kG + rg * 4;
    st4(dst, 100.f * (acc[0][j] + bj), 100.f * (acc[1][j] + bj),
        100.f * (acc[2][j] + bj), 100.f * (acc[3][j] + bj));
    st4(dst + kG / 2, 100.f * (acc[4][j] + bj), 100.f * (acc[5][j] + bj),
        100.f * (acc[6][j] + bj), 100.f * (acc[7][j] + bj));
  }
}

// Tangent rows: scaled by their point's primal sigmoid.
__device__ __forceinline__ void scale_by_sigmoid(float (&acc)[kRM][kRN],
                                                 const float* sSig, int rg,
                                                 int cg) {
#pragma unroll
  for (int j = 0; j < kRN; ++j) {
    const float* src = sSig + (cg * kRN + j) * kG + rg * 4;
    const float4 s0 = ld4(src), s1 = ld4(src + kG / 2);
    const float s[kRM] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
    for (int i = 0; i < kRM; ++i) acc[i][j] *= s[i];
  }
}

// The register tile into the activations ([channel][kRows rows]).
__device__ __forceinline__ void store_h(const float (&acc)[kRM][kRN],
                                        float* dst, int rg, int cg) {
#pragma unroll
  for (int j = 0; j < kRN; ++j) {
    float* d = dst + (cg * kRN + j) * kRows + rg * 4;
    st4(d, acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
    st4(d + kG / 2, acc[4][j], acc[5][j], acc[6][j], acc[7][j]);
  }
}

template <bool kGrad>
__global__ void __launch_bounds__(kThreads, 1)
    fused_sdf_fwd_kernel(const float* __restrict__ points,
                         const float* __restrict__ weights,
                         const float* __restrict__ biases,
                         float* __restrict__ sdf, float* __restrict__ feat,
                         float* __restrict__ grad, int N, int tiles_per_batch,
                         int total_tiles, int force_symmetry) {
  using S = Smem<kGrad>;
  constexpr int kPoints = S::kPoints;
  constexpr int kUnroll = kGrad ? 4 : 8;
  extern __shared__ __align__(16) float smem[];
  float* sW = smem;                       // reordered weights
  float* sH = smem + S::kH;               // [64][kRows]; then the staging
  float* sPE = smem + S::kPE;             // posenc rows, [feature][kG] each
  float* sSig = smem + S::kSig;           // [64][kG] z, then sigmoids
  float* sPart = smem + S::kPart;         // [2][kRows] sdf column halves
  float* sBias = smem + S::kBias;         // the tile's 385 biases

  const int tid = threadIdx.x;
  const int g = tid / (2 * kG);           // row group (warp-uniform)
  const int t = tid % (2 * kG);
  const int rg = t % (kG / 8);            // rows rg*4.. and kG/2 + rg*4..
  const int cg = t / (kG / 8);            // channels cg*4 .. +3
  const bool primal = !kGrad || g == 0;

  for (int j = tid; j < kNumWeights; j += kThreads)
    sW[j] = weights[weight_source(j)];

  for (int tile = blockIdx.x; tile < total_tiles; tile += gridDim.x) {
    const int b = tile / tiles_per_batch;
    const int n0 = (tile % tiles_per_batch) * kPoints;
    for (int j = tid; j < kBiasStride; j += kThreads)
      sBias[j] = biases[(size_t)b * kBiasStride + j];

    // ---- |x| symmetry + posenc ([feature][kG] per group; with tangents,
    // the 13 non-zero tangent features of each coordinate after the primal,
    // the x row's times sign(x0))
    for (int i = tid; i < kPoints * 3; i += kThreads) {
      const int p = i / 3, d = i % 3;
      const int n = n0 + p;
      float x = n < N ? points[((size_t)b * N + n) * 3 + d] : 0.f;
      float sgn = 1.f;
      if (d == 0 && force_symmetry) {
        sgn = x < 0.f ? -1.f : 1.f;
        x = fabsf(x);
      }
      float* pe = sPE + (p / kG) * kPe * kG + d * kPeD * kG + p % kG;
      float* tg = sPE + kPe * kG + d * kPeD * kG + p;   // with tangents
      pe[0] = x;
      if constexpr (kGrad) tg[0] = sgn;
      float f = 1.f;
#pragma unroll
      for (int k = 0; k < kFreqs; ++k, f *= 2.f) {
        float s, c;
        sincosf(x * f, &s, &c);
        pe[(1 + 2 * k) * kG] = s;
        pe[(2 + 2 * k) * kG] = c;
        if constexpr (kGrad) {
          tg[(1 + 2 * k) * kG] = sgn * (f * c);
          tg[(2 + 2 * k) * kG] = -sgn * (f * s);
        }
      }
    }
    __syncthreads();

    // ---- hidden layers 0..4
    float acc[kRM][kRN];
#pragma unroll
    for (int l = 0; l < 5; ++l) {
      zero(acc);
      if (l > 0)
        accumulate<kWidth, kRows, kUnroll>(sH + g * kG, sW + hidden_offset(l),
                                           acc, rg, cg);
      if (l < 3) {
        const float* w = sW + posenc_offset(l);
        if (primal)
          accumulate<kPe, kG, kUnroll>(sPE + (kGrad ? 0 : g * kPe * kG), w,
                                       acc, rg, cg);
        else
          accumulate<kPeD, kG, kUnroll>(sPE + (kPe + (g - 1) * kPeD) * kG,
                                        w + (g - 1) * kPeD * kWidth, acc, rg,
                                        cg);
      }
      const float* bias = sBias + l * kWidth;
      if constexpr (kGrad) {
        if (primal) store_z(acc, bias, sSig, rg, cg);
        __syncthreads();  // every thread has read H; the z are in
        // every thread activates 8 of the primal rows' 64 x kG values (not
        // unrolled: the tangent threads keep their tile in registers here)
#pragma unroll 1
        for (int e = tid; e < kWidth * kG; e += kThreads) {
          float act, sig;
          act_pair(sSig[e], act, sig);
          sH[(e / kG) * kRows + e % kG] = act;
          sSig[e] = sig;
        }
        __syncthreads();  // the primal rows and the sigmoids are in
        if (!primal) {
          scale_by_sigmoid(acc, sSig, rg, cg);
          store_h(acc, sH + g * kG, rg, cg);
        }
      } else {
        activate(acc, bias, cg);
        __syncthreads();  // every thread has read H
        store_h(acc, sH + g * kG, rg, cg);
      }
      __syncthreads();
    }

    // ---- output layer: the 64 feature columns on the primal rows, the sdf
    // column on every row (two threads a row, half of k each)
    if (primal) {
      zero(acc);
      accumulate<kWidth, kRows, kUnroll>(sH + g * kG, sW + kOffK5, acc, rg,
                                         cg);
#pragma unroll
      for (int j = 0; j < kRN; ++j) {
        const float bj = sBias[5 * kWidth + 1 + cg * kRN + j];
#pragma unroll
        for (int i = 0; i < kRM; ++i) acc[i][j] += bj;
      }
    }
    const int half = t / kG, row = t % kG;
    const float* hcol = sH + g * kG + half * (kWidth / 2) * kRows + row;
    const float* wcol = sW + kOffK5sdf + half * (kWidth / 2);
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
    for (int k = 0; k < kWidth / 2; k += 4) {
      s0 = fmaf(hcol[k * kRows], wcol[k], s0);
      s1 = fmaf(hcol[(k + 1) * kRows], wcol[k + 1], s1);
      s2 = fmaf(hcol[(k + 2) * kRows], wcol[k + 2], s2);
      s3 = fmaf(hcol[(k + 3) * kRows], wcol[k + 3], s3);
    }
    const float bias_sdf = sBias[5 * kWidth];
    __syncthreads();  // every thread has read H, which the staging reuses
    sPart[half * kRows + g * kG + row] = (s0 + s1) + (s2 + s3);
    if (primal) {     // [points][64], swizzled
#pragma unroll
      for (int i = 0; i < kRM; ++i) {
        const int p = (kGrad ? 0 : g * kG) + tile_row(rg, i);
        st4(sH + p * kWidth + 4 * (cg ^ swizzle(p)), acc[i][0], acc[i][1],
            acc[i][2], acc[i][3]);
      }
    }
    __syncthreads();

    // ---- coalesced, unpadded stores; the ragged tail is masked
    const int n_valid = min(kPoints, N - n0);
    const size_t base = (size_t)b * N + n0;
    for (int i = tid; i < n_valid * (kWidth / 4); i += kThreads) {
      const int p = i / (kWidth / 4), u = i % (kWidth / 4);
      *reinterpret_cast<float4*>(feat + (base + p) * kWidth + 4 * u) =
          ld4(sH + p * kWidth + 4 * (u ^ swizzle(p)));
    }
    for (int p = tid; p < n_valid; p += kThreads)
      sdf[base + p] = sPart[p] + sPart[kRows + p] + bias_sdf;
    if constexpr (kGrad) {
      for (int i = tid; i < n_valid * 3; i += kThreads) {
        const int r = (1 + i % 3) * kG + i / 3;
        grad[base * 3 + i] = sPart[r] + sPart[kRows + r];
      }
    }
    // the next tile writes sBias and sPE, and sH only after a barrier
  }
}

template <bool kGrad>
cudaError_t launch(const float* points, const float* weights,
                   const float* biases, float* sdf, float* feat, float* grad,
                   int B, int N, int force_symmetry, cudaStream_t stream) {
  using S = Smem<kGrad>;
  const size_t smem = S::kFloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_sdf_fwd_kernel<kGrad>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fused_sdf_fwd_kernel<kGrad>, kThreads, smem)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int tiles_per_batch = (N + S::kPoints - 1) / S::kPoints;
  const long long total = (long long)tiles_per_batch * B;
  if (total > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int grid = (int)(total < (long long)sms * per_sm ? total
                                                        : (long long)sms * per_sm);
  fused_sdf_fwd_kernel<kGrad><<<grid, kThreads, smem, stream>>>(
      points, weights, biases, sdf, feat, grad, N, tiles_per_batch,
      (int)total, force_symmetry);
  return cudaGetLastError();
}

}  // namespace

// points [B,N,3], weights packed as above (28,032 floats), biases [B,385];
// sdf [B,N], feat [B,N,64], grad [B,N,3] (ignored unless compute_grad).
// All float32, contiguous, on the current device. Returns a cudaError_t.
extern "C" int scl_fused_sdf_fwd(const void* points, const void* weights,
                                 const void* biases, void* sdf, void* feat,
                                 void* grad, int B, int N, int compute_grad,
                                 int force_symmetry, void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(points);
  const float* w = static_cast<const float*>(weights);
  const float* bi = static_cast<const float*>(biases);
  if (compute_grad)
    return (int)launch<true>(p, w, bi, static_cast<float*>(sdf),
                             static_cast<float*>(feat),
                             static_cast<float*>(grad), B, N, force_symmetry,
                             s);
  return (int)launch<false>(p, w, bi, static_cast<float*>(sdf),
                            static_cast<float*>(feat), nullptr, B, N,
                            force_symmetry, s);
}

extern "C" int scl_fused_sdf_num_weights() { return kNumWeights; }

// Points a tile holds, with tangents (K1) or without (K3).
extern "C" int scl_fused_sdf_fwd_tile_points(int compute_grad) {
  return compute_grad ? Smem<true>::kPoints : Smem<false>::kPoints;
}
