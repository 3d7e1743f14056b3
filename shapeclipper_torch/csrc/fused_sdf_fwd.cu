// Fused SDF-MLP forward (+ forward-mode point gradient) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `shapeclipper_tpu/ops/fused_sdf.py::
// _forward_call` (the `pl.pallas_call` at line 311): both instantiations,
// with tangents (K1: render / turntable normals / training) and without
// (K3: the dense SDF grid), each with float32 products (described here, down
// to the bf16 section) and with bf16 products (`_mm_cast("bfloat16")`: the
// tensor-core kernel `fused_sdf_fwd_bf16_kernel` at the end of the file).
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

// A kernel's SMs and resident blocks an SM on each device, found (and its
// shared-memory limit set) at its first launch there and then kept: the
// four runtime queries cost the host more than a short launch does.
constexpr int kMaxDevices = 64;
struct Residency {
  int sms[kMaxDevices];
  int per_sm[kMaxDevices];
};

template <typename Kernel>
cudaError_t residency(Kernel kernel, int threads, size_t smem,
                      Residency& cache, int& sms, int& per_sm) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const bool keep = device >= 0 && device < kMaxDevices;
  if (keep && cache.per_sm[device] > 0) {
    sms = cache.sms[device];
    per_sm = cache.per_sm[device];
    return cudaSuccess;
  }
  if ((err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
           (int)smem)) != cudaSuccess)
    return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  if (keep) {
    cache.sms[device] = sms;
    cache.per_sm[device] = per_sm;
  }
  return cudaSuccess;
}

template <bool kGrad>
cudaError_t launch(const float* points, const float* weights,
                   const float* biases, float* sdf, float* feat, float* grad,
                   int B, int N, int force_symmetry, cudaStream_t stream) {
  using S = Smem<kGrad>;
  const size_t smem = S::kFloats * sizeof(float);
  static Residency cache;
  int sms = 0, per_sm = 0;
  const cudaError_t err = residency(fused_sdf_fwd_kernel<kGrad>, kThreads,
                                    smem, cache, sms, per_sm);
  if (err != cudaSuccess) return err;
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

// ===========================================================================
// bf16 products: K1-bf16 / K3-bf16 on the tensor cores.
//
// What it computes: the function above with every product's operands
// rounded to bfloat16 (nearest even) and float32 sums -- the JAX package's
// `_mm_cast("bfloat16")`. Bias, activation, the tangents' sigmoid scaling
// and the |x| sign stay float32; the outputs are float32.
//
// What bounds it on this card. The bound (989 TFLOP/s of dense bf16
// products plus the elementwise work at 67 TFLOP/s) is far off; what holds
// it at ~30% of that bound (PERF.md) is three pipes of one SM
// sub-partition working on one dependent chain a warp: the mma.sync
// products (55 m16n8k16 a point with tangents: ~0.1 ms at 12 x 32,768 if
// mma.sync issued one an SM a clock), the activations (softplus(100 z) and
// sigmoid(100 z) of every hidden primal value, three MUFU operations each
// at 1/8 of the FMA rate: ~0.1 ms there by the same count) and the
// posenc's sincosf, with the issue slot they share; per warp and tile
// `scripts/sdf_segments.py --kernel fwd-bf16` reads about 40% activations,
// a third products and a fifth posenc. The activations use the fast
// intrinsics (`act_pair_fast`): their results are only ever bf16 operands.
//
// The design: one warp per tile, warps independent (no block barrier in the
// tile loop), products by `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.
// f32` (A 16 x 16 row-major, B 16 x 8, float32 accumulator).
//   * A warp's rows are m16 tiles. With tangents: 8 points, tile 0 =
//     [primal rows; t_x rows], tile 1 = [t_y; t_z], so a thread (lane =
//     4 g + t) holds point g's four rows at the same 16 columns of a layer
//     (2 t, 2 t + 1 of each n8 tile), and activates its primal values and
//     scales its tangent values by their sigmoid in registers. Without
//     tangents: one tile of 16 points, every row primal.
//   * Registers carry the activations from layer to layer: the float32
//     accumulator of n8 tiles 2 kk and 2 kk + 1 is exactly the A fragment of
//     k16 step kk of the next product, so activate, round to bf16 pairs
//     (`__floats2bfloat162_rn`) and go on.
//   * The weights arrive packed: one launch before the kernel
//     (`pack_bf16_kernel`, from the float32 weights) writes them as bf16 B
//     fragments in fragment order (59 KB: each (matrix, k16 step, n8 tile)
//     is 32 lanes x 8 bytes, padding zero), beside the plain bf16 copy that
//     K2-bf16 reads. A block copies the buffer into shared memory with
//     Hopper's bulk copy (`cp.async.bulk`, completing on an mbarrier) while
//     its warps compute their first tile's posenc; a B fragment is then one
//     8-byte load a lane. The output layer's 65 columns take 9 n8 tiles,
//     the 64 features first and the sdf column in tile 8, so a thread
//     stores its two features of a row as one aligned float2; with tangents
//     the t_y / t_z tile computes tile 8 alone.
//   * Posenc once a point: the posenc rows of K0, K1pe and K2pe are packed
//     by lane (`posenc_slot_feature`), so that lane t holds the features of
//     the (coordinate, frequency) pairs t, t + 4, ...: one sincosf a pair,
//     18 a point over its quad, and no exchange between lanes. sign(x0)
//     is folded into the x tangent (exact).
//   * Occupancy (`Bf16Tile`): with tangents 4 warps a block and 3 blocks
//     an SM (12 warps, 168 registers a thread); without, 8 warps and 2
//     blocks (16 warps, 128 registers). The blocks of an SM hold a weight
//     copy each. What does not fit K1-bf16's 168 registers waits in a
//     per-warp shared slot (the posenc A fragments, read back as one
//     conflict-free 16-byte load a k16 step) or is not held at once (a
//     layer's accumulators in two groups of four n8 tiles). At 16 warps and
//     128 registers K1-bf16 spilled and ran slower.
//   * Values that depend on the lane are read where they are used
//     (`lane_id`): held through the tile loop, ptxas spills them.
//   * Biases come through the read-only cache; the outputs are written from
//     the accumulators (sdf and gradient by the lanes holding column 64).
//   * The ragged tail of N reads points as 0 and is not written.
// No atomics: two launches are bitwise equal.
// `SCL_SEGMENT(i)` marks the stages for `scripts/sdf_segments.py --kernel
// fwd-bf16` (`FWD_BF16_SEGMENTS`); they compile to nothing here.

#ifndef SCL_SEGMENT
#define SCL_SEGMENT(i)
#endif

// Fragments of the packed matrices, in this order, each (k16 step, n8 tile)
// a 64-word fragment: K0 [39 -> 48][64], K1h, K1pe, K2h, K2pe, K3, K4 and
// K5 [64][65 -> 72] (columns: features 0-63, then sdf).
constexpr int kPeSteps = 3;                  // posenc k16 steps (48 rows)
constexpr int kHSteps = kWidth / 16;         // hidden k16 steps (4)
constexpr int kNT = kWidth / 8;              // hidden n8 tiles (8)
constexpr int kNTOut = 9;                    // output n8 tiles (72 columns)
constexpr int kFragK0 = 0;
constexpr int kFragK1h = kFragK0 + kPeSteps * kNT;
constexpr int kFragK1pe = kFragK1h + kHSteps * kNT;
constexpr int kFragK2h = kFragK1pe + kPeSteps * kNT;
constexpr int kFragK2pe = kFragK2h + kHSteps * kNT;
constexpr int kFragK3 = kFragK2pe + kPeSteps * kNT;
constexpr int kFragK4 = kFragK3 + kHSteps * kNT;
constexpr int kFragK5 = kFragK4 + kHSteps * kNT;
constexpr int kFrags = kFragK5 + kHSteps * kNTOut;      // 236
constexpr int kFragWords = kFrags * 64;                 // 15,104 words
constexpr int kFragBytes = kFragWords * 4;              // 60,416
constexpr int kPlainWords = kNumWeights / 2;            // 14,016
constexpr int kPairs = 3 * kFreqs;         // (coordinate, frequency) pairs
constexpr int kCopies = 4;                 // bulk copies of the weights
static_assert(kFragBytes % (16 * kCopies) == 0, "16-byte bulk copies");

// What a warp and a block of each instantiation hold, chosen by
// `scripts/fwd_ab.py --bf16` on the card among spill-free configurations
// (PERF.md). Warps a block stay a multiple of 4, so that every SM
// sub-partition (its own registers, tensor core and issue slot) gets the
// same number of warps.
template <bool kGrad>
struct Bf16Tile {
  // m16 tiles a warp: with tangents [primal; t_x] and [t_y; t_z] of 8
  // points; without, one tile of 16 points (two need 128+ registers)
  static constexpr int kM = kGrad ? 2 : 1;
  static constexpr int kPoints = kGrad ? 8 : 16 * kM;    // points a warp
  // warps a block, sharing one weight copy, and blocks an SM (the
  // launch bounds: 168 registers a thread with tangents, 128 without)
  static constexpr int kWarps = kGrad ? 4 : 8;
  static constexpr int kBlocks = kGrad ? 3 : 2;
  // with tangents the posenc A fragments (24 registers, live through
  // layers 0-2) wait in the warp's slot, and a layer's n8 tiles are
  // computed in two groups of four, each activated into the next layer's A
  // fragments before the next group: 168 registers without spills
  static constexpr bool kPeShared = kGrad;
  static constexpr int kNGroups = kGrad ? 2 : 1;
  // a warp's slot, in 16-byte words: the posenc A fragments (kM m16 tiles
  // x 3 k16 steps x 32 lanes)
  static constexpr int kSlot = kPeShared ? kM * kPeSteps * 32 : 0;
  static constexpr size_t kSmem = kFragBytes + 16 + kWarps * kSlot * 16;
};

// The posenc feature that lane t's slot s (s = 4 kk + 2 r + e: k16 step kk,
// register pair r, half e) carries in K0, K1pe and K2pe, or -1 (padding).
// Lane t owns the (coordinate, frequency) pairs p = t, t + 4, ... < 18
// (coordinate p % 3, frequency 2^(p / 3)): slot 0 is coordinate t itself
// (t < 3), slots 1 + 2 i and 2 + 2 i the sin and cos of its pair i. So a
// lane computes only the sincosf of its own pairs, 18 a point over the
// quad, and needs no feature of another lane.
__host__ __device__ inline int posenc_slot_feature(int t, int s) {
  if (s == 0) return t < 3 ? t : -1;
  const int i = (s - 1) / 2, p = t + 4 * i;
  if (p >= kPairs) return -1;
  return 3 + 6 * (p / 3) + 3 * ((s - 1) % 2) + p % 3;
}

// The packed-weight element of fragment word w (lane w / 2, register w % 2)
// half e of fragment `frag`, or -1 for the padding: row 16 kk + 2 (lane %
// 4) + 8 reg + e (in K0, K1pe and K2pe the posenc row of the lane's slot
// 4 kk + 2 reg + e), column 8 j + lane / 4 of its (k16 step kk, n8 tile j).
__host__ __device__ inline int frag_source(int frag, int w, int e) {
  int base, off, rows, nt;
  if (frag >= kFragK5) {
    base = kFragK5; off = kOffK5; rows = kWidth; nt = kNTOut;
  } else if (frag >= kFragK4) {
    base = kFragK4; off = kOffK4; rows = kWidth; nt = kNT;
  } else if (frag >= kFragK3) {
    base = kFragK3; off = kOffK3; rows = kWidth; nt = kNT;
  } else if (frag >= kFragK2pe) {
    base = kFragK2pe; off = kOffK2pe; rows = kPe; nt = kNT;
  } else if (frag >= kFragK2h) {
    base = kFragK2h; off = kOffK2h; rows = kWidth; nt = kNT;
  } else if (frag >= kFragK1pe) {
    base = kFragK1pe; off = kOffK1pe; rows = kPe; nt = kNT;
  } else if (frag >= kFragK1h) {
    base = kFragK1h; off = kOffK1h; rows = kWidth; nt = kNT;
  } else {
    base = kFragK0; off = kOffK0; rows = kPe; nt = kNT;
  }
  const int f = frag - base, kk = f / nt, j = f % nt;
  const int lane = w / 2, reg = w % 2;
  const int n = 8 * j + (lane >> 2);
  if (rows == kPe) {   // the posenc rows, by lane (posenc_slot_feature)
    const int q = posenc_slot_feature(lane & 3, 4 * kk + 2 * reg + e);
    return q < 0 ? -1 : off + q * kWidth + n;
  }
  const int k = 16 * kk + 2 * (lane & 3) + 8 * reg + e;
  if (k >= rows) return -1;
  if (frag < kFragK5) return off + k * kWidth + n;
  if (n < kWidth) return off + k * kOut + 1 + n;     // feature n
  return n == kWidth ? off + k * kOut : -1;          // the sdf column
}

// Two floats rounded to bf16 (nearest even), the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The float32 packed weights -> their bf16 B fragments in fragment order
// (K1-bf16 / K3-bf16) and their plain bf16 copy (K2-bf16), one 32-bit word
// of each a thread.
__global__ void __launch_bounds__(256)
    pack_bf16_kernel(const float* __restrict__ weights,
                     uint32_t* __restrict__ frags,
                     uint32_t* __restrict__ plain) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < kFragWords) {
    const int i0 = frag_source(i / 64, i % 64, 0);
    const int i1 = frag_source(i / 64, i % 64, 1);
    frags[i] = pack_bf16(i0 < 0 ? 0.f : weights[i0],
                         i1 < 0 ? 0.f : weights[i1]);
  }
  if (i < kPlainWords)
    plain[i] = pack_bf16(weights[2 * i], weights[2 * i + 1]);
}

// This thread's lane, read where it is used: a lane-dependent value held
// through the tile loop takes a register in every layer, and ptxas spills
// such values first.
__device__ __forceinline__ int lane_id() {
  int lane;
  asm volatile("mov.u32 %0, %%laneid;\n" : "=r"(lane));
  return lane;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The weights' mbarrier: initialised for one arrival (the thread that
// issues the copies, with their byte count), then waited on at phase 0.
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_copy_weights(uint32_t dst,
                                                  const void* src,
                                                  uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(kFragBytes)
      : "memory");
  constexpr int kChunk = kFragBytes / kCopies;
#pragma unroll
  for (int c = 0; c < kCopies; ++c)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(dst + c * kChunk),
        "l"(static_cast<const char*>(src) + c * kChunk), "r"(kChunk),
        "r"(bar)
        : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar) {
  asm volatile(
      "{\n"
      ".reg .pred ready;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 ready, [%0], 0;\n"
      "@!ready bra WAIT;\n"
      "}\n" ::"r"(bar)
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// (softplus(100 p)/100, sigmoid(100 p)) from z = 100 p with the fast
// intrinsics: both feed bf16 operands only (the next product's activations,
// the tangents' scaling), whose rounding (2^-9 relative) is ~10^4 times
// coarser than the intrinsics' errors.
__device__ __forceinline__ void act_pair_fast(float z, float& act,
                                              float& sig) {
  const float e = __expf(-fabsf(z));
  const float inv = __fdividef(1.f, 1.f + e);
  sig = z >= 0.f ? inv : 1.f - inv;
  act = (fmaxf(z, 0.f) + __logf(1.f + e)) * 0.01f;
}

// The posenc A fragments of a warp's tile (uint32 [m16 tile][k16 step][4]).
// With tangents, rows [point g; its t_x] in tile 0 and [t_y; t_z] in tile
// 1; without, points 16 m + g and 16 m + 8 + g in tile m. Lane t holds the
// features of posenc_slot_feature(t, .), so it evaluates sincosf only for
// its own (coordinate, frequency) pairs, once each a point.
template <bool kGrad>
__device__ __forceinline__ void posenc(const float* __restrict__ points,
                                       int n0, int N, int force_symmetry,
                                       uint32_t (&pe)[Bf16Tile<kGrad>::kM]
                                                     [kPeSteps][4]) {
  constexpr int kPts = kGrad ? 1 : 2 * Bf16Tile<kGrad>::kM;   // its points
  constexpr int kKinds = kGrad ? 4 : 1;      // rows a point has here
  constexpr int kOwn = (kPairs + 3) / 4;     // pairs a lane owns, at most
  const int lane = lane_id();
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int q = 0; q < kPts; ++q) {
    const int n = n0 + (kGrad ? g : (q & 1) * 8 + (q >> 1) * 16 + g);
    float x[3];
#pragma unroll
    for (int d = 0; d < 3; ++d)
      x[d] = n < N ? points[(size_t)n * 3 + d] : 0.f;
    float sgn = 1.f;
    if (force_symmetry) {
      sgn = x[0] < 0.f ? -1.f : 1.f;
      x[0] = fabsf(x[0]);
    }
    // slots 2 i and 2 i + 1 are packed once pair i's sin is known; `even`
    // holds slot 2 i meanwhile ([row kind]: primal, t_x, t_y, t_z)
    float even[kKinds], odd[kKinds];
    // slot 0: coordinate t (derivative 1 along itself)
    even[0] = t == 0 ? x[0] : t == 1 ? x[1] : t == 2 ? x[2] : 0.f;
    if constexpr (kGrad) {
      even[1] = t == 0 ? sgn : 0.f;
      even[2] = t == 1 ? 1.f : 0.f;
      even[3] = t == 2 ? 1.f : 0.f;
    }
#pragma unroll
    for (int i = 0; i <= kOwn; ++i) {
      float next[kKinds];   // slot 2 i + 2: pair i's cos
      if (i < kOwn) {
        const int p = t + 4 * i, d = p % 3;
        float sn = 0.f, cs = 0.f, f = 0.f;
        if (p < kPairs) {
          f = (float)(1 << (p / 3));
          sincosf((d == 0 ? x[0] : d == 1 ? x[1] : x[2]) * f, &sn, &cs);
        }
        odd[0] = sn;
        next[0] = cs;
        if constexpr (kGrad) {
          const float ds = f * cs, dc = -f * sn;   // d sin, d cos
          odd[1] = d == 0 ? sgn * ds : 0.f;
          next[1] = d == 0 ? sgn * dc : 0.f;
          odd[2] = d == 1 ? ds : 0.f;
          next[2] = d == 1 ? dc : 0.f;
          odd[3] = d == 2 ? ds : 0.f;
          next[3] = d == 2 ? dc : 0.f;
        }
      } else {   // slot 11: padding
#pragma unroll
        for (int r = 0; r < kKinds; ++r) odd[r] = 0.f;
      }
      // slot 2 i = 4 kk + 2 h: register 2 h (row g) / 2 h + 1 (row g + 8)
      // of tile m, the even slot in the low half
      const int kk = i / 2, h = i % 2;
      if constexpr (kGrad) {
        pe[0][kk][2 * h] = pack_bf16(even[0], odd[0]);
        pe[0][kk][2 * h + 1] = pack_bf16(even[1], odd[1]);
        pe[1][kk][2 * h] = pack_bf16(even[2], odd[2]);
        pe[1][kk][2 * h + 1] = pack_bf16(even[3], odd[3]);
      } else {   // point q: tile q / 2, row g (q even) or g + 8
        pe[q >> 1][kk][2 * h + (q & 1)] = pack_bf16(even[0], odd[0]);
      }
      if (i < kOwn) {
#pragma unroll
        for (int r = 0; r < kKinds; ++r) even[r] = next[r];
      }
    }
  }
}

template <bool kGrad>
__global__ void __launch_bounds__(32 * Bf16Tile<kGrad>::kWarps,
                                  Bf16Tile<kGrad>::kBlocks)
    fused_sdf_fwd_bf16_kernel(const float* __restrict__ points,
                              const uint2* __restrict__ frags,
                              const float* __restrict__ biases,
                              float* __restrict__ sdf,
                              float* __restrict__ feat,
                              float* __restrict__ grad, int N,
                              int tiles_per_batch, int total_tiles,
                              int force_symmetry) {
  using T = Bf16Tile<kGrad>;
  constexpr int kP = T::kPoints;
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  const uint2* sB = reinterpret_cast<const uint2*>(smem_bf16);
  const uint32_t bar = smem_u32(smem_bf16 + kFragBytes);
  const int warp = threadIdx.x / 32;
  // this warp's slot
  uint4* const slot = reinterpret_cast<uint4*>(smem_bf16 + kFragBytes + 16) +
                      warp * T::kSlot;

  if (threadIdx.x == 0) mbar_init(bar);
  __syncthreads();
  if (threadIdx.x == 0) bulk_copy_weights(smem_u32(smem_bf16), frags, bar);
  bool staged = false;
  constexpr int kWarps = T::kWarps;
  constexpr bool kPeShared = T::kPeShared;
  constexpr int kNGroups = T::kNGroups;
  for (int tile = blockIdx.x * kWarps + warp; tile < total_tiles;
       tile += gridDim.x * kWarps) {
    const int b = tile / tiles_per_batch;
    const int n0 = (tile % tiles_per_batch) * kP;
    constexpr int kM = T::kM;
    uint32_t pe[kM][kPeSteps][4];
    posenc<kGrad>(points + (size_t)b * N * 3, n0, N, force_symmetry, pe);
    if constexpr (kPeShared) {
      // each lane reads back only its own words: no barrier
      uint4* const own = slot + lane_id();
#pragma unroll
      for (int m = 0; m < kM; ++m) {
#pragma unroll
        for (int kk = 0; kk < kPeSteps; ++kk)
          own[(m * kPeSteps + kk) * 32] = make_uint4(
              pe[m][kk][0], pe[m][kk][1], pe[m][kk][2], pe[m][kk][3]);
      }
    }
    SCL_SEGMENT(1);
    if (!staged) {   // the first tile's posenc overlapped the copy
      mbar_wait(bar);
      staged = true;
      SCL_SEGMENT(0);
    }

    // ---- hidden layers 0..4, the activations carried in registers; a
    // layer's 8 n8 tiles in kNGroups groups, each group's accumulators
    // activated into the next layer's A fragments before the next group
    uint32_t h[kM][kHSteps][4];
#pragma unroll
    for (int l = 0; l < 5; ++l) {
      constexpr int kGT = kNT / kNGroups;    // n8 tiles a group
      uint32_t hn[kM][kHSteps][4];
#pragma unroll
      for (int grp = 0; grp < kNGroups; ++grp) {
        float acc[kM][kGT][4];
#pragma unroll
        for (int m = 0; m < kM; ++m) {
#pragma unroll
          for (int j = 0; j < kGT; ++j) {
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[m][j][r] = 0.f;
          }
        }
        const uint2* const lb = sB + lane_id();   // this lane's B words
        if (l > 0) {
          const int frag = l == 1 ? kFragK1h : l == 2 ? kFragK2h
                           : l == 3 ? kFragK3 : kFragK4;
#pragma unroll
          for (int kk = 0; kk < kHSteps; ++kk) {
#pragma unroll
            for (int j = 0; j < kGT; ++j) {
              const uint2 bj = lb[(frag + kk * kNT + grp * kGT + j) * 32];
#pragma unroll
              for (int m = 0; m < kM; ++m) mma_bf16(acc[m][j], h[m][kk], bj);
            }
          }
        }
        if (l < 3) {
          const int frag = l == 0 ? kFragK0 : l == 1 ? kFragK1pe : kFragK2pe;
#pragma unroll
          for (int kk = 0; kk < kPeSteps; ++kk) {
            uint32_t a[kM][4];
#pragma unroll
            for (int m = 0; m < kM; ++m) {
              if constexpr (kPeShared) {
                const uint4 v = slot[(m * kPeSteps + kk) * 32 + lane_id()];
                a[m][0] = v.x; a[m][1] = v.y; a[m][2] = v.z; a[m][3] = v.w;
              } else {
#pragma unroll
                for (int r = 0; r < 4; ++r) a[m][r] = pe[m][kk][r];
              }
            }
#pragma unroll
            for (int j = 0; j < kGT; ++j) {
              const uint2 bj = lb[(frag + kk * kNT + grp * kGT + j) * 32];
#pragma unroll
              for (int m = 0; m < kM; ++m) mma_bf16(acc[m][j], a[m], bj);
            }
          }
        }
        SCL_SEGMENT(2 + l);
        // bias and activation; the next layer's A fragments
        const int t = lane_id() & 3;
        const float* bl = biases + (size_t)b * kBiasStride + l * kWidth;
#pragma unroll
        for (int jj = 0; jj < kGT; ++jj) {
          const int j = grp * kGT + jj;
          const float b0 = __ldg(bl + 8 * j + 2 * t);
          const float b1 = __ldg(bl + 8 * j + 2 * t + 1);
          float o[kM][4];
          if constexpr (kGrad) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float act, sig;
              act_pair_fast(100.f * (acc[0][jj][e] + (e ? b1 : b0)), act,
                            sig);
              o[0][e] = act;
              o[0][2 + e] = acc[0][jj][2 + e] * sig;   // t_x
              o[1][e] = acc[1][jj][e] * sig;           // t_y
              o[1][2 + e] = acc[1][jj][2 + e] * sig;   // t_z
            }
          } else {
#pragma unroll
            for (int m = 0; m < kM; ++m) {
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                float sig;
                act_pair_fast(100.f * (acc[m][jj][r] + (r & 1 ? b1 : b0)),
                              o[m][r], sig);
              }
            }
          }
          // n8 tile j is half (j & 1) of k16 step j / 2
#pragma unroll
          for (int m = 0; m < kM; ++m) {
            hn[m][j / 2][2 * (j & 1)] = pack_bf16(o[m][0], o[m][1]);
            hn[m][j / 2][2 * (j & 1) + 1] = pack_bf16(o[m][2], o[m][3]);
          }
        }
        SCL_SEGMENT(7 + l);
      }
#pragma unroll
      for (int m = 0; m < kM; ++m) {
#pragma unroll
        for (int kk = 0; kk < kHSteps; ++kk) {
#pragma unroll
          for (int r = 0; r < 4; ++r) h[m][kk][r] = hn[m][kk][r];
        }
      }
    }

    // ---- output layer, one n8 tile at a time: the 64 features (with
    // tangents of the primal rows only), then the sdf column (tile 8;
    // with tangents also the [t_y; t_z] tile's, the gradient)
    // the output layer's biases: [sdf, feature 0..63]
    const float* bo = biases + (size_t)b * kBiasStride + 5 * kWidth;
    const size_t row0 = (size_t)b * N + n0;
    const int lane = lane_id();
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      float c[kM][4] = {};
#pragma unroll
      for (int kk = 0; kk < kHSteps; ++kk) {
        const uint2 bj = sB[(kFragK5 + kk * kNTOut + j) * 32 + lane];
#pragma unroll
        for (int m = 0; m < (kGrad ? 1 : kM); ++m)
          mma_bf16(c[m], h[m][kk], bj);
      }
      const int col = 8 * j + 2 * t;
      const float b0 = __ldg(bo + 1 + col), b1 = __ldg(bo + 2 + col);
      // rows of this thread: with tangents point g (tile 0, registers
      // 0-1); without, points 16 m + g and 16 m + 8 + g of tile m
#pragma unroll
      for (int q = 0; q < (kGrad ? 1 : 2 * kM); ++q) {
        const int m = q >> 1, half = q & 1;
        const int p = kGrad ? g : m * 16 + half * 8 + g;
        if (n0 + p < N)
          *reinterpret_cast<float2*>(feat + (row0 + p) * kWidth + col) =
              make_float2(c[m][2 * half] + b0, c[m][2 * half + 1] + b1);
      }
    }
    {
      float c[kM][4] = {};
#pragma unroll
      for (int kk = 0; kk < kHSteps; ++kk) {
        const uint2 bj = sB[(kFragK5 + kk * kNTOut + kNT) * 32 + lane];
#pragma unroll
        for (int m = 0; m < kM; ++m) mma_bf16(c[m], h[m][kk], bj);
      }
      if (t == 0) {   // column 64
        const float bs = __ldg(bo);
#pragma unroll
        for (int q = 0; q < (kGrad ? 1 : 2 * kM); ++q) {
          const int m = q >> 1, half = q & 1;
          const int p = kGrad ? g : m * 16 + half * 8 + g;
          if (n0 + p >= N) continue;
          sdf[row0 + p] = c[m][2 * half] + bs;
          if constexpr (kGrad) {
            grad[(row0 + p) * 3] = c[0][2];
            grad[(row0 + p) * 3 + 1] = c[1][0];
            grad[(row0 + p) * 3 + 2] = c[1][2];
          }
        }
      }
    }
    SCL_SEGMENT(12);
  }
  if (!staged) mbar_wait(bar);   // no tile: the copy still lands first
}

template <bool kGrad>
cudaError_t launch_bf16(const float* points, const void* frags,
                        const float* biases, float* sdf, float* feat,
                        float* grad, int B, int N, int force_symmetry,
                        cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(frags) % 16) return cudaErrorInvalidValue;
  const size_t smem = Bf16Tile<kGrad>::kSmem;
  static Residency cache;
  int sms = 0, per_sm = 0;
  const cudaError_t err = residency(fused_sdf_fwd_bf16_kernel<kGrad>,
                                    32 * Bf16Tile<kGrad>::kWarps, smem,
                                    cache, sms,
                                    per_sm);
  if (err != cudaSuccess) return err;
  constexpr int kP = Bf16Tile<kGrad>::kPoints;
  const int tiles_per_batch = (N + kP - 1) / kP;
  const long long total = (long long)tiles_per_batch * B;
  if (total > 0x7fffffffLL) return cudaErrorInvalidValue;
  constexpr int kWarps = Bf16Tile<kGrad>::kWarps;
  const long long blocks = (total + kWarps - 1) / kWarps;
  const int grid = (int)(blocks < (long long)sms * per_sm
                             ? blocks : (long long)sms * per_sm);
  fused_sdf_fwd_bf16_kernel<kGrad><<<grid, 32 * kWarps, smem, stream>>>(
      points, static_cast<const uint2*>(frags), biases, sdf, feat, grad, N,
      tiles_per_batch, (int)total, force_symmetry);
  return cudaGetLastError();
}

}  // namespace

// points [B,N,3], weights packed as above (28,032 floats; with mm_bf16
// the bf16 fragments of `scl_fused_sdf_pack_bf16`, 16-byte aligned),
// biases [B,385]; sdf [B,N], feat [B,N,64], grad [B,N,3] (ignored unless
// compute_grad). Float32 but for the bf16 fragments, contiguous, on the
// current device. Returns a cudaError_t.
extern "C" int scl_fused_sdf_fwd(const void* points, const void* weights,
                                 const void* biases, void* sdf, void* feat,
                                 void* grad, int B, int N, int compute_grad,
                                 int force_symmetry, int mm_bf16,
                                 void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(points);
  const float* bi = static_cast<const float*>(biases);
  float* so = static_cast<float*>(sdf);
  float* fo = static_cast<float*>(feat);
  float* go = static_cast<float*>(grad);
  if (mm_bf16)
    return (int)(compute_grad
                     ? launch_bf16<true>(p, weights, bi, so, fo, go, B, N,
                                         force_symmetry, s)
                     : launch_bf16<false>(p, weights, bi, so, fo, nullptr, B,
                                          N, force_symmetry, s));
  const float* w = static_cast<const float*>(weights);
  if (compute_grad)
    return (int)launch<true>(p, w, bi, so, fo, go, B, N, force_symmetry, s);
  return (int)launch<false>(p, w, bi, so, fo, nullptr, B, N, force_symmetry,
                            s);
}

// weights [28,032] float32 -> frags (the 15,104 32-bit words of the bf16
// B fragments that K1-bf16 / K3-bf16 read) and plain (their [28,032] bf16
// copy, packed as above, which K2-bf16 reads): one launch on `stream`.
// Returns a cudaError_t.
extern "C" int scl_fused_sdf_pack_bf16(const void* weights, void* frags,
                                       void* plain, void* stream) {
  constexpr int kWords = kFragWords > kPlainWords ? kFragWords : kPlainWords;
  pack_bf16_kernel<<<(kWords + 255) / 256, 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(weights), static_cast<uint32_t*>(frags),
      static_cast<uint32_t*>(plain));
  return (int)cudaGetLastError();
}

extern "C" int scl_fused_sdf_num_weights() { return kNumWeights; }

extern "C" int scl_fused_sdf_bf16_frag_words() { return kFragWords; }

// Points a tile holds, with tangents (K1) or without (K3): a block's tile
// for the float32 products, a warp's for the bf16 ones.
extern "C" int scl_fused_sdf_fwd_tile_points(int compute_grad, int mm_bf16) {
  if (mm_bf16) return compute_grad ? Bf16Tile<true>::kPoints
                                   : Bf16Tile<false>::kPoints;
  return compute_grad ? Smem<true>::kPoints : Smem<false>::kPoints;
}
