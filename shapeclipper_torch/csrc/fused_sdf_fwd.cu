// Fused SDF-MLP forward (+ forward-mode point gradient) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `shapeclipper_tpu/ops/fused_sdf.py::
// _forward_call` (the `pl.pallas_call` at line 311): both instantiations,
// with tangents (render / turntable normals) and without (dense SDF grid).
//
// What it computes, per point x of batch row b (default architecture):
//   |x| symmetry on x0 (sign kept for the chain rule), posenc with 6
//   frequencies -> 39 features, 6 linear layers of width 64 with softplus(100)
//   between them, skips at layers 1 and 2 (kernels pre-scaled by 1/sqrt 2),
//   the latent folded into per-sample biases by the caller. With tangents,
//   every point carries four rows [primal; t_x; t_y; t_z] through the same
//   products, so d sdf / dx falls out of the tangent rows' sdf column.
//   Outputs are written unpadded: sdf [B,N], feat [B,N,64], grad [B,N,3].
//
// What bounds it on this card: arithmetic. With tangents a point costs
// 4 rows x 28,032 MACs = 224 kFLOP (56 kFLOP without), against 12 bytes read
// and 260-272 bytes written, i.e. ~800 FLOP per byte; fp32 FMA throughput is
// the roof (no tensor cores in this first version).
//
// What the design does about it:
//   * All 28,032 layer weights (112 KB) are staged once per block in dynamic
//     shared memory; blocks are persistent and walk over tiles, so weights are
//     read from device memory once per SM, not once per tile.
//   * A tile is 128 rows (32 points x 4 rows with tangents, 128 points
//     without). Its activations live transposed in shared memory
//     ([channel][row], 32 KB + 20 KB for the posenc rows) and never touch
//     device memory between layers.
//   * Each of the 256 threads owns an 8-row x 4-channel register tile: per
//     input channel it does 3 vector shared loads for 32 FMAs. The 8 rows are
//     two whole points (all four rows each), so the activation, which needs
//     the primal row's sigmoid for the tangent rows, stays in registers.
//   * Activation shares one exp between softplus and sigmoid, as `_act_pair`.
//   * The ragged tail of N is masked in the kernel (points past N read as 0
//     and are not written); no padding of the inputs or outputs.

#include <cuda_runtime.h>

namespace {

constexpr int kWidth = 64;                 // hidden width
constexpr int kFreqs = 6;
constexpr int kPe = 3 + 6 * kFreqs;        // 39 posenc features
constexpr int kOut = kWidth + 1;           // sdf + 64 feature channels
constexpr int kRows = 128;                 // rows per tile
constexpr int kThreads = 256;
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
// In shared memory K5 is split into [64][64] (columns 0..63) followed by its
// last column [64], so that every weight row is 16-byte aligned.
constexpr int kOffK5last = kOffK5 + kWidth * kWidth;

// Packed per-sample biases [B][5*64 + 65].
constexpr int kBiasStride = 5 * kWidth + kOut;

// Output staging [kRows][kOutLd], aliased onto the activation buffers.
constexpr int kOutLd = kOut;

constexpr int kSmemFloats = kNumWeights + (kWidth + kPe) * kRows + kRows;
static_assert(kRows * kOutLd <= (kWidth + kPe) * kRows, "output staging fits");
static_assert(kOffK5 % 4 == 0 && kNumWeights % 4 == 0, "16-byte alignment");
static_assert((kRows / kRM) * (kWidth / kRN) == kThreads, "thread tiling");

// acc[i][j] += srcT[k][rows i] * w[k][channels j] over k < K.
template <int K>
__device__ __forceinline__ void accumulate(const float* __restrict__ srcT,
                                           const float* __restrict__ w,
                                           float (&acc)[kRM][kRN], int rg,
                                           int cg) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float4 a0 =
        *reinterpret_cast<const float4*>(srcT + k * kRows + rg * kRM);
    const float4 a1 =
        *reinterpret_cast<const float4*>(srcT + k * kRows + rg * kRM + 4);
    const float4 wv =
        *reinterpret_cast<const float4*>(w + k * kWidth + cg * kRN);
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

// Bias on primal rows, then (softplus(100 z)/100, sigmoid(100 z)) from one
// exp; tangent rows are scaled by the primal row's sigmoid. The result
// replaces the activations in sH once every thread has finished reading them.
template <bool kGrad>
__device__ __forceinline__ void hidden_epilogue(float (&acc)[kRM][kRN],
                                                const float* __restrict__ bias,
                                                float* sH, int rg, int cg) {
#pragma unroll
  for (int i = 0; i < kRM; i += (kGrad ? 4 : 1)) {
#pragma unroll
    for (int j = 0; j < kRN; ++j) {
      const float z = 100.f * (acc[i][j] + __ldg(bias + cg * kRN + j));
      const float e = expf(-fabsf(z));
      const float inv = 1.f / (1.f + e);
      const float sig = z >= 0.f ? inv : 1.f - inv;
      acc[i][j] = (fmaxf(z, 0.f) + log1pf(e)) / 100.f;
      if constexpr (kGrad) {
        acc[i + 1][j] *= sig;
        acc[i + 2][j] *= sig;
        acc[i + 3][j] *= sig;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kRN; ++j) {
    float* dst = sH + (cg * kRN + j) * kRows + rg * kRM;
    *reinterpret_cast<float4*>(dst) =
        make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
    *reinterpret_cast<float4*>(dst + 4) =
        make_float4(acc[4][j], acc[5][j], acc[6][j], acc[7][j]);
  }
  __syncthreads();
}

template <bool kGrad>
__global__ void __launch_bounds__(kThreads, 1)
    fused_sdf_fwd_kernel(const float* __restrict__ points,
                         const float* __restrict__ weights,
                         const float* __restrict__ biases,
                         float* __restrict__ sdf, float* __restrict__ feat,
                         float* __restrict__ grad, int N, int tiles_per_batch,
                         int total_tiles, int force_symmetry) {
  extern __shared__ __align__(16) float smem[];
  float* sW = smem;                       // weights
  float* sH = smem + kNumWeights;         // [64][kRows] hidden activations
  float* sPE = sH + kWidth * kRows;       // [39][kRows] posenc rows
  float* sSign = sPE + kPe * kRows;       // [points] sign of x0
  float* sOut = sH;                       // [kRows][kOutLd], after layer 5
  constexpr int kPoints = kGrad ? kRows / 4 : kRows;

  const int tid = threadIdx.x;
  const int rg = tid % (kRows / kRM);     // rows rg*8 .. rg*8+7
  const int cg = tid / (kRows / kRM);     // channels cg*4 .. cg*4+3

  for (int i = tid; i < kOffK5; i += kThreads) sW[i] = weights[i];
  for (int i = tid; i < kWidth * kOut; i += kThreads) {
    const int k = i / kOut, c = i % kOut;
    const float v = weights[kOffK5 + i];
    if (c < kWidth)
      sW[kOffK5 + k * kWidth + c] = v;
    else
      sW[kOffK5last + k] = v;
  }

  for (int tile = blockIdx.x; tile < total_tiles; tile += gridDim.x) {
    const int b = tile / tiles_per_batch;
    const int n0 = (tile % tiles_per_batch) * kPoints;
    const float* bias_b = biases + (size_t)b * kBiasStride;

    // ---- |x| symmetry + posenc (and its tangents) into sPE
    for (int i = tid; i < kPoints * 3; i += kThreads) {
      const int p = i / 3, d = i % 3;
      const int n = n0 + p;
      float x = n < N ? points[((size_t)b * N + n) * 3 + d] : 0.f;
      if (d == 0) {
        sSign[p] = (force_symmetry && x < 0.f) ? -1.f : 1.f;
        if (force_symmetry) x = fabsf(x);
      }
      const int r = kGrad ? 4 * p : p;
      sPE[d * kRows + r] = x;
      if constexpr (kGrad) {
#pragma unroll
        for (int e = 0; e < 3; ++e) sPE[d * kRows + r + 1 + e] = e == d ? 1.f : 0.f;
      }
      float f = 1.f;
#pragma unroll
      for (int k = 0; k < kFreqs; ++k, f *= 2.f) {
        float s, c;
        sincosf(x * f, &s, &c);
        const int js = 3 + 6 * k + d, jc = js + 3;
        sPE[js * kRows + r] = s;
        sPE[jc * kRows + r] = c;
        if constexpr (kGrad) {
#pragma unroll
          for (int e = 0; e < 3; ++e) {
            sPE[js * kRows + r + 1 + e] = e == d ? f * c : 0.f;
            sPE[jc * kRows + r + 1 + e] = e == d ? -f * s : 0.f;
          }
        }
      }
    }
    __syncthreads();

    float acc[kRM][kRN];
    zero(acc);
    accumulate<kPe>(sPE, sW + kOffK0, acc, rg, cg);
    hidden_epilogue<kGrad>(acc, bias_b + 0 * kWidth, sH, rg, cg);

    zero(acc);
    accumulate<kWidth>(sH, sW + kOffK1h, acc, rg, cg);
    accumulate<kPe>(sPE, sW + kOffK1pe, acc, rg, cg);
    hidden_epilogue<kGrad>(acc, bias_b + 1 * kWidth, sH, rg, cg);

    zero(acc);
    accumulate<kWidth>(sH, sW + kOffK2h, acc, rg, cg);
    accumulate<kPe>(sPE, sW + kOffK2pe, acc, rg, cg);
    hidden_epilogue<kGrad>(acc, bias_b + 2 * kWidth, sH, rg, cg);

    zero(acc);
    accumulate<kWidth>(sH, sW + kOffK3, acc, rg, cg);
    hidden_epilogue<kGrad>(acc, bias_b + 3 * kWidth, sH, rg, cg);

    zero(acc);
    accumulate<kWidth>(sH, sW + kOffK4, acc, rg, cg);
    hidden_epilogue<kGrad>(acc, bias_b + 4 * kWidth, sH, rg, cg);

    // ---- output layer: columns 0..63 in the register tile, column 64 (the
    // last feature channel) for the primal rows, one row per thread
    zero(acc);
    accumulate<kWidth>(sH, sW + kOffK5, acc, rg, cg);
    const float* bias5 = bias_b + 5 * kWidth;
    const int last_row = kGrad ? 4 * tid : tid;
    float last = 0.f;
    if (tid < kPoints) {
#pragma unroll 8
      for (int k = 0; k < kWidth; ++k)
        last = fmaf(sH[k * kRows + last_row], sW[kOffK5last + k], last);
      last += __ldg(bias5 + kWidth);
    }
#pragma unroll
    for (int i = 0; i < kRM; i += (kGrad ? 4 : 1)) {
#pragma unroll
      for (int j = 0; j < kRN; ++j) acc[i][j] += __ldg(bias5 + cg * kRN + j);
    }
    __syncthreads();  // sOut aliases sH / sPE
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
#pragma unroll
      for (int j = 0; j < kRN; ++j)
        sOut[(rg * kRM + i) * kOutLd + cg * kRN + j] = acc[i][j];
    }
    if (tid < kPoints) sOut[last_row * kOutLd + kWidth] = last;
    __syncthreads();

    // ---- coalesced, unpadded stores; the ragged tail is masked
    const int n_valid = min(kPoints, N - n0);
    for (int i = tid; i < n_valid * kWidth; i += kThreads) {
      const int p = i / kWidth, c = i % kWidth;
      const int r = kGrad ? 4 * p : p;
      feat[((size_t)b * N + n0) * kWidth + i] = sOut[r * kOutLd + 1 + c];
    }
    for (int p = tid; p < n_valid; p += kThreads) {
      const int r = kGrad ? 4 * p : p;
      sdf[(size_t)b * N + n0 + p] = sOut[r * kOutLd];
    }
    if constexpr (kGrad) {
      for (int i = tid; i < n_valid * 3; i += kThreads) {
        const int p = i / 3, d = i % 3;
        float g = sOut[(4 * p + 1 + d) * kOutLd];
        if (d == 0) g *= sSign[p];
        grad[((size_t)b * N + n0) * 3 + i] = g;
      }
    }
    __syncthreads();  // the next tile overwrites sPE / sSign / sOut
  }
}

template <bool kGrad>
cudaError_t launch(const float* points, const float* weights,
                   const float* biases, float* sdf, float* feat, float* grad,
                   int B, int N, int force_symmetry, cudaStream_t stream) {
  constexpr int kPoints = kGrad ? kRows / 4 : kRows;
  const size_t smem = kSmemFloats * sizeof(float);
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
  const int tiles_per_batch = (N + kPoints - 1) / kPoints;
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
