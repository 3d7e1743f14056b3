// What the generic fused SDF pair's two sources share
// (`fused_sdf_generic.cu`, the float32 K8 / K9 in 3xTF32;
// `fused_sdf_generic_bf16.cu`, their bf16 forms; both on the tensor cores):
// the envelope, the run-time architecture and its packed float32 layout, the
// activation and the posenc features, and the sum of K9's per-block
// partials.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxHidden = 16;
constexpr int kMaxWidth = 512;
constexpr int kMaxFreqs = 16;
constexpr float kBeta = 100.f;      // softplus(100 x) / 100
constexpr int kSmemLimit = 232448;  // bytes of shared memory a block can use

struct Arch {
  int n_freqs, n_hidden, width, skip_mask;
  int pe_dim;      // D = 3 + 6 F
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

// K9's second launch: out[i] = sum over the blocks g of part[g][i], g in
// order.
__global__ void sum_partials_kernel(const float* __restrict__ part,
                                    float* __restrict__ out, size_t n,
                                    int blocks) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int g = 0; g < blocks; ++g) s += part[(size_t)g * n + i];
  out[i] = s;
}

// Lets `kernel` take `bytes` of dynamic shared memory (above 48 KB).
template <class K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

// The bf16 forms' host entry points (`fused_sdf_generic_bf16.cu`), which
// the C entry points of `fused_sdf_generic.cu` dispatch to, for the
// architecture (F, L, W, skip mask); the launches return a cudaError_t, the
// sizes -1 outside the envelope.
int sdf_generic_bf16_packed(int f, int l, int w, int m);
int sdf_generic_bf16_fwd_form(int f, int l, int w, int m, bool grad);
int sdf_generic_bf16_tile_points(int f, int l, int w, int m, bool grad,
                                 bool backward);
int sdf_generic_bf16_stash_floats(int f, int l, int w, int m);
int sdf_generic_bf16_bwd_blocks_per_sm(int f, int l, int w, int m);
int sdf_generic_bf16_pack(const float* weights, void* packed, int f, int l,
                          int w, int m, cudaStream_t s);
int sdf_generic_bf16_fwd(const float* points, const void* packed,
                         const float* biases, float* sdf, float* feat,
                         float* grad, int B, int N, bool compute_grad,
                         int force_symmetry, int f, int l, int w, int m,
                         cudaStream_t s);
int sdf_generic_bf16_bwd(const float* points, const void* packed,
                         const float* biases, const float* sbar,
                         const float* fbar, const float* gbar, float* dpoints,
                         float* out, float* partials, float* stash, int B,
                         int N, int grid, int force_symmetry, int f, int l,
                         int w, int m, cudaStream_t s);
