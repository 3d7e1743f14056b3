// Brute-force nearest neighbour between two point clouds, one direction per
// launch, for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of `shapeclipper_tpu/ops/chamfer.py`:
//   * K4, `_nn_dist_one_direction` (the `pl.pallas_call` at line 155): for
//     each point of cloud A the squared distance to its nearest point of
//     cloud B (the metric path: Chamfer-L1 and F-score of every evaluated
//     sample);
//   * K5, `_nn_one_direction` (the `pl.pallas_call` at line 93): the same
//     plus the index of that nearest point (the differentiable chamfer).
// One template, instantiated without and with the argmin.
//
// What it computes, for batch row b and point i of A [B,N1,3] against
// B [B,N2,3]:
//   dist[b,i] = min_j (ax-bx)^2 + (ay-by)^2 + (az-bz)^2
//   idx[b,i]  = the first j (lowest index) that attains it
// in the exact form, as the JAX metric path's default `nodot` sweep does
// (`ops/chamfer.py:199-202`): no |b|^2 - 2 a.b cancellation and no clamp at
// 0 (the Pallas kernels use the dot form with max(., 0)). The two squares of
// y and z are fused multiply-adds, so results differ from the plain
// PyTorch version (three rounded squares, two rounded sums) by a few ulps.
//
// What bounds it on this card: fp32 issue. A pair costs 3 subtractions,
// 1 multiply, 2 fused multiply-adds and 1 min (or a compare and two selects
// with the argmin); the data is a few MB (100,000 points are 1.2 MB) and
// stays in L2, so device memory is never the limit. A Chamfer distance needs
// each pair once (one sweep can min-reduce each tile along both axes); this
// first version sweeps once per direction, so it does each pair twice.
//
// What the design does about it:
//   * A block owns 256 rows of A (128 threads x 2 rows, in registers: two
//     independent min chains per thread) and walks all of B in tiles of
//     2,048 points staged in shared memory as x[], y[], z[] (24 KB). Every
//     thread of a warp reads the same B point, so each 16-byte shared load
//     is a broadcast and feeds 4 points x 2 rows = 8 pairs.
//   * The grid is (ceil(N1 / 256), B): 391 blocks at N1 = 100,000, all
//     resident at once, about three per SM.
//   * B is scanned in index order with a strict `<`, so the first minimum
//     wins: `jnp.argmin`'s tie rule (`ops/chamfer.py:576`) and torch's.
//   * The ragged tails are masked here: rows past N1 compute on a clamped
//     row and are not written; the last tile of B stops at N2. Nothing is
//     padded.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRowsPerThread = 2;
constexpr int kRowsPerBlock = kThreads * kRowsPerThread;
constexpr int kTile = 2048;  // points of B per shared-memory tile

template <bool kArgmin>
__device__ __forceinline__ void visit(float ax, float ay, float az, float bx,
                                      float by, float bz, int j, float& best,
                                      int& best_j) {
  const float dx = ax - bx, dy = ay - by, dz = az - bz;
  float d = dx * dx;
  d = fmaf(dy, dy, d);
  d = fmaf(dz, dz, d);
  if (kArgmin) {
    if (d < best) {
      best = d;
      best_j = j;
    }
  } else {
    best = fminf(best, d);
  }
}

template <bool kArgmin>
__global__ void __launch_bounds__(kThreads)
    nn_kernel(const float* __restrict__ a, const float* __restrict__ b,
              float* __restrict__ dist, int* __restrict__ idx, int N1,
              int N2) {
  __shared__ __align__(16) float s[3 * kTile];  // x[kTile] y[kTile] z[kTile]
  const int batch = blockIdx.y;
  const float* A = a + (size_t)batch * N1 * 3;
  const float* Bp = b + (size_t)batch * N2 * 3;

  float ax[kRowsPerThread], ay[kRowsPerThread], az[kRowsPerThread];
  float best[kRowsPerThread];
  int best_j[kRowsPerThread];
  int row[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    row[r] = blockIdx.x * kRowsPerBlock + r * kThreads + threadIdx.x;
    const int src = row[r] < N1 ? row[r] : N1 - 1;  // masked tail row
    ax[r] = A[(size_t)src * 3 + 0];
    ay[r] = A[(size_t)src * 3 + 1];
    az[r] = A[(size_t)src * 3 + 2];
    best[r] = __int_as_float(0x7f800000);  // +inf
    best_j[r] = 0;
  }

  for (int t0 = 0; t0 < N2; t0 += kTile) {
    const int n = N2 - t0 < kTile ? N2 - t0 : kTile;
    // coalesced copy of n points (3n floats) into the x / y / z arrays
    const float* src = Bp + (size_t)t0 * 3;
    for (int f = threadIdx.x; f < 3 * n; f += kThreads) {
      const int p = f / 3;
      s[(f - 3 * p) * kTile + p] = src[f];
    }
    __syncthreads();

    const int n4 = n & ~3;
    for (int j = 0; j < n4; j += 4) {
      const float4 X = *reinterpret_cast<const float4*>(s + j);
      const float4 Y = *reinterpret_cast<const float4*>(s + kTile + j);
      const float4 Z = *reinterpret_cast<const float4*>(s + 2 * kTile + j);
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        visit<kArgmin>(ax[r], ay[r], az[r], X.x, Y.x, Z.x, t0 + j, best[r],
                       best_j[r]);
        visit<kArgmin>(ax[r], ay[r], az[r], X.y, Y.y, Z.y, t0 + j + 1,
                       best[r], best_j[r]);
        visit<kArgmin>(ax[r], ay[r], az[r], X.z, Y.z, Z.z, t0 + j + 2,
                       best[r], best_j[r]);
        visit<kArgmin>(ax[r], ay[r], az[r], X.w, Y.w, Z.w, t0 + j + 3,
                       best[r], best_j[r]);
      }
    }
    for (int j = n4; j < n; ++j) {
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r)
        visit<kArgmin>(ax[r], ay[r], az[r], s[j], s[kTile + j],
                       s[2 * kTile + j], t0 + j, best[r], best_j[r]);
    }
    __syncthreads();  // the next tile overwrites s
  }

#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    if (row[r] < N1) {
      dist[(size_t)batch * N1 + row[r]] = best[r];
      if (kArgmin) idx[(size_t)batch * N1 + row[r]] = best_j[r];
    }
  }
}

}  // namespace

// a [B,N1,3], b [B,N2,3] float32; dist [B,N1] float32; idx [B,N1] int32 or
// null (null: distances only, K4; else with the argmin, K5). All contiguous,
// on the current device. Returns a cudaError_t.
extern "C" int scl_chamfer_nn(const void* a, const void* b, void* dist,
                              void* idx, int B, int N1, int N2, void* stream) {
  if (B <= 0 || B > 65535 || N1 <= 0 || N2 <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N1 + kRowsPerBlock - 1) / kRowsPerBlock, B);
  const float* pa = static_cast<const float*>(a);
  const float* pb = static_cast<const float*>(b);
  float* pd = static_cast<float*>(dist);
  if (idx)
    nn_kernel<true><<<grid, kThreads, 0, s>>>(pa, pb, pd,
                                              static_cast<int*>(idx), N1, N2);
  else
    nn_kernel<false><<<grid, kThreads, 0, s>>>(pa, pb, pd, nullptr, N1, N2);
  return (int)cudaGetLastError();
}
