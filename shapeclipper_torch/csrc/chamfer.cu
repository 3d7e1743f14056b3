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
// What bounds it on this card depends on the shape:
//   * With enough rows of A (N1 = 100,000: 391 blocks of 256 rows, about
//     three per SM) it is fp32 issue. A pair costs 3 subtractions,
//     1 multiply, 2 fused multiply-adds and 1 min (or a compare and two
//     selects with the argmin); the data is a few MB (100,000 points are
//     1.2 MB) and stays in L2, so device memory is never the limit. A
//     Chamfer distance needs each pair once; this kernel sweeps once per
//     direction, so it does each pair twice and reaches at most half of
//     the bound.
//   * With few rows of A it is occupancy. The evaluation's GT cloud (2,048
//     points against 100,000) makes 8 blocks of 256 rows: swept whole, they
//     would hold 8 of the 132 SMs for the full 100,000 points.
//
// What the design does about it:
//   * A block owns 256 rows of A (128 threads x 2 rows, in registers: two
//     independent min chains per thread) and walks its part of B in tiles
//     of 2,048 points staged in shared memory as x[], y[], z[] (24 KB).
//     Every thread of a warp reads the same B point, so each 16-byte shared
//     load is a broadcast and feeds 4 points x 2 rows = 8 pairs.
//   * The split: the grid is (ceil(N1 / 256), S, B), and block (r, s, b)
//     sweeps row block r against chunk s of B's cloud: points
//     [s * c, min((s + 1) * c, N2)) with c = ceil(N2 / S) rounded up to a
//     multiple of 4. The wrapper (`ops/chamfer.py::nn_splits`) takes S = 1
//     where the row blocks alone give about two blocks per SM (today's
//     schedule, launch for launch: N1 = 100,000), and otherwise the
//     smallest S that gives about three, with chunks of at least 1,024
//     points: S = 50 chunks of 2,000 points, 400 blocks, for the GT's 2,048
//     rows against 100,000.
//   * B is scanned in index order with a strict `<`, so inside a block the
//     first minimum wins: `jnp.argmin`'s tie rule (`ops/chamfer.py:576`)
//     and torch's.
//   * The combine across chunks (S > 1) is exact and independent of the
//     order in which blocks run, so the result is bitwise the one S = 1
//     gives, and bitwise repeatable. Every distance here is a sum of
//     squares, never negative (nor -0), and for such floats the order of
//     their bits read as unsigned integers is their order as floats. K4:
//     the wrapper fills `dist` with +inf and each block ends with an
//     unsigned `atomicMin` on the bits. K5: the wrapper fills a 64-bit key
//     per row with all ones, each block ends with an `atomicMin` on
//     (distance bits << 32) | j, so the smallest distance wins and, among
//     equal distances, the lowest index, across chunks too; `unpack_kernel`
//     then writes dist and idx. A NaN (either sign) has larger bits than
//     +inf, so it never wins, as `fminf` and the strict `<` ignore it.
//   * The ragged tails are masked here: rows past N1 compute on a clamped
//     row and are not written; the last tile of a chunk stops at the
//     chunk's end. Nothing is padded.

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

// chunk: points of B per chunk (blockIdx.y); key: the 64-bit combine
// buffer of K5 when gridDim.y > 1, else unused.
template <bool kArgmin>
__global__ void __launch_bounds__(kThreads)
    nn_kernel(const float* __restrict__ a, const float* __restrict__ b,
              float* __restrict__ dist, int* __restrict__ idx,
              unsigned long long* __restrict__ key, int N1, int N2,
              int chunk) {
  __shared__ __align__(16) float s[3 * kTile];  // x[kTile] y[kTile] z[kTile]
  const int batch = blockIdx.z;
  const int begin = blockIdx.y * chunk;
  const int end = N2 - begin < chunk ? N2 : begin + chunk;
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

  for (int t0 = begin; t0 < end; t0 += kTile) {
    const int n = end - t0 < kTile ? end - t0 : kTile;
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

  const bool split = gridDim.y > 1;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    if (row[r] >= N1) continue;
    const size_t o = (size_t)batch * N1 + row[r];
    const unsigned bits = __float_as_uint(best[r]);
    if (!split) {
      dist[o] = best[r];
      if (kArgmin) idx[o] = best_j[r];
    } else if (kArgmin) {
      atomicMin(key + o, ((unsigned long long)bits << 32) |
                             (unsigned long long)(unsigned)best_j[r]);
    } else {
      atomicMin(reinterpret_cast<unsigned int*>(dist) + o, bits);
    }
  }
}

// K5 with S > 1: key (distance bits << 32 | j) -> dist, idx.
__global__ void unpack_kernel(const unsigned long long* __restrict__ key,
                              float* __restrict__ dist, int* __restrict__ idx,
                              long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned long long k = key[i];
  dist[i] = __uint_as_float((unsigned)(k >> 32));
  idx[i] = (int)(unsigned)(k & 0xffffffffull);
}

}  // namespace

// a [B,N1,3], b [B,N2,3] float32; dist [B,N1] float32; idx [B,N1] int32 or
// null (null: distances only, K4; else with the argmin, K5); S chunks of
// b's cloud (grid dimension y). With S > 1 the caller fills dist with +inf
// (K4), or key [B,N1] 64-bit with all ones (K5), on the same stream. All
// contiguous, on the current device. Returns a cudaError_t.
extern "C" int scl_chamfer_nn(const void* a, const void* b, void* dist,
                              void* idx, void* key, int B, int N1, int N2,
                              int S, void* stream) {
  if (B <= 0 || B > 65535 || N1 <= 0 || N2 <= 0 || S <= 0 || S > 65535 ||
      (idx && S > 1 && !key))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // ceil(N2 / S) rounded up to a multiple of 4 (`ops/chamfer.py::nn_chunk`)
  const long long chunk = ((N2 + (long long)S - 1) / S + 3) / 4 * 4;
  const dim3 grid((N1 + kRowsPerBlock - 1) / kRowsPerBlock, S, B);
  const float* pa = static_cast<const float*>(a);
  const float* pb = static_cast<const float*>(b);
  float* pd = static_cast<float*>(dist);
  unsigned long long* pk = static_cast<unsigned long long*>(key);
  if (idx) {
    int* pi = static_cast<int*>(idx);
    nn_kernel<true><<<grid, kThreads, 0, s>>>(pa, pb, pd, pi, pk, N1, N2,
                                              (int)chunk);
    if (S > 1) {
      const long long n = (long long)B * N1;
      const int threads = 256;
      unpack_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                      s>>>(pk, pd, pi, n);
    }
  } else {
    nn_kernel<false><<<grid, kThreads, 0, s>>>(pa, pb, pd, nullptr, nullptr,
                                               N1, N2, (int)chunk);
  }
  return (int)cudaGetLastError();
}
