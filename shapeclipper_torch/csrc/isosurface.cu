// Marching tetrahedra and area-weighted surface sampling of level grids,
// for Hopper (sm_90a).
//
// Replaces no `pl.pallas_call`: the JAX package computes this path in XLA
// (`shapeclipper_tpu/eval3d/device_isosurface.py`, `triangle_areas` and
// `sample_level_surface`), where fusion keeps its [C, 6, 4] and [T, 3, 3]
// temporaries out of memory. Written out in eager PyTorch it would be about
// a hundred launches over such temporaries a sample, so it is two kernels:
//   * K6, `cell_area_kernel`: one thread a (sample, cell). It loads the
//     cell's 8 corners, splits the cell into the 6 main-diagonal tetrahedra
//     and sums the areas of the 12 triangle slots (2 a tetrahedron, masked
//     by its sign case) in float64 -> sums [B, C]. The wrapper's
//     `torch.cumsum` (float64) turns them into each sample's CDF over the
//     cells.
//   * K7, `draw_kernel`: one thread a drawn point. It finds the cell whose
//     CDF interval holds r * total (the first CDF value > r * total: the
//     `searchsorted(side="right")` of the flattened slot CDF), recomputes
//     that cell's 12 slot areas as K6 did and walks them in float64 from the
//     previous cell's CDF value to the first slot that passes r * total, then
//     rebuilds the slot's three vertices from its tetrahedron's 4 corners,
//     draws the barycentric point (the host sampler's flip trick) and scales
//     it to world coordinates, pts / M * (max - min) + min. A sample whose
//     total area is 0 gets zeros; a draw that passes no slot takes the
//     cell's last one, so that r * total at the total gives face T - 1, the
//     JAX package's clip. The flattened face index is written only when the
//     caller passes a face buffer (the checks do; the evaluation keeps only
//     the points).
// Every float32 step follows the plain version (`eval3d/
// device_isosurface.py`): the strict `< isovalue` sign test, the 1e-12 lerp
// guard and the [0, 1] clip, pa (1 - t) + pb t, the cross product's terms,
// the squares summed x, y, z, 0.5 sqrt. Products, sums, the division and the
// square root are the `__f*_rn` intrinsics, so nvcc fuses none of them into
// a multiply-add and nothing is approximate: the kernels give the plain
// version's areas and points bit for bit.
//
// What bounds them: at vox 64 K6 reads a 1.1 MB grid and writes 2.1 MB of
// sums, and K7 reads 12 bytes of draws and writes 12 bytes a point, plus
// ~17 dependent CDF reads of its binary search (L2-resident: 2.1 MB) and 8
// corners. Both are launch- and latency-sized at these shapes (a few us of
// bytes); the design keeps one thread per independent unit and no shared
// memory. The case and edge tables sit in `__constant__` memory, written
// once a device from the port's own tables (`scl_iso_tables`).

#include <cuda_runtime.h>

namespace {

// [6][4] corner id (x + 2y + 4z) of each tetrahedron vertex
__constant__ int kTets[24];
// [16][2][3] (inside, outside) tetrahedron vertex of each triangle vertex
__constant__ int kEdgeA[96];
__constant__ int kEdgeB[96];
// [16][2] slot s of sign case c holds a triangle
__constant__ int kValid[32];

constexpr int kThreads = 256;

struct Cell {
  float v[8];       // corner values, corner id x + 2y + 4z
  float base[3];    // cell coordinates (i, j, k) as float
};

__device__ __forceinline__ void load_cell(const float* __restrict__ lv,
                                          long long M, long long cell,
                                          Cell& c) {
  const long long n = M - 1;
  const long long i = cell / (n * n), j = (cell / n) % n, k = cell % n;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const long long x = i + (q & 1), y = j + ((q >> 1) & 1),
                    z = k + ((q >> 2) & 1);
    c.v[q] = lv[(x * M + y) * M + z];
  }
  c.base[0] = (float)i;
  c.base[1] = (float)j;
  c.base[2] = (float)k;
}

// the 4 vertex values of tetrahedron t and its sign case
__device__ __forceinline__ int tet_case(const Cell& c, int t, float iso,
                                        float vals[4]) {
  int cs = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    vals[q] = c.v[kTets[t * 4 + q]];
    if (vals[q] < iso) cs |= 1 << q;
  }
  return cs;
}

// the crossing on the edge (a, b) of tetrahedron t, grid-index coordinates
__device__ __forceinline__ void lerp_vertex(const Cell& c, int t,
                                            const float vals[4], int a, int b,
                                            float iso, float p[3]) {
  const float va = vals[a], vb = vals[b];
  float denom = __fsub_rn(vb, va);
  if (fabsf(denom) < 1e-12f) denom = 1e-12f;
  float s = __fdiv_rn(__fsub_rn(iso, va), denom);
  s = fminf(fmaxf(s, 0.0f), 1.0f);
  const float one_minus = __fsub_rn(1.0f, s);
  const int ca = kTets[t * 4 + a], cb = kTets[t * 4 + b];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float pa = __fadd_rn(c.base[d], (float)((ca >> d) & 1));
    const float pb = __fadd_rn(c.base[d], (float)((cb >> d) & 1));
    p[d] = __fadd_rn(__fmul_rn(pa, one_minus), __fmul_rn(pb, s));
  }
}

// the three vertices of slot `slot` of tetrahedron t in sign case `cs`
__device__ __forceinline__ void slot_vertices(const Cell& c, int t, int cs,
                                              int slot, const float vals[4],
                                              float iso, float p[3][3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int e = (cs * 2 + slot) * 3 + k;
    lerp_vertex(c, t, vals, kEdgeA[e], kEdgeB[e], iso, p[k]);
  }
}

__device__ __forceinline__ float tri_area(const float p[3][3]) {
  float e1[3], e2[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    e1[d] = __fsub_rn(p[1][d], p[0][d]);
    e2[d] = __fsub_rn(p[2][d], p[0][d]);
  }
  const float cx = __fsub_rn(__fmul_rn(e1[1], e2[2]), __fmul_rn(e1[2], e2[1]));
  const float cy = __fsub_rn(__fmul_rn(e1[2], e2[0]), __fmul_rn(e1[0], e2[2]));
  const float cz = __fsub_rn(__fmul_rn(e1[0], e2[1]), __fmul_rn(e1[1], e2[0]));
  const float ss = __fadd_rn(__fadd_rn(__fmul_rn(cx, cx), __fmul_rn(cy, cy)),
                             __fmul_rn(cz, cz));
  return __fmul_rn(0.5f, __fsqrt_rn(ss));
}

// area of slot `slot` of tetrahedron t (0 where the case has no triangle)
__device__ __forceinline__ float slot_area(const Cell& c, int t, int cs,
                                           int slot, const float vals[4],
                                           float iso) {
  if (!kValid[cs * 2 + slot]) return 0.0f;
  float p[3][3];
  slot_vertices(c, t, cs, slot, vals, iso, p);
  return tri_area(p);
}

// K6: sums [B, C] float64, the 12 slot areas of each cell in slot order
__global__ void __launch_bounds__(kThreads)
    cell_area_kernel(const float* __restrict__ level,
                     double* __restrict__ sums, long long M, long long C,
                     long long BC, float iso) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= BC) return;
  const long long b = idx / C, cell = idx - b * C;
  Cell c;
  load_cell(level + b * M * M * M, M, cell, c);
  double acc = 0.0;
  for (int t = 0; t < 6; ++t) {
    float vals[4];
    const int cs = tet_case(c, t, iso, vals);
    for (int slot = 0; slot < 2; ++slot)
      acc += (double)slot_area(c, t, cs, slot, vals, iso);
  }
  sums[idx] = acc;
}

// K7: points [B, n, 3] float32 for the draws, and their faces [B, n] int64
// where `face` is not null
__global__ void __launch_bounds__(kThreads)
    draw_kernel(const float* __restrict__ level,
                const double* __restrict__ cdf, const float* __restrict__ r,
                const float* __restrict__ u, const float* __restrict__ w,
                float* __restrict__ pts, long long* __restrict__ face,
                long long M, long long C, long long n, long long Bn,
                float iso, float scale, float lo) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= Bn) return;
  const long long b = idx / n;
  const double* cd = cdf + b * C;
  const double total = cd[C - 1];
  const double target = (double)r[idx] * total;
  // the first cell whose CDF value exceeds the target
  long long lo_i = 0, hi_i = C;
  while (lo_i < hi_i) {
    const long long mid = lo_i + (hi_i - lo_i) / 2;
    if (cd[mid] > target)
      hi_i = mid;
    else
      lo_i = mid + 1;
  }
  const long long cell = lo_i < C ? lo_i : C - 1;
  double acc = cell > 0 ? cd[cell - 1] : 0.0;

  Cell c;
  load_cell(level + b * M * M * M, M, cell, c);
  int chosen = 11;
  for (int sl = 0; sl < 12; ++sl) {
    float vals[4];
    const int t = sl >> 1;
    const int cs = tet_case(c, t, iso, vals);
    acc += (double)slot_area(c, t, cs, sl & 1, vals, iso);
    if (acc > target) {
      chosen = sl;
      break;
    }
  }
  const int t = chosen >> 1, slot = chosen & 1;
  float vals[4], p[3][3];
  const int cs = tet_case(c, t, iso, vals);
  slot_vertices(c, t, cs, slot, vals, iso, p);

  float uu = u[idx], ww = w[idx];
  if (__fadd_rn(uu, ww) > 1.0f) {
    uu = __fsub_rn(1.0f, uu);
    ww = __fsub_rn(1.0f, ww);
  }
  const bool empty = !(total > 0.0);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    float q = __fadd_rn(
        __fadd_rn(p[0][d], __fmul_rn(uu, __fsub_rn(p[1][d], p[0][d]))),
        __fmul_rn(ww, __fsub_rn(p[2][d], p[0][d])));
    q = __fadd_rn(__fmul_rn(__fdiv_rn(q, (float)M), scale), lo);
    pts[idx * 3 + d] = empty ? 0.0f : q;
  }
  if (face != nullptr) face[idx] = cell * 12 + chosen;
}

int blocks_for(long long n) {
  return (int)((n + kThreads - 1) / kThreads);
}

}  // namespace

// The case tables into constant memory of the current device: tets [6*4],
// edge_a / edge_b [16*2*3], valid [16*2], int32, host pointers. Returns a
// cudaError_t.
extern "C" int scl_iso_tables(const void* tets, const void* edge_a,
                              const void* edge_b, const void* valid) {
  cudaError_t e = cudaMemcpyToSymbol(kTets, tets, sizeof(int) * 24);
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(kEdgeA, edge_a, sizeof(int) * 96);
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(kEdgeB, edge_b, sizeof(int) * 96);
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(kValid, valid, sizeof(int) * 32);
  return (int)e;
}

// K6. level [B,M,M,M] float32 -> sums [B,(M-1)^3] float64. Contiguous, on
// the current device. Returns a cudaError_t.
extern "C" int scl_iso_cell_areas(const void* level, void* sums, int B,
                                  int M, float iso, void* stream) {
  if (B <= 0 || M < 2) return (int)cudaErrorInvalidValue;
  const long long C = (long long)(M - 1) * (M - 1) * (M - 1);
  const long long BC = (long long)B * C;
  cell_area_kernel<<<blocks_for(BC), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(level), static_cast<double*>(sums), M, C, BC,
      iso);
  return (int)cudaGetLastError();
}

// K7. level [B,M,M,M] float32, cdf [B,(M-1)^3] float64, r / u / w [B,n]
// float32 -> pts [B,n,3] float32 and, unless `face` is null, face [B,n]
// int64; world coordinates pts / M * scale + lo. Contiguous, on the current
// device. Returns a cudaError_t.
extern "C" int scl_iso_draw(const void* level, const void* cdf, const void* r,
                            const void* u, const void* w, void* pts,
                            void* face, int B, int M, int n, float iso,
                            float scale, float lo, void* stream) {
  if (B <= 0 || M < 2 || n <= 0) return (int)cudaErrorInvalidValue;
  const long long C = (long long)(M - 1) * (M - 1) * (M - 1);
  const long long Bn = (long long)B * n;
  draw_kernel<<<blocks_for(Bn), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(level), static_cast<const double*>(cdf),
      static_cast<const float*>(r), static_cast<const float*>(u),
      static_cast<const float*>(w), static_cast<float*>(pts),
      static_cast<long long*>(face), M, C, n, Bn, iso, scale, lo);
  return (int)cudaGetLastError();
}
