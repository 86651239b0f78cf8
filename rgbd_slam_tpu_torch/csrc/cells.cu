// Per-cell pass of the plane extraction, for Hopper.
//
// Not a port of a Pallas kernel: the device form of what XLA fuses at the head
// of the jitted `find_primitives` (rgbd_slam_tpu/features/primitives.py:441):
// `depth_to_cloud` (rgbd_slam_tpu/ops/depth_cloud.py:21), `fit_cells` (:111)
// with `fit_plane_from_moments` (:87) and the closed-form eig3 of
// rgbd_slam_tpu/geometry/eig3.py, `_edge_maps` (:197) and `_normal_bins`
// (:271).  Its plain PyTorch version is `cells_reference` in
// rgbd_slam_tpu_torch/ops/cells_cuda.py, which runs the port's functions of
// the same names.
//
// From the depth map [h, w] (mm) it writes, for the gh x gw cells of
// patch x patch pixels: every CellGrid field (count, mean, centred second
// moments m2, normal, d, mse, score, planar, the merge distance tolerance),
// the directed mergeability edges [4, gh, gw] in the layout
// `components_kernel` reads, the normal's histogram bin and each cell's
// centre point with its valid flag (what the boundary polygons read).  The
// dense [h, w, 3] cloud is never written: each point is made in registers
// from its depth, as depth_to_cloud makes it, when a lane needs it.
//
// What bounds it on Hopper: bytes.  At 640x480 it must read 1.23 MB of depth
// and write ~78 kB, 0.39 us at 3.35 TB/s; the arithmetic, ~27 flops a pixel
// and a few hundred a cell, is ~8.7 MFLOP, 0.13 us at 67 TFLOP/s.  In fact a
// launch this small is bound by its latency, so the design keeps each warp's
// chain of dependent steps short, and its code small: in the step's CUDA
// graph the kernel starts with its code out of the instruction caches, and
// every instruction it runs is fetched first (PERF.md has the measurements).
// Two kernels, one call:
//   * `cells_fit_kernel`: one warp a cell, six cells a CTA (128 CTAs at
//     640x480: one wave, one CTA an SM).  A lane takes the pixels lane,
//     lane + 32, ... of its cell's patch and issues all its loads at once,
//     into registers (at most CELLS_SLOTS), before it uses any: one trip to
//     memory a lane instead of one a pixel.  It parks them in shared memory
//     (a slot past the patch holds 0, an invalid depth that adds +0 to every
//     sum), where the two passes (short loops), the continuity pairs, the
//     corner points and the centre point read them.  The rays (x - cx) / fx
//     and (y - cy) / fy are divided once a column and a row of the patch, by
//     lanes 0..31 (and by every lane for the 33rd of the largest patch), and
//     fetched by shuffle where a pixel needs them;
//   * the moments are the plain version's two-pass centred form: the count
//     and the sum of the points, a warp reduction, the mean, then sum w *
//     (p_i - m_i) * (p_j - m_j).  The middle row's and column's continuity
//     tests take a lane a pixel pair and a ballot.  Every lane runs the eig3
//     fit on the same sums (the butterfly reduction leaves the same bits in
//     every lane), and lanes 0-8 store the cell's vectors while lane 0 stores
//     its scalars;
//   * `cells_edges_kernel`: the edges of a cell need its neighbours' fits,
//     which other warps of other CTAs compute, so a second kernel, one thread
//     a cell, reads the fits back (72 kB, from L2, every load before any use)
//     and writes the four directed edges, with the borders cleared as
//     `_clear_edge` clears them.  Inside the step's graph this costs less than
//     the one-launch designs that were measured: the last CTA to finish
//     writing every edge, and per-cell counts whose atomics pick the warp that
//     completes a cell's neighbours.
// Reductions run in a fixed order (a lane's pixels in order, a butterfly
// within the warp), so two launches on the same depth give the same bits, and
// the same bits as the first design's fit kernel and edges kernel (the
// commit before this design).  The library is built with -fmad=false: each
// product and sum rounds on its own, as the plain version's separate tensor
// ops round, so the eig3 and the gates (mse against the squared depth
// quantization, the continuity jump, cos and distance of the edges) see the
// plain version's arithmetic but for the order of the sums.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "eig3.cuh"

#define CELLS_WARPS 6
// a lane's pixels of the largest patch, 33 x 33: ceil(1089 / 32)
#define CELLS_SLOTS 35
#define EDGES_THREADS 128
#define FULL_MASK 0xffffffffu

struct CellsArgs {
  const float* depth;      // [h, w]
  float* count;            // [c]
  float* mean;             // [c, 3]
  float* m2;               // [c, 3, 3]
  float* normal;           // [c, 3]
  float* d;                // [c]
  float* mse;              // [c]
  float* score;            // [c]
  uint8_t* planar;         // [c]
  float* tol;              // [c]
  uint8_t* edges;          // [4, gh, gw]
  int32_t* bins;           // [c]
  float* centers;          // [gh, gw, 3]
  uint8_t* centers_valid;  // [gh, gw]
  int h, w, patch, gh, gw, min_points, half_points, hist_bins;
  float fx, fy, cx, cy, min_depth, max_depth;
  float q_const, q_lin, q_quad, q_floor;
  float sin_merge, max_merge_dist, cos_max;
};

__device__ __forceinline__ float warp_sum(float v) {
  // a butterfly: both lanes of a pair add the same two values, so every lane
  // ends with the same bits
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

// get_depth_quantization: max(a + b z + c z^2, floor), in the plain order
__device__ __forceinline__ float quantization(const CellsArgs& a, float z) {
  return fmaxf((a.q_const + a.q_lin * z) + (a.q_quad * z) * z, a.q_floor);
}

__device__ __forceinline__ bool depth_valid(const CellsArgs& a, float dep) {
  return (dep > a.min_depth) && (dep <= a.max_depth);
}

// depth_to_cloud's z: the depth where valid, else 0
__device__ __forceinline__ float cloud_z(const CellsArgs& a, float dep) {
  return depth_valid(a, dep) ? dep : 0.0f;
}

// the ray of column (or row) k of the patch: lane k divided it for k < 32;
// every lane divided `far`, that of k = 32, which only a 33 px patch has
__device__ __forceinline__ float ray_at(float ray, float far, int k) {
  const float v = __shfl_sync(FULL_MASK, ray, k & 31);
  return k < 32 ? v : far;
}

__device__ __forceinline__ float pick3(int k, float v0, float v1, float v2) {
  return k == 0 ? v0 : (k == 1 ? v1 : v2);
}

// the directions of the edges: edge k of (y, x) reads the neighbour rolled
// onto it by (dy, dx) = (0, 1), (0, -1), (1, 0), (-1, 0), the cell (y - dy, x - dx)
__device__ __forceinline__ int edge_dy(int k) { return k == 2 ? 1 : (k == 3 ? -1 : 0); }
__device__ __forceinline__ int edge_dx(int k) { return k == 0 ? 1 : (k == 1 ? -1 : 0); }

// an edge that `_clear_edge` clears: its rolled neighbour lies across a border
__device__ __forceinline__ bool edge_border(const CellsArgs& a, int k, int y, int x) {
  return (k == 0 && x == 0) || (k == 1 && x == a.gw - 1) || (k == 2 && y == 0)
         || (k == 3 && y == a.gh - 1);
}

// The four directed edges of cell i, edge[k][y, x] when the neighbour rolled
// onto (y, x) by (0, +1), (0, -1), (+1, 0), (-1, 0) may grow into it, from the
// fits in device memory, every load before any use.  The rolled neighbour
// across a border is not read (the cell's own fit stands in), since
// `_clear_edge` clears that edge.
__device__ __forceinline__ void write_edges(const CellsArgs& a, int i, int y, int x) {
  const int c = a.gh * a.gw;
  float n[3], m[3], fn[4][3], fd[4];
  bool fp[4];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    n[q] = a.normal[3 * i + q];
    m[q] = a.mean[3 * i + q];
  }
  const float tol = a.tol[i];
  const bool planar = a.planar[i] != 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = edge_border(a, k, y, x) ? i : i - edge_dy(k) * a.gw - edge_dx(k);
#pragma unroll
    for (int q = 0; q < 3; ++q) fn[k][q] = a.normal[3 * j + q];
    fd[k] = a.d[j];
    fp[k] = a.planar[j] != 0;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float* f = fn[k];
    const float cos_ab = (f[0] * n[0] + f[1] * n[1]) + f[2] * n[2];
    const float dist = fabsf(((f[0] * m[0] + f[1] * m[1]) + f[2] * m[2]) + fd[k]);
    const bool on = cos_ab > a.cos_max && dist < tol && planar && fp[k]
                    && !edge_border(a, k, y, x);
    a.edges[(size_t)k * c + i] = on ? 1 : 0;
  }
}

// The fit of one cell by one warp (all 32 lanes, converged).  patch_px: the
// warp's CELLS_SLOTS * 32 floats of shared memory, which take its patch.
__device__ __forceinline__ void fit_cell(const CellsArgs& a, int cell, int lane,
                                         float* patch_px) {
  const int P = a.patch, ppc = P * P;
  const int gy = cell / a.gw, gx = cell - gy * a.gw;
  const int y0 = gy * P, x0 = gx * P;
  const float* base = a.depth + (size_t)y0 * a.w + x0;
  // a lane's pixel i = lane + 32 j sits at (i / P, i % P); i < 1120, so
  // (i + 0.5) / P in float is never within rounding of an integer
  const float inv_p = 1.0f / (float)P;
  const int slots = (ppc + 31) / 32;

  // every load of the lane first, into registers, then into shared memory:
  // one trip to memory a lane.  A pixel past the patch holds 0, which is no
  // valid depth: it adds +0 to every sum below, and a lane's pixels in the
  // patch come first, so the sums keep their bits.
  float x_ray, y_ray, x_far, y_far;
  {
    float dep[CELLS_SLOTS];
#pragma unroll
    for (int j = 0; j < CELLS_SLOTS; ++j) {
      if (32 * j < ppc) {   // the same for every lane
        const int i = lane + 32 * j, row = (int)(((float)i + 0.5f) * inv_p);
        dep[j] = i < ppc ? base[row * a.w + (i - row * P)] : 0.0f;
      }
    }
    // the rays of column x0 + lane and row y0 + lane, and of column x0 + 32
    // and row y0 + 32, as depth_to_cloud divides, while the loads are in flight
    x_ray = ((float)(x0 + lane) - a.cx) / a.fx;
    y_ray = ((float)(y0 + lane) - a.cy) / a.fy;
    x_far = ((float)(x0 + 32) - a.cx) / a.fx;
    y_far = ((float)(y0 + 32) - a.cy) / a.fy;
#pragma unroll
    for (int j = 0; j < CELLS_SLOTS; ++j)
      if (32 * j < ppc) patch_px[lane + 32 * j] = dep[j];
  }
  __syncwarp();

  // pass 1: count and sum of the valid points (a lane's own pixels, from
  // shared memory: a short loop keeps the code that a cold launch fetches
  // small)
  float cnt = 0.0f, s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
#pragma unroll 2
  for (int j = 0; j < slots; ++j) {
    const int i = lane + 32 * j, row = (int)(((float)i + 0.5f) * inv_p);
    const float xp = ray_at(x_ray, x_far, i - row * P);
    const float yp = ray_at(y_ray, y_far, row);
    const float dep = patch_px[i];
    const bool valid = depth_valid(a, dep);
    const float z = valid ? dep : 0.0f;
    const float wt = valid ? 1.0f : 0.0f;
    cnt += wt;
    s0 += wt * (xp * z);
    s1 += wt * (yp * z);
    s2 += wt * z;
  }
  cnt = warp_sum(cnt);
  s0 = warp_sum(s0);
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const float safe = fmaxf(cnt, 1.0f);
  const float mu0 = s0 / safe, mu1 = s1 / safe, mu2 = s2 / safe;

  // pass 2: the centred second moments, dev_i * raw_j for j >= i
  float m00 = 0.0f, m01 = 0.0f, m02 = 0.0f, m11 = 0.0f, m12 = 0.0f, m22 = 0.0f;
#pragma unroll 2
  for (int j = 0; j < slots; ++j) {
    const int i = lane + 32 * j, row = (int)(((float)i + 0.5f) * inv_p);
    const float xp = ray_at(x_ray, x_far, i - row * P);
    const float yp = ray_at(y_ray, y_far, row);
    const float dep = patch_px[i];
    const bool valid = depth_valid(a, dep);
    const float z = valid ? dep : 0.0f;
    const float wt = valid ? 1.0f : 0.0f;
    const float r0 = xp * z - mu0, r1 = yp * z - mu1, r2 = z - mu2;
    const float e0 = wt * r0, e1 = wt * r1, e2 = wt * r2;
    m00 += e0 * r0;
    m01 += e0 * r1;
    m02 += e0 * r2;
    m11 += e1 * r1;
    m12 += e1 * r2;
    m22 += e2 * r2;
  }
  m00 = warp_sum(m00);
  m01 = warp_sum(m01);
  m02 = warp_sum(m02);
  m11 = warp_sum(m11);
  m12 = warp_sum(m12);
  m22 = warp_sum(m22);

  // the rays of the corner and centre points, while every lane is here
  const int mid = P / 2;
  const float x_first = __shfl_sync(FULL_MASK, x_ray, 0);
  const float y_first = __shfl_sync(FULL_MASK, y_ray, 0);
  const float x_last = ray_at(x_ray, x_far, P - 1);
  const float y_last = ray_at(y_ray, y_far, P - 1);
  const float x_mid = __shfl_sync(FULL_MASK, x_ray, mid);
  const float y_mid = __shfl_sync(FULL_MASK, y_ray, mid);

  // continuity of the middle row and column: lane i tests the pair (i, i + 1)
  bool broken = false;
  if (lane < P - 1) {
    const float prev = cloud_z(a, patch_px[mid * P + lane]);
    const float nxt = cloud_z(a, patch_px[mid * P + lane + 1]);
    broken = (prev > 0.0f && nxt > 0.0f)
             && fabsf(nxt - prev) > 4.0f * quantization(a, fmaxf(nxt, 1.0f));
    const float prev2 = cloud_z(a, patch_px[lane * P + mid]);
    const float nxt2 = cloud_z(a, patch_px[(lane + 1) * P + mid]);
    broken = broken || ((prev2 > 0.0f && nxt2 > 0.0f)
                        && fabsf(nxt2 - prev2) > 4.0f * quantization(a, fmaxf(nxt2, 1.0f)));
  }
  // (a patch of at most 33 pixels has at most 32 pairs: cells_launch checks)
  const bool continuous = __ballot_sync(FULL_MASK, broken) == 0u;

  // fit_plane_from_moments on cov = (m2 + m2^T) / 2, in every lane
  const float c00 = 0.5f * (m00 + m00), c11 = 0.5f * (m11 + m11), c22 = 0.5f * (m22 + m22);
  const float c01 = 0.5f * (m01 + m01), c02 = 0.5f * (m02 + m02), c12 = 0.5f * (m12 + m12);
  float vals[3], n[3];
  sym_eig3_smallest(c00, c11, c22, c01, c02, c12, vals, n);
  const float ev0 = fabsf(vals[0]), ev1 = fabsf(vals[1]);
  float dd = -((n[0] * mu0 + n[1] * mu1) + n[2] * mu2);
  if (dd <= 0.0f) {
    n[0] = -n[0];
    n[1] = -n[1];
    n[2] = -n[2];
    dd = -dd;
  }
  const float mse = ev0 / safe;
  const float score = ev1 / fmaxf(ev0, 1e-6f);
  const bool fit_ok = cnt > 0.0f && isfinite(n[0]) && isfinite(n[1]) && isfinite(n[2]);
  const bool enough = cnt >= (float)a.min_points && cnt >= (float)a.half_points;
  const float qz = quantization(a, fabsf(mu2));
  const bool planar = continuous && enough && fit_ok && (mse <= qz * qz);

  // merge distance tolerance from the patch's corner-to-corner diameter
  const float z_first = cloud_z(a, patch_px[0]), z_last = cloud_z(a, patch_px[ppc - 1]);
  const float e0 = x_last * z_last - x_first * z_first;
  const float e1 = y_last * z_last - y_first * z_first;
  const float e2 = z_last - z_first;
  const float diameter = sqrtf((e0 * e0 + e1 * e1) + e2 * e2);
  const float tol = fminf((diameter * a.sin_merge) * sqrtf(fmaxf(cnt, 1.0f)),
                          a.max_merge_dist);

  // polar-angle histogram bin of the normal (_normal_bins)
  const float pi = 3.14159265358979323846f;
  const float proj = acosf(fminf(fmaxf(-n[2], -1.0f), 1.0f));
  const float ang = atan2f(n[0], n[1]);
  const int nb = a.hist_bins;
  const int bx = min(max((int)((proj / pi) * (float)nb), 0), nb - 1);
  const int by = min(max((int)(((ang + pi) / (2.0f * pi)) * (float)nb), 0), nb - 1);

  const float dep_mid = patch_px[mid * P + mid];
  const bool cvalid = depth_valid(a, dep_mid);
  const float z_mid = cvalid ? dep_mid : 0.0f;

  // the cell's vectors by lanes 0-8, its scalars by lane 0
  if (lane < 9) {
    const int r = lane / 3, q = lane - 3 * r;   // m2[r][q], symmetric
    const int lo = min(r, q), hi = max(r, q);
    a.m2[9 * cell + lane] = lo == 0 ? pick3(hi, m00, m01, m02)
                                    : (lo == 1 ? (hi == 1 ? m11 : m12) : m22);
  }
  if (lane < 3) {
    a.mean[3 * cell + lane] = pick3(lane, mu0, mu1, mu2);
    a.normal[3 * cell + lane] = pick3(lane, n[0], n[1], n[2]);
    a.centers[3 * cell + lane] = pick3(lane, x_mid * z_mid, y_mid * z_mid, z_mid);
  }
  if (lane == 0) {
    a.count[cell] = cnt;
    a.d[cell] = dd;
    a.mse[cell] = mse;
    a.score[cell] = score;
    a.planar[cell] = planar ? 1 : 0;
    a.tol[cell] = planar ? tol : 0.0f;
    a.bins[cell] = bx * nb + by;
    a.centers_valid[cell] = cvalid ? 1 : 0;
  }
}

__global__ void __launch_bounds__(32 * CELLS_WARPS) cells_fit_kernel(const CellsArgs a) {
  __shared__ float s_patch[CELLS_WARPS][CELLS_SLOTS * 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cell = blockIdx.x * CELLS_WARPS + warp;
  if (cell >= a.gh * a.gw) return;   // a whole warp: the shuffles see all 32 lanes
  fit_cell(a, cell, lane, s_patch[warp]);
}

__global__ void __launch_bounds__(EDGES_THREADS) cells_edges_kernel(const CellsArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.gh * a.gw) return;
  const int y = i / a.gw;
  write_edges(a, i, y, i - y * a.gw);
}

extern "C" int cells_launch(const CellsArgs* args, void* stream) {
  const CellsArgs a = *args;
  // (a depth of 0 must be invalid: the padded slots hold it)
  if (a.gh <= 0 || a.gw <= 0 || a.patch < 2 || a.patch > 33 || a.gh * a.patch > a.h
      || a.gw * a.patch > a.w || !(a.min_depth >= 0.0f))
    return (int)cudaErrorInvalidValue;
  const int c = a.gh * a.gw;
  cudaStream_t s = (cudaStream_t)stream;
  cells_fit_kernel<<<(c + CELLS_WARPS - 1) / CELLS_WARPS, 32 * CELLS_WARPS, 0, s>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  cells_edges_kernel<<<(c + EDGES_THREADS - 1) / EDGES_THREADS, EDGES_THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}
