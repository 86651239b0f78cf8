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
// launch this small is bound by its latency: the design reads each pixel once
// from device memory and keeps everything else in registers.
//   * cells_fit_kernel: one warp a cell, four cells a CTA.  A lane takes the
//     pixels lane, lane + 32, ... of its cell's patch.  The moments are the
//     plain version's two-pass centred form: the count and the sum of the
//     points, a warp reduction, the mean, then sum w * (p_i - m_i) * (p_j -
//     m_j) over the patch (the second pass rereads the patch from L1).  The
//     middle row's and column's continuity tests take a lane a pixel pair and
//     a ballot.  Every lane then runs the eig3 fit on the same sums (the
//     butterfly reduction leaves the same bits in every lane) and lane 0
//     writes the cell.
//   * cells_edges_kernel: the edges need each neighbour's fit, which another
//     warp of another CTA computes.  A second small kernel in the same
//     launch call, one thread a cell, reads the fits back (72 kB, from L2)
//     and writes the four directed edges, with the borders cleared as
//     `_clear_edge` clears them.  Recomputing a one-cell halo in every CTA
//     instead would read each border patch's depth again (a four-cell CTA
//     would refit 14 cells for its 4) to save one launch of a few
//     microseconds; this design keeps one fit a cell.
// Reductions run in a fixed order (a butterfly within the warp), so two
// launches on the same depth give the same bits.  The library is built with
// -fmad=false: each product and sum rounds on its own, as the plain version's
// separate tensor ops round, so the eig3 and the gates (mse against the
// squared depth quantization, the continuity jump, cos and distance of the
// edges) see the plain version's arithmetic but for the order of the sums.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "eig3.cuh"

#define CELLS_WARPS 4
#define EDGES_THREADS 128

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
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// get_depth_quantization: max(a + b z + c z^2, floor), in the plain order
__device__ __forceinline__ float quantization(const CellsArgs& a, float z) {
  return fmaxf((a.q_const + a.q_lin * z) + (a.q_quad * z) * z, a.q_floor);
}

// depth -> (valid, camera-space point), as depth_to_cloud computes it
__device__ __forceinline__ bool cloud_point(const CellsArgs& a, int y, int x, float* p) {
  const float dep = a.depth[(size_t)y * a.w + x];
  const bool valid = (dep > a.min_depth) && (dep <= a.max_depth);
  const float z = valid ? dep : 0.0f;
  const float x_pre = ((float)x - a.cx) / a.fx;
  const float y_pre = ((float)y - a.cy) / a.fy;
  p[0] = x_pre * z;
  p[1] = y_pre * z;
  p[2] = z;
  return valid;
}

__global__ void __launch_bounds__(32 * CELLS_WARPS) cells_fit_kernel(const CellsArgs a) {
  const int lane = threadIdx.x & 31;
  const int cell = blockIdx.x * CELLS_WARPS + (threadIdx.x >> 5);
  const int c = a.gh * a.gw;
  if (cell >= c) return;   // a whole warp: the shuffles below see all 32 lanes
  const int gy = cell / a.gw, gx = cell - gy * a.gw;
  const int y0 = gy * a.patch, x0 = gx * a.patch;
  const int ppc = a.patch * a.patch;

  // pass 1: count and sum of the valid points
  float cnt = 0.0f, s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
  for (int i = lane; i < ppc; i += 32) {
    const int py = i / a.patch, px = i - py * a.patch;
    float p[3];
    const float wt = cloud_point(a, y0 + py, x0 + px, p) ? 1.0f : 0.0f;
    cnt += wt;
    s0 += wt * p[0];
    s1 += wt * p[1];
    s2 += wt * p[2];
  }
  cnt = warp_sum(cnt);
  s0 = warp_sum(s0);
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const float safe = fmaxf(cnt, 1.0f);
  const float mu0 = s0 / safe, mu1 = s1 / safe, mu2 = s2 / safe;

  // pass 2: the centred second moments, dev_i * raw_j for j >= i
  float m00 = 0.0f, m01 = 0.0f, m02 = 0.0f, m11 = 0.0f, m12 = 0.0f, m22 = 0.0f;
  for (int i = lane; i < ppc; i += 32) {
    const int py = i / a.patch, px = i - py * a.patch;
    float p[3];
    const float wt = cloud_point(a, y0 + py, x0 + px, p) ? 1.0f : 0.0f;
    const float r0 = p[0] - mu0, r1 = p[1] - mu1, r2 = p[2] - mu2;
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

  // continuity of the middle row and column: lane i tests the pair (i, i + 1)
  const int mid = a.patch / 2;
  bool broken = false;
  if (lane < a.patch - 1) {
    float p[3], q[3];
    cloud_point(a, y0 + mid, x0 + lane, p);
    cloud_point(a, y0 + mid, x0 + lane + 1, q);
    const float prev = p[2], nxt = q[2];
    broken = (prev > 0.0f && nxt > 0.0f)
             && fabsf(nxt - prev) > 4.0f * quantization(a, fmaxf(nxt, 1.0f));
    cloud_point(a, y0 + lane, x0 + mid, p);
    cloud_point(a, y0 + lane + 1, x0 + mid, q);
    const float prev2 = p[2], nxt2 = q[2];
    broken = broken || ((prev2 > 0.0f && nxt2 > 0.0f)
                        && fabsf(nxt2 - prev2) > 4.0f * quantization(a, fmaxf(nxt2, 1.0f)));
  }
  // (a patch of at most 33 pixels has at most 32 pairs: cells_launch checks)
  const bool continuous = __ballot_sync(0xffffffffu, broken) == 0u;

  if (lane != 0) return;

  // fit_plane_from_moments on cov = (m2 + m2^T) / 2
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
  float k0[3], k1[3];
  cloud_point(a, y0, x0, k0);
  cloud_point(a, y0 + a.patch - 1, x0 + a.patch - 1, k1);
  const float e0 = k1[0] - k0[0], e1 = k1[1] - k0[1], e2 = k1[2] - k0[2];
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

  float cp[3];
  const bool cvalid = cloud_point(a, y0 + mid, x0 + mid, cp);

  a.count[cell] = cnt;
  a.mean[3 * cell + 0] = mu0;
  a.mean[3 * cell + 1] = mu1;
  a.mean[3 * cell + 2] = mu2;
  float* m = a.m2 + 9 * cell;
  m[0] = m00; m[1] = m01; m[2] = m02;
  m[3] = m01; m[4] = m11; m[5] = m12;
  m[6] = m02; m[7] = m12; m[8] = m22;
  a.normal[3 * cell + 0] = n[0];
  a.normal[3 * cell + 1] = n[1];
  a.normal[3 * cell + 2] = n[2];
  a.d[cell] = dd;
  a.mse[cell] = mse;
  a.score[cell] = score;
  a.planar[cell] = planar ? 1 : 0;
  a.tol[cell] = planar ? tol : 0.0f;
  a.bins[cell] = bx * nb + by;
  a.centers[3 * cell + 0] = cp[0];
  a.centers[3 * cell + 1] = cp[1];
  a.centers[3 * cell + 2] = cp[2];
  a.centers_valid[cell] = cvalid ? 1 : 0;
}

// The directed edges [4, gh, gw]: edge[dir][y, x] when the neighbour rolled
// onto (y, x) by (0, +1), (0, -1), (+1, 0), (-1, 0) may grow into it.
__global__ void __launch_bounds__(EDGES_THREADS) cells_edges_kernel(const CellsArgs a) {
  const int c = a.gh * a.gw;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= c) return;
  const int y = i / a.gw, x = i - y * a.gw;
  const float n0 = a.normal[3 * i], n1 = a.normal[3 * i + 1], n2 = a.normal[3 * i + 2];
  const float c0 = a.mean[3 * i], c1 = a.mean[3 * i + 1], c2 = a.mean[3 * i + 2];
  const float tol = a.tol[i];
  const bool planar = a.planar[i] != 0;
  const int dys[4] = {0, 0, 1, -1};
  const int dxs[4] = {1, -1, 0, 0};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int dy = dys[k], dx = dxs[k];
    const int fy = (y - dy + a.gh) % a.gh, fx = (x - dx + a.gw) % a.gw;
    const int f = fy * a.gw + fx;
    const float f0 = a.normal[3 * f], f1 = a.normal[3 * f + 1], f2 = a.normal[3 * f + 2];
    const float cos_ab = (f0 * n0 + f1 * n1) + f2 * n2;
    const float dist = fabsf(((f0 * c0 + f1 * c1) + f2 * c2) + a.d[f]);
    bool e = cos_ab > a.cos_max && dist < tol && planar && a.planar[f] != 0;
    if ((dx == 1 && x == 0) || (dx == -1 && x == a.gw - 1) || (dy == 1 && y == 0)
        || (dy == -1 && y == a.gh - 1))
      e = false;
    a.edges[(size_t)k * c + i] = e ? 1 : 0;
  }
}

extern "C" int cells_launch(const CellsArgs* args, void* stream) {
  const CellsArgs a = *args;
  if (a.gh <= 0 || a.gw <= 0 || a.patch < 2 || a.patch > 33 || a.gh * a.patch > a.h
      || a.gw * a.patch > a.w)
    return (int)cudaErrorInvalidValue;
  const int c = a.gh * a.gw;
  cudaStream_t s = (cudaStream_t)stream;
  cells_fit_kernel<<<(c + CELLS_WARPS - 1) / CELLS_WARPS, 32 * CELLS_WARPS, 0, s>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  cells_edges_kernel<<<(c + EDGES_THREADS - 1) / EDGES_THREADS, EDGES_THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}
