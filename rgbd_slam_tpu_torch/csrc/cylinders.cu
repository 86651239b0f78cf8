// Cylinder stage of the plane extraction, for Hopper.
//
// Not a port of a Pallas kernel: the device form of what XLA fuses of the
// jitted `find_primitives` (rgbd_slam_tpu/features/primitives.py:441) between
// the grown regions and the model choice: `_cylinder_axis` (:301) over every
// candidate region, the cumsum selection of at most `slots` live regions,
// `_fit_cylinder` (:319, with its LLS cylinder) on each, as :496-508 vmap
// them, and the routing of the sub-segments back to the regions (:509-525).
// Its plain PyTorch version is `cylinders_reference` in
// rgbd_slam_tpu_torch/ops/cylinders_cuda.py, which runs the port's
// `_cylinder_axis` and `_fit_cylinder`.
//
// What bounds it on Hopper: operations, and only on the frames where a
// region is live.  A live slot's three rounds score 43 hypotheses against
// every cell, ~23 flops each: ~2.4 MFLOP a slot at 768 cells, and the axis
// gate of 20 regions 0.3 MFLOP, 41 ns at 67 TFLOP/s for one live slot; the
// ~82 kB of inputs and outputs take 25 ns at 3.35 TB/s.  In
// fact the stage is a chain of dependent steps (axis, selection, then per
// round: compaction, hypotheses, scoring, argmin, inliers, refit, MSE), each a
// block-wide barrier, so it is bound by that chain's latency.  The design:
//   * one CTA of 512 threads a region slot (`slots` CTAs; 16 warps hide the
//     latency of the serial steps better than 8: 34 against 43 us on an H100
//     at 700 W, a tunnel frame).  Every CTA first computes the
//     axis gate of all candidate regions (a warp a region, the normals'
//     outer products summed over the region's planar cells, then the eig3 of
//     eig3.cuh) and the selection, in the same order, so all CTAs agree on
//     them without talking to each other.  CTA 0 writes the axes, the flags,
//     the selection and the plain version's fill values (0, inf, False) of
//     every region no slot holds; a CTA whose slot is dead then exits, which
//     is every CTA on a frame without a cylinder candidate;
//   * a live CTA keeps its region's cells projected onto the plane across the
//     axis (point, normal, |c|^2 and c.n a cell) and the remaining set in
//     shared memory for the three rounds.  A round compacts the remaining
//     cells in cell order (ballots a warp of cells, one prefix sum), draws
//     the scrambled triplets as the plain version does in uint32 arithmetic,
//     fits a hypothesis a thread, scores each hypothesis with a warp over the
//     cells in the plain version's expanded truncated distance, takes the
//     first minimum (torch's argmin: a NaN first), and refits on the inliers.
//     A round with no cell left is invalid whatever it scores and fits empty
//     sums (radius 0 at the origin): it writes those values unscored;
//   * every sum runs in a fixed order (a thread's cells in order, a
//     butterfly within the warp, the warps' partials in order), so two
//     launches give the same bits and all lanes of a warp hold the same sum.
// The library is built with -fmad=false: each product and sum rounds on its
// own, as the plain version's separate tensor ops round, so the thresholds
// (the axis score, d2 < trunc, the argmin) see the plain arithmetic but for
// the order of the sums.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "eig3.cuh"

#define CYL_THREADS 512
#define CYL_WARPS (CYL_THREADS / 32)
#define CYL_MAX_REGIONS 64
#define CYL_MAX_HYP 256
#define CYL_MAX_SUBSEGMENTS 8
// partial sums a reduction carries at once
#define CYL_MAX_SUMS 8

struct CylArgs {
  const float* normal;     // [c, 3]
  const float* mean;       // [c, 3]
  const uint8_t* planar;   // [c]
  const uint8_t* member;   // [k, c]
  const uint8_t* try_cyl;  // [k]
  float* axis;             // [k, 3]
  uint8_t* axis_ok;        // [k]
  uint8_t* selected;       // [k]
  float* centers;          // [k, s, 3]
  float* radii;            // [k, s]
  uint8_t* valids;         // [k, s]
  float* mses;             // [k, s]
  uint8_t* inliers;        // [k, s, c]
  int c, k, subsegments, n_hyp, min_activated;
  float trunc, min_score;
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sums v[0..n) over the CTA, in a fixed order; every thread gets the sums.
// red: [CYL_WARPS][CYL_MAX_SUMS] shared scratch.
__device__ void block_sums(float* v, int n, float (*red)[CYL_MAX_SUMS]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = 0; i < n; ++i) {
    const float s = warp_sum(v[i]);
    if (lane == 0) red[warp][i] = s;
  }
  __syncthreads();
  for (int i = 0; i < n; ++i) {
    float s = red[0][i];
    for (int w = 1; w < CYL_WARPS; ++w) s += red[w][i];
    v[i] = s;
  }
  __syncthreads();
}

// _lls_cylinder: the closed-form cylinder of a cell set's sums
__device__ __forceinline__ void lls_cylinder(const float* sn, const float* sc, float snc,
                                             float k, float* radius, float* center) {
  const float inv_k = 1.0f / fmaxf(k, 1.0f);
  const float nn = (sn[0] * sn[0] + sn[1] * sn[1]) + sn[2] * sn[2];
  const float nc = (sn[0] * sc[0] + sn[1] * sc[1]) + sn[2] * sc[2];
  const float a = 1.0f - (nn * inv_k) * inv_k;
  const float b = snc * inv_k - (nc * inv_k) * inv_k;
  const float r = b / (fabsf(a) < 1e-9f ? 1e-9f : a);
  *radius = r;
  for (int d = 0; d < 3; ++d) center[d] = (sc[d] - r * sn[d]) * inv_k;
}

// the expanded truncated relative distance |(c_i - r n_i) - center|^2 / r^2
// of a cell to a hypothesis, in the plain version's order of operations
__device__ __forceinline__ float rel_dist2(const float* pc, const float* pn, float cc,
                                           float cn, float r, const float* h, float hs) {
  const float c_dot = (pc[0] * h[0] + pc[1] * h[1]) + pc[2] * h[2];
  const float n_dot = (pn[0] * h[0] + pn[1] * h[1]) + pn[2] * h[2];
  const float two_r = 2.0f * r;
  const float num = ((((cc - two_r * cn) + r * r) - 2.0f * c_dot) + two_r * n_dot) + hs;
  return num / fmaxf(r * r, 1e-12f);
}

__global__ void __launch_bounds__(CYL_THREADS) cylinders_kernel(const CylArgs a) {
  extern __shared__ float smem[];
  const int c = a.c;
  const int n_chunks = (c + 31) / 32;
  float* s_pc = smem;                       // [c][3] centroids across the axis
  float* s_pn = s_pc + 3 * c;               // [c][3] unit normals across the axis
  float* s_cc = s_pn + 3 * c;               // [c] |pc|^2
  float* s_cn = s_cc + c;                   // [c] pc . pn
  int* s_compact = (int*)(s_cn + c);        // [c] the remaining cells in order
  int* s_chunk = s_compact + c;             // [n_chunks] prefix of the remaining
  uint8_t* s_rem = (uint8_t*)(s_chunk + n_chunks);   // [c]

  __shared__ float s_axis[CYL_MAX_REGIONS][3];
  __shared__ uint8_t s_axis_ok[CYL_MAX_REGIONS];
  __shared__ int s_region[CYL_MAX_REGIONS];   // slot -> region
  __shared__ uint8_t s_sel[CYL_MAX_REGIONS];
  __shared__ int s_nsel;
  __shared__ int s_nrem;
  __shared__ int s_best;
  __shared__ float s_red[CYL_WARPS][CYL_MAX_SUMS];
  __shared__ float s_hr[CYL_MAX_HYP];
  __shared__ float s_hc[CYL_MAX_HYP][3];
  __shared__ float s_hs[CYL_MAX_HYP];
  __shared__ float s_msac[CYL_MAX_HYP];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slot = blockIdx.x;

  // ---- the axis gate of every candidate region (_cylinder_axis) ----
  for (int r = warp; r < a.k; r += CYL_WARPS) {
    float acc[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    const uint8_t* mem = a.member + (size_t)r * c;
    for (int i = lane; i < c; i += 32) {
      const float wt = (mem[i] && a.planar[i]) ? 1.0f : 0.0f;
      const float n0 = a.normal[3 * i], n1 = a.normal[3 * i + 1], n2 = a.normal[3 * i + 2];
      acc[0] += (wt * n0) * n0;
      acc[1] += (wt * n1) * n1;
      acc[2] += (wt * n2) * n2;
      acc[3] += (wt * n0) * n1;
      acc[4] += (wt * n0) * n2;
      acc[5] += (wt * n1) * n2;
      acc[6] += wt;
    }
    for (int j = 0; j < 7; ++j) acc[j] = warp_sum(acc[j]);
    if (lane == 0) {
      float vals[3], v[3];
      sym_eig3_smallest(acc[0], acc[1], acc[2], acc[3], acc[4], acc[5], vals, v);
      const float score = vals[2] / fmaxf(vals[0], 1e-12f);
      s_axis[r][0] = v[0];
      s_axis[r][1] = v[1];
      s_axis[r][2] = v[2];
      s_axis_ok[r] = (score >= a.min_score) && (acc[6] >= 3.0f);
    }
  }
  __syncthreads();

  // ---- the selection of at most gridDim.x live regions, in region order ----
  if (tid == 0) {
    int rank = 0;
    for (int r = 0; r < a.k; ++r) {
      const bool cand = a.try_cyl[r] && s_axis_ok[r];
      s_sel[r] = cand && rank < (int)gridDim.x;
      if (s_sel[r]) s_region[rank] = r;
      if (cand) ++rank;
    }
    s_nsel = min(rank, (int)gridDim.x);
  }
  __syncthreads();
  const int s_n = a.subsegments;

  if (slot == 0) {
    for (int r = tid; r < a.k; r += CYL_THREADS) {
      a.axis[3 * r] = s_axis[r][0];
      a.axis[3 * r + 1] = s_axis[r][1];
      a.axis[3 * r + 2] = s_axis[r][2];
      a.axis_ok[r] = s_axis_ok[r];
      a.selected[r] = s_sel[r];
    }
    // the regions no slot holds: the routing's fill values
    for (int r = 0; r < a.k; ++r) {
      if (s_sel[r]) continue;
      for (int j = tid; j < s_n; j += CYL_THREADS) {
        const int rs = r * s_n + j;
        a.centers[3 * rs] = 0.0f;
        a.centers[3 * rs + 1] = 0.0f;
        a.centers[3 * rs + 2] = 0.0f;
        a.radii[rs] = 0.0f;
        a.valids[rs] = 0;
        a.mses[rs] = INFINITY;
      }
      uint8_t* inl = a.inliers + (size_t)r * s_n * c;
      for (int j = tid; j < s_n * c; j += CYL_THREADS) inl[j] = 0;
    }
  }
  if (slot >= s_nsel) return;

  // ---- one live region: _fit_cylinder ----
  const int region = s_region[slot];
  const float ax0 = s_axis[region][0], ax1 = s_axis[region][1], ax2 = s_axis[region][2];
  const uint8_t* mem = a.member + (size_t)region * c;
  float cnt0 = 0.0f;
  for (int i = tid; i < c; i += CYL_THREADS) {
    const float m0 = a.mean[3 * i], m1 = a.mean[3 * i + 1], m2 = a.mean[3 * i + 2];
    const float n0 = a.normal[3 * i], n1 = a.normal[3 * i + 1], n2 = a.normal[3 * i + 2];
    const float cdot = (m0 * ax0 + m1 * ax1) + m2 * ax2;
    const float pc0 = m0 - cdot * ax0, pc1 = m1 - cdot * ax1, pc2 = m2 - cdot * ax2;
    const float ndot = (n0 * ax0 + n1 * ax1) + n2 * ax2;
    float pn0 = n0 - ndot * ax0, pn1 = n1 - ndot * ax1, pn2 = n2 - ndot * ax2;
    const float norm = fmaxf(sqrtf((pn0 * pn0 + pn1 * pn1) + pn2 * pn2), 1e-9f);
    pn0 = pn0 / norm;
    pn1 = pn1 / norm;
    pn2 = pn2 / norm;
    s_pc[3 * i] = pc0;
    s_pc[3 * i + 1] = pc1;
    s_pc[3 * i + 2] = pc2;
    s_pn[3 * i] = pn0;
    s_pn[3 * i + 1] = pn1;
    s_pn[3 * i + 2] = pn2;
    s_cc[i] = (pc0 * pc0 + pc1 * pc1) + pc2 * pc2;
    s_cn[i] = (pc0 * pn0 + pc1 * pn1) + pc2 * pn2;
    const bool active = mem[i] && a.planar[i];
    s_rem[i] = active;
    cnt0 += active ? 1.0f : 0.0f;
  }
  block_sums(&cnt0, 1, s_red);

  for (int si = 0; si < s_n; ++si) {
    // compaction of the remaining cells, in cell order
    for (int ch = warp; ch < n_chunks; ch += CYL_WARPS) {
      const int i = ch * 32 + lane;
      const unsigned bits = __ballot_sync(0xffffffffu, i < c && s_rem[i]);
      if (lane == 0) s_chunk[ch] = __popc(bits);
    }
    __syncthreads();
    if (tid == 0) {
      int total = 0;
      for (int ch = 0; ch < n_chunks; ++ch) {
        const int n = s_chunk[ch];
        s_chunk[ch] = total;
        total += n;
      }
      s_nrem = total;
    }
    __syncthreads();
    for (int ch = warp; ch < n_chunks; ch += CYL_WARPS) {
      const int i = ch * 32 + lane;
      const bool on = i < c && s_rem[i];
      const unsigned bits = __ballot_sync(0xffffffffu, on);
      if (on) s_compact[s_chunk[ch] + __popc(bits & ((1u << lane) - 1u))] = i;
    }
    __syncthreads();
    const int n_rem = s_nrem;
    const float n_left = (float)n_rem;
    const bool round_ok = n_left > (float)a.min_activated && n_left > 0.1f * cnt0
                          && n_left >= 3.0f;
    const int rs = region * s_n + si;
    if (n_rem == 0) {
      // no cell remains: the plain round finds no inlier whatever it scores,
      // and the LLS of empty sums (k clamped to 1) is radius 0 at the origin;
      // the round is invalid.  The same values, without the scoring.
      if (tid == 0) {
        a.centers[3 * rs] = 0.0f;
        a.centers[3 * rs + 1] = 0.0f;
        a.centers[3 * rs + 2] = 0.0f;
        a.radii[rs] = 0.0f;
        a.valids[rs] = 0;
        a.mses[rs] = INFINITY;
      }
      uint8_t* inl_out = a.inliers + (size_t)rs * c;
      for (int i = tid; i < c; i += CYL_THREADS) inl_out[i] = 0;
      continue;   // n_rem is the CTA's: every thread skips together
    }

    // hypotheses: the scrambled triplets over the compacted remaining cells
    const unsigned na = (unsigned)max(n_rem, 1);
    for (int b = tid; b < a.n_hyp; b += CYL_THREADS) {
      float tn[3][3], tc[3][3];
      for (int j = 0; j < 3; ++j) {
        const unsigned t = ((unsigned)(3 * b + j) + (unsigned)(si * 7919)) * 2654435761u;
        const int cell = n_rem > 0 ? s_compact[t % na] : 0;
        for (int d = 0; d < 3; ++d) {
          tn[j][d] = s_pn[3 * cell + d];
          tc[j][d] = s_pc[3 * cell + d];
        }
      }
      float sn[3], sc[3];
      for (int d = 0; d < 3; ++d) {
        sn[d] = (tn[0][d] + tn[1][d]) + tn[2][d];
        sc[d] = (tc[0][d] + tc[1][d]) + tc[2][d];
      }
      float snc = 0.0f;
      for (int j = 0; j < 3; ++j)
        for (int d = 0; d < 3; ++d) snc += tn[j][d] * tc[j][d];
      float r, h[3];
      lls_cylinder(sn, sc, snc, 3.0f, &r, h);
      s_hr[b] = r;
      s_hc[b][0] = h[0];
      s_hc[b][1] = h[1];
      s_hc[b][2] = h[2];
      s_hs[b] = (h[0] * h[0] + h[1] * h[1]) + h[2] * h[2];
    }
    __syncthreads();

    // MSAC scores: a warp a hypothesis over every cell (a NaN distance makes
    // the score NaN, as clamp_max and the weighted sum carry it)
    for (int b = warp; b < a.n_hyp; b += CYL_WARPS) {
      const float r = s_hr[b], hs = s_hs[b];
      const float* h = s_hc[b];
      float acc = 0.0f;
      for (int i = lane; i < c; i += 32) {
        const float d2 = rel_dist2(s_pc + 3 * i, s_pn + 3 * i, s_cc[i], s_cn[i], r, h, hs);
        const float clamped = d2 > a.trunc ? a.trunc : d2;
        acc += (s_rem[i] ? 1.0f : 0.0f) * clamped;
      }
      acc = warp_sum(acc);
      if (lane == 0) s_msac[b] = acc;
    }
    __syncthreads();
    if (tid == 0) {
      int best = 0;
      float bv = s_msac[0];
      for (int b = 1; b < a.n_hyp; ++b) {
        const float v = s_msac[b];
        if ((isnan(v) && !isnan(bv)) || v < bv) {
          best = b;
          bv = v;
        }
      }
      s_best = best;
    }
    __syncthreads();

    // inliers of the best hypothesis, and the refit's sums over them
    const int best = s_best;
    const float br = s_hr[best], bhs = s_hs[best];
    const float* bh = s_hc[best];
    float sums[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int i = tid; i < c; i += CYL_THREADS) {
      const float d2 = rel_dist2(s_pc + 3 * i, s_pn + 3 * i, s_cc[i], s_cn[i], br, bh, bhs);
      const bool inl = s_rem[i] && d2 < a.trunc;
      const float iw = inl ? 1.0f : 0.0f;
      const float* pn = s_pn + 3 * i;
      const float* pc = s_pc + 3 * i;
      sums[0] += pn[0] * iw;
      sums[1] += pn[1] * iw;
      sums[2] += pn[2] * iw;
      sums[3] += pc[0] * iw;
      sums[4] += pc[1] * iw;
      sums[5] += pc[2] * iw;
      sums[6] += ((pn[0] * pc[0]) * iw + (pn[1] * pc[1]) * iw) + (pn[2] * pc[2]) * iw;
      sums[7] += iw;
    }
    block_sums(sums, 8, s_red);
    const float k = sums[7];
    const bool seg_ok = round_ok && k >= 6.0f;
    float radius, center[3];
    lls_cylinder(sums, sums + 3, sums[6], k, &radius, center);
    radius = fabsf(radius);

    // MSE: (distance to the axis line - radius)^2 over the inliers
    float sq = 0.0f;
    for (int i = tid; i < c; i += CYL_THREADS) {
      const float d2 = rel_dist2(s_pc + 3 * i, s_pn + 3 * i, s_cc[i], s_cn[i], br, bh, bhs);
      const float iw = (s_rem[i] && d2 < a.trunc) ? 1.0f : 0.0f;
      const float r0 = a.mean[3 * i] - center[0];
      const float r1 = a.mean[3 * i + 1] - center[1];
      const float r2 = a.mean[3 * i + 2] - center[2];
      const float along = (r0 * ax0 + r1 * ax1) + r2 * ax2;
      const float q0 = r0 - along * ax0, q1 = r1 - along * ax1, q2 = r2 - along * ax2;
      const float dist = sqrtf((q0 * q0 + q1 * q1) + q2 * q2) - radius;
      sq += (iw * dist) * dist;
    }
    block_sums(&sq, 1, s_red);
    const float mse = sq / fmaxf(k, 1.0f);

    // this region's row of the routed outputs, and the next round's cells
    if (tid == 0) {
      a.centers[3 * rs] = center[0];
      a.centers[3 * rs + 1] = center[1];
      a.centers[3 * rs + 2] = center[2];
      a.radii[rs] = radius;
      a.valids[rs] = seg_ok;
      a.mses[rs] = seg_ok ? (isfinite(mse) ? mse : 0.0f) : INFINITY;
    }
    uint8_t* inl_out = a.inliers + (size_t)rs * c;
    for (int i = tid; i < c; i += CYL_THREADS) {
      const float d2 = rel_dist2(s_pc + 3 * i, s_pn + 3 * i, s_cc[i], s_cn[i], br, bh, bhs);
      const bool taken = seg_ok && s_rem[i] && d2 < a.trunc;
      inl_out[i] = taken;
      if (taken) s_rem[i] = 0;
    }
    __syncthreads();
  }
}

// Dynamic shared memory of c cells: the projected point and normal, |c|^2
// and c.n (8 floats), the compacted index (an int) and the remaining flag a
// cell, and a prefix a chunk of 32 cells.
static size_t cylinders_smem(int c) {
  return (size_t)c * (8 * sizeof(float) + sizeof(int) + 1) + (size_t)((c + 31) / 32) * sizeof(int);
}

extern "C" int cylinders_launch(const CylArgs* args, int slots, void* stream) {
  const CylArgs a = *args;
  if (a.c <= 0 || a.k <= 0 || a.k > CYL_MAX_REGIONS || a.n_hyp <= 0 || a.n_hyp > CYL_MAX_HYP
      || a.subsegments <= 0 || a.subsegments > CYL_MAX_SUBSEGMENTS || slots <= 0
      || slots > a.k)
    return (int)cudaErrorInvalidValue;
  const size_t smem = cylinders_smem(a.c);
  // past 40 kB the dynamic part and the ~8 kB of static arrays need the
  // opt-in above the 48 kB default
  if (smem > 40 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        cylinders_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cylinders_kernel<<<slots, CYL_THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
