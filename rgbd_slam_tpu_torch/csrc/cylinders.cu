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
// ~82 kB of inputs and outputs take 25 ns at 3.35 TB/s.  In fact the stage is
// a chain of dependent steps (axis, selection, then per round: compaction,
// hypotheses, scoring, argmin, inliers, refit, MSE), each a barrier, so it is
// bound by that chain's latency, and the design shortens each link:
//   * a thread block cluster of CYL_CLUSTER CTAs of 512 threads a region slot
//     (`slots` clusters).  Each CTA first stages its inputs in shared memory
//     with 16-byte asynchronous copies, all in flight at once: the normals,
//     means, planar flags, candidate flags and the k region rows of `member`
//     (the cluster's barrier, which must pass before a CTA writes into
//     another's shared memory, is arrived at before the copies and waited
//     for after the gate's sums, so it costs nothing on its own).  The axis
//     gate takes one warp a region, the regions spread over the cluster's
//     CTAs (region r on CTA r % CYL_CLUSTER), so no warp takes two: the
//     normals' outer products summed over the region's planar cells, the
//     eig3 of eig3.cuh in every lane (an empty region's zero matrix answered
//     at once), and the axis and its flag written into every CTA of the
//     cluster (distributed shared memory).  Every cluster computes the same
//     gate, so all agree on the selection (a ballot prefix over the regions)
//     without talking to each other;
//   * all CTAs of the grid write the fill values (0, inf, False) of the
//     regions no slot holds, 16-byte stores spread over every thread; CTA 0
//     writes the axes, the flags and the selection.  A cluster whose slot is
//     dead then exits, which is every cluster on a frame without a cylinder
//     candidate;
//   * in a live cluster every CTA keeps the region's cells projected onto the
//     plane across the axis (point with |c|^2, normal with c.n: two float4s a
//     cell, over the member rows, which the gate no longer needs) and the
//     remaining set (a flag a cell, and a ballot mask a chunk of 32 cells,
//     which the round before writes) in shared memory.  A round compacts the
//     remaining cells in cell order (each warp takes the prefix of the
//     chunks' counts and places its own chunks' cells), draws the scrambled
//     triplets as the plain version does in uint32 arithmetic and fits a
//     hypothesis a thread.  The scoring, the bulk of a round, is spread over
//     the cluster: CTA q scores hypotheses q, q + CYL_CLUSTER, ..., a warp a
//     hypothesis over every cell in the plain version's expanded truncated
//     distance, and writes each score into every CTA of the cluster; after a
//     cluster barrier each CTA takes the first minimum (torch's argmin: a NaN
//     first) by a warp reduction, and refits on the inliers.  The cell's
//     inlier bit of the best hypothesis is computed once a round and kept in
//     a register for the refit sums, the MSE and the writes; the cluster's
//     first CTA writes the outputs.  A round with no cell left is invalid
//     whatever it scores and fits empty sums (radius 0 at the origin): it
//     writes those values unscored;
//   * every sum runs in a fixed order (a thread's cells in order, a
//     butterfly within the warp, the warps' partials in order), so two
//     launches give the same bits, all lanes of a warp and all CTAs of a
//     cluster hold the same sums, and the outputs are the first design's
//     (one CTA a slot, the commit before this design) to the bit.
// The library is built with -fmad=false: each product and sum rounds on its
// own, as the plain version's separate tensor ops round, so the thresholds
// (the axis score, d2 < trunc, the argmin) see the plain arithmetic but for
// the order of the sums.
//
// Two paths, chosen by the grid's size (the wrapper's `shared_path`): the one
// above while a CTA's inputs and per-cell arrays fit its shared memory (3,576
// cells at 20 regions: 640x480 at 20 px is 768), and past that the global
// path (`cylinders_kernel_global`), the same code on the same arithmetic with
// the per-cell arrays in global memory, where L1 and L2 hold them: each CTA
// reads the normals, means, planar flags, member rows and candidate flags
// where they lie (no staging), and keeps its own remaining flags, compacted
// cells, chunk masks, projected cells and the round's inlier flags (a byte a
// cell, in place of the register bits) in its slice of a scratch buffer that
// the wrapper allocates (`cylinders_scratch`, ~38 bytes a cell).  Only the
// cluster's exchanges (axes, flags, scores) stay in static shared memory.  The
// sums run in the same order, so the two paths give the same bits.  A cluster
// that splits the cell arrays over its CTAs' shared memory (distributed shared
// memory) would hold 4 x 227 KB, ~14,600 cells at 62 bytes a cell: short of
// the 38,741 cells the components kernel takes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "eig3.cuh"

namespace cg = cooperative_groups;

#define CYL_THREADS 512
#define CYL_WARPS (CYL_THREADS / 32)
#define CYL_CLUSTER 4
// at most one warp a region in the gate: CYL_CLUSTER * CYL_WARPS or fewer
#define CYL_MAX_REGIONS 64
#define CYL_MAX_HYP 256
#define CYL_MAX_SUBSEGMENTS 8
// partial sums a reduction carries at once
#define CYL_MAX_SUMS 8
// a thread keeps the inlier bits of its cells in one 32-bit register
#define CYL_MAX_CELLS (32 * CYL_THREADS)
// the global path: k s c stays far below 2^31 and the scratch below 40 MB
#define CYL_MAX_CELLS_GLOBAL 65536
#define FULL_MASK 0xffffffffu

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
  uint8_t* scratch;        // the global path's cell arrays, cylinders_scratch(c) a CTA; else null
  int c, k, subsegments, n_hyp, min_activated;
  float trunc, min_score;
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

// Sums v[0..n) over the CTA, in a fixed order; every thread gets the sums.
// red: [CYL_WARPS][CYL_MAX_SUMS] shared scratch, which a thread may still read
// after it returns: the next sum takes another, or comes after a barrier.
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

// an MSAC hypothesis: radius r, centre h and |h|^2
struct Hypothesis {
  float r, h[3], hs;
};

// Hypothesis b of round si: the LLS cylinder of the scrambled triplet over
// the n_rem compacted remaining cells, in the plain version's uint32
// arithmetic and order of operations
__device__ __forceinline__ Hypothesis hypothesis(int b, int si, int n_rem, const int* compact,
                                                 const float4* pcs, const float4* pns) {
  float tn[3][3], tc[3][3];
  for (int j = 0; j < 3; ++j) {
    const unsigned t = ((unsigned)(3 * b + j) + (unsigned)(si * 7919)) * 2654435761u;
    const int cell = compact[t % (unsigned)n_rem];
    const float4 pn = pns[cell], pc = pcs[cell];
    tn[j][0] = pn.x;
    tn[j][1] = pn.y;
    tn[j][2] = pn.z;
    tc[j][0] = pc.x;
    tc[j][1] = pc.y;
    tc[j][2] = pc.z;
  }
  float sn[3], sc[3];
  for (int d = 0; d < 3; ++d) {
    sn[d] = (tn[0][d] + tn[1][d]) + tn[2][d];
    sc[d] = (tc[0][d] + tc[1][d]) + tc[2][d];
  }
  float snc = 0.0f;
  for (int j = 0; j < 3; ++j)
    for (int d = 0; d < 3; ++d) snc += tn[j][d] * tc[j][d];
  Hypothesis hyp;
  lls_cylinder(sn, sc, snc, 3.0f, &hyp.r, hyp.h);
  hyp.hs = (hyp.h[0] * hyp.h[0] + hyp.h[1] * hyp.h[1]) + hyp.h[2] * hyp.h[2];
  return hyp;
}

__device__ __forceinline__ Hypothesis stored_hypothesis(const float* v) {
  Hypothesis hyp;
  hyp.r = v[0];
  hyp.h[0] = v[1];
  hyp.h[1] = v[2];
  hyp.h[2] = v[3];
  hyp.hs = v[4];
  return hyp;
}

// the expanded truncated relative distance |(c_i - r n_i) - center|^2 / r^2
// of a cell (pc: point and |c|^2, pn: normal and c.n) to a hypothesis, in the
// plain version's order of operations
__device__ __forceinline__ float rel_dist2(float4 pc, float4 pn, const Hypothesis& hyp) {
  const float r = hyp.r;
  const float c_dot = (pc.x * hyp.h[0] + pc.y * hyp.h[1]) + pc.z * hyp.h[2];
  const float n_dot = (pn.x * hyp.h[0] + pn.y * hyp.h[1]) + pn.z * hyp.h[2];
  const float two_r = 2.0f * r;
  const float num = ((((pc.w - two_r * pn.w) + r * r) - 2.0f * c_dot) + two_r * n_dot) + hyp.hs;
  return num / fmaxf(r * r, 1e-12f);
}

// the argmin order of torch: a NaN before any number, else the smaller
// value; ties (and two NaNs) to the lower index
__device__ __forceinline__ bool argmin_before(float v, int i, float w, int j) {
  const bool nv = isnan(v), nw = isnan(w);
  if (nv != nw) return nv;
  if (!nv && v != w) return v < w;
  return i < j;
}

// Copies into shared memory, all in flight at once: 16-byte asynchronous
// copies (cp.async, read from L2) where the source is 16-byte aligned, the
// rest by bytes.
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src)
               : "memory");
}

// starts the copy of n bytes into shared memory (dst 16-byte aligned), by
// every thread of the CTA
__device__ __forceinline__ void stage_bytes(void* dst, const void* src, int n) {
  uint8_t* d = (uint8_t*)dst;
  const uint8_t* s = (const uint8_t*)src;
  int done = 0;
  if ((((uintptr_t)s) & 15) == 0) {
    const int n16 = n >> 4;
    for (int j = threadIdx.x; j < n16; j += blockDim.x) cp_async16(d + 16 * j, s + 16 * j);
    done = n16 << 4;
  }
  for (int j = done + threadIdx.x; j < n; j += blockDim.x) d[j] = __ldcg(s + j);
}

// this thread's copies have landed (a barrier then shows them to the CTA)
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__host__ __device__ __forceinline__ size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

// The dynamic shared memory of c cells and k regions, in its order: normals
// and means (12 bytes a cell each), planar and remaining flags (a byte each),
// the compacted cells (an int each), a mask a chunk of 32 cells, the
// candidate flags (a byte a region), and one area that holds the k member
// rows (k bytes a cell) while the gate runs and the projected cells (two
// float4s a cell) after it.
__host__ __device__ __forceinline__ size_t cylinders_smem(int c, int k) {
  return 2 * align16((size_t)12 * c) + 2 * align16((size_t)c) + align16((size_t)4 * c)
         + align16((size_t)4 * ((c + 31) / 32)) + align16((size_t)k)
         + align16((size_t)(k > 32 ? k : 32) * c);
}

// The global path's scratch of one CTA, in its order: the projected cells (two
// float4s a cell), the compacted cells, a mask a chunk of 32 cells, the
// remaining flags and the round's inlier flags (a byte a cell each).
__host__ __device__ __forceinline__ size_t cylinders_scratch(int c) {
  return (size_t)32 * c + align16((size_t)4 * c) + align16((size_t)4 * ((c + 31) / 32))
         + 2 * align16((size_t)c);
}

// The kernel's body, by path: the two kernels below, each a cluster of
// CYL_CLUSTER CTAs of CYL_THREADS threads a region slot.
template <bool kGlobal>
__device__ __forceinline__ void cylinders_body(const CylArgs& a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int c = a.c, k = a.k;
  const int n_chunks = (c + 31) / 32;
  // this CTA has started: the cluster's barrier, waited for before the first
  // write into another CTA's shared memory, overlaps the staging and the gate
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const float *s_normal, *s_mean;                 // [c][3]
  const uint8_t *s_planar, *s_try, *s_member;     // [c], [k], [k][c] (the gate's)
  uint8_t* s_rem;                                 // [c]
  int* s_compact;                                 // [c]
  unsigned* s_mask;   // [n_chunks]: the remaining cells of a chunk of 32, a bit a cell
  float4 *s_pc, *s_pn;                            // [c] each, after the gate
  uint8_t* s_inl = nullptr;                       // [c], the global path's inlier flags
  if constexpr (kGlobal) {
    s_normal = a.normal;
    s_mean = a.mean;
    s_planar = a.planar;
    s_try = a.try_cyl;
    s_member = a.member;
    uint8_t* w = a.scratch + (size_t)blockIdx.x * cylinders_scratch(c);
    s_pc = (float4*)w;
    s_pn = s_pc + c;
    s_compact = (int*)(s_pn + c);
    s_mask = (unsigned*)((uint8_t*)s_compact + align16((size_t)4 * c));
    s_rem = (uint8_t*)s_mask + align16((size_t)4 * n_chunks);
    s_inl = s_rem + align16((size_t)c);
  } else {
    float* normal = (float*)smem;
    float* mean = (float*)(smem + align16((size_t)12 * c));
    uint8_t* planar = (uint8_t*)mean + align16((size_t)12 * c);
    s_rem = planar + align16((size_t)c);
    s_compact = (int*)(s_rem + align16((size_t)c));
    s_mask = (unsigned*)((uint8_t*)s_compact + align16((size_t)4 * c));
    uint8_t* try_cyl = (uint8_t*)s_mask + align16((size_t)4 * n_chunks);
    uint8_t* member = try_cyl + align16((size_t)k);
    s_pc = (float4*)member;   // over the member rows, after the gate
    s_pn = s_pc + c;
    // ---- the inputs, all copies in flight at once ----
    stage_bytes(normal, a.normal, 12 * c);
    stage_bytes(mean, a.mean, 12 * c);
    stage_bytes(planar, a.planar, c);
    stage_bytes(member, a.member, k * c);
    stage_bytes(try_cyl, a.try_cyl, k);
    s_normal = normal;
    s_mean = mean;
    s_planar = planar;
    s_try = try_cyl;
    s_member = member;
  }

  __shared__ float s_axis[CYL_MAX_REGIONS][3];
  __shared__ uint8_t s_axis_ok[CYL_MAX_REGIONS];
  __shared__ int s_region[CYL_MAX_REGIONS];   // slot -> region
  __shared__ uint8_t s_sel[CYL_MAX_REGIONS];
  __shared__ int s_nsel;
  __shared__ int s_best;
  __shared__ float s_red[2][CYL_WARPS][CYL_MAX_SUMS];   // the refit's, the MSE's
  __shared__ float s_hyp[CYL_MAX_HYP][5];   // r, h, |h|^2
  // the scores of a round, by the round's parity: a CTA writes the next
  // round's into the other buffer of a CTA that may still read this one's
  __shared__ float s_msac[2][CYL_MAX_HYP];

  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slot = blockIdx.x / CYL_CLUSTER;
  const int n_slots = gridDim.x / CYL_CLUSTER;

  if constexpr (!kGlobal) {   // the inputs have landed
    stage_wait();
    __syncthreads();
  }

  // ---- the axis gate (_cylinder_axis): region r on CTA r % CYL_CLUSTER ----
  const int gate_r = (int)rank + CYL_CLUSTER * warp;
  float gate_v[3] = {0.f, 0.f, 0.f};
  bool gate_ok = false;
  if (gate_r < k) {
    float acc[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    const uint8_t* mem = s_member + (size_t)gate_r * c;
#pragma unroll 4
    for (int i = lane; i < c; i += 32) {
      const float wt = ((mem[i] != 0) & (s_planar[i] != 0)) ? 1.0f : 0.0f;
      const float n0 = s_normal[3 * i], n1 = s_normal[3 * i + 1], n2 = s_normal[3 * i + 2];
      acc[0] += (wt * n0) * n0;
      acc[1] += (wt * n1) * n1;
      acc[2] += (wt * n2) * n2;
      acc[3] += (wt * n0) * n1;
      acc[4] += (wt * n0) * n2;
      acc[5] += (wt * n1) * n2;
      acc[6] += wt;
    }
    for (int j = 0; j < 7; ++j) acc[j] = warp_sum(acc[j]);
    float vals[3];
    sym_eig3_smallest(acc[0], acc[1], acc[2], acc[3], acc[4], acc[5], vals, gate_v);
    const float score = vals[2] / fmaxf(vals[0], 1e-12f);
    gate_ok = (score >= a.min_score) && (acc[6] >= 3.0f);
  }
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (gate_r < k && lane < CYL_CLUSTER) {   // lane q writes into CTA q of the cluster
    float* ax = cluster.map_shared_rank(&s_axis[gate_r][0], lane);
    ax[0] = gate_v[0];
    ax[1] = gate_v[1];
    ax[2] = gate_v[2];
    *cluster.map_shared_rank(&s_axis_ok[gate_r], lane) = gate_ok;
  }
  cluster.sync();

  // ---- the selection of at most n_slots live regions, in region order ----
  if (warp == 0) {
    int taken = 0;
    for (int r0 = 0; r0 < k; r0 += 32) {
      const int r = r0 + lane;
      const bool cand = r < k && s_try[r] && s_axis_ok[r];
      const unsigned bits = __ballot_sync(FULL_MASK, cand);
      const int order = taken + __popc(bits & ((1u << lane) - 1u));
      if (r < k) s_sel[r] = cand && order < n_slots;
      if (cand && order < n_slots) s_region[order] = r;
      taken += __popc(bits);
    }
    if (lane == 0) s_nsel = min(taken, n_slots);
  }
  __syncthreads();
  const int s_n = a.subsegments;

  if (blockIdx.x == 0) {
    for (int r = tid; r < k; r += CYL_THREADS) {
      a.axis[3 * r] = s_axis[r][0];
      a.axis[3 * r + 1] = s_axis[r][1];
      a.axis[3 * r + 2] = s_axis[r][2];
      a.axis_ok[r] = s_axis_ok[r];
      a.selected[r] = s_sel[r];
    }
  }
  // the regions no slot holds: the routing's fill values, spread over every
  // thread of the grid; their inliers a 16-byte chunk a thread (k s c <
  // 2^31: the launch's limits)
  {
    const unsigned t = blockIdx.x * CYL_THREADS + tid, nt = gridDim.x * CYL_THREADS;
    for (unsigned rs = t; rs < (unsigned)(k * s_n); rs += nt) {
      if (s_sel[rs / s_n]) continue;
      a.centers[3 * rs] = 0.0f;
      a.centers[3 * rs + 1] = 0.0f;
      a.centers[3 * rs + 2] = 0.0f;
      a.radii[rs] = 0.0f;
      a.valids[rs] = 0;
      a.mses[rs] = INFINITY;
    }
    const unsigned row = (unsigned)(s_n * c), total = (unsigned)k * row;
    unsigned bytes_done = 0;
    if ((((uintptr_t)a.inliers) & 15) == 0) {
      const unsigned n16 = total >> 4;
      for (unsigned q = t; q < n16; q += nt) {
        const unsigned b0 = q << 4, r0 = b0 / row;
        if (r0 == (b0 + 15) / row) {
          if (!s_sel[r0]) ((uint4*)a.inliers)[q] = make_uint4(0u, 0u, 0u, 0u);
        } else {
          for (unsigned b = b0; b < b0 + 16; ++b)
            if (!s_sel[b / row]) a.inliers[b] = 0;
        }
      }
      bytes_done = n16 << 4;
    }
    for (unsigned b = bytes_done + t; b < total; b += nt)
      if (!s_sel[b / row]) a.inliers[b] = 0;
  }
  // the whole cluster leaves together: no more writes into its shared memory
  if (slot >= s_nsel) return;

  // ---- one live region: _fit_cylinder ----
  const bool leader = rank == 0;
  const int region = s_region[slot];
  const float ax0 = s_axis[region][0], ax1 = s_axis[region][1], ax2 = s_axis[region][2];
  const uint8_t* mem = s_member + (size_t)region * c;
  // the region's cells: a flag a cell, and a mask a chunk of 32 (a thread's
  // cells are tid + 512 m, so warp w holds chunks w, w + CYL_WARPS, ...)
  for (int i0 = warp * 32; i0 < c; i0 += CYL_THREADS) {
    const int i = i0 + lane;
    const bool active = i < c && (mem[i] != 0) & (s_planar[i] != 0);
    const unsigned bits = __ballot_sync(FULL_MASK, active);
    if (i < c) s_rem[i] = active;
    if (lane == 0) s_mask[i0 >> 5] = bits;
  }
  __syncthreads();   // every read of the member rows (the shared path's s_pc) is done
  for (int i = tid; i < c; i += CYL_THREADS) {
    const float m0 = s_mean[3 * i], m1 = s_mean[3 * i + 1], m2 = s_mean[3 * i + 2];
    const float n0 = s_normal[3 * i], n1 = s_normal[3 * i + 1], n2 = s_normal[3 * i + 2];
    const float cdot = (m0 * ax0 + m1 * ax1) + m2 * ax2;
    const float pc0 = m0 - cdot * ax0, pc1 = m1 - cdot * ax1, pc2 = m2 - cdot * ax2;
    const float ndot = (n0 * ax0 + n1 * ax1) + n2 * ax2;
    float pn0 = n0 - ndot * ax0, pn1 = n1 - ndot * ax1, pn2 = n2 - ndot * ax2;
    const float norm = fmaxf(sqrtf((pn0 * pn0 + pn1 * pn1) + pn2 * pn2), 1e-9f);
    pn0 = pn0 / norm;
    pn1 = pn1 / norm;
    pn2 = pn2 / norm;
    s_pc[i] = make_float4(pc0, pc1, pc2, (pc0 * pc0 + pc1 * pc1) + pc2 * pc2);
    s_pn[i] = make_float4(pn0, pn1, pn2, (pc0 * pn0 + pc1 * pn1) + pc2 * pn2);
  }
  __syncthreads();

  float cnt0 = 0.0f;   // the region's cells: the first round's count
  for (int si = 0; si < s_n; ++si) {
    // compaction of the remaining cells, in cell order: every warp takes the
    // prefix of the chunks' counts, 32 chunks at a time, and places the
    // cells of its own chunks
    int n_rem = 0;
    for (int ch0 = 0; ch0 < n_chunks; ch0 += 32) {
      const int ch = ch0 + lane;
      const unsigned bits = ch < n_chunks ? s_mask[ch] : 0u;
      const int n = __popc(bits);
      int incl = n;
      for (int o = 1; o < 32; o <<= 1) {
        const int up = __shfl_up_sync(FULL_MASK, incl, o);
        if (lane >= o) incl += up;
      }
      for (int q = ch0 + warp; q < min(ch0 + 32, n_chunks); q += CYL_WARPS) {
        const int start = n_rem + __shfl_sync(FULL_MASK, incl - n, q - ch0);
        const unsigned qbits = __shfl_sync(FULL_MASK, bits, q - ch0);
        if ((qbits >> lane) & 1u)
          s_compact[start + __popc(qbits & ((1u << lane) - 1u))] = q * 32 + lane;
      }
      n_rem += __shfl_sync(FULL_MASK, incl, 31);
    }
    if (si == 0) cnt0 = (float)n_rem;
    __syncthreads();
    const float n_left = (float)n_rem;
    const bool round_ok = n_left > (float)a.min_activated && n_left > 0.1f * cnt0
                          && n_left >= 3.0f;
    const int rs = region * s_n + si;
    if (n_rem == 0) {
      // no cell remains: the plain round finds no inlier whatever it scores,
      // and the LLS of empty sums (k clamped to 1) is radius 0 at the origin;
      // the round is invalid.  The same values, without the scoring.  (No
      // later round has a cell either, so no CTA scores again.)
      if (leader) {
        if (tid == 0) {
          a.centers[3 * rs] = 0.0f;
          a.centers[3 * rs + 1] = 0.0f;
          a.centers[3 * rs + 2] = 0.0f;
          a.radii[rs] = 0.0f;
          a.valids[rs] = 0;
          a.mses[rs] = INFINITY;
        }
        for (int i = tid; i < c; i += CYL_THREADS) a.inliers[(size_t)rs * c + i] = 0;
      }
      continue;   // n_rem is the cluster's: every thread skips together
    }

    // hypotheses: the scrambled triplets over the compacted remaining cells,
    // a thread each
    for (int b = tid; b < a.n_hyp; b += CYL_THREADS) {
      const Hypothesis hb = hypothesis(b, si, n_rem, s_compact, s_pc, s_pn);
      s_hyp[b][0] = hb.r;
      s_hyp[b][1] = hb.h[0];
      s_hyp[b][2] = hb.h[1];
      s_hyp[b][3] = hb.h[2];
      s_hyp[b][4] = hb.hs;
    }
    __syncthreads();

    // MSAC scores, hypothesis b on CTA b % CYL_CLUSTER: a warp a hypothesis
    // over every cell (a NaN distance makes the score NaN, as clamp_max and
    // the weighted sum carry it), written into every CTA of the cluster
    float* msac = s_msac[si & 1];
    for (int b = (int)rank + CYL_CLUSTER * warp; b < a.n_hyp; b += CYL_CLUSTER * CYL_WARPS) {
      const Hypothesis hb = stored_hypothesis(s_hyp[b]);
      float acc = 0.0f;
#pragma unroll 4
      for (int i = lane; i < c; i += 32) {
        const float d2 = rel_dist2(s_pc[i], s_pn[i], hb);
        const float clamped = d2 > a.trunc ? a.trunc : d2;
        acc += (s_rem[i] ? 1.0f : 0.0f) * clamped;
      }
      acc = warp_sum(acc);
      if (lane < CYL_CLUSTER) *cluster.map_shared_rank(&msac[b], lane) = acc;
    }
    cluster.sync();

    // the first minimum, by a warp
    if (warp == 0) {
      int best = -1;
      float bv = 0.0f;
      for (int b = lane; b < a.n_hyp; b += 32) {
        const float v = msac[b];
        if (best < 0 || argmin_before(v, b, bv, best)) {
          best = b;
          bv = v;
        }
      }
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(FULL_MASK, bv, o);
        const int ob = __shfl_xor_sync(FULL_MASK, best, o);
        if (ob >= 0 && (best < 0 || argmin_before(ov, ob, bv, best))) {
          best = ob;
          bv = ov;
        }
      }
      if (lane == 0) s_best = best;
    }
    __syncthreads();
    const Hypothesis hbest = stored_hypothesis(s_hyp[s_best]);

    // inliers of the best hypothesis (a bit a cell of this thread), and the
    // refit's sums over them
    float sums[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    unsigned inl_bits = 0u;
    for (int i = tid, m = 0; i < c; i += CYL_THREADS, ++m) {
      const float4 pc = s_pc[i], pn = s_pn[i];
      const bool inl = s_rem[i] && rel_dist2(pc, pn, hbest) < a.trunc;
      if constexpr (kGlobal)
        s_inl[i] = inl;
      else
        inl_bits |= (inl ? 1u : 0u) << m;
      const float iw = inl ? 1.0f : 0.0f;
      sums[0] += pn.x * iw;
      sums[1] += pn.y * iw;
      sums[2] += pn.z * iw;
      sums[3] += pc.x * iw;
      sums[4] += pc.y * iw;
      sums[5] += pc.z * iw;
      sums[6] += ((pn.x * pc.x) * iw + (pn.y * pc.y) * iw) + (pn.z * pc.z) * iw;
      sums[7] += iw;
    }
    block_sums(sums, 8, s_red[0]);
    const float kin = sums[7];
    const bool seg_ok = round_ok && kin >= 6.0f;
    float radius, center[3];
    lls_cylinder(sums, sums + 3, sums[6], kin, &radius, center);
    radius = fabsf(radius);

    // MSE: (distance to the axis line - radius)^2 over the inliers
    float sq = 0.0f;
    for (int i = tid, m = 0; i < c; i += CYL_THREADS, ++m) {
      const bool inl = kGlobal ? s_inl[i] != 0 : ((inl_bits >> m) & 1u) != 0u;
      const float iw = inl ? 1.0f : 0.0f;
      const float r0 = s_mean[3 * i] - center[0];
      const float r1 = s_mean[3 * i + 1] - center[1];
      const float r2 = s_mean[3 * i + 2] - center[2];
      const float along = (r0 * ax0 + r1 * ax1) + r2 * ax2;
      const float q0 = r0 - along * ax0, q1 = r1 - along * ax1, q2 = r2 - along * ax2;
      const float dist = sqrtf((q0 * q0 + q1 * q1) + q2 * q2) - radius;
      sq += (iw * dist) * dist;
    }
    block_sums(&sq, 1, s_red[1]);
    const float mse = sq / fmaxf(kin, 1.0f);

    // this region's row of the routed outputs, and the next round's cells
    if (leader && tid == 0) {
      a.centers[3 * rs] = center[0];
      a.centers[3 * rs + 1] = center[1];
      a.centers[3 * rs + 2] = center[2];
      a.radii[rs] = radius;
      a.valids[rs] = seg_ok;
      a.mses[rs] = seg_ok ? (isfinite(mse) ? mse : 0.0f) : INFINITY;
    }
    uint8_t* inl_out = a.inliers + (size_t)rs * c;
    for (int i0 = warp * 32, m = 0; i0 < c; i0 += CYL_THREADS, ++m) {
      const int i = i0 + lane;
      const bool taken =
          seg_ok && (kGlobal ? i < c && s_inl[i] != 0 : ((inl_bits >> m) & 1u) != 0u);
      const bool left = i < c && s_rem[i] && !taken;
      if (leader && i < c) inl_out[i] = taken;
      if (taken) s_rem[i] = 0;
      const unsigned bits = __ballot_sync(FULL_MASK, left);
      if (lane == 0) s_mask[i0 >> 5] = bits;
    }
    __syncthreads();
  }
}

// the shared-memory path
__global__ void __cluster_dims__(CYL_CLUSTER, 1, 1) __launch_bounds__(CYL_THREADS)
    cylinders_kernel(const CylArgs a) {
  cylinders_body<false>(a);
}

// the global-memory path, for grids past one CTA's shared memory
__global__ void __cluster_dims__(CYL_CLUSTER, 1, 1) __launch_bounds__(CYL_THREADS)
    cylinders_kernel_global(const CylArgs a) {
  cylinders_body<true>(a);
}

extern "C" int cylinders_launch(const CylArgs* args, int slots, void* stream) {
  const CylArgs a = *args;
  const bool global = a.scratch != nullptr;
  if (a.c <= 0 || a.c > (global ? CYL_MAX_CELLS_GLOBAL : CYL_MAX_CELLS) || a.k <= 0
      || a.k > CYL_MAX_REGIONS || a.n_hyp <= 0 || a.n_hyp > CYL_MAX_HYP || a.subsegments <= 0
      || a.subsegments > CYL_MAX_SUBSEGMENTS || slots <= 0 || slots > a.k)
    return (int)cudaErrorInvalidValue;
  if (global) {
    cylinders_kernel_global<<<slots * CYL_CLUSTER, CYL_THREADS, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
  }
  const size_t smem = cylinders_smem(a.c, a.k);
  // the dynamic part beside the ~9 kB of static arrays needs the opt-in above
  // the 48 kB default; set once a device, on the first (eager) launch
  static bool opted_in[64] = {};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (!opted_in[device]) {
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, cylinders_kernel);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(cylinders_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               232448 - (int)attr.sharedSizeBytes);
    if (e != cudaSuccess) return (int)e;
    opted_in[device] = true;
  }
  cylinders_kernel<<<slots * CYL_CLUSTER, CYL_THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Bytes of the global path's scratch for `slots` region slots of c cells.
extern "C" size_t cylinders_scratch_bytes(int c, int slots) {
  return (size_t)slots * CYL_CLUSTER * cylinders_scratch(c);
}
