// The pose optimizer's RANSAC scoring for Hopper: every hypothesis' score,
// the best hypothesis, and its inlier masks, in one launch.
//
// Not a port of a Pallas kernel: the device form of the scoring in
// rgbd_slam_tpu/pose/optimizer.py (the vmapped `_score_pose`, the rank and its
// argmax, the best pose's masks) and of `inlier_masks_prepared` in
// rgbd_slam_tpu/pose/residuals.py, which XLA compiles into fused kernels.
// Its plain PyTorch version is `score_reference` in
// rgbd_slam_tpu_torch/ops/ransac_score_cuda.py: `inlier_masks_prepared` on
// the features compacted to the caps for the scores, at the best pose over
// every row for the masks.
//
// What it computes, for each hypothesis h (one CTA each):
//   * the world-to-camera transform of coefficients h, as
//     se3.coefficients_to_pose -> se3.world_to_camera build it;
//   * every row's inlier test (pose/residuals.inlier_masks_prepared): a point
//     when its L1 reprojection error is at most the point limit; an
//     inverse-depth point when both components of its signed distance to the
//     projected far-near segment (the point distance under 1e-12 px^2) are at
//     most the 2D limit; a plane when its three wrapped normal angles are at
//     most the normal limit and its d error at most the mm limit; a line when
//     both endpoints' distances to the projected line (1e-12 and 1e-9 floors)
//     are at most the line limit.  An invalid projection reads BIG_RESIDUAL,
//     a masked row is never an inlier;
//   * its score from the inliers among the first cap[t] live rows of each
//     type t (the rows the compacted feature set of the plain scoring holds,
//     found by a per-type prefix count): POINT_SCORE n_p + POINT2D_SCORE n_q
//     + PLANE_SCORE n_k + LINE_SCORE n_l in float32 in that order, -1 where
//     the hypothesis is not ok, and its count n_p + n_q + n_k + n_l.
// The last CTA to finish (a ticket taken after __threadfence) ranks the
// hypotheses (score + 1e-6 count), takes the first maximum as torch.argmax
// does, writes the winner's index, coefficients and score, and tests every
// row at the winner's pose for its four bool masks.  The refit's scoring is
// one CTA at one pose, which writes its own masks.
//
// Rounding.  Every tested value is the plain version's on the card to the bit,
// so the decisions are too: built with -fmad=false, each product and sum
// rounds on its own, in the plain chain's order, and where the plain chain
// calls a matrix product or a reduction, the kernel rounds as the card's
// kernel for it does (found by comparing the card's results with every order
// of the terms, fused or not: dot_pairs, dot_chain, the sum of squares in
// pose_of, norm2).  The card rounds se3's products of a batch of poses
// otherwise than those of one pose, and the plain scoring takes the
// hypotheses as a batch but the best pose's masks at that pose alone: so a
// hypothesis' CTA builds its pose as a batch's, the last CTA the winner's as
// one pose's.
//
// What bounds it on Hopper.  Latency: the main path's 96 hypotheses x 816
// rows are ~3.9 MFLOP and ~35 KB (ransac_score_cuda.score_work), well under
// a tenth of a microsecond of either.  One CTA a hypothesis, a thread a row
// (rows rounded up to warps, at most 1024 threads: the main path's rows in one
// pass), the pose built in registers on every thread (no barrier before the
// rows), the per-type ranks that the caps need from one ballot a type and the
// warps' counts in shared memory, the counts summed as integers in a fixed
// order; then one more pass of rows in the last CTA.  No float atomics: a
// launch repeats to the bit.
// Shared memory, and what orders each write before its reads:
//   * the warps' live counts and counted inliers a type: written by lane 0 of
//     each warp, read by every thread after the __syncthreads that follows;
//     a next pass (rows past 1024) writes them after a further __syncthreads;
//   * the last CTA's flag and the ranks' reduction: written before, read
//     after a __syncthreads.
// Global scratch: each CTA's score and count are written by thread 0, which
// then runs __threadfence and takes the ticket; the last CTA reads them with
// __ldcg (no L1).  The ticket wraps to 0 in the last CTA's atomicInc, so the
// next launch, and a CUDA graph's replay, finds it at 0.

#include <cuda_runtime.h>
#include <stdint.h>

#define RS_MAX_THREADS 1024
#define RS_MAX_WARPS (RS_MAX_THREADS / 32)
#define RS_BIG 1.0e4f
#define RS_FULL 0xffffffffu

// The kernel's arguments; ransac_score_cuda.py's ctypes structure mirrors
// this layout.
struct ScoreArgs {
  const float* pts;           // [P, 3]: points, far, near, line starts, line ends
  const float* point_obs;     // [NP, 2]
  const uint8_t* point_mask;  // [NP]
  const float* p2d_obs;       // [N2, 2]
  const uint8_t* p2d_mask;    // [N2]
  const float* plane_world;   // [NK, 4]
  const float* plane_cam;     // [NK, 4]
  const uint8_t* plane_mask;  // [NK]
  const float* line_p0;       // [NL, 2]
  const float* line_p1;       // [NL, 2]
  const uint8_t* line_mask;   // [NL]
  const float* coeffs;        // [H, 6]
  const uint8_t* hyp_ok;      // [H], or null: every hypothesis ok
  float* scores;              // [H] out
  int* counts;                // [H] out
  unsigned* ticket;           // [1], 0 between launches
  long long* best;            // [1] out
  float* best_coeffs;         // [6] out
  float* best_score;          // [1] out
  uint8_t* inliers;           // [NP + N2 + NK + NL] out: the winner's masks
  float* values;              // [H, NP + 2 N2 + 4 NK + 2 NL] out, or null: the
                              // tested values (see row_test)
  int hyps, np, n2, nk, nl;
  int batched;                // 1: hypotheses, a batch (the last CTA masks the
                              // winner); 0: one pose (H = 1), masked by its CTA
  int cap[4];                 // rows of each type that count towards a score
  float fx, fy, cx, cy;
  float limit[5];             // point px, 2D px, plane normal, plane mm, line px
  float weight[4];            // POINT_SCORE, POINT2D_SCORE, PLANE_SCORE, LINE_SCORE
};

__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }

// sum_k a[k] x[k] as the card's batched small matrix products round them
// (torch.matmul of [B, 3, 3] or [B, 4, 4] by [B, 3 or 4, 1], and se3's
// products of one pose): the terms in pairs, a pair's second product fused
// into its first, the pairs' sums added
template <int K>
__device__ __forceinline__ float dot_pairs(const float* a, const float* x) {
  const float s = __fmaf_rn(a[1], x[1], fmul(a[0], x[0]));
  if (K == 3) return fadd(s, fmul(a[2], x[2]));
  return fadd(s, __fmaf_rn(a[3], x[3], fmul(a[2], x[2])));
}

// sum_k a[k] x[k] of 3 terms as the card rounds se3's products of a batch of
// poses ([H, 3, 3] by [H, 3, 1], [H, 1, 3] by [H, 3, 3]): each later product
// fused into the sum, in order
__device__ __forceinline__ float dot_chain(const float* a, const float* x) {
  return __fmaf_rn(a[2], x[2], __fmaf_rn(a[1], x[1], fmul(a[0], x[0])));
}

// The world-to-camera transform of coefficients c: rotation, translation, and
// the last row of the plane transform, -(t^T R) (se3.plane_world_to_camera_matrix).
struct Pose {
  float r[3][3];
  float t[3];
  float last[3];
};

// se3.coefficients_to_pose, quat_to_matrix and world_to_camera: camera_to_world
// is AXIS_CORRECTION @ [R | p] (rows R2, -R0, -R1; translation p2, -p0, -p1),
// its inverse [Rc^T | -Rc^T tc].  `batched`: rounded as the pose of a batch.
__device__ __forceinline__ void pose_of(const float* c, bool batched, Pose& P) {
  const float s0 = c[3], s1 = c[4], s2 = c[5];
  // torch.sum of the three squares: the first and the last, then the middle
  const float alpha = fadd(fadd(fmul(s0, s0), fmul(s2, s2)), fmul(s1, s1));
  const float divider = __fdiv_rn(1.f, fadd(alpha, 1.f));
  const float w = fmul(fmul(2.f, s0), divider), x = fmul(fmul(2.f, s1), divider);
  const float y = fmul(fmul(2.f, s2), divider), z = fmul(fsub(1.f, alpha), divider);
  const float xx = fmul(x, x), yy = fmul(y, y), zz = fmul(z, z);
  const float wx = fmul(w, x), wy = fmul(w, y), wz = fmul(w, z);
  const float xy = fmul(x, y), xz = fmul(x, z), yz = fmul(y, z);
  float R[3][3];
  R[0][0] = fsub(1.f, fmul(2.f, fadd(yy, zz)));
  R[0][1] = fmul(2.f, fsub(xy, wz));
  R[0][2] = fmul(2.f, fadd(xz, wy));
  R[1][0] = fmul(2.f, fadd(xy, wz));
  R[1][1] = fsub(1.f, fmul(2.f, fadd(xx, zz)));
  R[1][2] = fmul(2.f, fsub(yz, wx));
  R[2][0] = fmul(2.f, fsub(xz, wy));
  R[2][1] = fmul(2.f, fadd(yz, wx));
  R[2][2] = fsub(1.f, fmul(2.f, fadd(xx, yy)));
  const float tc[3] = {c[2], -c[0], -c[1]};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    P.r[i][0] = R[2][i];
    P.r[i][1] = -R[0][i];
    P.r[i][2] = -R[1][i];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
    P.t[i] = -(batched ? dot_chain(P.r[i], tc) : dot_pairs<3>(P.r[i], tc));
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float col[3] = {P.r[0][j], P.r[1][j], P.r[2][j]};
    P.last[j] = -(batched ? dot_chain(P.t, col) : dot_pairs<3>(P.t, col));
  }
}

struct Screen {
  float u, v;
  bool ok;
};

// pinhole.world_to_screen: the camera point (a matrix product, then + t),
// camera_to_screen's safe_z (1e-9 where |z| < 1e-9), and the validity z > 0
// with a finite [u, v, z]
__device__ __forceinline__ Screen project(const Pose& P, const float* X, const ScoreArgs& a) {
  float pc[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) pc[i] = fadd(dot_pairs<3>(P.r[i], X), P.t[i]);
  const float safe_z = fabsf(pc[2]) < 1e-9f ? 1e-9f : pc[2];
  Screen s;
  s.u = fadd(__fdiv_rn(fmul(a.fx, pc[0]), safe_z), a.cx);
  s.v = fadd(__fdiv_rn(fmul(a.fy, pc[1]), safe_z), a.cy);
  s.ok = pc[2] > 0.f && isfinite(s.u) && isfinite(s.v) && isfinite(pc[2]);
  return s;
}

__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

// torch.linalg.vector_norm of a 2-vector as the card rounds it: the squares
// rounded, then summed
__device__ __forceinline__ float norm2(float x, float y) {
  return __fsqrt_rn(fadd(fmul(x, x), fmul(y, y)));
}

// the offsets of a row type's tested values in a hypothesis' row of `values`
__device__ __forceinline__ int values_per_hyp(const ScoreArgs& a) {
  return a.np + 2 * a.n2 + 4 * a.nk + 2 * a.nl;
}

// Row f of the unified order (points, 2D points, planes, lines) at pose P:
// whether it passes its test (the mask aside).  With `vals`, the tested
// values: a point's L1 error; a 2D point's two signed components; a plane's
// three wrapped angles and its d error; a line's two endpoint distances.
__device__ bool row_test(const Pose& P, const ScoreArgs& a, int f, float* vals) {
  const float* pts = a.pts;
  if (f < a.np) {
    const Screen s = project(P, pts + 3 * f, a);
    const float* obs = a.point_obs + 2 * f;
    const float du = s.ok ? fsub(obs[0], s.u) : RS_BIG;
    const float dv = s.ok ? fsub(obs[1], s.v) : RS_BIG;
    const float d = fadd(fabsf(du), fabsf(dv));
    if (vals) vals[f] = d;
    return d <= a.limit[0];
  }
  f -= a.np;
  if (f < a.n2) {
    const Screen s0 = project(P, pts + 3 * (a.np + f), a);          // far
    const Screen s1 = project(P, pts + 3 * (a.np + a.n2 + f), a);   // near
    const float* obs = a.p2d_obs + 2 * f;
    float q0 = RS_BIG, q1 = RS_BIG;
    if (s0.ok && s1.ok) {
      const float dx = fsub(s1.u, s0.u), dy = fsub(s1.v, s0.v);
      const float relx = fsub(obs[0], s0.u), rely = fsub(obs[1], s0.v);
      if (fadd(fmul(dx, dx), fmul(dy, dy)) < 1e-12f) {
        q0 = relx;   // the point distance
        q1 = rely;
      } else {       // lines.segment_signed_distance_to_point
        const float nrm = clamp_min(norm2(dx, dy), 1e-12f);
        const float ux = __fdiv_rn(dx, nrm), uy = __fdiv_rn(dy, nrm);
        const float along = fadd(fmul(relx, ux), fmul(rely, uy));
        q0 = fsub(relx, fmul(along, ux));
        q1 = fsub(rely, fmul(along, uy));
      }
    }
    if (vals) {
      vals[a.np + 2 * f] = q0;
      vals[a.np + 2 * f + 1] = q1;
    }
    return fabsf(q0) <= a.limit[1] && fabsf(q1) <= a.limit[1];
  }
  f -= a.n2;
  if (f < a.nk) {   // planes.signed_distance through the plane transform
    const float* nw = a.plane_world + 4 * f;
    const float* nc = a.plane_cam + 4 * f;
    bool in = true;
    float* out = vals ? vals + a.np + 2 * a.n2 + 4 * f : nullptr;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float row[4] = {P.r[i][0], P.r[i][1], P.r[i][2], 0.f};
      const float diff = fsub(nc[i], dot_pairs<4>(row, nw));
      const float ang = atan2f(sinf(diff), cosf(diff));
      if (out) out[i] = ang;
      in = in && fabsf(ang) <= a.limit[2];
    }
    const float row[4] = {P.last[0], P.last[1], P.last[2], 1.f};
    const float dd = fsub(nc[3], dot_pairs<4>(row, nw));
    if (out) out[3] = dd;
    return in && fabsf(dd) <= a.limit[3];
  }
  f -= a.nk;
  const int base = a.np + 2 * a.n2;
  const Screen l0 = project(P, pts + 3 * (base + f), a);
  const Screen l1 = project(P, pts + 3 * (base + a.nl + f), a);
  const float* q0 = a.line_p0 + 2 * f;
  const float* q1 = a.line_p1 + 2 * f;
  float r0 = RS_BIG, r1 = RS_BIG;
  if (l0.ok && l1.ok) {   // pose/residuals._line_point_distances
    const float dx = fsub(l1.u, l0.u), dy = fsub(l1.v, l0.v);
    const float ss = fadd(fmul(dx, dx), fmul(dy, dy));
    if (!(ss < 1e-9f)) {
      const float nrm = __fsqrt_rn(clamp_min(ss, 1e-12f));
      const float nx = __fdiv_rn(-dy, nrm), ny = __fdiv_rn(dx, nrm);
      r0 = fadd(fmul(fsub(q0[0], l0.u), nx), fmul(fsub(q0[1], l0.v), ny));
      r1 = fadd(fmul(fsub(q1[0], l0.u), nx), fmul(fsub(q1[1], l0.v), ny));
    }
  }
  if (vals) {
    const int o = a.np + 2 * a.n2 + 4 * a.nk + 2 * f;
    vals[o] = r0;
    vals[o + 1] = r1;
  }
  return fabsf(r0) <= a.limit[4] && fabsf(r1) <= a.limit[4];
}

__device__ __forceinline__ int row_type(int f, const ScoreArgs& a) {
  return (f >= a.np) + (f >= a.np + a.n2) + (f >= a.np + a.n2 + a.nk);
}

__device__ __forceinline__ bool row_live(int f, int type, const ScoreArgs& a) {
  switch (type) {
    case 0: return a.point_mask[f] != 0;
    case 1: return a.p2d_mask[f - a.np] != 0;
    case 2: return a.plane_mask[f - a.np - a.n2] != 0;
    default: return a.line_mask[f - a.np - a.n2 - a.nk] != 0;
  }
}

// the best (rank, index) of the warp's lanes into lane 0: the higher rank,
// the lower index of equal ranks; index `none` holds nothing
__device__ __forceinline__ void warp_best(float& rank, int& index, int none) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float rk = __shfl_down_sync(RS_FULL, rank, o);
    const int i = __shfl_down_sync(RS_FULL, index, o);
    if (i != none && (index == none || rk > rank || (rk == rank && i < index))) {
      rank = rk;
      index = i;
    }
  }
}

struct Shared {
  int live[RS_MAX_WARPS][4];     // a warp's live rows of each type
  int counted[RS_MAX_WARPS][4];  // a warp's counted inliers of each type
  float rank[RS_MAX_WARPS];      // the last CTA's reduction
  int index[RS_MAX_WARPS];
  int last;
};

// Every row tested at pose P into the masks (inliers: live and passing).
__device__ __forceinline__ void write_masks(const Pose& P, const ScoreArgs& a, int rows) {
  for (int f = threadIdx.x; f < rows; f += blockDim.x) {
    const int type = row_type(f, a);
    a.inliers[f] = row_live(f, type, a) && row_test(P, a, f, nullptr);
  }
}

__global__ void __launch_bounds__(RS_MAX_THREADS) ransac_score_kernel(const ScoreArgs a) {
  __shared__ Shared sh;
  const int h = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int rows = a.np + a.n2 + a.nk + a.nl;
  const unsigned below = (1u << lane) - 1u;
  const float neg_inf = -__int_as_float(0x7f800000);

  Pose P;
  pose_of(a.coeffs + 6 * h, a.batched != 0, P);
  float* vals = a.values ? a.values + (long long)h * values_per_hyp(a) : nullptr;

  // live rows of each type before this pass, and counted inliers so far
  // (the same on every thread)
  int live_before[4] = {0, 0, 0, 0}, counted[4] = {0, 0, 0, 0};
  for (int r0 = 0; r0 < rows; r0 += blockDim.x) {
    const int f = r0 + threadIdx.x;
    const int type = f < rows ? row_type(f, a) : 4;
    const bool live = type < 4 && row_live(f, type, a);
    // a masked row is tested only for its values
    const bool in = type < 4 && (live || vals != nullptr) && row_test(P, a, f, vals) && live;
    if (!a.batched && f < rows) a.inliers[f] = in;   // one pose: its own masks
    unsigned mine = 0;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const unsigned b = __ballot_sync(RS_FULL, live && type == t);
      if (t == type) mine = b;
      if (lane == 0) sh.live[warp][t] = __popc(b);
    }
    __syncthreads();
    int rank = __popc(mine & below);
    if (type < 4) {
      rank += live_before[type];
      for (int w = 0; w < warp; ++w) rank += sh.live[w][type];
    }
    const bool counts = in && rank < a.cap[type < 4 ? type : 0];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const unsigned b = __ballot_sync(RS_FULL, counts && type == t);
      if (lane == 0) sh.counted[warp][t] = __popc(b);
    }
    __syncthreads();
    for (int w = 0; w < n_warps; ++w) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        live_before[t] += sh.live[w][t];
        counted[t] += sh.counted[w][t];
      }
    }
    if (r0 + (int)blockDim.x < rows) __syncthreads();   // the reads before the next writes
  }

  // the score: weights times counts, summed in type order, in float32
  const bool ok = a.hyp_ok == nullptr || a.hyp_ok[h] != 0;
  float score = fmul(a.weight[0], (float)counted[0]);
#pragma unroll
  for (int t = 1; t < 4; ++t) score = fadd(score, fmul(a.weight[t], (float)counted[t]));
  if (!ok) score = -1.f;
  if (threadIdx.x == 0) {
    a.scores[h] = score;
    a.counts[h] = counted[0] + counted[1] + counted[2] + counted[3];
    __threadfence();
    sh.last = a.hyps == 1 || atomicInc(a.ticket, a.hyps - 1) == (unsigned)(a.hyps - 1);
  }
  __syncthreads();
  if (!sh.last) return;

  // rank = score + 1e-6 count; the first maximum (torch.argmax): a thread's
  // hypotheses ascend, so it keeps the first of equal ranks, and the
  // reductions keep the lower index of equal ranks
  float best_rank = neg_inf;
  int best_h = a.hyps;
  for (int g = threadIdx.x; g < a.hyps; g += blockDim.x) {
    const float rk = fadd(__ldcg(a.scores + g), fmul(1e-6f, (float)__ldcg(a.counts + g)));
    if (best_h == a.hyps || rk > best_rank) {
      best_rank = rk;
      best_h = g;
    }
  }
  warp_best(best_rank, best_h, a.hyps);
  if (lane == 0) {
    sh.rank[warp] = best_rank;
    sh.index[warp] = best_h;
  }
  __syncthreads();
  if (warp == 0) {
    best_rank = lane < n_warps ? sh.rank[lane] : neg_inf;
    best_h = lane < n_warps ? sh.index[lane] : a.hyps;
    warp_best(best_rank, best_h, a.hyps);
    if (lane == 0) sh.index[0] = best_h;
  }
  __syncthreads();
  const int b = sh.index[0];
  if (threadIdx.x == 0) {
    *a.best = b;
    *a.best_score = __ldcg(a.scores + b);
  }
  if (threadIdx.x < 6) a.best_coeffs[threadIdx.x] = a.coeffs[6 * b + threadIdx.x];
  if (a.batched) {   // the winner's masks, at its pose as one pose's
    Pose W;
    pose_of(a.coeffs + 6 * b, false, W);
    write_masks(W, a, rows);
  }
}

// One CTA a hypothesis, `threads` threads (ransac_score_cuda.launch_threads:
// the rows rounded up to whole warps, at most RS_MAX_THREADS).
extern "C" int ransac_score_launch(const ScoreArgs* args, int threads, void* stream) {
  if (args->hyps <= 0 || (!args->batched && args->hyps != 1) || threads < 32 ||
      threads > RS_MAX_THREADS || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  ransac_score_kernel<<<args->hyps, threads, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
