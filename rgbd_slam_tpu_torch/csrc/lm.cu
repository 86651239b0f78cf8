// The pose optimizer's Levenberg-Marquardt solve for Hopper.
//
// Not a port of a Pallas kernel: the device form of `lm_solve` in
// rgbd_slam_tpu/pose/optimizer.py:50, which XLA compiles from a `lax.scan`
// (unrolled) over `jax.linearize` of the stacked pose residual into a handful
// of fused kernels.  Its plain PyTorch version is `lm_solve_reference` in
// rgbd_slam_tpu_torch/ops/lm_cuda.py (`vmap(jvp)` over the six coefficient
// tangents and the column-by-column 6x6 Cholesky of pose/linalg6.py).
//
// What it computes, for each batch member independently:
//   * linearize the residual of `residual_vector_prepared` at coeffs0: the
//     residual r, the Jacobian J [R, 6] and the cost r.r;
//   * `iterations` times: form the trial best + solve6_spd(JtJ + damping *
//     diag(max(diag JtJ, 1e-8)) + 1e-12 I, -Jtr) from the best point's normal
//     equations, linearize at the trial, accept it when its cost is lower and
//     all of it is finite (damping / 2), else reject it (damping * 4); the
//     damping is clamped to [1e-9, 1e6];
//   * return the best coefficients and cost.
// The residual rows, in the plain order: 3D points (pinhole reprojection,
// BIG_RESIDUAL where the projection is invalid), inverse-depth points (the
// signed distance to the projected far-near segment, the point distance under
// 1e-12 px^2), planes (`reduced_signed_distance` through the plane transform of
// the pose), lines (the endpoints' distances to the projected line, with its
// 1e-12 and 1e-9 floors); each block scaled by alpha / parts.  A masked feature
// gives zero rows.  The pose comes from `se3.coefficients_to_pose`: position in
// the first three coefficients, the stereographic rotation in the last three.
//
// Derivatives.  Every quantity that depends on the pose is a dual number: a
// value and its tangents, carried in registers, as `jax.linearize` and
// `torch.func.jvp` carry them.  Where the plain code selects (`torch.where`, a
// clamp), the tangent follows the branch taken and the rule torch applies:
// a constant (BIG_RESIDUAL, the 1e-9 depth floor) has a zero tangent, and a
// clamp passes the tangent where its input is at or past the floor.
//
// What bounds it on Hopper.  By the roofline, operations: the refit batch of
// the main path (101 members, 896 residual rows, 7 linearizations) is at most
// 0.14 GFLOP of f32 (every feature live; a real frame's are ~20 MFLOP) against
// 0.7 MB of inputs, a few microseconds either way (lm_cuda.lm_work counts it).
// In fact the chain: each member is a sequence of 7 or 11 linearizations, and
// each waits for the previous one's reduction and 6x6 solve, so the time is
// the latency of one link times the links.  The design shortens the link
// (tools/lm_diagnostics.py breakdown times each part and each alternative):
//   * one CTA a member.  Its threads (the features' slots rounded up to whole
//     warps, 32 to 128; lm_cuda.launch_shape picks them) take the member's
//     LIVE features, listed once a launch in shared memory (a ballot and a
//     prefix over the masks, in a fixed order), round robin.  The list puts the
//     dear types first (inverse-depth points, lines, planes, then points), so
//     each thread gets ceil(live / threads) features of like cost, a warp's
//     lanes mostly the same type, and a masked slot costs nothing.  128
//     threads, one warp a scheduler: with 256 the four schedulers each run the
//     LM state's work twice (see below) and the refit takes longer;
//   * every warp holds the whole LM state itself, spread over its lanes: lane
//     k < 6 holds coefficient k of the trial and of the best point, row k of
//     the best point's JtJ and Jtr[k]; every lane holds the best cost, the
//     damping and the accept bits.  All lanes of all warps take the same
//     decisions from the same broadcast sums, so the state is never handed
//     from one thread to another through memory;
//   * the pose and its tangents are built on six lanes, lane k carrying the
//     value and tangent k (a dual number of one tangent), and written to the
//     warp's own slot in shared memory, where the warp's features read them;
//   * a dual quotient or root divides once and multiplies its six tangents by
//     the reciprocal (an IEEE division is a dozen instructions; the tangents
//     move by an ulp, far inside the linearization's tolerance);
//   * a thread's 28 terms (JtJ's upper triangle in row order, Jtr, the cost)
//     are summed over the warp by a transposing reduction: each of 5 steps
//     trades half the terms a lane holds with its partner, 16 + 8 + 4 + 2 + 1 =
//     31 shuffles, and lane k ends with term k.  With more than one warp, lane
//     k of each warp writes its term to shared memory and, after one barrier,
//     lane k of every warp folds the warps' terms in warp order.  No float
//     atomics, a fixed order throughout: a launch repeats to the bit;
//   * the damped 6x6 system: every lane gathers it from lanes 0-5 (27
//     shuffles, all issued before the solve starts) and runs linalg6.solve_spd
//     serially, in its order of operations and with its roundings (column j
//     from a[j:, j] less the earlier columns' products, the pivot
//     sqrt(max(s, 1e-20)), forward then back substitution, `msub` with no fused
//     multiply-add), so a trial is the plain damped step from the same state
//     to an ulp.  The solve is a chain of six pivots (a root and a reciprocal
//     each) that no split shortens: solved row-parallel on six lanes, the same
//     operations wait on a shuffle at every pivot and substitution step, and
//     the launch took longer at both main-path shapes;
//   * a one-warp CTA (the hypotheses: 21 feature slots) is a separate kernel,
//     `lm_solve_kernel_warp`, that has no block barrier at all.
// Shared memory, and what orders each write before its reads:
//   * the live list: written in the listing, read in every linearization;
//     the barrier that ends the listing (__syncwarp for one warp,
//     __syncthreads for more) orders them;
//   * the listing's per-warp counts: written by lane 0 of each warp, read by
//     every thread after the __syncthreads that follows; a second
//     __syncthreads ends the reads before the next chunk's writes;
//   * a warp's pose slot: written by lanes 0-5 of that warp after a
//     __syncwarp (which ends the warp's reads of the previous pose), read by
//     its lanes after the __syncwarp that follows the writes;
//   * the warps' terms: double-buffered by linearization; written by lanes
//     0-27 of each warp, read by every warp after the __syncthreads that
//     follows.  A buffer is written again two linearizations later, after the
//     next linearization's __syncthreads, which every warp reaches only when
//     it has read it.
// Nothing else goes through memory: the coefficients, sums and system travel
// by shuffles.  The trace and the outputs are written by warp 0.
// Not done, and why: several one-warp members a CTA (at the main path's 32 and
// 101 members each CTA has an SM of its own, so it would only share one); the
// features' blocks staged in shared memory (a member's blocks, ~11 KB at the
// refit shape, stay in L1 between linearizations); tensor cores, TMA or
// clusters (no product large enough).  Nothing is differentiated through the
// solve, so there is no backward.

#include <cuda_runtime.h>
#include <stdint.h>

#define LM_MAX_THREADS 128
#define LM_WARPS (LM_MAX_THREADS / 32)
// the live list's shared memory, 4 bytes a feature (lm_cuda.MAX_FEATURES)
#define LM_MAX_LIST_BYTES 32768
// the 21 entries of JtJ's upper triangle, the 6 of Jtr and the cost
#define LM_TERMS 28
#define LM_BIG 1.0e4f
// a trace row, one a linearization: where it was taken (6), its cost, JtJ's
// upper triangle (21) and Jtr (6)
#define LM_TRACE 34
#define LM_FULL 0xffffffffu

// The kernel's arguments; lm_cuda.py's ctypes structure mirrors this layout.
// A float block of member b starts at ptr + b * stride (stride 0: one block
// shared by every member).
struct LMArgs {
  const float* pts;          // [P, 3]: points, far, near, line starts, line ends
  const float* point_obs;    // [NP, 2]
  const uint8_t* point_mask; // [NP]
  const float* p2d_obs;      // [N2, 2]
  const uint8_t* p2d_mask;   // [N2]
  const float* plane_world;  // [NK, 4]
  const float* plane_cam;    // [NK, 4]
  const uint8_t* plane_mask; // [NK]
  const float* line_p0;      // [NL, 2]
  const float* line_p1;      // [NL, 2]
  const uint8_t* line_mask;  // [NL]
  const float* coeffs0;      // [B, 6]
  float* coeffs;             // [B, 6] out
  float* cost;               // [B] out
  float* jtj;                // [B, 6, 6] out (the best point's), or null
  float* jtr;                // [B, 6] out, or null
  long long* accepts;        // [B] out, bit i: iteration i + 1 accepted (i < 63), or null
  float* trace;              // [B, iterations + 1, LM_TRACE] out, or null: each
                             // linearization's point, cost, JtJ upper triangle, Jtr
  long long stride[11];      // batch strides of the eleven feature blocks above
  int batch, np, n2, nk, nl, iterations;
  float fx, fy, cx, cy, damping0;
  float scale[4];            // alpha / parts of points, 2D points, planes, lines
};

// a value and N tangents: N = 6 for the residual rows, N = 1 for the pose,
// whose six tangents are built on six lanes
template <int N>
struct DualN {
  float v;
  float d[N];
};
typedef DualN<6> Dual;

template <int N>
__device__ __forceinline__ DualN<N> dconstN(float v) {
  DualN<N> r;
  r.v = v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = 0.f;
  return r;
}

__device__ __forceinline__ Dual dconst(float v) { return dconstN<6>(v); }

// coefficient k as an input, value c: tangent j of the dual carries direction
// first + j, so N = 6 (first 0) carries all six and N = 1 (first = the lane)
// carries the lane's own
template <int N>
__device__ __forceinline__ DualN<N> dvar(float c, int k, int first) {
  DualN<N> r;
  r.v = c;
#pragma unroll
  for (int j = 0; j < N; ++j) r.d[j] = first + j == k ? 1.f : 0.f;
  return r;
}

template <int N>
__device__ __forceinline__ DualN<N> operator+(const DualN<N>& a, const DualN<N>& b) {
  DualN<N> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] + b.d[k];
  return r;
}

template <int N>
__device__ __forceinline__ DualN<N> operator+(const DualN<N>& a, float b) {
  DualN<N> r = a;
  r.v = a.v + b;
  return r;
}

template <int N>
__device__ __forceinline__ DualN<N> operator-(const DualN<N>& a, const DualN<N>& b) {
  DualN<N> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] - b.d[k];
  return r;
}

template <int N>
__device__ __forceinline__ DualN<N> operator-(float a, const DualN<N>& b) {
  DualN<N> r;
  r.v = a - b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = -b.d[k];
  return r;
}

template <int N>
__device__ __forceinline__ DualN<N> operator-(const DualN<N>& a) {
  DualN<N> r;
  r.v = -a.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = -a.d[k];
  return r;
}

template <int N>
__device__ __forceinline__ DualN<N> operator*(const DualN<N>& a, const DualN<N>& b) {
  DualN<N> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] * b.v + b.d[k] * a.v;
  return r;
}

template <int N>
__device__ __forceinline__ DualN<N> operator*(const DualN<N>& a, float b) {
  DualN<N> r;
  r.v = a.v * b;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] * b;
  return r;
}

template <int N>
__device__ __forceinline__ DualN<N> operator*(float a, const DualN<N>& b) { return b * a; }

template <int N>
__device__ __forceinline__ DualN<N> operator/(const DualN<N>& a, const DualN<N>& b) {
  DualN<N> r;
  r.v = a.v / b.v;
  const float inv = 1.f / b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = (a.d[k] - r.v * b.d[k]) * inv;
  return r;
}

__device__ __forceinline__ Dual dsqrt(const Dual& a) {
  Dual r;
  r.v = sqrtf(a.v);
  const float inv = 1.f / (2.f * r.v);
#pragma unroll
  for (int k = 0; k < 6; ++k) r.d[k] = a.d[k] * inv;
  return r;
}

// torch.clamp_min: the tangent passes where x >= lo and is 0 elsewhere; NaN
// stays NaN
__device__ __forceinline__ Dual dclamp_min(const Dual& a, float lo) {
  return a.v >= lo ? a : dconst(a.v < lo ? lo : a.v);
}

__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

// The world-to-camera transform of the pose and its tangents, and the last row
// of the plane transform, [-t^T R, 1] (se3.plane_world_to_camera_matrix).
template <int N>
struct PoseN {
  DualN<N> r[3][3];
  DualN<N> t[3];
  DualN<N> last[3];
};
typedef PoseN<6> Pose;

// se3.coefficients_to_pose, quat_to_matrix and world_to_camera: camera_to_world
// is AXIS_CORRECTION @ [R | p] (rows R2, -R0, -R1; translation p2, -p0, -p1),
// and its inverse is [Rc^T | -Rc^T tc].  Tangent j carries direction first + j.
template <int N>
__device__ __forceinline__ void pose_of(const float* c, int first, PoseN<N>& P) {
  const DualN<N> p0 = dvar<N>(c[0], 0, first), p1 = dvar<N>(c[1], 1, first);
  const DualN<N> p2 = dvar<N>(c[2], 2, first);
  const DualN<N> s0 = dvar<N>(c[3], 3, first), s1 = dvar<N>(c[4], 4, first);
  const DualN<N> s2 = dvar<N>(c[5], 5, first);
  const DualN<N> alpha = s0 * s0 + s1 * s1 + s2 * s2;
  const DualN<N> divider = dconstN<N>(1.f) / (alpha + 1.f);
  const DualN<N> w = (2.f * s0) * divider, x = (2.f * s1) * divider, y = (2.f * s2) * divider;
  const DualN<N> z = (1.f - alpha) * divider;
  const DualN<N> xx = x * x, yy = y * y, zz = z * z;
  const DualN<N> wx = w * x, wy = w * y, wz = w * z;
  const DualN<N> xy = x * y, xz = x * z, yz = y * z;
  DualN<N> R[3][3];
  R[0][0] = 1.f - 2.f * (yy + zz);
  R[0][1] = 2.f * (xy - wz);
  R[0][2] = 2.f * (xz + wy);
  R[1][0] = 2.f * (xy + wz);
  R[1][1] = 1.f - 2.f * (xx + zz);
  R[1][2] = 2.f * (yz - wx);
  R[2][0] = 2.f * (xz - wy);
  R[2][1] = 2.f * (yz + wx);
  R[2][2] = 1.f - 2.f * (xx + yy);
  const DualN<N> tc[3] = {p2, -p0, -p1};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    P.r[i][0] = R[2][i];
    P.r[i][1] = -R[0][i];
    P.r[i][2] = -R[1][i];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
    P.t[i] = -(P.r[i][0] * tc[0] + P.r[i][1] * tc[1] + P.r[i][2] * tc[2]);
#pragma unroll
  for (int j = 0; j < 3; ++j)
    P.last[j] = -(P.t[0] * P.r[0][j] + P.t[1] * P.r[1][j] + P.t[2] * P.r[2][j]);
}

// lane k < 6 writes tangent k of a pose entry, lane 0 its value too
__device__ __forceinline__ void put(Dual& dst, const DualN<1>& x, int lane) {
  if (lane < 6) dst.d[lane] = x.d[0];
  if (lane == 0) dst.v = x.v;
}

// The warp's pose at coefficients c (the same on every lane) into its slot:
// lane k < 6 builds tangent k.  The caller orders the writes (__syncwarp).
__device__ __forceinline__ void build_pose(const float* c, int lane, Pose& P) {
  PoseN<1> p;
  pose_of<1>(c, lane, p);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) put(P.r[i][j], p.r[i][j], lane);
    put(P.t[i], p.t[i], lane);
    put(P.last[i], p.last[i], lane);
  }
}

struct Screen {
  Dual u, v;
  bool ok;
};

// pinhole.world_to_screen: camera_to_screen's safe_z (a constant 1e-9 where
// |z| < 1e-9) and the validity z > 0 with a finite [u, v, z]
__device__ __forceinline__ Screen project(const Pose& P, const float* X, const LMArgs& a) {
  Dual pc[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    pc[i] = P.r[i][0] * X[0] + P.r[i][1] * X[1] + P.r[i][2] * X[2] + P.t[i];
  const Dual safe_z = fabsf(pc[2].v) < 1e-9f ? dconst(1e-9f) : pc[2];
  Screen s;
  s.u = (a.fx * pc[0]) / safe_z + a.cx;
  s.v = (a.fy * pc[1]) / safe_z + a.cy;
  s.ok = pc[2].v > 0.f && isfinite(s.u.v) && isfinite(s.v.v) && isfinite(pc[2].v);
  return s;
}

// one residual row into the normal equations: JtJ's upper triangle, Jtr, cost
__device__ __forceinline__ void add_row(float* acc, const Dual& r) {
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = i; j < 6; ++j) acc[k++] += r.d[i] * r.d[j];
#pragma unroll
  for (int i = 0; i < 6; ++i) acc[21 + i] += r.d[i] * r.v;
  acc[27] += r.v * r.v;
}

__device__ __forceinline__ const float* block(const float* base, long long stride, int b) {
  return base + (long long)b * stride;
}

__device__ __forceinline__ const uint8_t* block(const uint8_t* base, long long stride, int b) {
  return base + (long long)b * stride;
}

// The rows of live feature f (points, then 2D points, planes, lines) of member
// b at pose P, added to acc.
__device__ void add_feature(float* acc, const Pose& P, const LMArgs& a, int b, int f) {
  const float* pts = block(a.pts, a.stride[0], b);
  if (f < a.np) {
    const Screen s = project(P, pts + 3 * f, a);
    const float* obs = block(a.point_obs, a.stride[1], b) + 2 * f;
    const float sc = a.scale[0];
    add_row(acc, (s.ok ? dconst(obs[0]) - s.u : dconst(LM_BIG)) * sc);
    add_row(acc, (s.ok ? dconst(obs[1]) - s.v : dconst(LM_BIG)) * sc);
    return;
  }
  f -= a.np;
  if (f < a.n2) {
    const Screen s0 = project(P, pts + 3 * (a.np + f), a);          // far
    const Screen s1 = project(P, pts + 3 * (a.np + a.n2 + f), a);   // near
    const float* obs = block(a.p2d_obs, a.stride[3], b) + 2 * f;
    const float sc = a.scale[1];
    Dual ru = dconst(LM_BIG), rv = dconst(LM_BIG);
    if (s0.ok && s1.ok) {
      const Dual dx = s1.u - s0.u, dy = s1.v - s0.v;
      const Dual seg_len_sq = dx * dx + dy * dy;
      const Dual relx = dconst(obs[0]) - s0.u, rely = dconst(obs[1]) - s0.v;
      if (seg_len_sq.v < 1e-12f) {
        ru = relx;   // the point distance
        rv = rely;
      } else {       // lines.segment_signed_distance_to_point
        const Dual nrm = dclamp_min(dsqrt(dx * dx + dy * dy), 1e-12f);
        const Dual ux = dx / nrm, uy = dy / nrm;
        const Dual along = relx * ux + rely * uy;
        ru = relx - along * ux;
        rv = rely - along * uy;
      }
    }
    add_row(acc, ru * sc);
    add_row(acc, rv * sc);
    return;
  }
  f -= a.n2;
  if (f < a.nk) {
    const float* nw = block(a.plane_world, a.stride[5], b) + 4 * f;
    const float* nc = block(a.plane_cam, a.stride[6], b) + 4 * f;
    const Dual proj3 = P.last[0] * nw[0] + P.last[1] * nw[1] + P.last[2] * nw[2] + nw[3];
    const float sc = a.scale[2];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const Dual proj = P.r[i][0] * nw[0] + P.r[i][1] * nw[1] + P.r[i][2] * nw[2];
      add_row(acc, (dconst(nc[3] * nc[i]) - proj3 * proj) * sc);
    }
    return;
  }
  f -= a.nk;
  const int base = a.np + 2 * a.n2;
  const Screen l0 = project(P, pts + 3 * (base + f), a);
  const Screen l1 = project(P, pts + 3 * (base + a.nl + f), a);
  const float* q0 = block(a.line_p0, a.stride[8], b) + 2 * f;
  const float* q1 = block(a.line_p1, a.stride[9], b) + 2 * f;
  const float sc = a.scale[3];
  Dual r0 = dconst(LM_BIG), r1 = dconst(LM_BIG);
  if (l0.ok && l1.ok) {
    const Dual dx = l1.u - l0.u, dy = l1.v - l0.v;
    const Dual ss = dx * dx + dy * dy;
    if (!(ss.v < 1e-9f)) {   // pose/residuals._line_point_distances
      const Dual nrm = dsqrt(dclamp_min(ss, 1e-12f));
      const Dual nx = (-dy) / nrm, ny = dx / nrm;
      r0 = (dconst(q0[0]) - l0.u) * nx + (dconst(q0[1]) - l0.v) * ny;
      r1 = (dconst(q1[0]) - l0.u) * nx + (dconst(q1[1]) - l0.v) * ny;
    }
  }
  add_row(acc, r0 * sc);
  add_row(acc, r1 * sc);
}

// Feature q of the listing order: inverse-depth points, lines, planes, then
// points (the dearest first), as an index of add_feature's order.
__device__ __forceinline__ int listed_feature(int q, const LMArgs& a) {
  if (q < a.n2) return a.np + q;
  q -= a.n2;
  if (q < a.nl) return a.np + a.n2 + a.nk + q;
  q -= a.nl;
  if (q < a.nk) return a.np + a.n2 + q;
  return q - a.nk;
}

__device__ __forceinline__ bool feature_live(int f, const LMArgs& a, int b) {
  if (f < a.np) return block(a.point_mask, a.stride[2], b)[f] != 0;
  f -= a.np;
  if (f < a.n2) return block(a.p2d_mask, a.stride[4], b)[f] != 0;
  f -= a.n2;
  if (f < a.nk) return block(a.plane_mask, a.stride[7], b)[f] != 0;
  f -= a.nk;
  return block(a.line_mask, a.stride[10], b)[f] != 0;
}

template <bool ONE_WARP>
__device__ __forceinline__ void block_sync() {
  if (ONE_WARP)
    __syncwarp();
  else
    __syncthreads();
}

// Member b's live features into `live`, in the listing order; returns their
// count (the same on every thread).  A chunk of blockDim features at a time:
// a ballot a warp, then the warps' counts in warp order.
template <bool ONE_WARP>
__device__ int list_live(int* live, int* counts, const LMArgs& a, int b, int lane, int warp) {
  const int n = a.np + a.n2 + a.nk + a.nl;
  const int n_warps = blockDim.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  int total = 0;
  for (int q0 = 0; q0 < n; q0 += blockDim.x) {
    const int q = q0 + threadIdx.x;
    const int f = q < n ? listed_feature(q, a) : 0;
    const bool on = q < n && feature_live(f, a, b);
    const unsigned bits = __ballot_sync(LM_FULL, on);
    int before = total + __popc(bits & below), chunk = __popc(bits);
    if (!ONE_WARP) {
      if (lane == 0) counts[warp] = chunk;
      __syncthreads();
      chunk = 0;
      for (int w = 0; w < n_warps; ++w) {
        if (w < warp) before += counts[w];
        chunk += counts[w];
      }
      __syncthreads();
    }
    if (on) live[before] = f;
    total += chunk;
  }
  block_sync<ONE_WARP>();
  return total;
}

// One step of the transposing reduction: lanes with bit H clear keep terms
// [0, H) of the 2H they hold, the others [H, 2H), each adding its partner's.
template <int H>
__device__ __forceinline__ void trade(float* v, int lane) {
  const bool upper = (lane & H) != 0;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float give = upper ? v[j] : v[j + H];
    const float keep = upper ? v[j + H] : v[j];
    v[j] = keep + __shfl_xor_sync(LM_FULL, give, H);
  }
}

// The 28 terms summed over the warp: lane k < 28 returns term k (lanes 28-31
// the zero padding), in 31 shuffles.
__device__ __forceinline__ float warp_terms(const float* acc, int lane) {
  float v[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) v[k] = k < LM_TERMS ? acc[k] : 0.f;
  trade<16>(v, lane);
  trade<8>(v, lane);
  trade<4>(v, lane);
  trade<2>(v, lane);
  trade<1>(v, lane);
  return v[0];
}

// the index of JtJ entry (i, j), i <= j, in the upper triangle in row order
__device__ __forceinline__ int upper_index(int i, int j) { return i * (11 - i) / 2 + j; }

// s - p * q rounded twice, as tensor code rounds it: never contracted into
// one fused multiply-add
__device__ __forceinline__ float msub(float s, float p, float q) {
  return __fsub_rn(s, __fmul_rn(p, q));
}

// linalg6.solve_spd for one 6x6 system, in its order of operations and with
// its roundings (no fused multiply-add): column j of L from a[j:, j] less the
// earlier columns' products, the pivot sqrt(max(s, 1e-20)), then forward and
// back substitution.  a is the upper triangle of the symmetric matrix
// (a[i][j] = a[j][i] is read for i >= j).  Given the same normal equations and
// damping, the trial is then the plain version's to an ulp.
__device__ __forceinline__ void solve6(const float a[6][6], const float* rhs, float* x) {
  float L[6][6], inv_d[6], y[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s[6];
#pragma unroll
    for (int i = j; i < 6; ++i) s[i] = a[j][i];
#pragma unroll
    for (int k = 0; k < j; ++k)
#pragma unroll
      for (int i = j; i < 6; ++i) s[i] = msub(s[i], L[i][k], L[j][k]);
    const float d = sqrtf(clamp_min(s[j], 1e-20f));
    inv_d[j] = 1.f / d;
    L[j][j] = d;
#pragma unroll
    for (int i = j + 1; i < 6; ++i) L[i][j] = s[i] * inv_d[j];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = rhs[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = msub(s, L[i][k], y[k]);
    y[i] = s * inv_d[i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s = msub(s, L[k][i], x[k]);
    x[i] = s * inv_d[i];
  }
}

// The step of lane k < 6 from the damped system whose row k it holds (`row`,
// its diagonal entry replaced by `diag`) and -Jtr[k] (`rhs`): every lane
// gathers the upper triangle and the right-hand side from lanes 0-5 (27
// shuffles, none on the solve's chain), solves the whole system with solve6,
// and keeps entry k.  Every lane computes the same x.
__device__ __forceinline__ float step_of_lane(const float* row, float diag, float rhs, int row_of,
                                              int lane) {
  float m[6][6], b[6], x[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j) m[i][j] = __shfl_sync(LM_FULL, j == row_of ? diag : row[j], i);
    b[i] = __shfl_sync(LM_FULL, rhs, i);
  }
  solve6(m, b, x);
  float mine = 0.f;
#pragma unroll
  for (int k = 0; k < 6; ++k)
    if (lane == k) mine = x[k];
  return mine;
}

// shared memory of a CTA: the warps' pose slots, their terms (two buffers),
// the listing's counts; the live list is the dynamic part
template <int WARPS>
struct Shared {
  Pose pose[WARPS];
  float terms[2][WARPS][LM_TERMS];
  int counts[WARPS];
};

template <bool ONE_WARP>
__device__ __forceinline__ void lm_member(const LMArgs& a) {
  extern __shared__ int live[];
  __shared__ Shared<ONE_WARP ? 1 : LM_WARPS> sh;
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int n_live = list_live<ONE_WARP>(live, sh.counts, a, b, lane, warp);
  Pose& pose = sh.pose[ONE_WARP ? 0 : warp];

  // the LM state, the same in every warp: lane k < 6 holds coefficient k of
  // the point of this linearization and of the best point, row k of the best
  // point's JtJ and Jtr[k] (lanes 6-31 mirror row 5); every lane the rest
  const int row_of = lane < 6 ? lane : 5;
  float at = lane < 6 ? a.coeffs0[6 * b + lane] : 0.f;
  float best = at, jtr = 0.f, best_cost = 0.f, damping = a.damping0;
  float jtj[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) jtj[j] = 0.f;
  long long accepted = 0;

  for (int it = 0; it <= a.iterations; ++it) {
    float c[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) c[k] = __shfl_sync(LM_FULL, at, k);
    __syncwarp();                  // the warp's reads of the last pose are done
    build_pose(c, lane, pose);
    __syncwarp();                  // the pose is written

    float acc[LM_TERMS];
#pragma unroll
    for (int k = 0; k < LM_TERMS; ++k) acc[k] = 0.f;
    for (int e = threadIdx.x; e < n_live; e += blockDim.x) add_feature(acc, pose, a, b, live[e]);
    float sum = warp_terms(acc, lane);
    if (!ONE_WARP) {               // the warps' terms, folded in warp order
      float(*terms)[LM_TERMS] = sh.terms[it & 1];
      if (lane < LM_TERMS) terms[warp][lane] = sum;
      __syncthreads();
      if (lane < LM_TERMS) {
        sum = terms[0][lane];
        for (int w = 1; w < n_warps; ++w) sum += terms[w][lane];
      }
    }

    // this linearization's row of JtJ, Jtr entry and cost on every lane
    float jtj_t[6];
#pragma unroll
    for (int j = 0; j < 6; ++j)
      jtj_t[j] = __shfl_sync(LM_FULL, sum, j < row_of ? upper_index(j, row_of)
                                                      : upper_index(row_of, j));
    const float jtr_t = __shfl_sync(LM_FULL, sum, 21 + row_of);
    const float cost_t = __shfl_sync(LM_FULL, sum, 27);
    if (a.trace != nullptr && warp == 0) {
      float* out = a.trace + ((long long)b * (a.iterations + 1) + it) * LM_TRACE;
      if (lane < 6) out[lane] = at;
      if (lane < 27) out[7 + lane] = sum;
      else if (lane == 27) out[6] = sum;
    }

    bool take = it == 0;
    if (it > 0) {
      const bool finite = __all_sync(LM_FULL, lane >= 6 || isfinite(at));
      take = cost_t < best_cost && finite;
      if (take && it <= 63) accepted |= 1ll << (it - 1);
      const float stepped = take ? damping * 0.5f : damping * 4.f;
      damping = fminf(fmaxf(stepped, 1e-9f), 1e6f);
    }
    if (take) {
      best = at;
      best_cost = cost_t;
#pragma unroll
      for (int j = 0; j < 6; ++j) jtj[j] = jtj_t[j];
      jtr = jtr_t;
    }
    if (it < a.iterations) {       // the next trial from the best point
      float d0 = 0.f;
#pragma unroll
      for (int j = 0; j < 6; ++j)
        if (j == row_of) d0 = jtj[j];
      const float diag = __fadd_rn(__fadd_rn(d0, __fmul_rn(damping, clamp_min(d0, 1e-8f))),
                                   1e-12f);
      at = best + step_of_lane(jtj, diag, -jtr, row_of, lane);
    }
  }

  if (warp == 0) {
    if (lane < 6) {
      a.coeffs[6 * b + lane] = best;
      if (a.jtr != nullptr) a.jtr[6 * b + lane] = jtr;
      if (a.jtj != nullptr)
#pragma unroll
        for (int j = 0; j < 6; ++j) a.jtj[36 * b + 6 * lane + j] = jtj[j];
    }
    if (lane == 0) {
      a.cost[b] = best_cost;
      if (a.accepts != nullptr) a.accepts[b] = accepted;
    }
  }
}

// a member on 64 to 128 threads
__global__ void __launch_bounds__(LM_MAX_THREADS) lm_solve_kernel(const LMArgs a) {
  lm_member<false>(a);
}

// a member on one warp: no block barrier
__global__ void __launch_bounds__(32) lm_solve_kernel_warp(const LMArgs a) {
  lm_member<true>(a);
}

// One CTA a member, `threads` threads (32: the one-warp kernel), `list_bytes`
// of dynamic shared memory for the live list (4 a feature); lm_cuda.launch_shape
// picks both.
extern "C" int lm_solve_launch(const LMArgs* args, int threads, int list_bytes, void* stream) {
  const int n = args->np + args->n2 + args->nk + args->nl;
  if (args->batch <= 0 || args->iterations < 0 || threads < 32 ||
      threads > LM_MAX_THREADS || threads % 32 != 0 || list_bytes < 4 * n ||
      list_bytes > LM_MAX_LIST_BYTES)
    return (int)cudaErrorInvalidValue;
  if (threads == 32)
    lm_solve_kernel_warp<<<args->batch, 32, list_bytes, (cudaStream_t)stream>>>(*args);
  else
    lm_solve_kernel<<<args->batch, threads, list_bytes, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
