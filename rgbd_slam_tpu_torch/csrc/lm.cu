// The pose optimizer's Levenberg-Marquardt solve for Hopper: one kernel.
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
// Derivatives.  Every quantity that depends on the pose is a `Dual`: a value
// and its six tangents, carried in registers, as `jax.linearize` and
// `torch.func.jvp` carry them.  Where the plain code selects (`torch.where`, a
// clamp), the tangent follows the branch taken and the rule torch applies:
// a constant (BIG_RESIDUAL, the 1e-9 depth floor) has a zero tangent, and a
// clamp passes the tangent where its input is at or past the floor.
//
// What bounds it on Hopper.  By the roofline, operations: the refit batch of
// the main path (101 members, 896 residual rows, 7 linearizations) is at most
// 0.14 GFLOP of f32 (every feature live; a real frame's are ~20 MFLOP) against
// 0.7 MB of inputs, a few microseconds either way (lm_cuda.lm_work counts it).
// In fact the chain: each member is a sequence of linearizations, and each
// waits for the previous one's block reduction and 6x6 solve.  This first
// design is simple and right:
//   * one CTA a member; a thread takes features (not rows) strided by the block
//     size, so a feature's projections are computed once for all its rows;
//   * each thread accumulates the 21 entries of JtJ's upper triangle, the 6 of
//     Jtr and the cost; the block reduction runs in a fixed order (warp
//     shuffles, then one shared-memory slot a warp folded by thread 0 in warp
//     order), with no float atomics, so a launch repeats to the bit;
//   * thread 0 holds the LM state in its registers (the trial, the best point,
//     its normal equations), computes the trial's pose and its tangents into
//     shared memory for the block, applies accept or reject and the damping
//     rule, and solves the damped system with linalg6.solve_spd's pivot floor
//     sqrt(max(s, 1e-20)), in its order of operations and with its roundings;
//   * shared memory holds the pose (written by thread 0 between the barrier
//     that ends a linearization and the one that starts the next, read by every
//     thread after it) and one slot of sums a warp (written by its lane 0,
//     read by thread 0 after the next barrier);
//   * with a trace buffer, thread 0 writes each linearization's point, cost
//     and normal equations, so that a check can replay the run step by step.
// A first version kept the trial in shared memory and copied the best point
// from it; on the card the best point then followed rejected trials.  The cause
// was not found; the state now stays in thread 0's registers.
// No tensor cores, TMA or clusters; nothing is differentiated through the
// solve, so there is no backward.

#include <cuda_runtime.h>
#include <stdint.h>

#define LM_MAX_THREADS 256
#define LM_WARPS (LM_MAX_THREADS / 32)
// the 21 entries of JtJ's upper triangle, the 6 of Jtr and the cost
#define LM_TERMS 28
#define LM_BIG 1.0e4f
// a trace row, one a linearization: where it was taken (6), its cost, JtJ's
// upper triangle (21) and Jtr (6)
#define LM_TRACE 34

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

struct Dual {
  float v;
  float d[6];
};

__device__ __forceinline__ Dual dconst(float v) {
  Dual r;
  r.v = v;
#pragma unroll
  for (int k = 0; k < 6; ++k) r.d[k] = 0.f;
  return r;
}

// coefficient k as an input: value c, unit tangent along k
__device__ __forceinline__ Dual dvar(float c, int k) {
  Dual r = dconst(c);
  r.d[k] = 1.f;
  return r;
}

__device__ __forceinline__ Dual operator+(const Dual& a, const Dual& b) {
  Dual r;
  r.v = a.v + b.v;
#pragma unroll
  for (int k = 0; k < 6; ++k) r.d[k] = a.d[k] + b.d[k];
  return r;
}

__device__ __forceinline__ Dual operator+(const Dual& a, float b) {
  Dual r = a;
  r.v = a.v + b;
  return r;
}

__device__ __forceinline__ Dual operator-(const Dual& a, const Dual& b) {
  Dual r;
  r.v = a.v - b.v;
#pragma unroll
  for (int k = 0; k < 6; ++k) r.d[k] = a.d[k] - b.d[k];
  return r;
}

__device__ __forceinline__ Dual operator-(float a, const Dual& b) {
  Dual r;
  r.v = a - b.v;
#pragma unroll
  for (int k = 0; k < 6; ++k) r.d[k] = -b.d[k];
  return r;
}

__device__ __forceinline__ Dual operator-(const Dual& a) {
  Dual r;
  r.v = -a.v;
#pragma unroll
  for (int k = 0; k < 6; ++k) r.d[k] = -a.d[k];
  return r;
}

__device__ __forceinline__ Dual operator*(const Dual& a, const Dual& b) {
  Dual r;
  r.v = a.v * b.v;
#pragma unroll
  for (int k = 0; k < 6; ++k) r.d[k] = a.d[k] * b.v + b.d[k] * a.v;
  return r;
}

__device__ __forceinline__ Dual operator*(const Dual& a, float b) {
  Dual r;
  r.v = a.v * b;
#pragma unroll
  for (int k = 0; k < 6; ++k) r.d[k] = a.d[k] * b;
  return r;
}

__device__ __forceinline__ Dual operator*(float a, const Dual& b) { return b * a; }

__device__ __forceinline__ Dual operator/(const Dual& a, const Dual& b) {
  Dual r;
  r.v = a.v / b.v;
#pragma unroll
  for (int k = 0; k < 6; ++k) r.d[k] = (a.d[k] - r.v * b.d[k]) / b.v;
  return r;
}

__device__ __forceinline__ Dual dsqrt(const Dual& a) {
  Dual r;
  r.v = sqrtf(a.v);
#pragma unroll
  for (int k = 0; k < 6; ++k) r.d[k] = a.d[k] / (2.f * r.v);
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
struct Pose {
  Dual r[3][3];
  Dual t[3];
  Dual last[3];
};

// se3.coefficients_to_pose, quat_to_matrix and world_to_camera: camera_to_world
// is AXIS_CORRECTION @ [R | p] (rows R2, -R0, -R1; translation p2, -p0, -p1),
// and its inverse is [Rc^T | -Rc^T tc].
__device__ void pose_of(const float* c, Pose& P) {
  const Dual p0 = dvar(c[0], 0), p1 = dvar(c[1], 1), p2 = dvar(c[2], 2);
  const Dual s0 = dvar(c[3], 3), s1 = dvar(c[4], 4), s2 = dvar(c[5], 5);
  const Dual alpha = s0 * s0 + s1 * s1 + s2 * s2;
  const Dual divider = dconst(1.f) / (alpha + 1.f);
  const Dual w = (2.f * s0) * divider, x = (2.f * s1) * divider, y = (2.f * s2) * divider;
  const Dual z = (1.f - alpha) * divider;
  const Dual xx = x * x, yy = y * y, zz = z * z;
  const Dual wx = w * x, wy = w * y, wz = w * z;
  const Dual xy = x * y, xz = x * z, yz = y * z;
  Dual R[3][3];
  R[0][0] = 1.f - 2.f * (yy + zz);
  R[0][1] = 2.f * (xy - wz);
  R[0][2] = 2.f * (xz + wy);
  R[1][0] = 2.f * (xy + wz);
  R[1][1] = 1.f - 2.f * (xx + zz);
  R[1][2] = 2.f * (yz - wx);
  R[2][0] = 2.f * (xz - wy);
  R[2][1] = 2.f * (yz + wx);
  R[2][2] = 1.f - 2.f * (xx + yy);
  const Dual tc[3] = {p2, -p0, -p1};
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

// The rows of feature f (points, then 2D points, planes, lines) of member b at
// pose P, added to acc.
__device__ void add_feature(float* acc, const Pose& P, const LMArgs& a, int b, int f) {
  const float* pts = block(a.pts, a.stride[0], b);
  if (f < a.np) {
    if (!block(a.point_mask, a.stride[2], b)[f]) return;
    const Screen s = project(P, pts + 3 * f, a);
    const float* obs = block(a.point_obs, a.stride[1], b) + 2 * f;
    const float sc = a.scale[0];
    add_row(acc, (s.ok ? dconst(obs[0]) - s.u : dconst(LM_BIG)) * sc);
    add_row(acc, (s.ok ? dconst(obs[1]) - s.v : dconst(LM_BIG)) * sc);
    return;
  }
  f -= a.np;
  if (f < a.n2) {
    if (!block(a.p2d_mask, a.stride[4], b)[f]) return;
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
    if (!block(a.plane_mask, a.stride[7], b)[f]) return;
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
  if (!block(a.line_mask, a.stride[10], b)[f]) return;
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
// damping, the trial is then the plain version's to the bit.
__device__ void solve6(const float a[6][6], const float* rhs, float* x) {
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

__global__ void __launch_bounds__(LM_MAX_THREADS) lm_solve_kernel(const LMArgs a) {
  __shared__ Pose pose;
  __shared__ float partial[LM_WARPS][LM_TERMS];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_features = a.np + a.n2 + a.nk + a.nl;

  // thread 0's LM state, in its registers: where this linearization is taken,
  // the best point, its cost and normal equations, the damping
  float at[6], best[6], jtj[21], jtr[6];
  float best_cost = 0.f, damping = a.damping0;
  long long accepted = 0;
#pragma unroll
  for (int k = 0; k < 6; ++k) at[k] = best[k] = tid == 0 ? a.coeffs0[6 * b + k] : 0.f;
#pragma unroll
  for (int k = 0; k < 21; ++k) jtj[k] = 0.f;
#pragma unroll
  for (int k = 0; k < 6; ++k) jtr[k] = 0.f;

  for (int it = 0; it <= a.iterations; ++it) {
    if (tid == 0) pose_of(at, pose);
    __syncthreads();

    float acc[LM_TERMS];
#pragma unroll
    for (int k = 0; k < LM_TERMS; ++k) acc[k] = 0.f;
    for (int f = tid; f < n_features; f += blockDim.x) add_feature(acc, pose, a, b, f);
    // fixed-order block sum: shuffles within a warp, then the warps in order
#pragma unroll
    for (int k = 0; k < LM_TERMS; ++k) {
      float v = acc[k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) partial[warp][k] = v;
    }
    __syncthreads();

    if (tid == 0) {
      float sum[LM_TERMS];
#pragma unroll
      for (int k = 0; k < LM_TERMS; ++k) {
        float v = partial[0][k];
        for (int w = 1; w < (int)(blockDim.x >> 5); ++w) v += partial[w][k];
        sum[k] = v;
      }
      const float cost_t = sum[27];
      if (a.trace != nullptr) {
        float* row = a.trace + ((long long)b * (a.iterations + 1) + it) * LM_TRACE;
#pragma unroll
        for (int k = 0; k < 6; ++k) row[k] = at[k];
        row[6] = cost_t;
#pragma unroll
        for (int k = 0; k < 27; ++k) row[7 + k] = sum[k];
      }
      bool take = it == 0;
      if (it > 0) {
        bool finite = true;
#pragma unroll
        for (int k = 0; k < 6; ++k) finite = finite && isfinite(at[k]);
        take = cost_t < best_cost && finite;
        if (take && it <= 63) accepted |= 1ll << (it - 1);
        const float stepped = take ? damping * 0.5f : damping * 4.f;
        damping = fminf(fmaxf(stepped, 1e-9f), 1e6f);
      }
      if (take) {
#pragma unroll
        for (int k = 0; k < 6; ++k) best[k] = at[k];
        best_cost = cost_t;
#pragma unroll
        for (int k = 0; k < 21; ++k) jtj[k] = sum[k];
#pragma unroll
        for (int k = 0; k < 6; ++k) jtr[k] = sum[21 + k];
      }
      if (it < a.iterations) {   // the next trial from the best point
        float m[6][6], rhs[6], delta[6];
        int k = 0;
#pragma unroll
        for (int i = 0; i < 6; ++i)
#pragma unroll
          for (int j = i; j < 6; ++j) m[i][j] = jtj[k++];
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          m[i][i] = __fadd_rn(__fadd_rn(m[i][i], __fmul_rn(damping, clamp_min(m[i][i], 1e-8f))),
                             1e-12f);
          rhs[i] = -jtr[i];
        }
        solve6(m, rhs, delta);
#pragma unroll
        for (int i = 0; i < 6; ++i) at[i] = best[i] + delta[i];
      }
    }
    __syncthreads();
  }

  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < 6; ++k) a.coeffs[6 * b + k] = best[k];
    a.cost[b] = best_cost;
    if (a.jtj != nullptr) {
      int k = 0;
      for (int i = 0; i < 6; ++i)
        for (int j = i; j < 6; ++j) {
          a.jtj[36 * b + 6 * i + j] = jtj[k];
          a.jtj[36 * b + 6 * j + i] = jtj[k];
          ++k;
        }
    }
    if (a.jtr != nullptr)
      for (int k = 0; k < 6; ++k) a.jtr[6 * b + k] = jtr[k];
    if (a.accepts != nullptr) a.accepts[b] = accepted;
  }
}

// Threads a CTA: the features rounded up to whole warps, at most LM_MAX_THREADS.
static int lm_threads(const LMArgs* a) {
  const int n = a->np + a->n2 + a->nk + a->nl;
  const int t = ((n + 31) / 32) * 32;
  return t < 32 ? 32 : (t > LM_MAX_THREADS ? LM_MAX_THREADS : t);
}

extern "C" int lm_solve_launch(const LMArgs* args, void* stream) {
  if (args->batch <= 0 || args->iterations < 0)
    return (int)cudaErrorInvalidValue;
  lm_solve_kernel<<<args->batch, lm_threads(args), 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
