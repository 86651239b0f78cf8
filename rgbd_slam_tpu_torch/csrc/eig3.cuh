// The closed-form symmetric 3x3 eigen-solver of rgbd_slam_tpu/geometry/eig3.py
// (the port's geometry/eig3.py), for the kernels of the plane extraction
// (csrc/cells.cu, csrc/cylinders.cu).  It runs operation for operation as the
// plain tensor code does, so that a kernel built with -fmad=false rounds each
// step as the plain version's separate ops round.

#pragma once

#include <math.h>

// argmax of three with torch's rules: the first NaN, else the first maximum
__device__ __forceinline__ int argmax3(float v0, float v1, float v2) {
  int best = 0;
  float bv = v0;
  if ((isnan(v1) && !isnan(bv)) || v1 > bv) { best = 1; bv = v1; }
  if ((isnan(v2) && !isnan(bv)) || v2 > bv) { best = 2; }
  return best;
}

// The closed-form eig3 of geometry/eig3.py on a symmetric matrix given by its
// six entries: the eigenvalues ascending and the unit eigenvector of the
// smallest, operation for operation as sym_eig3 and eigenvector_for.
__device__ void sym_eig3_smallest(float a00, float a11, float a22, float a01, float a02,
                                  float a12, float* vals, float* vec) {
  // the zero matrix (every entry +0: an empty cell or region) takes the
  // isotropic branch below to eigenvalues +0 and the fallback vector (0, 0,
  // 1); those bits directly, without the divisions by the 1e-30 floors
  if ((__float_as_uint(a00) | __float_as_uint(a11) | __float_as_uint(a22)
       | __float_as_uint(a01) | __float_as_uint(a02) | __float_as_uint(a12)) == 0u) {
    vals[0] = vals[1] = vals[2] = 0.0f;
    vec[0] = 0.0f;
    vec[1] = 0.0f;
    vec[2] = 1.0f;
    return;
  }
  const float p1 = (a01 * a01 + a02 * a02) + a12 * a12;
  const float q = ((a00 + a11) + a22) / 3.0f;
  const float d0 = a00 - q, d1 = a11 - q, d2 = a22 - q;
  const float p2 = ((d0 * d0 + d1 * d1) + d2 * d2) + 2.0f * p1;
  const float p = sqrtf(fmaxf(p2 / 6.0f, 1e-30f));
  const float b00 = d0 / p, b11 = d1 / p, b22 = d2 / p;
  const float b01 = a01 / p, b02 = a02 / p, b12 = a12 / p;
  const float detb = (b00 * (b11 * b22 - b12 * b12) - b01 * (b01 * b22 - b12 * b02))
                     + b02 * (b01 * b12 - b11 * b02);
  const float r = fminf(fmaxf(detb / 2.0f, -1.0f), 1.0f);
  const float phi = acosf(r) / 3.0f;
  float e_hi = q + (2.0f * p) * cosf(phi);
  float e_lo = q + (2.0f * p) * cosf(phi + 2.0943951023931953f);
  float e_mid = (3.0f * q - e_hi) - e_lo;
  if (p2 < 1e-20f) e_lo = e_mid = e_hi = q;   // isotropic
  vals[0] = e_lo;
  vals[1] = e_mid;
  vals[2] = e_hi;

  // eigenvector_for(a, e_lo) on the norm-scaled matrix
  float scale = fabsf(a00);
  scale = fmaxf(scale, fabsf(a01));
  scale = fmaxf(scale, fabsf(a02));
  scale = fmaxf(scale, fabsf(a11));
  scale = fmaxf(scale, fabsf(a12));
  scale = fmaxf(scale, fabsf(a22));
  scale = fmaxf(scale, 1e-30f);
  const float lam = e_lo / scale;
  const float off = lam * 0.0f;   // lam * eye off the diagonal, as the plain version
  const float m00 = a00 / scale - lam, m11 = a11 / scale - lam, m22 = a22 / scale - lam;
  const float m01 = a01 / scale - off, m02 = a02 / scale - off, m12 = a12 / scale - off;
  // rows r0 = (m00, m01, m02), r1 = (m01, m11, m12), r2 = (m02, m12, m22)
  float c[3][3];
  // cross(r0, r1)
  c[0][0] = m01 * m12 - m02 * m11;
  c[0][1] = m02 * m01 - m00 * m12;
  c[0][2] = m00 * m11 - m01 * m01;
  // cross(r0, r2)
  c[1][0] = m01 * m22 - m02 * m12;
  c[1][1] = m02 * m02 - m00 * m22;
  c[1][2] = m00 * m12 - m01 * m02;
  // cross(r1, r2)
  c[2][0] = m11 * m22 - m12 * m12;
  c[2][1] = m12 * m02 - m01 * m22;
  c[2][2] = m01 * m12 - m11 * m02;
  const float n0 = (c[0][0] * c[0][0] + c[0][1] * c[0][1]) + c[0][2] * c[0][2];
  const float n1 = (c[1][0] * c[1][0] + c[1][1] * c[1][1]) + c[1][2] * c[1][2];
  const float n2 = (c[2][0] * c[2][0] + c[2][1] * c[2][1]) + c[2][2] * c[2][2];
  // the chosen row by selects: an index into c would put it in local memory
  const int best = argmax3(n0, n1, n2);
  const float v0 = best == 0 ? c[0][0] : (best == 1 ? c[1][0] : c[2][0]);
  const float v1 = best == 0 ? c[0][1] : (best == 1 ? c[1][1] : c[2][1]);
  const float v2 = best == 0 ? c[0][2] : (best == 1 ? c[1][2] : c[2][2]);
  const float norm = sqrtf((v0 * v0 + v1 * v1) + v2 * v2);
  if (norm > 1e-12f) {
    const float s = fmaxf(norm, 1e-12f);
    vec[0] = v0 / s;
    vec[1] = v1 / s;
    vec[2] = v2 / s;
  } else {
    vec[0] = 0.0f;
    vec[1] = 0.0f;
    vec[2] = 1.0f;
  }
}

