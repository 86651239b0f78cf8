// Pyramidal Lucas-Kanade for Hopper: three kernels that share one per-level sweep.
//
// Replaces the Pallas kernels of rgbd_slam_tpu/ops/pallas_lk.py:
//   * lk_fwd_bwd_kernel: lk_fwd_bwd_pallas (pallas_call at :454, body
//     _lk_fwd_bwd_kernel / _track_direction / _sample_slab), fused forward and
//     backward pyramidal LK with the round-trip gate;
//   * lk_pyramid_kernel: lk_pyramid_pallas (pallas_call at :498, body
//     _lk_pyramid_kernel :186), forward-only pyramidal LK, flow and status;
//   * lk_level_kernel: lk_level_pallas (pallas_call at :542, body _lk_kernel :27),
//     one level from per-point guesses with an explicit window.
// Same semantics, point for point:
//   * at a level, a bilinear (win+2)^2 template patch of the source image gives
//     the template and central-difference gradients, and their 2x2 structure
//     tensor; det <= 1e-6 (or an invalid point) skips the level's iterations;
//   * up to `iterations` Gauss-Newton steps resample the moving window of the
//     destination image; the step that falls under eps is still applied, then
//     the point stops;
//   * pyramids run top -> 0, the guess doubles between levels, only level 0 sets
//     the status;
//   * the fused backward pass starts zero-seeded at `bwd_top`, from the forward
//     result; ok = fwd_ok & bwd_ok & |fwd + bwd|^2 <= max_roundtrip^2.
// Per-level windows come from the caller (the fused kernel's min(win, l - 8)
// list, with the coarse window from coarse_from_level, for both pyramid
// kernels).  The top-left clamps to [2, l - win - 3]; the sample index clamps to
// l - (w + 1), with the fraction taken from the unclamped floor.
//
// What bounds it on Hopper: the latency of the sequential Gauss-Newton chain
// (<= levels x iterations steps per direction, each a resample plus one block
// reduction), not bytes or FLOPs: the pyramids (~3.3 MB in f32 at 640x480) stay in
// L2, and a 53x53 window is 2.8k bilinear samples.  Design: one CTA per point (128
// CTAs fill one wave of 132 SMs), 256 threads share the window's samples, the
// halo template patch sits in shared memory, and each reduction is warp shuffles
// plus one shared-memory pass that every thread sums in the same order, so all
// threads take the same early exit.  A converged point stops at once; the Pallas
// kernels' lockstep masking freezes a converged point's step, which gives the
// same result.  The Mosaic slab/roll sampler and the level padding of the TPU
// kernels have no counterpart here: a thread reads its four taps directly.

#include <cuda_runtime.h>
#include <stdint.h>

#define LK_MAX_LEVELS 8
#define LK_THREADS 256
#define LK_WARPS (LK_THREADS / 32)

struct LKLevel {
  const float* prev;
  const float* next;
  int h, w;    // level rows, cols
  int wh, ww;  // window rows, cols
};

struct LKParams {
  LKLevel lv[LK_MAX_LEVELS];
  int top;          // forward pass starts here (the pyramid's top level)
  int bwd_top;      // backward pass starts here
  int iterations;
  float eps_sq;
  float max_roundtrip_sq;
};

// Integer top-left and fractions of a bilinear window whose float top-left is
// (x, y): _sample_slab's clamp of the index, with the fraction taken from the
// unclamped floor.
struct Window {
  int xi, yi;
  float fx, fy;
};

__device__ __forceinline__ Window window_at(float x, float y, int h, int w,
                                            int lh, int lw) {
  Window s;
  float x0 = floorf(x);
  float y0 = floorf(y);
  s.fx = x - x0;
  s.fy = y - y0;
  // the clamp to +-1e9 keeps the float->int conversion defined; it moves no
  // finite index, which is clamped into the image right after
  int xi = (int)fminf(fmaxf(x0, -1e9f), 1e9f);
  int yi = (int)fminf(fmaxf(y0, -1e9f), 1e9f);
  s.xi = min(max(xi, 0), lw - (w + 1));
  s.yi = min(max(yi, 0), lh - (h + 1));
  return s;
}

__device__ __forceinline__ float sample(const float* img, int lw, const Window& s,
                                        int r, int c) {
  const float* p = img + (size_t)(s.yi + r) * lw + (s.xi + c);
  return (1.f - s.fy) * ((1.f - s.fx) * p[0] + s.fx * p[1])
       + s.fy * ((1.f - s.fx) * p[lw] + s.fx * p[lw + 1]);
}

// Sums over the block; every thread returns the same totals.
__device__ __forceinline__ void block_sum(float* v, int n, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int k = 0; k < n; ++k) {
    float x = v[k];
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    if (lane == 0) red[k * LK_WARPS + warp] = x;
  }
  __syncthreads();
  for (int k = 0; k < n; ++k) {
    float s = 0.f;
    for (int wi = 0; wi < LK_WARPS; ++wi) s += red[k * LK_WARPS + wi];
    v[k] = s;
  }
  __syncthreads();
}

// One level of LK for one point, shared by all three kernels: template patch of
// `src` at top-left (tlx, tly), then up to `iterations` Gauss-Newton steps on
// `dst` from the guess (gx, gy), which is updated in place.  Returns whether the
// level's structure tensor is usable (det > 1e-6) for a valid point.
__device__ bool level_sweep(const float* src, const float* dst, int lh, int lw, int wh,
                            int ww, float tlx, float tly, bool valid, int iterations,
                            float eps_sq, float* tp, float* red, float& gx, float& gy) {
  const int th = wh + 2, tw = ww + 2;
  const Window ts = window_at(tlx - 1.f, tly - 1.f, th, tw, lh, lw);
  for (int k = threadIdx.x; k < th * tw; k += LK_THREADS)
    tp[k] = sample(src, lw, ts, k / tw, k % tw);
  __syncthreads();

  float g[3] = {0.f, 0.f, 0.f};
  for (int k = threadIdx.x; k < wh * ww; k += LK_THREADS) {
    const int r = k / ww, c = k % ww;
    const float ix = 0.5f * (tp[(r + 1) * tw + c + 2] - tp[(r + 1) * tw + c]);
    const float iy = 0.5f * (tp[(r + 2) * tw + c + 1] - tp[r * tw + c + 1]);
    g[0] += ix * ix;
    g[1] += ix * iy;
    g[2] += iy * iy;
  }
  block_sum(g, 3, red);
  const float gxx = g[0], gxy = g[1], gyy = g[2];
  const float det = gxx * gyy - gxy * gxy;
  const bool lvl_ok = (det > 1e-6f) && valid;
  const float inv_det = lvl_ok ? 1.f / det : 0.f;

  bool done = !lvl_ok;
  for (int it = 0; it < iterations && !done; ++it) {
    const Window js = window_at(tlx + gx, tly + gy, wh, ww, lh, lw);
    float b[2] = {0.f, 0.f};
    for (int k = threadIdx.x; k < wh * ww; k += LK_THREADS) {
      const int r = k / ww, c = k % ww;
      const float t = tp[(r + 1) * tw + c + 1];
      const float ix = 0.5f * (tp[(r + 1) * tw + c + 2] - tp[(r + 1) * tw + c]);
      const float iy = 0.5f * (tp[(r + 2) * tw + c + 1] - tp[r * tw + c + 1]);
      const float diff = t - sample(dst, lw, js, r, c);
      b[0] += ix * diff;
      b[1] += iy * diff;
    }
    block_sum(b, 2, red);
    const float dx = (gyy * b[0] - gxy * b[1]) * inv_det;
    const float dy = (gxx * b[1] - gxy * b[0]) * inv_det;
    gx += dx;
    gy += dy;
    done = dx * dx + dy * dy < eps_sq;
  }
  __syncthreads();  // tp is rewritten by the next sweep
  return lvl_ok;
}

// Coarse-to-fine LK of one point from `top` down to level 0 (src -> dst images).
__device__ void track_direction(const LKParams& p, bool forward, float px, float py,
                                bool valid, int top, float* tp, float* red,
                                float* out_gx, float* out_gy, bool* out_ok) {
  float gx = 0.f, gy = 0.f;
  bool ok = valid;
  for (int lvl = top; lvl >= 0; --lvl) {
    const LKLevel L = p.lv[lvl];
    const float scale = ldexpf(1.f, -lvl);
    const float tlx = fminf(fmaxf(px * scale - (L.ww - 1) / 2.0f, 2.0f),
                            (float)(L.w - L.ww - 3));
    const float tly = fminf(fmaxf(py * scale - (L.wh - 1) / 2.0f, 2.0f),
                            (float)(L.h - L.wh - 3));
    const bool lvl_ok = level_sweep(forward ? L.prev : L.next, forward ? L.next : L.prev,
                                    L.h, L.w, L.wh, L.ww, tlx, tly, valid, p.iterations,
                                    p.eps_sq, tp, red, gx, gy);
    if (lvl == 0) ok = ok && lvl_ok;  // only the finest level sets status
    if (lvl > 0) {
      gx *= 2.f;
      gy *= 2.f;
    }
  }
  *out_gx = gx;
  *out_gy = gy;
  *out_ok = ok;
}

__global__ void __launch_bounds__(LK_THREADS)
lk_fwd_bwd_kernel(LKParams p, const float* __restrict__ points,
                  const uint8_t* __restrict__ valid, float* __restrict__ out_points,
                  uint8_t* __restrict__ out_ok) {
  extern __shared__ float tp[];
  __shared__ float red[3 * LK_WARPS];
  const int i = blockIdx.x;
  const float px = points[2 * i];
  const float py = points[2 * i + 1];

  float fgx, fgy, bgx, bgy;
  bool fok, bok;
  track_direction(p, true, px, py, valid[i] != 0, p.top, tp, red, &fgx, &fgy, &fok);
  const float fx = px + fgx;
  const float fy = py + fgy;
  track_direction(p, false, fx, fy, fok, p.bwd_top, tp, red, &bgx, &bgy, &bok);

  if (threadIdx.x == 0) {
    const float rx = fgx + bgx, ry = fgy + bgy;
    out_points[2 * i] = fx;
    out_points[2 * i + 1] = fy;
    out_ok[i] = (fok && bok && (rx * rx + ry * ry <= p.max_roundtrip_sq)) ? 1 : 0;
  }
}

__global__ void __launch_bounds__(LK_THREADS)
lk_pyramid_kernel(LKParams p, const float* __restrict__ points,
                  const uint8_t* __restrict__ valid, float* __restrict__ out_flow,
                  uint8_t* __restrict__ out_ok) {
  extern __shared__ float tp[];
  __shared__ float red[3 * LK_WARPS];
  const int i = blockIdx.x;
  float gx, gy;
  bool ok;
  track_direction(p, true, points[2 * i], points[2 * i + 1], valid[i] != 0, p.top, tp,
                  red, &gx, &gy, &ok);
  if (threadIdx.x == 0) {
    out_flow[2 * i] = gx;
    out_flow[2 * i + 1] = gy;
    out_ok[i] = ok ? 1 : 0;
  }
}

__global__ void __launch_bounds__(LK_THREADS)
lk_level_kernel(LKLevel L, int iterations, float eps_sq, const float* __restrict__ points,
                const float* __restrict__ guesses, const uint8_t* __restrict__ valid,
                float* __restrict__ out_guesses, uint8_t* __restrict__ out_ok) {
  extern __shared__ float tp[];
  __shared__ float red[3 * LK_WARPS];
  const int i = blockIdx.x;
  const float tlx = fminf(fmaxf(points[2 * i] - (L.ww - 1) / 2.0f, 2.0f),
                          (float)(L.w - L.ww - 3));
  const float tly = fminf(fmaxf(points[2 * i + 1] - (L.wh - 1) / 2.0f, 2.0f),
                          (float)(L.h - L.wh - 3));
  float gx = guesses[2 * i], gy = guesses[2 * i + 1];
  const bool ok = level_sweep(L.prev, L.next, L.h, L.w, L.wh, L.ww, tlx, tly,
                              valid[i] != 0, iterations, eps_sq, tp, red, gx, gy);
  if (threadIdx.x == 0) {
    out_guesses[2 * i] = gx;
    out_guesses[2 * i + 1] = gy;
    out_ok[i] = ok ? 1 : 0;
  }
}

// Dynamic shared memory for a (wh+2) x (ww+2) template patch; raises the
// kernel's limit when it is over the 48 KB default.
template <typename Kernel>
static cudaError_t patch_smem(Kernel kernel, int max_patch, size_t* smem) {
  *smem = (size_t)max_patch * sizeof(float);
  if (*smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)*smem);
  return cudaSuccess;
}

// Fills `p` from `levels`+1 device pointers per pyramid and 4 ints per level
// (rows, cols, window rows, window cols); returns the largest template patch.
static int fill_levels(LKParams* p, const void* const* prev, const void* const* next,
                       const int* dims, int levels) {
  int max_patch = 0;
  for (int l = 0; l <= levels; ++l) {
    p->lv[l].prev = (const float*)prev[l];
    p->lv[l].next = (const float*)next[l];
    p->lv[l].h = dims[4 * l];
    p->lv[l].w = dims[4 * l + 1];
    p->lv[l].wh = dims[4 * l + 2];
    p->lv[l].ww = dims[4 * l + 3];
    const int patch = (p->lv[l].wh + 2) * (p->lv[l].ww + 2);
    if (patch > max_patch) max_patch = patch;
  }
  p->top = levels;
  return max_patch;
}

// Plain C interface (bound with ctypes).  Each launches on `stream` and returns
// cudaGetLastError() (or the error that kept it from launching).

extern "C" int lk_fwd_bwd_launch(const void* const* prev, const void* const* next,
                                 const int* dims, int levels, int bwd_top,
                                 int iterations, float eps_sq, float max_roundtrip_sq,
                                 const void* points, const void* valid,
                                 void* out_points, void* out_ok, int n, void* stream) {
  if (levels < 0 || levels >= LK_MAX_LEVELS || bwd_top < 0 || bwd_top > levels)
    return (int)cudaErrorInvalidValue;
  LKParams p;
  const int max_patch = fill_levels(&p, prev, next, dims, levels);
  p.bwd_top = bwd_top;
  p.iterations = iterations;
  p.eps_sq = eps_sq;
  p.max_roundtrip_sq = max_roundtrip_sq;
  if (n <= 0) return (int)cudaSuccess;
  size_t smem;
  cudaError_t e = patch_smem(lk_fwd_bwd_kernel, max_patch, &smem);
  if (e != cudaSuccess) return (int)e;
  lk_fwd_bwd_kernel<<<n, LK_THREADS, smem, (cudaStream_t)stream>>>(
      p, (const float*)points, (const uint8_t*)valid, (float*)out_points,
      (uint8_t*)out_ok);
  return (int)cudaGetLastError();
}

extern "C" int lk_pyramid_launch(const void* const* prev, const void* const* next,
                                 const int* dims, int levels, int iterations,
                                 float eps_sq, const void* points, const void* valid,
                                 void* out_flow, void* out_ok, int n, void* stream) {
  if (levels < 0 || levels >= LK_MAX_LEVELS) return (int)cudaErrorInvalidValue;
  LKParams p;
  const int max_patch = fill_levels(&p, prev, next, dims, levels);
  p.bwd_top = 0;
  p.iterations = iterations;
  p.eps_sq = eps_sq;
  p.max_roundtrip_sq = 0.f;
  if (n <= 0) return (int)cudaSuccess;
  size_t smem;
  cudaError_t e = patch_smem(lk_pyramid_kernel, max_patch, &smem);
  if (e != cudaSuccess) return (int)e;
  lk_pyramid_kernel<<<n, LK_THREADS, smem, (cudaStream_t)stream>>>(
      p, (const float*)points, (const uint8_t*)valid, (float*)out_flow,
      (uint8_t*)out_ok);
  return (int)cudaGetLastError();
}

extern "C" int lk_level_launch(const void* prev, const void* next, int h, int w, int wh,
                               int ww, int iterations, float eps_sq, const void* points,
                               const void* guesses, const void* valid,
                               void* out_guesses, void* out_ok, int n, void* stream) {
  LKLevel L;
  L.prev = (const float*)prev;
  L.next = (const float*)next;
  L.h = h;
  L.w = w;
  L.wh = wh;
  L.ww = ww;
  if (n <= 0) return (int)cudaSuccess;
  size_t smem;
  cudaError_t e = patch_smem(lk_level_kernel, (wh + 2) * (ww + 2), &smem);
  if (e != cudaSuccess) return (int)e;
  lk_level_kernel<<<n, LK_THREADS, smem, (cudaStream_t)stream>>>(
      L, iterations, eps_sq, (const float*)points, (const float*)guesses,
      (const uint8_t*)valid, (float*)out_guesses, (uint8_t*)out_ok);
  return (int)cudaGetLastError();
}
