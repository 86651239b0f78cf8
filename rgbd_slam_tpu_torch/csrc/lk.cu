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
// What bounds it on Hopper.  By the roofline, operations: ~0.1 GFLOP of f32
// blends a launch against 3.3 MB of pyramids that L2 holds, one or two
// microseconds either way.  In fact, two other things.  A point is a sequential
// chain (per pass, levels x up to `iterations` Gauss-Newton steps, each a
// resample of its window plus one block-wide sum, and step k+1 needs step k's
// sum), so a point cannot use more than one SM, and the rate at which that SM
// dispatches instructions sets the pace.  And every point re-reads its windows
// from L2: 128 CTAs that fetch a template and a window each at the same moment
// saturate L2, at about 2 TB/s.  The design goes after both:
//   * one CTA per point (128 CTAs: one wave of 132 SMs).  Its warps are split:
//     LK_SUM_WARPS sweep the window, LK_COPY_WARPS only copy;
//   * the destination window plus a margin of LK_MARGIN pixels on every side is
//     staged in shared memory with cp.async, and the iterations sample from
//     there: no Gauss-Newton step goes to L2.  A step that leaves the staged
//     tile restages it around the new position; sampling from the tile is
//     arithmetically the same as sampling from the image;
//   * the template's position depends only on the point, so while the sweeping
//     warps iterate on a level the copying warps bring the next level's
//     template region and destination tile (around twice the current guess)
//     into a second pair of buffers: the L2 traffic runs beside the arithmetic
//     instead of before it.  Regions are widened to 16-byte columns and copied
//     16 bytes at a time where the level's rows are aligned (4 bytes at a time
//     where not);
//   * a sweeping thread owns one column strip of the window (LK_STRIP rows) for
//     the whole level and keeps the strip's template values and gradients in
//     registers, computed once from the staged raw region.  Going down the
//     strip it shares each row blend between the two pixels that use it.  The
//     strip loops have no branch (the last band is moved up to end with the
//     window and masks the rows it shares), so the loads of a whole strip are in
//     flight together; nothing divides inside the iteration loop;
//   * a block sum costs one barrier of the sweeping warps: warp shuffles, one
//     shared-memory slot per warp in one of two buffers used in turn, then every
//     thread folds the slots in the same order, so all threads hold bit-equal
//     sums and take the same early exit.  No atomics: results are equal from
//     run to run.
// Tensor cores are not used: the work is two-tap blends and two short dot
// products per pixel, there is no matrix product in it (the matmul sampler of
// the Pallas kernel, _sample_slab_mm, was a Mosaic device that is off on every
// path).  TMA is not used either: a window starts at any pixel, the copies are
// no longer what the sweep waits for, and cp.async serves unaligned levels with
// the same code.  What the kernel takes from Hopper is its large shared memory,
// its asynchronous copies and named barriers.
//
// A level whose two buffer pairs do not fit a CTA's shared memory (a window of
// 120 x 160 at level 0 of a 1920 x 1080 frame needs 362 KB) is swept in
// place: its template and tile are the level's images themselves, read through
// L1 and L2, and nothing of it is staged.  The host marks each level (`staged`,
// level_caps); the levels that fit keep the staged sweep.  Sampling from the
// image is what sampling from a tile is, so both give the same bits.
//
// One build variant (compile-time, off in the normal build): -DLK_PHASE_PROFILE.
// Thread 0 of the first CTAs then writes clock64() and the global timer at the
// phase borders of the sweep into a buffer given through lk_profile_attach().

#include <cuda_runtime.h>
#include <stdint.h>

#define LK_MAX_LEVELS 8
#define LK_THREADS 288    // threads of a CTA
#define LK_COPY_WARPS 2   // the CTA's last warps only stage the next level
#define LK_WARPS (LK_THREADS / 32)
#define LK_SUM_WARPS (LK_WARPS - LK_COPY_WARPS)  // warps that sweep the window
#define LK_SUM_THREADS (32 * LK_SUM_WARPS)
#define LK_MARGIN 8  // pixels of the destination staged around the window
// window rows of the column strip a thread keeps in registers (more would spill)
#define LK_STRIP 14
// dynamic shared memory a CTA may hold on Hopper (227 KB), less the static arrays
#define LK_SMEM_BUDGET (232448 - 1024)

struct LKLevel {
  const float* prev;
  const float* next;
  int h, w;     // level rows, cols
  int wh, ww;   // window rows, cols
  int aligned;  // both images' rows start on 16-byte borders
  int staged;   // its inputs are staged in shared memory; else swept in place
};

struct LKParams {
  LKLevel lv[LK_MAX_LEVELS];
  int top;          // forward pass starts here (the pyramid's top level)
  int bwd_top;      // backward pass starts here
  int iterations;
  float eps_sq;
  float max_roundtrip_sq;
  int tmpl_cap, tile_cap;  // floats of one template / one tile buffer
};

// What a CTA's sweeps share: the dynamic shared memory, the reduction slots
// (two buffers of 3 x LK_SUM_WARPS, used in turn), the slots through which the
// sweeping warps hand a level's result to the copying warps, and the
// phase-profile cursor.
struct Scratch {
  float* buf;
  float* red;
  float* pub;  // two slots of (gx, gy, level ok), used in turn
  int turn, pub_turn;
  int tmpl_cap, tile_cap;
  int marks;
};

// Phase marks: tag = 10000 * pass (0 forward, 1 backward) + 1000 * level
// + 100 * phase + iteration.  Phases: 1 inputs staged, 2 structure tensor
// summed, 4 iteration summed and applied, 5 tile restaged, 9 pass done.
#ifdef LK_PHASE_PROFILE
__device__ long long* lk_prof_buf;
__device__ int lk_prof_ctas;
__device__ int lk_prof_cap;

__device__ __forceinline__ void lk_mark(Scratch& sc, int tag) {
  if (threadIdx.x == 0 && (int)blockIdx.x < lk_prof_ctas && sc.marks < lk_prof_cap) {
    long long* rec = lk_prof_buf + ((size_t)blockIdx.x * lk_prof_cap + sc.marks) * 3;
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    rec[0] = tag;
    rec[1] = clock64();
    rec[2] = (long long)ns;
    ++sc.marks;
  }
}
#define LK_MARK(sc, tag) lk_mark(sc, tag)
#else
#define LK_MARK(sc, tag)
#endif

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

// Bilinear blend of the 2x2 taps at p (row stride `stride`).
__device__ __forceinline__ float blend(const float* p, int stride, float fx, float fy) {
  return (1.f - fy) * ((1.f - fx) * p[0] + fx * p[1])
       + fy * ((1.f - fx) * p[stride] + fx * p[stride + 1]);
}

// Window top-left of a point at level scale: clamp to [2, l - win - 3].
__device__ __forceinline__ void top_left(const LKLevel& L, float x, float y, float& tlx,
                                         float& tly) {
  tlx = fminf(fmaxf(x - (L.ww - 1) / 2.0f, 2.0f), (float)(L.w - L.ww - 3));
  tly = fminf(fmaxf(y - (L.wh - 1) / 2.0f, 2.0f), (float)(L.h - L.wh - 3));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s),
               "l"(__cvta_generic_to_global(gmem))
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(__cvta_generic_to_global(gmem))
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// A part of a level held in shared memory, row-major with row stride w.
struct Region {
  int x0, y0, w, h;
};

// The region that holds columns [x0, x0 + w) and rows [y0, y0 + h) of level L.
// Where the level's rows are 16-byte aligned, it is widened to whole 16-byte
// columns, so that it can be copied 16 bytes at a time.
__device__ __forceinline__ Region region_of(const LKLevel& L, int x0, int y0, int w,
                                            int h) {
  Region g;
  g.y0 = y0;
  g.h = h;
  g.x0 = L.aligned ? (x0 & ~3) : x0;
  g.w = L.aligned ? (((x0 + w + 3) & ~3) - g.x0) : w;
  return g;
}

// Starts the copy of region g of a level into `out`, shared between
// `workers` threads of which this one is number `worker`.
__device__ __forceinline__ void stage_region(float* out, const float* img, const LKLevel& L,
                                             const Region& g, int worker, int workers) {
  const float* src = img + (size_t)g.y0 * L.w + g.x0;
  const int unit = L.aligned ? 4 : 1;  // floats a copy
  const int per_row = g.w / unit;
  const int total = g.h * per_row;
  int r = worker / per_row, c = worker - r * per_row;
  const int dr = workers / per_row, dc = workers - dr * per_row;
  for (int k = worker; k < total; k += workers) {
    float* to = out + r * g.w + unit * c;
    const float* from = src + (size_t)r * L.w + unit * c;
    if (L.aligned)
      cp_async16(to, from);
    else
      cp_async4(to, from);
    c += dc;
    r += dr;
    if (c >= per_row) {
      c -= per_row;
      ++r;
    }
  }
}

// The staged part of the destination level around the window js: the window
// and LK_MARGIN pixels on every side, cut to the level.
__device__ __forceinline__ Region tile_around(const Window& js, const LKLevel& L) {
  if (!L.staged) return Region{0, 0, L.w, L.h};   // the whole level, in place
  const int w = min(L.ww + 1 + 2 * LK_MARGIN, L.w);
  const int h = min(L.wh + 1 + 2 * LK_MARGIN, L.h);
  return region_of(L, min(max(js.xi - LK_MARGIN, 0), L.w - w),
                   min(max(js.yi - LK_MARGIN, 0), L.h - h), w, h);
}

__device__ __forceinline__ bool tile_holds(const Region& t, const Window& js,
                                           const LKLevel& L) {
  return js.xi >= t.x0 && js.xi + L.ww + 1 <= t.x0 + t.w && js.yi >= t.y0 &&
         js.yi + L.wh + 1 <= t.y0 + t.h;
}

// The raw (wh+3) x (ww+3) region under the template patch at (tlx, tly).
__device__ __forceinline__ Region template_region(const LKLevel& L, float tlx, float tly) {
  if (!L.staged) return Region{0, 0, L.w, L.h};   // the whole level, in place
  const Window ts = window_at(tlx - 1.f, tly - 1.f, L.wh + 2, L.ww + 2, L.h, L.w);
  return region_of(L, ts.xi, ts.yi, L.ww + 3, L.wh + 3);
}

__device__ __forceinline__ float* tmpl_slot(const Scratch& sc, int slot) {
  return sc.buf + slot * sc.tmpl_cap;
}
__device__ __forceinline__ float* tile_slot(const Scratch& sc, int slot) {
  return sc.buf + 2 * sc.tmpl_cap + slot * sc.tile_cap;
}

// Starts the copies a level needs into buffer pair `slot`: the region under
// the template patch of `src`, and the tile of `dst` around the guess.
__device__ __forceinline__ void stage_level(const float* src, const float* dst,
                                            const LKLevel& L, float tlx, float tly,
                                            const Region& tile, const Scratch& sc, int slot,
                                            int worker, int workers) {
  if (!L.staged) return;
  stage_region(tmpl_slot(sc, slot), src, L, template_region(L, tlx, tly), worker, workers);
  stage_region(tile_slot(sc, slot), dst, L, tile, worker, workers);
  cp_async_commit();
}

__device__ __forceinline__ bool is_copy_thread() { return threadIdx.x >= LK_SUM_THREADS; }

// Barrier of the sweeping warps only (the copying warps are elsewhere).
__device__ __forceinline__ void sum_barrier() {
  asm volatile("bar.sync 1, %0;" ::"n"(LK_SUM_THREADS) : "memory");
}

// Sums over the sweeping warps with one barrier: warp shuffles, one slot per
// warp in one of two buffers used in turn, then every thread folds the slots in
// the same order, so all threads return the same totals, bit for bit.
template <int N>
__device__ __forceinline__ void block_sum(float* v, Scratch& sc) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* red = sc.red + sc.turn * 3 * LK_SUM_WARPS;
  sc.turn ^= 1;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float x = v[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    if (lane == 0) red[k * LK_SUM_WARPS + warp] = x;
  }
  sum_barrier();
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < LK_SUM_WARPS; ++wi) s += red[k * LK_SUM_WARPS + wi];
    v[k] = s;
  }
}

// Template value and central-difference gradients of window pixel (r, c) from
// the staged raw region: p points at raw (r, c).  Patch (i, j) is the blend of
// raw (i..i+1, j..j+1); the pixel is patch (r+1, c+1).
__device__ __forceinline__ void template_pixel(const float* p, int stride, float fx,
                                               float fy, float& t, float& ix, float& iy) {
  t = blend(p + stride + 1, stride, fx, fy);
  ix = 0.5f * (blend(p + stride + 2, stride, fx, fy) - blend(p + stride, stride, fx, fy));
  iy = 0.5f * (blend(p + 2 * stride + 1, stride, fx, fy) - blend(p + 1, stride, fx, fy));
}

// One level of LK for one point, shared by all three kernels and run by the
// sweeping warps.  The level's inputs are staged (stage_level, waited for and
// made visible by the caller):
// `tmpl` holds the region under the template, `tile_buf` the destination tile
// `tile`; a level swept in place reads `src` and `dst` themselves.  Runs up to
// `iterations` Gauss-Newton steps on `dst` from the guess (gx, gy), which is
// updated in place.  Returns whether the level's structure
// tensor is usable (det > 1e-6) for a valid point.
//
// A thread owns one column strip of the window, LK_STRIP rows of one column,
// for the whole level: thread s has column s % ww of band s / ww.  Going down
// its column it blends each row pair once and shares the row blend between
// the two pixels that use it; the loops over the strip have no branch, so the
// loads of all rows are in flight together.  Its neighbours in the warp hold
// the next columns, so shared-memory reads do not conflict.  Rows that the
// threads cannot hold as strips (a window of more than LK_SUM_THREADS strips, or
// of fewer than LK_STRIP rows) are the tail: its pixels are recomputed from
// shared memory in every iteration.
__device__ bool level_sweep(const float* src, const float* dst, const LKLevel& L, int tag,
                            float tlx, float tly, bool valid, int iterations, float eps_sq,
                            const float* tmpl, float* tile_buf, Region tile, Scratch& sc,
                            float& gx, float& gy) {
  const int ww = L.ww, wh = L.wh, n = wh * ww;
  if (!L.staged) tmpl = src;
  const float* tile_src = L.staged ? tile_buf : dst;
  const Window tw = window_at(tlx - 1.f, tly - 1.f, wh + 2, ww + 2, L.h, L.w);
  const Region tr = template_region(L, tlx, tly);
  const int ts = tr.w;
  const float* traw = tmpl + (tw.yi - tr.y0) * ts + (tw.xi - tr.x0);  // raw (0, 0)

  // bands of LK_STRIP rows; the last one is moved up to end with the window, and
  // the rows it then shares with the band above are masked out of its sums
  const int bands = wh >= LK_STRIP ? (wh + LK_STRIP - 1) / LK_STRIP : 0;
  const int held = min(bands, LK_SUM_THREADS / ww);  // bands the threads can hold
  const int band = threadIdx.x / ww, c = threadIdx.x - band * ww;
  const bool active = band < held;
  const int r0 = min(band * LK_STRIP, wh - LK_STRIP);
  const int first = band * LK_STRIP - r0;  // the strip's first row that is its own
  const int tail = held * LK_STRIP < wh ? held * LK_STRIP * ww : n;  // first tail pixel

  float t[LK_STRIP], ix[LK_STRIP], iy[LK_STRIP];
  float g[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int r = 0; r < LK_STRIP; ++r) t[r] = ix[r] = iy[r] = 0.f;
  if (active) {
    // raw rows r0 .. r0 + LK_STRIP + 2, columns c .. c + 3: h0..h2 are the row
    // blends of one raw row, p1 the patch's middle column
    const float ax = 1.f - tw.fx, ay = 1.f - tw.fy;
    const float* p = traw + r0 * ts + c;
    float p1[LK_STRIP + 2];
    float a0 = 0.f, a1 = 0.f, a2 = 0.f;
#pragma unroll
    for (int i = 0; i < LK_STRIP + 3; ++i) {
      const float* q = p + i * ts;
      const float h0 = ax * q[0] + tw.fx * q[1];
      const float h1 = ax * q[1] + tw.fx * q[2];
      const float h2 = ax * q[2] + tw.fx * q[3];
      if (i >= 1) p1[i - 1] = ay * a1 + tw.fy * h1;
      if (i >= 2 && i - 2 < LK_STRIP) {
        t[i - 2] = p1[i - 1];
        ix[i - 2] = 0.5f * ((ay * a2 + tw.fy * h2) - (ay * a0 + tw.fy * h0));
      }
      a0 = h0;
      a1 = h1;
      a2 = h2;
    }
#pragma unroll
    for (int r = 0; r < LK_STRIP; ++r) {
      const bool own = r >= first;
      ix[r] = own ? ix[r] : 0.f;
      iy[r] = own ? 0.5f * (p1[r + 2] - p1[r]) : 0.f;
      g[0] += ix[r] * ix[r];
      g[1] += ix[r] * iy[r];
      g[2] += iy[r] * iy[r];
    }
  }
  for (int k = tail + threadIdx.x; k < n; k += LK_SUM_THREADS) {
    const int r = k / ww;
    float t_, ix_, iy_;
    template_pixel(traw + r * ts + (k - r * ww), ts, tw.fx, tw.fy, t_, ix_, iy_);
    g[0] += ix_ * ix_;
    g[1] += ix_ * iy_;
    g[2] += iy_ * iy_;
  }
  block_sum<3>(g, sc);
  LK_MARK(sc, tag + 200);
  const float gxx = g[0], gxy = g[1], gyy = g[2];
  const float det = gxx * gyy - gxy * gxy;
  const bool lvl_ok = (det > 1e-6f) && valid;
  const float inv_det = lvl_ok ? 1.f / det : 0.f;

  bool done = !lvl_ok;
  for (int it = 0; it < iterations && !done; ++it) {
    const Window js = window_at(tlx + gx, tly + gy, wh, ww, L.h, L.w);
    if (!tile_holds(tile, js, L)) {
      // every sweeping thread is past the last sum's barrier, so no one still
      // reads the tile
      tile = tile_around(js, L);
      stage_region(tile_buf, dst, L, tile, threadIdx.x, LK_SUM_THREADS);
      cp_async_commit();
      cp_async_wait<0>();
      sum_barrier();
      LK_MARK(sc, tag + 500 + it);
    }
    const float* base = tile_src + (js.yi - tile.y0) * tile.w + (js.xi - tile.x0);
    float b[2] = {0.f, 0.f};
    if (active) {
      const float ax = 1.f - js.fx, ay = 1.f - js.fy;
      const float* q = base + r0 * tile.w + c;
      float above = ax * q[0] + js.fx * q[1];
#pragma unroll
      for (int r = 0; r < LK_STRIP; ++r) {
        q += tile.w;
        const float below = ax * q[0] + js.fx * q[1];
        const float diff = t[r] - (ay * above + js.fy * below);
        b[0] += ix[r] * diff;  // a row of the band above has ix = iy = 0
        b[1] += iy[r] * diff;
        above = below;
      }
    }
    for (int k = tail + threadIdx.x; k < n; k += LK_SUM_THREADS) {
      const int r = k / ww, cc = k - r * ww;
      float t_, ix_, iy_;
      template_pixel(traw + r * ts + cc, ts, tw.fx, tw.fy, t_, ix_, iy_);
      const float diff = t_ - blend(base + r * tile.w + cc, tile.w, js.fx, js.fy);
      b[0] += ix_ * diff;
      b[1] += iy_ * diff;
    }
    block_sum<2>(b, sc);
    const float dx = (gyy * b[0] - gxy * b[1]) * inv_det;
    const float dy = (gxx * b[1] - gxy * b[0]) * inv_det;
    gx += dx;
    gy += dy;
    done = dx * dx + dy * dy < eps_sq;
    LK_MARK(sc, tag + 400 + it);
  }
  return lvl_ok;
}

// A level's result, handed from the sweeping warps to every thread of the CTA
// through shared memory: thread 0 writes before the CTA's barrier, all read
// after it.  Two slots used in turn: a slot is rewritten two barriers later.
__device__ __forceinline__ void publish(Scratch& sc, float gx, float gy, bool ok) {
  float* pub = sc.pub + 4 * sc.pub_turn;
  if (threadIdx.x == 0) {
    pub[0] = gx;
    pub[1] = gy;
    pub[2] = ok ? 1.f : 0.f;
  }
}
__device__ __forceinline__ void collect(Scratch& sc, float& gx, float& gy, bool& ok) {
  const float* pub = sc.pub + 4 * sc.pub_turn;
  sc.pub_turn ^= 1;
  gx = pub[0];
  gy = pub[1];
  ok = pub[2] != 0.f;
}

// Coarse-to-fine LK of one point from `top` down to level 0 (src -> dst images).
// While the sweeping warps iterate on a level, the copying warps bring the next
// level's inputs into the other buffer pair; its tile is placed around twice the
// guess this level started with.  Every thread of the CTA runs this function and
// returns the same result.
__device__ void track_direction(const LKParams& p, bool forward, float px, float py,
                                bool valid, int top, Scratch& sc, float* out_gx,
                                float* out_gy, bool* out_ok) {
  const int pass = forward ? 0 : 10000;
  const bool copies = is_copy_thread();
  const int worker = threadIdx.x - LK_SUM_THREADS, workers = 32 * LK_COPY_WARPS;
  float gx = 0.f, gy = 0.f;
  bool ok = valid;
  int slot = 0;
  float tlx, tly;
  top_left(p.lv[top], px * ldexpf(1.f, -top), py * ldexpf(1.f, -top), tlx, tly);
  Region tile = tile_around(
      window_at(tlx, tly, p.lv[top].wh, p.lv[top].ww, p.lv[top].h, p.lv[top].w), p.lv[top]);
  if (copies) {
    stage_level(forward ? p.lv[top].prev : p.lv[top].next,
                forward ? p.lv[top].next : p.lv[top].prev, p.lv[top], tlx, tly, tile, sc, 0,
                worker, workers);
    cp_async_wait<0>();
  }
  __syncthreads();
  for (int lvl = top; lvl >= 0; --lvl) {
    const LKLevel& L = p.lv[lvl];
    LK_MARK(sc, pass + 1000 * lvl + 100);
    float ntlx = 0.f, ntly = 0.f;
    Region ntile = tile;
    if (lvl > 0) {
      const LKLevel& M = p.lv[lvl - 1];
      const float scale = ldexpf(1.f, -(lvl - 1));
      top_left(M, px * scale, py * scale, ntlx, ntly);
      ntile = tile_around(window_at(ntlx + 2.f * gx, ntly + 2.f * gy, M.wh, M.ww, M.h, M.w), M);
      if (copies) {
        stage_level(forward ? M.prev : M.next, forward ? M.next : M.prev, M, ntlx, ntly,
                    ntile, sc, slot ^ 1, worker, workers);
        cp_async_wait<0>();
      }
    }
    if (!copies) {
      const bool lvl_ok = level_sweep(forward ? L.prev : L.next, forward ? L.next : L.prev, L,
                                      pass + 1000 * lvl, tlx, tly, valid, p.iterations,
                                      p.eps_sq, tmpl_slot(sc, slot), tile_slot(sc, slot), tile,
                                      sc, gx, gy);
      publish(sc, gx, gy, lvl_ok);
    }
    __syncthreads();  // the level's result is out, the next level's inputs are in
    bool lvl_ok;
    collect(sc, gx, gy, lvl_ok);
    if (lvl == 0) ok = ok && lvl_ok;  // only the finest level sets status
    if (lvl > 0) {
      gx *= 2.f;
      gy *= 2.f;
    }
    slot ^= 1;
    tlx = ntlx;
    tly = ntly;
    tile = ntile;
  }
  LK_MARK(sc, pass + 900);
  *out_gx = gx;
  *out_gy = gy;
  *out_ok = ok;
}

// One level from a given guess (the single-level kernel).  Returns, in every
// thread, the new guess and the level's status.
__device__ bool track_level(const LKLevel& L, float tlx, float tly, bool valid,
                            int iterations, float eps_sq, Scratch& sc, float& gx,
                            float& gy) {
  const Region tile = tile_around(window_at(tlx + gx, tly + gy, L.wh, L.ww, L.h, L.w), L);
  if (is_copy_thread()) {
    stage_level(L.prev, L.next, L, tlx, tly, tile, sc, 0, threadIdx.x - LK_SUM_THREADS,
                32 * LK_COPY_WARPS);
    cp_async_wait<0>();
  }
  __syncthreads();
  LK_MARK(sc, 100);
  if (!is_copy_thread()) {
    const bool lvl_ok = level_sweep(L.prev, L.next, L, 0, tlx, tly, valid, iterations, eps_sq,
                                    tmpl_slot(sc, 0), tile_slot(sc, 0), tile, sc, gx, gy);
    publish(sc, gx, gy, lvl_ok);
  }
  __syncthreads();
  bool ok;
  collect(sc, gx, gy, ok);
  LK_MARK(sc, 900);
  return ok;
}

__device__ __forceinline__ Scratch make_scratch(float* buf, float* red, float* pub,
                                                int tmpl_cap, int tile_cap) {
  Scratch sc;
  sc.buf = buf;
  sc.red = red;
  sc.pub = pub;
  sc.turn = 0;
  sc.pub_turn = 0;
  sc.tmpl_cap = tmpl_cap;
  sc.tile_cap = tile_cap;
  sc.marks = 0;
  return sc;
}

__global__ void __launch_bounds__(LK_THREADS)
lk_fwd_bwd_kernel(LKParams p, const float* __restrict__ points,
                  const uint8_t* __restrict__ valid, float* __restrict__ out_points,
                  uint8_t* __restrict__ out_ok) {
  extern __shared__ __align__(16) float buf[];
  __shared__ float red[2 * 3 * LK_WARPS];
  __shared__ float pub[2 * 4];
  Scratch sc = make_scratch(buf, red, pub, p.tmpl_cap, p.tile_cap);
  LK_MARK(sc, 0);
  const int i = blockIdx.x;
  const float px = points[2 * i];
  const float py = points[2 * i + 1];

  float fgx, fgy, bgx, bgy;
  bool fok, bok;
  track_direction(p, true, px, py, valid[i] != 0, p.top, sc, &fgx, &fgy, &fok);
  const float fx = px + fgx;
  const float fy = py + fgy;
  track_direction(p, false, fx, fy, fok, p.bwd_top, sc, &bgx, &bgy, &bok);

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
  extern __shared__ __align__(16) float buf[];
  __shared__ float red[2 * 3 * LK_WARPS];
  __shared__ float pub[2 * 4];
  Scratch sc = make_scratch(buf, red, pub, p.tmpl_cap, p.tile_cap);
  LK_MARK(sc, 0);
  const int i = blockIdx.x;
  float gx, gy;
  bool ok;
  track_direction(p, true, points[2 * i], points[2 * i + 1], valid[i] != 0, p.top, sc,
                  &gx, &gy, &ok);
  if (threadIdx.x == 0) {
    out_flow[2 * i] = gx;
    out_flow[2 * i + 1] = gy;
    out_ok[i] = ok ? 1 : 0;
  }
}

__global__ void __launch_bounds__(LK_THREADS)
lk_level_kernel(LKLevel L, int iterations, float eps_sq, int tmpl_cap, int tile_cap,
                const float* __restrict__ points, const float* __restrict__ guesses,
                const uint8_t* __restrict__ valid, float* __restrict__ out_guesses,
                uint8_t* __restrict__ out_ok) {
  extern __shared__ __align__(16) float buf[];
  __shared__ float red[2 * 3 * LK_WARPS];
  __shared__ float pub[2 * 4];
  Scratch sc = make_scratch(buf, red, pub, tmpl_cap, tile_cap);
  LK_MARK(sc, 0);
  const int i = blockIdx.x;
  float tlx, tly;
  top_left(L, points[2 * i], points[2 * i + 1], tlx, tly);
  float gx = guesses[2 * i], gy = guesses[2 * i + 1];
  const bool ok = track_level(L, tlx, tly, valid[i] != 0, iterations, eps_sq, sc, gx, gy);
  if (threadIdx.x == 0) {
    out_guesses[2 * i] = gx;
    out_guesses[2 * i + 1] = gy;
    out_ok[i] = ok ? 1 : 0;
  }
}

// Sets a level's alignment flag and whether it is staged, and folds the buffer
// sizes of a staged level's windows into the running maxima; the sizes allow
// for the widening to 16-byte columns.  A level is staged where the two buffer
// pairs, at the maxima with it, fit LK_SMEM_BUDGET; else it is swept in place.
static void level_caps(LKLevel* L, int* tmpl_cap, int* tile_cap) {
  L->aligned = (((uintptr_t)L->prev | (uintptr_t)L->next) % 16 == 0 && L->w % 4 == 0) ? 1 : 0;
  const int tmpl = (L->wh + 3) * ((L->ww + 3 + 6) & ~3);
  const int tile_w = L->ww + 1 + 2 * LK_MARGIN < L->w ? L->ww + 1 + 2 * LK_MARGIN : L->w;
  const int tile_h = L->wh + 1 + 2 * LK_MARGIN < L->h ? L->wh + 1 + 2 * LK_MARGIN : L->h;
  const int tile = tile_h * ((tile_w + 6) & ~3);
  const int tmpl_max = tmpl > *tmpl_cap ? tmpl : *tmpl_cap;
  const int tile_max = tile > *tile_cap ? tile : *tile_cap;
  L->staged = 2 * ((size_t)tmpl_max + (size_t)tile_max) * sizeof(float) <= LK_SMEM_BUDGET;
  if (L->staged) {
    *tmpl_cap = tmpl_max;
    *tile_cap = tile_max;
  }
}

// Dynamic shared memory of a launch, two template regions and two tiles; raises
// the kernel's limit when it is over the 48 KB default.
template <typename Kernel>
static cudaError_t sweep_smem(Kernel kernel, int tmpl_cap, int tile_cap, size_t* smem) {
  *smem = 2 * ((size_t)tmpl_cap + (size_t)tile_cap) * sizeof(float);
  if (*smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)*smem);
  return cudaSuccess;
}

// Fills `p` from `levels`+1 device pointers per pyramid and 4 ints per level
// (rows, cols, window rows, window cols).
static void fill_levels(LKParams* p, const void* const* prev, const void* const* next,
                        const int* dims, int levels) {
  p->tmpl_cap = 0;
  p->tile_cap = 0;
  for (int l = 0; l <= levels; ++l) {
    p->lv[l].prev = (const float*)prev[l];
    p->lv[l].next = (const float*)next[l];
    p->lv[l].h = dims[4 * l];
    p->lv[l].w = dims[4 * l + 1];
    p->lv[l].wh = dims[4 * l + 2];
    p->lv[l].ww = dims[4 * l + 3];
    level_caps(&p->lv[l], &p->tmpl_cap, &p->tile_cap);
  }
  p->top = levels;
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
  fill_levels(&p, prev, next, dims, levels);
  p.bwd_top = bwd_top;
  p.iterations = iterations;
  p.eps_sq = eps_sq;
  p.max_roundtrip_sq = max_roundtrip_sq;
  if (n <= 0) return (int)cudaSuccess;
  size_t smem;
  cudaError_t e = sweep_smem(lk_fwd_bwd_kernel, p.tmpl_cap, p.tile_cap, &smem);
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
  fill_levels(&p, prev, next, dims, levels);
  p.bwd_top = 0;
  p.iterations = iterations;
  p.eps_sq = eps_sq;
  p.max_roundtrip_sq = 0.f;
  if (n <= 0) return (int)cudaSuccess;
  size_t smem;
  cudaError_t e = sweep_smem(lk_pyramid_kernel, p.tmpl_cap, p.tile_cap, &smem);
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
  int tmpl_cap = 0, tile_cap = 0;
  level_caps(&L, &tmpl_cap, &tile_cap);
  size_t smem;
  cudaError_t e = sweep_smem(lk_level_kernel, tmpl_cap, tile_cap, &smem);
  if (e != cudaSuccess) return (int)e;
  lk_level_kernel<<<n, LK_THREADS, smem, (cudaStream_t)stream>>>(
      L, iterations, eps_sq, tmpl_cap, tile_cap, (const float*)points,
      (const float*)guesses, (const uint8_t*)valid, (float*)out_guesses, (uint8_t*)out_ok);
  return (int)cudaGetLastError();
}

#ifdef LK_PHASE_PROFILE
// Points the phase marks of the first `ctas` CTAs at `buf`: ctas x cap records
// of three int64 (tag, clock64, global timer in ns).  The caller zeroes it.
extern "C" int lk_profile_attach(void* buf, int ctas, int cap) {
  long long* b = (long long*)buf;
  cudaError_t e = cudaMemcpyToSymbol(lk_prof_buf, &b, sizeof(b));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(lk_prof_ctas, &ctas, sizeof(ctas));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(lk_prof_cap, &cap, sizeof(cap));
  return (int)e;
}
#endif
