// The line detector's seeds, grown over the directed 8-neighbour tile graph,
// for Hopper.
//
// Not a port of a Pallas kernel: the device form of the JAX package's seed
// loop, `seed_step` over the `lax.while_loop` of `_propagate`
// (rgbd_slam_tpu/features/lines.py:153-170), which the port had replaced by a
// dense reach closure (11 float32 squarings of the [T, T] adjacency) and a
// 16-round loop of tensor code.  Each of the 16 seeds in turn takes the
// heaviest available line tile (the first on equal weights, as `argmax`
// does) and proceeds if its weight is over 0; it grows along the in-edges
// (`edges[s, y, x]`: tile (y, x) may join from (y, x) - SHIFTS[s]) through
// available tiles to the fixpoint; its members are the grown set's available
// tiles; it consumes them all if they are at least `min_tiles`, else itself
// alone.  A seed that does not proceed writes an empty row, and so does every
// seed after it (nothing is consumed, so none can proceed).  The plain
// PyTorch version is `grow_seeds_reference` in
// rgbd_slam_tpu_torch/ops/line_grow_cuda.py (the closure rows, or the loop
// `_propagate` for min_tiles > 2); the outputs are equal for any min_tiles.
// Inputs as `_line_edge_maps` gives them: an edge only between two line
// tiles, none across the grid's border, a weight over 0 on every line tile.
//
// What bounds it on Hopper.  Not bytes: at 640x480 the tile grid is 40 x 30 =
// 1,200 tiles, ~15 KB in (eight edge planes, is_line, weights) and 19.2 KB
// out, ~0.01 us at 3.35 TB/s.  It is a chain of latencies: at most 16
// searches one after the other, each over rounds that each wait on the one
// before.  A search one tile a round takes as many rounds as its longest
// path (8-14 a seed on the striped wall, whose stripe edges run down the
// image), so this design cuts the rounds and what a round and a seed wait on:
//   * one CTA; every thread packs the planes into bit rows in shared memory
//     (word k of row y holds tiles (y, 32k) .. (y, 32k + 31)) from 16-byte
//     loads, then one warp runs the 16 seeds with its rows in registers (lane
//     l holds rows l, l + 32, ..., `LG_MAX_CHUNKS` of them, and their
//     words), and every thread writes the member rows out at the end in
//     16-byte stores;
//   * a round takes the four diagonal in-edges one step (the rows above and
//     below by shuffles), then carries the set along each row, right and
//     left at once: a carry-propagate add over the row's words (generate: a
//     tile beside an active one across its edge; propagate: the edge),
//     `__brev` turning the leftward carry into a rightward one; then down and
//     up each column, 32 columns a word at once: a Kogge-Stone scan over the
//     lanes of the maps X -> active | (edge & X), every word's and both
//     directions' scans interleaved, chunks of 32 rows carried one to the
//     next.  A path's run along a row or a column joins in one round, so the
//     rounds follow its turns, not its length (2 a seed on the striped wall),
//     and they end on `__any_sync`: no host read and no CTA barrier, so the
//     kernel can be recorded in a CUDA graph with the rest of the step;
//   * a seed is the largest key (weight bits above the inverted tile index)
//     over the available tiles: each lane keeps its rows' largest, which stays
//     right until its tile is consumed, then a butterfly of shuffles.
// Grids of up to LG_MAX_WORDS x 32 columns and LG_MAX_CHUNKS x 32 rows of
// tiles (128 x 96: 2048 x 1536 px at 16 px tiles, 1920 x 1080's 120 x 67
// among them); the wrapper raises on any other.

#include <cuda_runtime.h>
#include <stdint.h>

#define LG_THREADS 256
#define LG_SEEDS 16
#define LG_MAX_WORDS 4
#define LG_MAX_CHUNKS 3
#define FULL_MASK 0xffffffffu
// the bit planes in shared memory, each gh x ceil(gw / 32) words: the eight
// edge planes in the order of SHIFTS, is_line, then a member plane a seed
// LG_SHIFTS (0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (1, -1), (-1, 1), (-1, -1)
#define LG_LINE 8
#define LG_MEMBERS 9
#define LG_PLANES (LG_MEMBERS + LG_SEEDS)
// the seeds' proceed flags and rounds (an int each), then a 64-bit key a
// tile, then the planes
#define LG_HEAD_BYTES (8 * LG_SEEDS)
#define LG_KEY_BYTES 8
// shared memory a CTA may hold on Hopper (227 KB)
#define LG_MAX_SMEM 232448

typedef unsigned long long u64;

// ORs the set bytes of `src` (n bytes: planes of t tiles each, row by row,
// from plane `plane0`) into the bit planes, 16 bytes a thread at a time.
__device__ void lg_pack(const uint8_t* __restrict__ src, int n, int plane0, uint32_t* planes,
                        int t, int gw, int w, int r) {
  const int n16 = n >> 4;
  for (int j = threadIdx.x; j < n16; j += blockDim.x) {
    const uint4 v = reinterpret_cast<const uint4*>(src)[j];
    if ((v.x | v.y | v.z | v.w) == 0u) continue;
    const uint32_t quad[4] = {v.x, v.y, v.z, v.w};
    const int f = j << 4;
    int p = f / t;
    int y = (f - p * t) / gw;
    int x = f - p * t - y * gw;
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      if ((quad[b >> 2] >> (8 * (b & 3))) & 0xffu)
        atomicOr(planes + (plane0 + p) * r + y * w + (x >> 5), 1u << (x & 31));
      if (++x == gw) {
        x = 0;
        if ((++y) * gw == t) {
          y = 0;
          ++p;
        }
      }
    }
  }
  for (int f = (n16 << 4) + threadIdx.x; f < n; f += blockDim.x) {
    if (!src[f]) continue;
    const int p = f / t, y = (f - p * t) / gw, x = f - p * t - y * gw;
    atomicOr(planes + (plane0 + p) * r + y * w + (x >> 5), 1u << (x & 31));
  }
}

// The scans of (g, p) over the warp's lanes for every word at once, down
// (lane l composes lanes 0 .. l) or up (lanes l .. 31): each lane ends with
// g_l | p_l & (g_{l-1} | p_{l-1} & (...)), the maps X -> g | p & X composed
// from the chunk's first row (its last, up).
template <int N>
__device__ __forceinline__ void lg_scan(uint32_t (&gd)[N], uint32_t (&pd)[N], uint32_t (&gu)[N],
                                        uint32_t (&pu)[N], int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    uint32_t gd2[N], pd2[N], gu2[N], pu2[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      gd2[i] = __shfl_up_sync(FULL_MASK, gd[i], d);
      pd2[i] = __shfl_up_sync(FULL_MASK, pd[i], d);
      gu2[i] = __shfl_down_sync(FULL_MASK, gu[i], d);
      pu2[i] = __shfl_down_sync(FULL_MASK, pu[i], d);
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (lane >= d) {
        gd[i] |= pd[i] & gd2[i];
        pd[i] &= pd2[i];
      }
      if (lane + d < 32) {
        gu[i] |= pu[i] & gu2[i];
        pu[i] &= pu2[i];
      }
    }
  }
}

// The largest key over a lane's available tiles (0 if none) and where it is:
// (chunk * W + word) * 32 + bit.
template <int C, int W>
__device__ __forceinline__ u64 lg_lane_best(const uint32_t (&avail)[C][W], const u64* keys,
                                            int gw, int lane, int& at) {
  u64 best = 0;
  at = -1;
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int k = 0; k < W; ++k) {
      uint32_t bits = avail[c][k];
      const int base = (32 * c + lane) * gw + 32 * k;
      while (bits) {
        const int b = __ffs(bits) - 1;
        bits &= bits - 1;
        const u64 key = keys[base + b];
        if (key > best) {
          best = key;
          at = (c * W + k) * 32 + b;
        }
      }
    }
  return best;
}

// The 16 seeds, run by one warp on a grid of C chunks of 32 rows and W words
// a row.
template <int C, int W>
__device__ void lg_seeds(uint32_t* planes, const u64* keys, int gh, int gw, int min_tiles,
                         int* seed_proceeds, int* seed_rounds) {
  const int lane = threadIdx.x;
  const int r = gh * W;
  // each lane's rows' edge planes in registers up to 4 words (the 640x480
  // grid's 2), else read from shared memory each round; a row past the grid
  // holds no edge and no available tile
  constexpr bool kRegs = C * W <= 4;
  uint32_t e_regs[kRegs ? 8 : 1][C][W], avail[C][W];
  auto plane = [&](int s, int c, int k) -> uint32_t {
    const int y = 32 * c + lane;
    return y < gh ? planes[s * r + y * W + k] : 0u;
  };
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int k = 0; k < W; ++k) {
      if constexpr (kRegs) {
#pragma unroll
        for (int s = 0; s < 8; ++s) e_regs[s][c][k] = plane(s, c, k);
      }
      avail[c][k] = plane(LG_LINE, c, k);
    }
  auto edge = [&](int s, int c, int k) -> uint32_t {
    if constexpr (kRegs) return e_regs[kRegs ? s : 0][c][k];
    else return plane(s, c, k);
  };
  int at;
  u64 mine = lg_lane_best<C, W>(avail, keys, gw, lane, at);
  for (int s = 0; s < LG_SEEDS; ++s) {
    // the seed: the heaviest available tile, the first of equal weights
    u64 best = mine;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      const u64 other = __shfl_xor_sync(FULL_MASK, best, d);
      best = other > best ? other : best;
    }
    uint32_t* mem = planes + (LG_MEMBERS + s) * r;
    if (best == 0 || !(__uint_as_float((uint32_t)(best >> 32)) > 0.0f)) {
      // no available line tile: this seed and the rest stop
      for (int i = lane; i < (LG_SEEDS - s) * r; i += 32) mem[i] = 0u;
      if (lane < LG_SEEDS - s) {
        seed_proceeds[s + lane] = 0;
        seed_rounds[s + lane] = 0;
      }
      return;
    }
    const int seed = (int)(0xffffffffu - (uint32_t)best);
    const int sy = seed / gw, sx = seed - sy * gw;
    // the seed's word, as the owning lane indexes its registers
    const int seed_word = (sy >> 5) * W + (sx >> 5);
    const uint32_t seed_bit = (sy & 31) == lane ? 1u << (sx & 31) : 0u;
    uint32_t act[C][W];
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int k = 0; k < W; ++k) act[c][k] = c * W + k == seed_word ? seed_bit : 0u;

    int n_rounds = 0;
    bool changed;
    do {
      ++n_rounds;
      // 1. the diagonal in-edges, one step: rows y - 1 and y + 1 from the
      // lanes beside, across a chunk's ends from the chunk beside
      uint32_t up[C][W], down[C][W];
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int k = 0; k < W; ++k) {
          const int before = c > 0 ? c - 1 : 0, after = c + 1 < C ? c + 1 : 0;
          up[c][k] = __shfl_up_sync(FULL_MASK, act[c][k], 1);
          down[c][k] = __shfl_down_sync(FULL_MASK, act[c][k], 1);
          const uint32_t above = c > 0 ? __shfl_sync(FULL_MASK, act[before][k], 31) : 0u;
          const uint32_t below = c + 1 < C ? __shfl_sync(FULL_MASK, act[after][k], 0) : 0u;
          if (lane == 0) up[c][k] = above;
          if (lane == 31) down[c][k] = below;
        }
      uint32_t a[C][W];
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int k = 0; k < W; ++k) {
          // tile x from x - 1 (`l`) or x + 1 (`r`) of the row above or below
          const int left = k > 0 ? k - 1 : 0, right = k + 1 < W ? k + 1 : 0;
          const uint32_t ul = (up[c][k] << 1) | (k > 0 ? up[c][left] >> 31 : 0u);
          const uint32_t ur = (up[c][k] >> 1) | (k + 1 < W ? up[c][right] << 31 : 0u);
          const uint32_t dl = (down[c][k] << 1) | (k > 0 ? down[c][left] >> 31 : 0u);
          const uint32_t dr = (down[c][k] >> 1) | (k + 1 < W ? down[c][right] << 31 : 0u);
          const uint32_t g = (edge(4, c, k) & ul) | (edge(5, c, k) & ur) |
                             (edge(6, c, k) & dl) | (edge(7, c, k) & dr);
          a[c][k] = act[c][k] | (g & avail[c][k]);
        }
      // 2. along each row, right (tile x joins from x - 1 over plane 0) and
      // left (from x + 1 over plane 1) from the same set: the union of the
      // two closures is closed along the row.  With p the joinable tiles and
      // g those beside an active one, the add p + g carries from each g
      // through the run of p above it, and the carry into a tile says its
      // left neighbour joined; leftward, the same add on the words
      // bit-reversed, from the row's last word
      uint32_t h[C][W];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        uint32_t carry = 0, spill = 0;
#pragma unroll
        for (int k = 0; k < W; ++k) {
          const uint32_t p = edge(0, c, k) & avail[c][k];
          const uint32_t g = ((a[c][k] << 1) | spill) & p;
          spill = a[c][k] >> 31;
          const u64 sum = (u64)p + g + carry;
          carry = (uint32_t)(sum >> 32);
          h[c][k] = a[c][k] | g | (((uint32_t)sum ^ p ^ g) & p);
        }
        carry = 0;
        spill = 0;
#pragma unroll
        for (int k = W - 1; k >= 0; --k) {
          const uint32_t p = edge(1, c, k) & avail[c][k];
          const uint32_t g = ((a[c][k] >> 1) | (spill << 31)) & p;
          spill = a[c][k] & 1u;
          const uint32_t rp = __brev(p), rg = __brev(g);
          const u64 sum = (u64)rp + rg + carry;
          carry = (uint32_t)(sum >> 32);
          h[c][k] |= g | (__brev((uint32_t)sum ^ rp ^ rg) & p);
        }
      }
      // 3. down each column (tile (y, x) joins from (y - 1, x) over plane 2)
      // and up (from (y + 1, x) over plane 3) from the same set, every
      // chunk's and word's scan at once, then the chunks carried in turn
      uint32_t gd[C * W], pd[C * W], gu[C * W], pu[C * W];
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int k = 0; k < W; ++k) {
          gd[c * W + k] = gu[c * W + k] = h[c][k];
          pd[c * W + k] = edge(2, c, k) & avail[c][k];
          pu[c * W + k] = edge(3, c, k) & avail[c][k];
        }
      lg_scan<C * W>(gd, pd, gu, pu, lane);
#pragma unroll
      for (int c = 1; c < C; ++c)
#pragma unroll
        for (int k = 0; k < W; ++k)
          gd[c * W + k] |= pd[c * W + k] & __shfl_sync(FULL_MASK, gd[(c - 1) * W + k], 31);
#pragma unroll
      for (int c = C - 2; c >= 0; --c)
#pragma unroll
        for (int k = 0; k < W; ++k)
          gu[c * W + k] |= pu[c * W + k] & __shfl_sync(FULL_MASK, gu[(c + 1) * W + k], 0);
      changed = false;
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int k = 0; k < W; ++k) {
          const uint32_t v = gd[c * W + k] | gu[c * W + k];
          changed |= v != act[c][k];
          act[c][k] = v;
        }
    } while (__any_sync(FULL_MASK, changed));

    // the members: the grown set's available tiles; consumed all if they are
    // min_tiles or more, else the seed alone
    int count = 0;
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const int y = 32 * c + lane;
        const uint32_t m = act[c][k] & avail[c][k];
        if (y < gh) mem[y * W + k] = m;
        count += __popc(m);
      }
    count = __reduce_add_sync(FULL_MASK, count);
    const bool whole = count >= min_tiles;
    bool lost = false;   // whether this lane's largest key was consumed
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const uint32_t gone =
            whole ? act[c][k] & avail[c][k] : (c * W + k == seed_word ? seed_bit : 0u);
        if (c * W + k == (at >> 5)) lost = (gone >> (at & 31)) & 1u;
        avail[c][k] &= ~gone;
      }
    if (lost) mine = lg_lane_best<C, W>(avail, keys, gw, lane, at);
    if (lane == 0) {
      seed_proceeds[s] = 1;
      seed_rounds[s] = n_rounds;
    }
  }
}

// edges: [8, gh, gw] bool; is_line: [gh * gw] bool; weight: [gh * gw]
// float32 (each 16-byte aligned); members: [LG_SEEDS, gh * gw] bool out
// (16-byte aligned); proceed: [LG_SEEDS] bool out; rounds: [LG_SEEDS] int32
// out, each seed's rounds (the last, which changed nothing, counted; 0 for a
// seed that did not proceed), or null.
__global__ void __launch_bounds__(LG_THREADS)
line_grow_kernel(const uint8_t* __restrict__ edges, const uint8_t* __restrict__ is_line,
                 const float* __restrict__ weight, int gh, int gw, int min_tiles,
                 uint8_t* __restrict__ members, uint8_t* __restrict__ proceed,
                 int* __restrict__ rounds) {
  extern __shared__ __align__(16) uint8_t lg_smem[];
  const int t = gh * gw;
  const int w = (gw + 31) >> 5;
  const int r = gh * w;
  int* seed_proceeds = reinterpret_cast<int*>(lg_smem);
  int* seed_rounds = seed_proceeds + LG_SEEDS;
  u64* keys = reinterpret_cast<u64*>(lg_smem + LG_HEAD_BYTES);
  uint32_t* planes = reinterpret_cast<uint32_t*>(keys + t);

  // a tile's key: its weight's bits (a positive float's order) above its
  // index inverted (the first of equal weights the largest)
  for (int i = threadIdx.x; i < (LG_LINE + 1) * r; i += blockDim.x) planes[i] = 0u;
  for (int i = threadIdx.x; i < t; i += blockDim.x)
    keys[i] = ((u64)__float_as_uint(weight[i]) << 32) | (0xffffffffu - (uint32_t)i);
  __syncthreads();
  lg_pack(edges, 8 * t, 0, planes, t, gw, w, r);
  lg_pack(is_line, t, LG_LINE, planes, t, gw, w, r);
  __syncthreads();

  if (threadIdx.x < 32) {
    const int chunks = (gh + 31) >> 5;
    switch (chunks * 8 + w) {
#define LG_CASE(C, W) \
  case C * 8 + W:     \
    lg_seeds<C, W>(planes, keys, gh, gw, min_tiles, seed_proceeds, seed_rounds); \
    break;
      LG_CASE(1, 1) LG_CASE(1, 2) LG_CASE(1, 3) LG_CASE(1, 4)
      LG_CASE(2, 1) LG_CASE(2, 2) LG_CASE(2, 3) LG_CASE(2, 4)
      LG_CASE(3, 1) LG_CASE(3, 2) LG_CASE(3, 3) LG_CASE(3, 4)
#undef LG_CASE
      default:
        break;
    }
  }
  __syncthreads();

  // the member rows out, 16 bytes a thread at a time (16 t bytes in all)
  const uint32_t* mem = planes + LG_MEMBERS * r;
  for (int j = threadIdx.x; j < t; j += blockDim.x) {
    const int f = j << 4;
    int s = f / t;
    int y = (f - s * t) / gw;
    int x = f - s * t - y * gw;
    uint32_t quad[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      quad[b >> 2] |= ((mem[s * r + y * w + (x >> 5)] >> (x & 31)) & 1u) << (8 * (b & 3));
      if (++x == gw) {
        x = 0;
        if ((++y) * gw == t) {
          y = 0;
          ++s;
        }
      }
    }
    reinterpret_cast<uint4*>(members)[j] = make_uint4(quad[0], quad[1], quad[2], quad[3]);
  }
  if (threadIdx.x < LG_SEEDS) {
    proceed[threadIdx.x] = (uint8_t)seed_proceeds[threadIdx.x];
    if (rounds != nullptr) rounds[threadIdx.x] = seed_rounds[threadIdx.x];
  }
}

// Dynamic shared memory of a gh x gw tile grid: the head, a key a tile and
// the bit planes.
static size_t line_grow_smem(int gh, int gw) {
  const size_t words = (size_t)gh * (size_t)((gw + 31) / 32);
  return LG_HEAD_BYTES + LG_KEY_BYTES * (size_t)gh * (size_t)gw + 4 * LG_PLANES * words;
}

extern "C" int line_grow_launch(const void* edges, const void* is_line, const void* weight,
                                int gh, int gw, int min_tiles, void* members, void* proceed,
                                void* rounds, void* stream) {
  if (gh <= 0 || gw <= 0 || gh > 32 * LG_MAX_CHUNKS || gw > 32 * LG_MAX_WORDS)
    return (int)cudaErrorInvalidValue;
  const size_t smem = line_grow_smem(gh, gw);
  if (smem > LG_MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        line_grow_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  line_grow_kernel<<<1, LG_THREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)edges, (const uint8_t*)is_line, (const float*)weight, gh, gw, min_tiles,
      (uint8_t*)members, (uint8_t*)proceed, (int*)rounds);
  return (int)cudaGetLastError();
}
