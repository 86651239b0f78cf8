// Connected components of the plane extraction's cell graph, for Hopper.
//
// Not a port of a Pallas kernel: the device form of the `lax.while_loop` in
// rgbd_slam_tpu/features/primitives.py:267 (`_connected_components`), which
// propagates the minimum label over the symmetric 4-neighbour mergeability
// edges between planar cells, with two pointer jumps a round, until no label
// changes.  Its fixpoint labels each planar cell with the smallest cell index
// of its component under the edges whose two ends are planar (a non-planar
// cell's label is always C, so an edge to one joins nothing), and each
// non-planar cell with C = gh * gw.  Its plain PyTorch version is
// `components_reference` in rgbd_slam_tpu_torch/ops/components_cuda.py.
//
// What bounds it on Hopper.  By the roofline, nothing: at 640x480 with 20 px
// cells the grid is 32 x 24 = 768 cells, 3.8 KB in and 6 KB out.  In fact it is
// a chain of latencies in one CTA: each round of label propagation is a few
// dependent shared-memory reads and a CTA barrier, and the first design took
// 9-10 rounds on a room frame and 36 on a serpentine, a row's label moving one
// cell a round.  This design cuts the rounds and what a round waits on:
//   * one CTA; cells i0 .. i0 + 31 on the lanes of a warp, so a row of a
//     32-wide grid (the main path's) is one warp;
//   * the flags pass issues every byte load a cell needs from device memory
//     at once, the neighbours' indices clamped into the grid, and takes the
//     symmetric edges as the plain version builds them: both ends planar, the
//     border columns and rows cleared so nothing wraps.  A ballot of the right
//     edges gives each cell the first and last lane of its run along the
//     warp's 32 cells (`__clz`, `__ffs`);
//   * a round takes each cell's minimum over its label and its vertical
//     neighbours' (and, at a warp's first and last lane, its horizontal
//     neighbours' across the warp), then the minimum over its whole run by a
//     segmented shuffle reduction, so a label crosses a run in one round, then
//     one pointer jump (the label of the cell its label names);
//   * where the CTA has a thread a cell (the main path), a thread keeps its
//     cell's flags and label in registers from round to round;
//   * the rounds end on `__syncthreads_or(changed)`: no host read, so the
//     kernel can be recorded in a CUDA graph with the rest of the step.
// The labels are exact whatever order the warps' reads and writes take: a
// label only ever falls, always to the index of a cell of the same component
// (a neighbour's label across an edge, or the label of the cell a label
// names), and a round in which no label changes leaves every edge's two ends
// and every run equal, so each planar cell then holds the smallest index of
// its component.  A concurrent union-find in shared memory (atomicMin hooks of
// row runs, then a walk to the roots) computes the same labels in a fixed
// number of phases, but measured slower on the card, inside the step's graph
// as well as warm: its hook loops took 2-3 us a room frame.
// The wrapper raises on a grid past one CTA's shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#define CC_THREADS 1024
#define FULL_MASK 0xffffffffu
// shared memory a cell: its int32 label and its uint16 flags
#define CC_SMEM_BYTES_PER_CELL 6

// flags of a cell: planar; an edge up, down; an edge left out of the warp's
// first lane, right out of its last; bits 5-9 the first lane of its run
// along the warp, bits 10-14 the last
#define CC_PLANAR 1
#define CC_UP 2
#define CC_DOWN 4
#define CC_LEFT_OUT 8
#define CC_RIGHT_OUT 16
#define CC_START_SHIFT 5
#define CC_END_SHIFT 10

// One round's work on cell i (lane `lane` of its warp; i may be past the
// grid, with flags that make it a one-lane run, and `own` = C): the minimum
// over its label `own`, its neighbours' across its edges and its run's, then
// one pointer jump.  Returns whether its label fell, and writes it to `own`
// and its slot.  The reads need not be volatile: a barrier ends each round,
// and a label another warp lowers during the round is read either way, both
// being labels of the same component.
__device__ __forceinline__ int cc_step(int* lbl, int i, int f, int& own, int gw, int lane) {
  int m = own;
  if (f & CC_UP) m = min(m, lbl[i - gw]);
  if (f & CC_DOWN) m = min(m, lbl[i + gw]);
  if (f & CC_LEFT_OUT) m = min(m, lbl[i - 1]);
  if (f & CC_RIGHT_OUT) m = min(m, lbl[i + 1]);
  // the minimum over the run: lane k gathers lanes k .. end, and the run's
  // first lane hands the whole run's to every lane of it (one
  // `__reduce_min_sync` a run serialises the runs of a warp: 2.8x slower)
  const int end = (f >> CC_END_SHIFT) & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_down_sync(FULL_MASK, m, d);
    if (lane + d <= end) m = min(m, v);
  }
  m = __shfl_sync(FULL_MASK, m, (f >> CC_START_SHIFT) & 31);
  if (!(f & CC_PLANAR)) return 0;
  m = min(m, lbl[m]);   // pointer jump: a cell may adopt its label's own label
  if (m >= own) return 0;
  lbl[i] = m;
  own = m;
  return 1;
}

// edges: [4, gh, gw] bool, directed (edge[dir][y, x]: the neighbour at
// (0, +1), (0, -1), (+1, 0), (-1, 0) rolled onto (y, x) may grow into it);
// planar: [gh * gw] bool; labels: [gh * gw] int64 out.
__global__ void __launch_bounds__(CC_THREADS)
components_kernel(const uint8_t* __restrict__ edges, const uint8_t* __restrict__ planar,
                  int gh, int gw, int64_t* __restrict__ labels) {
  extern __shared__ __align__(16) uint8_t cc_smem[];
  const int c = gh * gw;
  int* lbl = reinterpret_cast<int*>(cc_smem);
  uint16_t* flags = reinterpret_cast<uint16_t*>(cc_smem + 4 * c);
  const int lane = threadIdx.x & 31;

  // symmetric edges, as the plain version builds them:
  //   left (y, x)  = x > 0      and (e0[y, x]   or e1[y, x-1])
  //   right (y, x) = x < gw - 1 and (e0[y, x+1] or e1[y, x])
  //   up (y, x)    = y > 0      and (e2[y, x]   or e3[y-1, x])
  //   down (y, x)  = y < gh - 1 and (e2[y+1, x] or e3[y, x])
  // kept where both ends are planar.  The loop is uniform over a warp.
  const uint8_t* e0 = edges;
  const uint8_t* e1 = edges + c;
  const uint8_t* e2 = edges + 2 * c;
  const uint8_t* e3 = edges + 3 * c;
  for (int i0 = threadIdx.x & ~31; i0 < c; i0 += blockDim.x) {
    const int i = i0 + lane;
    bool here = false, left = false, right = false, up = false, down = false;
    if (i < c) {
      // the neighbours' indices clamped into the grid, so every load issues
      // before the division that says which neighbours there are
      const int il = max(i - 1, 0), ir = min(i + 1, c - 1);
      const int iu = max(i - gw, 0), id = min(i + gw, c - 1);
      const uint8_t p = planar[i], pl = planar[il], pr = planar[ir], pu = planar[iu],
                    pd = planar[id];
      const uint8_t l0 = e0[i], l1 = e1[il], r0 = e0[ir], r1 = e1[i];
      const uint8_t u2 = e2[i], u3 = e3[iu], d2 = e2[id], d3 = e3[i];
      const int y = i / gw;
      const int x = i - y * gw;
      const bool has_l = x > 0, has_r = x < gw - 1, has_u = y > 0, has_d = y < gh - 1;
      here = p != 0;
      left = has_l && here && pl && (l0 || l1);
      right = has_r && here && pr && (r0 || r1);
      up = has_u && here && pu && (u2 || u3);
      down = has_d && here && pd && (d2 || d3);
    }
    // a run of right edges starts after the last lane below without one and
    // ends at the first lane from here without one
    const unsigned runs = __ballot_sync(FULL_MASK, right) & 0x7fffffffu;
    const unsigned breaks = ~runs & ((1u << lane) - 1u);
    const int start = breaks ? 32 - __clz(breaks) : 0;
    const int end = min(31, lane + __ffs(~(runs >> lane)) - 1);
    if (i < c) {
      flags[i] = (uint16_t)((here ? CC_PLANAR : 0) | (up ? CC_UP : 0) | (down ? CC_DOWN : 0) |
                            (lane == 0 && left ? CC_LEFT_OUT : 0) |
                            (lane == 31 && right ? CC_RIGHT_OUT : 0) |
                            (start << CC_START_SHIFT) | (end << CC_END_SHIFT));
      lbl[i] = here ? i : c;
    }
  }
  __syncthreads();

  // the flags of a lane past the grid: a one-lane run of no edges
  const int none = (lane << CC_START_SHIFT) | (lane << CC_END_SHIFT);
  if (c <= (int)blockDim.x) {   // a cell a thread, its flags and label in registers
    const int i = threadIdx.x;
    const int f = i < c ? flags[i] : none;
    int own = i < c ? lbl[i] : c;
    while (__syncthreads_or(cc_step(lbl, i, f, own, gw, lane))) {}
  } else {
    int changed;
    do {
      changed = 0;
      for (int i0 = threadIdx.x & ~31; i0 < c; i0 += blockDim.x) {
        const int i = i0 + lane;
        int own = i < c ? lbl[i] : c;
        changed |= cc_step(lbl, i, i < c ? flags[i] : none, own, gw, lane);
      }
    } while (__syncthreads_or(changed));
  }

  for (int i = threadIdx.x; i < c; i += blockDim.x) labels[i] = (int64_t)lbl[i];
}

// Dynamic shared memory of a gh x gw grid.
static size_t components_smem(int gh, int gw) {
  return (size_t)gh * (size_t)gw * CC_SMEM_BYTES_PER_CELL;
}

extern "C" int components_launch(const void* edges, const void* planar, int gh, int gw,
                                 void* labels, void* stream) {
  if (gh <= 0 || gw <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = components_smem(gh, gw);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        components_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int c = gh * gw;
  const int threads = c < CC_THREADS ? ((c + 31) / 32) * 32 : CC_THREADS;
  components_kernel<<<1, threads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)edges, (const uint8_t*)planar, gh, gw, (int64_t*)labels);
  return (int)cudaGetLastError();
}
