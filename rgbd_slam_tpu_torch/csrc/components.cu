// Connected components of the plane extraction's cell graph, for Hopper.
//
// Not a port of a Pallas kernel: the device form of the `lax.while_loop` in
// rgbd_slam_tpu/features/primitives.py:267 (`_connected_components`), which
// propagates the minimum label over the symmetric 4-neighbour mergeability
// edges between planar cells, with two pointer jumps a round, until no label
// changes.  Its plain PyTorch version is `components_reference` in
// rgbd_slam_tpu_torch/ops/components_cuda.py.
//
// The fixpoint does not depend on the schedule.  A label only ever falls, and
// it is always the index of a cell of the same component (a neighbour's label
// across an edge, or the label of the cell a label names), so when no label
// changes each planar cell holds the smallest cell index of its component and
// a non-planar cell holds C = gh * gw.  This kernel therefore updates the
// labels in place, in any order, and returns exactly the JAX labels.
//
// What bounds it on Hopper.  By the roofline, nothing: at 640x480 with 20 px
// cells the grid is 32 x 24 = 768 cells, 4.6 KB in and 6 KB out, and a few
// thousand integer operations a round, far under a microsecond either way.  In
// fact a round is a CTA-wide barrier, and the rounds needed grow with the
// component's diameter (shortened by the pointer jumps), so the kernel is a
// chain of barriers on one SM.  The design keeps that chain short and off the
// host:
//   * one CTA holds the whole grid: the labels (int32) and a byte of edge bits
//     a cell sit in shared memory, the edges made symmetric once on load;
//   * a thread owns cells tid, tid + blockDim, ...: any grid size runs, a grid
//     larger than the CTA loops each thread over several cells;
//   * the owner alone writes a cell's label, in place, so a round sees the
//     labels other threads have already lowered in the same round (Gauss-Seidel
//     order), which only shortens the chain;
//   * the loop ends on __syncthreads_or(changed): no host read, so the kernel
//     can be recorded in a CUDA graph with the rest of the step.
// The wrapper raises on a grid whose labels do not fit in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#define CC_THREADS 1024

// edge bits of a cell's byte
#define CC_LEFT 1
#define CC_RIGHT 2
#define CC_UP 4
#define CC_DOWN 8
#define CC_PLANAR 16

// edges: [4, gh, gw] bool, directed (edge[dir][y, x]: the neighbour at
// (0, +1), (0, -1), (+1, 0), (-1, 0) rolled onto (y, x) may grow into it);
// planar: [gh * gw] bool; labels: [gh * gw] int64 out.
__global__ void __launch_bounds__(CC_THREADS)
components_kernel(const uint8_t* __restrict__ edges, const uint8_t* __restrict__ planar,
                  int gh, int gw, int64_t* __restrict__ labels) {
  extern __shared__ int cc_smem[];
  const int c = gh * gw;
  volatile int* lbl = cc_smem;
  uint8_t* bits = (uint8_t*)(cc_smem + c);

  // symmetric edges, as the plain version builds them:
  //   left (y, x)  = x > 0      and (e0[y, x]   or e1[y, x-1])
  //   right (y, x) = x < gw - 1 and (e0[y, x+1] or e1[y, x])
  //   up (y, x)    = y > 0      and (e2[y, x]   or e3[y-1, x])
  //   down (y, x)  = y < gh - 1 and (e2[y+1, x] or e3[y, x])
  const uint8_t* e0 = edges;
  const uint8_t* e1 = edges + c;
  const uint8_t* e2 = edges + 2 * c;
  const uint8_t* e3 = edges + 3 * c;
  for (int i = threadIdx.x; i < c; i += blockDim.x) {
    const int y = i / gw;
    const int x = i - y * gw;
    uint8_t b = 0;
    if (x > 0 && (e0[i] || e1[i - 1])) b |= CC_LEFT;
    if (x < gw - 1 && (e0[i + 1] || e1[i])) b |= CC_RIGHT;
    if (y > 0 && (e2[i] || e3[i - gw])) b |= CC_UP;
    if (y < gh - 1 && (e2[i + gw] || e3[i])) b |= CC_DOWN;
    if (planar[i]) b |= CC_PLANAR;
    bits[i] = b;
    lbl[i] = planar[i] ? i : c;
  }
  __syncthreads();

  int changed;
  do {
    changed = 0;
    for (int i = threadIdx.x; i < c; i += blockDim.x) {
      const uint8_t b = bits[i];
      if (!(b & CC_PLANAR)) continue;
      const int own = lbl[i];
      int m = own;
      if (b & CC_LEFT) m = min(m, lbl[i - 1]);
      if (b & CC_RIGHT) m = min(m, lbl[i + 1]);
      if (b & CC_UP) m = min(m, lbl[i - gw]);
      if (b & CC_DOWN) m = min(m, lbl[i + gw]);
      // pointer jumping: a cell may adopt its label's own label
      m = min(m, lbl[m]);
      m = min(m, lbl[m]);
      if (m < own) {
        lbl[i] = m;
        changed = 1;
      }
    }
    changed = __syncthreads_or(changed);
  } while (changed);

  for (int i = threadIdx.x; i < c; i += blockDim.x) labels[i] = (int64_t)lbl[i];
}

// Dynamic shared memory of a gh x gw grid: an int32 label and a byte of edge
// bits a cell.
static size_t components_smem(int gh, int gw) {
  return (size_t)gh * (size_t)gw * (sizeof(int) + 1);
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
