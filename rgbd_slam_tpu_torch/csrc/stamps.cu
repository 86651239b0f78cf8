// The step graph's device stamps: one thread writes the card's %globaltimer
// (ns, one clock for every SM of the card) into one slot of an int64 buffer.
// Launched on the caller's stream, between two of the step's kernels, it
// starts when the kernel before it has ended, so a CUDA graph that records it
// times the stretch between two stamps on the card itself.

#include <cuda_runtime.h>

__global__ void stamp_kernel(long long* slots, int slot) {
    unsigned long long now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    slots[slot] = static_cast<long long>(now);
}

extern "C" int stamp_launch(long long* slots, int slot, cudaStream_t stream) {
    stamp_kernel<<<1, 1, 0, stream>>>(slots, slot);
    return static_cast<int>(cudaGetLastError());
}
