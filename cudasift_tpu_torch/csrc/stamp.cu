// The stage marker of utils/trace.py: one thread writes the device's global
// timer (%globaltimer, ns) into a slot of a buffer in pinned host memory,
// which the device reaches through unified addressing.
//
// A kernel in stream order starts after the one before it has finished and
// ends before the one after it starts, so a stamp marks a boundary between
// the kernels around it, inside a captured graph as on a stream. A timing
// event recorded in a graph marks it too, but each event-record node cost
// about 4.2 us of a replayed 1920x1080 frame (33 of them: 1.164 -> 1.304 ms,
// NVIDIA H100 80GB HBM3 at 700 W); a one-thread kernel node costs about a
// launch. The host reads the stamps from the buffer once the work is done.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void stamp_kernel(unsigned long long* slots, int slot) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    slots[slot] = t;
}

}  // namespace

extern "C" int stamp(unsigned long long* slots, int slot, cudaStream_t stream) {
    if (slot < 0) return (int)cudaErrorInvalidValue;
    stamp_kernel<<<1, 1, 0, stream>>>(slots, slot);
    return (int)cudaGetLastError();
}
