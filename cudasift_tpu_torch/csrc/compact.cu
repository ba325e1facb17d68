// K8: raster-order compaction of the extrema mask into a fixed capacity.
//
// Replaces the TPU kernel
// cudasift_tpu/ops/pallas/compact.py:compact_mask_pallas (_compact_kernel).
// Computes the same function as ops/detect.py:compact_mask, bit for bit:
// idx[k] is the flat index of the (k+1)-th set entry of the mask in raster
// order for k < count, 0 past it; count = min(total, capacity); total is
// the number of set entries before the clamp. Three launches on one stream,
// no host read of any count:
//   1. count: each block of 256 threads counts the set entries of its
//      4096-entry segment (coalesced byte reads, warp reductions);
//   2. scan: one block turns the per-segment counts into exclusive offsets
//      and writes total and count;
//   3. write: each block walks its segment again in 16 steps of 256
//      entries; per step a warp ballot and popcount give each set entry its
//      rank inside the step, the warps' counts its rank inside the block,
//      and the segment offset its global rank; an entry is written at that
//      rank if it is below capacity. Blocks whose offset is at or past
//      capacity stop at once. The slots from count to capacity are zeroed
//      by a grid-stride loop.
// Ranks come from counts and scans only (no atomics), so the order never
// depends on scheduling. The TPU kernel is count-gated over the capacity
// slots; this one streams the mask, so its cost scales with the mask size.
//
// Bound: device memory, two reads of the mask (10.4 MB at octave 0 of a
// 1920x1080 frame) and capacity * 4 bytes of writes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int STEPS = 16;
constexpr int SEG = THREADS * STEPS;   // mask entries per block
constexpr int SCAN_THREADS = 1024;

__global__ void __launch_bounds__(THREADS)
count_kernel(const uint8_t* __restrict__ mask, long long n, int* __restrict__ seg_count) {
    __shared__ int warp_sum[THREADS / 32];
    const int t = threadIdx.x;
    const long long base = (long long)blockIdx.x * SEG;
    int c = 0;
    for (int j = 0; j < STEPS; ++j) {
        const long long i = base + j * THREADS + t;
        c += (i < n && mask[i]) ? 1 : 0;
    }
    c = __reduce_add_sync(0xffffffffu, c);
    if (t % 32 == 0) warp_sum[t / 32] = c;
    __syncthreads();
    if (t == 0) {
        int s = 0;
        for (int q = 0; q < THREADS / 32; ++q) s += warp_sum[q];
        seg_count[blockIdx.x] = s;
    }
}

// In place: seg[i] becomes the number of set entries before segment i.
__global__ void __launch_bounds__(SCAN_THREADS)
scan_kernel(int* __restrict__ seg, int nseg, int capacity, int* __restrict__ count,
            int* __restrict__ total) {
    __shared__ int sums[SCAN_THREADS];
    const int t = threadIdx.x;
    const int per = (nseg + SCAN_THREADS - 1) / SCAN_THREADS;
    const int lo = min(t * per, nseg), hi = min(lo + per, nseg);
    int s = 0;
    for (int i = lo; i < hi; ++i) s += seg[i];
    sums[t] = s;
    __syncthreads();
    for (int off = 1; off < SCAN_THREADS; off *= 2) {
        const int v = t >= off ? sums[t - off] : 0;
        __syncthreads();
        sums[t] += v;
        __syncthreads();
    }
    int run = sums[t] - s;
    for (int i = lo; i < hi; ++i) {
        const int c = seg[i];
        seg[i] = run;
        run += c;
    }
    if (t == SCAN_THREADS - 1) {
        *total = sums[t];
        *count = min(sums[t], capacity);
    }
}

__global__ void __launch_bounds__(THREADS)
write_kernel(const uint8_t* __restrict__ mask, long long n, const int* __restrict__ seg_offset,
             const int* __restrict__ count_p, int capacity, int* __restrict__ idx) {
    __shared__ int warp_cnt[THREADS / 32];
    const int t = threadIdx.x, lane = t % 32, warp = t / 32;
    const int count = *count_p;
    for (long long s = (long long)blockIdx.x * THREADS + t; s < capacity;
         s += (long long)gridDim.x * THREADS)
        if (s >= count) idx[s] = 0;

    int rank = seg_offset[blockIdx.x];   // uniform over the block
    const long long base = (long long)blockIdx.x * SEG;
    const unsigned below = (1u << lane) - 1u;
    for (int j = 0; j < STEPS && rank < capacity; ++j) {
        const long long i = base + j * THREADS + t;
        const bool set = i < n && mask[i];
        const unsigned ballot = __ballot_sync(0xffffffffu, set);
        if (lane == 0) warp_cnt[warp] = __popc(ballot);
        __syncthreads();
        int before = 0, step = 0;
        for (int q = 0; q < THREADS / 32; ++q) {
            before += q < warp ? warp_cnt[q] : 0;
            step += warp_cnt[q];
        }
        const int r = rank + before + __popc(ballot & below);
        if (set && r < capacity) idx[r] = (int)i;
        rank += step;
        __syncthreads();   // warp_cnt is rewritten by the next step
    }
}

}  // namespace

extern "C" int compact_mask(const uint8_t* mask, long long n, int capacity, int* seg,
                            int* idx, int* count, int* total, cudaStream_t stream) {
    const int nseg = (int)((n + SEG - 1) / SEG);
    const int blocks = nseg > 0 ? nseg : 1;
    count_kernel<<<blocks, THREADS, 0, stream>>>(mask, n, seg);
    int err = (int)cudaGetLastError();
    if (err) return err;
    scan_kernel<<<1, SCAN_THREADS, 0, stream>>>(seg, blocks, capacity, count, total);
    err = (int)cudaGetLastError();
    if (err) return err;
    write_kernel<<<blocks, THREADS, 0, stream>>>(mask, n, seg, count, capacity, idx);
    return (int)cudaGetLastError();
}
