// K8: raster-order compaction of the extrema mask into a fixed capacity.
//
// Replaces the TPU kernel
// cudasift_tpu/ops/pallas/compact.py:compact_mask_pallas (_compact_kernel).
// Computes the same function as ops/detect.py:compact_mask, bit for bit:
// idx[k] is the flat index of the (k+1)-th set (non-zero) byte of the mask
// in raster order for k < count, 0 past it; count = min(total, capacity);
// total is the number of set entries before the clamp.
//
// Layout. The mask is read as 16-byte words on the 16-byte grid of the
// address space: word w covers flat entries [16 w - a, 16 w - a + 16),
// where a = mask address mod 16, so every whole word is one aligned uint4
// load whatever the view's offset. The first and the last word, where they
// reach outside [0, n), are read byte by byte. A segment is 1024 words
// (16384 entries); thread t of its block loads words t, t + 256, t + 512
// and t + 768, so neighbouring threads read neighbouring words.
//
// Two launches on one stream, no host read of any count:
//   1. count: one block per segment counts its set bytes (__vsetne4 +
//      popcount per word, warp and block sums) into seg_count;
//   2. write: each block sums the counts of the segments before it (its
//      offset) and of all of them (total, count) straight from seg_count,
//      which replaces a separate scan launch. It reloads its words and
//      ranks each set byte: its prefix inside the word, the warp's
//      exclusive scan of per-thread counts (__shfl_up_sync), the counts of
//      the warps before it, and the totals of the earlier load steps. An
//      entry is written at offset + rank if that is below capacity. Every
//      block zeroes its share of the slots count..capacity; block 0 writes
//      count and total; blocks whose offset is at or past capacity stop
//      after that.
// Ranks come from counts and prefix sums only: no atomic decides an order,
// and no state lives from one call to the next, so the launches can be
// captured in a CUDA graph and replayed.
//
// Bound: device memory in principle -- one read of the mask (10.4 MB at
// octave 0 of a 1920x1080 frame, 0.003 ms at 3.35 TB/s) and capacity * 4
// bytes of writes; the second read mostly hits the 50 MB L2, and segments
// of 16384 entries keep the per-block sum over seg_count (633 ints there)
// cheap. At that size the two dependent launches' fixed cost sets the pace:
// about 0.01 ms replayed from a CUDA graph on an H100, against about 0.04 ms
// for the three-launch design with byte loads it replaces.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int VEC = 16;                  // mask entries (bytes) per load
constexpr int STEPS = 4;                 // loads per thread
constexpr int WORDS = THREADS * STEPS;   // words per segment
constexpr int SEG = WORDS * VEC;         // mask entries per segment (block)

// Word w of the mask whose address is a bytes past the 16-byte grid.
__device__ __forceinline__ uint4 load_word(const uint8_t* __restrict__ mask, int a, long long n,
                                           long long w) {
    const long long lo = w * VEC - a;    // flat index of the word's first byte
    if (lo >= 0 && lo + VEC <= n) return __ldg(reinterpret_cast<const uint4*>(mask + lo));
    unsigned b[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
        const long long i = lo + q;
        if (i >= 0 && i < n && mask[i]) b[q / 4] |= 1u << (8 * (q % 4));
    }
    return make_uint4(b[0], b[1], b[2], b[3]);
}

__device__ __forceinline__ int set_bytes(uint4 v) {
    return __popc(__vsetne4(v.x, 0u)) + __popc(__vsetne4(v.y, 0u)) +
           __popc(__vsetne4(v.z, 0u)) + __popc(__vsetne4(v.w, 0u));
}

__global__ void __launch_bounds__(THREADS)
count_kernel(const uint8_t* __restrict__ mask, int a, long long n, int* __restrict__ seg_count) {
    __shared__ int warp_sum[WARPS];
    const int t = threadIdx.x;
    const long long w0 = (long long)blockIdx.x * WORDS;
    uint4 v[STEPS];
#pragma unroll
    for (int k = 0; k < STEPS; ++k) v[k] = load_word(mask, a, n, w0 + k * THREADS + t);
    int c = 0;
#pragma unroll
    for (int k = 0; k < STEPS; ++k) c += set_bytes(v[k]);
    c = __reduce_add_sync(0xffffffffu, c);
    if (t % 32 == 0) warp_sum[t / 32] = c;
    __syncthreads();
    if (t == 0) {
        int s = 0;
        for (int q = 0; q < WARPS; ++q) s += warp_sum[q];
        seg_count[blockIdx.x] = s;
    }
}

__global__ void __launch_bounds__(THREADS)
write_kernel(const uint8_t* __restrict__ mask, int a, long long n, int nseg,
             const int* __restrict__ seg_count, int capacity, int* __restrict__ idx,
             int* __restrict__ count_p, int* __restrict__ total_p) {
    __shared__ int sums[2][WARPS];
    __shared__ int step_cnt[STEPS][WARPS];
    const int t = threadIdx.x, lane = t % 32, warp = t / 32;
    const int b = blockIdx.x;
    const long long w0 = (long long)b * WORDS;

    uint4 v[STEPS];
#pragma unroll
    for (int k = 0; k < STEPS; ++k) v[k] = load_word(mask, a, n, w0 + k * THREADS + t);

    // This block's offset and the total, from the segment counts.
    int before = 0, all = 0;
    for (int i = t; i < nseg; i += THREADS) {
        const int c = seg_count[i];
        all += c;
        before += i < b ? c : 0;
    }
    before = __reduce_add_sync(0xffffffffu, before);
    all = __reduce_add_sync(0xffffffffu, all);
    if (lane == 0) {
        sums[0][warp] = before;
        sums[1][warp] = all;
    }

    // Per step, the thread's count and its warp's exclusive prefix.
    int cnt[STEPS], excl[STEPS];
#pragma unroll
    for (int k = 0; k < STEPS; ++k) {
        cnt[k] = set_bytes(v[k]);
        int x = cnt[k];
#pragma unroll
        for (int d = 1; d < 32; d *= 2) {
            const int y = __shfl_up_sync(0xffffffffu, x, d);
            if (lane >= d) x += y;
        }
        excl[k] = x - cnt[k];
        if (lane == 31) step_cnt[k][warp] = x;
    }
    __syncthreads();

    int offset = 0, total = 0;
#pragma unroll
    for (int q = 0; q < WARPS; ++q) {
        offset += sums[0][q];
        total += sums[1][q];
    }
    const int count = min(total, capacity);
    if (b == 0 && t == 0) {
        *count_p = count;
        *total_p = total;
    }
    for (long long s = count + (long long)b * THREADS + t; s < capacity;
         s += (long long)gridDim.x * THREADS)
        idx[s] = 0;
    if (offset >= capacity) return;      // uniform over the block

    int run = offset;                    // rank of this step's first set entry
#pragma unroll
    for (int k = 0; k < STEPS; ++k) {
        int warp_before = 0, step_total = 0;
#pragma unroll
        for (int q = 0; q < WARPS; ++q) {
            const int s = step_cnt[k][q];
            warp_before += q < warp ? s : 0;
            step_total += s;
        }
        int r = run + warp_before + excl[k];
        if (cnt[k] > 0 && r < capacity) {
            const long long lo = (w0 + k * THREADS + t) * VEC - a;
            const unsigned word[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
            for (int q = 0; q < VEC; ++q) {
                if ((word[q / 4] >> (8 * (q % 4))) & 0xffu) {
                    if (r < capacity) idx[r] = (int)(lo + q);
                    ++r;
                }
            }
        }
        run += step_total;
    }
}

}  // namespace

// ``seg`` holds at least ceil((n + mask % 16) / 16384) ints (1 when n is
// 0); every one the count launch writes is read by the write launch.
extern "C" int compact_mask(const uint8_t* mask, long long n, int capacity, int* seg,
                            int* idx, int* count, int* total, cudaStream_t stream) {
    const int a = (int)((uintptr_t)mask % VEC);
    const long long nseg = (n + a + SEG - 1) / SEG;
    const int blocks = nseg > 0 ? (int)nseg : 1;
    count_kernel<<<blocks, THREADS, 0, stream>>>(mask, a, n, seg);
    int err = (int)cudaGetLastError();
    if (err) return err;
    write_kernel<<<blocks, THREADS, 0, stream>>>(mask, a, n, blocks, seg, capacity, idx,
                                                 count, total);
    return (int)cudaGetLastError();
}
