// K5: candidate sweep of the hybrid exact matcher (rescore_k), on the
// tensor cores.
//
// Replaces the TPU kernel
// cudasift_tpu/ops/pallas/match.py:_sweep_candidates (_sweep_kernel), the
// first stage of match_descriptors_pallas(rescore_k=8). Every score is the
// three-product bfloat16 split of the TPU kernel: hi = bf16(a), lo =
// bf16(a - hi) (round to nearest even, as PyTorch's cast), score = hi.hi +
// (hi.lo + lo.hi), on m16n8k16 bf16 mma.sync with float32 accumulation,
// each product exact; hi.hi in one accumulator, the two cross products in a
// second, added in that order in the epilogue. For every query row and
// every chunk of 256 columns of the second set the kernel keeps the top two
// (score, column) pairs, the higher score first and the lower column on
// equal scores; columns at or past n2 (read on the device) score -1e30 and
// still take part in the ranking, as in the TPU kernel. Output: cand_s /
// cand_i (N1, 2 * chunks), entries 2c and 2c+1 for chunk c. Chunks wholly
// past n2 are written without being scored (-1e30 at the chunk's two lowest
// columns); rows at or past n1 get -1e30 and column 0. No score matrix is
// written to device memory. The exact float32 rescore of each row's top-k
// candidates stays in PyTorch (ops/match.py:exact_rescore), as it is XLA in
// the JAX package.
//
// Layout (csrc/match_tc.cuh): a block of 8 warps owns 128 query rows, split
// once into bf16 hi and lo halves in shared memory, and one RANGE of whole
// chunks of the second set, so that no chunk straddles two blocks and each
// block owns its output slice, as each grid step of the TPU kernel does.
// The range streams through a cp.async ring in 64-column tiles, each
// column's hi and lo split at fragment load. Each thread keeps a running
// top-2 for its four rows over its columns of the current chunk; at the
// chunk's end the four threads of a quad merge with shuffles, the two warps
// of a row group through shared memory, and the block writes the chunk's
// two entries per row. Grid: (row blocks) x (ranges).
//
// Bound: arithmetic, 3 * 2 * N1 * N2 * 128 bf16 operations on the tensor
// cores (12.6 GFLOP at 4096 x 4001, 0.013 ms at 989 TFLOP/s).

#include <math.h>

#include "match_tc.cuh"

namespace {

using namespace mtc;

constexpr int CHUNK = 256;
constexpr int RANGE = 1024;            // columns per block: 4 whole chunks
constexpr int AW = (DIM + 8) / 2;      // query words (bf16 pairs) per row
constexpr int BS = DIM + 8;            // ring floats per row
constexpr float DEAD = -1e30f;
constexpr size_t SMEM = 2 * (size_t)BM * AW * 4 + 2 * (size_t)BN * BS * 4 + BM * 16;
constexpr int ROWS = 2 * WM;           // rows per thread

struct Top2 {
    float s1, s2;
    int i1, i2;
};

// (s1, i1) ranks above (s2, i2): higher score, then lower column.
__device__ __forceinline__ bool better(float s1, int i1, float s2, int i2) {
    return s1 > s2 || (s1 == s2 && i1 < i2);
}

__device__ __forceinline__ void insert(Top2& t, float s, int c) {
    if (better(s, c, t.s1, t.i1)) {
        t.s2 = t.s1;
        t.i2 = t.i1;
        t.s1 = s;
        t.i1 = c;
    } else if (better(s, c, t.s2, t.i2)) {
        t.s2 = s;
        t.i2 = c;
    }
}

// Merge the top-2 of another, disjoint set of columns into t.
__device__ __forceinline__ void merge(Top2& t, const Top2& o) {
    if (better(o.s1, o.i1, t.s1, t.i1)) {   // the other top wins
        if (better(t.s1, t.i1, o.s2, o.i2)) {
            t.s2 = t.s1;
            t.i2 = t.i1;
        } else {
            t.s2 = o.s2;
            t.i2 = o.i2;
        }
        t.s1 = o.s1;
        t.i1 = o.i1;
    } else if (better(o.s1, o.i1, t.s2, t.i2)) {
        t.s2 = o.s1;
        t.i2 = o.i1;
    }
}

__device__ __forceinline__ Top2 shfl_xor(const Top2& t, int off) {
    return {__shfl_xor_sync(0xffffffffu, t.s1, off), __shfl_xor_sync(0xffffffffu, t.s2, off),
            __shfl_xor_sync(0xffffffffu, t.i1, off), __shfl_xor_sync(0xffffffffu, t.i2, off)};
}

__global__ void __launch_bounds__(THREADS, WM == 1 ? 2 : 1)
sweep_kernel(const float* __restrict__ d1, const float* __restrict__ d2, int n1cap,
             int n2cap, const int* __restrict__ n1p, const int* __restrict__ n2p,
             int nchunks, float* __restrict__ cand_s, int* __restrict__ cand_i) {
    extern __shared__ __align__(16) unsigned char smem[];
    uint32_t* ahi = reinterpret_cast<uint32_t*>(smem);
    uint32_t* alo = ahi + BM * AW;
    float* ring = reinterpret_cast<float*>(alo + BM * AW);
    Top2* red = reinterpret_cast<Top2*>(ring + 2 * BN * BS);

    const int n1 = min(*n1p, n1cap);
    const int n2 = min(*n2p, n2cap);
    const int ncand = 2 * nchunks;
    const int r0 = blockIdx.x * BM;
    const int ch0 = blockIdx.y * (RANGE / CHUNK);
    const int ch1 = min(ch0 + RANGE / CHUNK, nchunks);
    // Chunks [ch0, live_end) are scored for the block's live rows.
    const int live_end = r0 < n1 ? min(ch1, (n2 + CHUNK - 1) / CHUNK) : ch0;

    // Entries that are not scored: rows past n1, chunks wholly past n2.
    const int width = 2 * (ch1 - ch0);
    for (int i = threadIdx.x; i < BM * width; i += THREADS) {
        const int r = r0 + i / width, e = i % width, ch = ch0 + e / 2;
        if (r >= n1cap || (r < n1 && ch < live_end)) continue;
        const size_t at = (size_t)r * ncand + 2 * ch0 + e;
        cand_s[at] = DEAD;
        cand_i[at] = r < n1 ? ch * CHUNK + (e & 1) : 0;
    }
    if (live_end <= ch0) return;

    const int c_begin = ch0 * CHUNK;
    const int ntiles = (live_end - ch0) * (CHUNK / BN);
    load_tile<BS>(ring, d2, c_begin, n2);
    cp_async_commit();
    // Stage the query block while the first tile is in flight, split once.
    for (int i = threadIdx.x; i < BM * DIM / 4; i += THREADS) {
        const int rr = i / (DIM / 4), k = (i % (DIM / 4)) * 4;
        const float4 v = query4(d1, r0, rr, k, n1);
        uint32_t* h = ahi + rr * AW + k / 2;
        uint32_t* l = alo + rr * AW + k / 2;
        split_bf16(v.x, v.y, h[0], l[0]);
        split_bf16(v.z, v.w, h[1], l[1]);
    }

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, q = lane & 3;
    const int wr = warp & 3, wc = warp >> 2;
    const int row0 = 16 * WM * wr + g;   // this thread's rows: row0 + 8h, h < ROWS
    const Top2 empty = {-INFINITY, -INFINITY, NO_INDEX, NO_INDEX};
    Top2 top[ROWS];
#pragma unroll
    for (int h = 0; h < ROWS; ++h) top[h] = empty;

    for (int it = 0; it < ntiles; ++it) {
        if (it + 1 < ntiles) {
            load_tile<BS>(ring + ((it + 1) & 1) * BN * BS, d2, c_begin + (it + 1) * BN, n2);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const float* tile = ring + (it & 1) * BN * BS;
        float hh[WM][4][4] = {}, cr[WM][4][4] = {};
#pragma unroll
        for (int k0 = 0; k0 < DIM / 2; k0 += 8) {   // bf16 pairs, 16 per step
            uint32_t ah[WM][4], al[WM][4];
#pragma unroll
            for (int m = 0; m < WM; ++m) {
                load_a(ah[m], ahi, AW, row0 + 16 * m, k0, q);
                load_a(al[m], alo, AW, row0 + 16 * m, k0, q);
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float* b = tile + (32 * wc + 8 * j + g) * BS + 2 * k0 + 2 * q;
                const float2 x = *reinterpret_cast<const float2*>(b);
                const float2 y = *reinterpret_cast<const float2*>(b + 8);
                uint32_t bh0, bl0, bh1, bl1;
                split_bf16(x.x, x.y, bh0, bl0);
                split_bf16(y.x, y.y, bh1, bl1);
#pragma unroll
                for (int m = 0; m < WM; ++m) {
                    mma_bf16(hh[m][j], ah[m], bh0, bh1);
                    mma_bf16(cr[m][j], ah[m], bl0, bl1);
                    mma_bf16(cr[m][j], al[m], bh0, bh1);
                }
            }
        }
        const int c0 = c_begin + it * BN + 32 * wc + 2 * q;
#pragma unroll
        for (int m = 0; m < WM; ++m) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int col = c0 + 8 * j + (e & 1);
                    insert(top[2 * m + (e >> 1)], col < n2 ? hh[m][j][e] + cr[m][j][e] : DEAD,
                           col);
                }
            }
        }
        if ((it + 1) % (CHUNK / BN) == 0) {   // the chunk ends: merge and write
            const int ch = ch0 + it / (CHUNK / BN);
#pragma unroll
            for (int h = 0; h < ROWS; ++h) {
                merge(top[h], shfl_xor(top[h], 1));
                merge(top[h], shfl_xor(top[h], 2));
                if (wc == 1 && q == 0) red[row0 + 8 * h] = top[h];
            }
            __syncthreads();
            if (wc == 0 && q == 0) {
#pragma unroll
                for (int h = 0; h < ROWS; ++h) {
                    merge(top[h], red[row0 + 8 * h]);
                    const int r = r0 + row0 + 8 * h;
                    if (r < n1) {
                        const size_t at = (size_t)r * ncand + 2 * ch;
                        cand_s[at] = top[h].s1;
                        cand_s[at + 1] = top[h].s2;
                        cand_i[at] = top[h].i1;
                        cand_i[at + 1] = top[h].i2;
                    }
                }
            }
#pragma unroll
            for (int h = 0; h < ROWS; ++h) top[h] = empty;
        }
        __syncthreads();   // this ring stage is free for tile it + 2
    }
}

}  // namespace

extern "C" int sweep_candidates(const float* d1, const float* d2, int n1cap, int n2cap,
                                const int* n1, const int* n2, int nchunks, float* cand_s,
                                int* cand_i, cudaStream_t stream) {
    if (n1cap == 0 || nchunks == 0) return 0;
    const cudaError_t err = cudaFuncSetAttribute(
        sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    if (err != cudaSuccess) return (int)err;
    const int per_block = RANGE / CHUNK;
    const dim3 grid((n1cap + BM - 1) / BM, (nchunks + per_block - 1) / per_block);
    sweep_kernel<<<grid, THREADS, SMEM, stream>>>(d1, d2, n1cap, n2cap, n1, n2, nchunks,
                                                  cand_s, cand_i);
    return (int)cudaGetLastError();
}
