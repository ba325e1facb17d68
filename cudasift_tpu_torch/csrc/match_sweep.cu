// K5: candidate sweep of the hybrid exact matcher (rescore_k).
//
// Replaces the TPU kernel
// cudasift_tpu/ops/pallas/match.py:_sweep_candidates (_sweep_kernel), the
// first stage of match_descriptors_pallas(rescore_k=8). Every score is the
// three-product bfloat16 split of the TPU kernel, computed on the CUDA
// cores: hi = bf16(a), lo = bf16(a - hi) (round to nearest even, as
// PyTorch's cast), score = hi.hi + (hi.lo + lo.hi), each product exact in
// float32 and each of the three dot products accumulated in float32. For
// every query row and every chunk of 256 columns of the second set the
// kernel keeps the top two (score, column) pairs, the higher score first
// and the lower column on equal scores; columns at or past n2 (read on the
// device) score -1e30 and still take part in the ranking, as in the TPU
// kernel. Output: cand_s / cand_i (N1, 2 * chunks), entries 2c and 2c+1 for
// chunk c. Chunks wholly past n2 are written without being scored; rows at
// or past n1 get -1e30 candidates (blocks wholly past n1 score nothing). The exact
// float32 rescore of each row's top-k candidates stays in PyTorch
// (ops/match.py:exact_rescore), as it is XLA in the JAX package.
//
// Layout as K4 (csrc/match.cu): one block per 32 query rows keeps their hi
// and lo halves in shared memory as bfloat16 and streams 32-column tiles of
// the second set the same way; each thread owns one row and every 8th
// column of a tile and keeps a running top-2 over the chunk; at the chunk's
// end the 8 partial top-2s of a row are merged with warp shuffles.
//
// Bound: arithmetic. 3 * N1 * N2 * 128 multiply-adds on the CUDA cores,
// three times K4's work; the tensor cores (bf16 mma with float32
// accumulation, which is what the split was made for) are the way past it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int QR = 32;        // query rows per block
constexpr int TC = 32;        // columns of the second set per tile
constexpr int DIM = 128;
constexpr int LANES = 8;      // threads per query row
constexpr int THREADS = QR * LANES;
constexpr int CHUNK = 256;
constexpr int PAD = DIM + 2;
constexpr float DEAD = -1e30f;
constexpr int NO_INDEX = 0x7fffffff;

// (s1, i1) ranks above (s2, i2): higher score, then lower column.
__device__ __forceinline__ bool better(float s1, int i1, float s2, int i2) {
    return s1 > s2 || (s1 == s2 && i1 < i2);
}

__device__ __forceinline__ void insert(float s, int c, float& b1, int& i1, float& b2, int& i2) {
    if (better(s, c, b1, i1)) {
        b2 = b1;
        i2 = i1;
        b1 = s;
        i1 = c;
    } else if (better(s, c, b2, i2)) {
        b2 = s;
        i2 = c;
    }
}

__device__ __forceinline__ void split(float v, __nv_bfloat16& hi, __nv_bfloat16& lo) {
    hi = __float2bfloat16_rn(v);
    lo = __float2bfloat16_rn(v - __bfloat162float(hi));
}

__global__ void __launch_bounds__(THREADS)
sweep_kernel(const float* __restrict__ d1, const float* __restrict__ d2, int n1cap,
             int n2cap, const int* __restrict__ n1p, const int* __restrict__ n2p,
             int nchunks, float* __restrict__ cand_s, int* __restrict__ cand_i) {
    __shared__ __nv_bfloat16 ahi[QR][PAD], alo[QR][PAD];
    __shared__ __nv_bfloat16 bhi[TC][PAD], blo[TC][PAD];
    const int t = threadIdx.x;
    const int row = t / LANES, lane = t % LANES;
    const int r0 = blockIdx.x * QR;
    const int r = r0 + row;
    const int n1 = min(*n1p, n1cap);
    const int n2 = min(*n2p, n2cap);
    const int ncand = 2 * nchunks;

    if (r0 >= n1) {  // rows past the live count of the first set
        for (int i = t; i < QR * ncand; i += THREADS) {
            const int rr = r0 + i / ncand;
            if (rr < n1cap) {
                cand_s[(size_t)rr * ncand + i % ncand] = DEAD;
                cand_i[(size_t)rr * ncand + i % ncand] = 0;
            }
        }
        return;
    }
    for (int i = t; i < QR * DIM; i += THREADS) {
        const int rr = i / DIM, c = i % DIM;
        const float v = (r0 + rr < n1cap) ? d1[(size_t)(r0 + rr) * DIM + c] : 0.0f;
        split(v, ahi[rr][c], alo[rr][c]);
    }
    const int live_chunks = (n2 + CHUNK - 1) / CHUNK;
    for (int ch = 0; ch < nchunks; ++ch) {
        float b1 = -INFINITY, b2 = -INFINITY;
        int i1 = NO_INDEX, i2 = NO_INDEX;
        if (ch >= live_chunks) {  // every column masked: the two lowest win
            b1 = b2 = DEAD;
            i1 = ch * CHUNK;
            i2 = ch * CHUNK + 1;
        } else {
            for (int c0 = ch * CHUNK; c0 < (ch + 1) * CHUNK; c0 += TC) {
                __syncthreads();
                for (int i = t; i < TC * DIM; i += THREADS) {
                    const int rr = i / DIM, c = i % DIM;
                    const float v = (c0 + rr < n2) ? d2[(size_t)(c0 + rr) * DIM + c] : 0.0f;
                    split(v, bhi[rr][c], blo[rr][c]);
                }
                __syncthreads();
                for (int j = lane; j < TC; j += LANES) {
                    const int col = c0 + j;
                    float s = DEAD;
                    if (col < n2) {
                        float hh = 0.0f, hl = 0.0f, lh = 0.0f;
#pragma unroll 8
                        for (int e = 0; e < DIM; ++e) {
                            const float ah = __bfloat162float(ahi[row][e]);
                            const float al = __bfloat162float(alo[row][e]);
                            const float bh = __bfloat162float(bhi[j][e]);
                            const float bl = __bfloat162float(blo[j][e]);
                            hh += ah * bh;
                            hl += ah * bl;
                            lh += al * bh;
                        }
                        s = hh + (hl + lh);
                    }
                    insert(s, col, b1, i1, b2, i2);
                }
            }
            for (int off = LANES / 2; off > 0; off /= 2) {
                const float o1 = __shfl_xor_sync(0xffffffffu, b1, off);
                const int oi1 = __shfl_xor_sync(0xffffffffu, i1, off);
                const float o2 = __shfl_xor_sync(0xffffffffu, b2, off);
                const int oi2 = __shfl_xor_sync(0xffffffffu, i2, off);
                if (better(o1, oi1, b1, i1)) {   // the other top wins
                    if (better(b1, i1, o2, oi2)) {
                        b2 = b1;
                        i2 = i1;
                    } else {
                        b2 = o2;
                        i2 = oi2;
                    }
                    b1 = o1;
                    i1 = oi1;
                } else if (better(o1, oi1, b2, i2)) {
                    b2 = o1;
                    i2 = oi1;
                }
            }
        }
        if (lane == 0 && r < n1cap) {
            const bool live = r < n1;
            cand_s[(size_t)r * ncand + 2 * ch] = live ? b1 : DEAD;
            cand_s[(size_t)r * ncand + 2 * ch + 1] = live ? b2 : DEAD;
            cand_i[(size_t)r * ncand + 2 * ch] = live ? i1 : 0;
            cand_i[(size_t)r * ncand + 2 * ch + 1] = live ? i2 : 0;
        }
    }
}

}  // namespace

extern "C" int sweep_candidates(const float* d1, const float* d2, int n1cap, int n2cap,
                                const int* n1, const int* n2, int nchunks, float* cand_s,
                                int* cand_i, cudaStream_t stream) {
    if (n1cap == 0 || nchunks == 0) return 0;
    const int blocks = (n1cap + QR - 1) / QR;
    sweep_kernel<<<blocks, THREADS, 0, stream>>>(d1, d2, n1cap, n2cap, n1, n2, nchunks,
                                                 cand_s, cand_i);
    return (int)cudaGetLastError();
}
