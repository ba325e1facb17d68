// K4: brute-force descriptor matcher with a fused running top-2.
//
// Replaces the TPU kernel
// cudasift_tpu/ops/pallas/match.py:match_descriptors_pallas (_match_kernel,
// default rescore_k=None). One block per 32 query rows keeps those rows in
// shared memory and streams the second set through shared memory in tiles
// of 32 rows; each thread owns one query row and every 8th column of a tile,
// computes the dot products itself with float32 multiply-adds, and keeps a
// running (best, second, index). The 8 partial triples of a row are merged
// with warp shuffles. Columns at or past n2 never enter. The lowest index
// wins ties, as in the TPU kernel. The bf16 tier rounds both inputs to
// bfloat16 and accumulates in float32.
//
// Rows at or past n1 come back zero without being scored.
// Outputs: score = max(best, 0), ambiguity = max(second, 0) / (score + 1e-6)
// and index = max(argbest, 0), as the TPU wrapper returns them.
//
// Bound: arithmetic. N1*N2*128 multiply-adds on the CUDA cores (about 2.1
// GFLOP at 4096 x 4096), against 4 MB of input. The tensor cores (wgmma) are
// the way past that bound, in a later version.

#include <cuda_runtime.h>
#include <math.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int QR = 32;        // query rows per block
constexpr int TC = 32;        // columns of the second set per tile
constexpr int DIM = 128;
constexpr int LANES = 8;      // threads per query row
constexpr int THREADS = QR * LANES;
constexpr int NO_INDEX = 0x7fffffff;

template <bool BF16>
__device__ __forceinline__ float load(const float* p) {
    if (BF16) return __bfloat162float(__float2bfloat16(*p));
    return *p;
}

// Merge two (best, index, second) triples over disjoint column sets.
__device__ __forceinline__ void merge(float& best, int& idx, float& second,
                                      float b2, int i2, float s2) {
    const float lo = fminf(best, b2);
    second = fmaxf(lo, fmaxf(second, s2));
    if (b2 > best || (b2 == best && i2 < idx)) {
        best = b2;
        idx = i2;
    }
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
match_kernel(const float* __restrict__ d1, const float* __restrict__ d2,
             int n1cap, int n2cap, const int* __restrict__ n1p,
             const int* __restrict__ n2p,
             float* __restrict__ score, float* __restrict__ ambiguity,
             int* __restrict__ index) {
    __shared__ float a[QR][DIM + 1];
    __shared__ float b[TC][DIM + 1];
    const int t = threadIdx.x;
    const int row = t / LANES, lane = t % LANES;
    const int r0 = blockIdx.x * QR;
    const int n1 = min(*n1p, n1cap);
    const int n2 = min(*n2p, n2cap);
    if (r0 >= n1) {  // rows past the live count of the first set are zero
        if (t < QR && r0 + t < n1cap) {
            score[r0 + t] = 0.0f;
            ambiguity[r0 + t] = 0.0f;
            index[r0 + t] = 0;
        }
        return;
    }

    for (int i = t; i < QR * DIM; i += THREADS) {
        const int r = i / DIM, c = i % DIM;
        a[r][c] = (r0 + r < n1cap) ? load<BF16>(d1 + (size_t)(r0 + r) * DIM + c) : 0.0f;
    }
    float best = -1e30f, second = -1e30f;
    int idx = NO_INDEX;
    for (int c0 = 0; c0 < n2; c0 += TC) {
        __syncthreads();
        for (int i = t; i < TC * DIM; i += THREADS) {
            const int r = i / DIM, c = i % DIM;
            b[r][c] = (c0 + r < n2) ? load<BF16>(d2 + (size_t)(c0 + r) * DIM + c) : 0.0f;
        }
        __syncthreads();
        for (int j = lane; j < TC; j += LANES) {
            const int col = c0 + j;
            if (col >= n2) break;
            float acc = 0.0f;
#pragma unroll 8
            for (int e = 0; e < DIM; ++e) acc += a[row][e] * b[j][e];
            // Columns arrive in increasing order, so a strict > keeps the
            // lowest index among equal scores.
            if (acc > best) {
                second = best;
                best = acc;
                idx = col;
            } else if (acc > second) {
                second = acc;
            }
        }
    }
    for (int off = LANES / 2; off > 0; off /= 2) {
        const float b2 = __shfl_xor_sync(0xffffffffu, best, off);
        const int i2 = __shfl_xor_sync(0xffffffffu, idx, off);
        const float s2 = __shfl_xor_sync(0xffffffffu, second, off);
        merge(best, idx, second, b2, i2, s2);
    }
    const int r = r0 + row;
    if (lane == 0 && r >= n1 && r < n1cap) {
        score[r] = 0.0f;
        ambiguity[r] = 0.0f;
        index[r] = 0;
    } else if (lane == 0 && r < n1cap) {
        const float bs = fmaxf(best, 0.0f);
        const float sc = fmaxf(second, 0.0f);
        score[r] = bs;
        ambiguity[r] = sc / (bs + 1e-6f);
        index[r] = (idx == NO_INDEX) ? 0 : idx;
    }
}

}  // namespace

extern "C" int match_descriptors(const float* d1, const float* d2, int n1cap,
                                 int n2cap, const int* n1, const int* n2, int use_bf16,
                                 float* score, float* ambiguity, int* index,
                                 cudaStream_t stream) {
    if (n1cap == 0) return 0;
    const int blocks = (n1cap + QR - 1) / QR;
    if (use_bf16)
        match_kernel<true><<<blocks, THREADS, 0, stream>>>(d1, d2, n1cap, n2cap, n1, n2,
                                                           score, ambiguity, index);
    else
        match_kernel<false><<<blocks, THREADS, 0, stream>>>(d1, d2, n1cap, n2cap, n1, n2,
                                                            score, ambiguity, index);
    return (int)cudaGetLastError();
}
