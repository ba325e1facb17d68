// K4: brute-force descriptor matcher with a fused running top-2, on the
// tensor cores.
//
// Replaces the TPU kernel
// cudasift_tpu/ops/pallas/match.py:match_descriptors_pallas (_match_kernel,
// default rescore_k=None). For every query row: the best and second-best
// dot product against the first n2 rows of the second set, and the index of
// the best, the lowest index winning equal scores. Rows at or past n1 come
// back zero. Outputs: score = max(best, 0), ambiguity = max(second, 0) /
// (score + 1e-6) and index = max(argbest, 0), as the TPU wrapper returns
// them, and, when the caller passes a buffer for it, second = max(second,
// 0) itself (the sharded matcher merges shards' triples with it). No score
// matrix is written to device memory.
//
// Arithmetic. The default tier is 3xTF32 on m16n8k8 mma.sync: big =
// cvt.rna.tf32(x), small = cvt.rna.tf32(x - big), and score = big.big +
// (big.small + small.big), the first product in one float32 accumulator,
// the two cross products in a second, added in that order in the epilogue
// (the order of ops/match.py and of the TPU kernel's split). This keeps
// float32 fidelity: 22 of float32's 24 mantissa bits enter the products.
// It is not the bfloat16x3 split of K5, because the JAX package measured
// that one flipping near-tie matches on its repetitive stereo pair (numFit
// 806 -> 557; cudasift_tpu/ops/pallas/match.py:38-45), which is why its
// exact tier stays at Precision.HIGHEST. The use_bf16 tier is one bfloat16
// product (m16n8k16) of inputs rounded to nearest even.
//
// Layout (csrc/match_tc.cuh): a block of 8 warps owns 128 query rows, split
// once into big and small halves in shared memory, and one SPLIT-column
// range of the second set, streamed in 64-column tiles through a cp.async
// ring. Each thread keeps a running (best, index, second) for its four rows
// over its columns, which it visits in increasing order; at the end the
// four threads of a quad merge with shuffles and the two warps of a row
// group through shared memory, and the block writes one partial triple per
// row and range. Grid: (row blocks) x (ranges). A block whose rows start at
// or past n1, or whose range starts at or past n2, exits at once. A second
// small kernel merges each row's partials in range order (no atomics) and
// writes the outputs.
//
// Bound: arithmetic, 3 * 2 * N1 * N2 * 128 TF32 operations on the tensor
// cores (12.6 GFLOP at 4096 x 4001, 0.025 ms at 495 TFLOP/s), against 4 MB
// of input.

#include <math.h>

#include "match_tc.cuh"

namespace {

using namespace mtc;

constexpr int SPLIT = 1024;   // columns of the second set per block (a range)
constexpr int ROWS = 2 * WM;  // rows per thread

// Shared memory of one block. tf32: big and small query halves (words,
// stride 132) + the ring (floats, stride 132), 200 KB; bf16: the rounded
// query (pairs, stride 68 words) + the ring (stride 136), 104 KB; + one
// triple per row for the cross-warp merge.
template <bool BF16>
struct Layout {
    static constexpr int AW = BF16 ? (DIM + 8) / 2 : DIM + 4;   // query words per row
    static constexpr int AH = BF16 ? 1 : 2;                     // query halves
    static constexpr int BS = BF16 ? DIM + 8 : DIM + 4;         // ring floats per row
    static constexpr size_t SMEM = (size_t)AH * BM * AW * 4 + 2 * (size_t)BN * BS * 4 + BM * 16;
};

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
__global__ void __launch_bounds__(THREADS, BF16 && WM == 1 ? 2 : 1)
match_partial_kernel(const float* __restrict__ d1, const float* __restrict__ d2, int n1cap,
                     int n2cap, const int* __restrict__ n1p, const int* __restrict__ n2p,
                     int splits, float* __restrict__ part_s, int* __restrict__ part_i) {
    using L = Layout<BF16>;
    extern __shared__ __align__(16) unsigned char smem[];
    uint32_t* qa = reinterpret_cast<uint32_t*>(smem);          // big / rounded query
    uint32_t* qb = qa + BM * L::AW;                             // small query (tf32)
    float* ring = reinterpret_cast<float*>(qa + L::AH * BM * L::AW);
    float4* red = reinterpret_cast<float4*>(ring + 2 * BN * L::BS);

    const int n1 = min(*n1p, n1cap);
    const int n2 = min(*n2p, n2cap);
    const int r0 = blockIdx.x * BM;
    const int c_begin = blockIdx.y * SPLIT;
    if (r0 >= n1 || c_begin >= n2) return;
    const int c_end = min(c_begin + SPLIT, n2);
    const int ntiles = (c_end - c_begin + BN - 1) / BN;

    load_tile<L::BS>(ring, d2, c_begin, n2);
    cp_async_commit();
    // Stage the query block while the first tile is in flight, split once.
    for (int i = threadIdx.x; i < BM * DIM / 4; i += THREADS) {
        const int rr = i / (DIM / 4), k = (i % (DIM / 4)) * 4;
        const float4 v = query4(d1, r0, rr, k, n1);
        if (BF16) {
            uint32_t* p = qa + rr * L::AW + k / 2;
            p[0] = pack_bf16(v.x, v.y);
            p[1] = pack_bf16(v.z, v.w);
        } else {
            const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int e = 0; e < 4; ++e)
                split_tf32(x[e], qa[rr * L::AW + k + e], qb[rr * L::AW + k + e]);
        }
    }

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, q = lane & 3;
    const int wr = warp & 3, wc = warp >> 2;
    const int row0 = 16 * WM * wr + g;   // this thread's rows: row0 + 8h, h < ROWS
    float best[ROWS], second[ROWS];
    int idx[ROWS];
#pragma unroll
    for (int h = 0; h < ROWS; ++h) {
        best[h] = second[h] = -1e30f;
        idx[h] = NO_INDEX;
    }

    for (int it = 0; it < ntiles; ++it) {
        if (it + 1 < ntiles) {
            load_tile<L::BS>(ring + ((it + 1) & 1) * BN * L::BS, d2, c_begin + (it + 1) * BN, n2);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const float* tile = ring + (it & 1) * BN * L::BS;
        float hh[WM][4][4] = {}, cr[WM][4][4] = {};
        if (BF16) {
#pragma unroll
            for (int k0 = 0; k0 < DIM / 2; k0 += 8) {   // bf16 pairs, 16 per step
                uint32_t a[WM][4];
#pragma unroll
                for (int m = 0; m < WM; ++m) load_a(a[m], qa, L::AW, row0 + 16 * m, k0, q);
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const float* b = tile + (32 * wc + 8 * j + g) * L::BS + 2 * k0 + 2 * q;
                    const float2 x = *reinterpret_cast<const float2*>(b);
                    const float2 y = *reinterpret_cast<const float2*>(b + 8);
                    const uint32_t b0 = pack_bf16(x.x, x.y), b1 = pack_bf16(y.x, y.y);
#pragma unroll
                    for (int m = 0; m < WM; ++m) mma_bf16(hh[m][j], a[m], b0, b1);
                }
            }
        } else {
#pragma unroll
            for (int k0 = 0; k0 < DIM; k0 += 8) {
                uint32_t ab[WM][4], as[WM][4];
#pragma unroll
                for (int m = 0; m < WM; ++m) {
                    load_a(ab[m], qa, L::AW, row0 + 16 * m, k0, q);
                    load_a(as[m], qb, L::AW, row0 + 16 * m, k0, q);
                }
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const float* b = tile + (32 * wc + 8 * j + g) * L::BS + k0 + q;
                    uint32_t bb0, bs0, bb1, bs1;
                    split_tf32(b[0], bb0, bs0);
                    split_tf32(b[4], bb1, bs1);
#pragma unroll
                    for (int m = 0; m < WM; ++m) {
                        mma_tf32(hh[m][j], ab[m], bb0, bb1);
                        mma_tf32(cr[m][j], ab[m], bs0, bs1);
                        mma_tf32(cr[m][j], as[m], bb0, bb1);
                    }
                }
            }
        }
        // Columns arrive in increasing order, so a strict > keeps the
        // lowest index among equal scores.
        const int c0 = c_begin + it * BN + 32 * wc + 2 * q;
#pragma unroll
        for (int m = 0; m < WM; ++m) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int col = c0 + 8 * j + (e & 1);
                    if (col >= c_end) continue;
                    const float s = BF16 ? hh[m][j][e] : hh[m][j][e] + cr[m][j][e];
                    const int h = 2 * m + (e >> 1);
                    if (s > best[h]) {
                        second[h] = best[h];
                        best[h] = s;
                        idx[h] = col;
                    } else if (s > second[h]) {
                        second[h] = s;
                    }
                }
            }
        }
        __syncthreads();   // this ring stage is free for tile it + 2
    }

#pragma unroll
    for (int h = 0; h < ROWS; ++h) {
        for (int off = 1; off < 4; off *= 2) {
            const float b2 = __shfl_xor_sync(0xffffffffu, best[h], off);
            const int i2 = __shfl_xor_sync(0xffffffffu, idx[h], off);
            const float s2 = __shfl_xor_sync(0xffffffffu, second[h], off);
            merge(best[h], idx[h], second[h], b2, i2, s2);
        }
        if (wc == 1 && q == 0)
            red[row0 + 8 * h] = make_float4(best[h], __int_as_float(idx[h]), second[h], 0.0f);
    }
    __syncthreads();
    if (wc == 0 && q == 0) {
#pragma unroll
        for (int h = 0; h < ROWS; ++h) {
            const float4 o = red[row0 + 8 * h];
            merge(best[h], idx[h], second[h], o.x, __float_as_int(o.y), o.z);
            const int r = r0 + row0 + 8 * h;
            if (r < n1) {
                const size_t at = (size_t)r * splits + blockIdx.y;
                part_s[2 * at] = best[h];
                part_s[2 * at + 1] = second[h];
                part_i[at] = idx[h];
            }
        }
    }
}

// One thread per row: merge the live ranges' partials in order and write
// the outputs (second_out only when it is not null); rows at or past n1 are
// zero.
__global__ void match_merge_kernel(int n1cap, int n2cap, const int* __restrict__ n1p,
                                   const int* __restrict__ n2p, int splits,
                                   const float* __restrict__ part_s,
                                   const int* __restrict__ part_i, float* __restrict__ score,
                                   float* __restrict__ ambiguity, int* __restrict__ index,
                                   float* __restrict__ second_out) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= n1cap) return;
    const int n1 = min(*n1p, n1cap);
    const int n2 = min(*n2p, n2cap);
    if (r >= n1) {
        score[r] = 0.0f;
        ambiguity[r] = 0.0f;
        index[r] = 0;
        if (second_out) second_out[r] = 0.0f;
        return;
    }
    float best = -1e30f, second = -1e30f;
    int idx = NO_INDEX;
    const int live = (n2 + SPLIT - 1) / SPLIT;
    for (int s = 0; s < live; ++s) {
        const size_t at = (size_t)r * splits + s;
        merge(best, idx, second, part_s[2 * at], part_i[at], part_s[2 * at + 1]);
    }
    const float bs = fmaxf(best, 0.0f);
    const float ss = fmaxf(second, 0.0f);
    score[r] = bs;
    ambiguity[r] = ss / (bs + 1e-6f);
    index[r] = (idx == NO_INDEX) ? 0 : idx;
    if (second_out) second_out[r] = ss;
}

template <bool BF16>
cudaError_t launch_partial(const float* d1, const float* d2, int n1cap, int n2cap,
                           const int* n1, const int* n2, int splits, float* part_s,
                           int* part_i, cudaStream_t stream) {
    const size_t smem = Layout<BF16>::SMEM;
    cudaError_t err = cudaFuncSetAttribute(match_partial_kernel<BF16>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((n1cap + BM - 1) / BM, splits);
    match_partial_kernel<BF16><<<grid, THREADS, smem, stream>>>(d1, d2, n1cap, n2cap, n1, n2,
                                                                splits, part_s, part_i);
    return cudaGetLastError();
}

}  // namespace

// part_s (n1cap, splits, 2) f32 and part_i (n1cap, splits) int32 are the
// caller's scratch, splits = ceil(n2cap / 1024). second (n1cap,) f32 may be
// null. Launches the partial kernel (when n2cap > 0) and the merge kernel.
extern "C" int match_descriptors(const float* d1, const float* d2, int n1cap, int n2cap,
                                 const int* n1, const int* n2, int use_bf16, int splits,
                                 float* part_s, int* part_i, float* score, float* ambiguity,
                                 int* index, float* second, cudaStream_t stream) {
    if (n1cap == 0) return 0;
    if (splits != (n2cap + SPLIT - 1) / SPLIT) return (int)cudaErrorInvalidValue;
    if (splits > 0) {
        const cudaError_t err =
            use_bf16 ? launch_partial<true>(d1, d2, n1cap, n2cap, n1, n2, splits, part_s,
                                            part_i, stream)
                     : launch_partial<false>(d1, d2, n1cap, n2cap, n1, n2, splits, part_s,
                                             part_i, stream);
        if (err != cudaSuccess) return (int)err;
    }
    match_merge_kernel<<<(n1cap + 255) / 256, 256, 0, stream>>>(n1cap, n2cap, n1, n2, splits,
                                                                part_s, part_i, score,
                                                                ambiguity, index, second);
    return (int)cudaGetLastError();
}
