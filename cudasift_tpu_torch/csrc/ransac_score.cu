// RANSAC's hypothesis scoring: the inlier count and the MSAC sum of every
// candidate homography over the live matched points.
//
// Replaces no TPU kernel: it stands beside the XLA scoring of
// cudasift_tpu/ops/homography.py:_inlier_counts, whose PyTorch copy
// (ops/cuda/ransac.py:inlier_counts_plain) ran some twenty elementwise and
// reduce kernels over (1024, max_pts) temporaries, tens of GB a call. For a
// hypothesis h = [h00..h21] and a point (x1, y1) -> (x2, y2) it computes
//   deno  = h20 x1 + h21 y1 + 1,  nomx, nomy alike,
//   err2s = (x2 deno - nomx)^2 + (y2 deno - nomy)^2,
//   count += err2s < t2 deno deno             (the division-free test),
//   msac  += min(err2s / max(deno^2, 1e-12), t2),
// with t2 = thresh * thresh, over the points below the live count only.
//
// Bound: about 30 flop and one IEEE division a (hypothesis, point) pair,
// 10000 x ~11k pairs at 1920x1080, some 3.3 GFLOP: compute, not bytes.
// Each thread keeps HYPS hypotheses (8 coefficients each) in registers;
// each block stages its TILE_P points once in shared memory as 16-byte
// {x1, y1, x2, y2} words, which every warp reads as a broadcast. The grid
// is fixed at capture (hypothesis tiles x point splits of max_pts): the
// live count and the threshold are read on the device, and a block whose
// split begins at or past the live count leaves at once, so dead columns
// cost a block launch and nothing else. Nothing is written but each live
// block's partial (count, sum) a hypothesis; a second launch sums the live
// splits in index order, so a replay on the same input gives the same bits
// (no atomics).
//
// Rounding: every product, sum and quotient is the plain expression's,
// element by element, spelled with the _rn intrinsics (never contracted
// into an FMA; the file also builds with -fmad=false), the division IEEE.
// The clamps keep torch.clamp's NaN rule (a comparison that is false for
// NaN leaves the NaN), so every term and every count equals the plain
// version's bit for bit; the sums differ from PyTorch's only in order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int HYPS = 4;                    // hypotheses a thread
constexpr int TILE_H = THREADS * HYPS;     // hypotheses a block
constexpr int TILE_P = 256;                // points a block (one split)
constexpr int REDUCE_THREADS = 256;

__device__ __forceinline__ int live_count(const int* num_pts, int max_pts) {
    return min(max(*num_pts, 0), max_pts);
}

__global__ void __launch_bounds__(THREADS)
score_kernel(const float* __restrict__ h8, int num_h, const float* __restrict__ x1,
             const float* __restrict__ y1, const float* __restrict__ x2,
             const float* __restrict__ y2, int max_pts, const int* __restrict__ num_pts,
             const float* __restrict__ thresh, int* __restrict__ part_count,
             float* __restrict__ part_msac) {
    __shared__ float4 pts[TILE_P];
    const int n_live = live_count(num_pts, max_pts);
    const int p0 = blockIdx.y * TILE_P;
    if (p0 >= n_live) return;                       // a dead split: nothing to read
    const int np = min(TILE_P, n_live - p0);
    for (int p = threadIdx.x; p < np; p += THREADS) {
        const int i = p0 + p;
        pts[p] = make_float4(__ldg(x1 + i), __ldg(y1 + i), __ldg(x2 + i), __ldg(y2 + i));
    }
    const int h0 = blockIdx.x * TILE_H + threadIdx.x;
    float h[HYPS][8];
#pragma unroll
    for (int k = 0; k < HYPS; ++k) {
        const int j = h0 + k * THREADS;
#pragma unroll
        for (int c = 0; c < 8; ++c) h[k][c] = j < num_h ? __ldg(h8 + (size_t)j * 8 + c) : 0.0f;
    }
    const float th = __ldg(thresh);
    const float t2 = __fmul_rn(th, th);
    __syncthreads();
    if (h0 >= num_h) return;                        // no hypothesis of this thread is live

    int count[HYPS];
    float msac[HYPS];
#pragma unroll
    for (int k = 0; k < HYPS; ++k) {
        count[k] = 0;
        msac[k] = 0.0f;
    }
#pragma unroll 2
    for (int p = 0; p < np; ++p) {
        const float4 q = pts[p];
#pragma unroll
        for (int k = 0; k < HYPS; ++k) {
            const float* a = h[k];
            const float nomx = __fadd_rn(__fadd_rn(__fmul_rn(a[0], q.x), __fmul_rn(a[1], q.y)), a[2]);
            const float nomy = __fadd_rn(__fadd_rn(__fmul_rn(a[3], q.x), __fmul_rn(a[4], q.y)), a[5]);
            const float deno = __fadd_rn(__fadd_rn(__fmul_rn(a[6], q.x), __fmul_rn(a[7], q.y)), 1.0f);
            const float ex = __fsub_rn(__fmul_rn(q.z, deno), nomx);
            const float ey = __fsub_rn(__fmul_rn(q.w, deno), nomy);
            const float err2s = __fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey));
            count[k] += err2s < __fmul_rn(__fmul_rn(t2, deno), deno);
            const float dd = __fmul_rn(deno, deno);
            const float deno2 = dd < 1e-12f ? 1e-12f : dd;     // clamp(min=1e-12)
            const float e = __fdiv_rn(err2s, deno2);
            msac[k] = __fadd_rn(msac[k], e > t2 ? t2 : e);      // clamp(max=t2)
        }
    }
    const size_t row = (size_t)blockIdx.y * num_h;
#pragma unroll
    for (int k = 0; k < HYPS; ++k) {
        const int j = h0 + k * THREADS;
        if (j < num_h) {
            part_count[row + j] = count[k];
            part_msac[row + j] = msac[k];
        }
    }
}

// Sums each hypothesis's live splits in index order.
__global__ void __launch_bounds__(REDUCE_THREADS)
reduce_kernel(int num_h, int max_pts, const int* __restrict__ num_pts,
              const int* __restrict__ part_count, const float* __restrict__ part_msac,
              long long* __restrict__ counts, float* __restrict__ msac) {
    const int j = blockIdx.x * REDUCE_THREADS + threadIdx.x;
    if (j >= num_h) return;
    const int splits = (live_count(num_pts, max_pts) + TILE_P - 1) / TILE_P;
    long long c = 0;
    float m = 0.0f;
    for (int s = 0; s < splits; ++s) {
        c += part_count[(size_t)s * num_h + j];
        m = __fadd_rn(m, part_msac[(size_t)s * num_h + j]);
    }
    counts[j] = c;
    msac[j] = m;
}

}  // namespace

// h8 (num_h, 8), the four point fields (max_pts,), num_pts and thresh 0-d on
// the device; part_count and part_msac (ceil(max_pts / 256), num_h) scratch;
// counts (num_h,) int64 and msac (num_h,) out.
extern "C" int ransac_score(const float* h8, int num_h, const float* x1, const float* y1,
                            const float* x2, const float* y2, int max_pts,
                            const int* num_pts, const float* thresh, int* part_count,
                            float* part_msac, long long* counts, float* msac,
                            cudaStream_t stream) {
    if (num_h < 0 || max_pts < 0) return (int)cudaErrorInvalidValue;
    if (num_h == 0) return (int)cudaSuccess;
    if (max_pts > 0) {
        const dim3 grid((num_h + TILE_H - 1) / TILE_H, (max_pts + TILE_P - 1) / TILE_P);
        score_kernel<<<grid, THREADS, 0, stream>>>(h8, num_h, x1, y1, x2, y2, max_pts, num_pts,
                                                   thresh, part_count, part_msac);
    }
    reduce_kernel<<<(num_h + REDUCE_THREADS - 1) / REDUCE_THREADS, REDUCE_THREADS, 0, stream>>>(
        num_h, max_pts, num_pts, part_count, part_msac, counts, msac);
    return (int)cudaGetLastError();
}
