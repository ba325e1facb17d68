// The weighted 8-parameter least-squares refit of the homography programs
// (RANSAC's LO refits): for each of B weightings w of the same DLT rows, the
// a (8) that minimises sum_i w_i ((ya_i . a - bx_i)^2 + (yb_i . a - by_i)^2),
// by a float32 thin QR: modified Gram-Schmidt with a second
// orthogonalisation pass, the algorithm of its plain twin
// ops/linalg.py:weighted_lstsq8 step for step. The two differ only in the
// order of each dot product's sum.
//
// Replaces no TPU kernel: it stands beside the XLA refit of the JAX package
// (cudasift_tpu/ops/linalg.py:weighted_lstsq8, the same QR), whose PyTorch
// copy runs some 460 elementwise and reduce kernels a call over
// (B, 2 x max_pts) temporaries.
//
// The QR is 72 dependent sums over the live rows (per column j: 2j
// projections, the norm and q_j . b), so a call is bound by how fast one sum
// can follow another, not by bytes: the rows of one weighting are spread
// over a cluster of CLUSTER blocks, each thread keeps the same rows
// throughout (no sum waits on another thread's rows), and a sum is a
// shuffle tree in each warp, the warps in order, then the cluster's blocks
// in rank order through distributed shared memory, behind one cluster
// barrier. Every block sums the partials in the same order, so all hold the
// same bits, and a replay gives the same bits (no atomics). The pending
// update v -= c q_i of one projection rides in the sweep of the next sum.
//
// The live count is read on the device: rows at or past it are left out,
// which is exact since every caller's weight is 0 there (a zero row adds 0 to
// every sum). The rows of A and b sit in a float32 workspace, in place: the
// columns of A become those of Q.
//
// ok: the weight total is at least 4, every diagonal of R is greater than
// 1e-12, and a is finite.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 8;                   // blocks a weighting
constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int SUMS = 1 + 72;                 // the weight total, then the QR's sums
constexpr int COLS = 9;                      // the 8 of A, then b

// The cluster-wide sum of x; k numbers the sums of a call, so no slot of
// block_part is written twice, and warp_part alternates between two rows.
__device__ __forceinline__ float cluster_sum(float x, int k, float (&warp_part)[2][WARPS],
                                             float (&block_part)[SUMS]) {
    cg::cluster_group cluster = cg::this_cluster();
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) warp_part[k & 1][warp] = x;
    __syncthreads();
    if (warp == 0) {
        float y = warp_part[k & 1][lane];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) y += __shfl_down_sync(0xffffffffu, y, off);
        if (lane == 0) block_part[k] = y;
    }
    cluster.sync();
    float s = *cluster.map_shared_rank(&block_part[k], 0);
#pragma unroll
    for (int r = 1; r < CLUSTER; ++r) s += *cluster.map_shared_rank(&block_part[k], r);
    return s;
}

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
qr_kernel(const float* __restrict__ ya, const float* __restrict__ yb,
          const float* __restrict__ w, const float* __restrict__ bx,
          const float* __restrict__ by, int n, const int* __restrict__ num_pts,
          float* work, float* __restrict__ a, bool* __restrict__ ok) {
    __shared__ float warp_part[2][WARPS];
    __shared__ float block_part[SUMS];
    __shared__ float r[8][8], qtb[8];
    cg::cluster_group cluster = cg::this_cluster();
    const int wi = blockIdx.y;
    const int stride = CLUSTER * THREADS;
    const int first = (int)cluster.block_rank() * THREADS + threadIdx.x;
    const int live = min(max(*num_pts, 0), n);
    const size_t rows = 2 * (size_t)n;           // a column: the ya rows, then the yb rows
    float* col = work + (size_t)wi * COLS * rows;
    const float* wb = w + (size_t)wi * n;

    // A = [ya; yb] * sqrt(w) and b = [bx; by] * sqrt(w), this thread's rows.
    float wsum = 0.0f;
    for (int p = first; p < live; p += stride) {
        const float wp = wb[p];
        const float s = sqrtf(wp);
        wsum += wp;
        const float4* ra = reinterpret_cast<const float4*>(ya + (size_t)p * 8);
        const float4* rb = reinterpret_cast<const float4*>(yb + (size_t)p * 8);
        const float4 a0 = __ldg(ra), a1 = __ldg(ra + 1), b0 = __ldg(rb), b1 = __ldg(rb + 1);
        const float va[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float vb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            col[j * rows + p] = va[j] * s;
            col[j * rows + n + p] = vb[j] * s;
        }
        col[8 * rows + p] = __ldg(bx + p) * s;
        col[8 * rows + n + p] = __ldg(by + p) * s;
    }
    int k = 0;
    bool good = cluster_sum(wsum, k++, warp_part, block_part) >= 4.0f;

    const float* b = col + 8 * rows;
    for (int j = 0; j < 8; ++j) {
        float* v = col + j * rows;
        // The projections on q_0 .. q_{j-1}, twice; (c, qp) is the update
        // still to apply to v.
        float c = 0.0f;
        const float* qp = nullptr;
        if (threadIdx.x == 0)
            for (int i = 0; i < j; ++i) r[i][j] = 0.0f;
        for (int pass = 0; pass < 2; ++pass) {
            for (int i = 0; i < j; ++i) {
                const float* q = col + i * rows;
                float part = 0.0f;
                for (int p = first; p < live; p += stride) {
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const size_t row = p + (size_t)h * n;
                        float x = v[row];
                        if (qp != nullptr) v[row] = x = x - c * qp[row];
                        part += q[row] * x;
                    }
                }
                c = cluster_sum(part, k++, warp_part, block_part);
                if (threadIdx.x == 0) r[i][j] = r[i][j] + c;
                qp = q;
            }
        }
        float part = 0.0f;
        for (int p = first; p < live; p += stride) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const size_t row = p + (size_t)h * n;
                float x = v[row];
                if (qp != nullptr) v[row] = x = x - c * qp[row];
                part += x * x;
            }
        }
        const float nj = sqrtf(cluster_sum(part, k++, warp_part, block_part));
        good = good && nj > 1e-12f;
        const float den = fmaxf(nj, 1e-30f);
        part = 0.0f;
        for (int p = first; p < live; p += stride) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const size_t row = p + (size_t)h * n;
                const float q = v[row] / den;
                v[row] = q;
                part += q * b[row];
            }
        }
        const float t = cluster_sum(part, k++, warp_part, block_part);
        if (threadIdx.x == 0) {
            r[j][j] = nj;
            qtb[j] = t;
        }
    }

    // R a = Q^T b, in the block of rank 0; every block holds the same R.
    if (cluster.block_rank() == 0 && threadIdx.x == 0) {
        float x[8];
#pragma unroll
        for (int j = 7; j >= 0; --j) {
            float s = qtb[j];
            if (j < 7) {
                float t = r[j][j + 1] * x[j + 1];
#pragma unroll
                for (int m = j + 2; m < 8; ++m) t += r[j][m] * x[m];
                s = s - t;
            }
            x[j] = s / fmaxf(r[j][j], 1e-30f);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            good = good && isfinite(x[j]);
            a[(size_t)wi * 8 + j] = x[j];
        }
        ok[wi] = good;
    }
    cluster.sync();                              // no block leaves while its partials are read
}

}  // namespace

// ya, yb (n, 8) with 16-byte aligned rows, w (num_w, n), bx, by (n,), all
// float32; num_pts a 0-d int32 on the device; work (num_w, 9, 2n) float32
// scratch; a (num_w, 8) float32 and ok (num_w,) bool out.
extern "C" int weighted_lstsq8(const float* ya, const float* yb, const float* w,
                               const float* bx, const float* by, int n, int num_w,
                               const int* num_pts, float* work, float* a, bool* ok,
                               cudaStream_t stream) {
    if (n < 0 || num_w < 0 || num_pts == nullptr) return (int)cudaErrorInvalidValue;
    if (num_w == 0) return (int)cudaSuccess;
    qr_kernel<<<dim3(CLUSTER, num_w), THREADS, 0, stream>>>(ya, yb, w, bx, by, n, num_pts,
                                                             work, a, ok);
    return (int)cudaGetLastError();
}
