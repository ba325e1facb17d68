// K6: orientation histograms of front-packed keypoints, count-gated.
//
// Replaces the TPU kernel
// cudasift_tpu/ops/pallas/orient.py:orientation_histograms_pallas
// (_ori_kernel). One warp per keypoint slot, four slots per block; slots at
// or past the on-device count write zeros and leave. Per live keypoint:
//   1. the 13x13 grid of the patch bilinearly shifted once by the subpixel
//      fraction (fx, fy): the patch is 16x128 image values from the origin
//      max(floor(.) - 7, 0), edge-padded past the bottom/right border, and
//      the grid's integer index is clamped into it ([0, 15] x [0, 127]) with
//      the fraction kept. Positions are not clamped into the image first
//      (the fused kernel K3 clamps; this kernel follows its TPU twin);
//   2. central differences over the inner 11x11 window, atan2_poly bins
//      floor(16*theta/3.1416 + 16.5) (> 31 -> 0), Gaussian weights with
//      sigma = 1.5*scale;
//   3. the 32-bin histogram: lane b sums bin b's contributors in window
//      order, so there are no float atomics and two runs are bit-identical.
// Peak finding stays outside (ops/orient.py:histogram_peaks), as it is XLA
// in the JAX package. Arithmetic follows the plain version
// (ops/orient.py:keypoint_histograms with texture.SPLIT_ORIENT); build with
// -fmad=false so the two round alike.
//
// Bound: latency of scattered reads, 676 image reads and about 2.5 kflop per
// live keypoint, a few thousand keypoints per octave. The grid is read
// straight from the image through the cache (no shared-memory patch: the
// 169 samples touch at most 14x14 pixels), so one warp finishes a keypoint
// with three warp-synchronous steps and no block barrier.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sift_common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int MARGIN = 7, P = 16, PW = 128;

__global__ void __launch_bounds__(WARPS * 32)
orient_hist_kernel(const float* __restrict__ img, int h, int w,
                   const float* __restrict__ xpos, const float* __restrict__ ypos,
                   const float* __restrict__ scale, const int* __restrict__ count,
                   int n, float* __restrict__ hist) {
    __shared__ float grid[WARPS][169];
    __shared__ float wgt[WARPS][121];
    __shared__ int bins[WARPS][121];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int k = blockIdx.x * WARPS + warp;
    if (k >= n) return;
    float* out = hist + (size_t)k * 32;
    if (k >= *count) {
        out[lane] = 0.0f;
        return;
    }
    const float x = xpos[k], y = ypos[k], sc = scale[k];
    const float flx = floorf(x), fly = floorf(y);
    const int ox = max((int)flx - MARGIN, 0), oy = max((int)fly - MARGIN, 0);
    const float fx = x - flx, fy = y - fly;
    const int cbase = (int)flx - ox - 6, rbase = (int)fly - oy - 6;
    float* g = grid[warp];
    for (int i = lane; i < 169; i += 32) {
        const int uy = i / 13, ux = i % 13;
        const int R = min(max(rbase + uy, 0), P - 1), C = min(max(cbase + ux, 0), PW - 1);
        const float* r0 = img + (size_t)min(oy + R, h - 1) * w;
        const float* r1 = img + (size_t)min(oy + R + 1, h - 1) * w;
        const int c0 = min(ox + C, w - 1), c1 = min(ox + C + 1, w - 1);
        g[i] = (1.0f - fy) * ((1.0f - fx) * r0[c0] + fx * r0[c1])
             + fy * ((1.0f - fx) * r1[c0] + fx * r1[c1]);
    }
    __syncwarp();
    const float i2s2 = -1.0f / (4.5f * sc * sc);
    for (int i = lane; i < 121; i += 32) {
        const int uy = i / 11, ux = i % 11;
        const float dx = g[(uy + 1) * 13 + ux + 2] - g[(uy + 1) * 13 + ux];
        const float dy = g[(uy + 2) * 13 + ux + 1] - g[uy * 13 + ux + 1];
        const float theta = sift::atan2_poly(dy, dx);
        const int b = (int)floorf(16.0f * theta / 3.1416f + 16.5f);
        bins[warp][i] = b > 31 ? 0 : b;
        const float du = (float)(ux - 5), dv = (float)(uy - 5);
        const float dist2 = du * du + dv * dv;
        wgt[warp][i] = sqrtf(dx * dx + dy * dy) * expf(i2s2 * dist2);
    }
    __syncwarp();
    float acc = 0.0f;
    for (int i = 0; i < 121; ++i)
        if (bins[warp][i] == lane) acc = acc + wgt[warp][i];
    out[lane] = acc;
}

}  // namespace

extern "C" int orientation_histograms(const float* img, int h, int w, const float* xpos,
                                      const float* ypos, const float* scale,
                                      const int* count, int n, float* hist,
                                      cudaStream_t stream) {
    if (n == 0) return 0;
    orient_hist_kernel<<<(n + WARPS - 1) / WARPS, WARPS * 32, 0, stream>>>(
        img, h, w, xpos, ypos, scale, count, n, hist);
    return (int)cudaGetLastError();
}
