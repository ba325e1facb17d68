// K6: orientation histograms of front-packed keypoints and their two peaks,
// count-gated.
//
// Replaces the TPU kernel
// cudasift_tpu/ops/pallas/orient.py:orientation_histograms_pallas
// (_ori_kernel) and, in the same launch, the peak search that follows it in
// the split path (ops/orient.py:histogram_peaks; XLA inside the same program
// in the JAX package). One warp per keypoint slot, four slots per block;
// slots at or past the on-device count write zeros (has_second = 0) and
// leave. Per live keypoint:
//   1. the footprint: the 16 x 16 corner of the keypoint's patch, staged in
//      shared memory by one round of loads (half a warp a row, two rows a
//      step, the column clamp hoisted). The patch is the TPU kernel's: 16x128
//      image values from the origin max(floor(.) - 7, 0), edge-padded past
//      the bottom/right border. Positions are not clamped into the image
//      first (the fused kernel K3 clamps; this kernel follows its TPU twin);
//   2. the 13x13 grid, the patch bilinearly shifted once by the subpixel
//      fraction (fx, fy), its integer index clamped into the patch with the
//      fraction kept. The index of grid entry 0 is at most 1 (the origin
//      follows the keypoint), so the grid and its +1 neighbours lie in patch
//      rows and columns 0..14, inside the staged corner: only the clamp at 0
//      ever binds, and [0, 14] here equals the patch's [0, 15] x [0, 127];
//   3. central differences over the inner 11x11 window, atan2_poly bins,
//      weights magnitude * exp(-dist2 / (2 (1.5 scale)^2)); the Gaussian is
//      taken once for each of the 51 values dist2 can have, not per sample.
//      A lane keeps its four samples (lane, lane + 32, ...) in registers;
//   4. the 32-bin histogram through a column a lane: the warp's (32 bins x
//      32 lanes) table in shared memory is zeroed with 16-byte stores, each
//      lane adds its samples into its own column in sample order (no two
//      lanes share an entry), and lane b then adds row b over the lanes in
//      lane order. About a hundred instructions a keypoint, the zeroing
//      hidden behind the image loads; handing every sample round by
//      shuffles, as K3's four warps do for theirs (orient_desc.cu),
//      costs one warp 256 shuffles and left this kernel no faster than the
//      design before it. No float atomics: two runs are bit-identical;
//   5. the peak search on the same warp with lane = bin (sift::find_peaks,
//      the device code K3 runs): primary and secondary orientation in
//      degrees and whether the second peak counts.
// Arithmetic follows the plain version (ops/orient.py:keypoint_histograms
// with texture.SPLIT_ORIENT, then histogram_peaks); build with -fmad=false so
// the two round alike.
//
// Bound: a few thousand live keypoints an octave at several hundred warp
// instructions each (the divisions of the angle and the bin among them); the
// image is read once (256 values a keypoint in 8 loads a lane, issued with
// the position's loads before the count is known), and nothing but the
// results goes back to device memory. On an H100 the launch, the count's
// read and the dead slots' stores take 2.0 of the kernel's 7 microseconds at
// 2928 live slots of 5120, a live warp's chain (two dependent round trips to
// device memory, then the arithmetic) about 2.5, and the rest grows with the
// live count at about 0.9 ns a keypoint. 6.0 KB of shared memory a warp.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sift_common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int MARGIN = 7;
constexpr int SIDE = 16;               // staged rows and columns of the patch
constexpr int MAX_DIST2 = 50;          // 5 * 5 + 5 * 5
constexpr int ROW = 33;                // floats between two bins of the table
constexpr int TABLE = 32 * ROW;        // 1056 floats, a multiple of 4
constexpr int SCRATCH = SIDE * SIDE + 13 * 13 + 3 + 64;   // patch, grid (padded), Gaussian
static_assert(TABLE % 4 == 0 && (TABLE + SCRATCH) % 4 == 0, "16-byte rows");

template <bool PEAKS>
__global__ void __launch_bounds__(WARPS * 32)
orient_kernel(const float* __restrict__ img, int h, int w,
              const float* __restrict__ xpos, const float* __restrict__ ypos,
              const float* __restrict__ scale, const int* __restrict__ count,
              int n, float* __restrict__ hist, float* __restrict__ ori1,
              float* __restrict__ ori2, uint8_t* __restrict__ has2) {
    // A warp's shared memory: the histogram table, then the patch, the grid
    // and the Gaussian.
    __shared__ __align__(16) float smem[WARPS][TABLE + SCRATCH];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int k = blockIdx.x * WARPS + warp;
    if (k >= n) return;
    // The position before the count is known: slot k exists either way.
    const float x = __ldg(xpos + k), y = __ldg(ypos + k), sc = __ldg(scale + k);
    float* out = hist + (size_t)k * 32;
    if (k >= *count) {
        out[lane] = 0.0f;
        if (PEAKS && lane == 0) {
            ori1[k] = 0.0f;
            ori2[k] = 0.0f;
            has2[k] = 0;
        }
        return;
    }
    float* table = smem[warp];
    float (*patch)[SIDE] = reinterpret_cast<float (*)[SIDE]>(table + TABLE);
    float* g = table + TABLE + SIDE * SIDE;
    float* gauss = g + 13 * 13 + 3;
    const float flx = floorf(x), fly = floorf(y);
    const int ox = max((int)flx - MARGIN, 0), oy = max((int)fly - MARGIN, 0);
    const float fx = x - flx, fy = y - fly;
    const int cbase = (int)flx - ox - 6, rbase = (int)fly - oy - 6;

    // The footprint: lane -> column lane % 16 of rows lane / 16, + 2, ...
    const int prow = lane >> 4, pcol = lane & 15;
    const float* column = img + min(ox + pcol, w - 1);
    float v[SIDE / 2];
#pragma unroll
    for (int j = 0; j < SIDE / 2; ++j)
        v[j] = __ldg(column + (size_t)min(oy + 2 * j + prow, h - 1) * w);
    // While the loads are in flight: the table zeroed, and the Gaussian of
    // every squared distance.
    const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int i = lane; i < TABLE / 4; i += 32) reinterpret_cast<float4*>(table)[i] = zero4;
    const float i2s2 = -1.0f / (4.5f * sc * sc);
    gauss[lane] = expf(i2s2 * (float)lane);
    if (lane + 32 <= MAX_DIST2) gauss[lane + 32] = expf(i2s2 * (float)(lane + 32));
#pragma unroll
    for (int j = 0; j < SIDE / 2; ++j) patch[2 * j + prow][pcol] = v[j];
    __syncwarp();

#pragma unroll
    for (int i = lane; i < 169; i += 32) {
        const int uy = i / 13, ux = i - 13 * uy;
        const int R = min(max(rbase + uy, 0), SIDE - 2), C = min(max(cbase + ux, 0), SIDE - 2);
        const float* p0 = &patch[R][C];
        const float* p1 = p0 + SIDE;
        g[i] = (1.0f - fy) * ((1.0f - fx) * p0[0] + fx * p0[1])
             + fy * ((1.0f - fx) * p1[0] + fx * p1[1]);
    }
    __syncwarp();

    int bin[4];
    float wgt[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const int i = lane + 32 * r;
        bin[r] = -1;
        wgt[r] = 0.0f;
        if (i < 121) {
            const int uy = i / 11, ux = i - 11 * uy;
            const float dx = g[(uy + 1) * 13 + ux + 2] - g[(uy + 1) * 13 + ux];
            const float dy = g[(uy + 2) * 13 + ux + 1] - g[uy * 13 + ux + 1];
            bin[r] = sift::orientation_bin(dy, dx);
            const int du = ux - 5, dv = uy - 5;
            wgt[r] = sqrtf(dx * dx + dy * dy) * gauss[du * du + dv * dv];
        }
    }

    // The table, entry (bin, lane) at bin * ROW + lane: ROW = 33 keeps both
    // a lane's walk down its column and lane b's walk along row b off each
    // other's banks. It was zeroed before the first __syncwarp.
#pragma unroll
    for (int r = 0; r < 4; ++r)
        if (bin[r] >= 0) {
            float* entry = table + bin[r] * ROW + lane;
            *entry = *entry + wgt[r];
        }
    __syncwarp();
    float hv = 0.0f;
#pragma unroll
    for (int l = 0; l < 32; ++l) hv = hv + table[lane * ROW + l];
    out[lane] = hv;
    if (PEAKS) {
        float o0, o1;
        int nori;
        sift::find_peaks(hv, lane, o0, o1, nori);
        if (lane == 0) {
            ori1[k] = o0;
            ori2[k] = o1;
            has2[k] = nori == 2 ? 1 : 0;
        }
    }
}

}  // namespace

// Histograms and peaks of n slots in one launch; with ori1 null the peak
// search is left out and only the histograms are written.
extern "C" int orientation_peaks(const float* img, int h, int w, const float* xpos,
                                 const float* ypos, const float* scale, const int* count,
                                 int n, float* hist, float* ori1, float* ori2,
                                 uint8_t* has2, cudaStream_t stream) {
    if (n == 0) return 0;
    const int blocks = (n + WARPS - 1) / WARPS;
    if (ori1 == nullptr)
        orient_kernel<false><<<blocks, WARPS * 32, 0, stream>>>(
            img, h, w, xpos, ypos, scale, count, n, hist, nullptr, nullptr, nullptr);
    else
        orient_kernel<true><<<blocks, WARPS * 32, 0, stream>>>(
            img, h, w, xpos, ypos, scale, count, n, hist, ori1, ori2, has2);
    return (int)cudaGetLastError();
}

extern "C" int orientation_histograms(const float* img, int h, int w, const float* xpos,
                                      const float* ypos, const float* scale,
                                      const int* count, int n, float* hist,
                                      cudaStream_t stream) {
    return orientation_peaks(img, h, w, xpos, ypos, scale, count, n, hist, nullptr, nullptr,
                             nullptr, stream);
}
