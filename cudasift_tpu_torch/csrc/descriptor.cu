// K7: exact 128-D descriptors of front-packed oriented keypoints,
// count-gated.
//
// Replaces the TPU kernel
// cudasift_tpu/ops/pallas/descriptor.py:extract_descriptors_pallas
// (_desc_kernel). One block of 256 threads per keypoint slot; slots at or
// past the on-device count write zeros and leave. Thread t owns point t of
// the 16x16 grid rotated by the keypoint's orientation, with spacing
// 0.75*scale and the reference's +0.5 shift. Its gradient comes from four
// bilinear taps at the rotated unit offsets +-(cos, sin) and +-(-sin, cos);
// each tap's coordinates are clipped to the keypoint's 48x128 patch
// ([0, 47] x [0, 127]) from the origin max(floor(.) - 22, 0), and the patch
// is edge-padded past the bottom/right image border. Positions are not
// clamped into the image first (the fused kernel K3 clamps; this kernel
// follows its TPU twin). Then the Gaussian window exp(-d^2/128), fast_atan2
// 8-bin trilinear binning and L2 -> clamp 0.2 -> L2, in float32 throughout
// (the TPU kernel samples on the MXU in bfloat16; that is its precision
// artefact, not reproduced). Sums run in a fixed order (sift_common.cuh), so
// two runs are bit-identical. Arithmetic follows the plain version
// (ops/descriptor.py:extract_descriptors with texture.SPLIT_DESC and the
// "exact" sampler); build with -fmad=false so the two round alike.
//
// Bound: a few thousand live keypoints per octave, one block each: the SM's
// issue rate and the latency of the scattered image reads. What the design
// does about it: the four taps' 16 image reads are all issued before the
// first is used (they go through the cache: the taps of one keypoint touch
// a few hundred pixels, so the patch is not staged); the binning walks only
// each entry's 8x8 window with compile-time weights on all 256 threads, two
// lanes an entry, in 16-byte reads (sift_common.cuh); the norms are shuffle
// trees. One barrier behind the samples and one a norm: three a block.
// Occupancy: shared memory is 10.2 KB a block; __launch_bounds__(256, 8)
// holds the kernel to 32 registers a thread (no spills), so the SM's 2048
// threads, 8 blocks, are the limit; left alone the compiler takes 64
// registers, and the kernel ran a tenth slower on an H100 at a few thousand
// live keypoints. Slots past the count are zeroed by one warp with 16-byte
// stores.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sift_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MIN_BLOCKS = 8;          // blocks an SM the registers are held to
constexpr int MARGIN = 22, P = 48, PW = 128;

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
descriptor_kernel(const float* __restrict__ img, int h, int w,
                  const float* __restrict__ xpos, const float* __restrict__ ypos,
                  const float* __restrict__ scale, const float* __restrict__ orientation,
                  const int* __restrict__ count, float* __restrict__ desc) {
    __shared__ sift::DescShared<1> ds;
    const int k = blockIdx.x;
    const int t = threadIdx.x;
    float* out = desc + (size_t)k * 128;
    if (k >= *count) {
        if (t < 32) reinterpret_cast<float4*>(out)[t] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        return;
    }

    const float x = xpos[k], y = ypos[k], sc = scale[k];
    const int ox = max((int)floorf(x) - MARGIN, 0);
    const int oy = max((int)floorf(y) - MARGIN, 0);
    const float gx = (float)(t % 16) - 7.5f, gy = (float)(t / 16) - 7.5f;
    const float lx0 = x - (float)ox, ly0 = y - (float)oy;
    const float s12 = 0.75f * sc;
    const float th = (float)(2.0 * 3.1415 / 360.0) * orientation[k];
    float sina, cosa;
    sincosf(th, &sina, &cosa);
    const float xs = lx0 + gx * (s12 * cosa) - gy * (s12 * sina) + 0.5f;
    const float ys = ly0 + gx * (s12 * sina) + gy * (s12 * cosa) + 0.5f;
    const float gweight = sift::grid_gauss(t);
    const float tx[4] = {cosa, -cosa, -sina, sina};
    const float ty[4] = {sina, -sina, cosa, -cosa};
    // Every tap's four image values first, then the arithmetic.
    float sx[4], sy[4], v00[4], v01[4], v10[4], v11[4];
    int p0[4], q0[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        sx[j] = fminf(fmaxf(xs + tx[j] - 0.5f, 0.0f), (float)PW - 1.0f);
        sy[j] = fminf(fmaxf(ys + ty[j] - 0.5f, 0.0f), (float)P - 1.0f);
        p0[j] = (int)floorf(sy[j]);
        q0[j] = (int)floorf(sx[j]);
        // An octave holds fewer than 2^31 pixels: 32-bit offsets.
        const int r0 = min(oy + p0[j], h - 1) * w, r1 = min(oy + p0[j] + 1, h - 1) * w;
        const int c0 = min(ox + q0[j], w - 1), c1 = min(ox + q0[j] + 1, w - 1);
        v00[j] = __ldg(img + r0 + c0);
        v01[j] = __ldg(img + r0 + c1);
        v10[j] = __ldg(img + r1 + c0);
        v11[j] = __ldg(img + r1 + c1);
    }
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const float wr0 = sift::tent(p0[j], sy[j]), wr1 = sift::tent(p0[j] + 1, sy[j]);
        const float wc0 = sift::tent(q0[j], sx[j]), wc1 = sift::tent(q0[j] + 1, sx[j]);
        const float top = v00[j] * wc0 + v01[j] * wc1;
        const float bot = v10[j] * wc0 + v11[j] * wc1;
        v[j] = wr0 * top + wr1 * bot;
    }
    sift::stage_sample(ds.smp[0], t, v[0] - v[1], v[2] - v[3], gweight);
    __syncthreads();
    sift::bin_and_write<true>(ds, t, out, nullptr);
}

}  // namespace

extern "C" int extract_descriptors(const float* img, int h, int w, const float* xpos,
                                   const float* ypos, const float* scale,
                                   const float* orientation, const int* count, int n,
                                   float* desc, cudaStream_t stream) {
    if (n == 0) return 0;
    descriptor_kernel<<<n, THREADS, 0, stream>>>(img, h, w, xpos, ypos, scale,
                                                 orientation, count, desc);
    return (int)cudaGetLastError();
}
