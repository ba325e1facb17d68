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
// Bound: latency per keypoint, 4096 scattered image reads (through the
// cache; the taps of one keypoint touch a few hundred pixels, so the patch
// is not staged) and the 128 x 256 binning loop; a few thousand live
// keypoints per octave.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sift_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MARGIN = 22, P = 48, PW = 128;

__global__ void __launch_bounds__(THREADS)
descriptor_kernel(const float* __restrict__ img, int h, int w,
                  const float* __restrict__ xpos, const float* __restrict__ ypos,
                  const float* __restrict__ scale, const float* __restrict__ orientation,
                  const int* __restrict__ count, float* __restrict__ desc) {
    __shared__ sift::DescShared ds;
    const int k = blockIdx.x;
    const int t = threadIdx.x;
    float* out = desc + (size_t)k * 128;
    if (k >= *count) {
        if (t < 128) out[t] = 0.0f;
        return;
    }
    sift::fill_spatial_weights(ds, t);  // read after bin_and_write's first barrier

    const float x = xpos[k], y = ypos[k], sc = scale[k];
    const int ox = max((int)floorf(x) - MARGIN, 0);
    const int oy = max((int)floorf(y) - MARGIN, 0);
    const float gx = (float)(t % 16) - 7.5f, gy = (float)(t / 16) - 7.5f;
    const float lx0 = x - (float)ox, ly0 = y - (float)oy;
    const float s12 = 0.75f * sc;
    const float th = (float)(2.0 * 3.1415 / 360.0) * orientation[k];
    const float cosa = cosf(th), sina = sinf(th);
    const float xs = lx0 + gx * (s12 * cosa) - gy * (s12 * sina) + 0.5f;
    const float ys = ly0 + gx * (s12 * sina) + gy * (s12 * cosa) + 0.5f;
    const float tx[4] = {cosa, -cosa, -sina, sina};
    const float ty[4] = {sina, -sina, cosa, -cosa};
    float v[4];
    for (int j = 0; j < 4; ++j) {
        const float sx = fminf(fmaxf(xs + tx[j] - 0.5f, 0.0f), (float)PW - 1.0f);
        const float sy = fminf(fmaxf(ys + ty[j] - 0.5f, 0.0f), (float)P - 1.0f);
        const int p0 = (int)floorf(sy), q0 = (int)floorf(sx);
        const float wr0 = sift::tent(p0, sy), wr1 = sift::tent(p0 + 1, sy);
        const float wc0 = sift::tent(q0, sx), wc1 = sift::tent(q0 + 1, sx);
        const float* r0 = img + (size_t)min(oy + p0, h - 1) * w;
        const float* r1 = img + (size_t)min(oy + p0 + 1, h - 1) * w;
        const int c0 = min(ox + q0, w - 1), c1 = min(ox + q0 + 1, w - 1);
        const float top = r0[c0] * wc0 + r0[c1] * wc1;
        const float bot = r1[c0] * wc0 + r1[c1] * wc1;
        v[j] = wr0 * top + wr1 * bot;
    }
    sift::bin_and_write(ds, t, v[0] - v[1], v[2] - v[3], sift::grid_gauss(t), out);
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
