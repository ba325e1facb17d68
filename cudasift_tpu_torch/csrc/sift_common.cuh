// Device code shared by the orientation and descriptor kernels (K3, K6, K7):
// the two atan2 polynomials, the tent weight of a bilinear sample, and the
// descriptor's trilinear 4x4x8 binning with L2 -> clamp 0.2 -> L2.
//
// Arithmetic follows the plain versions in ops/texture.py and
// ops/descriptor.py; the including kernels build with -fmad=false so the
// two round alike.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace sift {

// Octant-reduced minimax atan2, |err| < 1e-6 rad (texture.atan2_poly).
__device__ __forceinline__ float atan2_poly(float y, float x) {
    const float absx = fabsf(x), absy = fabsf(y);
    const float mx = fmaxf(absx, absy), mn = fminf(absx, absy);
    const float z = mn / (mx == 0.0f ? 1.0f : mx);
    const float s = z * z;
    float r = -0.0040540580f;
    r = r * s + 0.0218612288f;
    r = r * s + -0.0559098861f;
    r = r * s + 0.0964200441f;
    r = r * s + -0.1390853351f;
    r = r * s + 0.1994653599f;
    r = r * s + -0.3332985605f;
    r = r * s + 0.9999993329f;
    r = r * z;
    if (absy > absx) r = 1.5707963268f - r;
    if (x < 0.0f) r = 3.1415926536f - r;
    return y < 0.0f ? -r : r;
}

// The reference's FastAtan2 (cudaSiftD.cu:295-306; texture.fast_atan2).
__device__ __forceinline__ float fast_atan2(float y, float x) {
    const float absx = fabsf(x), absy = fabsf(y);
    const float mx = fmaxf(absx, absy), mn = fminf(absx, absy);
    const float a = mn / (mx == 0.0f ? 1.0f : mx);
    const float s = a * a;
    float r = ((-0.0464964749f * s + 0.15931422f) * s - 0.327622764f) * s * a + a;
    if (absy > absx) r = 1.57079637f - r;
    if (x < 0.0f) r = 3.14159274f - r;
    return y < 0.0f ? -r : r;
}

__device__ __forceinline__ float tent(int p, float s) {
    return fmaxf(1.0f - fabsf((float)p - s), 0.0f);
}

// Shared memory of the descriptor binning; one 256-thread block, thread t
// owns grid point t of the 16x16 grid.
struct DescShared {
    float wsp[16][256];          // trilinear spatial weight of sample s, cell rc
    float g1s[256], g2s[256];    // gradient magnitude split over two angle bins
    int ais[256], aps[256];      // the two angle bins
    float desc[128], red[128];
};

// Fill the spatial weights of grid sample t for the 16 cells
// (descriptor.spatial_weights).
__device__ __forceinline__ void fill_spatial_weights(DescShared& s, int t) {
    const float gx = (float)(t % 16) - 7.5f, gy = (float)(t / 16) - 7.5f;
    const float cy = floorf((gy + 7.5f + 2.0f) / 4.0f) - 1.0f;
    const float fy = (gy + 7.5f - 1.5f) / 4.0f - cy;
    const float cx = floorf((gx + 7.5f + 2.0f) / 4.0f) - 1.0f;
    const float fx = (gx + 7.5f - 1.5f) / 4.0f - cx;
    for (int rc = 0; rc < 16; ++rc) {
        const float r = (float)(rc / 4), c = (float)(rc % 4);
        const float wr = (cy == r ? 1.0f - fy : 0.0f) + (cy + 1.0f == r ? fy : 0.0f);
        const float wc = (cx == c ? 1.0f - fx : 0.0f) + (cx + 1.0f == c ? fx : 0.0f);
        s.wsp[rc][t] = wr * wc;
    }
}

// Gaussian window exp(-d^2/128) of grid sample t.
__device__ __forceinline__ float grid_gauss(int t) {
    const float gx = (float)(t % 16) - 7.5f, gy = (float)(t / 16) - 7.5f;
    return expf(-(gx * gx + gy * gy) / 128.0f);
}

// Bin the gradient (dx, dy) of every grid sample into the 128 descriptor
// entries (one thread per entry, samples in a fixed order), normalise
// L2 -> clamp 0.2 -> L2 by a fixed-shape tree, and write out[0..127]. Every
// thread of the block calls it (it synchronises); s.wsp must be filled.
__device__ __forceinline__ void bin_and_write(DescShared& s, int t, float dx, float dy,
                                              float gweight, float* out) {
    const float grad = sqrtf(dx * dx + dy * dy) * gweight;
    const float angf = (float)(4.0 / 3.1415) * fast_atan2(dy, dx) + 4.0f;
    const float angi_raw = floorf(angf);
    const float frac = angf - angi_raw;
    const int ai = (((int)angi_raw % 8) + 8) % 8;
    s.g1s[t] = grad * (1.0f - frac);
    s.g2s[t] = grad * frac;
    s.ais[t] = ai;
    s.aps[t] = ai == 7 ? 0 : ai + 1;
    __syncthreads();
    if (t < 128) {
        const int rc = t / 8, a = t % 8;
        float acc = 0.0f;
        for (int k = 0; k < 256; ++k) {
            const float ws = s.wsp[rc][k];
            if (ws == 0.0f) continue;
            const float ga = (s.ais[k] == a ? s.g1s[k] : 0.0f) + (s.aps[k] == a ? s.g2s[k] : 0.0f);
            acc = acc + ws * ga;
        }
        s.desc[t] = acc;
        s.red[t] = acc * acc;
    }
    __syncthreads();
    for (int half = 64; half > 0; half /= 2) {
        if (t < half) s.red[t] = s.red[t] + s.red[t + half];
        __syncthreads();
    }
    const float n1 = 1.0f / sqrtf(fmaxf(s.red[0], 1e-30f));
    __syncthreads();
    float t1 = 0.0f;
    if (t < 128) {
        t1 = fminf(s.desc[t] * n1, 0.2f);
        s.red[t] = t1 * t1;
    }
    __syncthreads();
    for (int half = 64; half > 0; half /= 2) {
        if (t < half) s.red[t] = s.red[t] + s.red[t + half];
        __syncthreads();
    }
    const float n2 = 1.0f / sqrtf(fmaxf(s.red[0], 1e-30f));
    if (t < 128) out[t] = t1 * n2;
    __syncthreads();
}

}  // namespace sift
