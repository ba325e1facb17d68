// K3: fused orientation + descriptor kernel, both peaks per keypoint.
//
// Replaces the TPU kernel
// cudasift_tpu/ops/pallas/orient_desc.py:orient_and_describe_pallas
// (_run_table -> _call_kernel -> _fused_kernel/_block_body). One block of
// 256 threads per keypoint slot; dead slots write zeros and leave. Per live
// keypoint:
//   1. the patch -- (P+1) x (PW+1) image values from the origin
//      max(floor(y) - margin, 0), edge-padded past the bottom/right border,
//      with (P, PW, margin) = (32, 32, 15) for scale <= 1.72, else
//      (48, 64, 22) -- staged in shared memory;
//   2. the 13x13 orientation grid, the patch bilinearly shifted by the
//      keypoint's subpixel fraction, integer index clamped to [0, 31];
//   3. central differences over the inner 11x11 window, Gaussian weights, a
//      32-bin histogram (one thread per bin, contributors summed in a fixed
//      order), [1,4,6,4,1] smoothing, two peaks with parabolic
//      interpolation, and a second orientation when its peak is >= 0.8 of
//      the first;
//   4. for each orientation, one thread per point of the rotated 16x16
//      grid: "shift" samples rotation-aligned gradient fields built from
//      fractional +-(cos, sin) shifts, "exact" takes 4 bilinear taps;
//   5. trilinear 4x4x8 binning (one thread per descriptor entry, samples in
//      a fixed order), then L2 -> clamp 0.2 -> L2 by a fixed-shape tree.
// No float atomics anywhere, so two runs are bit-identical. Arithmetic
// follows the plain version in ops/cuda/orient_desc.py; build with
// -fmad=false so coordinates and bins round alike.
//
// Bound: latency of one small block per keypoint (a few thousand live
// keypoints per octave); the patch is about 13 KB of shared memory and the
// arithmetic per keypoint is a few hundred thousand flops.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sift_common.cuh"

namespace {

using sift::atan2_poly;
using sift::tent;

constexpr int THREADS = 256;
constexpr int MAXP = 48, MAXPW = 64;

template <bool SHIFT>
__global__ void __launch_bounds__(THREADS)
orient_desc_kernel(const float* __restrict__ img, int h, int w,
                   const float* __restrict__ xpos, const float* __restrict__ ypos,
                   const float* __restrict__ scale, const uint8_t* __restrict__ live,
                   float* __restrict__ desc1, float* __restrict__ desc2,
                   float* __restrict__ ori1, float* __restrict__ ori2,
                   uint8_t* __restrict__ has2) {
    __shared__ float patch[MAXP + 1][MAXPW + 1];
    __shared__ float grid[13][13];
    __shared__ float wgt[121];
    __shared__ int bins[121];
    __shared__ float hist[32];
    __shared__ float oris[2];
    __shared__ int nori;
    __shared__ sift::DescShared ds;

    const int k = blockIdx.x;
    const int t = threadIdx.x;
    if (!live[k]) {
        if (t < 128) {
            desc1[(size_t)k * 128 + t] = 0.0f;
            desc2[(size_t)k * 128 + t] = 0.0f;
        }
        if (t == 0) {
            ori1[k] = 0.0f;
            ori2[k] = 0.0f;
            has2[k] = 0;
        }
        return;
    }

    // Sampling coordinates are clamped into the image box; the reported
    // positions are not touched.
    const float x = fminf(fmaxf(xpos[k], 0.0f), (float)(w - 1));
    const float y = fminf(fmaxf(ypos[k], 0.0f), (float)(h - 1));
    const float sc = scale[k];
    const bool small = sc <= 1.72f;
    const int margin = small ? 15 : 22;
    const int P = small ? 32 : 48;
    const int PW = small ? 32 : 64;
    const float flx = floorf(x), fly = floorf(y);
    const int ox = max((int)flx - margin, 0);
    const int oy = max((int)fly - margin, 0);

    // Phase 1: patch rows 0..P, cols 0..PW (one row/col past the patch so
    // every bilinear neighbour is a plain shared-memory read).
    for (int i = t; i < (P + 1) * (PW + 1); i += THREADS) {
        const int r = i / (PW + 1), c = i % (PW + 1);
        patch[r][c] = img[(size_t)min(oy + r, h - 1) * w + min(ox + c, w - 1)];
    }
    sift::fill_spatial_weights(ds, t);  // trilinear weights of grid sample t
    __syncthreads();

    // Phase 2: the 13x13 orientation grid.
    const float fx = x - flx, fy = y - fly;
    const int cbase = (int)flx - ox - 6, rbase = (int)fly - oy - 6;
    if (t < 169) {
        const int uy = t / 13, ux = t % 13;
        const int R = min(max(rbase + uy, 0), 31), C = min(max(cbase + ux, 0), 31);
        grid[uy][ux] = (1.0f - fy) * ((1.0f - fx) * patch[R][C] + fx * patch[R][C + 1])
                     + fy * ((1.0f - fx) * patch[R + 1][C] + fx * patch[R + 1][C + 1]);
    }
    __syncthreads();

    // Phase 3: weighted gradient histogram and its peaks.
    if (t < 121) {
        const int uy = t / 11, ux = t % 11;
        const float dx = grid[uy + 1][ux + 2] - grid[uy + 1][ux];
        const float dy = grid[uy + 2][ux + 1] - grid[uy][ux + 1];
        const float theta = atan2_poly(dy, dx);
        int b = (int)floorf(16.0f * theta / 3.1416f + 16.5f);
        bins[t] = b > 31 ? 0 : b;
        const float i2s2 = -1.0f / (4.5f * sc * sc);
        const float du = (float)(ux - 5), dv = (float)(uy - 5);
        const float dist2 = du * du + dv * dv;
        wgt[t] = sqrtf(dx * dx + dy * dy) * expf(i2s2 * dist2);
    }
    __syncthreads();
    if (t < 32) {
        float acc = 0.0f;
        for (int i = 0; i < 121; ++i)
            if (bins[i] == t) acc = acc + wgt[i];
        hist[t] = acc;
    }
    __syncthreads();
    if (t == 0) {
        float sm[32], peaks[32];
        for (int i = 0; i < 32; ++i)
            sm[i] = 6.0f * hist[i] + 4.0f * (hist[(i + 31) % 32] + hist[(i + 1) % 32])
                  + hist[(i + 30) % 32] + hist[(i + 2) % 32];
        for (int i = 0; i < 32; ++i)
            peaks[i] = (sm[i] > sm[(i + 31) % 32] && sm[i] >= sm[(i + 1) % 32]) ? sm[i] : 0.0f;
        int i1 = 0;
        for (int i = 1; i < 32; ++i)
            if (peaks[i] > peaks[i1]) i1 = i;
        int i2 = i1 == 0 ? 1 : 0;
        for (int i = 0; i < 32; ++i)
            if (i != i1 && peaks[i] > peaks[i2]) i2 = i;
        const float max1 = peaks[i1], max2 = peaks[i2];
        float o[2];
        const int ii[2] = {i1, i2};
        const float mm[2] = {max1, max2};
        for (int j = 0; j < 2; ++j) {
            const float v1 = sm[(ii[j] + 1) % 32], v2 = sm[(ii[j] + 31) % 32];
            const float denom = 2.0f * mm[j] - v1 - v2;
            float peak = (float)ii[j] + 0.5f * (v1 - v2) / (denom == 0.0f ? 1e-30f : denom);
            o[j] = 11.25f * (peak < 0.0f ? peak + 32.0f : peak);
        }
        const bool second = max2 > 0.8f * max1;
        oris[0] = o[0];
        oris[1] = o[1];
        nori = second ? 2 : 1;
        ori1[k] = o[0];
        ori2[k] = o[1];
        has2[k] = second ? 1 : 0;
    }
    __syncthreads();

    // Phases 4-5, once per orientation; thread t owns grid point t.
    const float gx = (float)(t % 16) - 7.5f, gy = (float)(t / 16) - 7.5f;
    const float lx0 = x - (float)ox, ly0 = y - (float)oy;
    const float s12 = 0.75f * sc;
    const float gweight = sift::grid_gauss(t);
    for (int o = 0; o < 2; ++o) {
        float* out = (o == 0 ? desc1 : desc2) + (size_t)k * 128;
        if (o >= nori) {
            if (t < 128) out[t] = 0.0f;
            break;
        }
        const float th = (float)(2.0 * 3.1415 / 360.0) * oris[o];
        const float cosa = cosf(th), sina = sinf(th);
        const float xs = lx0 + gx * (s12 * cosa) - gy * (s12 * sina) + 0.5f;
        const float ys = ly0 + gx * (s12 * sina) + gy * (s12 * cosa) + 0.5f;
        float dx, dy;
        if (SHIFT) {
            float hc[3], hs[3];
            for (int j = 0; j < 3; ++j) {
                hc[j] = fmaxf(1.0f - fabsf(cosa - (float)(j - 1)), 0.0f);
                hs[j] = fmaxf(1.0f - fabsf(sina - (float)(j - 1)), 0.0f);
            }
            float wx[3][3], wy[3][3];
            for (int jr = 0; jr < 3; ++jr)
                for (int jc = 0; jc < 3; ++jc) {
                    wx[jr][jc] = hs[jr] * hc[jc] - hs[2 - jr] * hc[2 - jc];
                    wy[jr][jc] = hc[jr] * hs[2 - jc] - hc[2 - jr] * hs[jc];
                }
            const float sx = fminf(fmaxf(xs - 0.5f, 1.0f), (float)PW - 2.0f);
            const float sy = fminf(fmaxf(ys - 0.5f, 1.0f), (float)P - 2.0f);
            const int p0 = (int)floorf(sy), q0 = (int)floorf(sx);
            const float wr0 = tent(p0, sy), wr1 = tent(p0 + 1, sy);
            const float wc0 = tent(q0, sx), wc1 = tent(q0 + 1, sx);
            float fxv[2][2], fyv[2][2];
            for (int a = 0; a < 2; ++a)
                for (int b = 0; b < 2; ++b) {
                    float ax = 0.0f, ay = 0.0f;
                    for (int jr = 0; jr < 3; ++jr)
                        for (int jc = 0; jc < 3; ++jc) {
                            const float v = patch[p0 + a + jr - 1][q0 + b + jc - 1];
                            ax = ax + wx[jr][jc] * v;
                            ay = ay + wy[jr][jc] * v;
                        }
                    fxv[a][b] = ax;
                    fyv[a][b] = ay;
                }
            dx = wr0 * (fxv[0][0] * wc0 + fxv[0][1] * wc1) + wr1 * (fxv[1][0] * wc0 + fxv[1][1] * wc1);
            dy = wr0 * (fyv[0][0] * wc0 + fyv[0][1] * wc1) + wr1 * (fyv[1][0] * wc0 + fyv[1][1] * wc1);
        } else {
            const float tx[4] = {cosa, -cosa, -sina, sina};
            const float ty[4] = {sina, -sina, cosa, -cosa};
            float v[4];
            for (int j = 0; j < 4; ++j) {
                const float sx = fminf(fmaxf(xs + tx[j] - 0.5f, 0.0f), (float)PW - 1.0f);
                const float sy = fminf(fmaxf(ys + ty[j] - 0.5f, 0.0f), (float)P - 1.0f);
                const int p0 = (int)floorf(sy), q0 = (int)floorf(sx);
                const float wr0 = tent(p0, sy), wr1 = tent(p0 + 1, sy);
                const float wc0 = tent(q0, sx), wc1 = tent(q0 + 1, sx);
                const float top = patch[p0][q0] * wc0 + patch[p0][q0 + 1] * wc1;
                const float bot = patch[p0 + 1][q0] * wc0 + patch[p0 + 1][q0 + 1] * wc1;
                v[j] = wr0 * top + wr1 * bot;
            }
            dx = v[0] - v[1];
            dy = v[2] - v[3];
        }
        sift::bin_and_write(ds, t, dx, dy, gweight, out);
    }
}

}  // namespace

extern "C" int orient_and_describe(const float* img, int h, int w, const float* xpos,
                                   const float* ypos, const float* scale,
                                   const uint8_t* live, int n, int shift,
                                   float* desc1, float* desc2, float* ori1,
                                   float* ori2, uint8_t* has2, cudaStream_t stream) {
    if (n == 0) return 0;
    if (shift)
        orient_desc_kernel<true><<<n, THREADS, 0, stream>>>(
            img, h, w, xpos, ypos, scale, live, desc1, desc2, ori1, ori2, has2);
    else
        orient_desc_kernel<false><<<n, THREADS, 0, stream>>>(
            img, h, w, xpos, ypos, scale, live, desc1, desc2, ori1, ori2, has2);
    return (int)cudaGetLastError();
}
