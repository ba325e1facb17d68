// K3: fused orientation + descriptor kernel, both peaks per keypoint.
//
// Replaces the TPU kernel
// cudasift_tpu/ops/pallas/orient_desc.py:orient_and_describe_pallas
// (_run_table -> _call_kernel -> _fused_kernel/_block_body). One block of
// 256 threads per keypoint slot; a dead slot's zeros are written by one warp
// with 16-byte stores. Per live keypoint:
//   1. the patch -- (P+1) x (PW+1) image values from the origin
//      max(floor(y) - margin, 0), edge-padded past the bottom/right border,
//      with (P, PW, margin) = (32, 32, 15) for scale <= 1.72, else
//      (48, 64, 22) -- staged in shared memory a warp per row, clamps
//      hoisted, every load issued before the first barrier;
//   2. the 13x13 orientation grid, the patch bilinearly shifted by the
//      keypoint's subpixel fraction, integer index clamped to [0, 31];
//      each of the 121 gradient threads takes its four grid values straight
//      from the patch (no grid in shared memory, no barrier for it);
//   3. central differences over the inner 11x11 window, Gaussian weights, a
//      32-bin histogram: warps 0-3 each bin their own 32 samples, handed
//      from lane to lane by shuffles in lane order, lane b keeping bin b;
//      the four partial histograms are added in warp order. Warp 0 then
//      searches the peaks with lane = bin: [1,4,6,4,1] smoothing from the
//      four neighbour lanes, two warp arg-max reductions in which the
//      lowest bin wins a tie (the second over the bins other than the
//      first), parabolic interpolation on the winners, and a second
//      orientation when its peak is >= 0.8 of the first; its lanes 0 and 1
//      prepare what all grid points of an orientation share (cos, sin, the
//      shift sampler's two 3x3 stencils) and leave it in shared memory;
//   4. one thread per point of the rotated 16x16 grid, for the one or two
//      orientations in turn: "shift" samples rotation-aligned gradient
//      fields built from fractional +-(cos, sin) shifts (the four 3x3
//      stencils of a point's bilinear neighbours cover one 4x4 window, read
//      once), "exact" takes 4 bilinear taps, "fast" samples the unrotated
//      central-difference fields of the staged patch
//      (I[p][q+1] - I[p][q-1], I[p+1][q] - I[p-1][q]) with the shift
//      mode's clip and rotates the two sums into the keypoint frame (the
//      TPU kernel rounds these fields to bf16; here they stay float32);
//   5. trilinear 4x4x8 binning over each entry's 8x8 window and L2 -> clamp
//      0.2 -> L2 by shuffle trees (sift_common.cuh): with one orientation
//      two lanes an entry, with two orientations both descriptors side by
//      side, one thread an entry, in one pass.
// No float atomics anywhere, so two runs are bit-identical. Arithmetic
// follows the plain version in ops/cuda/orient_desc.py; build with
// -fmad=false so coordinates and bins round alike.
//
// Bound: with a few live keypoints the latency of one block's chain, with a
// few thousand (the main path) the SM's issue and shared-memory rate, so
// the design shortens the chain (six barriers a live block: patch, partial
// histograms, orientations, samples, two norms), keeps block-wide work off
// values that one warp can prepare, and reads shared memory in 16-byte
// words where it can. Occupancy: shared memory is 33.5 KB a block (the
// patch at its larger size 12.7 KB, two descriptors' sample planes 20.3 KB,
// partial histograms, rotations and norm sums 0.5 KB), which allows 6
// blocks an SM; __launch_bounds__(256, 6) holds the kernel to 40 registers
// a thread for the same 6 blocks (48 warps), without spills in any
// sampler. On an H100 at a few thousand live keypoints 6 blocks ran faster
// than 4 or 5 (56 and 48 registers); at 7 and 8 (32 registers) the shift
// sampler spills and the kernel is slower again.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sift_common.cuh"

namespace {

using sift::FULL_MASK;
using sift::tent;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAXP = 48, MAXPW = 64;
constexpr int MIN_BLOCKS = 6;          // blocks an SM the registers are held to

enum Mode { EXACT = 0, SHIFT = 1, FAST = 2 };

typedef float Patch[MAXP + 1][MAXPW + 1];

// What every grid point of one orientation shares: the rotation and, for
// the shift sampler, the two 3x3 stencils of the rotation-aligned fields.
struct alignas(16) Rotation {
    float cosa, sina;
    float wx[3][3], wy[3][3];
};

// Rows 0..P and columns 0..PW of the patch at image origin (oy, ox): warp
// `warp` takes rows warp, warp + 8, ..., a lane the columns lane, lane + 32;
// the last row and the last column, the one past the patch that makes every
// bilinear neighbour a plain read, go to the first P + PW + 1 threads.
template <int P, int PW>
__device__ __forceinline__ void stage_patch(Patch& patch, const float* __restrict__ img,
                                            int h, int w, int oy, int ox, int t) {
    const int lane = t & 31, warp = t >> 5;
    int col[PW / 32];
#pragma unroll
    for (int j = 0; j < PW / 32; ++j) col[j] = min(ox + lane + 32 * j, w - 1);
    float v[P / WARPS][PW / 32];
#pragma unroll
    for (int i = 0; i < P / WARPS; ++i) {
        const float* row = img + (size_t)min(oy + warp + WARPS * i, h - 1) * w;
#pragma unroll
        for (int j = 0; j < PW / 32; ++j) v[i][j] = __ldg(row + col[j]);
    }
    // Row P: columns 0..PW; then column PW: rows 0..P-1.
    const bool edge = t < P + PW + 1;
    const int er = t <= PW ? P : t - (PW + 1);
    const int ec = t <= PW ? t : PW;
    float ev = 0.0f;
    if (edge) ev = __ldg(img + (size_t)min(oy + er, h - 1) * w + min(ox + ec, w - 1));
#pragma unroll
    for (int i = 0; i < P / WARPS; ++i)
#pragma unroll
        for (int j = 0; j < PW / 32; ++j) patch[warp + WARPS * i][lane + 32 * j] = v[i][j];
    if (edge) patch[er][ec] = ev;
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
orient_desc_kernel(const float* __restrict__ img, int h, int w,
                   const float* __restrict__ xpos, const float* __restrict__ ypos,
                   const float* __restrict__ scale, const uint8_t* __restrict__ live,
                   float* __restrict__ desc1, float* __restrict__ desc2,
                   float* __restrict__ ori1, float* __restrict__ ori2,
                   uint8_t* __restrict__ has2) {
    __shared__ Patch patch;
    __shared__ float part[4][32];        // partial histograms of warps 0-3
    __shared__ Rotation rot[2];          // the one or two orientations, from warp 0
    __shared__ int found;                // their number
    __shared__ sift::DescShared<2> ds;

    const int k = blockIdx.x;
    const int t = threadIdx.x;
    const int lane = t & 31, warp = t >> 5;
    float4* row1 = reinterpret_cast<float4*>(desc1 + (size_t)k * 128);
    float4* row2 = reinterpret_cast<float4*>(desc2 + (size_t)k * 128);
    const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (!live[k]) {
        if (t < 32) {
            row1[t] = zero4;
            row2[t] = zero4;
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

    // Phase 1: the patch.
    if (small)
        stage_patch<32, 32>(patch, img, h, w, oy, ox, t);
    else
        stage_patch<48, 64>(patch, img, h, w, oy, ox, t);
    __syncthreads();

    // Phases 2-3: gradients of the 13x13 grid's inner 11x11 window on
    // threads 0..120, binned by warps 0-3.
    if (warp < 4) {
        int bin = -1;
        float wgt = 0.0f;
        if (t < 121) {
            const float fx = x - flx, fy = y - fly;
            const int cbase = (int)flx - ox - 6, rbase = (int)fly - oy - 6;
            const int uy = t / 11, ux = t % 11;
            auto grid = [&](int gy, int gx) {
                const int R = min(max(rbase + gy, 0), 31), C = min(max(cbase + gx, 0), 31);
                return (1.0f - fy) * ((1.0f - fx) * patch[R][C] + fx * patch[R][C + 1])
                     + fy * ((1.0f - fx) * patch[R + 1][C] + fx * patch[R + 1][C + 1]);
            };
            const float dx = grid(uy + 1, ux + 2) - grid(uy + 1, ux);
            const float dy = grid(uy + 2, ux + 1) - grid(uy, ux + 1);
            bin = sift::orientation_bin(dy, dx);
            const float i2s2 = -1.0f / (4.5f * sc * sc);
            const float du = (float)(ux - 5), dv = (float)(uy - 5);
            const float dist2 = du * du + dv * dv;
            wgt = sqrtf(dx * dx + dy * dy) * expf(i2s2 * dist2);
        }
        float acc = 0.0f;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            const int bi = __shfl_sync(FULL_MASK, bin, i);
            const float wi = __shfl_sync(FULL_MASK, wgt, i);
            if (bi == lane) acc = acc + wi;
        }
        part[warp][lane] = acc;
    }
    __syncthreads();

    // Peaks on warp 0, lane = bin; lanes 0 and 1 then prepare one
    // orientation's rotation each.
    if (warp == 0) {
        float o0, o1;
        int n;
        const float hist = ((part[0][lane] + part[1][lane]) + part[2][lane]) + part[3][lane];
        sift::find_peaks(hist, lane, o0, o1, n);
        if (lane < 2) {
            const float th = (float)(2.0 * 3.1415 / 360.0) * (lane == 0 ? o0 : o1);
            Rotation& r = rot[lane];
            float sina, cosa;
            sincosf(th, &sina, &cosa);
            r.cosa = cosa;
            r.sina = sina;
            if (MODE == SHIFT) {
                float hc[3], hs[3];
#pragma unroll
                for (int j = 0; j < 3; ++j) {
                    hc[j] = fmaxf(1.0f - fabsf(cosa - (float)(j - 1)), 0.0f);
                    hs[j] = fmaxf(1.0f - fabsf(sina - (float)(j - 1)), 0.0f);
                }
#pragma unroll
                for (int jr = 0; jr < 3; ++jr)
#pragma unroll
                    for (int jc = 0; jc < 3; ++jc) {
                        r.wx[jr][jc] = hs[jr] * hc[jc] - hs[2 - jr] * hc[2 - jc];
                        r.wy[jr][jc] = hc[jr] * hs[2 - jc] - hc[2 - jr] * hs[jc];
                    }
            }
        }
        if (lane == 0) {
            found = n;
            ori1[k] = o0;
            ori2[k] = o1;
            has2[k] = n == 2 ? 1 : 0;
        }
    }
    __syncthreads();
    const int nori = found;
    if (nori == 1 && t < 32) row2[t] = zero4;

    // Phase 4: thread t owns grid point t, for each orientation in turn.
    const float gx = (float)(t % 16) - 7.5f, gy = (float)(t / 16) - 7.5f;
    const float lx0 = x - (float)ox, ly0 = y - (float)oy;
    const float s12 = 0.75f * sc;
    const float gweight = sift::grid_gauss(t);
#pragma unroll 1
    for (int o = 0; o < nori; ++o) {
        const Rotation& r = rot[o];
        const float cosa = r.cosa, sina = r.sina;
        const float xs = lx0 + gx * (s12 * cosa) - gy * (s12 * sina) + 0.5f;
        const float ys = ly0 + gx * (s12 * sina) + gy * (s12 * cosa) + 0.5f;
        float dx, dy;
        if (MODE == SHIFT) {
            const float sx = fminf(fmaxf(xs - 0.5f, 1.0f), (float)PW - 2.0f);
            const float sy = fminf(fmaxf(ys - 0.5f, 1.0f), (float)P - 2.0f);
            const int p0 = (int)floorf(sy), q0 = (int)floorf(sx);
            const float wr0 = tent(p0, sy), wr1 = tent(p0 + 1, sy);
            const float wc0 = tent(q0, sx), wc1 = tent(q0 + 1, sx);
            // The 4x4 window under the four neighbours' 3x3 stencils.
            float win[4][4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) win[i][j] = patch[p0 - 1 + i][q0 - 1 + j];
            // Taps outermost, so that a stencil weight is read once and
            // dropped; each of the eight sums still takes its taps in
            // row-major order.
            float fxv[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
            float fyv[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
            for (int jr = 0; jr < 3; ++jr)
#pragma unroll
                for (int jc = 0; jc < 3; ++jc) {
                    const float wxv = r.wx[jr][jc], wyv = r.wy[jr][jc];
#pragma unroll
                    for (int a = 0; a < 2; ++a)
#pragma unroll
                        for (int b = 0; b < 2; ++b) {
                            const float v = win[a + jr][b + jc];
                            fxv[a][b] = fxv[a][b] + wxv * v;
                            fyv[a][b] = fyv[a][b] + wyv * v;
                        }
                }
            dx = wr0 * (fxv[0][0] * wc0 + fxv[0][1] * wc1) + wr1 * (fxv[1][0] * wc0 + fxv[1][1] * wc1);
            dy = wr0 * (fyv[0][0] * wc0 + fyv[0][1] * wc1) + wr1 * (fyv[1][0] * wc0 + fyv[1][1] * wc1);
        } else if (MODE == FAST) {
            const float sx = fminf(fmaxf(xs - 0.5f, 1.0f), (float)PW - 2.0f);
            const float sy = fminf(fmaxf(ys - 0.5f, 1.0f), (float)P - 2.0f);
            const int p0 = (int)floorf(sy), q0 = (int)floorf(sx);
            const float wr0 = tent(p0, sy), wr1 = tent(p0 + 1, sy);
            const float wc0 = tent(q0, sx), wc1 = tent(q0 + 1, sx);
            // Central differences at the four bilinear neighbours; p0 + 1 <= P - 1
            // and q0 + 1 <= PW - 1, so every read lies in the staged patch.
            float gxv[2][2], gyv[2][2];
#pragma unroll
            for (int a = 0; a < 2; ++a)
#pragma unroll
                for (int b = 0; b < 2; ++b) {
                    const int p = p0 + a, q = q0 + b;
                    gxv[a][b] = patch[p][q + 1] - patch[p][q - 1];
                    gyv[a][b] = patch[p + 1][q] - patch[p - 1][q];
                }
            const float sgx = wr0 * (gxv[0][0] * wc0 + gxv[0][1] * wc1) + wr1 * (gxv[1][0] * wc0 + gxv[1][1] * wc1);
            const float sgy = wr0 * (gyv[0][0] * wc0 + gyv[0][1] * wc1) + wr1 * (gyv[1][0] * wc0 + gyv[1][1] * wc1);
            dx = cosa * sgx + sina * sgy;
            dy = cosa * sgy - sina * sgx;
        } else {
            const float tx[4] = {cosa, -cosa, -sina, sina};
            const float ty[4] = {sina, -sina, cosa, -cosa};
            float v[4];
#pragma unroll
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
        sift::stage_sample(ds.smp[o], t, dx, dy, gweight);
    }
    __syncthreads();

    // Phase 5: one descriptor on two lanes an entry, or two side by side.
    float* out1 = desc1 + (size_t)k * 128;
    float* out2 = desc2 + (size_t)k * 128;
    if (nori == 1)
        sift::bin_and_write<true>(ds, t, out1, out2);
    else
        sift::bin_and_write<false>(ds, t, out1, out2);
}

}  // namespace

extern "C" int orient_and_describe(const float* img, int h, int w, const float* xpos,
                                   const float* ypos, const float* scale,
                                   const uint8_t* live, int n, int mode,
                                   float* desc1, float* desc2, float* ori1,
                                   float* ori2, uint8_t* has2, cudaStream_t stream) {
    if (n == 0) return 0;
    if (mode == SHIFT)
        orient_desc_kernel<SHIFT><<<n, THREADS, 0, stream>>>(
            img, h, w, xpos, ypos, scale, live, desc1, desc2, ori1, ori2, has2);
    else if (mode == FAST)
        orient_desc_kernel<FAST><<<n, THREADS, 0, stream>>>(
            img, h, w, xpos, ypos, scale, live, desc1, desc2, ori1, ori2, has2);
    else if (mode == EXACT)
        orient_desc_kernel<EXACT><<<n, THREADS, 0, stream>>>(
            img, h, w, xpos, ypos, scale, live, desc1, desc2, ori1, ori2, has2);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}
