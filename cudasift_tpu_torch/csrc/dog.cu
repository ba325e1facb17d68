// K1: fused scale-space kernel for one octave base -- 8 separable 9-tap
// clamp-to-edge Gaussian blurs, 7 DoG planes, and the strict 3x3x3 extremum
// mask over DoG planes 1-5 with |DoG| > thresh and the edge-response test.
//
// Replaces the TPU kernel cudasift_tpu/ops/pallas/dog.py:dog_and_mask_pallas
// (_dog_kernel). One block per 16x32 output tile: the (tile + 2*5) clamped
// input rows/cols are staged once in shared memory, the vertical and
// horizontal passes of each scale run out of shared memory over the tile
// plus a 1-pixel halo, and the DoG planes of that halo feed the extremum and
// edge tests without another read of device memory.
//
// Arithmetic order is that of ops/convolve.blur_multi (vertical, then
// horizontal, taps 0..8, each product rounded before the add) and of
// ops/detect.extrema_mask; build with -fmad=false so no multiply-add is
// contracted and the kernel matches its plain version bit for bit.
//
// Bound: device memory. Per pixel it reads 4 bytes and writes 7*4 (DoG) +
// 5 (mask) bytes; the ~150 flops per pixel of the 8 blurs stay far below
// the card's rate. The one-pass design keeps the DoG stack out of a second
// read for the mask.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TW = 32;             // output tile width
constexpr int TH = 16;             // output tile height
constexpr int R = 4;               // Gaussian radius
constexpr int NS = 8;              // Gaussian scales per octave
constexpr int HALO = R + 1;        // blur radius + extremum halo
constexpr int IN_W = TW + 2 * HALO;
constexpr int IN_H = TH + 2 * HALO;
constexpr int DW = TW + 2;         // DoG tile width incl. the 1-pixel halo
constexpr int DH = TH + 2;
constexpr int THREADS = 256;

// The octave's (8, 9) tap table, passed by value as a kernel parameter.
struct Taps {
    float k[NS][2 * R + 1];
};

__global__ void __launch_bounds__(THREADS)
dog_and_mask_kernel(const float* __restrict__ img, const Taps taps,
                    int h, int w, float thresh, float edge_limit,
                    float* __restrict__ dog, uint8_t* __restrict__ mask) {
    __shared__ float k[NS][2 * R + 1];
    __shared__ float in[IN_H][IN_W];
    __shared__ float tmp[DH][IN_W];
    __shared__ float blur[2][DH][DW];
    __shared__ float d[NS - 1][DH][DW];

    const int tid = threadIdx.x;
    const int x0 = blockIdx.x * TW;
    const int y0 = blockIdx.y * TH;

    for (int i = tid; i < NS * (2 * R + 1); i += THREADS) k[i / 9][i % 9] = taps.k[i / 9][i % 9];
    for (int i = tid; i < IN_H * IN_W; i += THREADS) {
        const int r = i / IN_W, c = i % IN_W;
        const int y = min(max(y0 - HALO + r, 0), h - 1);
        const int x = min(max(x0 - HALO + c, 0), w - 1);
        in[r][c] = img[(size_t)y * w + x];
    }
    __syncthreads();

    // DoG tile entry (r, c) is image pixel (y0 - 1 + r, x0 - 1 + c).
    for (int s = 0; s < NS; ++s) {
        for (int i = tid; i < DH * IN_W; i += THREADS) {
            const int r = i / IN_W, c = i % IN_W;
            float acc = k[s][0] * in[r][c];
            for (int j = 1; j <= 2 * R; ++j) acc = acc + k[s][j] * in[r + j][c];
            tmp[r][c] = acc;
        }
        __syncthreads();
        for (int i = tid; i < DH * DW; i += THREADS) {
            const int r = i / DW, c = i % DW;
            float acc = k[s][0] * tmp[r][c];
            for (int j = 1; j <= 2 * R; ++j) acc = acc + k[s][j] * tmp[r][c + j];
            blur[s & 1][r][c] = acc;
            if (s > 0) d[s - 1][r][c] = acc - blur[(s - 1) & 1][r][c];
        }
        __syncthreads();
    }

    const size_t plane = (size_t)h * w;
    for (int i = tid; i < TH * TW; i += THREADS) {
        const int r = i / TW, c = i % TW;
        const int y = y0 + r, x = x0 + c;
        if (y >= h || x >= w) continue;
        const size_t px = (size_t)y * w + x;
        for (int p = 0; p < NS - 1; ++p) dog[p * plane + px] = d[p][r + 1][c + 1];
        const bool interior = y >= 1 && y <= h - 2 && x >= 1 && x <= w - 2;
        for (int s = 0; s < 5; ++s) {
            const float cv = d[s + 1][r + 1][c + 1];
            float nmax = -INFINITY, nmin = INFINITY;
            for (int ds = 0; ds < 3; ++ds)
                for (int dy = -1; dy <= 1; ++dy)
                    for (int dx = -1; dx <= 1; ++dx) {
                        if (ds == 1 && dy == 0 && dx == 0) continue;
                        const float v = d[s + ds][r + 1 + dy][c + 1 + dx];
                        nmax = fmaxf(nmax, v);
                        nmin = fminf(nmin, v);
                    }
            bool ext = (cv > fmaxf(nmax, thresh)) || (cv < fminf(nmin, -thresh));
            const auto m = [&](int rr, int cc) { return d[s + 1][rr][cc]; };
            const float dxx = 2.0f * cv - m(r + 1, c) - m(r + 1, c + 2);
            const float dyy = 2.0f * cv - m(r, c + 1) - m(r + 2, c + 1);
            const float dxy = 0.25f * (m(r + 2, c + 2) + m(r, c) - m(r, c + 2) - m(r + 2, c));
            const float tra = dxx + dyy;
            const float det = dxx * dyy - dxy * dxy;
            ext = ext && (tra * tra < edge_limit * det);
            mask[s * plane + px] = (ext && interior) ? 1 : 0;
        }
    }
}

}  // namespace

// ``taps`` points to the (8, 9) float32 table in host memory.
extern "C" int dog_and_mask(const float* img, const float* taps, int h, int w,
                            float thresh, float edge_limit, float* dog,
                            uint8_t* mask, cudaStream_t stream) {
    Taps t;
    for (int i = 0; i < NS * (2 * R + 1); ++i) t.k[i / 9][i % 9] = taps[i];
    const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH);
    dog_and_mask_kernel<<<grid, THREADS, 0, stream>>>(img, t, h, w, thresh,
                                                      edge_limit, dog, mask);
    return (int)cudaGetLastError();
}
