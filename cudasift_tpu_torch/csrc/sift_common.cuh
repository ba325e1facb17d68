// Device code shared by the orientation and descriptor kernels (K3, K6, K7):
// the two atan2 polynomials, the tent weight of a bilinear sample, and the
// descriptor's trilinear 4x4x8 binning with L2 -> clamp 0.2 -> L2.
//
// Arithmetic follows the plain versions in ops/texture.py and
// ops/descriptor.py; the including kernels build with -fmad=false so the
// two round alike.
//
// The binning (stage_sample, bin_and_write) is laid out for a 256-thread
// block on Hopper. The trilinear spatial weight of grid row i for cell row
// r is non-zero only for i = 4r-2 .. 4r+5 (clipped to 0..15), where it is
// 1/8, 3/8, 5/8, 7/8, 7/8, 5/8, 3/8, 1/8; columns alike. So a descriptor
// entry sums an 8x8 window of the 16x16 grid with compile-time weights and
// no table of weights exists. The window is cut into a left and a right
// half of four columns; the halves are summed apart, rows then columns
// ascending, and added left + right. With one descriptor per block two
// lanes of a warp take the halves of one entry and meet by a shuffle; with
// two descriptors per block one thread takes both halves of its entry.
// Sums of squares go through a shuffle tree over the 16 entries that share
// entry / 16, then the eight group sums are added in ascending order; both
// layouts use the same tree, so a descriptor's bits do not depend on the
// layout. Samples are staged as eight angle planes with zero columns
// around them, so that a window row's half is one aligned 16-byte read
// without a column test (DescSamples). No float atomics: two runs are
// bit-identical.

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

constexpr unsigned FULL_MASK = 0xffffffffu;

// Gaussian window exp(-(u^2 + v^2) / 128) of the grid sample at distance
// (u, v) = (a + 0.5, b + 0.5) from the grid centre, entry 8a + b: a constant
// of the 16x16 grid, in float32 as descriptor.bin_descriptors computes it.
static __device__ const float GRID_GAUSS[64] = {
    0.996101379f, 0.980658233f, 0.950486541f, 0.906960607f, 0.852010667f, 0.787981033f, 0.717464924f, 0.643131375f,
    0.980658233f, 0.965454578f, 0.935750663f, 0.892899513f, 0.838801444f, 0.775764525f, 0.706341624f, 0.633160532f,
    0.950486541f, 0.935750663f, 0.906960607f, 0.865427852f, 0.812994242f, 0.751896739f, 0.684609771f, 0.613680243f,
    0.906960607f, 0.892899513f, 0.865427852f, 0.825797021f, 0.775764525f, 0.717464924f, 0.653259218f, 0.585577786f,
    0.852010667f, 0.838801444f, 0.812994242f, 0.775764525f, 0.728763342f, 0.673995912f, 0.613680243f, 0.550099432f,
    0.787981033f, 0.775764525f, 0.751896739f, 0.717464924f, 0.673995912f, 0.623344302f, 0.567561448f, 0.508758783f,
    0.717464924f, 0.706341624f, 0.684609771f, 0.653259218f, 0.613680243f, 0.567561448f, 0.516770601f, 0.463230163f,
    0.643131375f, 0.633160532f, 0.613680243f, 0.585577786f, 0.550099432f, 0.508758783f, 0.463230163f, 0.415236831f,
};

// Gaussian window of grid sample t (row t / 16, column t % 16).
__device__ __forceinline__ float grid_gauss(int t) {
    const int i = t >> 4, j = t & 15;
    const int a = i < 8 ? 7 - i : i - 8, b = j < 8 ? 7 - j : j - 8;
    return __ldg(&GRID_GAUSS[8 * a + b]);
}

// The 256 grid samples of one descriptor in shared memory, as eight angle
// planes: plane a holds, for every sample, the share of its gradient
// magnitude that falls into angle bin a (zero for six of the eight), so a
// gather costs no test of the angle. A plane row is ROW = 20 floats: the
// row's 16 samples at 2..17 between two zeros on either side, which stand
// for the window columns -2, -1, 16, 17 outside the grid. The half window
// row of cell column c, half h then starts at float 4 * (c + h): one
// aligned 16-byte read. Planes are PLANE floats apart with PLANE / 4 odd,
// so the eight angles that a quarter-warp reads at once lie in eight
// different 16-byte bank groups.
constexpr int ROW = 20;
constexpr int PLANE = 16 * ROW + 4;
struct alignas(16) DescSamples {
    float v[8 * PLANE];
};

// Shared memory of the binning of N descriptors per block (1 or 2): the
// samples and, for each of the two norms, eight group sums a descriptor.
template <int N>
struct DescShared {
    DescSamples smp[N];
    alignas(16) float wsum[2][N][8];
};

// Split the gradient (dx, dy) of grid sample t over its two neighbouring
// angle bins and store its entry of the eight planes; thread t of 256 also
// zeroes one pair of the planes' border columns. A barrier must follow
// before bin_and_write reads the samples.
__device__ __forceinline__ void stage_sample(DescSamples& s, int t, float dx, float dy,
                                             float gweight) {
    const float grad = sqrtf(dx * dx + dy * dy) * gweight;
    const float angf = (float)(4.0 / 3.1415) * fast_atan2(dy, dx) + 4.0f;
    const float angi_raw = floorf(angf);
    const float frac = angf - angi_raw;
    const float g1 = grad * (1.0f - frac), g2 = grad * frac;
    const int ai = (int)angi_raw & 7, ap = (ai + 1) & 7;
    float* at = s.v + ROW * (t >> 4) + (t & 15) + 2;
#pragma unroll
    for (int a = 0; a < 8; ++a) at[a * PLANE] = a == ai ? g1 : (a == ap ? g2 : 0.0f);
    // Plane t / 32, row (t / 2) % 16, left or right border.
    float* border = s.v + (t >> 5) * PLANE + ROW * ((t >> 1) & 15) + 18 * (t & 1);
    *reinterpret_cast<float2*>(border) = make_float2(0.0f, 0.0f);
}

// Trilinear weight of window offset d (0..7) along one axis.
__device__ constexpr float axis_weight(int d) {
    return d < 4 ? (float)(2 * d + 1) / 8.0f : (float)(15 - 2 * d) / 8.0f;
}

// Sum of half `half` (0: window columns 0..3, 1: columns 4..7) of the 8x8
// window of cell (r, c) for angle bin a: rows ascending, columns ascending
// within a row; rows outside the grid are skipped, columns outside it read
// the planes' zero borders.
__device__ __forceinline__ float half_window(const DescSamples& s, int r, int c, int a,
                                             int half) {
    const float* plane = s.v + a * PLANE + 4 * (c + half);
    // Both halves of an axis carry the same four weights, mirrored.
    float wc[4];
#pragma unroll
    for (int dj = 0; dj < 4; ++dj) wc[dj] = half == 0 ? axis_weight(dj) : axis_weight(dj + 4);
    const int i0 = 4 * r - 2;
    float acc = 0.0f;
#pragma unroll
    for (int di = 0; di < 8; ++di) {
        const int i = i0 + di;
        if ((unsigned)i >= 16u) continue;            // uniform over the warp
        const float wr = axis_weight(di);
        const float4 q = *reinterpret_cast<const float4*>(plane + ROW * i);
        acc = acc + (wr * wc[0]) * q.x;
        acc = acc + (wr * wc[1]) * q.y;
        acc = acc + (wr * wc[2]) * q.z;
        acc = acc + (wr * wc[3]) * q.w;
    }
    return acc;
}

// Sum of x over the 16 entries that share entry / 16, by a shuffle tree over
// the entry index's low four bits; every lane of the group gets the sum.
// With PAIR, bit 3 of the entry is bit 4 of the lane (bit 3 is the half).
template <bool PAIR>
__device__ __forceinline__ float group_sum(float x) {
    x = x + __shfl_xor_sync(FULL_MASK, x, 1);
    x = x + __shfl_xor_sync(FULL_MASK, x, 2);
    x = x + __shfl_xor_sync(FULL_MASK, x, 4);
    return x + __shfl_xor_sync(FULL_MASK, x, PAIR ? 16 : 8);
}

// 1 / |v| over a descriptor's 128 entries, v this thread's entry: group sums
// of squares into `wsum` (eight floats of this descriptor), a barrier, and
// the eight added in ascending order.
template <bool PAIR>
__device__ __forceinline__ float inv_norm(float v, float* wsum, int e, int lane) {
    const float g = group_sum<PAIR>(v * v);
    if ((lane & (PAIR ? 31 : 15)) == 0) wsum[e >> 4] = g;
    __syncthreads();
    const float4 lo = *reinterpret_cast<const float4*>(wsum);
    const float4 hi = *reinterpret_cast<const float4*>(wsum + 4);
    const float total = ((((((lo.x + lo.y) + lo.z) + lo.w) + hi.x) + hi.y) + hi.z) + hi.w;
    return 1.0f / sqrtf(fmaxf(total, 1e-30f));
}

// Bin the staged samples into descriptor entries, normalise L2 -> clamp 0.2
// -> L2 and write them. Every thread of the 256-thread block calls it (it
// synchronises twice) after a barrier behind stage_sample.
//   PAIR:  one descriptor (sh.smp[0] -> out0); lane 16 * cell + 8 * half + a
//          of warp w takes that half of entry 16 * w + 8 * cell + a, so the
//          eight lanes of a quarter-warp read eight angles of one cell.
//   !PAIR: two descriptors (sh.smp[d] -> out0, out1); thread t takes both
//          halves of entry t % 128 of descriptor d = t / 128.
template <bool PAIR, int N>
__device__ __forceinline__ void bin_and_write(DescShared<N>& sh, int t, float* out0,
                                              float* out1) {
    static_assert(PAIR || N == 2, "two descriptors need two sample sets");
    const int lane = t & 31;
    const int d = PAIR ? 0 : t >> 7;
    const int half = (t >> 3) & 1;                     // PAIR only
    const int e = PAIR ? ((t >> 5) << 4) | (((t >> 4) & 1) << 3) | (t & 7) : t & 127;
    const int rc = e >> 3, a = e & 7, r = rc >> 2, c = rc & 3;
    const DescSamples& s = sh.smp[d];
    float left, right;
    if (PAIR) {
        const float mine = half_window(s, r, c, a, half);
        const float other = __shfl_xor_sync(FULL_MASK, mine, 8);
        left = half ? other : mine;
        right = half ? mine : other;
    } else {
        left = half_window(s, r, c, a, 0);
        right = half_window(s, r, c, a, 1);
    }
    const float v = left + right;
    const float n1 = inv_norm<PAIR>(v, sh.wsum[0][d], e, lane);
    const float t1 = fminf(v * n1, 0.2f);
    const float n2 = inv_norm<PAIR>(t1, sh.wsum[1][d], e, lane);
    if (!PAIR || half == 0) (d == 0 ? out0 : out1)[e] = t1 * n2;
}

}  // namespace sift
