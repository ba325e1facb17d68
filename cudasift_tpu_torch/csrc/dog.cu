// K1: fused scale-space kernel for one octave base -- 8 separable 9-tap
// clamp-to-edge Gaussian blurs, 7 DoG planes, and the strict 3x3x3 extremum
// mask over DoG planes 1-5 with |DoG| > thresh and the edge-response test.
//
// Replaces the TPU kernel cudasift_tpu/ops/pallas/dog.py:dog_and_mask_pallas
// (_dog_kernel). One block of 256 threads per 32 x 64 output tile. The
// tile's clamped input strip is staged in shared memory once. The scale
// loop and the tap loops are unrolled, so every tap is a constant-bank
// operand of its multiply (the table is a kernel parameter). Three kinds
// of work, each with its own thread ownership:
//   V. vertical pass of scale s: each thread owns one column of the strip
//      and 12 output rows, loads its 20 input values and slides the 9-tap
//      window over them in registers (1.7 loads per output instead of 9);
//   H. horizontal pass of scale s: each thread owns a run of 12 outputs of
//      one row of the DoG region (the tile and a 1-pixel halo, widened to a
//      multiple of 4 columns), reads its 20 inputs as five float4 loads,
//      keeps the previous scale's 12 blurred values in registers, takes the
//      DoG there and writes the run into a shared DoG plane;
//   E. extremum pass of DoG plane p: each thread owns 2 x 4 output pixels,
//      reads its 4 x 6 window of the plane (float4 loads), writes the DoG
//      rows to device memory as float4 and takes the separable 3 x 3 max
//      and min of the plane, kept in registers for the next plane. They
//      close the tests of plane p - 1's pixels, which wait in registers as
//      two values a pixel (the DoG where it can still be a maximum, resp.
//      minimum; NaN where not). For plane p's own pixels the 8-neighbour
//      max and min, the previous plane's 3 x 3, the threshold and the edge
//      test open the tests. Mask bytes go out four at a time. A pixel with
//      |DoG| <= thresh can never pass, and at the detection thresholds in
//      use most warps' 4 x 64 pixels hold none, so a warp vote skips the
//      opening where no lane holds one and the closing where no lane has a
//      test open.
// The vertical-pass rows and the DoG plane are double-buffered in shared
// memory (56.7 KB), so that one phase runs H of scale s, V of scale s + 1
// and then E of plane s - 2: one barrier per scale, and the compares of E
// and the multiplies and adds of V and H can issue side by side. The 7 DoG
// planes never sit in shared memory together, and the 26 neighbour loads
// per pixel and plane of a direct test become 1.5. Rows of a width that is
// not a multiple of 4 take scalar stores; the ragged right and bottom edges
// are masked.
//
// Arithmetic order is that of ops/convolve.blur_multi (vertical, then
// horizontal, taps 0..8, each product rounded before the add) and of
// ops/detect.extrema_mask (max and min are exact, so their grouping is
// free; the edge test keeps its order); build with -fmad=false so no
// multiply-add is contracted and the kernel matches its plain version bit
// for bit.
//
// Bound: per pixel it must read 4 bytes and write 7*4 (DoG) + 5 (mask)
// bytes, 0.023 ms at octave 0 of a 1920x1080 frame. Shared-memory loads no
// longer set the pace: instruction issue does, above all the 8 blurs'
// unfused multiplies and adds over the halo-widened region (about 360 a
// pixel, near 0.025 ms at the card's float32 rate) and the extremum
// tests' max, min and compares where a warp opens them, with the DoG
// stores (0.020 ms of device-memory time) to hide under them. On an H100
// it takes about 0.063 ms (replayed from a CUDA graph) at octave 0 of a
// 1920x1080 frame of blocks and 0.077 ms on a dead-leaves frame, where more
// warps open the tests; the single-pass design it replaces took 0.15 ms.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TW = 64;                  // output tile width
constexpr int TH = 32;                  // output tile height
constexpr int R = 4;                    // Gaussian radius
constexpr int NT = 2 * R + 1;           // taps
constexpr int NS = 8;                   // Gaussian scales per octave
constexpr int THREADS = 256;
// DoG region: region (r, c) is image pixel (y0 - 1 + r, x0 - 4 + c); it
// holds the tile and a 1-pixel halo, widened to RW columns so that its
// rows stay 16-byte aligned against the tile.
constexpr int RW = TW + 8;
constexpr int RH = TH + 2;
// Vertical pass: VCHUNKS x VROWS rows of VW columns; region column c takes
// columns c..c+8 of it (image column x0 - 8 + c).
constexpr int VROWS = 12;
constexpr int VCHUNKS = 3;
constexpr int VH = VCHUNKS * VROWS;
constexpr int VW = RW + 2 * R;
// Input strip: image rows y0 - 5 .., columns x0 - 8 .. (clamped).
constexpr int IN_H = VH + 2 * R;
// Horizontal pass: runs of HRUN outputs.
constexpr int HRUN = 12;
constexpr int HRUNS = RW / HRUN;
// Extremum pass: each thread 2 rows x 4 columns of output pixels.
constexpr int QX = 4;
constexpr int QY = 2;
// Shared memory (floats): the strip, two vertical-pass buffers, two DoG
// planes.
constexpr int IN_SIZE = IN_H * VW;
constexpr int TMP_SIZE = VH * VW;
constexpr int DP_SIZE = RH * RW;
constexpr int SMEM_BYTES = (IN_SIZE + 2 * TMP_SIZE + 2 * DP_SIZE) * 4;

static_assert(VH >= RH, "the vertical pass covers the DoG region's rows");
static_assert(VW * VCHUNKS <= THREADS && RH * HRUNS <= THREADS, "work fits the block");
static_assert(HRUNS * HRUN == RW && HRUN % 4 == 0, "horizontal runs tile the region");
static_assert((TH / QY) * (TW / QX) == THREADS, "one 2 x 4 pixel group a thread");
static_assert(IN_SIZE % 4 == 0 && TMP_SIZE % 4 == 0 && DP_SIZE % 4 == 0, "16-byte buffers");

// The octave's (8, 9) tap table, passed by value as a kernel parameter.
struct Taps {
    float k[NS][NT];
};

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fffffff); }

// Column triples of a 4 x 6 window: max and min over rows o..o+2 for the
// two output rows o, which share their middle pair.
__device__ __forceinline__ void column_triples(const float (&wv)[QY + 2][QX + 2],
                                               float (&cmax)[QY][QX + 2],
                                               float (&cmin)[QY][QX + 2]) {
#pragma unroll
    for (int c = 0; c < QX + 2; ++c) {
        const float mx = fmaxf(wv[1][c], wv[2][c]);
        const float mn = fminf(wv[1][c], wv[2][c]);
        cmax[0][c] = fmaxf(wv[0][c], mx);
        cmax[1][c] = fmaxf(mx, wv[3][c]);
        cmin[0][c] = fminf(wv[0][c], mn);
        cmin[1][c] = fminf(mn, wv[3][c]);
    }
}

// The 3x3 max and min of the 2 x 4 pixels from their column triples;
// neighbouring columns share their middle pair.
__device__ __forceinline__ void box3(const float (&cmax)[QY][QX + 2],
                                     const float (&cmin)[QY][QX + 2], float (&nmax)[QY][QX],
                                     float (&nmin)[QY][QX]) {
#pragma unroll
    for (int o = 0; o < QY; ++o)
#pragma unroll
        for (int j = 0; j < QX; j += 2) {
            const float mx = fmaxf(cmax[o][j + 1], cmax[o][j + 2]);
            const float mn = fminf(cmin[o][j + 1], cmin[o][j + 2]);
            nmax[o][j] = fmaxf(cmax[o][j], mx);
            nmax[o][j + 1] = fmaxf(mx, cmax[o][j + 3]);
            nmin[o][j] = fminf(cmin[o][j], mn);
            nmin[o][j + 1] = fminf(mn, cmin[o][j + 3]);
        }
}

__global__ void __launch_bounds__(THREADS, 2)
dog_and_mask_kernel(const float* __restrict__ img, const Taps taps,
                    int h, int w, float thresh, float edge_limit,
                    float* __restrict__ dog, uint8_t* __restrict__ mask) {
    extern __shared__ __align__(16) float smem[];
    float (*in)[VW] = reinterpret_cast<float (*)[VW]>(smem);
    float (*tmp[2])[VW] = {reinterpret_cast<float (*)[VW]>(smem + IN_SIZE),
                           reinterpret_cast<float (*)[VW]>(smem + IN_SIZE + TMP_SIZE)};
    float (*dp[2])[RW] = {reinterpret_cast<float (*)[RW]>(smem + IN_SIZE + 2 * TMP_SIZE),
                          reinterpret_cast<float (*)[RW]>(smem + IN_SIZE + 2 * TMP_SIZE +
                                                          DP_SIZE)};

    const int tid = threadIdx.x;
    const int x0 = blockIdx.x * TW;
    const int y0 = blockIdx.y * TH;
    const size_t plane = (size_t)h * w;
    const bool vec = (w % 4) == 0;       // whole rows of float4 / 4 mask bytes

    for (int i = tid; i < IN_SIZE; i += THREADS) {
        const int r = i / VW, c = i % VW;
        const int y = min(max(y0 - 1 - R + r, 0), h - 1);
        const int x = min(max(x0 - 4 - R + c, 0), w - 1);
        in[r][c] = __ldg(img + (size_t)y * w + x);
    }

    // Vertical-pass ownership: column vc, rows vr .. vr + VROWS - 1.
    const bool v_on = tid < VW * VCHUNKS;
    const int vc = tid % VW, vr = (tid / VW) * VROWS;
    // Horizontal-pass ownership: row hr, columns hc .. hc + HRUN - 1.
    const bool h_on = tid < RH * HRUNS;
    const int hr = tid / HRUNS, hc = (tid % HRUNS) * HRUN;
    float prev[HRUN] = {};               // the previous scale's blur
    // Extremum-pass ownership: pixels (py + o, px + j), o < 2, j < 4.
    const int py = y0 + QY * (tid / (TW / QX));
    const int px = x0 + QX * (tid % (TW / QX));
    const int wr = py - y0;              // window rows wr .. wr + 3 of a DoG plane
    const int wc = px - x0 + 3;          // window columns wc .. wc + 5
    float m3max[QY][QX], m3min[QY][QX];  // the previous plane's 3x3 max / min
    float up[QY][QX], dn[QY][QX];        // the previous plane's open tests
    bool open = false;                   // any of them open
    __syncthreads();

    // Phase -1: V of scale 0. Phase s: H of scale s, V of scale s + 1, E of
    // DoG plane s - 2; a barrier after each.
#pragma unroll
    for (int s = -1; s <= NS; ++s) {
        if (s >= 0 && s < NS && h_on) {
            // H of scale s from tmp[s & 1]; the DoG of scales 1.. into dp[s & 1].
            const float (*t)[VW] = tmp[s & 1];
            float v[HRUN + 2 * R];
#pragma unroll
            for (int q = 0; q < (HRUN + 2 * R) / 4; ++q) {
                const float4 f = *reinterpret_cast<const float4*>(&t[hr][hc + 4 * q]);
                v[4 * q] = f.x;
                v[4 * q + 1] = f.y;
                v[4 * q + 2] = f.z;
                v[4 * q + 3] = f.w;
            }
            float d[HRUN];
#pragma unroll
            for (int i = 0; i < HRUN; ++i) {
                float acc = taps.k[s][0] * v[i];
#pragma unroll
                for (int j = 1; j < NT; ++j) acc = acc + taps.k[s][j] * v[i + j];
                d[i] = acc - prev[i];
                prev[i] = acc;
            }
            if (s > 0) {
#pragma unroll
                for (int q = 0; q < HRUN / 4; ++q)
                    *reinterpret_cast<float4*>(&dp[s & 1][hr][hc + 4 * q]) =
                        make_float4(d[4 * q], d[4 * q + 1], d[4 * q + 2], d[4 * q + 3]);
            }
        }

        if (s + 1 < NS && v_on) {
            // V of scale s + 1 into tmp[(s + 1) & 1].
            const int sv = s + 1;
            float v[VROWS + 2 * R];
#pragma unroll
            for (int i = 0; i < VROWS + 2 * R; ++i) v[i] = in[vr + i][vc];
#pragma unroll
            for (int i = 0; i < VROWS; ++i) {
                float acc = taps.k[sv][0] * v[i];
#pragma unroll
                for (int j = 1; j < NT; ++j) acc = acc + taps.k[sv][j] * v[i + j];
                tmp[sv & 1][vr + i][vc] = acc;
            }
        }
        if (s >= 2) {
            // E: DoG plane p, in dp[(p + 1) & 1] since H of scale p + 1.
            const int p = s - 2;
            const float (*d)[RW] = dp[(p + 1) & 1];
            float wv[QY + 2][QX + 2];
#pragma unroll
            for (int rr = 0; rr < QY + 2; ++rr) {
                const float* row = &d[wr + rr][wc];
                const float4 f = *reinterpret_cast<const float4*>(row + 1);
                wv[rr][0] = row[0];
                wv[rr][1] = f.x;
                wv[rr][2] = f.y;
                wv[rr][3] = f.z;
                wv[rr][4] = f.w;
                wv[rr][5] = row[5];
            }
#pragma unroll
            for (int o = 0; o < QY; ++o) {
                const int y = py + o;
                if (y >= h) continue;
                float* out = dog + p * plane + (size_t)y * w + px;
                if (vec) {
                    if (px < w)
                        *reinterpret_cast<float4*>(out) =
                            make_float4(wv[o + 1][1], wv[o + 1][2], wv[o + 1][3], wv[o + 1][4]);
                } else {
#pragma unroll
                    for (int j = 0; j < QX; ++j)
                        if (px + j < w) out[j] = wv[o + 1][j + 1];
                }
            }

            // The plane's column triples and 3x3 max and min.
            float cmax[QY][QX + 2], cmin[QY][QX + 2], nmax[QY][QX], nmin[QY][QX];
            column_triples(wv, cmax, cmin);
            box3(cmax, cmin, nmax, nmin);

            if (p >= 2) {
                // Close plane p - 1's open tests against this plane's 3x3:
                // mask plane p - 2. A warp with no open test writes zeros.
                unsigned bits[QY] = {};
                if (__any_sync(0xffffffffu, open)) {
#pragma unroll
                    for (int o = 0; o < QY; ++o)
#pragma unroll
                        for (int j = 0; j < QX; ++j) {
                            const bool ext = (up[o][j] > nmax[o][j]) || (dn[o][j] < nmin[o][j]);
                            bits[o] |= (ext ? 1u : 0u) << (8 * j);
                        }
                }
#pragma unroll
                for (int o = 0; o < QY; ++o) {
                    const int y = py + o;
                    if (y >= h) continue;
                    uint8_t* out = mask + (p - 2) * plane + (size_t)y * w + px;
                    if (vec) {
                        if (px < w) *reinterpret_cast<uint32_t*>(out) = bits[o];
                    } else {
#pragma unroll
                        for (int j = 0; j < QX; ++j)
                            if (px + j < w) out[j] = (uint8_t)((bits[o] >> (8 * j)) & 1u);
                    }
                }
            }

            if (p >= 1 && p <= 5) {
                // Open plane p's tests: its 8 neighbours, the previous
                // plane's 3x3, the threshold and the edge test. A pixel with
                // |DoG| <= thresh cannot pass, so a warp with none skips
                // them. The next plane closes them.
                bool cand = false;
#pragma unroll
                for (int o = 0; o < QY; ++o)
#pragma unroll
                    for (int j = 0; j < QX; ++j) {
                        const float cv = wv[o + 1][j + 1];
                        cand |= (cv > thresh) | (cv < -thresh);
                    }
                open = false;
                if (__any_sync(0xffffffffu, cand)) {
#pragma unroll
                    for (int o = 0; o < QY; ++o)
#pragma unroll
                        for (int j = 0; j < QX; ++j) {
                            const float cv = wv[o + 1][j + 1];
                            const float hi = fmaxf(fmaxf(fmaxf(cmax[o][j], cmax[o][j + 2]),
                                                         fmaxf(wv[o][j + 1], wv[o + 2][j + 1])),
                                                   m3max[o][j]);
                            const float lo = fminf(fminf(fminf(cmin[o][j], cmin[o][j + 2]),
                                                         fminf(wv[o][j + 1], wv[o + 2][j + 1])),
                                                   m3min[o][j]);
                            const bool is_max = cv > fmaxf(hi, thresh);
                            const bool is_min = cv < fminf(lo, -thresh);
                            const float dxx = 2.0f * cv - wv[o + 1][j] - wv[o + 1][j + 2];
                            const float dyy = 2.0f * cv - wv[o][j + 1] - wv[o + 2][j + 1];
                            const float dxy = 0.25f * (wv[o + 2][j + 2] + wv[o][j] -
                                                       wv[o][j + 2] - wv[o + 2][j]);
                            const float tra = dxx + dyy;
                            const float det = dxx * dyy - dxy * dxy;
                            const int y = py + o, x = px + j;
                            const bool ok = (tra * tra < edge_limit * det) && y >= 1 &&
                                            y <= h - 2 && x >= 1 && x <= w - 2;
                            up[o][j] = (ok && is_max) ? cv : nan_f();
                            dn[o][j] = (ok && is_min) ? cv : nan_f();
                            open = open || (ok && (is_max || is_min));
                        }
                }
            }
#pragma unroll
            for (int o = 0; o < QY; ++o)
#pragma unroll
                for (int j = 0; j < QX; ++j) {
                    m3max[o][j] = nmax[o][j];
                    m3min[o][j] = nmin[o][j];
                }
        }

        if (s < NS) __syncthreads();
    }
}

}  // namespace

// ``taps`` points to the (8, 9) float32 table in host memory.
extern "C" int dog_and_mask(const float* img, const float* taps, int h, int w,
                            float thresh, float edge_limit, float* dog,
                            uint8_t* mask, cudaStream_t stream) {
    Taps t;
    for (int i = 0; i < NS * NT; ++i) t.k[i / NT][i % NT] = taps[i];
    int err = (int)cudaFuncSetAttribute(dog_and_mask_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        SMEM_BYTES);
    if (err) return err;
    const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH);
    dog_and_mask_kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(img, t, h, w, thresh,
                                                               edge_limit, dog, mask);
    return (int)cudaGetLastError();
}
