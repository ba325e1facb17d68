// ScaleUp: the 2x top-left-aligned bilinear upsample that starts an
// extraction with SiftParams(scale_up=True) (CudaSift's ScaleUp,
// cudaSiftD.cu:170-190).
//
// Replaces no TPU kernel: the JAX package upsamples with XLA code
// (cudasift_tpu/ops/convolve.py:117, scale_up), whose PyTorch copy
// (ops/convolve.py:scale_up) runs three concatenations, the sums and
// scalings and three interleaving stacks, some fourteen kernels and about
// 0.2 GB of traffic for a 1280x960 frame. For an input pixel a = in[y, x]
// with its right, down and down-right neighbours r, d, dr (indices clamped
// to the last column and row) it writes the 2x2 output block
//   out[2y,     2x] = a,               out[2y,     2x + 1] = 0.5 (a + r),
//   out[2y + 1, 2x] = 0.5 (a + d),     out[2y + 1, 2x + 1] = 0.25 (((a + r) + d) + dr).
//
// Bound: device memory. The least traffic is the input read once and the
// four-times-larger output written once, 20 bytes an input pixel (24.6 MB,
// 7.3 us at 3.35 TB/s for 1280x960), against 8 adds and multiplies, under
// half an operation a byte. Each thread takes two neighbouring input pixels
// of a row: it loads them, the pixel right of them and the same three of
// the row below (the overlap between threads comes from L1), and writes its
// 2x4 output block as one 16-byte store a row, so a warp writes 512
// contiguous bytes of each output row. Where the width is odd (odd output
// rows then start off the 16-byte grid) or the input is off 8 bytes, each
// row takes two 8-byte stores instead. A block is 64 pairs x 4 rows. In an
// extraction the output (19.7 MB at 1280x960) fits in the 50 MB L2 and is
// written back to device memory during the kernels after it, so the kernel
// can end under the device memory bound (about 7.0 us a frame on an H100).
//
// Rounding: every sum and product is the plain expression's, in its order,
// spelled with the _rn intrinsics (never contracted into an FMA; the file
// also builds with -fmad=false), so the output equals convolve.scale_up's
// bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PAIRS_X = 64;              // pairs of input pixels a block row
constexpr int ROWS = 4;                  // input rows a block
constexpr int MAX_GRID_Y = 65535;

__device__ __forceinline__ float half_sum(float p, float q) {
    return __fmul_rn(0.5f, __fadd_rn(p, q));
}

__device__ __forceinline__ float quad_sum(float a, float r, float d, float dr) {
    return __fmul_rn(0.25f, __fadd_rn(__fadd_rn(__fadd_rn(a, r), d), dr));
}

// EVEN: the width is even (every thread has two pixels, both output rows
// of a block start on 16 bytes) and the input lies on 8 bytes (its pairs
// load as 8-byte words).
template <bool EVEN>
__global__ void __launch_bounds__(PAIRS_X * ROWS)
scale_up_kernel(const float* __restrict__ in, int h, int w, float* __restrict__ out) {
    const int y = blockIdx.y * ROWS + threadIdx.y;
    const int x0 = 2 * (blockIdx.x * PAIRS_X + threadIdx.x);
    if (y >= h || x0 >= w) return;
    const int yd = min(y + 1, h - 1);
    const int x1 = min(x0 + 1, w - 1);
    const int x2 = min(x0 + 2, w - 1);
    const float* row = in + (size_t)y * w;
    const float* down = in + (size_t)yd * w;
    float a0, a1, d0, d1;
    if (EVEN) {
        const float2 pa = __ldg(reinterpret_cast<const float2*>(row + x0));
        const float2 pd = __ldg(reinterpret_cast<const float2*>(down + x0));
        a0 = pa.x; a1 = pa.y; d0 = pd.x; d1 = pd.y;
    } else {
        a0 = __ldg(row + x0); a1 = __ldg(row + x1);
        d0 = __ldg(down + x0); d1 = __ldg(down + x1);
    }
    const float a2 = __ldg(row + x2);
    const float d2 = __ldg(down + x2);

    const size_t w2 = 2 * (size_t)w;
    float* top = out + 2 * (size_t)y * w2 + 2 * (size_t)x0;
    float* bot = top + w2;
    const float t0 = a0, t1 = half_sum(a0, a1);
    const float b0 = half_sum(a0, d0), b1 = quad_sum(a0, a1, d0, d1);
    if (EVEN) {
        *reinterpret_cast<float4*>(top) = make_float4(t0, t1, a1, half_sum(a1, a2));
        *reinterpret_cast<float4*>(bot) =
            make_float4(b0, b1, half_sum(a1, d1), quad_sum(a1, a2, d1, d2));
    } else {
        *reinterpret_cast<float2*>(top) = make_float2(t0, t1);
        *reinterpret_cast<float2*>(bot) = make_float2(b0, b1);
        if (x0 + 1 < w) {               // the second pixel of the pair
            *reinterpret_cast<float2*>(top + 2) = make_float2(a1, half_sum(a1, a2));
            *reinterpret_cast<float2*>(bot + 2) =
                make_float2(half_sum(a1, d1), quad_sum(a1, a2, d1, d2));
        }
    }
}

}  // namespace

// in (h, w) float32, contiguous; out (2h, 2w) float32, contiguous, on 8
// bytes at least (a fresh allocation is on 256). Returns a cudaError_t.
extern "C" int scale_up(const float* in, int h, int w, float* out, cudaStream_t stream) {
    if (h < 0 || w < 0 || (uintptr_t)out % 8 != 0) return (int)cudaErrorInvalidValue;
    if (h == 0 || w == 0) return (int)cudaSuccess;
    const int pairs = (w + 1) / 2;
    const int rows = (h + ROWS - 1) / ROWS;
    if (rows > MAX_GRID_Y) return (int)cudaErrorInvalidValue;
    const dim3 block(PAIRS_X, ROWS);
    const dim3 grid((pairs + PAIRS_X - 1) / PAIRS_X, rows);
    if (w % 2 == 0 && (uintptr_t)in % 8 == 0 && (uintptr_t)out % 16 == 0) {
        scale_up_kernel<true><<<grid, block, 0, stream>>>(in, h, w, out);
    } else {
        scale_up_kernel<false><<<grid, block, 0, stream>>>(in, h, w, out);
    }
    return (int)cudaGetLastError();
}
