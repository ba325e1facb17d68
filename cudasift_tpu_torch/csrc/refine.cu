// K2: count-gated subpixel refinement of compacted extremum candidates.
//
// Replaces the TPU kernel
// cudasift_tpu/ops/pallas/refine.py:refine_candidates_pallas
// (_refine_kernel/_refine_body). One thread per candidate slot reads the 19
// values of its 3x3x3 DoG cube that the formulas use straight from the
// (7, H, W) stack, solves for the subpixel offset with the Hessian adjugate,
// falls back to per-axis Newton steps when the offset leaves +-0.5, and
// applies the edge test, the scale formula 2^(s/5) * 2^(pds/5) and the
// lowest-scale cut. Slots at or past the live count write zeros and
// valid = 0 and leave. The expressions are those of
// ops/detect.refine_candidates; build with -fmad=false so they round alike.
//
// Bound: one dependent chain a candidate (count and index, cube, six stores)
// and the launch; a few thousand live candidates an octave move a few hundred
// KB. So the design shortens the chain and spreads it: 32-bit index
// arithmetic (the wrapper refuses a stack whose 7 * H * W does not fit; a
// 64-bit division is emulated in some eighty instructions), the 19 loads
// issued together before any use, and a warp a block, so that an octave's
// slots (160 blocks for 5120) reach every SM. The DMA-tile and lane-roll
// layout of the TPU kernel has no purpose here: the cube is read through the
// L1/L2 caches directly.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 32;

__global__ void __launch_bounds__(THREADS)
refine_kernel(const float* __restrict__ dog, const int* __restrict__ flat_idx,
              const int* __restrict__ count, int k, int h, int w,
              float edge_limit, float lowest_scale, float* __restrict__ out,
              uint8_t* __restrict__ valid_out) {
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= k) return;
    // The index before the count is known (slot i exists either way), so
    // that the two reads share one round trip.
    const int fi = __ldg(flat_idx + i);
    if (i >= *count) {
        out[i] = 0.0f;
        out[k + i] = 0.0f;
        out[2 * k + i] = 0.0f;
        out[3 * k + i] = 0.0f;
        out[4 * k + i] = 0.0f;
        valid_out[i] = 0;
        return;
    }
    const int hw = h * w;
    const int s = fi / hw;
    const int rem = fi - s * hw;
    int y = rem / w;
    int x = rem - y * w;
    y = min(max(y, 1), h - 2);
    x = min(max(x, 1), w - 2);
    // The cube around DoG plane s + 1: c the centre plane, d the plane below
    // (ds = -1), u the plane above (ds = +1); suffixes are (dy, dx) with m
    // for -1 and p for +1, a single letter where the other offset is 0.
    const float* c = dog + ((s + 1) * hw + y * w + x);
    const float* d = c - hw;
    const float* u = c + hw;
    const float val = __ldg(c);
    const float cxm = __ldg(c - 1), cxp = __ldg(c + 1);
    const float cym = __ldg(c - w), cyp = __ldg(c + w);
    const float cmm = __ldg(c - w - 1), cmp = __ldg(c - w + 1);
    const float cpm = __ldg(c + w - 1), cpp = __ldg(c + w + 1);
    const float d00 = __ldg(d), dxm = __ldg(d - 1), dxp = __ldg(d + 1);
    const float dym = __ldg(d - w), dyp = __ldg(d + w);
    const float u00 = __ldg(u), uxm = __ldg(u - 1), uxp = __ldg(u + 1);
    const float uym = __ldg(u - w), uyp = __ldg(u + w);

    const float dxx = 2.0f * val - cxm - cxp;
    const float dyy = 2.0f * val - cym - cyp;
    const float dxy = 0.25f * (cpp + cmm - cmp - cpm);
    const float tra = dxx + dyy;
    const float det = dxx * dyy - dxy * dxy;
    const bool edge_ok = tra * tra < edge_limit * det;
    const float edge = tra * tra / (det == 0.0f ? 1e-30f : det);

    const float dx_ = 0.5f * (cxp - cxm);
    const float dy_ = 0.5f * (cyp - cym);
    const float ds_ = 0.5f * (d00 - u00);
    const float dss = 2.0f * val - u00 - d00;
    const float dxs = 0.25f * (uxp + dxm - dxp - uxm);
    const float dys = 0.25f * (uyp + dym - uym - dyp);

    const float idxx = dyy * dss - dys * dys;
    const float idxy = dys * dxs - dxy * dss;
    const float idxs = dxy * dys - dyy * dxs;
    const float denom = idxx * dxx + idxy * dxy + idxs * dxs;
    const float idet = 1.0f / (denom == 0.0f ? 1e-30f : denom);
    const float idyy = dxx * dss - dxs * dxs;
    const float idys = dxy * dxs - dxx * dys;
    const float idss = dxx * dyy - dxy * dxy;
    float pdx = idet * (idxx * dx_ + idxy * dy_ + idxs * ds_);
    float pdy = idet * (idxy * dx_ + idyy * dy_ + idys * ds_);
    float pds = idet * (idxs * dx_ + idys * dy_ + idss * ds_);
    if (fabsf(pdx) > 0.5f || fabsf(pdy) > 0.5f || fabsf(pds) > 0.5f) {
        pdx = dx_ / (dxx == 0.0f ? 1e-30f : dxx);
        pdy = dy_ / (dyy == 0.0f ? 1e-30f : dyy);
        pds = ds_ / (dss == 0.0f ? 1e-30f : dss);
    }
    const float dval = 0.5f * (dx_ * pdx + dy_ * pdy + ds_ * pds);
    const float sc = exp2f((float)s * 0.2f) * exp2f(pds * 0.2f);
    const bool valid = edge_ok && (sc >= lowest_scale);
    out[i] = valid ? (float)x + pdx : 0.0f;
    out[k + i] = valid ? (float)y + pdy : 0.0f;
    out[2 * k + i] = valid ? sc : 0.0f;
    out[3 * k + i] = valid ? val + dval : 0.0f;
    out[4 * k + i] = valid ? edge : 0.0f;
    valid_out[i] = valid ? 1 : 0;
}

}  // namespace

extern "C" int refine_candidates(const float* dog, const int* flat_idx,
                                 const int* count, int k, int h, int w,
                                 float edge_limit, float lowest_scale,
                                 float* out, uint8_t* valid, cudaStream_t stream) {
    if (k == 0) return 0;
    refine_kernel<<<(k + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
        dog, flat_idx, count, k, h, w, edge_limit, lowest_scale, out, valid);
    return (int)cudaGetLastError();
}
