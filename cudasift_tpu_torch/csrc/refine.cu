// K2: count-gated subpixel refinement of compacted extremum candidates.
//
// Replaces the TPU kernel
// cudasift_tpu/ops/pallas/refine.py:refine_candidates_pallas
// (_refine_kernel/_refine_body). One thread per candidate slot reads its
// 3x3x3 DoG cube straight from the (7, H, W) stack, solves for the subpixel
// offset with the Hessian adjugate, falls back to per-axis Newton steps when
// the offset leaves +-0.5, and applies the edge test, the scale formula
// 2^(s/5) * 2^(pds/5) and the lowest-scale cut. Slots at or past the live
// count write zeros and valid = 0. The expressions are those of
// ops/detect.refine_candidates; build with -fmad=false so they round alike.
//
// Bound: latency of the 27 scattered reads per candidate (a few thousand
// live candidates per octave, a few microseconds of work). The DMA-tile and
// lane-roll layout of the TPU kernel has no purpose here: the cube is read
// through the L1/L2 caches directly.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
refine_kernel(const float* __restrict__ dog, const int* __restrict__ flat_idx,
              const int* __restrict__ count, int k, int h, int w,
              float edge_limit, float lowest_scale, float* __restrict__ out,
              uint8_t* __restrict__ valid_out) {
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= k) return;
    float xo = 0.0f, yo = 0.0f, so = 0.0f, sho = 0.0f, eo = 0.0f;
    bool valid = false;
    if (i < *count) {
        const long long hw = (long long)h * w;
        const long long fi = flat_idx[i];
        const long long s = fi / hw;
        const long long rem = fi - s * hw;
        long long y = rem / w;
        long long x = rem - y * w;
        y = min(max(y, 1LL), (long long)h - 2);
        x = min(max(x, 1LL), (long long)w - 2);
        auto at = [&](int ds, int dy, int dx) {
            return dog[(s + 1 + ds) * hw + (y + dy) * w + (x + dx)];
        };
        const float val = at(0, 0, 0);
        const float dxx = 2.0f * val - at(0, 0, -1) - at(0, 0, 1);
        const float dyy = 2.0f * val - at(0, -1, 0) - at(0, 1, 0);
        const float dxy = 0.25f * (at(0, 1, 1) + at(0, -1, -1) - at(0, -1, 1) - at(0, 1, -1));
        const float tra = dxx + dyy;
        const float det = dxx * dyy - dxy * dxy;
        const bool edge_ok = tra * tra < edge_limit * det;
        const float edge = tra * tra / (det == 0.0f ? 1e-30f : det);

        const float dx_ = 0.5f * (at(0, 0, 1) - at(0, 0, -1));
        const float dy_ = 0.5f * (at(0, 1, 0) - at(0, -1, 0));
        const float ds_ = 0.5f * (at(-1, 0, 0) - at(1, 0, 0));
        const float dss = 2.0f * val - at(1, 0, 0) - at(-1, 0, 0);
        const float dxs = 0.25f * (at(1, 0, 1) + at(-1, 0, -1) - at(-1, 0, 1) - at(1, 0, -1));
        const float dys = 0.25f * (at(1, 1, 0) + at(-1, -1, 0) - at(1, -1, 0) - at(-1, 1, 0));

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
        valid = edge_ok && (sc >= lowest_scale);
        if (valid) {
            xo = (float)x + pdx;
            yo = (float)y + pdy;
            so = sc;
            sho = val + dval;
            eo = edge;
        }
    }
    out[i] = xo;
    out[k + i] = yo;
    out[2 * k + i] = so;
    out[3 * k + i] = sho;
    out[4 * k + i] = eo;
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
