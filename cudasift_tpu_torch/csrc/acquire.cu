// P1: per-keypoint patch acquisition, the patch-acquisition microbenchmark.
//
// Replaces the TPU kernels of benchmarks/acquire_bench.py: make_hbm_variant
// (an aligned (56, 256) f32 patch copied HBM -> VMEM by async DMA per
// keypoint) and make_vmem_variant (the whole image resident in VMEM), each
// with and without the realignment by two dynamic rolls. Per keypoint i the
// function sums the (48, 64) window whose element (r, c) is
//   img[oy[i] + (r + ry) mod 56, ox[i] + (c + rx) mod 256],
// ry = rxy[i], rx = rxy[i + half] with the rolls, ry = rx = 0 without (the
// two rolls read row r + ry and column c + rx of the aligned patch, mod its
// size). Image reads clamp to the image, so any offsets are safe; the
// bench's offsets (oy a multiple of 8, ox of 128, patch inside the image,
// ry < 8, rx < 128) never clamp or wrap. Each group of 8 keypoints writes
// one (8, 128) block: row 0 holds the sum of its 8 window sums in every
// lane, rows 1-7 zeros (the TPU kernel leaves them unwritten).
//
// Two kernels, one block of 256 threads per group of 8 keypoints:
//   staged -- the counterpart of the DMA: each keypoint's whole aligned
//     (56, 256) patch (57,344 B) is copied global -> shared with cp.async,
//     double-buffered (114,688 B of dynamic shared memory, past the 48 KB
//     default, so the launcher opts in), the next keypoint's copy in flight
//     while the current window is summed out of shared memory; eight patches
//     (458 KB) would not fit in the 227 KB a block may use;
//   direct -- the counterpart of the VMEM-resident image: the window is read
//     straight from global memory through the cache.
// Bound: bytes. The function needs only the windows (12 KB per keypoint;
// the staged kernel moves the whole 57 KB patch, as the TPU kernel does);
// the arithmetic is one add per element.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int B = 8;            // keypoints per output block
constexpr int PR = 56, PWR = 256;  // aligned patch
constexpr int P = 48, PW = 64;     // summed window
constexpr int THREADS = 256;
constexpr int PATCH = PR * PWR;
constexpr size_t STAGED_SMEM = 2 * PATCH * sizeof(float);

__device__ __forceinline__ int wrap(int v, int m) {
    v %= m;
    return v < 0 ? v + m : v;
}

__device__ __forceinline__ float at(const float* __restrict__ img, int h, int w, int r, int c) {
    r = min(max(r, 0), h - 1);
    c = min(max(c, 0), w - 1);
    return __ldg(img + (size_t)r * w + c);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Sum of every thread's acc over the block; every thread gets it.
__device__ __forceinline__ float block_sum(float acc, float* red) {
    for (int o = 16; o > 0; o /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = acc;
    __syncthreads();
    float total = 0.0f;
    for (int j = 0; j < THREADS / 32; ++j) total += red[j];
    return total;
}

__device__ __forceinline__ void write_block(float* __restrict__ out, float total) {
    float* o = out + (size_t)blockIdx.x * 8 * 128;
    for (int e = threadIdx.x; e < 8 * 128; e += THREADS) o[e] = e < 128 ? total : 0.0f;
}

template <bool ROLL>
__global__ void __launch_bounds__(THREADS)
staged_kernel(const float* __restrict__ img, int h, int w, const int* __restrict__ oy,
              const int* __restrict__ ox, const int* __restrict__ rxy, int half,
              float* __restrict__ out) {
    extern __shared__ float4 smem4[];
    float* buf = reinterpret_cast<float*>(smem4);
    __shared__ float red[THREADS / 32];
    const int t = threadIdx.x;
    const int first = blockIdx.x * B;
    const bool aligned_img = (w % 4 == 0) && ((reinterpret_cast<uintptr_t>(img) & 15) == 0);

    // Issue the copy of keypoint k's aligned patch into dst: 16-byte
    // cp.async chunks when the patch lies inside the image on a 16-byte
    // boundary, else plain clamped loads (no fault on any offset).
    auto stage = [&](int k, float* dst) {
        const int y0 = oy[first + k], x0 = ox[first + k];
        if (aligned_img && y0 >= 0 && y0 + PR <= h && x0 >= 0 && x0 + PWR <= w && x0 % 4 == 0) {
            for (int ch = t; ch < PATCH / 4; ch += THREADS) {
                const int r = ch / (PWR / 4), q = (ch % (PWR / 4)) * 4;
                cp_async16(dst + r * PWR + q, img + (size_t)(y0 + r) * w + x0 + q);
            }
        } else {
            for (int e = t; e < PATCH; e += THREADS) dst[e] = at(img, h, w, y0 + e / PWR, x0 + e % PWR);
        }
        cp_async_commit();
    };

    float acc = 0.0f;
    stage(0, buf);
    for (int k = 0; k < B; ++k) {
        float* cur = buf + (k & 1) * PATCH;
        if (k + 1 < B) {
            stage(k + 1, buf + ((k + 1) & 1) * PATCH);
            cp_async_wait<1>();   // keypoint k's copy is done
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const int ry = ROLL ? rxy[first + k] : 0;
        const int rx = ROLL ? rxy[first + k + half] : 0;
        for (int e = t; e < P * PW; e += THREADS) {
            const int r = e / PW, c = e % PW;
            acc += cur[(ROLL ? wrap(r + ry, PR) : r) * PWR + (ROLL ? wrap(c + rx, PWR) : c)];
        }
        __syncthreads();   // cur is refilled two keypoints on
    }
    write_block(out, block_sum(acc, red));
}

template <bool ROLL>
__global__ void __launch_bounds__(THREADS)
direct_kernel(const float* __restrict__ img, int h, int w, const int* __restrict__ oy,
              const int* __restrict__ ox, const int* __restrict__ rxy, int half,
              float* __restrict__ out) {
    __shared__ float red[THREADS / 32];
    const int t = threadIdx.x;
    const int first = blockIdx.x * B;
    float acc = 0.0f;
    for (int k = 0; k < B; ++k) {
        const int y0 = oy[first + k], x0 = ox[first + k];
        const int ry = ROLL ? rxy[first + k] : 0;
        const int rx = ROLL ? rxy[first + k + half] : 0;
        for (int e = t; e < P * PW; e += THREADS) {
            const int r = e / PW, c = e % PW;
            acc += at(img, h, w, y0 + (ROLL ? wrap(r + ry, PR) : r), x0 + (ROLL ? wrap(c + rx, PWR) : c));
        }
    }
    write_block(out, block_sum(acc, red));
}

template <bool ROLL>
int launch_staged(const float* img, int h, int w, const int* oy, const int* ox, const int* rxy,
                  int half, int n, float* out, cudaStream_t stream) {
    if (n == 0) return 0;
    cudaError_t err = cudaFuncSetAttribute(staged_kernel<ROLL>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)STAGED_SMEM);
    if (err != cudaSuccess) return (int)err;
    staged_kernel<ROLL><<<n / B, THREADS, STAGED_SMEM, stream>>>(img, h, w, oy, ox, rxy, half, out);
    return (int)cudaGetLastError();
}

template <bool ROLL>
int launch_direct(const float* img, int h, int w, const int* oy, const int* ox, const int* rxy,
                  int half, int n, float* out, cudaStream_t stream) {
    if (n == 0) return 0;
    direct_kernel<ROLL><<<n / B, THREADS, 0, stream>>>(img, h, w, oy, ox, rxy, half, out);
    return (int)cudaGetLastError();
}

}  // namespace

// n keypoints (a multiple of 8) -> out (n / 8, 8, 128) f32.
extern "C" int acquire_staged(const float* img, int h, int w, const int* oy, const int* ox,
                              const int* rxy, int half, int n, float* out, cudaStream_t stream) {
    return launch_staged<false>(img, h, w, oy, ox, rxy, half, n, out, stream);
}

extern "C" int acquire_staged_roll(const float* img, int h, int w, const int* oy, const int* ox,
                                   const int* rxy, int half, int n, float* out,
                                   cudaStream_t stream) {
    return launch_staged<true>(img, h, w, oy, ox, rxy, half, n, out, stream);
}

extern "C" int acquire_direct(const float* img, int h, int w, const int* oy, const int* ox,
                              const int* rxy, int half, int n, float* out, cudaStream_t stream) {
    return launch_direct<false>(img, h, w, oy, ox, rxy, half, n, out, stream);
}

extern "C" int acquire_direct_roll(const float* img, int h, int w, const int* oy, const int* ox,
                                   const int* rxy, int half, int n, float* out,
                                   cudaStream_t stream) {
    return launch_direct<true>(img, h, w, oy, ox, rxy, half, n, out, stream);
}
