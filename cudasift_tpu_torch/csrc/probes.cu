// P2: capability probes, eight small kernels.
//
// Replaces the TPU kernels of benchmarks/mosaic_probe.py, which each check
// that Mosaic lowers one feature the batched keypoint kernels need. Each
// kernel here does on Hopper what its probe checks on the TPU:
//
//   slice_rows          dynamic unaligned row slice of a tile staged in
//                       shared memory (unaligned_sublane_slice);
//   lane_lane_dot       bf16 product contracting both operands' last
//                       dimension, float32 accumulation, on the tensor cores
//                       with mma.sync.m16n8k16.row.col (lane_lane_dot);
//   scale_by_scalar     a float32 scalar read from device memory
//                       (f32_scalar_prefetch);
//   transpose           a tile transpose through shared memory
//                       (transpose_2d);
//   block_diag          a block-diagonal assembly (concat_blockdiag);
//   strided_rows        a strided row store into a zeroed tile
//                       (sublane_interleave_write);
//   roll_cols           a rotation along the last axis by a shift read on
//                       the device (dyn_roll_cost_shape);
//   small_dot           a float32 product by fused multiply-adds on the
//                       CUDA cores (f32_small_dot).
//
// Bound: each moves a few KB; launch latency sets its time. What that
// latency is on this card, launch_floor measures: a kernel with an empty
// body at a grid of the caller's choice, the least any launch of that grid
// can take. It stands beside the probes as the TPU file's probe() harness
// does: the cost of running anything at all.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int wrap(int v, int m) {
    v %= m;
    return v < 0 ? v + m : v;
}

// out (out_rows, cols) = tile[off + r] of the (rows, cols) tile, the row
// clamped into the tile.
__global__ void slice_rows_kernel(const float* __restrict__ img, int rows, int cols,
                                  const int* __restrict__ off, int out_rows,
                                  float* __restrict__ out) {
    extern __shared__ float tile[];
    for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) tile[e] = img[e];
    __syncthreads();
    const int o = off[0];
    for (int e = threadIdx.x; e < out_rows * cols; e += blockDim.x) {
        const int r = min(max(o + e / cols, 0), rows - 1);
        out[e] = tile[r * cols + e % cols];
    }
}

__device__ __forceinline__ uint32_t ld_pair(const uint16_t* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

// out (16, n) f32 = a (16, k) bf16 . b (n, k)^T bf16; one warp, n a multiple
// of 8, k of 16. Fragments of m16n8k16: g = lane / 4, q = lane % 4; A holds
// rows g and g + 8, columns 2q, 2q + 1 and 2q + 8, 2q + 9 of each 16-wide
// k-step; B (column-major, so rows of b) columns 2q, 2q + 1, 2q + 8, 2q + 9
// of row g of its 8-row tile; C rows g, g + 8, columns 2q, 2q + 1.
__global__ void lane_lane_dot_kernel(const uint16_t* __restrict__ a,
                                     const uint16_t* __restrict__ b, int n, int k,
                                     float* __restrict__ out) {
    const int lane = threadIdx.x;
    const int g = lane >> 2, q = lane & 3;
    for (int nt = 0; nt < n / 8; ++nt) {
        float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, c3 = 0.0f;
        const uint16_t* brow = b + (size_t)(nt * 8 + g) * k;
        for (int k0 = 0; k0 < k; k0 += 16) {
            const uint32_t a0 = ld_pair(a + (size_t)g * k + k0 + 2 * q);
            const uint32_t a1 = ld_pair(a + (size_t)(g + 8) * k + k0 + 2 * q);
            const uint32_t a2 = ld_pair(a + (size_t)g * k + k0 + 2 * q + 8);
            const uint32_t a3 = ld_pair(a + (size_t)(g + 8) * k + k0 + 2 * q + 8);
            const uint32_t b0 = ld_pair(brow + k0 + 2 * q);
            const uint32_t b1 = ld_pair(brow + k0 + 2 * q + 8);
            asm volatile(
                "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                : "+f"(c0), "+f"(c1), "+f"(c2), "+f"(c3)
                : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
        }
        const int col = nt * 8 + 2 * q;
        out[g * n + col] = c0;
        out[g * n + col + 1] = c1;
        out[(g + 8) * n + col] = c2;
        out[(g + 8) * n + col + 1] = c3;
    }
}

// out = x * s[idx], the scalar read on the device.
__global__ void scale_by_scalar_kernel(const float* __restrict__ s, int idx,
                                       const float* __restrict__ x, int size,
                                       float* __restrict__ out) {
    const float v = __ldg(s + idx);
    for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < size; e += gridDim.x * blockDim.x)
        out[e] = x[e] * v;
}

// out (cols, rows) = x (rows, cols)^T through 32 x 32 shared tiles
// (one padding column against bank conflicts); blocks of 32 x 8 threads.
__global__ void transpose_kernel(const float* __restrict__ x, int rows, int cols,
                                 float* __restrict__ out) {
    __shared__ float tile[32][33];
    const int c0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
    for (int j = threadIdx.y; j < 32; j += 8) {
        const int r = r0 + j, c = c0 + threadIdx.x;
        if (r < rows && c < cols) tile[j][threadIdx.x] = x[(size_t)r * cols + c];
    }
    __syncthreads();
    for (int j = threadIdx.y; j < 32; j += 8) {
        const int r = c0 + j, c = r0 + threadIdx.x;   // out row = x column
        if (r < cols && c < rows) out[(size_t)r * rows + c] = tile[threadIdx.x][j];
    }
}

// out (ra + rb, ca + cb) = [[a, 0], [0, b]].
__global__ void block_diag_kernel(const float* __restrict__ a, int ra, int ca,
                                  const float* __restrict__ b, int rb, int cb,
                                  float* __restrict__ out) {
    const int cols = ca + cb, size = (ra + rb) * cols;
    for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < size; e += gridDim.x * blockDim.x) {
        const int r = e / cols, c = e % cols;
        float v = 0.0f;
        if (r < ra && c < ca) v = a[r * ca + c];
        else if (r >= ra && c >= ca) v = b[(r - ra) * cb + (c - ca)];
        out[e] = v;
    }
}

// out (rows, cols) zeroed, then x (rows / stride, cols) stored into rows
// start, start + stride, ...; one block.
__global__ void strided_rows_kernel(const float* __restrict__ x, int rows, int cols, int start,
                                    int stride, float* __restrict__ out) {
    for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) out[e] = 0.0f;
    __syncthreads();
    const int xrows = (rows - start + stride - 1) / stride;
    for (int e = threadIdx.x; e < xrows * cols; e += blockDim.x) {
        const int r = e / cols, c = e % cols;
        out[(size_t)(start + r * stride) * cols + c] = x[e];
    }
}

// out[r][c] = x[r][(c - s[0]) mod cols] (np.roll along the last axis); one
// block per row, the row staged in shared memory.
__global__ void roll_cols_kernel(const float* __restrict__ x, int cols,
                                 const int* __restrict__ shift, float* __restrict__ out) {
    extern __shared__ float row[];
    const float* src = x + (size_t)blockIdx.x * cols;
    for (int c = threadIdx.x; c < cols; c += blockDim.x) row[c] = src[c];
    __syncthreads();
    const int s = shift[0];
    float* dst = out + (size_t)blockIdx.x * cols;
    for (int c = threadIdx.x; c < cols; c += blockDim.x) dst[c] = row[wrap(c - s, cols)];
}

// out (m, n) = a (m, k) . b (k, n) in float32, one thread per entry, k
// fused multiply-adds in order.
__global__ void small_dot_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                 int m, int k, int n, float* __restrict__ out) {
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= m * n) return;
    const int i = e / n, j = e % n;
    float acc = 0.0f;
    for (int t = 0; t < k; ++t) acc = fmaf(a[i * k + t], b[t * n + j], acc);
    out[e] = acc;
}

// Nothing: what is left of a kernel when its work is taken away.
__global__ void launch_floor_kernel() {}

}  // namespace

extern "C" int probe_launch_floor(int blocks, int threads, cudaStream_t stream) {
    if (blocks < 1 || threads < 1 || threads > 1024) return (int)cudaErrorInvalidValue;
    launch_floor_kernel<<<blocks, threads, 0, stream>>>();
    return (int)cudaGetLastError();
}

extern "C" int probe_slice_rows(const float* img, int rows, int cols, const int* off,
                                int out_rows, float* out, cudaStream_t stream) {
    const size_t smem = (size_t)rows * cols * sizeof(float);
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    slice_rows_kernel<<<1, 256, smem, stream>>>(img, rows, cols, off, out_rows, out);
    return (int)cudaGetLastError();
}

extern "C" int probe_lane_lane_dot(const uint16_t* a, const uint16_t* b, int n, int k,
                                   float* out, cudaStream_t stream) {
    if (n % 8 || k % 16) return (int)cudaErrorInvalidValue;
    lane_lane_dot_kernel<<<1, 32, 0, stream>>>(a, b, n, k, out);
    return (int)cudaGetLastError();
}

extern "C" int probe_scale_by_scalar(const float* s, int idx, const float* x, int size,
                                     float* out, cudaStream_t stream) {
    scale_by_scalar_kernel<<<(size + 255) / 256, 256, 0, stream>>>(s, idx, x, size, out);
    return (int)cudaGetLastError();
}

extern "C" int probe_transpose(const float* x, int rows, int cols, float* out,
                               cudaStream_t stream) {
    transpose_kernel<<<dim3((cols + 31) / 32, (rows + 31) / 32), dim3(32, 8), 0, stream>>>(
        x, rows, cols, out);
    return (int)cudaGetLastError();
}

extern "C" int probe_block_diag(const float* a, int ra, int ca, const float* b, int rb, int cb,
                                float* out, cudaStream_t stream) {
    const int size = (ra + rb) * (ca + cb);
    block_diag_kernel<<<(size + 255) / 256, 256, 0, stream>>>(a, ra, ca, b, rb, cb, out);
    return (int)cudaGetLastError();
}

extern "C" int probe_strided_rows(const float* x, int rows, int cols, int start, int stride,
                                  float* out, cudaStream_t stream) {
    strided_rows_kernel<<<1, 256, 0, stream>>>(x, rows, cols, start, stride, out);
    return (int)cudaGetLastError();
}

extern "C" int probe_roll_cols(const float* x, int rows, int cols, const int* shift, float* out,
                               cudaStream_t stream) {
    const size_t smem = (size_t)cols * sizeof(float);
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    roll_cols_kernel<<<rows, 256, smem, stream>>>(x, cols, shift, out);
    return (int)cudaGetLastError();
}

extern "C" int probe_small_dot(const float* a, const float* b, int m, int k, int n, float* out,
                               cudaStream_t stream) {
    small_dot_kernel<<<(m * n + 255) / 256, 256, 0, stream>>>(a, b, m, k, n, out);
    return (int)cudaGetLastError();
}
