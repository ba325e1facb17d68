// P2: capability probes, eight small kernels.
//
// Replaces the TPU kernels of benchmarks/mosaic_probe.py, which each check
// that Mosaic lowers one feature the batched keypoint kernels need. Each
// kernel here does on Hopper what its probe checks on the TPU:
//
//   slice_rows          dynamic unaligned row slice of a tile, the rows
//                       chosen on the device (unaligned_sublane_slice);
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
// does: the cost of running anything at all. So each probe is built to add
// as little as it can to the floor: every thread issues its global loads
// before it waits on any, and no probe serialises work a grid could spread
// (slice_rows, lane_lane_dot, strided_rows and small_dot were redesigned
// so). Those four read in 16-byte words aligned on the address, the edge
// elements masked (ld_words), so one path serves any base and row length.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int wrap(int v, int m) {
    v %= m;
    return v < 0 ? v + m : v;
}

// The 16-byte word at global address w when `load`, else zeros: one
// predicated load, no branch, so a caller's loads can all be in flight
// before the first is used.
__device__ __forceinline__ uint4 ld_word_if(uintptr_t w, bool load) {
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    asm("{\n.reg .pred p;\n.reg .u64 g;\n"
        "setp.ne.b32 p, %4, 0;\n"
        "cvta.to.global.u64 g, %5;\n"
        "@p ld.global.nc.v4.u32 {%0, %1, %2, %3}, [g];\n}\n"
        : "+r"(v.x), "+r"(v.y), "+r"(v.z), "+r"(v.w)
        : "r"((int)load), "l"(w));
    return v;
}

// Words p[0] .. p[valid - 1] (valid 0-4) of an array on 4 bytes, read as
// the one or two 16-byte words aligned on the address that hold them; the
// words past valid are 0, and valid 0 reads nothing. The edge words reach
// at most 12 bytes past the elements asked for, inside their own 16-byte
// word of the array's memory. slice_rows, lane_lane_dot, strided_rows and
// small_dot read their global memory through this, so any base and any row
// length take the same 16-byte loads; no branch, only selects.
__device__ __forceinline__ uint4 ld_words(const void* p, int valid) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(p), w = a & ~uintptr_t(15);
    const int ph = (int)(a >> 2) & 3;   // p's place in its word
    const uint4 lo = ld_word_if(w, valid > 0), hi = ld_word_if(w + 16, ph + valid > 4);
    // Words ph .. ph + 3 of lo:hi, shifted by two words, then by one.
    const bool two = ph & 2, one = ph & 1;
    const uint32_t s0 = two ? lo.z : lo.x, s1 = two ? lo.w : lo.y, s2 = two ? hi.x : lo.z,
                   s3 = two ? hi.y : lo.w, s4 = two ? hi.z : hi.x;
    return make_uint4(one ? s1 : s0, valid > 1 ? (one ? s2 : s1) : 0u,
                      valid > 2 ? (one ? s3 : s2) : 0u, valid > 3 ? (one ? s4 : s3) : 0u);
}

__device__ __forceinline__ float4 ld_floats(const float* p, int valid) {
    const uint4 v = ld_words(p, valid);
    return make_float4(__uint_as_float(v.x), __uint_as_float(v.y), __uint_as_float(v.z),
                       __uint_as_float(v.w));
}

// out[0 .. valid - 1] = v: one 16-byte store where out lies on 16 bytes and
// valid is 4, else a store per element.
__device__ __forceinline__ void st_floats(float* out, float4 v, int valid) {
    if (valid == 4 && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
        *reinterpret_cast<float4*>(out) = v;
        return;
    }
    const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
        if (i < valid) out[i] = e[i];
}

// out (out_rows, cols) = tile[off + r] of the (rows, cols) tile, the row
// clamped into the tile: only the out_rows source rows are read, one pass,
// a thread per four columns of an output row.
__global__ void slice_rows_kernel(const float* __restrict__ img, int rows, int cols,
                                  const int* __restrict__ off, int out_rows,
                                  float* __restrict__ out) {
    const int o = __ldg(off);
    const int per_row = (cols + 3) / 4;
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= out_rows * per_row) return;
    const int orow = e / per_row, c = 4 * (e % per_row), valid = min(4, cols - c);
    const int r = min(max(o + orow, 0), rows - 1);
    st_floats(out + (size_t)orow * cols + c, ld_floats(img + (size_t)r * cols + c, valid), valid);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// out (16, n) f32 = a (16, k) bf16 . b (n, k)^T bf16, n a multiple of 8, k
// of 16, both bases on 4 bytes. Fragments of m16n8k16: g = lane / 4, q =
// lane % 4; A holds rows g and g + 8 in the k slots 2q, 2q + 1 and 2q + 8,
// 2q + 9 of a 16-wide step, B (column-major, so rows of b) the same slots of
// row g of its n-tile; C rows g, g + 8, columns 2q, 2q + 1. A sum over k may
// take its terms in any order, so the slots need not be k itself: each
// 32-wide chunk of k is one 16-byte word a row for each lane, elements 8q ..
// 8q + 7 of the chunk, whose first half fills the lane's slots of one mma
// step and whose second half those of the next (A and B map slots to k
// alike, so every product pairs equal k). A block of LL_WARPS warps per
// 8-column n-tile splits k: warp w takes chunks w, w + LL_WARPS, ... (the
// 16-wide tail, elements 4q .. 4q + 3, goes to the warp next in turn), loads
// the words of up to LL_KB of them before its first mma (ld_words: aligned
// on the address, so a base off 16 bytes costs a second word, not another
// path), and the warps' C fragments are summed in shared memory in warp
// order. At k = 256 each warp loads three words and runs two mma steps.
constexpr int LL_WARPS = 8, LL_KB = 2;

__global__ void __launch_bounds__(LL_WARPS * 32)
lane_lane_dot_kernel(const uint16_t* __restrict__ a, const uint16_t* __restrict__ b, int n, int k,
                     float* __restrict__ out) {
    __shared__ float part[LL_WARPS][16][8];
    const int nt = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, q = lane & 3;
    const uint16_t* ag = a + (size_t)g * k;
    const uint16_t* ag8 = a + (size_t)(g + 8) * k;
    const uint16_t* bg = b + (size_t)(nt * 8 + g) * k;
    float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const int chunks = k / 32;
    for (int c0 = warp; c0 < chunks; c0 += LL_WARPS * LL_KB) {
        uint4 wa[LL_KB], wa8[LL_KB], wb[LL_KB];
#pragma unroll
        for (int j = 0; j < LL_KB; ++j) {
            const int ch = c0 + j * LL_WARPS, kk = ch * 32 + 8 * q, valid = ch < chunks ? 4 : 0;
            wa[j] = ld_words(ag + kk, valid);
            wa8[j] = ld_words(ag8 + kk, valid);
            wb[j] = ld_words(bg + kk, valid);
        }
#pragma unroll
        for (int j = 0; j < LL_KB; ++j) {
            if (c0 + j * LL_WARPS < chunks) {
                mma_bf16(c, wa[j].x, wa8[j].x, wa[j].y, wa8[j].y, wb[j].x, wb[j].y);
                mma_bf16(c, wa[j].z, wa8[j].z, wa[j].w, wa8[j].w, wb[j].z, wb[j].w);
            }
        }
    }
    if (k % 32 && warp == chunks % LL_WARPS) {
        const int kk = chunks * 32 + 4 * q;
        const uint4 ta = ld_words(ag + kk, 2), ta8 = ld_words(ag8 + kk, 2),
                    tb = ld_words(bg + kk, 2);
        mma_bf16(c, ta.x, ta8.x, ta.y, ta8.y, tb.x, tb.y);
    }
    part[warp][g][2 * q] = c[0];
    part[warp][g][2 * q + 1] = c[1];
    part[warp][g + 8][2 * q] = c[2];
    part[warp][g + 8][2 * q + 1] = c[3];
    __syncthreads();
    if (threadIdx.x < 16 * 8) {
        const int r = threadIdx.x >> 3, col = threadIdx.x & 7;
        float sum = 0.0f;
#pragma unroll
        for (int w = 0; w < LL_WARPS; ++w) sum += part[w][r][col];
        out[(size_t)r * n + nt * 8 + col] = sum;
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

// out (rows, cols): rows start, start + stride, ... hold the rows of x
// (len(range(start, rows, stride)), cols), every other row zeros. Each
// thread writes four columns of one output row, once: no zeroing pass, no
// barrier.
__global__ void strided_rows_kernel(const float* __restrict__ x, int rows, int cols, int start,
                                    int stride, float* __restrict__ out) {
    const int per_row = (cols + 3) / 4;
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= rows * per_row) return;
    const int r = e / per_row, c = 4 * (e % per_row), valid = min(4, cols - c);
    const bool stored = r >= start && (r - start) % stride == 0;
    const int src = stored ? (r - start) / stride : 0;
    st_floats(out + (size_t)r * cols + c,
              ld_floats(x + (size_t)src * cols + c, stored ? valid : 0), valid);
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

// out (m, n) = a (m, k) . b (k, n) in float32 by fused multiply-adds on the
// CUDA cores, any m, k, n and bases. A block of 8 warps owns a 16 x 16 tile
// of out: it stages the tile's 16 rows of a and 16 columns of b, DOT_KC of k
// at a time, in shared memory with 16-byte loads (ld_words; zeros past the
// edges); warp w takes k in [32w, 32w + 32) of the chunk,
// each lane a 2 x 4 block of the tile (8 running sums, 8 multiply-adds for
// three shared reads), and the warps' partial tiles are summed in shared
// memory in warp order.
constexpr int DOT_T = 16, DOT_KC = 256, DOT_WARPS = 8;

__global__ void __launch_bounds__(DOT_WARPS * 32)
small_dot_kernel(const float* __restrict__ a, const float* __restrict__ b, int m, int k, int n,
                 float* __restrict__ out) {
    __shared__ __align__(16) float sa[DOT_T][DOT_KC + 4];   // + 4: rows on other banks
    __shared__ __align__(16) float sb[DOT_KC][DOT_T];
    __shared__ float part[DOT_WARPS][DOT_T][DOT_T];
    const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
    const int i0 = blockIdx.y * DOT_T, j0 = blockIdx.x * DOT_T;
    const int ti = (lane >> 2) * 2, tj = (lane & 3) * 4;   // the lane's 2 x 4 block
    float acc[2][4] = {};
    for (int k0 = 0; k0 < k; k0 += DOT_KC) {
        float4 va[4], vb[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {   // 1024 words of each tile, 4 a thread
            const int e = t + 256 * u;
            const int ra = e >> 6, ca = (e & 63) * 4, rb = e >> 2, cb = (e & 3) * 4;
            // Rows and columns past the edges read nothing and stage zeros.
            va[u] = ld_floats(a + (size_t)(i0 + ra) * k + k0 + ca,
                              i0 + ra < m ? max(0, min(4, k - k0 - ca)) : 0);
            vb[u] = ld_floats(b + (size_t)(k0 + rb) * n + j0 + cb,
                              k0 + rb < k ? max(0, min(4, n - j0 - cb)) : 0);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int e = t + 256 * u;
            *reinterpret_cast<float4*>(&sa[e >> 6][(e & 63) * 4]) = va[u];
            *reinterpret_cast<float4*>(&sb[e >> 2][(e & 3) * 4]) = vb[u];
        }
        __syncthreads();
#pragma unroll
        for (int kk = warp * 32; kk < warp * 32 + 32; kk += 4) {
            const float4 x0 = *reinterpret_cast<const float4*>(&sa[ti][kk]);
            const float4 x1 = *reinterpret_cast<const float4*>(&sa[ti + 1][kk]);
            const float r0[4] = {x0.x, x0.y, x0.z, x0.w}, r1[4] = {x1.x, x1.y, x1.z, x1.w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const float4 y = *reinterpret_cast<const float4*>(&sb[kk + u][tj]);
                const float col[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    acc[0][c] = fmaf(r0[u], col[c], acc[0][c]);
                    acc[1][c] = fmaf(r1[u], col[c], acc[1][c]);
                }
            }
        }
        __syncthreads();   // the tiles are refilled for the next chunk
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        part[warp][ti][tj + c] = acc[0][c];
        part[warp][ti + 1][tj + c] = acc[1][c];
    }
    __syncthreads();
    const int r = t / DOT_T, c = t % DOT_T;
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < DOT_WARPS; ++w) s += part[w][r][c];
    if (i0 + r < m && j0 + c < n) out[(size_t)(i0 + r) * n + j0 + c] = s;
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
    const int threads = out_rows * ((cols + 3) / 4);
    if (threads == 0) return 0;
    slice_rows_kernel<<<(threads + 255) / 256, 256, 0, stream>>>(img, rows, cols, off, out_rows,
                                                                 out);
    return (int)cudaGetLastError();
}

extern "C" int probe_lane_lane_dot(const uint16_t* a, const uint16_t* b, int n, int k,
                                   float* out, cudaStream_t stream) {
    if (n % 8 || k % 16 || (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 3)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    lane_lane_dot_kernel<<<n / 8, LL_WARPS * 32, 0, stream>>>(a, b, n, k, out);
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
    const int threads = rows * ((cols + 3) / 4);
    if (threads == 0) return 0;
    strided_rows_kernel<<<(threads + 255) / 256, 256, 0, stream>>>(x, rows, cols, start, stride,
                                                                   out);
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
    if (m == 0 || n == 0) return 0;
    const dim3 grid((n + DOT_T - 1) / DOT_T, (m + DOT_T - 1) / DOT_T);
    small_dot_kernel<<<grid, DOT_WARPS * 32, 0, stream>>>(a, b, m, k, n, out);
    return (int)cudaGetLastError();
}
