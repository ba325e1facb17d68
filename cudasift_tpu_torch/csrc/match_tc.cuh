// The tile skeleton shared by the two matcher kernels on Hopper's tensor
// cores: K4 (csrc/match.cu) and K5 (csrc/match_sweep.cu).
//
// A block of THREADS = 8 warps owns BM = 64 * WM query rows (the first set)
// at the whole depth of 128. It stages them once into shared memory, already
// split into the operand halves its products need, and then streams the
// second set through a two-stage ring of BN = 64-column tiles: 16-byte
// cp.async.cg copies of tile t + 1 are in flight while tile t is
// multiplied. Columns at or past the live count n2 (read on the device) are
// zero-filled in the ring and never read from device memory; the epilogues
// mask them. Warp w computes the 16 * WM rows from 16 * WM * (w % 4)
// against columns 32 * (w / 4) .. + 31 of each tile, WM x 4 blocks of
// 16 x 8, with warp-level mma.sync (no side effects, so not volatile: the
// compiler may interleave them with the fragment loads):
//   m16n8k8  .tf32 (K4's default tier, three products of a split),
//   m16n8k16 .bf16 (K5's three-product split and K4's use_bf16 tier),
// both with float32 accumulation. Fragment layout (g = lane / 4,
// q = lane % 4): A holds rows g and g + 8, B one column (row of the second
// set) g, C rows g and g + 8 at columns 2q and 2q + 1 of each n8 block.
//
// WM = 2 (32 x 32 warp tiles, 128 rows per block) was taken over WM = 1
// (16 x 32, 64 rows): twice the products per fragment load and per split
// column, and half the second set's traffic. On an H100 it was faster for
// K4's TF32 tier and for K5, and slower for K4's one-product bf16 tier,
// which loses its second resident block (PERF.md).
//
// Row strides are padded so that every fragment load is free of bank
// conflicts: 132 words where a thread reads one 32-bit word at column q
// (K4's tf32 A and B: rows land on banks 4g + q), 136 where it reads a bf16
// pair or a float2 at column 2q (rows land on banks 4g + q or, per half
// warp, 8g + 2q).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mtc {

constexpr int DIM = 128;            // descriptor length
constexpr int WM = 2;               // m16 row blocks per warp
constexpr int BM = 4 * 16 * WM;     // query rows per block: 4 row groups of warps
constexpr int BN = 64;              // columns of the second set per tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int NO_INDEX = 0x7fffffff;

// 16 bytes from global to shared memory, asynchronously; with src_bytes = 0
// nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
                 "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issue the copies of columns [c0, c0 + BN) of the second set into one
// ring stage (BN rows of STRIDE floats); rows at or past n2 are zeros.
template <int STRIDE>
__device__ __forceinline__ void load_tile(float* stage, const float* __restrict__ d2, int c0,
                                          int n2) {
    for (int i = threadIdx.x; i < BN * DIM / 4; i += THREADS) {
        const int r = i / (DIM / 4), k = (i % (DIM / 4)) * 4;
        const bool live = c0 + r < n2;
        cp_async16(stage + r * STRIDE + k, live ? d2 + (size_t)(c0 + r) * DIM + k : d2,
                   live ? 16 : 0);
    }
}

// Row rr of the query block as four floats at column k; zeros at or past n1.
__device__ __forceinline__ float4 query4(const float* __restrict__ d1, int r0, int rr, int k,
                                         int n1) {
    if (r0 + rr >= n1) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    return *reinterpret_cast<const float4*>(d1 + (size_t)(r0 + rr) * DIM + k);
}

// ---- splits ---------------------------------------------------------------

// x rounded to TF32 as cvt.rna does: nearest, ties away from zero, 10
// mantissa bits (the low 13 bits of the result are zero).
__device__ __forceinline__ uint32_t to_tf32(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
    return r;
}

// big = tf32(x), small = tf32(x - big); x - big is exact in float32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
    big = to_tf32(x);
    small = to_tf32(x - __uint_as_float(big));
}

// A bfloat16 pair, x in the low half (the lower k index), each rounded to
// nearest even as PyTorch's cast.
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
    __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
    return *reinterpret_cast<uint32_t*>(&v);
}

// hi = bf16(x, y), lo = bf16(x - hi.x, y - hi.y): the split of the TPU
// sweep kernel and of ops/match.py:split_bf16.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = pack_bf16(x - __low2float(h), y - __high2float(h));
}

// ---- warp-level products ----------------------------------------------------

// c += a (16 x 8, tf32, row) . b (8 x 8, tf32, col)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of one k step (the caller's row = its 16-row group + g):
// words k0 + q and k0 + q + 4 of rows row and row + 8 of a row-major block of
// 32-bit words, `stride` words per row. A word is one tf32 value (m16n8k8,
// k0 = 8 per step) or a bf16 pair (m16n8k16, k0 = 8 pairs per step).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const uint32_t* block, int stride,
                                       int row, int k0, int q) {
    const uint32_t* p = block + row * stride + k0 + q;
    a[0] = p[0];
    a[1] = p[8 * stride];
    a[2] = p[4];
    a[3] = p[8 * stride + 4];
}

}  // namespace mtc
