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
// Bound: bytes. The function needs only the windows, 12,288 B a keypoint;
// the arithmetic is one add per element. A window is cut into at most four
// pieces where it wraps (rows at 56, columns at 256; `piece` below, restated
// in numpy as ops/cuda/acquire.py::window_boxes); on the bench's inputs every
// window is one piece. A piece that lies inside the image is loaded whole;
// one that leaves it takes the clamped branch, scalar loads clamped to the
// image, in both kernels. One block of 256 threads per group of 8 keypoints.
//
//   staged -- the counterpart of the DMA, on the Tensor Memory Accelerator:
//     the launcher encodes one 2-D tensor map over the image (box 48 rows x
//     68 columns, no swizzle) and passes it by value as a __grid_constant__
//     parameter. A box's first column must lie on a 16-byte word (a box
//     that starts off one stopped the kernel with an illegal instruction on
//     the H100), so each piece's box starts at the word that holds the
//     piece's first column, and 68 columns cover the piece's 64 from any of
//     the word's four places. Warp 0 cuts the block's 32 possible pieces, a
//     lane each, and lists them by ballot; the lane of the k-th inside
//     piece arms slot k's mbarrier with the box's 13,056 bytes and issues
//     its cp.async.bulk.tensor, eight slots (102 KB of dynamic shared
//     memory, so the launcher opts in past the 48 KB default) in flight,
//     more pieces in further rounds of the ring. A piece smaller than the
//     window (a wrapped window) sums only its own rows and columns of its
//     box (the box may overhang the image: TMA fills what lies outside,
//     which is never summed). The threads sum each slot with 16-byte
//     shared-memory reads as soon as its barrier completes, a whole window
//     in three unmasked words a thread and two masked edge words a row. On
//     this card the copies are not what a block waits for, the cutting,
//     listing and summing around them are (a block of 8 boxes took as long
//     with the copies left out), hence the ballot and the unmasked sums. An
//     image that TMA cannot address (a row pitch not a multiple of 16
//     bytes, a base not on 16 bytes) or smaller than the box takes the
//     clamped branch for every piece.
//   direct -- the counterpart of the VMEM-resident image: a warp per
//     keypoint reads its window straight from global memory through the
//     cache in aligned 16-byte words (a row of 64 columns spans at most 17;
//     lanes mask the elements outside the piece), issuing a batch of loads
//     before it adds any. Words are aligned on the address, so an odd width
//     or an unaligned base needs no other path; the first and last word of
//     a row may reach up to 12 bytes past the piece, inside one 16-byte
//     word of the image's own memory.

#include <cuda.h>           // CUtensorMap and the encoder's types; no driver call is linked
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int B = 8;               // keypoints per output block
constexpr int PR = 56, PWR = 256;  // aligned patch
constexpr int P = 48, PW = 64;     // summed window
constexpr int THREADS = 256;
constexpr int WORDS = PW / 4 + 1;  // aligned 16-byte words a row of 64 may span
constexpr int BOX_W = 4 * WORDS;   // TMA box: P rows of BOX_W columns
constexpr int SLOTS = 8;           // TMA boxes in flight per block
constexpr int BOX = P * BOX_W;     // floats in a box
constexpr int BOX_BYTES = BOX * 4;
constexpr size_t STAGED_SMEM = (size_t)SLOTS * BOX_BYTES + 128;   // + room to align to 128

__device__ __forceinline__ int wrap(int v, int m) {
    v %= m;
    return v < 0 ? v + m : v;
}

__device__ __forceinline__ float at(const float* __restrict__ img, int h, int w, int r, int c) {
    r = min(max(r, 0), h - 1);
    c = min(max(c, 0), w - 1);
    return __ldg(img + (size_t)r * w + c);
}

// Piece q (0-3) of a window: its rows are cut where r + ry reaches 56 (the
// first part from patch row ry, the second from patch row 0), its columns
// where c + rx reaches 256; (y, x) its first pixel in the image, rows or
// cols 0 when the window does not wrap there.
struct Piece {
    int y, x, rows, cols;
};

__device__ __forceinline__ Piece piece(int q, int oy, int ox, int ry, int rx) {
    const int r1 = min(P, PR - ry), c1 = min(PW, PWR - rx);
    const bool lower = q >> 1, right = q & 1;
    return {oy + (lower ? 0 : ry), ox + (right ? 0 : rx), lower ? P - r1 : r1,
            right ? PW - c1 : c1};
}

__device__ __forceinline__ bool inside(const Piece& p, int h, int w) {
    return p.y >= 0 && p.y + p.rows <= h && p.x >= 0 && p.x + p.cols <= w;
}

// Sum of the clamped reads of a piece, element e = lane, lane + stride, ...
__device__ float sum_clamped(const float* __restrict__ img, int h, int w, const Piece& p,
                             int lane, int stride) {
    float acc = 0.0f;
    for (int e = lane; e < p.rows * p.cols; e += stride)
        acc += at(img, h, w, p.y + e / p.cols, p.x + e % p.cols);
    return acc;
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
    float4* o = reinterpret_cast<float4*>(out + (size_t)blockIdx.x * 8 * 128);
    const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float4 s = make_float4(total, total, total, total);
    o[threadIdx.x] = threadIdx.x < 128 / 4 ? s : z;   // 256 threads, 256 words
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
                 "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
    unsigned done = 0;
    while (!done) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(smem_addr(bar)), "r"(parity)
            : "memory");
    }
}

// One (48, 68) box of the map at column x (a multiple of 4), row y into
// dst; completes on bar.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, int x, int y,
                                        uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_addr(bar))
        : "memory");
}

// Sum of a piece out of its box in shared memory: word j of box row r holds
// box columns 4j .. 4j + 3, the piece's columns are o .. o + cols - 1 with o
// = x & 3 (the box starts at the word that holds column x). A whole window
// (48 x 64): thread t adds word t % 16 of rows t / 16, + 16, + 32, all
// inside the piece but word 0 (columns from o on), and threads t < 48 add
// word 16 of row t (columns below o). Any other piece masks every word.
__device__ __forceinline__ float sum_box(const float* box, int4 p, int t) {
    const float4* b4 = reinterpret_cast<const float4*>(box);
    const int o = p.y & 3;
    float acc = 0.0f;
    if (p.z == P && p.w == PW) {
        const int j = t & 15, r = t >> 4;
        const float4 a = b4[r * WORDS + j], b = b4[(r + 16) * WORDS + j],
                     c = b4[(r + 32) * WORDS + j];
        const float4 v = make_float4(a.x + b.x + c.x, a.y + b.y + c.y, a.z + b.z + c.z,
                                     a.w + b.w + c.w);
        acc = j ? (v.x + v.y) + (v.z + v.w)
                : ((o == 0 ? v.x : 0.0f) + (o <= 1 ? v.y : 0.0f)) + ((o <= 2 ? v.z : 0.0f) + v.w);
        if (t < P) {
            const float4 e = b4[t * WORDS + WORDS - 1];
            acc += (0 < o ? e.x : 0.0f) + (1 < o ? e.y : 0.0f) + (2 < o ? e.z : 0.0f);
        }
        return acc;
    }
    for (int e4 = t; e4 < BOX / 4; e4 += THREADS) {
        const int r = e4 / WORDS, j = e4 - r * WORDS;
        const int lo = o - 4 * j, hi = lo + p.w;   // the piece's elements of this word
        if (r >= p.z || hi <= 0) continue;
        const float4 v = b4[e4];
        acc += (0 >= lo && 0 < hi ? v.x : 0.0f) + (1 >= lo && 1 < hi ? v.y : 0.0f) +
               (2 >= lo && 2 < hi ? v.z : 0.0f) + (3 >= lo && 3 < hi ? v.w : 0.0f);
    }
    return acc;
}

template <bool ROLL>
__global__ void __launch_bounds__(THREADS)
staged_kernel(const __grid_constant__ CUtensorMap map, int tma_ok, const float* __restrict__ img,
              int h, int w, const int* __restrict__ oy, const int* __restrict__ ox,
              const int* __restrict__ rxy, int half, float* __restrict__ out,
              int* __restrict__ tma_pieces) {
    extern __shared__ unsigned char dyn[];
    __shared__ __align__(8) uint64_t bar[SLOTS];
    __shared__ int4 by_tma[B * 4];     // the pieces TMA loads, in order: (y, x, rows, cols)
    __shared__ int4 clamped[B * 4];    // the pieces the clamped branch reads
    __shared__ int counts[2];          // how many of each
    __shared__ float red[THREADS / 32];
    float* slots = reinterpret_cast<float*>(dyn + ((128 - (smem_addr(dyn) & 127)) & 127));
    const CUtensorMap* tmap = &map;   // its address in the parameter space
    const int t = threadIdx.x;

    // Warp 0: lane l cuts piece l % 4 of keypoint l / 4, the pieces are
    // listed by ballot, and the lane whose TMA piece has rank k arms slot
    // k % SLOTS and issues its box in round k / SLOTS.
    int rank = -1;
    Piece own = {0, 0, 0, 0};
    auto issue = [&](int slot) {
        mbar_expect(&bar[slot], BOX_BYTES);
        tma_box(slots + slot * BOX, tmap, own.x & ~3, own.y, &bar[slot]);
    };
    if (t < 32) {
        if (t == 0) {
            for (int s = 0; s < SLOTS; ++s) mbar_init(&bar[s]);
            asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        }
        __syncwarp();
        const int i = blockIdx.x * B + t / 4;
        const int ry = ROLL ? wrap(rxy[i], PR) : 0, rx = ROLL ? wrap(rxy[i + half], PWR) : 0;
        own = piece(t & 3, oy[i], ox[i], ry, rx);
        const bool live = own.rows > 0 && own.cols > 0;
        const bool tma = live && tma_ok && inside(own, h, w);
        const unsigned by_ballot = __ballot_sync(0xffffffffu, tma);
        const unsigned clamp_ballot = __ballot_sync(0xffffffffu, live && !tma);
        const unsigned below = (1u << t) - 1;
        const int4 q = make_int4(own.y, own.x, own.rows, own.cols);
        if (tma) {
            rank = __popc(by_ballot & below);
            by_tma[rank] = q;
            if (rank < SLOTS) issue(rank);
        } else if (live) {
            clamped[__popc(clamp_ballot & below)] = q;
        }
        if (t == 0) {
            counts[0] = __popc(by_ballot);
            counts[1] = __popc(clamp_ballot);
        }
    }
    __syncthreads();

    // The clamped pieces while the boxes fly, then each slot as it lands.
    const int ntma = counts[0], nclamp = counts[1];
    float acc = 0.0f;
    int landed = 0;                   // boxes whose barrier completed, summed
    for (int j = 0; j < nclamp; ++j) {
        const int4 p = clamped[j];
        acc += sum_clamped(img, h, w, {p.x, p.y, p.z, p.w}, t, THREADS);
    }
    for (int base = 0, round = 0; base < ntma; base += SLOTS, ++round) {
        if (round > 0) {
            __syncthreads();                  // every slot of the last round is read
            if (rank >= base && rank < base + SLOTS) {
                asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
                issue(rank - base);
            }
        }
        for (int s = 0; s < SLOTS && base + s < ntma; ++s) {
            const int4 p = by_tma[base + s];
            mbar_wait(&bar[s], round & 1);
            acc += sum_box(slots + s * BOX, p, t);
            ++landed;
        }
    }
    if (t == 0 && tma_pieces != nullptr) atomicAdd(tma_pieces, landed);
    write_block(out, block_sum(acc, red));
}

// Sum of a piece that lies inside the image, by one warp, in aligned 16-byte
// words: slot s of the rows x WORDS grid is word s % WORDS (from the word
// that holds the row's first element) of piece row s / WORDS. A lane issues
// BATCH loads, then masks and adds them.
__device__ float sum_words(const float* __restrict__ img, int w, const Piece& p, int lane) {
    constexpr int BATCH = 9;
    const int nslots = p.rows * WORDS;
    float acc = 0.0f;
    for (int s0 = 0; s0 < nslots; s0 += 32 * BATCH) {
        float4 v[BATCH];
#pragma unroll
        for (int b = 0; b < BATCH; ++b) {
            const int s = s0 + lane + 32 * b;
            const int r = s / WORDS, j = s - r * WORDS;
            const uintptr_t a = reinterpret_cast<uintptr_t>(img + (size_t)(p.y + r) * w + p.x);
            const uintptr_t word = (a & ~uintptr_t(15)) + 16 * j;
            v[b] = s < nslots && word < a + 4 * p.cols
                       ? __ldg(reinterpret_cast<const float4*>(word))
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
#pragma unroll
        for (int b = 0; b < BATCH; ++b) {
            const int s = s0 + lane + 32 * b;
            const int r = s / WORDS, j = s - r * WORDS;
            const uintptr_t a = reinterpret_cast<uintptr_t>(img + (size_t)(p.y + r) * w + p.x);
            // Elements lo <= e < hi of this word lie in the piece's row.
            const int lo = (int)(a & 15) / 4 - 4 * j;
            const int hi = lo + p.cols;
            acc += (0 >= lo && 0 < hi ? v[b].x : 0.0f) + (1 >= lo && 1 < hi ? v[b].y : 0.0f) +
                   (2 >= lo && 2 < hi ? v[b].z : 0.0f) + (3 >= lo && 3 < hi ? v[b].w : 0.0f);
        }
    }
    return acc;
}

template <bool ROLL>
__global__ void __launch_bounds__(THREADS)
direct_kernel(const float* __restrict__ img, int h, int w, const int* __restrict__ oy,
              const int* __restrict__ ox, const int* __restrict__ rxy, int half,
              float* __restrict__ out) {
    __shared__ float red[THREADS / 32];
    const int lane = threadIdx.x & 31;
    const int i = blockIdx.x * B + (threadIdx.x >> 5);   // a warp per keypoint
    const int ry = ROLL ? wrap(rxy[i], PR) : 0, rx = ROLL ? wrap(rxy[i + half], PWR) : 0;
    const int y0 = oy[i], x0 = ox[i];
    float acc = 0.0f;
    for (int q = 0; q < 4; ++q) {
        const Piece p = piece(q, y0, x0, ry, rx);
        if (p.rows == 0 || p.cols == 0) continue;
        acc += inside(p, h, w) ? sum_words(img, w, p, lane) : sum_clamped(img, h, w, p, lane, 32);
    }
    write_block(out, block_sum(acc, red));
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled through the runtime, so the library
// needs no -lcuda; null if the driver has none.
EncodeTiled encoder() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
        cudaError_t err =
            cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

constexpr int NO_ENCODER = -1000;

template <bool ROLL>
int launch_staged(const float* img, int h, int w, const int* oy, const int* ox, const int* rxy,
                  int half, int n, float* out, int* tma_pieces, cudaStream_t stream) {
    if (n == 0) return 0;
    CUtensorMap map;
    memset(&map, 0, sizeof(map));
    // TMA needs a row pitch and a base on 16 bytes; an image smaller than the
    // box holds no whole window, so it takes the clamped branch too.
    const int tma_ok = w % 4 == 0 && (reinterpret_cast<uintptr_t>(img) & 15) == 0 && h >= P &&
                       w >= BOX_W;
    if (tma_ok) {
        EncodeTiled encode = encoder();
        if (encode == nullptr) return NO_ENCODER;
        const cuuint64_t dims[2] = {(cuuint64_t)w, (cuuint64_t)h};
        const cuuint64_t strides[1] = {(cuuint64_t)w * sizeof(float)};
        const cuuint32_t box[2] = {BOX_W, P};
        const cuuint32_t unit[2] = {1, 1};
        const CUresult r = encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(img),
                                  dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                  CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
        if (r != CUDA_SUCCESS) return -(int)r;
    }
    cudaError_t err = cudaFuncSetAttribute(staged_kernel<ROLL>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)STAGED_SMEM);
    if (err != cudaSuccess) return (int)err;
    staged_kernel<ROLL><<<n / B, THREADS, STAGED_SMEM, stream>>>(map, tma_ok, img, h, w, oy, ox,
                                                                 rxy, half, out, tma_pieces);
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

// n keypoints (a multiple of 8) -> out (n / 8, 8, 128) f32. Returns the
// launch's cudaError_t; the staged launchers return a negative value when
// the tensor map could not be made: -CUresult of cuTensorMapEncodeTiled, or
// -1000 when the driver does not export it. Where tma_pieces is not null,
// the staged kernel adds to it the number of boxes that arrived by TMA (a
// block's thread 0 counts the barriers it waited on).
extern "C" int acquire_staged(const float* img, int h, int w, const int* oy, const int* ox,
                              const int* rxy, int half, int n, float* out, int* tma_pieces,
                              cudaStream_t stream) {
    return launch_staged<false>(img, h, w, oy, ox, rxy, half, n, out, tma_pieces, stream);
}

extern "C" int acquire_staged_roll(const float* img, int h, int w, const int* oy, const int* ox,
                                   const int* rxy, int half, int n, float* out, int* tma_pieces,
                                   cudaStream_t stream) {
    return launch_staged<true>(img, h, w, oy, ox, rxy, half, n, out, tma_pieces, stream);
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
