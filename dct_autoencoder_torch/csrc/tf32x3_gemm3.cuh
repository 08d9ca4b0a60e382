// A three-channel matrix product on Hopper's tensor cores in 3xTF32, for the
// DCT kernels (dct_patchify.cu, idct_unpatchify.cu).
//
// For each batch index z and channel c in {0, 1, 2}:
//   C_c[m, n] = sum_k A_c[m, k] * B_c[k, n]
// One operand is a DCT matrix, the same for the three channels ("shared"),
// handed over already split into TF32 hi and lo parts
// (ops/dct.py::dct_matrix_tf32); the other is a per-channel fp32 plane,
// split in registers as it leaves shared memory (hi = tf32(x),
// lo = tf32(x - hi)).  Each product is lo*hi + hi*lo + hi*hi, summed in fp32
// in that order on mma.sync.m16n8k8 (lo*lo, ~2^-22 of the product, is
// dropped): about 22 significant bits, where one TF32 product keeps 11 and
// would cut the DC coefficient (~sqrt(H*W)/2) to three digits.  Each 16-deep
// stage is summed on the tensor cores from zero and added to the
// accumulator on the CUDA cores, since the tensor cores' own sums round
// toward zero.
//
// Layout: A (M x K) with k contiguous, B (K x N) with n contiguous.  Tiles
// stream through a STAGES-deep cp.async ring in shared memory, BK = 16 deep,
// one barrier a slice; rows are padded so that every fragment read hits 32
// different banks.  A 16-byte copy needs a row stride and a base that are
// multiples of 4 floats: the shared matrices and the kernels' own scratch
// planes are laid out so, and a per-channel operand that is not (a caller's
// planes of a width that is not a multiple of 4) is copied 4 bytes at a
// time (VEC = false).  What lies past M, N or K is zero-filled by the copy
// itself, so a ragged K-slice adds exact zeros.
//
// A block of 4 warps (2 x 2) owns a BM x BN tile of all three channels: a
// fragment of the shared operand, read once, feeds the three channels'
// products, and each thread ends with the three channels of each of its
// outputs in its own registers, so the epilogue (Op::store) can mix them.
// Two blocks an SM, up to 255 registers a thread: on an H100 a third block,
// capped at 168 registers, spilled and was 5-8 % slower, and 8 warps of
// 32 x 16 or 16 x 32 outputs (128 registers) were 8-16 % slower.
// The tile is the largest of 64 x 64, 32 x 64 and 32 x 32 that still gives
// every SM a block (one served image at 448 x 448 makes 49 blocks of
// 64 x 64 but 196 of 32 x 32).  Every output is summed over k in the same
// order whatever the tile, so the tile never changes a bit, and there are no
// atomics: two launches give the same bits.
//
// Op provides:  __device__ __forceinline__ void store(int z, int m, int n, const float v[3]) const;
#pragma once

#include <stdint.h>

#include <atomic>
#include <initializer_list>

#include "attn_mma.cuh"  // cp.async helpers, kernel_info

namespace tf32x3 {
// Internal linkage: each kernel library compiles its own copy.  With external
// linkage a function template's static local is one object (STB_GNU_UNIQUE)
// across all libraries in the process: the "shared-memory limit set" flag
// below once made the IDCT library skip setting its own limit, after the DCT
// library had launched the same instantiation, and its launch was refused.
namespace {

constexpr int BK = 16;
constexpr int THREADS = 128;
constexpr int STAGES = 3;
constexpr int A_LD = BK + 4;  // floats a row of an A tile: 20 rows x 4 banks apart cover all 32

template <int BN>
__host__ __device__ constexpr int b_ld() { return BN + 8; }  // B rows 8 banks apart: t*8 + g covers all 32

// An operand in device memory.  Shared: `p` the hi part, `lo` the lo part, one
// matrix.  Per-channel: `p` plane 0 of image 0; channel c of image z starts at
// p + z * batch + c * plane.
struct Operand {
    const float* p;
    const float* lo;
    int ld;
    long long plane;
    long long batch;
};

// Writes C_c of a row-major (B, 3, M, ld) plane stack.
struct StorePlane {
    float* out;
    int ld;
    long long plane, batch;
    __device__ __forceinline__ void store(int z, int m, int n, const float v[3]) const {
        float* o = out + z * batch + (long long)m * ld + n;
        o[0] = v[0];
        o[plane] = v[1];
        o[2 * plane] = v[2];
    }
};

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero), the 13 dropped bits cleared so that the value is exact: adding
// half of the dropped range to the sign-magnitude bits rounds the magnitude.
// Two integer operations (ops/dct.py::tf32_round does the same on the host);
// the cvt instruction itself made both kernels 8 % slower on an H100.
__device__ __forceinline__ uint32_t to_tf32(float x) {
    return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
    hi = to_tf32(x);
    lo = to_tf32(x - __uint_as_float(hi));  // x - hi is exact in fp32
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
        "{%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a*b, from a zero accumulator (no registers to clear)
__device__ __forceinline__ void mma_zero(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
        "{%10,%10,%10,%10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

// d (+)= lo*hi + hi*lo + hi*hi over one 8-deep slice, the small terms first;
// FIRST starts d from zero.
template <bool FIRST>
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2], const uint32_t (&bl)[2]) {
    if constexpr (FIRST)
        mma_zero(d, al, bh);
    else
        mma(d, al, bh);
    mma(d, ah, bl);
    mma(d, ah, bh);
}

// Copy a ROWS x COLS tile whose top-left element is `src` (row stride ld) into
// dst[ROWS][LDS]; rows >= rows_left and columns >= cols_left are zero-filled.
// `src` itself always lies inside the matrix, so it is the address of the
// copies that read nothing.
template <int ROWS, int COLS, int LDS, bool VEC>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int ld, int rows_left, int cols_left,
                                          int tid) {
    if constexpr (VEC) {
        constexpr int CPR = COLS / 4;  // 16-byte chunks a row
        static_assert((ROWS * CPR) % THREADS == 0, "whole chunks a thread");
#pragma unroll
        for (int it = 0; it < ROWS * CPR / THREADS; ++it) {
            const int i = tid + it * THREADS;
            const int r = i / CPR, c = (i % CPR) * 4;
            const int bytes = r < rows_left ? 4 * max(0, min(4, cols_left - c)) : 0;
            const float* s = bytes ? src + (long long)r * ld + c : src;
            attn_mma::cp_async_16(attn_mma::smem_u32(dst + r * LDS + c), s, bytes);
        }
    } else {
        static_assert((ROWS * COLS) % THREADS == 0, "whole elements a thread");
#pragma unroll
        for (int it = 0; it < ROWS * COLS / THREADS; ++it) {
            const int i = tid + it * THREADS;
            const int r = i / COLS, c = i % COLS;
            const int bytes = (r < rows_left && c < cols_left) ? 4 : 0;
            const float* s = bytes ? src + (long long)r * ld + c : src;
            attn_mma::cp_async_4(attn_mma::smem_u32(dst + r * LDS + c), s, bytes);
        }
    }
}

template <int BM, int BN, bool SHARED_A>
__host__ __device__ constexpr int stage_floats() {
    return (SHARED_A ? 2 : 3) * BM * A_LD + (SHARED_A ? 3 : 2) * BK * b_ld<BN>();
}

template <int BM, int BN, bool SHARED_A>
constexpr size_t smem_bytes() {
    return sizeof(float) * STAGES * stage_floats<BM, BN, SHARED_A>();
}

template <int BM, int BN, bool SHARED_A, bool VEC, class Op>
__global__ void __launch_bounds__(THREADS, 2)
    gemm3_kernel(Operand a, Operand b, int M, int N, int K, Op op) {
    constexpr int BLD = b_ld<BN>();
    constexpr int WM = BM / 2, WN = BN / 2;  // a warp's tile
    constexpr int MI = WM / 16, NI = WN / 8;
    constexpr int A_TILE = BM * A_LD, B_TILE = BK * BLD;
    constexpr int A_TILES = SHARED_A ? 2 : 3;
    extern __shared__ __align__(16) float smem[];

    const int z = blockIdx.z;
    const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int wm0 = (warp >> 1) * WM, wn0 = (warp & 1) * WN;

    // the tile origins of this block in each operand (k = 0)
    const float* a_hi = SHARED_A ? a.p + (long long)m0 * a.ld : a.p + z * a.batch + (long long)m0 * a.ld;
    const float* a_lo = SHARED_A ? a.lo + (long long)m0 * a.ld : nullptr;
    const float* b_hi = SHARED_A ? b.p + z * b.batch + n0 : b.p + n0;
    const float* b_lo = SHARED_A ? nullptr : b.lo + n0;

    auto load_stage = [&](int s, int k0) {
        float* as = smem + s * stage_floats<BM, BN, SHARED_A>();
        float* bs = as + A_TILES * A_TILE;
        const int kleft = K - k0;
        if constexpr (SHARED_A) {
            load_tile<BM, BK, A_LD, true>(as, a_hi + k0, a.ld, M - m0, kleft, tid);
            load_tile<BM, BK, A_LD, true>(as + A_TILE, a_lo + k0, a.ld, M - m0, kleft, tid);
#pragma unroll
            for (int c = 0; c < 3; ++c)
                load_tile<BK, BN, BLD, VEC>(bs + c * B_TILE, b_hi + c * b.plane + (long long)k0 * b.ld, b.ld,
                                            kleft, N - n0, tid);
        } else {
#pragma unroll
            for (int c = 0; c < 3; ++c)
                load_tile<BM, BK, A_LD, VEC>(as + c * A_TILE, a_hi + c * a.plane + k0, a.ld, M - m0, kleft, tid);
            load_tile<BK, BN, BLD, true>(bs, b_hi + (long long)k0 * b.ld, b.ld, kleft, N - n0, tid);
            load_tile<BK, BN, BLD, true>(bs + B_TILE, b_lo + (long long)k0 * b.ld, b.ld, kleft, N - n0, tid);
        }
    };

    float acc[3][MI][NI][4];
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int j = 0; j < NI; ++j)
#pragma unroll
                for (int r = 0; r < 4; ++r) acc[c][i][j][r] = 0.f;

    // A fragment (16 x 8) of rows row0.. and columns kk..: a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
    auto a_frag = [&](const float* as, int row0, int kk, float (&v)[4]) {
        const float* p = as + (row0 + g) * A_LD + kk + t;
        v[0] = p[0];
        v[1] = p[8 * A_LD];
        v[2] = p[4];
        v[3] = p[8 * A_LD + 4];
    };
    // B fragment (8 x 8) of rows kk.. and columns col0..: b0 (k = t, n = g), b1 (k = t+4, n = g)
    auto b_frag = [&](const float* bs, int kk, int col0, float (&v)[2]) {
        const float* p = bs + (kk + t) * BLD + col0 + g;
        v[0] = p[0];
        v[1] = p[4 * BLD];
    };

    // The tensor cores round their fp32 sums toward zero.  Chained on acc over
    // K = 448 (168 mma in a row) the biased error reached 1.3e-5 of the DC
    // coefficient, ten times an fp32 product's; so each stage's products (two
    // 8-deep slices, six mma) are summed on the tensor cores from zero and
    // added to acc on the CUDA cores, which round to nearest, and a stage's
    // truncation is that of ~1/28 of the total.
    constexpr int KS = BK / 8;  // 8-deep slices a stage
    auto add = [](float (&acc_)[4], const float (&d)[4]) {
#pragma unroll
        for (int r = 0; r < 4; ++r) acc_[r] += d[r];
    };
    auto compute_stage = [&](int s) {
        const float* as = smem + s * stage_floats<BM, BN, SHARED_A>();
        const float* bs = as + A_TILES * A_TILE;
        if constexpr (SHARED_A) {
            uint32_t ah[KS][MI][4], al[KS][MI][4];
#pragma unroll
            for (int q = 0; q < KS; ++q)
#pragma unroll
                for (int i = 0; i < MI; ++i) {
                    float h[4], l[4];
                    a_frag(as, wm0 + i * 16, 8 * q, h);
                    a_frag(as + A_TILE, wm0 + i * 16, 8 * q, l);
#pragma unroll
                    for (int r = 0; r < 4; ++r) {
                        ah[q][i][r] = __float_as_uint(h[r]);
                        al[q][i][r] = __float_as_uint(l[r]);
                    }
                }
#pragma unroll
            for (int c = 0; c < 3; ++c)
#pragma unroll
                for (int j = 0; j < NI; ++j) {
                    uint32_t bh[KS][2], bl[KS][2];
#pragma unroll
                    for (int q = 0; q < KS; ++q) {
                        float v[2];
                        b_frag(bs + c * B_TILE, 8 * q, wn0 + j * 8, v);
                        split(v[0], bh[q][0], bl[q][0]);
                        split(v[1], bh[q][1], bl[q][1]);
                    }
#pragma unroll
                    for (int i = 0; i < MI; ++i) {
                        float d[4];
                        mma3<true>(d, ah[0][i], al[0][i], bh[0], bl[0]);
#pragma unroll
                        for (int q = 1; q < KS; ++q) mma3<false>(d, ah[q][i], al[q][i], bh[q], bl[q]);
                        add(acc[c][i][j], d);
                    }
                }
        } else {
            uint32_t bh[KS][NI][2], bl[KS][NI][2];
#pragma unroll
            for (int q = 0; q < KS; ++q)
#pragma unroll
                for (int j = 0; j < NI; ++j) {
                    float h[2], l[2];
                    b_frag(bs, 8 * q, wn0 + j * 8, h);
                    b_frag(bs + B_TILE, 8 * q, wn0 + j * 8, l);
#pragma unroll
                    for (int r = 0; r < 2; ++r) {
                        bh[q][j][r] = __float_as_uint(h[r]);
                        bl[q][j][r] = __float_as_uint(l[r]);
                    }
                }
#pragma unroll
            for (int c = 0; c < 3; ++c)
#pragma unroll
                for (int i = 0; i < MI; ++i) {
                    uint32_t ah[KS][4], al[KS][4];
#pragma unroll
                    for (int q = 0; q < KS; ++q) {
                        float v[4];
                        a_frag(as + c * A_TILE, wm0 + i * 16, 8 * q, v);
#pragma unroll
                        for (int r = 0; r < 4; ++r) split(v[r], ah[q][r], al[q][r]);
                    }
#pragma unroll
                    for (int j = 0; j < NI; ++j) {
                        float d[4];
                        mma3<true>(d, ah[0], al[0], bh[0][j], bl[0][j]);
#pragma unroll
                        for (int q = 1; q < KS; ++q) mma3<false>(d, ah[q], al[q], bh[q][j], bl[q][j]);
                        add(acc[c][i][j], d);
                    }
                }
        }
    };

    const int KT = (K + BK - 1) / BK;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < KT) load_stage(s, s * BK);
        attn_mma::cp_async_commit();
    }
    for (int kt = 0; kt < KT; ++kt) {
        attn_mma::cp_async_wait<STAGES - 2>();
        __syncthreads();  // slice kt has landed for every thread; slice kt-1's buffer is free
        const int next = kt + STAGES - 1;
        if (next < KT) load_stage(next % STAGES, next * BK);
        attn_mma::cp_async_commit();
        compute_stage(kt % STAGES);
    }

    // C fragment: c0 c1 (g, 2t..2t+1), c2 c3 (g+8, 2t..2t+1)
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int m = m0 + wm0 + i * 16 + g + (r >= 2 ? 8 : 0);
                const int n = n0 + wn0 + j * 8 + 2 * t + (r & 1);
                if (m < M && n < N) {
                    const float v[3] = {acc[0][i][j][r], acc[1][i][j][r], acc[2][i][j][r]};
                    op.store(z, m, n, v);
                }
            }
}

// Per-device host caches: what a launch asks of the runtime once for each
// device.  Only answers that succeeded are kept (0 means not asked yet).
constexpr int MAX_DEVICES = 64;

inline cudaError_t current_device(int& dev) {
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess && (dev < 0 || dev >= MAX_DEVICES)) err = cudaErrorInvalidDevice;
    return err;
}

inline cudaError_t num_sms(int dev, int& sms) {
    static std::atomic<int> cache[MAX_DEVICES];
    sms = cache[dev].load(std::memory_order_relaxed);
    if (sms > 0) return cudaSuccess;
    cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) cache[dev].store(sms, std::memory_order_relaxed);
    return err;
}

template <int BM, int BN, bool SHARED_A, bool VEC, class Op>
cudaError_t launch_tile(int dev, const Operand& a, const Operand& b, int M, int N, int K, int batch, const Op& op,
                        cudaStream_t stream) {
    auto kernel = gemm3_kernel<BM, BN, SHARED_A, VEC, Op>;
    constexpr size_t smem = smem_bytes<BM, BN, SHARED_A>();
    // the shared-memory limit of this instantiation, set once a device
    static std::atomic<int> limit_set[MAX_DEVICES];
    if (!limit_set[dev].load(std::memory_order_relaxed)) {
        cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
        limit_set[dev].store(1, std::memory_order_relaxed);
    }
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
    kernel<<<grid, THREADS, smem, stream>>>(a, b, M, N, K, op);
    return cudaGetLastError();
}

// C_c = A_c . B_c for z < batch, the tile picked by the number of blocks.
template <bool SHARED_A, bool VEC, class Op>
cudaError_t launch(const Operand& a, const Operand& b, int M, int N, int K, int batch, const Op& op,
                   cudaStream_t stream) {
    if (batch == 0 || M == 0 || N == 0) return cudaSuccess;
    if (K <= 0) return cudaErrorInvalidValue;
    int dev = 0, sms = 0;
    cudaError_t err = current_device(dev);
    if (err == cudaSuccess) err = num_sms(dev, sms);
    if (err != cudaSuccess) return err;
    auto blocks = [&](int bm, int bn) { return (long long)((M + bm - 1) / bm) * ((N + bn - 1) / bn) * batch; };
    if (blocks(64, 64) >= sms) return launch_tile<64, 64, SHARED_A, VEC>(dev, a, b, M, N, K, batch, op, stream);
    if (blocks(32, 64) >= sms) return launch_tile<32, 64, SHARED_A, VEC>(dev, a, b, M, N, K, batch, op, stream);
    return launch_tile<32, 32, SHARED_A, VEC>(dev, a, b, M, N, K, batch, op, stream);
}

// registers, spill bytes, blocks an SM and shared bytes of the 64 x 64 instantiation
template <bool SHARED_A, bool VEC, class Op>
cudaError_t info(int* out) {
    return attn_mma::kernel_info(gemm3_kernel<64, 64, SHARED_A, VEC, Op>, THREADS, smem_bytes<64, 64, SHARED_A>(), out);
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Colour constants of the DCT kernels' pre-pass and epilogue (float32 casts of
// the float64 matrices in ops/colorspace.py), passed by value to a kernel.
struct Color3x3 {
    float m[9];
};

inline Color3x3 color(const float* m) {
    Color3x3 c;
    for (int i = 0; i < 9; ++i) c.m[i] = m[i];
    return c;
}

// sign(x) * |x|^g in the kernels' exp/log form.
__device__ __forceinline__ float signed_pow(float x, float g) {
    const float mag = expf(g * logf(fmaxf(fabsf(x), 1e-30f)));
    return x > 0.f ? mag : (x < 0.f ? -mag : 0.f);
}

}  // namespace
}  // namespace tf32x3
