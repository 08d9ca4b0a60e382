// Building blocks of the tensor-core attention kernels for Hopper (sm_90a):
// mma.sync m16n8k16 in bf16 with fp32 accumulation, ldmatrix, a cp.async ring
// of swizzled bf16 tiles in shared memory, and the packed-row mask on
// fragment coordinates.  attention_fwd.cu builds its tensor-core forward
// kernel from them, attention_bwd.cu its dq and dk/dv kernels.
//
// Fragment layouts of mma.sync.aligned.m16n8k16.row.col (g = lane / 4,
// t = lane % 4; every register holds two bf16, the lower column in the lower
// half):
//   A (16 x 16, row-major)  a0 (g, 2t..2t+1)   a1 (g+8, 2t..2t+1)
//                           a2 (g, 2t+8..2t+9) a3 (g+8, 2t+8..2t+9)
//   B (16 x 8, by columns)  b0 (k = 2t..2t+1, n = g)  b1 (k = 2t+8..2t+9, n = g)
//   C (16 x 8, fp32)        c0 c1 (g, 2t..2t+1)       c2 c3 (g+8, 2t..2t+1)
// So the C fragments of two neighbouring 8-column tiles, rounded to bf16 and
// packed in pairs, are the A fragment of a product whose depth runs over
// those 16 columns (pack_a_from_c): p and ds never pass through shared memory.
//
// A streamed tile is TILE rows of D bf16 (a row is 16-byte chunks of 8
// values).  B of a product over the head dim (S = Q.K^T) is the tile read
// with ldmatrix as it lies; B of a product over the tile's rows (dq = dS.K)
// is the same tile read with ldmatrix.trans.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn_mma {

constexpr int TILE = 64;      // rows of a tile, on the block's own side and on the streamed side
constexpr int THREADS = 128;  // 4 warps; each owns 16 rows of the block's own tile
constexpr int STAGES = 2;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Offset, in elements, of 16-byte chunk `chunk` of row `row` in a [TILE][D]
// bf16 tile.  The eight rows one ldmatrix reads at one chunk index must fall
// into different banks, i.e. onto the eight 16-byte slots of a 128-byte line:
// rows of at least 128 bytes (D >= 64) take chunk ^ (row & 7); shorter rows
// share a line (two at D = 32, four at D = 16), so the index of the row's
// group of lines is XORed in.
template <int D>
__device__ __forceinline__ int swz(int row, int chunk) {
    static_assert(D == 16 || D == 32 || D == 64 || D == 128, "head dim 16, 32, 64 or 128");
    constexpr int CH = D / 8;  // 16-byte chunks a row
    if constexpr (CH >= 8) {
        return row * D + ((chunk ^ (row & 7)) << 3);
    } else {
        constexpr int ROWS_A_LINE = 8 / CH;
        return row * D + ((chunk ^ ((row / ROWS_A_LINE) & (CH - 1))) << 3);
    }
}

// ---- cp.async: src_bytes < the copy size zero-fills the rest

__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, int src_bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows row0 .. row0+TILE-1 of an (s, ld) stripe into a swizzled tile of D
// columns, 16 bytes a thread and copy; rows past s and the chunks past ld
// (ld a multiple of 8) are zero-filled (garbage times p = 0 would be NaN in
// an accumulator; a zero column adds nothing to a product over the head dim).
// A copy of 0 source bytes reads nothing, so its address may lie past the
// stripe: the thread's copies are then one address plus constants on both
// sides (STEP rows apart, a multiple of the 8 rows after which the swizzle
// repeats).
template <int D>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* tile, const __nv_bfloat16* stripe,
                                                int row0, int s, int ld, int tid) {
    constexpr int CH = D / 8;
    constexpr int STEP = THREADS / CH;  // rows between two copies of one thread
    const int r = tid / CH, c = tid % CH;
    const int bytes = c * 8 < ld ? 16 : 0;  // a chunk past ld reads nothing
    const int step = STEP * ld;
    const __nv_bfloat16* src = stripe + (size_t)(row0 + r) * ld + c * 8;
    const uint32_t dst = smem_u32(tile + swz<D>(r, c));
#pragma unroll
    for (int i = 0; i < TILE / STEP; ++i) {
        cp_async_16(dst + i * STEP * D * 2, src + i * step, row0 + r + i * STEP < s ? bytes : 0);
    }
}

// Element i of a TILE-long slice of a per-row vector (ids, lse, delta); 0 past s.
template <typename T>
__device__ __forceinline__ void load_row_async(T* dst, const T* vec, int row0, int s, int i) {
    static_assert(sizeof(T) == 4, "4-byte elements");
    cp_async_4(smem_u32(dst + i), vec + row0 + i, row0 + i < s ? 4 : 0);
}

// ---- ldmatrix and mma

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

// c (16 x 8, fp32) += a (16 x 16, bf16) . b (16 x 8, bf16)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B fragments of two neighbouring 8-row groups of the tile for one 16-deep
// step over the head dim: r[0], r[1] for rows n0 .. n0+7, r[2], r[3] for
// rows n0+8 .. n0+15 (the product's columns are the tile's rows).
template <int D>
__device__ __forceinline__ void load_b_rows(uint32_t (&r)[4], const __nv_bfloat16* tile, int n0, int kstep, int lane) {
    const int row = n0 + (lane & 7) + ((lane >> 4) << 3);
    const int chunk = kstep * 2 + ((lane >> 3) & 1);
    ldmatrix_x4(r, smem_u32(tile + swz<D>(row, chunk)));
}

// B fragments for a product whose depth runs over the tile's rows k0 .. k0+15:
// r[0], r[1] for the head-dim columns n0 .. n0+7, r[2], r[3] for n0+8 .. n0+15.
template <int D>
__device__ __forceinline__ void load_b_cols(uint32_t (&r)[4], const __nv_bfloat16* tile, int k0, int n0, int lane) {
    const int row = k0 + (lane & 15);
    const int chunk = n0 / 8 + (lane >> 4);
    ldmatrix_x4_trans(r, smem_u32(tile + swz<D>(row, chunk)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t x) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
}

// A fragments of rows r0 .. r0+15 of a swizzled tile for the 16-deep step kk
// over the head dim, read with ldmatrix as the tile lies (lanes 0-15 address
// the rows at chunk 2 kk, lanes 16-31 at chunk 2 kk + 1).
template <int D>
__device__ __forceinline__ void load_a_smem(uint32_t (&a)[4], const __nv_bfloat16* tile, int r0, int kk, int lane) {
    ldmatrix_x4(a, smem_u32(tile + swz<D>(r0 + (lane & 15), kk * 2 + (lane >> 4))));
}

// C fragments of the 8-column tiles 2i (even) and 2i+1 (odd), rounded to
// bf16, as the A fragment of the 16-deep step i of the next product.
__device__ __forceinline__ void pack_a_from_c(uint32_t (&a)[4], const float (&even)[4], const float (&odd)[4]) {
    a[0] = pack_bf16(even[0], even[1]);
    a[1] = pack_bf16(even[2], even[3]);
    a[2] = pack_bf16(odd[0], odd[1]);
    a[3] = pack_bf16(odd[2], odd[3]);
}

// A fragments of rows r_lo and r_hi (= r_lo + 8) of an (s, ld) stripe, read
// from device memory once; a row past s and the columns past ld (ld a
// multiple of 8) read as zeros.
template <int D>
__device__ __forceinline__ void load_a_global(uint32_t (&a)[D / 16][4], const __nv_bfloat16* stripe, int r_lo,
                                              int r_hi, int s, int ld, int t) {
    const uint32_t* lo = reinterpret_cast<const uint32_t*>(stripe + (size_t)(r_lo < s ? r_lo : 0) * ld);
    const uint32_t* hi = reinterpret_cast<const uint32_t*>(stripe + (size_t)(r_hi < s ? r_hi : 0) * ld);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
        const int w = kk * 8 + t;  // 32-bit word holding columns 16 kk + 2t, +1
        // with ld a multiple of 8, a step's 8 low (high) columns lie before ld or past it together
        const bool in0 = 16 * kk < ld, in4 = 16 * kk + 8 < ld;
        a[kk][0] = r_lo < s && in0 ? lo[w] : 0u;
        a[kk][1] = r_hi < s && in0 ? hi[w] : 0u;
        a[kk][2] = r_lo < s && in4 ? lo[w + 4] : 0u;
        a[kk][3] = r_hi < s && in4 ? hi[w + 4] : 0u;
    }
}

// ---- the mask

// 'block' sets a disallowed logit to -1e9; 'bias' adds +1 to an allowed one.
__device__ __forceinline__ float masked_logit(float dot, float scale, bool allowed, int bias_mode) {
    float logit = dot * scale;
    if (bias_mode) {
        logit += allowed ? 1.f : 0.f;
    } else if (!allowed) {
        logit = -1e9f;
    }
    return logit;
}

// same image, and with `causal` the key not after the query (global row indices)
__device__ __forceinline__ bool pair_allowed(int q_id, int kv_id, int q_pos, int k_pos, int causal) {
    return q_id == kv_id && (!causal || k_pos <= q_pos);
}

// ---- the grid

// The grid is one-dimensional.  Blocks that share a streamed stripe are
// neighbours (tile index fastest), unless `longest_first`: then the tile index
// is slowest, taken from the end where `from_end`, so that the blocks with the
// most tiles to stream are scheduled first.
__device__ __forceinline__ void block_coords(int n_tiles, int longest_first, bool from_end, int& bh, int& tile) {
    const int bid = blockIdx.x;
    if (longest_first) {
        const int nbh = gridDim.x / n_tiles;
        bh = bid % nbh;
        tile = from_end ? n_tiles - 1 - bid / nbh : bid / nbh;
    } else {
        tile = bid % n_tiles;
        bh = bid / n_tiles;
    }
}

// Blocks a SM the register allocation of a tensor-core kernel aims at: three
// (at most 168 registers a thread) up to D = 64; two at D = 128, whose o (or
// dq, dk and dv) accumulators alone are 64 registers each.
template <int D>
constexpr int min_blocks() {
    return D >= 128 ? 2 : 3;
}

// ---- the instantiations

// The head dims the kernels are compiled for.  The tensor-core kernels read
// and write rows of any width ld up to their D in place (16-byte chunks:
// ld a multiple of 8 in bf16, of 4 in fp32); for other widths, and for the
// CUDA-core kernels, the wrapper pads d up to the next D with zero columns.
// DROP selects the dropout mode.
template <int D_, bool DROP_>
struct Inst {
    static constexpr int D = D_;
    static constexpr bool DROP = DROP_;
};

// The instantiation that runs rows of ld columns: the smallest of the head
// dims above that holds them; 0 past the largest.
inline int instantiation_for(int ld) {
    return ld < 1 ? 0 : ld <= 16 ? 16 : ld <= 32 ? 32 : ld <= 64 ? 64 : ld <= 128 ? 128 : 0;
}

// fn(Inst<D, DROP>{}) for the instantiation of head dim d; cudaErrorInvalidValue for another d.
template <typename Fn>
cudaError_t dispatch(int d, bool drop, Fn fn) {
    switch (d) {
        case 16: return drop ? fn(Inst<16, true>{}) : fn(Inst<16, false>{});
        case 32: return drop ? fn(Inst<32, true>{}) : fn(Inst<32, false>{});
        case 64: return drop ? fn(Inst<64, true>{}) : fn(Inst<64, false>{});
        case 128: return drop ? fn(Inst<128, true>{}) : fn(Inst<128, false>{});
        default: return cudaErrorInvalidValue;
    }
}

// Sets the dynamic shared-memory limit of `kernel` where a block needs more
// than the default 48 KB.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// What the compiler and the card make of a kernel: out[0] registers a thread,
// out[1] local (spill) bytes a thread, out[2] resident blocks an SM, out[3]
// shared bytes a block.
template <typename Kernel>
cudaError_t kernel_info(Kernel kernel, int threads, size_t dynamic_smem, int* out) {
    cudaError_t err = cudaSuccess;
    if (dynamic_smem > 0) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dynamic_smem);
        if (err != cudaSuccess) return err;
    }
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, dynamic_smem);
    if (err != cudaSuccess) return err;
    out[0] = attr.numRegs;
    out[1] = (int)attr.localSizeBytes;
    out[2] = blocks;
    out[3] = (int)(attr.sharedSizeBytes + dynamic_smem);
    return cudaSuccess;
}

}  // namespace attn_mma
