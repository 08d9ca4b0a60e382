// Packed block-diagonal attention, forward, for Hopper (sm_90a).
//
// Replaces dct_autoencoder_tpu/kernels/attention.py::_attn_fwd_kernel
// (called from _flash_attention_fwd_impl).  Same contract: q, k, v are
// (b, h, s, d); per-token segment ids arrive as q_ids / kv_ids (b, s) with
// padded queries at -2 and padded keys at -1, so the (s, s) mask is derived
// in the kernel and never stored.  mode 'block' sets a disallowed logit to
// -1e9; mode 'bias' adds +1 to an allowed logit.  Outputs o (b, h, s, d) in
// the input type and the row log-sum-exp lse (b, h, s) in float32, in
// natural-log units (the backward kernels recompute p from it).
//
// Both implementations below share one online softmax: the Pallas kernel
// keeps the whole k/v stripe in VMEM; a Hopper block cannot, so each block
// takes one (b*h, q tile) and streams 64-row k/v tiles through shared memory,
// carrying the row max m, the row sum l and the output accumulator in fp32.
// The running max starts at -5e8, which reproduces the reference clamp
// m = max(m, -5e8) exactly: a row whose keys are all masked keeps m = -5e8,
// gets p = exp(-1e9 + 5e8) = 0 everywhere, and ends with o = 0 and
// lse = -5e8 + log(1e-9), as in the reference; a fully masked tile met
// before a row's valid keys contributes nothing and is rescaled away.
// Keys past the end of a ragged last tile get -inf, so p = 0.  l sums the
// unrounded fp32 p; lse = m + log(max(l, 1e-9)).
//
// causal != 0 (dct_autoencoder_tpu/kernels/attention.py::_causal_allowed)
// ANDs k_pos <= q_pos into `allowed`; positions are the row indices the
// kernel already holds, so there is no new operand.  In 'bias' mode that
// only decides who gets the +1: future keys still take part in the softmax,
// as in the Pallas kernel, and nothing is skipped.  In 'block' mode with
// skip_tiles != 0 a block stops at its own diagonal tile: every later tile
// would be all -1e9, and such a tile leaves m, l and the accumulator bit for
// bit as they were (alpha = exp(0) = 1, p = exp(-1e9 - m) = 0 for every
// m >= -5e8), so o and lse do not depend on skip_tiles.  Blocks take their q
// tiles from the last to the first, so that the longest causal blocks are
// scheduled first.
//
// Head dims: every kernel is compiled for D = 16, 32, 64 and 128.  The
// tensor-core kernel reads and writes rows of any width d <= D that is a
// multiple of 8 in place (`ld`, rows d apart in device memory): its loads
// zero-fill the 16-byte chunks past d, as they zero-fill rows past s, and
// its stores write only columns < d.  For other widths, and for the
// CUDA-core kernel, the wrapper (kernels/attention.py) pads q, k and v with
// zero columns up to the next D and cuts o back.  Both are exact (a zero
// column adds nothing to q.k, and a zero v column only makes an o column
// that is not kept).
//
// Dropout (the `seed` argument, nullptr for none; the DROP instantiations):
// the softmax weights are dropped as the JAX package drops them on its XLA
// path, o_i = (1/l_i) sum_j p_ij z_ij v_j / (1 - rate), with z the keep bit
// of attn_dropout.cuh.  l and lse sum the undropped p, so the backward
// recomputes p from lse as before; the dropped p is zeroed after it entered
// l (in the tensor-core kernel after its rounding point: zeroing commutes with
// the bf16 rounding), and 1/(1 - rate) is applied in fp32 with 1/l at the
// end.  The mask is drawn only for the tiles a block computes.  The
// instantiations without dropout are the kernels as they were, so they keep
// their registers and times.
//
// Two implementations here (the `impl` argument of the entry point); the
// third, impl 2, "tf32x3", the float32 forward on the tensor cores in
// 3xTF32, is attention_fwd_tf32x3.cu, a library of its own:
//
// impl 1, "mma", bfloat16 only: attn_fwd_mma_kernel multiplies on the tensor
// cores (mma.sync m16n8k16, bf16 operands, fp32 accumulators; the building
// blocks are in attn_mma.cuh, shared with the backward kernels).
//   Bound on the H100: at the main-path shape (64 rows, 16 heads, s = 256,
//   d = 64) the call reads q, k, v and writes o, ~134 MB: 0.040 ms of
//   memory time; the 17 GFLOP of products over all pairs would take 0.017 ms
//   at the tensor cores' peak, and in 'block' mode only the allowed pairs
//   are counted, so the bound is bytes.  What holds the kernel above it is
//   inside the SM: one ldmatrix.x4 feeds two mma (a warp owns 16 rows), so
//   shared memory can keep the tensor cores at most half busy; the mask, the
//   max, the exp (ex2 runs at a sixteenth of the FMA rate) and the row sums
//   run on the CUDA cores between the two products of every tile; and at
//   s = 256 a block streams four tiles, so its prologue (its q rows, read from
//   device memory) and its epilogue are a large share of its life.
//   Design: 128 threads, four warps, each owning 16 query rows as A fragments
//   in registers for the whole block.  K and V tiles (64 x d bf16) and the
//   tile's kv ids stream through a two-stage cp.async ring (16-byte copies,
//   rows past the end zero-filled, chunks swizzled so that ldmatrix meets no
//   bank conflict).  S = Q.K^T comes out in accumulator layout; each thread
//   holds two rows and 16 of the tile's 64 columns, applies the mask on
//   fragment coordinates, and the row max goes over the quad that shares a
//   row (two shuffles).  p = 2^(logit * log2 e - m * log2 e) is one FMA and
//   one ex2.approx; the accumulator and l are rescaled by alpha = 2^((m_old -
//   m_new) log2 e).  p is rounded to bf16, packed as the A fragment of
//   O += P.V (V read with ldmatrix.trans) and never touches shared memory.
//   l is summed per thread and reduced over the quad once, at the end.
//   Blocks that share a k/v stripe are neighbours in the grid so that the
//   stripe is read from L2; with causal skipping the grid is ordered longest
//   block first instead.  Tried and dropped (PERF.md): 32 rows a warp, so
//   that each ldmatrix feeds four mma (254 registers, two blocks an SM, no
//   faster), a 128-row tile of eight warps, and a cap of 128 registers.
//   Rounding: as the Pallas kernel does (p.astype(v.dtype)), p is rounded to
//   bf16 before P.V; l, m and lse stay fp32, o is rounded once at the store.
//   The online softmax rounds p relative to the running max where Pallas
//   rounds it relative to the row's final max, so a p of a tile met before
//   the row's max can round to another bf16 value, and o can differ from the
//   Pallas kernel's (and from attention_fwd_plain) by one bf16 ulp now and
//   then.  That is inside the tolerance; no bit of the masking changes.
//
// impl 0, "simt": attn_fwd_kernel multiplies in float32 on the CUDA cores,
// keeps p in float32 and rounds once at the store.  It was the float32
// forward until the 3xTF32 kernel (one TF32 product would not hold 1e-5);
// float32 and bfloat16 take it only when asked, for timing the old design
// against the new ones on one card.  It is
// arithmetic-bound: ~17 GFLOP of fp32 FMAs at the main-path shape against
// 67 TFLOP/s, with two blocks an SM at d = 64 (128 registers a thread, 50 KB
// of shared memory).
// Design: four threads share one query row (16 keys and d/4 output columns
// each) and combine their row max and row sum with warp shuffles; k and v
// tiles are widened to fp32 in shared memory; p goes through shared memory
// for the second product.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "attn_dropout.cuh"
#include "attn_mma.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int SIMT_THREADS = 256;  // 4 threads per query row

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);
}

template <int D>
constexpr size_t smem_bytes() {
    return sizeof(float) * (BK * (D + 1) + BK * D + BQ * (BK + 1)) + sizeof(int) * BK;
}

template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(SIMT_THREADS)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const int* __restrict__ q_ids, const int* __restrict__ kv_ids,
                T* __restrict__ o, float* __restrict__ lse,
                int h, int s, float scale, int bias_mode, int causal, int skip_tiles, attn_drop::Params drop) {
    constexpr int KP = D + 1;       // padded k row (bank spread)
    constexpr int PP = BK + 1;      // padded p row
    constexpr int NK = BK / 4;      // keys per thread per tile
    constexpr int NC = D / 4;       // output columns per thread

    extern __shared__ float smem[];
    float* Ks = smem;                       // BK x KP
    float* Vs = Ks + BK * KP;               // BK x D
    float* Ps = Vs + BK * D;                // BQ x PP
    int* kid_s = reinterpret_cast<int*>(Ps + BQ * PP);  // BK

    const int bh = blockIdx.x;
    const int b = bh / h;
    const int tid = threadIdx.x;
    const int r = tid >> 2;
    const int sub = tid & 3;
    const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
    const int qi = q0 + r;
    const bool q_in = qi < s;

    const size_t base = (size_t)bh * s * D;
    const T* qb = q + base;
    const T* kb = k + base;
    const T* vb = v + base;

    float qr[D];
#pragma unroll
    for (int c = 0; c < D; ++c) qr[c] = q_in ? to_f(qb[(size_t)qi * D + c]) : 0.f;
    const int qid = q_in ? q_ids[(size_t)b * s + qi] : -3;

    float m = -5e8f;   // the reference's clamp on the row max
    float l = 0.f;
    uint2 key{};
    if constexpr (DROP) key = attn_drop::load_key(drop.seed);
    const int drow = drop.row0 + b, dhead = drop.head0 + bh % h;
    float acc[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[i] = 0.f;

    const int k_end = (causal && !bias_mode && skip_tiles) ? min(s, q0 + BQ) : s;
    for (int k0 = 0; k0 < k_end; k0 += BK) {
        for (int idx = tid; idx < BK * D; idx += SIMT_THREADS) {
            const int j = idx / D, c = idx % D;
            const int kj = k0 + j;
            float kv = 0.f, vv = 0.f;
            if (kj < s) {
                kv = to_f(kb[(size_t)kj * D + c]);
                vv = to_f(vb[(size_t)kj * D + c]);
            }
            Ks[j * KP + c] = kv;
            Vs[j * D + c] = vv;
        }
        if (tid < BK) {
            const int kj = k0 + tid;
            kid_s[tid] = kj < s ? kv_ids[(size_t)b * s + kj] : 0;
        }
        __syncthreads();

        float sv[NK];
        float tmax = -INFINITY;
#pragma unroll
        for (int i = 0; i < NK; ++i) {
            const int j = sub + 4 * i;
            float logit;
            if (k0 + j < s) {
                float dot = 0.f;
#pragma unroll
                for (int c = 0; c < D; ++c) dot = fmaf(qr[c], Ks[j * KP + c], dot);
                logit = dot * scale;
                const bool allowed = qid == kid_s[j] && (!causal || k0 + j <= qi);
                if (bias_mode) {
                    logit += allowed ? 1.f : 0.f;
                } else if (!allowed) {
                    logit = -1e9f;
                }
            } else {
                logit = -INFINITY;   // past the end of the sequence
            }
            sv[i] = logit;
            tmax = fmaxf(tmax, logit);
        }
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
        const float m_new = fmaxf(m, tmax);
        const float alpha = expf(m - m_new);
        float psum = 0.f;
#pragma unroll
        for (int i = 0; i < NK; ++i) {
            float p = expf(sv[i] - m_new);
            psum += p;
            if constexpr (DROP) {
                if (!attn_drop::keep_pair(key, drop.threshold, drow, dhead, qi, k0 + sub + 4 * i)) p = 0.f;
            }
            Ps[r * PP + sub + 4 * i] = p;
        }
        psum += __shfl_xor_sync(0xffffffffu, psum, 1);
        psum += __shfl_xor_sync(0xffffffffu, psum, 2);
        l = l * alpha + psum;
        m = m_new;
#pragma unroll
        for (int i = 0; i < NC; ++i) acc[i] *= alpha;
        __syncthreads();

        for (int j = 0; j < BK; ++j) {
            const float p = Ps[r * PP + j];
#pragma unroll
            for (int i = 0; i < NC; ++i) acc[i] = fmaf(p, Vs[j * D + sub + 4 * i], acc[i]);
        }
        __syncthreads();
    }

    if (q_in) {
        const float denom = fmaxf(l, 1e-9f);
        float inv = 1.f / denom;
        if constexpr (DROP) inv *= drop.keep_scale;
        T* ob = o + base + (size_t)qi * D;
#pragma unroll
        for (int i = 0; i < NC; ++i) ob[sub + 4 * i] = from_f<T>(acc[i] * inv);
        if (sub == 0) lse[(size_t)bh * s + qi] = m + logf(denom);
    }
}

// ---------------------------------------------------------------- tensor cores

using namespace attn_mma;
using bf16 = __nv_bfloat16;

// The online softmax of one warp's 16 rows for one streamed tile: `sa` holds
// S = Q.K^T (this thread's rows r_lo and r_lo + 8, 16 of the tile's columns)
// and leaves with p; m, l (this thread's share of the row sums) and the o
// accumulator are brought up to date.
template <int NS, int NO>
__device__ __forceinline__ void softmax_tile(float (&sa)[NS][4], float (&m)[2], float (&l)[2], float (&acc)[NO][4],
                                             const int (&qid)[2], int r_lo, const int* kid_t, int k0, int s,
                                             float scale, int bias_mode, int causal, int t) {
    // the masked logits in place of S, and the tile's row max over the quad
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
        const int col = 8 * j + 2 * t;
        const int2 kid = *reinterpret_cast<const int2*>(kid_t + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int hi = e >> 1;
            const int k_pos = k0 + col + (e & 1);
            const bool allowed = pair_allowed(qid[hi], (e & 1) ? kid.y : kid.x, r_lo + 8 * hi, k_pos, causal);
            const float logit = k_pos < s ? masked_logit(sa[j][e], scale, allowed, bias_mode) : -INFINITY;
            sa[j][e] = logit;
            mx[hi] = fmaxf(mx[hi], logit);
        }
    }
    float neg_m[2];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
        mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], 1));
        mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], 2));
        const float m_new = fmaxf(m[hi], mx[hi]);
        // alpha is exactly 1 where the max did not move (a tile with nothing allowed)
        float alpha = 1.f;
        if (m_new != m[hi]) asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(alpha) : "f"((m[hi] - m_new) * LOG2E));
        m[hi] = m_new;
        neg_m[hi] = -m_new * LOG2E;
        l[hi] *= alpha;
#pragma unroll
        for (int j = 0; j < NO; ++j) {
            acc[j][2 * hi] *= alpha;
            acc[j][2 * hi + 1] *= alpha;
        }
    }
    // p = exp(logit - m) as 2^(logit log2 e - m log2 e), in place of the logits
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            float p;
            asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(p) : "f"(fmaf(sa[j][e], LOG2E, neg_m[e >> 1])));
            sa[j][e] = p;
            l[e >> 1] += p;
        }
    }
}

// Dynamic shared memory of the tensor-core kernel: the K and V rings and the
// tile's kv ids.
template <int D>
constexpr size_t mma_smem_bytes() {
    return sizeof(bf16) * 2 * STAGES * TILE * D + sizeof(int) * STAGES * TILE;
}

// The dropout mode's keep bits of one warp's rows for 16 keys of a streamed
// tile, keys k16 + 2t + e in `even` and k16 + 8 + 2t + e in `odd`
// (accumulator layout), applied to their p: one Philox call for each of the
// two quadruples (rows r_lo, r_lo + 8; keys k16 + 2t + e, + 8), just before
// the pair is packed for P.V, so that the draws of a tile do not all hold
// registers at once.
__device__ __forceinline__ void drop_pair(float (&even)[4], float (&odd)[4], uint2 key, const attn_drop::Params& drop,
                                          int row, int head, int r_lo, int k16, int t) {
    const uint32_t qg = attn_drop::group_of(r_lo);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
        const uint4 w = attn_drop::philox(
            make_uint4((uint32_t)row, (uint32_t)head, qg, attn_drop::group_of(k16 + 2 * t + e)), key);
        if (w.x < drop.threshold) even[e] = 0.f;
        if (w.y < drop.threshold) odd[e] = 0.f;
        if (w.z < drop.threshold) even[2 + e] = 0.f;
        if (w.w < drop.threshold) odd[2 + e] = 0.f;
    }
}

template <int D, bool DROP>
__global__ void __launch_bounds__(THREADS, min_blocks<D>())
attn_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                    const int* __restrict__ q_ids, const int* __restrict__ kv_ids,
                    bf16* __restrict__ o, float* __restrict__ lse,
                    int h, int s, int ld, int n_tiles, float scale, int bias_mode, int causal, int skip_tiles,
                    attn_drop::Params drop) {
    constexpr int KS = D / 16;    // 16-deep steps over the head dim (S = Q.K^T)
    constexpr int NS = TILE / 8;  // 8-column tiles of S over the streamed tile's keys
    constexpr int NO = D / 8;     // 8-column tiles of the o accumulator

    extern __shared__ __align__(128) unsigned char mma_smem[];
    bf16(*Ks)[TILE * D] = reinterpret_cast<bf16(*)[TILE * D]>(mma_smem);
    bf16(*Vs)[TILE * D] = Ks + STAGES;
    int(*kid_s)[TILE] = reinterpret_cast<int(*)[TILE]>(Vs + STAGES);

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const bool skip = causal && !bias_mode && skip_tiles;
    int bh, tile;
    block_coords(n_tiles, skip, true, bh, tile);
    const int b = bh / h;
    const int q0 = tile * TILE;
    const size_t base = (size_t)bh * s * ld;
    const bf16* kb = k + base;
    const bf16* vb = v + base;
    const int* kidb = kv_ids + (size_t)b * s;

    const int k_end = skip ? min(s, q0 + TILE) : s;  // stop at the diagonal tile
    const int n_kt = (k_end + TILE - 1) / TILE;

    auto load_stage = [&](int stage, int k0) {
        load_tile_async<D>(Ks[stage], kb, k0, s, ld, tid);
        load_tile_async<D>(Vs[stage], vb, k0, s, ld, tid);
        if (tid < TILE) load_row_async(kid_s[stage], kidb, k0, s, tid);
    };
    load_stage(0, 0);
    cp_async_commit();

    // the block's own rows: this thread holds rows r_lo and r_lo + 8 of q
    const int r_lo = q0 + warp * 16 + g;
    uint32_t qa[KS][4];
    load_a_global<D>(qa, q + base, r_lo, r_lo + 8, s, ld, t);
    int qid[2];
    float m[2], l[2];  // row max and this thread's share of the row sum
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
        const int r = r_lo + 8 * hi;
        qid[hi] = r < s ? q_ids[(size_t)b * s + r] : -3;
        m[hi] = -5e8f;  // the reference's clamp on the row max
        l[hi] = 0.f;
    }
    float acc[NO][4];
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    uint2 key{};
    if constexpr (DROP) key = attn_drop::load_key(drop.seed);

    for (int it = 0; it < n_kt; ++it) {
        if (it + 1 < n_kt) load_stage((it + 1) & 1, (it + 1) * TILE);
        cp_async_commit();
        cp_async_wait<1>();  // everything but the newest group: tile `it` has arrived
        __syncthreads();
        const bf16* Kt = Ks[it & 1];
        const bf16* Vt = Vs[it & 1];

        // S = Q.K^T for this thread's two rows and 16 of the tile's 64 keys
        float sa[NS][4];
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) sa[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
            for (int np = 0; np < TILE / 16; ++np) {
                uint32_t bk[4];
                load_b_rows<D>(bk, Kt, np * 16, kk, lane);
                mma_bf16(sa[2 * np], qa[kk], bk[0], bk[1]);
                mma_bf16(sa[2 * np + 1], qa[kk], bk[2], bk[3]);
            }
        }
        softmax_tile(sa, m, l, acc, qid, r_lo, kid_s[it & 1], it * TILE, s, scale, bias_mode, causal, t);

        // O += P.V over the tile's 64 keys, p rounded to bf16 in registers
#pragma unroll
        for (int ks = 0; ks < TILE / 16; ++ks) {
            if constexpr (DROP) {
                drop_pair(sa[2 * ks], sa[2 * ks + 1], key, drop, drop.row0 + b, drop.head0 + bh % h, r_lo,
                          it * TILE + 16 * ks, t);
            }
            uint32_t pa[4];
            pack_a_from_c(pa, sa[2 * ks], sa[2 * ks + 1]);
#pragma unroll
            for (int np = 0; np < NO / 2; ++np) {
                uint32_t bv[4];
                load_b_cols<D>(bv, Vt, ks * 16, np * 16, lane);
                mma_bf16(acc[2 * np], pa, bv[0], bv[1]);
                mma_bf16(acc[2 * np + 1], pa, bv[2], bv[3]);
            }
        }
        __syncthreads();  // the stage is free for the load after next
    }

#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
        const int r = r_lo + 8 * hi;
        // the row sum over the quad that shares the row
        float sum = l[hi];
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const float den = fmaxf(sum, 1e-9f);
        float inv = 1.f / den;
        if constexpr (DROP) inv *= drop.keep_scale;
        if (r >= s) continue;
        bf16* orow = o + base + (size_t)r * ld;
#pragma unroll
        for (int j = 0; j < NO; ++j) {
            // the 8-column tiles past the caller's head dim (a multiple of 8) are not stored:
            // a guard on j alone, the same for the whole block
            if (8 * j >= ld) continue;
            *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t) =
                __floats2bfloat162_rn(acc[j][2 * hi] * inv, acc[j][2 * hi + 1] * inv);
        }
        if (t == 0) lse[(size_t)bh * s + r] = m[hi] + logf(den);
    }
}

// ---------------------------------------------------------------- launches

struct FwdArgs {
    const void *q, *k, *v;
    const int *q_ids, *kv_ids;
    void* o;
    float* lse;
    int b, h, s, ld;  // ld: the row width in device memory (the caller's head dim in the tensor-core kernel)
    float scale;
    int bias_mode, causal, skip_tiles;
    attn_drop::Params drop;
    cudaStream_t stream;
};

template <typename T, int D, bool DROP>
cudaError_t launch_simt(const FwdArgs& a) {
    constexpr size_t smem = smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        attn_fwd_kernel<T, D, DROP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid(a.b * a.h, (a.s + BQ - 1) / BQ);
    attn_fwd_kernel<T, D, DROP><<<grid, SIMT_THREADS, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        a.q_ids, a.kv_ids, static_cast<T*>(a.o), a.lse, a.h, a.s, a.scale, a.bias_mode, a.causal, a.skip_tiles,
        a.drop);
    return cudaGetLastError();
}

template <int D, bool DROP>
cudaError_t launch_mma(const FwdArgs& a) {
    constexpr size_t smem = mma_smem_bytes<D>();
    cudaError_t err = allow_smem(attn_fwd_mma_kernel<D, DROP>, smem);
    if (err != cudaSuccess) return err;
    const int n_tiles = (a.s + TILE - 1) / TILE;
    attn_fwd_mma_kernel<D, DROP><<<a.b * a.h * n_tiles, THREADS, smem, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
        a.q_ids, a.kv_ids, static_cast<bf16*>(a.o), a.lse, a.h, a.s, a.ld, n_tiles, a.scale, a.bias_mode, a.causal,
        a.skip_tiles, a.drop);
    return cudaGetLastError();
}

// impl 1 takes bfloat16 only; impl 2 (float32) is attention_fwd_tf32x3.cu's
bool known(int impl, int dtype) {
    return (dtype == 0 || dtype == 1) && (impl == 0 || (impl == 1 && dtype == 1));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; impl: 0 = CUDA cores ("simt"), 1 = tensor
// cores ("mma", bfloat16 only); d the rows' width: one of 16, 32, 64, 128,
// or for impl 1 any multiple of 8 up to 128 (read and written in place by the
// instantiation instantiation_for(d)); causal and skip_tiles as in the header.  seed: nullptr, or the device address of the
// 64-bit dropout seed, with the keep threshold, 1 / (1 - rate) and the
// offsets of this call's rows and heads (attn_dropout.cuh).  Returns a
// cudaError_t (0 on success).
extern "C" int attn_fwd(const void* q, const void* k, const void* v, const int* q_ids,
                        const int* kv_ids, void* o, float* lse, int b, int h, int s, int d,
                        float scale, int bias_mode, int causal, int skip_tiles, int dtype, int impl,
                        const unsigned long long* seed, unsigned int threshold, float keep_scale, int row0,
                        int head0, void* stream) {
    if (!known(impl, dtype)) return cudaErrorInvalidValue;
    const int dim = instantiation_for(d);
    if (impl == 1 ? d % 8 != 0 : dim != d) return cudaErrorInvalidValue;
    if (b * h == 0 || s == 0) return dispatch(dim, false, [](auto) { return cudaSuccess; });
    const FwdArgs a{q, k, v, q_ids, kv_ids, o, lse, b, h, s, d, scale, bias_mode, causal, skip_tiles,
                    attn_drop::Params{seed, threshold, keep_scale, row0, head0}, static_cast<cudaStream_t>(stream)};
    return dispatch(dim, seed != nullptr, [&](auto inst) {
        constexpr int D = decltype(inst)::D;
        constexpr bool DROP = decltype(inst)::DROP;
        if (impl == 1) return launch_mma<D, DROP>(a);
        if (dtype == 1) return launch_simt<__nv_bfloat16, D, DROP>(a);
        return launch_simt<float, D, DROP>(a);
    });
}

// What the compiler and the card make of one instantiation (drop: the
// dropout mode's): out[0] registers a thread, out[1] local-memory (spill)
// bytes a thread, out[2] blocks that fit on one SM, out[3] shared-memory
// bytes a block.
extern "C" int attn_fwd_kernel_info(int impl, int dtype, int d, int drop, int* out) {
    if (!known(impl, dtype)) return cudaErrorInvalidValue;
    return dispatch(d, drop != 0, [&](auto inst) {
        constexpr int D = decltype(inst)::D;
        constexpr bool DROP = decltype(inst)::DROP;
        if (impl == 1) return kernel_info(attn_fwd_mma_kernel<D, DROP>, THREADS, mma_smem_bytes<D>(), out);
        if (dtype == 1) return kernel_info(attn_fwd_kernel<__nv_bfloat16, D, DROP>, SIMT_THREADS, smem_bytes<D>(), out);
        return kernel_info(attn_fwd_kernel<float, D, DROP>, SIMT_THREADS, smem_bytes<D>(), out);
    });
}
