// Packed block-diagonal attention, backward, in float32 on Hopper's tensor
// cores in 3xTF32 (sm_90a): the float32 implementation of the two backward
// kernels, impl 2, "tf32x3".
//
// Replaces, for float32 inputs, the two Pallas backward kernels of
// dct_autoencoder_tpu/kernels/attention.py: _attn_dq_kernel and
// _attn_dkv_kernel (called from _flash_attention_bwd_impl).  It computes what
// the kernels of attention_bwd.cu compute, with the same contract (see that
// header): q, k, v, o, do (b, h, s, d) float32, q_ids / kv_ids (b, s) int32,
// lse (b, h, s); the dq kernel writes delta = rowsum(do * o), which the
// dk/dv kernel reads, so dq is launched first on the same stream; the mask,
// the causal mode and its tile skipping, the dropout mode (the keep bits of
// attn_dropout.cuh at the same (row, head, query, key) counter) and the head
// dims 16, 32, 64 and 128 are those of attention_bwd.cu; rows of any width d
// <= D that is a multiple of 4 are read and written in place (`ld`; the
// loads zero-fill the columns past d, the stores write only columns < d).
// No atomics: two launches give the same bits.
//
//   dq     one block per (b*h, 64-row q tile): S = Q.K^T, dP = dO.V^T,
//          p = exp(masked S * scale - lse), ds = p (dp - delta) scale,
//          dq = dS.K
//   dk/dv  one block per (b*h, 64-row k tile): S^T = K.Q^T, dP^T = V.dO^T,
//          then dv = P^T.dO and dk = dS^T.Q
//
// Arithmetic.  Every product runs on mma.sync.m16n8k8 in TF32 as three
// products of TF32 parts (as tf32x3_gemm3.cuh: x = hi + lo; lo*hi + hi*lo +
// hi*hi, the lo*lo term of ~2^-22 of the product dropped), with fp32
// accumulators: about 22 significant bits, where one TF32 product keeps 11
// and misses fp32's 1e-5 by two orders of magnitude.  p and ds are split the
// same way before the second products.  The split (`split` below) runs on
// the FP32 pipe.
// p = expf(logit - lse) on the CUDA cores, as in the CUDA-core kernels.  The
// tensor cores round their fp32 sums toward zero (tf32x3_gemm3.cuh), so each
// 8-deep slice's three mma are summed on the tensor cores from zero and
// added to the accumulators on the CUDA cores, which round to nearest: in
// an emulation of this arithmetic on the CPU
// (tests/test_torch_attention_bwd_tf32x3.py) chaining the products over the
// head dim on the tensor cores put dq's float64 error at up to 8.7 x the fp32
// plain version's, passes of 32 chained rows in the second products at up to
// 3.5 x, and the sum by slices at up to 2.2 x.
//
// Bound on the H100: at (64, 16, 256, 64) each kernel moves ~400 MB (0.120
// ms at 3.35 TB/s) and needs 25.8 (dq) or 34.4 (dk/dv) GFLOP of allowed and
// masked full tiles, ~0.16 / 0.21 ms at 3xTF32's effective 165 TFLOP/s; at
// the sweep's (4, 8, 3072, 32) every pair is allowed and the operations
// bound it (58 and 77 GFLOP: 0.35 and 0.47 ms).  mma.sync reaches only part
// of the tensor cores' rate, and each operand costs a split (five
// instructions) per fragment it feeds, and each slice four adds, so the
// CUDA cores' issue slots share the bound.
//
// Design (the building blocks are in attn_tf32x3.cuh, shared with the
// forward, attention_fwd_tf32x3.cu): as the bf16 kernels of
// attention_bwd.cu, 128 threads, four warps each owning 16 rows of the
// block's own 64-row tile; the opposite side
// streams through a two-stage cp.async ring; the dk/dv kernel computes the
// transposed products so that P^T and dS^T come out in accumulator layout;
// the 64 streamed rows are taken in two passes of 32.  What fp32 changes:
//   * Registers: split fragments of the own side would take 2 x D registers
//     for each of q and do (k and v), so the own tiles stay in shared
//     memory as fp32 and their fragments are loaded and split at each use.
//   * Shared memory: tiles are fp32 rows of D + 4 floats (16-byte chunks for
//     cp.async; D + 4 = 4 mod 32 banks, so that each fragment read hits 32
//     banks): the own pair and two stages of the streamed pair take 104 KB
//     at D = 64 (two blocks an SM) and 203 KB at D = 128 (one).
//   * Fragment layout: the m16n8k8 TF32 A fragment holds columns t and t + 4
//     where an accumulator holds 2t and 2t + 1.  A product's sum over its
//     depth does not depend on the order of the depth, so the second
//     products take depth slot t as row 2t of the streamed tile and slot
//     t + 4 as row 2t + 1: an accumulator fragment (c0, c1, c2, c3) is then
//     the A fragment (c0, c2, c1, c3) as it stands, with no shuffle and no
//     trip through shared memory, and the B fragment reads rows 2t and
//     2t + 1 (banks 8t + g and 8t + g + 4: no conflict).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_dropout.cuh"
#include "attn_mma.cuh"
#include "attn_tf32x3.cuh"

namespace {

using attn_mma::block_coords;
using attn_mma::masked_logit;
using attn_mma::pair_allowed;
using attn_mma::STAGES;
using attn_mma::THREADS;
using attn_mma::TILE;
using namespace attn_tf32x3;

constexpr int PASS = 32;  // streamed rows per pass: two passes over a 64-row tile

// acc[n] += A.B over the 32 rows of one pass for each 8-column tile n of the
// head dim: A the pass's four split fragments, B the streamed tile's rows
// c0 .. c0 + 31.
template <int D>
__device__ __forceinline__ void pass_product(float (&acc)[D / 8][4], const uint32_t (&ah)[PASS / 8][4],
                                             const uint32_t (&al)[PASS / 8][4], const float* tile, int c0, int g,
                                             int t) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
#pragma unroll
        for (int j = 0; j < PASS / 8; ++j) {
            uint32_t bh[2], bl[2];
            b_frag_cols<D>(bh, bl, tile, c0 + 8 * j, 8 * n, g, t);
            add_slice(acc[n], ah[j], al[j], bh, bl);
        }
    }
}

// S (or S^T) and dP (or dP^T) of one pass: for the warp's 16 own rows and
// the streamed rows c0 .. c0 + 31, A from the own tiles (a_own with
// a_streamed, b_own with b_streamed), over the head dim.
template <int D>
__device__ __forceinline__ void pass_logits(float (&sa)[PASS / 8][4], float (&pa)[PASS / 8][4], const float* a_own,
                                            const float* b_own, const float* a_streamed, const float* b_streamed,
                                            int r0, int c0, int g, int t) {
#pragma unroll
    for (int j = 0; j < PASS / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sa[j][e] = pa[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
        uint32_t xh[4], xl[4], yh[4], yl[4];
        a_frag<D>(xh, xl, a_own, r0, kk, g, t);
        a_frag<D>(yh, yl, b_own, r0, kk, g, t);
#pragma unroll
        for (int j = 0; j < PASS / 8; ++j) {
            uint32_t bh[2], bl[2], ch[2], cl[2];
            b_frag_rows<D>(bh, bl, a_streamed, c0 + 8 * j, kk, g, t);
            b_frag_rows<D>(ch, cl, b_streamed, c0 + 8 * j, kk, g, t);
            add_slice(sa[j], xh, xl, bh, bl);
            add_slice(pa[j], yh, yl, ch, cl);
        }
    }
}

// Dynamic shared memory: the own pair, STAGES of the streamed pair, and the
// streamed rows' ids (dq) or lse, delta and ids (dk/dv).
template <int D>
constexpr size_t dq_smem_bytes() {
    return sizeof(float) * (2 + 2 * STAGES) * TILE_FLOATS<D> + sizeof(int) * STAGES * TILE;
}

template <int D>
constexpr size_t dkv_smem_bytes() {
    return sizeof(float) * (2 + 2 * STAGES) * TILE_FLOATS<D> + 3 * sizeof(float) * STAGES * TILE;
}

template <int D, bool DROP>
__global__ void __launch_bounds__(THREADS, min_blocks<D>())
attn_dq_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                      const float* __restrict__ o, const float* __restrict__ dout,
                      const int* __restrict__ q_ids, const int* __restrict__ kv_ids,
                      const float* __restrict__ lse, float* __restrict__ dq, float* __restrict__ delta,
                      int h, int s, int ld, int n_tiles, float scale, int bias_mode, int causal, int skip_tiles,
                      attn_drop::Params drop) {
    constexpr int NO = D / 8;  // 8-column tiles of the dq accumulator
    constexpr int TF = TILE_FLOATS<D>;

    extern __shared__ __align__(16) float smem[];
    float* Qs = smem;             // own q
    float* Os = Qs + TF;          // own do
    float* Ks = Os + TF;          // STAGES k tiles
    float* Vs = Ks + STAGES * TF; // STAGES v tiles
    int* kid_s = reinterpret_cast<int*>(Vs + STAGES * TF);  // STAGES x TILE

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const bool skip = causal && !bias_mode && skip_tiles;
    int bh, tile;
    block_coords(n_tiles, skip, true, bh, tile);
    const int b = bh / h;
    const int q0 = tile * TILE;
    const size_t base = (size_t)bh * s * ld;
    const float* kb = k + base;
    const float* vb = v + base;
    const int* kidb = kv_ids + (size_t)b * s;

    const int k_end = skip ? min(s, q0 + TILE) : s;  // stop at the diagonal tile
    const int n_kt = (k_end + TILE - 1) / TILE;

    auto load_stage = [&](int stage, int k0) {
        load_tile<D>(Ks + stage * TF, kb, k0, s, ld, tid);
        load_tile<D>(Vs + stage * TF, vb, k0, s, ld, tid);
        if (tid < TILE) attn_mma::load_row_async(kid_s + stage * TILE, kidb, k0, s, tid);
    };
    load_tile<D>(Qs, q + base, q0, s, ld, tid);  // in the first group: it has arrived when tile 0 has
    load_tile<D>(Os, dout + base, q0, s, ld, tid);
    load_stage(0, 0);
    attn_mma::cp_async_commit();

    // the thread's own rows r_lo and r_hi; delta = rowsum(do * o) over columns t + 4i, summed in the quad
    const int r_lo = q0 + warp * 16 + g, r_hi = r_lo + 8;
    const bool in_lo = r_lo < s, in_hi = r_hi < s;
    float delta_lo = 0.f, delta_hi = 0.f;
#pragma unroll
    for (int i = 0; i < D / 4; ++i) {
        const int c = t + 4 * i;
        if (c >= ld) continue;
        if (in_lo) delta_lo = fmaf(dout[base + (size_t)r_lo * ld + c], o[base + (size_t)r_lo * ld + c], delta_lo);
        if (in_hi) delta_hi = fmaf(dout[base + (size_t)r_hi * ld + c], o[base + (size_t)r_hi * ld + c], delta_hi);
    }
    delta_lo += __shfl_xor_sync(0xffffffffu, delta_lo, 1);
    delta_lo += __shfl_xor_sync(0xffffffffu, delta_lo, 2);
    delta_hi += __shfl_xor_sync(0xffffffffu, delta_hi, 1);
    delta_hi += __shfl_xor_sync(0xffffffffu, delta_hi, 2);
    if (t == 0 && in_lo) delta[(size_t)bh * s + r_lo] = delta_lo;
    if (t == 0 && in_hi) delta[(size_t)bh * s + r_hi] = delta_hi;
    const float lse_lo = in_lo ? lse[(size_t)bh * s + r_lo] : 0.f;
    const float lse_hi = in_hi ? lse[(size_t)bh * s + r_hi] : 0.f;
    const int qid_lo = in_lo ? q_ids[(size_t)b * s + r_lo] : -3;
    const int qid_hi = in_hi ? q_ids[(size_t)b * s + r_hi] : -3;
    uint2 key{};
    if constexpr (DROP) key = attn_drop::load_key(drop.seed);

    float acc[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

    for (int it = 0; it < n_kt; ++it) {
        if (it + 1 < n_kt) load_stage((it + 1) & 1, (it + 1) * TILE);
        attn_mma::cp_async_commit();
        attn_mma::cp_async_wait<1>();  // everything but the newest group: tile `it` has arrived
        __syncthreads();
        const float* Kt = Ks + (it & 1) * TF;
        const float* Vt = Vs + (it & 1) * TF;
        const int* kid_t = kid_s + (it & 1) * TILE;
        const int k0 = it * TILE;

#pragma unroll 1
        for (int c0 = 0; c0 < TILE; c0 += PASS) {
            // S = Q.K^T and dP = dO.V^T for this thread's rows and keys c0 .. c0 + 31
            float sa[PASS / 8][4], pa[PASS / 8][4];
            pass_logits<D>(sa, pa, Qs, Os, Kt, Vt, warp * 16, c0, g, t);
            uint32_t keep = 0;
            if constexpr (DROP) {
                keep = attn_drop::keep_bits<true, PASS>(key, drop, drop.row0 + b, drop.head0 + bh % h,
                                                        attn_drop::group_of(r_lo), k0 + c0, t);
            }
            // ds in place of S; a key past the end gets p = 0
#pragma unroll
            for (int j = 0; j < PASS / 8; ++j) {
                const int col = c0 + 8 * j + 2 * t;
                const int2 kid = *reinterpret_cast<const int2*>(kid_t + col);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const bool hi = e >= 2;
                    const int k_pos = k0 + col + (e & 1);
                    const bool allowed = pair_allowed(hi ? qid_hi : qid_lo, (e & 1) ? kid.y : kid.x,
                                                      hi ? r_hi : r_lo, k_pos, causal);
                    float p = expf(masked_logit(sa[j][e], scale, allowed, bias_mode) - (hi ? lse_hi : lse_lo));
                    if (k_pos >= s) p = 0.f;
                    float dp = pa[j][e];
                    if constexpr (DROP) dp = (keep >> (4 * j + e)) & 1u ? dp * drop.keep_scale : 0.f;
                    sa[j][e] = p * (dp - (hi ? delta_hi : delta_lo)) * scale;
                }
            }
            // dq += dS.K over these 32 keys
            uint32_t dh[PASS / 8][4], dl[PASS / 8][4];
#pragma unroll
            for (int j = 0; j < PASS / 8; ++j) a_from_c(dh[j], dl[j], sa[j]);
            pass_product<D>(acc, dh, dl, Kt, c0, g, t);
        }
        __syncthreads();  // the stage is free for the load after next
    }

    float* dq_lo = dq + base + (size_t)r_lo * ld;
    float* dq_hi = dq + base + (size_t)r_hi * ld;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
        const int col = 8 * n + 2 * t;
        if (col >= ld) continue;  // the columns past the caller's head dim are not stored
        if (in_lo) *reinterpret_cast<float2*>(dq_lo + col) = make_float2(acc[n][0], acc[n][1]);
        if (in_hi) *reinterpret_cast<float2*>(dq_hi + col) = make_float2(acc[n][2], acc[n][3]);
    }
}

template <int D, bool DROP>
__global__ void __launch_bounds__(THREADS, min_blocks<D>())
attn_dkv_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                       const float* __restrict__ dout,
                       const int* __restrict__ q_ids, const int* __restrict__ kv_ids,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       float* __restrict__ dk, float* __restrict__ dv,
                       int h, int s, int ld, int n_tiles, float scale, int bias_mode, int causal, int skip_tiles,
                       attn_drop::Params drop) {
    constexpr int NO = D / 8;
    constexpr int TF = TILE_FLOATS<D>;

    extern __shared__ __align__(16) float smem[];
    float* Ks = smem;              // own k
    float* Vs = Ks + TF;           // own v
    float* Qs = Vs + TF;           // STAGES q tiles
    float* Os = Qs + STAGES * TF;  // STAGES do tiles
    float* lse_s = Os + STAGES * TF;        // STAGES x TILE
    float* delta_s = lse_s + STAGES * TILE;  // STAGES x TILE
    int* qid_s = reinterpret_cast<int*>(delta_s + STAGES * TILE);  // STAGES x TILE

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const bool skip = causal && !bias_mode && skip_tiles;
    int bh, tile;
    block_coords(n_tiles, skip, false, bh, tile);
    const int b = bh / h;
    const int kt0 = tile * TILE;
    const size_t base = (size_t)bh * s * ld;
    const float* qb = q + base;
    const float* dob = dout + base;
    const float* lseb = lse + (size_t)bh * s;
    const float* deltab = delta + (size_t)bh * s;
    const int* qidb = q_ids + (size_t)b * s;

    const int qt_begin = skip ? tile : 0;  // start at the diagonal tile
    const int n_qt = n_tiles - qt_begin;

    auto load_stage = [&](int stage, int q0) {
        load_tile<D>(Qs + stage * TF, qb, q0, s, ld, tid);
        load_tile<D>(Os + stage * TF, dob, q0, s, ld, tid);
        if (tid < TILE) {
            attn_mma::load_row_async(lse_s + stage * TILE, lseb, q0, s, tid);
            attn_mma::load_row_async(delta_s + stage * TILE, deltab, q0, s, tid);
            attn_mma::load_row_async(qid_s + stage * TILE, qidb, q0, s, tid);
        }
    };
    load_tile<D>(Ks, k + base, kt0, s, ld, tid);  // in the first group: it has arrived when tile 0 has
    load_tile<D>(Vs, v + base, kt0, s, ld, tid);
    load_stage(0, qt_begin * TILE);
    attn_mma::cp_async_commit();

    // the thread's own keys r_lo and r_hi
    const int r_lo = kt0 + warp * 16 + g, r_hi = r_lo + 8;
    const bool in_lo = r_lo < s, in_hi = r_hi < s;
    const int kid_lo = in_lo ? kv_ids[(size_t)b * s + r_lo] : -3;
    const int kid_hi = in_hi ? kv_ids[(size_t)b * s + r_hi] : -3;
    uint2 key{};
    if constexpr (DROP) key = attn_drop::load_key(drop.seed);

    float dk_acc[NO][4], dv_acc[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

    for (int it = 0; it < n_qt; ++it) {
        if (it + 1 < n_qt) load_stage((it + 1) & 1, (qt_begin + it + 1) * TILE);
        attn_mma::cp_async_commit();
        attn_mma::cp_async_wait<1>();
        __syncthreads();
        const float* Qt = Qs + (it & 1) * TF;
        const float* Ot = Os + (it & 1) * TF;
        const float* lse_t = lse_s + (it & 1) * TILE;
        const float* delta_t = delta_s + (it & 1) * TILE;
        const int* qid_t = qid_s + (it & 1) * TILE;
        const int q0 = (qt_begin + it) * TILE;

#pragma unroll 1
        for (int c0 = 0; c0 < TILE; c0 += PASS) {
            // S^T = K.Q^T and dP^T = V.dO^T: rows are this thread's keys, columns queries c0 .. c0 + 31
            float sa[PASS / 8][4], pa[PASS / 8][4];
            pass_logits<D>(sa, pa, Ks, Vs, Qt, Ot, warp * 16, c0, g, t);
            uint32_t keep = 0;
            if constexpr (DROP) {
                keep = attn_drop::keep_bits<false, PASS>(key, drop, drop.row0 + b, drop.head0 + bh % h,
                                                         attn_drop::group_of(r_lo), q0 + c0, t);
            }
            // p^T (dropped) in place of S^T, ds^T in place of dP^T; lse, delta and q ids go by
            // column; a query past the end gets p = 0 (a key past the end needs nothing: the
            // rows of a product do not mix, and its rows of dk and dv are not stored)
#pragma unroll
            for (int j = 0; j < PASS / 8; ++j) {
                const int col = c0 + 8 * j + 2 * t;
                const float2 ls = *reinterpret_cast<const float2*>(lse_t + col);
                const float2 dl = *reinterpret_cast<const float2*>(delta_t + col);
                const int2 qid = *reinterpret_cast<const int2*>(qid_t + col);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const bool hi = e >= 2;
                    const int q_pos = q0 + col + (e & 1);
                    const bool allowed = pair_allowed((e & 1) ? qid.y : qid.x, hi ? kid_hi : kid_lo, q_pos,
                                                      hi ? r_hi : r_lo, causal);
                    float p = expf(masked_logit(sa[j][e], scale, allowed, bias_mode) - ((e & 1) ? ls.y : ls.x));
                    if (q_pos >= s) p = 0.f;
                    float dp = pa[j][e], pd = p;  // pd: the dropped weight, dv's factor
                    if constexpr (DROP) {
                        const float z = (keep >> (4 * j + e)) & 1u ? drop.keep_scale : 0.f;
                        dp *= z;
                        pd = p * z;
                    }
                    pa[j][e] = p * (dp - ((e & 1) ? dl.y : dl.x)) * scale;
                    sa[j][e] = pd;
                }
            }
            // dv += P^T.dO, then dk += dS^T.Q, over these 32 queries
            {
                uint32_t ph[PASS / 8][4], pl[PASS / 8][4];
#pragma unroll
                for (int j = 0; j < PASS / 8; ++j) a_from_c(ph[j], pl[j], sa[j]);
                pass_product<D>(dv_acc, ph, pl, Ot, c0, g, t);
            }
            {
                uint32_t dh[PASS / 8][4], dl[PASS / 8][4];
#pragma unroll
                for (int j = 0; j < PASS / 8; ++j) a_from_c(dh[j], dl[j], pa[j]);
                pass_product<D>(dk_acc, dh, dl, Qt, c0, g, t);
            }
        }
        __syncthreads();
    }

    const size_t lo = base + (size_t)r_lo * ld, hi = base + (size_t)r_hi * ld;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
        const int col = 8 * n + 2 * t;
        if (col >= ld) continue;
        if (in_lo) {
            *reinterpret_cast<float2*>(dk + lo + col) = make_float2(dk_acc[n][0], dk_acc[n][1]);
            *reinterpret_cast<float2*>(dv + lo + col) = make_float2(dv_acc[n][0], dv_acc[n][1]);
        }
        if (in_hi) {
            *reinterpret_cast<float2*>(dk + hi + col) = make_float2(dk_acc[n][2], dk_acc[n][3]);
            *reinterpret_cast<float2*>(dv + hi + col) = make_float2(dv_acc[n][2], dv_acc[n][3]);
        }
    }
}

// ---------------------------------------------------------------- launches

struct BwdArgs {
    const float *q, *k, *v, *o, *dout;
    const int *q_ids, *kv_ids;
    const float* lse;
    float* delta;  // written by dq, read by dk/dv
    float *dq, *dk, *dv;
    int b, h, s, ld;
    float scale;
    int bias_mode, causal, skip_tiles;
    attn_drop::Params drop;
    cudaStream_t stream;
};

template <int D, bool DROP>
cudaError_t launch_dq(const BwdArgs& a) {
    constexpr size_t smem = dq_smem_bytes<D>();
    cudaError_t err = attn_mma::allow_smem(attn_dq_tf32x3_kernel<D, DROP>, smem);
    if (err != cudaSuccess) return err;
    const int n_tiles = (a.s + TILE - 1) / TILE;
    attn_dq_tf32x3_kernel<D, DROP><<<a.b * a.h * n_tiles, THREADS, smem, a.stream>>>(
        a.q, a.k, a.v, a.o, a.dout, a.q_ids, a.kv_ids, a.lse, a.dq, a.delta, a.h, a.s, a.ld, n_tiles, a.scale,
        a.bias_mode, a.causal, a.skip_tiles, a.drop);
    return cudaGetLastError();
}

template <int D, bool DROP>
cudaError_t launch_dkv(const BwdArgs& a) {
    constexpr size_t smem = dkv_smem_bytes<D>();
    cudaError_t err = attn_mma::allow_smem(attn_dkv_tf32x3_kernel<D, DROP>, smem);
    if (err != cudaSuccess) return err;
    const int n_tiles = (a.s + TILE - 1) / TILE;
    attn_dkv_tf32x3_kernel<D, DROP><<<a.b * a.h * n_tiles, THREADS, smem, a.stream>>>(
        a.q, a.k, a.v, a.dout, a.q_ids, a.kv_ids, a.lse, a.delta, a.dk, a.dv, a.h, a.s, a.ld, n_tiles, a.scale,
        a.bias_mode, a.causal, a.skip_tiles, a.drop);
    return cudaGetLastError();
}

// One backward kernel (DKV: dk/dv, else dq) for rows of d floats (the
// instantiation attn_mma::instantiation_for(d) reads and writes them in
// place; d a multiple of 4): launched, or (info != nullptr, d an
// instantiation) described.  Takes impl 2 on float32 (dtype 0) only.
template <bool DKV>
cudaError_t run(int impl, int dtype, int d, bool drop, const BwdArgs* a, int* info) {
    if (impl != 2 || dtype != 0 || d % 4) return cudaErrorInvalidValue;
    return attn_mma::dispatch(attn_mma::instantiation_for(d), drop, [&](auto inst) {
        constexpr int D = decltype(inst)::D;
        constexpr bool DROP = decltype(inst)::DROP;
        if constexpr (DKV) {
            if (info != nullptr)
                return attn_mma::kernel_info(attn_dkv_tf32x3_kernel<D, DROP>, THREADS, dkv_smem_bytes<D>(), info);
            if (a->b * a->h == 0 || a->s == 0) return cudaSuccess;
            return launch_dkv<D, DROP>(*a);
        } else {
            if (info != nullptr)
                return attn_mma::kernel_info(attn_dq_tf32x3_kernel<D, DROP>, THREADS, dq_smem_bytes<D>(), info);
            if (a->b * a->h == 0 || a->s == 0) return cudaSuccess;
            return launch_dq<D, DROP>(*a);
        }
    });
}

}  // namespace

// As attention_bwd.cu, the source builds two libraries, one a kernel, so that
// their nvcc runs go in parallel: ATTN_BWD_PART 0 holds the dq kernel
// (attn_bwd_tf32x3_dq), 1 the dk/dv kernel (attn_bwd_tf32x3_dkv).
#ifndef ATTN_BWD_PART
#error "build with -DATTN_BWD_PART=0 (dq) or -DATTN_BWD_PART=1 (dk/dv)"
#endif

// The arguments of attn_bwd_dq and attn_bwd_dkv (attention_bwd.cu), pointers
// to float32 data; dtype must be 0 (float32) and impl 2 (tf32x3).  All return
// a cudaError_t (0 on success).

#if ATTN_BWD_PART == 0
extern "C" int attn_bwd_tf32x3_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
                                  const int* q_ids, const int* kv_ids, const float* lse, void* dq, float* delta,
                                  int b, int h, int s, int d, float scale, int bias_mode, int causal, int skip_tiles,
                                  int dtype, int impl, const unsigned long long* seed, unsigned int threshold,
                                  float keep_scale, int row0, int head0, void* stream) {
    const BwdArgs a{static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
                    static_cast<const float*>(o), static_cast<const float*>(dout), q_ids, kv_ids, lse, delta,
                    static_cast<float*>(dq), nullptr, nullptr, b, h, s, d, scale, bias_mode, causal, skip_tiles,
                    attn_drop::Params{seed, threshold, keep_scale, row0, head0}, static_cast<cudaStream_t>(stream)};
    return run<false>(impl, dtype, d, seed != nullptr, &a, nullptr);
}
#else
extern "C" int attn_bwd_tf32x3_dkv(const void* q, const void* k, const void* v, const void* dout, const int* q_ids,
                                   const int* kv_ids, const float* lse, float* delta, void* dk, void* dv, int b,
                                   int h, int s, int d, float scale, int bias_mode, int causal, int skip_tiles,
                                   int dtype, int impl, const unsigned long long* seed, unsigned int threshold,
                                   float keep_scale, int row0, int head0, void* stream) {
    const BwdArgs a{static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
                    nullptr, static_cast<const float*>(dout), q_ids, kv_ids, lse, delta, nullptr,
                    static_cast<float*>(dk), static_cast<float*>(dv), b, h, s, d, scale, bias_mode, causal, skip_tiles,
                    attn_drop::Params{seed, threshold, keep_scale, row0, head0}, static_cast<cudaStream_t>(stream)};
    return run<true>(impl, dtype, d, seed != nullptr, &a, nullptr);
}
#endif

// What the compiler and the card make of one instantiation of this library's
// kernel (drop: the dropout mode's): registers and local (spill) bytes a
// thread, blocks an SM, shared bytes a block, as attn_bwd_kernel_info.
extern "C" int attn_bwd_tf32x3_kernel_info(int impl, int dtype, int d, int drop, int* out) {
    return run<ATTN_BWD_PART == 1>(impl, dtype, d, drop != 0, nullptr, out);
}
