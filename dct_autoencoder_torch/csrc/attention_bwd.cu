// Packed block-diagonal attention, backward, for Hopper (sm_90a).
//
// Replaces the two Pallas backward kernels of
// dct_autoencoder_tpu/kernels/attention.py: _attn_dq_kernel and
// _attn_dkv_kernel (called from _flash_attention_bwd_impl).  Same contract
// as the forward (attention_fwd.cu): q, k, v, o, do are (b, h, s, d);
// q_ids / kv_ids are (b, s) int32 with padded queries at -2 and padded keys
// at -1; lse is the forward's row log-sum-exp (b, h, s) in float32.  Two
// kernels, one per TPU kernel, no atomics, so the result is deterministic:
//
//   dq     one block per (b*h, 64-row q tile): p = exp(logits - lse),
//          dp = do.v^T, ds = p * (dp - delta) * scale, dq = ds.k
//   dk/dv  one block per (b*h, 64-row k tile): the same p and ds,
//          transposed: dv = p^T.do, dk = ds^T.q
//
// delta = rowsum(do * o) in float32: the JAX package computes it outside its
// kernels; here it is folded into the prologue of the dq kernel, which
// holds the do rows anyway, and written to a (b, h, s) float32 buffer that
// the dk/dv kernel reads.  So dq must be launched before dk/dv on the same
// stream (the wrapper does).
//
// The mask is recomputed exactly as the forward applies it, so that p sums
// to 1 against the saved lse: 'block' sets a disallowed logit to -1e9,
// 'bias' adds +1 to an allowed logit and masks nothing.  A fully masked row
// (a padded query in 'block' mode) has lse = -5e8 + log(1e-9), so every
// p = exp(-1e9 - lse) = 0 in float32: dq = 0 and the row adds nothing to
// dk/dv, without a special case (in 'bias' mode padded queries do attend).
// Keys past the end of a ragged last tile get p = 0 and are not written;
// query rows past the end contribute nothing.
//
// causal != 0 ANDs k_pos <= q_pos (row indices) into `allowed`, exactly as
// the forward does, in both modes.  In 'block' mode with skip_tiles != 0 the
// dq kernel stops at its diagonal tile and the dk/dv kernel starts at it:
// a skipped (query, key) pair has logit -1e9, and exp(-1e9 - lse) is 0 in
// float32 both for a valid row (a causal row always holds its own key, so
// its lse is an ordinary number) and for a fully masked one, and an fp32
// accumulator plus a product with an exact 0 is unchanged, so the sums do
// not depend on skip_tiles.  In 'bias' mode nothing is skipped.
//
// Head dims: as the forward, every kernel is compiled for D = 16, 32, 64
// and 128; the tensor-core kernels read and write rows of any width d <= D
// that is a multiple of 8 in place (the loads zero-fill the chunks past d,
// the stores write only columns < d), and for other widths, and for the
// CUDA-core kernels, the wrapper pads d up to the next D with zero columns
// (the padded columns of dq, dk and dv are zero and cut off).
//
// Dropout (the `seed` argument, nullptr for none; the DROP instantiations):
// the forward computed o = (p z / (1 - rate)) . v with z the keep bits of
// attn_dropout.cuh and p = exp(logits - lse) the undropped weights; both
// kernels draw the same z from the seed and compute
//   dp = z / (1 - rate) * (do . v^T)        dv = (p z / (1 - rate))^T . do
//   ds = p * (dp - delta) * scale           dq = ds . k, dk = ds^T . q
// with delta = rowsum(do * o) of the dropped o, which is sum_j p_j dp_j.
// In the tensor-core kernels the four keep bits of one Philox call go into
// a bit mask a pass; the instantiations without dropout are the kernels as
// they were.
//
// Two implementations of each kernel (the `impl` argument of the entry
// points):
//
// impl 1, "mma", bfloat16 only: attn_dq_mma_kernel and attn_dkv_mma_kernel
// multiply on the tensor cores (mma.sync m16n8k16, bf16 operands, fp32
// accumulators; the building blocks are in attn_mma.cuh).
//   Bound on the H100: at the main-path shape (64 rows, 16 heads, s = 256,
//   d = 64, bf16) each kernel reads six (b, h, s, d) tensors' worth and
//   writes one or two: ~200 MB, 0.061 ms of memory time; the products of the
//   allowed pairs alone would take a few microseconds at the tensor cores'
//   peak.  So the bound is bytes.  What holds the kernels above it is inside
//   the SM: a warp that owns 16 rows feeds two mma from every ldmatrix.x4, so
//   shared memory (128 bytes a clock) can keep the tensor cores at most half
//   busy; the mask, the exp and the ds run on the CUDA cores between the
//   products; and at s = 256 a block streams only four tiles, so its
//   prologue (the own rows, read from device memory) is a large share of its
//   life.  The opposite stripe is read once per own tile: 4 x at s = 256,
//   from L2.
//   Design: 128 threads, four warps, each owning 16 rows of the block's own
//   64-row tile as A fragments in registers for the whole block (q and do for
//   dq; k and v for dk/dv, which computes the transposed products
//   S^T = K.Q^T and dP^T = V.dO^T so that P^T and dS^T come out in
//   accumulator layout).  The opposite side streams as bf16 tiles through a
//   two-stage cp.async ring (16-byte copies, rows past the end zero-filled,
//   chunks swizzled so that ldmatrix meets no bank conflict); the tile that
//   was B of the first products is B of the second ones read with
//   ldmatrix.trans.  p and ds are computed in fp32 from the fp32
//   accumulators in fragment coordinates (each thread knows its two rows'
//   ids, lse and delta and reads the streamed side's from shared memory),
//   rounded to bf16 and fed back as A fragments without touching shared
//   memory.  The 64 streamed columns are taken in two passes of 32 so that
//   the S and dP accumulators are 16 + 16 registers, not 32 + 32.  Blocks
//   that share a k/v (or q/do) stripe are neighbours in the grid so that the
//   stripe is read from L2; with causal skipping the grid is ordered longest
//   block first instead.
//   Rounding: as the Pallas kernels do (ds.astype(q.dtype),
//   p_t.astype(do.dtype), ds_t.astype(q.dtype)), p and ds are rounded to
//   bf16 before the second product; sums are fp32; results are rounded once
//   at the store.  exp is 2^x by ex2.approx on a log2 e-prescaled argument
//   (see pair_prob).
//
// impl 0, "simt": attn_dq_kernel and attn_dkv_kernel multiply in float32 on
// the CUDA cores, keep p and ds in float32 and round once at the store.
// float32 launches take impl 2, "tf32x3" (attention_bwd_tf32x3.cu: the
// tensor cores in 3xTF32, which hold fp32's 1e-5 where one TF32 product
// would not), unless impl 0 is asked for; the instantiations of both types
// stay for timing the old design against the new ones on one card.  They
// are arithmetic-bound at a few milliseconds (67 TFLOP/s peak).  Design:
// both sides tiled 64 x 64, the opposite side
// streams through shared memory widened to fp32; four threads share one row
// of the block's own side, which stays in registers; each takes 16 rows of
// the streamed tile for the logits and d/4 columns of the accumulators.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "attn_dropout.cuh"
#include "attn_mma.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int SIMT_THREADS = 256;  // 4 threads per row of the block's own side

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);
}

using attn_mma::masked_logit;

template <int D>
constexpr size_t dq_smem_bytes() {
    return sizeof(float) * (2 * BK * (D + 1) + BQ * (BK + 4)) + sizeof(int) * BK;
}

template <int D>
constexpr size_t dkv_smem_bytes() {
    return sizeof(float) * (2 * BQ * (D + 1) + 2 * BK * (BQ + 4) + 2 * BQ) + sizeof(int) * BQ;
}

template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(SIMT_THREADS)
attn_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ o, const T* __restrict__ dout,
               const int* __restrict__ q_ids, const int* __restrict__ kv_ids,
               const float* __restrict__ lse, T* __restrict__ dq, float* __restrict__ delta,
               int h, int s, float scale, int bias_mode, int causal, int skip_tiles, attn_drop::Params drop) {
    constexpr int KP = D + 1;       // padded k / v row (bank spread)
    constexpr int PP = BK + 4;      // padded ds row: (4 r + sub) spreads a warp over all banks
    constexpr int NK = BK / 4;      // keys per thread per tile
    constexpr int NC = D / 4;       // dq columns per thread

    extern __shared__ float smem[];
    float* Ks = smem;                       // BK x KP
    float* Vs = Ks + BK * KP;               // BK x KP
    float* Ss = Vs + BK * KP;               // BQ x PP   (ds)
    int* kid_s = reinterpret_cast<int*>(Ss + BQ * PP);  // BK

    const int bh = blockIdx.x;
    const int b = bh / h;
    const int tid = threadIdx.x;
    const int r = tid >> 2;
    const int sub = tid & 3;
    const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest causal blocks first
    const int qi = q0 + r;
    const bool q_in = qi < s;

    const size_t base = (size_t)bh * s * D;
    const T* kb = k + base;
    const T* vb = v + base;
    const size_t row = base + (size_t)(q_in ? qi : 0) * D;

    float qr[D], dor[D];
#pragma unroll
    for (int c = 0; c < D; ++c) {
        qr[c] = q_in ? to_f(q[row + c]) : 0.f;
        dor[c] = q_in ? to_f(dout[row + c]) : 0.f;
    }

    // delta = rowsum(do * o): each of the row's four threads sums d/4 columns
    float dl = 0.f;
    if (q_in) {
#pragma unroll
        for (int i = 0; i < NC; ++i) {
            const int c = sub + 4 * i;
            dl = fmaf(to_f(dout[row + c]), to_f(o[row + c]), dl);
        }
    }
    dl += __shfl_xor_sync(0xffffffffu, dl, 1);
    dl += __shfl_xor_sync(0xffffffffu, dl, 2);
    if (q_in && sub == 0) delta[(size_t)bh * s + qi] = dl;

    const float lse_r = q_in ? lse[(size_t)bh * s + qi] : 0.f;
    const int qid = q_in ? q_ids[(size_t)b * s + qi] : -3;
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
            Vs[j * KP + c] = vv;
        }
        if (tid < BK) {
            const int kj = k0 + tid;
            kid_s[tid] = kj < s ? kv_ids[(size_t)b * s + kj] : 0;
        }
        __syncthreads();

#pragma unroll
        for (int i = 0; i < NK; ++i) {
            const int j = sub + 4 * i;
            float ds = 0.f;
            if (q_in && k0 + j < s) {
                float dot = 0.f, dp = 0.f;
#pragma unroll
                for (int c = 0; c < D; ++c) {
                    dot = fmaf(qr[c], Ks[j * KP + c], dot);
                    dp = fmaf(dor[c], Vs[j * KP + c], dp);
                }
                const bool allowed = qid == kid_s[j] && (!causal || k0 + j <= qi);
                const float p = expf(masked_logit(dot, scale, allowed, bias_mode) - lse_r);
                if constexpr (DROP) {
                    dp = attn_drop::keep_pair(key, drop.threshold, drow, dhead, qi, k0 + j) ? dp * drop.keep_scale : 0.f;
                }
                ds = p * (dp - dl) * scale;
            }
            Ss[r * PP + j] = ds;
        }
        __syncthreads();

        for (int j = 0; j < BK; ++j) {
            const float ds = Ss[r * PP + j];
#pragma unroll
            for (int i = 0; i < NC; ++i) acc[i] = fmaf(ds, Ks[j * KP + sub + 4 * i], acc[i]);
        }
        __syncthreads();
    }

    if (q_in) {
        T* dqb = dq + row;
#pragma unroll
        for (int i = 0; i < NC; ++i) dqb[sub + 4 * i] = from_f<T>(acc[i]);
    }
}

template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(SIMT_THREADS)
attn_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout,
                const int* __restrict__ q_ids, const int* __restrict__ kv_ids,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dk, T* __restrict__ dv,
                int h, int s, float scale, int bias_mode, int causal, int skip_tiles, attn_drop::Params drop) {
    constexpr int QP = D + 1;       // padded q / do row
    constexpr int PP = BQ + 4;      // padded p^T / ds^T row, as in attn_dq_kernel
    constexpr int NQ = BQ / 4;      // queries per thread per tile
    constexpr int NC = D / 4;       // dk / dv columns per thread

    extern __shared__ float smem[];
    float* Qs = smem;                       // BQ x QP
    float* Os = Qs + BQ * QP;               // BQ x QP   (do)
    float* Pt = Os + BQ * QP;               // BK x PP   (p^T)
    float* St = Pt + BK * PP;               // BK x PP   (ds^T)
    float* lse_s = St + BK * PP;            // BQ
    float* delta_s = lse_s + BQ;            // BQ
    int* qid_s = reinterpret_cast<int*>(delta_s + BQ);  // BQ

    const int bh = blockIdx.x;
    const int b = bh / h;
    const int tid = threadIdx.x;
    const int r = tid >> 2;
    const int sub = tid & 3;
    const int kj = blockIdx.y * BK + r;
    const bool k_in = kj < s;

    const size_t base = (size_t)bh * s * D;
    const T* qb = q + base;
    const T* dob = dout + base;
    const size_t row = base + (size_t)(k_in ? kj : 0) * D;

    float kr[D], vr[D];
#pragma unroll
    for (int c = 0; c < D; ++c) {
        kr[c] = k_in ? to_f(k[row + c]) : 0.f;
        vr[c] = k_in ? to_f(v[row + c]) : 0.f;
    }
    const int kid = k_in ? kv_ids[(size_t)b * s + kj] : -3;
    uint2 key{};
    if constexpr (DROP) key = attn_drop::load_key(drop.seed);
    const int drow = drop.row0 + b, dhead = drop.head0 + bh % h;

    float dk_acc[NC], dv_acc[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) {
        dk_acc[i] = 0.f;
        dv_acc[i] = 0.f;
    }

    const int q_begin = (causal && !bias_mode && skip_tiles) ? blockIdx.y * BK : 0;
    for (int q0 = q_begin; q0 < s; q0 += BQ) {
        for (int idx = tid; idx < BQ * D; idx += SIMT_THREADS) {
            const int j = idx / D, c = idx % D;
            const int qj = q0 + j;
            float qv = 0.f, ov = 0.f;
            if (qj < s) {
                qv = to_f(qb[(size_t)qj * D + c]);
                ov = to_f(dob[(size_t)qj * D + c]);
            }
            Qs[j * QP + c] = qv;
            Os[j * QP + c] = ov;
        }
        if (tid < BQ) {
            const int qj = q0 + tid;
            const bool in = qj < s;
            lse_s[tid] = in ? lse[(size_t)bh * s + qj] : 0.f;
            delta_s[tid] = in ? delta[(size_t)bh * s + qj] : 0.f;
            qid_s[tid] = in ? q_ids[(size_t)b * s + qj] : -3;
        }
        __syncthreads();

#pragma unroll
        for (int i = 0; i < NQ; ++i) {
            const int j = sub + 4 * i;
            float p = 0.f, ds = 0.f;
            if (k_in && q0 + j < s) {
                float dot = 0.f, dp = 0.f;
#pragma unroll
                for (int c = 0; c < D; ++c) {
                    dot = fmaf(kr[c], Qs[j * QP + c], dot);
                    dp = fmaf(vr[c], Os[j * QP + c], dp);
                }
                const bool allowed = qid_s[j] == kid && (!causal || kj <= q0 + j);
                p = expf(masked_logit(dot, scale, allowed, bias_mode) - lse_s[j]);
                float pd = p;  // the dropped weight, dv's factor
                if constexpr (DROP) {
                    const float z = attn_drop::keep_pair(key, drop.threshold, drow, dhead, q0 + j, kj) ? drop.keep_scale : 0.f;
                    dp *= z;
                    pd = p * z;
                }
                ds = p * (dp - delta_s[j]) * scale;
                p = pd;
            }
            Pt[r * PP + j] = p;
            St[r * PP + j] = ds;
        }
        __syncthreads();

        for (int j = 0; j < BQ; ++j) {
            const float p = Pt[r * PP + j];
            const float ds = St[r * PP + j];
#pragma unroll
            for (int i = 0; i < NC; ++i) {
                const int c = sub + 4 * i;
                dv_acc[i] = fmaf(p, Os[j * QP + c], dv_acc[i]);
                dk_acc[i] = fmaf(ds, Qs[j * QP + c], dk_acc[i]);
            }
        }
        __syncthreads();
    }

    if (k_in) {
#pragma unroll
        for (int i = 0; i < NC; ++i) {
            dk[row + sub + 4 * i] = from_f<T>(dk_acc[i]);
            dv[row + sub + 4 * i] = from_f<T>(dv_acc[i]);
        }
    }
}

// ---------------------------------------------------------------- tensor cores

using namespace attn_mma;
using bf16 = __nv_bfloat16;

constexpr int PASS = 32;  // streamed columns per pass: two passes over a 64-row tile

// p = exp(masked logit - lse) of one (query, key) pair, taken as
// 2^(dot * scale * log2 e - lse * log2 e) with one FMA and one ex2.approx
// (relative error ~2e-6 at |logit - lse| < 30, far under the bf16 rounding
// of p that follows).  A disallowed pair in 'block' mode is 0 outright:
// lse >= -5e8 + log 1e-9 always, so exp(-1e9 - lse) is 0 in float32 and the
// CUDA-core kernels get the same 0 from expf.  Past a ragged end p is 0 in
// both modes, on both sides: `in` is false there on one side, and the other
// side's neg_lse_log2e is minus infinity.
__device__ __forceinline__ float pair_prob(float dot, float scale_log2e, float neg_lse_log2e, bool allowed,
                                           bool in, int bias_mode) {
    const float x = fmaf(dot, scale_log2e, neg_lse_log2e);
    float arg = x, p;
    if (bias_mode) arg = x + (allowed ? LOG2E : 0.f);
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(p) : "f"(arg));
    if (!bias_mode && !allowed) p = 0.f;
    return in ? p : 0.f;
}

// Dynamic shared memory of the dq kernel: the K and V rings and the tile's kv ids.
template <int D>
constexpr size_t dq_mma_smem_bytes() {
    return sizeof(bf16) * 2 * STAGES * TILE * D + sizeof(int) * STAGES * TILE;
}

// At D = 128 the dk/dv kernel keeps its own k and v tiles in shared memory
// and reads their A fragments with ldmatrix at each use: in registers they
// would take 64 of the 255 a thread, beside the 128 of the dk and dv
// accumulators.
template <int D>
constexpr bool DKV_OWN_IN_SMEM = D >= 128;

// Dynamic shared memory of the dk/dv kernel: the Q and dO rings, the tile's
// lse, delta and q ids, and at D = 128 the own k and v tiles.
template <int D>
constexpr size_t dkv_mma_smem_bytes() {
    return sizeof(bf16) * 2 * STAGES * TILE * D + 3 * sizeof(float) * STAGES * TILE +
           (DKV_OWN_IN_SMEM<D> ? sizeof(bf16) * 2 * TILE * D : 0);
}

template <int D, bool DROP>
__global__ void __launch_bounds__(THREADS, min_blocks<D>())
attn_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                   const bf16* __restrict__ o, const bf16* __restrict__ dout,
                   const int* __restrict__ q_ids, const int* __restrict__ kv_ids,
                   const float* __restrict__ lse, bf16* __restrict__ dq, float* __restrict__ delta,
                   int h, int s, int ld, int n_tiles, float scale, int bias_mode, int causal, int skip_tiles,
                   attn_drop::Params drop) {
    constexpr int KS = D / 16;  // 16-deep steps over the head dim
    constexpr int NO = D / 8;   // 8-column tiles of the dq accumulator

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

    // the block's own rows: this thread holds rows r_lo and r_hi of q and do
    const int r_lo = q0 + warp * 16 + g, r_hi = r_lo + 8;
    const bool in_lo = r_lo < s, in_hi = r_hi < s;
    uint32_t qa[KS][4], da[KS][4];
    load_a_global<D>(qa, q + base, r_lo, r_hi, s, ld, t);
    load_a_global<D>(da, dout + base, r_lo, r_hi, s, ld, t);

    // delta = rowsum(do * o): the row's four threads hold d/4 columns each
    float delta_lo = 0.f, delta_hi = 0.f;
    {
        uint32_t oa[KS][4];
        load_a_global<D>(oa, o + base, r_lo, r_hi, s, ld, t);
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float2 x = unpack_bf16(da[kk][i]), y = unpack_bf16(oa[kk][i]);
                float& acc = (i & 1) ? delta_hi : delta_lo;
                acc = fmaf(x.x, y.x, acc);
                acc = fmaf(x.y, y.y, acc);
            }
        }
        delta_lo += __shfl_xor_sync(0xffffffffu, delta_lo, 1);
        delta_lo += __shfl_xor_sync(0xffffffffu, delta_lo, 2);
        delta_hi += __shfl_xor_sync(0xffffffffu, delta_hi, 1);
        delta_hi += __shfl_xor_sync(0xffffffffu, delta_hi, 2);
        if (t == 0 && in_lo) delta[(size_t)bh * s + r_lo] = delta_lo;
        if (t == 0 && in_hi) delta[(size_t)bh * s + r_hi] = delta_hi;
    }
    const float scale_log2e = scale * LOG2E;
    // -lse * log2 e; minus infinity for a row past the end, whose p is then 0
    const float nlse_lo = in_lo ? -lse[(size_t)bh * s + r_lo] * LOG2E : -INFINITY;
    const float nlse_hi = in_hi ? -lse[(size_t)bh * s + r_hi] * LOG2E : -INFINITY;
    const int qid_lo = in_lo ? q_ids[(size_t)b * s + r_lo] : -3;
    const int qid_hi = in_hi ? q_ids[(size_t)b * s + r_hi] : -3;
    uint2 key{};
    if constexpr (DROP) key = attn_drop::load_key(drop.seed);

    float acc[NO][4];
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

    for (int it = 0; it < n_kt; ++it) {
        if (it + 1 < n_kt) load_stage((it + 1) & 1, (it + 1) * TILE);
        cp_async_commit();
        cp_async_wait<1>();  // everything but the newest group: tile `it` has arrived
        __syncthreads();
        const bf16* Kt = Ks[it & 1];
        const bf16* Vt = Vs[it & 1];
        const int* kid_t = kid_s[it & 1];
        const int k0 = it * TILE;

#pragma unroll
        for (int c0 = 0; c0 < TILE; c0 += PASS) {
            // S = Q.K^T and dP = dO.V^T for this thread's rows and keys c0 .. c0+31
            float sa[PASS / 8][4], pa[PASS / 8][4];
#pragma unroll
            for (int j = 0; j < PASS / 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) sa[j][e] = pa[j][e] = 0.f;
#pragma unroll
            for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
                for (int np = 0; np < PASS / 16; ++np) {
                    uint32_t bk[4], bv[4];
                    load_b_rows<D>(bk, Kt, c0 + np * 16, kk, lane);
                    load_b_rows<D>(bv, Vt, c0 + np * 16, kk, lane);
                    mma_bf16(sa[2 * np], qa[kk], bk[0], bk[1]);
                    mma_bf16(sa[2 * np + 1], qa[kk], bk[2], bk[3]);
                    mma_bf16(pa[2 * np], da[kk], bv[0], bv[1]);
                    mma_bf16(pa[2 * np + 1], da[kk], bv[2], bv[3]);
                }
            }
            uint32_t keep = 0;
            if constexpr (DROP) {
                keep = attn_drop::keep_bits<true, PASS>(key, drop, drop.row0 + b, drop.head0 + bh % h, attn_drop::group_of(r_lo),
                                       k0 + c0, t);
            }
            // ds in fragment coordinates, in place of S
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
                    const float p = pair_prob(sa[j][e], scale_log2e, hi ? nlse_hi : nlse_lo, allowed, k_pos < s, bias_mode);
                    float dp = pa[j][e];
                    if constexpr (DROP) dp = (keep >> (4 * j + e)) & 1u ? dp * drop.keep_scale : 0.f;
                    sa[j][e] = p * (dp - (hi ? delta_hi : delta_lo)) * scale;
                }
            }
            // dq += dS.K over these 32 keys
#pragma unroll
            for (int ks = 0; ks < PASS / 16; ++ks) {
                uint32_t dsa[4];
                pack_a_from_c(dsa, sa[2 * ks], sa[2 * ks + 1]);
#pragma unroll
                for (int np = 0; np < NO / 2; ++np) {
                    uint32_t bk[4];
                    load_b_cols<D>(bk, Kt, c0 + ks * 16, np * 16, lane);
                    mma_bf16(acc[2 * np], dsa, bk[0], bk[1]);
                    mma_bf16(acc[2 * np + 1], dsa, bk[2], bk[3]);
                }
            }
        }
        __syncthreads();  // the stage is free for the load after next
    }

    bf16* dq_lo = dq + base + (size_t)r_lo * ld;
    bf16* dq_hi = dq + base + (size_t)r_hi * ld;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
        const int col = 8 * j + 2 * t;
        // the 8-column tiles past the caller's head dim (a multiple of 8) are not stored: a guard
        // on j alone, the same for the whole block
        if (8 * j >= ld) continue;
        if (in_lo) *reinterpret_cast<__nv_bfloat162*>(dq_lo + col) = __floats2bfloat162_rn(acc[j][0], acc[j][1]);
        if (in_hi) *reinterpret_cast<__nv_bfloat162*>(dq_hi + col) = __floats2bfloat162_rn(acc[j][2], acc[j][3]);
    }
}

template <int D, bool DROP>
__global__ void __launch_bounds__(THREADS, min_blocks<D>())
attn_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                    const bf16* __restrict__ dout,
                    const int* __restrict__ q_ids, const int* __restrict__ kv_ids,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dk, bf16* __restrict__ dv,
                    int h, int s, int ld, int n_tiles, float scale, int bias_mode, int causal, int skip_tiles,
                    attn_drop::Params drop) {
    constexpr int KS = D / 16;
    constexpr int NO = D / 8;
    constexpr bool OWN_SMEM = DKV_OWN_IN_SMEM<D>;

    extern __shared__ __align__(128) unsigned char mma_smem[];
    bf16(*Qs)[TILE * D] = reinterpret_cast<bf16(*)[TILE * D]>(mma_smem);
    bf16(*Os)[TILE * D] = Qs + STAGES;  // do
    float(*lse_s)[TILE] = reinterpret_cast<float(*)[TILE]>(Os + STAGES);
    float(*delta_s)[TILE] = lse_s + STAGES;
    int(*qid_s)[TILE] = reinterpret_cast<int(*)[TILE]>(delta_s + STAGES);
    bf16* k_own = reinterpret_cast<bf16*>(qid_s + STAGES);  // OWN_SMEM only
    bf16* v_own = k_own + TILE * D;

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const bool skip = causal && !bias_mode && skip_tiles;
    int bh, tile;
    block_coords(n_tiles, skip, false, bh, tile);
    const int b = bh / h;
    const int kt0 = tile * TILE;
    const size_t base = (size_t)bh * s * ld;
    const bf16* qb = q + base;
    const bf16* dob = dout + base;
    const float* lseb = lse + (size_t)bh * s;
    const float* deltab = delta + (size_t)bh * s;
    const int* qidb = q_ids + (size_t)b * s;

    const int qt_begin = skip ? tile : 0;  // start at the diagonal tile
    const int n_qt = n_tiles - qt_begin;

    auto load_stage = [&](int stage, int q0) {
        load_tile_async<D>(Qs[stage], qb, q0, s, ld, tid);
        load_tile_async<D>(Os[stage], dob, q0, s, ld, tid);
        if (tid < TILE) {
            load_row_async(lse_s[stage], lseb, q0, s, tid);
            load_row_async(delta_s[stage], deltab, q0, s, tid);
            load_row_async(qid_s[stage], qidb, q0, s, tid);
        }
    };
    if constexpr (OWN_SMEM) {  // in the first group: it has arrived when tile 0 has
        load_tile_async<D>(k_own, k + base, kt0, s, ld, tid);
        load_tile_async<D>(v_own, v + base, kt0, s, ld, tid);
    }
    load_stage(0, qt_begin * TILE);
    cp_async_commit();

    // the block's own rows: this thread holds keys r_lo and r_hi of k and v
    const int r_lo = kt0 + warp * 16 + g, r_hi = r_lo + 8;
    const bool in_lo = r_lo < s, in_hi = r_hi < s;
    uint32_t ka[OWN_SMEM ? 1 : KS][4], va[OWN_SMEM ? 1 : KS][4];
    if constexpr (!OWN_SMEM) {
        load_a_global<D>(ka, k + base, r_lo, r_hi, s, ld, t);
        load_a_global<D>(va, v + base, r_lo, r_hi, s, ld, t);
    }
    const int kid_lo = in_lo ? kv_ids[(size_t)b * s + r_lo] : -3;
    const int kid_hi = in_hi ? kv_ids[(size_t)b * s + r_hi] : -3;
    const float scale_log2e = scale * LOG2E;
    uint2 key{};
    if constexpr (DROP) key = attn_drop::load_key(drop.seed);

    float dk_acc[NO][4], dv_acc[NO][4];
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

    for (int it = 0; it < n_qt; ++it) {
        if (it + 1 < n_qt) load_stage((it + 1) & 1, (qt_begin + it + 1) * TILE);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        const bf16* Qt = Qs[it & 1];
        const bf16* Ot = Os[it & 1];
        const float* lse_t = lse_s[it & 1];
        const float* delta_t = delta_s[it & 1];
        const int* qid_t = qid_s[it & 1];
        const int q0 = (qt_begin + it) * TILE;

#pragma unroll
        for (int c0 = 0; c0 < TILE; c0 += PASS) {
            // S^T = K.Q^T and dP^T = V.dO^T: rows are this thread's keys, columns queries c0 .. c0+31
            float sa[PASS / 8][4], pa[PASS / 8][4];
#pragma unroll
            for (int j = 0; j < PASS / 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) sa[j][e] = pa[j][e] = 0.f;
#pragma unroll
            for (int kk = 0; kk < KS; ++kk) {
                uint32_t ak[4], av[4];
                if constexpr (OWN_SMEM) {
                    load_a_smem<D>(ak, k_own, warp * 16, kk, lane);
                    load_a_smem<D>(av, v_own, warp * 16, kk, lane);
                } else {
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        ak[i] = ka[kk][i];
                        av[i] = va[kk][i];
                    }
                }
#pragma unroll
                for (int np = 0; np < PASS / 16; ++np) {
                    uint32_t bq[4], bo[4];
                    load_b_rows<D>(bq, Qt, c0 + np * 16, kk, lane);
                    load_b_rows<D>(bo, Ot, c0 + np * 16, kk, lane);
                    mma_bf16(sa[2 * np], ak, bq[0], bq[1]);
                    mma_bf16(sa[2 * np + 1], ak, bq[2], bq[3]);
                    mma_bf16(pa[2 * np], av, bo[0], bo[1]);
                    mma_bf16(pa[2 * np + 1], av, bo[2], bo[3]);
                }
            }
            uint32_t keep = 0;
            if constexpr (DROP) {
                keep = attn_drop::keep_bits<false, PASS>(key, drop, drop.row0 + b, drop.head0 + bh % h, attn_drop::group_of(r_lo),
                                        q0 + c0, t);
            }
            // p^T in place of S^T, ds^T in place of dP^T; lse, delta and q ids go by column
#pragma unroll
            for (int j = 0; j < PASS / 8; ++j) {
                const int col = c0 + 8 * j + 2 * t;
                float2 nl = *reinterpret_cast<const float2*>(lse_t + col);
                nl.x = q0 + col < s ? -nl.x * LOG2E : -INFINITY;  // a query past the end: p = 0
                nl.y = q0 + col + 1 < s ? -nl.y * LOG2E : -INFINITY;
                const float2 dl = *reinterpret_cast<const float2*>(delta_t + col);
                const int2 qid = *reinterpret_cast<const int2*>(qid_t + col);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const bool hi = e >= 2;
                    const int q_pos = q0 + col + (e & 1);
                    const bool allowed = pair_allowed((e & 1) ? qid.y : qid.x, hi ? kid_hi : kid_lo,
                                                      q_pos, hi ? r_hi : r_lo, causal);
                    // a key row past the end needs no mask: the rows of a product do not mix,
                    // and its rows of dk and dv are not stored
                    const float p = pair_prob(sa[j][e], scale_log2e, (e & 1) ? nl.y : nl.x, allowed, true, bias_mode);
                    if constexpr (DROP) {
                        const float z = (keep >> (4 * j + e)) & 1u ? drop.keep_scale : 0.f;
                        sa[j][e] = p * z;
                        pa[j][e] = p * (pa[j][e] * z - ((e & 1) ? dl.y : dl.x)) * scale;
                    } else {
                        sa[j][e] = p;
                        pa[j][e] = p * (pa[j][e] - ((e & 1) ? dl.y : dl.x)) * scale;
                    }
                }
            }
            // dv += P^T.dO and dk += dS^T.Q over these 32 queries
#pragma unroll
            for (int ks = 0; ks < PASS / 16; ++ks) {
                uint32_t pta[4], dsa[4];
                pack_a_from_c(pta, sa[2 * ks], sa[2 * ks + 1]);
                pack_a_from_c(dsa, pa[2 * ks], pa[2 * ks + 1]);
#pragma unroll
                for (int np = 0; np < NO / 2; ++np) {
                    uint32_t bo[4], bq[4];
                    load_b_cols<D>(bo, Ot, c0 + ks * 16, np * 16, lane);
                    load_b_cols<D>(bq, Qt, c0 + ks * 16, np * 16, lane);
                    mma_bf16(dv_acc[2 * np], pta, bo[0], bo[1]);
                    mma_bf16(dv_acc[2 * np + 1], pta, bo[2], bo[3]);
                    mma_bf16(dk_acc[2 * np], dsa, bq[0], bq[1]);
                    mma_bf16(dk_acc[2 * np + 1], dsa, bq[2], bq[3]);
                }
            }
        }
        __syncthreads();
    }

    const size_t lo = base + (size_t)r_lo * ld, hi = base + (size_t)r_hi * ld;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
        const int col = 8 * j + 2 * t;
        if (8 * j >= ld) continue;  // as in the dq kernel
        if (in_lo) {
            *reinterpret_cast<__nv_bfloat162*>(dk + lo + col) = __floats2bfloat162_rn(dk_acc[j][0], dk_acc[j][1]);
            *reinterpret_cast<__nv_bfloat162*>(dv + lo + col) = __floats2bfloat162_rn(dv_acc[j][0], dv_acc[j][1]);
        }
        if (in_hi) {
            *reinterpret_cast<__nv_bfloat162*>(dk + hi + col) = __floats2bfloat162_rn(dk_acc[j][2], dk_acc[j][3]);
            *reinterpret_cast<__nv_bfloat162*>(dv + hi + col) = __floats2bfloat162_rn(dv_acc[j][2], dv_acc[j][3]);
        }
    }
}

// ---------------------------------------------------------------- launches

struct BwdArgs {
    const void *q, *k, *v, *o, *dout;
    const int *q_ids, *kv_ids;
    const float* lse;
    float* delta;  // written by dq, read by dk/dv
    void *dq, *dk, *dv;
    int b, h, s, ld;  // ld: the row width in device memory (the caller's head dim in the tensor-core kernels)
    float scale;
    int bias_mode, causal, skip_tiles;
    attn_drop::Params drop;
    cudaStream_t stream;
};

template <typename T, int D, bool DROP>
cudaError_t launch_dq(const BwdArgs& a) {
    constexpr size_t smem = dq_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        attn_dq_kernel<T, D, DROP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid(a.b * a.h, (a.s + BQ - 1) / BQ);
    attn_dq_kernel<T, D, DROP><<<grid, SIMT_THREADS, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.q_ids, a.kv_ids, a.lse,
        static_cast<T*>(a.dq), a.delta, a.h, a.s, a.scale, a.bias_mode, a.causal, a.skip_tiles, a.drop);
    return cudaGetLastError();
}

template <typename T, int D, bool DROP>
cudaError_t launch_dkv(const BwdArgs& a) {
    constexpr size_t smem = dkv_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        attn_dkv_kernel<T, D, DROP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid(a.b * a.h, (a.s + BK - 1) / BK);
    attn_dkv_kernel<T, D, DROP><<<grid, SIMT_THREADS, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(a.dout), a.q_ids, a.kv_ids, a.lse, a.delta,
        static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.h, a.s, a.scale, a.bias_mode, a.causal, a.skip_tiles,
        a.drop);
    return cudaGetLastError();
}

template <int D, bool DROP>
cudaError_t launch_dq_mma(const BwdArgs& a) {
    constexpr size_t smem = dq_mma_smem_bytes<D>();
    cudaError_t err = allow_smem(attn_dq_mma_kernel<D, DROP>, smem);
    if (err != cudaSuccess) return err;
    const int n_tiles = (a.s + TILE - 1) / TILE;
    attn_dq_mma_kernel<D, DROP><<<a.b * a.h * n_tiles, THREADS, smem, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
        static_cast<const bf16*>(a.o), static_cast<const bf16*>(a.dout), a.q_ids, a.kv_ids, a.lse,
        static_cast<bf16*>(a.dq), a.delta, a.h, a.s, a.ld, n_tiles, a.scale, a.bias_mode, a.causal, a.skip_tiles,
        a.drop);
    return cudaGetLastError();
}

template <int D, bool DROP>
cudaError_t launch_dkv_mma(const BwdArgs& a) {
    constexpr size_t smem = dkv_mma_smem_bytes<D>();
    cudaError_t err = allow_smem(attn_dkv_mma_kernel<D, DROP>, smem);
    if (err != cudaSuccess) return err;
    const int n_tiles = (a.s + TILE - 1) / TILE;
    attn_dkv_mma_kernel<D, DROP><<<a.b * a.h * n_tiles, THREADS, smem, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
        static_cast<const bf16*>(a.dout), a.q_ids, a.kv_ids, a.lse, a.delta,
        static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.h, a.s, a.ld, n_tiles, a.scale, a.bias_mode, a.causal,
        a.skip_tiles, a.drop);
    return cudaGetLastError();
}

// impl 1 takes bfloat16 only; impl 2 (float32) is attention_bwd_tf32x3.cu's
bool known(int impl, int dtype) {
    return (dtype == 0 || dtype == 1) && (impl == 0 || (impl == 1 && dtype == 1));
}

// One backward kernel (DKV: dk/dv, else dq) for rows of d values: launched,
// or (info != nullptr, d an instantiation) described.  The tensor-core
// kernels run the instantiation instantiation_for(d) on rows of d in place
// (d a multiple of 8); the CUDA-core kernels take an instantiation's d only.
template <bool DKV>
cudaError_t run(int impl, int dtype, int d, bool drop, const BwdArgs* a, int* info) {
    if (!known(impl, dtype)) return cudaErrorInvalidValue;
    const int dim = instantiation_for(d);
    if (impl == 1 ? d % 8 != 0 : dim != d) return cudaErrorInvalidValue;
    return dispatch(dim, drop, [&](auto inst) {
        constexpr int D = decltype(inst)::D;
        constexpr bool DROP = decltype(inst)::DROP;
        using bf = __nv_bfloat16;
        if constexpr (DKV) {
            if (info != nullptr) {
                if (impl == 1) return kernel_info(attn_dkv_mma_kernel<D, DROP>, THREADS, dkv_mma_smem_bytes<D>(), info);
                if (dtype == 1) return kernel_info(attn_dkv_kernel<bf, D, DROP>, SIMT_THREADS, dkv_smem_bytes<D>(), info);
                return kernel_info(attn_dkv_kernel<float, D, DROP>, SIMT_THREADS, dkv_smem_bytes<D>(), info);
            }
            if (a->b * a->h == 0 || a->s == 0) return cudaSuccess;
            if (impl == 1) return launch_dkv_mma<D, DROP>(*a);
            if (dtype == 1) return launch_dkv<bf, D, DROP>(*a);
            return launch_dkv<float, D, DROP>(*a);
        } else {
            if (info != nullptr) {
                if (impl == 1) return kernel_info(attn_dq_mma_kernel<D, DROP>, THREADS, dq_mma_smem_bytes<D>(), info);
                if (dtype == 1) return kernel_info(attn_dq_kernel<bf, D, DROP>, SIMT_THREADS, dq_smem_bytes<D>(), info);
                return kernel_info(attn_dq_kernel<float, D, DROP>, SIMT_THREADS, dq_smem_bytes<D>(), info);
            }
            if (a->b * a->h == 0 || a->s == 0) return cudaSuccess;
            if (impl == 1) return launch_dq_mma<D, DROP>(*a);
            if (dtype == 1) return launch_dq<bf, D, DROP>(*a);
            return launch_dq<float, D, DROP>(*a);
        }
    });
}

}  // namespace

// The source builds two libraries, one a kernel, so that their two nvcc runs
// go in parallel: ATTN_BWD_PART 0 holds the dq kernel (attn_bwd_dq), 1 the
// dk/dv kernel (attn_bwd_dkv); kernels/_build.py passes the define.
#ifndef ATTN_BWD_PART
#error "build with -DATTN_BWD_PART=0 (dq) or -DATTN_BWD_PART=1 (dk/dv)"
#endif

// dtype: 0 = float32, 1 = bfloat16; impl: 0 = CUDA cores ("simt"), 1 = tensor
// cores ("mma", bfloat16 only); d the rows' width: one of 16, 32, 64, 128,
// or for impl 1 any multiple of 8 up to 128 (read and written in place); causal and
// skip_tiles as in the header; seed, threshold, keep_scale, row0 and head0
// as in attn_fwd (attention_fwd.cu), the same as the forward got.  All
// return a cudaError_t (0 on success).

#if ATTN_BWD_PART == 0
// dq (b, h, s, d) in the input type, and delta (b, h, s) float32 as a by-product.
extern "C" int attn_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                           const void* dout, const int* q_ids, const int* kv_ids,
                           const float* lse, void* dq, float* delta, int b, int h, int s, int d,
                           float scale, int bias_mode, int causal, int skip_tiles, int dtype, int impl,
                           const unsigned long long* seed, unsigned int threshold, float keep_scale, int row0,
                           int head0, void* stream) {
    const BwdArgs a{q, k, v, o, dout, q_ids, kv_ids, lse, delta, dq, nullptr, nullptr,
                    b, h, s, d, scale, bias_mode, causal, skip_tiles,
                    attn_drop::Params{seed, threshold, keep_scale, row0, head0}, static_cast<cudaStream_t>(stream)};
    return run<false>(impl, dtype, d, seed != nullptr, &a, nullptr);
}
#else
// dk, dv (b, h, s, d) in the input type; delta is the buffer attn_bwd_dq filled.
extern "C" int attn_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                            const int* q_ids, const int* kv_ids, const float* lse,
                            float* delta, void* dk, void* dv, int b, int h, int s, int d,
                            float scale, int bias_mode, int causal, int skip_tiles, int dtype, int impl,
                            const unsigned long long* seed, unsigned int threshold, float keep_scale, int row0,
                            int head0, void* stream) {
    const BwdArgs a{q, k, v, nullptr, dout, q_ids, kv_ids, lse, delta, nullptr, dk, dv,
                    b, h, s, d, scale, bias_mode, causal, skip_tiles,
                    attn_drop::Params{seed, threshold, keep_scale, row0, head0}, static_cast<cudaStream_t>(stream)};
    return run<true>(impl, dtype, d, seed != nullptr, &a, nullptr);
}
#endif

// What the compiler and the card make of one instantiation of this
// library's kernel (drop: the dropout mode's): out[0] registers a thread,
// out[1] local-memory (spill) bytes a thread, out[2] blocks that fit on one
// SM, out[3] shared-memory bytes a block.
extern "C" int attn_bwd_kernel_info(int impl, int dtype, int d, int drop, int* out) {
    return run<ATTN_BWD_PART == 1>(impl, dtype, d, drop != 0, nullptr, out);
}
