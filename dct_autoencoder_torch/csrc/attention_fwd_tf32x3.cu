// Packed block-diagonal attention, forward, in float32 on Hopper's tensor
// cores in 3xTF32 (sm_90a): the float32 implementation of the forward kernel,
// impl 2, "tf32x3".
//
// Replaces, for float32 inputs, dct_autoencoder_tpu/kernels/attention.py::
// _attn_fwd_kernel (called from _flash_attention_fwd_impl).  It computes what
// the kernels of attention_fwd.cu compute, with the same contract (see that
// header): q, k, v (b, h, s, d) float32, q_ids / kv_ids (b, s) int32; o (b, h,
// s, d) and the row log-sum-exp lse (b, h, s), natural log.  The mask ('block'
// -1e9, 'bias' +1), the running max that starts at -5e8 (a fully masked row
// gives o = 0 and lse = -5e8 + log(1e-9)), keys past a ragged end at -inf,
// the causal mode and its tile skipping (blocks scheduled from the last q
// tile), and the dropout mode (the keep bits of attn_dropout.cuh at the same
// (row, head, query, key) counter; l and lse from the undropped p, 1/(1 -
// rate) applied with 1/l) are those of attention_fwd.cu.  No atomics: two
// launches give the same bits.
//
// Arithmetic.  S = Q.K^T and O += P.V run on mma.sync.m16n8k8 in TF32 as
// three products of TF32 parts (lo*hi + hi*lo + hi*hi, the lo*lo term of
// ~2^-22 of the product dropped; attn_tf32x3.cuh), each 8-deep slice summed
// on the tensor cores from zero and added to the fp32 accumulator on the CUDA
// cores, which round to nearest where the tensor cores truncate: about 22
// significant bits, within fp32's 1e-5, where one TF32 product keeps 11.  The
// online softmax runs in fp32 on the CUDA cores with the CUDA-core kernel's
// arithmetic (expf of logit - m, the accumulator and l rescaled by
// expf(m_old - m_new) once a tile, the tile's row sum reduced over the quad
// and added to l), not the bf16 kernel's ex2.approx; p enters P.V split, in
// fp32, never rounded to a narrower type.
//
// Bound on the H100: at (64, 16, 256, 64) 'block' the call reads q, k, v and
// writes o, ~268 MB (0.080 ms at 3.35 TB/s); the products of the pairs
// inside an image take less at 3xTF32's effective 165 TFLOP/s (17.2 GFLOP
// if every pair were computed: 0.104 ms), so bytes bound it.  At the
// sweep's (4, 8, 3072, 32) every pair is allowed: 38.7 GFLOP, 0.234 ms, and
// operations bound it.
// mma.sync reaches only part of the tensor cores' rate, and each fragment a
// product reads costs a split (five FP32-pipe instructions) and each slice
// four adds, so the CUDA cores' instruction slots share the bound, with the
// softmax's expf.
//
// Design: the design of attention_bwd_tf32x3.cu with one product fewer.  One
// block per (b*h, 64-row q tile), 128 threads, four warps, each owning 16
// query rows.  K and V stream as fp32 rows of D + 4 floats (with the tile's
// kv ids) through a two-stage cp.async ring.  The q tile is loaded once into
// shared memory; up to D = 32 its split A fragments are taken into registers
// before the loop (2 x D / 2 registers), from D = 64 on they are read and
// split at each use, as the backward reads its own tiles: on an H100 that
// was faster at D = 64, where q in registers left 255 a thread with the S
// and o accumulators and spilled, and slower at D = 32; the bits are the
// same.  S comes out in accumulator layout (each thread two rows, 16 of the
// tile's 64 keys); each
// 8-key slice of p is split in place as the A fragment of O += P.V in the
// permuted depth order (a_from_c: (c0, c1, c2, c3) -> (c0, c2, c1, c3)), and
// V's B fragment reads rows 2t and 2t + 1: no shuffle, no trip through
// shared memory.
//
// Head dims: instantiations D = 16, 32, 64 and 128; rows in device memory
// are `ld` floats apart, any multiple of 4 up to D, read and written in
// place: the loads zero-fill the columns past ld (a zero column adds
// nothing to q.k, and a zero v column only makes an o column that is not
// stored).

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

// Whether the block's q fragments are split once into registers (else read
// from shared memory and split at each use).
template <int D>
constexpr bool Q_IN_REGS = D <= 32;

// Dynamic shared memory: the q tile, STAGES of the k and v tiles, the k tiles' ids.
template <int D>
constexpr size_t fwd_smem_bytes() {
    return sizeof(float) * (1 + 2 * STAGES) * TILE_FLOATS<D> + sizeof(int) * STAGES * TILE;
}

template <int D, bool DROP>
__global__ void __launch_bounds__(THREADS, min_blocks<D>())
attn_fwd_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                       const int* __restrict__ q_ids, const int* __restrict__ kv_ids,
                       float* __restrict__ o, float* __restrict__ lse,
                       int h, int s, int ld, int n_tiles, float scale, int bias_mode, int causal, int skip_tiles,
                       attn_drop::Params drop) {
    constexpr int KK = D / 8;     // 8-deep slices of S = Q.K^T over the head dim
    constexpr int NS = TILE / 8;  // 8-column tiles of S over the streamed tile's keys
    constexpr int NO = D / 8;     // 8-column tiles of the o accumulator
    constexpr int TF = TILE_FLOATS<D>;
    constexpr bool QREG = Q_IN_REGS<D>;

    extern __shared__ __align__(16) float smem[];
    float* Qs = smem;                                        // own q
    float* Ks = Qs + TF;                                     // STAGES k tiles
    float* Vs = Ks + STAGES * TF;                            // STAGES v tiles
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
    load_tile<D>(Qs, q + base, q0, s, ld, tid);
    if constexpr (QREG) attn_mma::cp_async_commit();  // a group of its own: split before tile 0 arrives
    load_stage(0, 0);
    attn_mma::cp_async_commit();

    uint32_t qh[QREG ? KK : 1][4], ql[QREG ? KK : 1][4];
    if constexpr (QREG) {
        attn_mma::cp_async_wait<1>();  // the q tile, with tile 0 still in flight
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < KK; ++kk) a_frag<D>(qh[kk], ql[kk], Qs, warp * 16, kk, g, t);
    }

    // the thread's own rows r_lo and r_lo + 8: ids, row max m and row sum l (the quad's, in every thread)
    const int r_lo = q0 + warp * 16 + g;
    int qid[2];
    float m[2], l[2];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
        const int r = r_lo + 8 * hi;
        qid[hi] = r < s ? q_ids[(size_t)b * s + r] : -3;
        m[hi] = -5e8f;  // the reference's clamp on the row max
        l[hi] = 0.f;
    }
    float acc[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    uint2 key{};
    if constexpr (DROP) key = attn_drop::load_key(drop.seed);

    for (int it = 0; it < n_kt; ++it) {
        if (it + 1 < n_kt) load_stage((it + 1) & 1, (it + 1) * TILE);
        attn_mma::cp_async_commit();
        attn_mma::cp_async_wait<1>();  // everything but the newest group: tile `it` has arrived
        __syncthreads();
        const float* Kt = Ks + (it & 1) * TF;
        const float* Vt = Vs + (it & 1) * TF;
        const int* kid_t = kid_s + (it & 1) * TILE;
        const int k0 = it * TILE;

        // S = Q.K^T for this thread's two rows and 16 of the tile's 64 keys
        float sa[NS][4];
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) sa[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KK; ++kk) {
            uint32_t xh[4], xl[4];
            if constexpr (QREG) {
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    xh[i] = qh[kk][i];
                    xl[i] = ql[kk][i];
                }
            } else {
                a_frag<D>(xh, xl, Qs, warp * 16, kk, g, t);
            }
#pragma unroll
            for (int j = 0; j < NS; ++j) {
                uint32_t kh[2], kl[2];
                b_frag_rows<D>(kh, kl, Kt, 8 * j, kk, g, t);
                add_slice(sa[j], xh, xl, kh, kl);
            }
        }

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
        float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
            mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], 1));
            mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], 2));
            const float m_new = fmaxf(m[hi], mx[hi]);
            alpha[hi] = expf(m[hi] - m_new);
            m[hi] = m_new;
        }
        // p = exp(logit - m) in place of the logits; the row sums take the undropped p
#pragma unroll
        for (int j = 0; j < NS; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float p = expf(sa[j][e] - m[e >> 1]);
                psum[e >> 1] += p;
                sa[j][e] = p;
            }
        }
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
            psum[hi] += __shfl_xor_sync(0xffffffffu, psum[hi], 1);
            psum[hi] += __shfl_xor_sync(0xffffffffu, psum[hi], 2);
            l[hi] = l[hi] * alpha[hi] + psum[hi];
#pragma unroll
            for (int n = 0; n < NO; ++n) {
                acc[n][2 * hi] *= alpha[hi];
                acc[n][2 * hi + 1] *= alpha[hi];
            }
        }
        if constexpr (DROP) {
            // bit 4 j + e of the two 32-key halves: element e of S's 8-column tile j
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const uint32_t keep = attn_drop::keep_bits<true, 32>(key, drop, drop.row0 + b, drop.head0 + bh % h,
                                                                     attn_drop::group_of(r_lo), k0 + 32 * half, t);
#pragma unroll
                for (int j = 0; j < NS / 2; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        if (!((keep >> (4 * j + e)) & 1u)) sa[4 * half + j][e] = 0.f;
            }
        }

        // O += P.V over the tile's 64 keys, by 8-key slices
#pragma unroll
        for (int j = 0; j < NS; ++j) {
            uint32_t ph[4], pl[4];
            a_from_c(ph, pl, sa[j]);
#pragma unroll
            for (int n = 0; n < NO; ++n) {
                uint32_t vh[2], vl[2];
                b_frag_cols<D>(vh, vl, Vt, 8 * j, 8 * n, g, t);
                add_slice(acc[n], ph, pl, vh, vl);
            }
        }
        __syncthreads();  // the stage is free for the load after next
    }

#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
        const int r = r_lo + 8 * hi;
        const float den = fmaxf(l[hi], 1e-9f);
        float inv = 1.f / den;
        if constexpr (DROP) inv *= drop.keep_scale;
        if (r >= s) continue;
        float* orow = o + base + (size_t)r * ld;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
            const int col = 8 * n + 2 * t;
            if (col >= ld) continue;  // the columns past the caller's head dim are not stored
            *reinterpret_cast<float2*>(orow + col) = make_float2(acc[n][2 * hi] * inv, acc[n][2 * hi + 1] * inv);
        }
        if (t == 0) lse[(size_t)bh * s + r] = m[hi] + logf(den);
    }
}

struct FwdArgs {
    const float *q, *k, *v;
    const int *q_ids, *kv_ids;
    float *o, *lse;
    int b, h, s, ld;
    float scale;
    int bias_mode, causal, skip_tiles;
    attn_drop::Params drop;
    cudaStream_t stream;
};

template <int D, bool DROP>
cudaError_t launch(const FwdArgs& a) {
    constexpr size_t smem = fwd_smem_bytes<D>();
    cudaError_t err = attn_mma::allow_smem(attn_fwd_tf32x3_kernel<D, DROP>, smem);
    if (err != cudaSuccess) return err;
    const int n_tiles = (a.s + TILE - 1) / TILE;
    attn_fwd_tf32x3_kernel<D, DROP><<<a.b * a.h * n_tiles, THREADS, smem, a.stream>>>(
        a.q, a.k, a.v, a.q_ids, a.kv_ids, a.o, a.lse, a.h, a.s, a.ld, n_tiles, a.scale, a.bias_mode, a.causal,
        a.skip_tiles, a.drop);
    return cudaGetLastError();
}

// The forward for rows of d floats (d a multiple of 4 up to 128, run by the
// instantiation attn_mma::instantiation_for(d) in place): launched, or
// (info != nullptr, d an instantiation) described.  Takes impl 2 on float32
// (dtype 0) only.
cudaError_t run(int impl, int dtype, int d, bool drop, const FwdArgs* a, int* info) {
    if (impl != 2 || dtype != 0 || d % 4) return cudaErrorInvalidValue;
    return attn_mma::dispatch(attn_mma::instantiation_for(d), drop, [&](auto inst) {
        constexpr int D = decltype(inst)::D;
        constexpr bool DROP = decltype(inst)::DROP;
        if (info != nullptr)
            return attn_mma::kernel_info(attn_fwd_tf32x3_kernel<D, DROP>, THREADS, fwd_smem_bytes<D>(), info);
        if (a->b * a->h == 0 || a->s == 0) return cudaSuccess;
        return launch<D, DROP>(*a);
    });
}

}  // namespace

// The arguments of attn_fwd (attention_fwd.cu), pointers to float32 data;
// dtype must be 0 (float32) and impl 2 (tf32x3); d the rows' width.  Returns
// a cudaError_t (0 on success).
extern "C" int attn_fwd_tf32x3(const void* q, const void* k, const void* v, const int* q_ids, const int* kv_ids,
                               void* o, float* lse, int b, int h, int s, int d, float scale, int bias_mode,
                               int causal, int skip_tiles, int dtype, int impl, const unsigned long long* seed,
                               unsigned int threshold, float keep_scale, int row0, int head0, void* stream) {
    const FwdArgs a{static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
                    q_ids, kv_ids, static_cast<float*>(o), lse, b, h, s, d, scale, bias_mode, causal, skip_tiles,
                    attn_drop::Params{seed, threshold, keep_scale, row0, head0}, static_cast<cudaStream_t>(stream)};
    return run(impl, dtype, d, seed != nullptr, &a, nullptr);
}

// What the compiler and the card make of one instantiation (drop: the
// dropout mode's): registers and local (spill) bytes a thread, blocks an
// SM, shared bytes a block, as attn_fwd_kernel_info.
extern "C" int attn_fwd_tf32x3_kernel_info(int impl, int dtype, int d, int drop, int* out) {
    return run(impl, dtype, d, drop != 0, nullptr, out);
}
