// Attention dropout's random stream, shared by the kernels of
// attention_fwd.cu and attention_bwd.cu; kernels/attention.py holds its plain
// PyTorch twin (attention_dropout_keep_mask), bit for bit.
//
// The TPU kernels draw nothing: the JAX package drops attention weights
// only on its XLA path (nn.Dropout after the softmax).  Here the dropout
// lives inside the kernels, so the forward and the two backward kernels must
// draw the same mask without storing it.  Philox4x32-10 (Salmon, Moraes,
// Dror and Shaw, "Parallel random numbers: as easy as 1, 2, 3", SC 2011) is
// counter-based: its four output words are a function of a 64-bit key (the
// seed, read from device memory, so a layer does no host read) and a
// 128-bit counter.  The counter is (batch row, head, query group, key
// group) with row and head offset by where this call's rows and heads lie
// in the whole batch and model (a data- or tensor-parallel rank passes its
// offsets), so the mask does not depend on tiles, warps or ranks.
//
// Grouping: a group is the four pairs (q, k), (q, k + 8), (q + 8, k),
// (q + 8, k + 8) with q and k at bits 3 clear; its index along one axis is
// (pos >> 4) * 8 + (pos & 7), and word (q >> 3 & 1) * 2 + (k >> 3 & 1)
// decides the pair.  In every tensor-core kernel one thread holds exactly
// such quadruples (rows g and g + 8 of its warp's 16, columns 2t + e and
// 2t + e + 8 of a 16-column step), so one Philox call serves four logits
// and no word is drawn twice or thrown away.  A pair is kept when its
// 32-bit word is >= round(rate * 2^32): the kept share is 1 - rate to
// within 2^-32.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace attn_drop {

// The dropout arguments of a launch (seed nullptr: no dropout).
struct Params {
    const unsigned long long* seed;  // one 64-bit seed in device memory
    uint32_t threshold;              // keep a pair iff its word >= threshold
    float keep_scale;                // 1 / (1 - rate), applied in fp32
    int row0, head0;                 // this call's first batch row and head in the whole batch and model
};

__device__ __forceinline__ uint4 philox(uint4 c, uint2 key) {
#pragma unroll
    for (int i = 0; i < 10; ++i) {
        const uint32_t lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
        const uint32_t lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
        c = make_uint4(hi1 ^ c.y ^ key.x, lo1, hi0 ^ c.w ^ key.y, lo0);
        key.x += 0x9E3779B9u;
        key.y += 0xBB67AE85u;
    }
    return c;
}

__device__ __forceinline__ uint32_t group_of(int pos) {
    return ((uint32_t)pos >> 4) * 8u + ((uint32_t)pos & 7u);
}

__device__ __forceinline__ uint2 load_key(const unsigned long long* seed) {
    const unsigned long long s = *seed;
    return make_uint2((uint32_t)s, (uint32_t)(s >> 32));
}

// The four words of the group holding (q, k), in the order above.
__device__ __forceinline__ uint4 group_words(uint2 key, int row, int head, int q, int k) {
    return philox(make_uint4((uint32_t)row, (uint32_t)head, group_of(q), group_of(k)), key);
}

// Whether the pair (q, k) of (row, head) is kept: one Philox call a pair, for
// the CUDA-core kernels, which hold one query row a thread.
__device__ __forceinline__ bool keep_pair(uint2 key, uint32_t threshold, int row, int head, int q, int k) {
    const uint4 w = group_words(key, row, head, q, k);
    const int i = ((q >> 3) & 1) * 2 + ((k >> 3) & 1);
    const uint32_t x = i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
    return x >= threshold;
}

// The keep bits of one pass of a tensor-core backward kernel (attention_bwd.cu,
// attention_bwd_tf32x3.cu), whose m16n8 accumulators share one layout: bit
// 4 j + e says whether element e of the 8-column tile j of the pass's
// (16 x PASS) accumulators is kept (e = 0, 1 on the own row r_lo, e = 2, 3 on
// r_lo + 8; column 8 j + 2t + (e & 1) from col0).  One Philox call for each
// quadruple above; `own_g` is the group of the thread's own rows, which are
// queries in the dq kernel and keys in the dk/dv kernel (OWN_IS_QUERY), so
// the group words land on other elements in the two.
template <bool OWN_IS_QUERY, int PASS>
__device__ __forceinline__ uint32_t keep_bits(uint2 key, const Params& drop, int row, int head, uint32_t own_g,
                                              int col0, int t) {
    static_assert(PASS % 16 == 0 && PASS <= 32, "whole 16-column steps, 32 bits");
    uint32_t bits = 0;
#pragma unroll
    for (int jj = 0; jj < PASS / 16; ++jj) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const uint32_t col_g = group_of(col0 + 16 * jj + 2 * t + e);
            const uint4 w = philox(OWN_IS_QUERY ? make_uint4((uint32_t)row, (uint32_t)head, own_g, col_g)
                                                : make_uint4((uint32_t)row, (uint32_t)head, col_g, own_g),
                                   key);
            // w.x (q, k), w.y (q, k + 8), w.z (q + 8, k), w.w (q + 8, k + 8); the
            // own row's + 8 is e + 2, the column's + 8 the tile 2 jj + 1
            const int lo = 8 * jj + e, hi = 8 * jj + 4 + e;  // bit of (own, column) and of (own, column + 8)
            bits |= (uint32_t)(w.x >= drop.threshold) << lo;
            bits |= (uint32_t)(w.w >= drop.threshold) << (hi + 2);
            if (OWN_IS_QUERY) {
                bits |= (uint32_t)(w.y >= drop.threshold) << hi;
                bits |= (uint32_t)(w.z >= drop.threshold) << (lo + 2);
            } else {
                bits |= (uint32_t)(w.y >= drop.threshold) << (lo + 2);
                bits |= (uint32_t)(w.z >= drop.threshold) << hi;
            }
        }
    }
    return bits;
}

}  // namespace attn_drop
