// Building blocks of the float32 attention kernels on Hopper's tensor cores in
// 3xTF32 (sm_90a): attention_fwd_tf32x3.cu builds the forward from them,
// attention_bwd_tf32x3.cu the dq and dk/dv kernels.  The arithmetic and the
// fragment layouts are argued in attention_bwd_tf32x3.cu's header; in short:
//   * every product runs on mma.sync.m16n8k8 in TF32 as lo*hi + hi*lo + hi*hi
//     of TF32 parts (tf32x3::mma3), each 8-deep slice summed on the tensor
//     cores from zero and added to an fp32 accumulator on the CUDA cores,
//     because the tensor cores round their sums toward zero;
//   * tiles lie in shared memory as fp32 rows of D + 4 floats (16-byte chunks
//     for cp.async; D + 4 = 4 mod 32 banks, so that each fragment read hits
//     32 banks), and their fragments are split as they are read;
//   * an accumulator fragment (c0, c1, c2, c3) is the A fragment
//     (c0, c2, c1, c3) of a product whose depth runs over its 8 columns in
//     the permuted order (slot t is column 2t, slot t + 4 column 2t + 1), and
//     the B fragment of such a product reads rows 2t and 2t + 1 of the tile.
//
// Rows in device memory are `ld` floats apart (the caller's head dim, or the
// instantiation's where the wrapper padded); the loads zero-fill the columns
// from ld to D, as they zero-fill rows past s, so a kernel of instantiation D
// reads and writes rows of any ld <= D that is a multiple of 4 in place.
#pragma once

#include <stdint.h>

#include "attn_mma.cuh"
#include "tf32x3_gemm3.cuh"

// No unnamed namespace inside: the kernel sources take these names with a
// using-directive, and nvcc's host stubs name every unnamed namespace of a
// file alike, so a nested one would make the kernels' names ambiguous there.
// (Nothing here has a static local, the reason tf32x3_gemm3.cuh has one.)
namespace attn_tf32x3 {

using attn_mma::TILE;

// floats a row of a tile in shared memory, and a tile (variables: device code reads them too)
template <int D>
constexpr int LD = D + 4;
template <int D>
constexpr int TILE_FLOATS = TILE * LD<D>;

// x = hi + lo in TF32 parts, on the FP32 pipe: hi is x rounded to 11
// significant bits by Veltkamp's split (c = (2^13 + 1) x, hi = c - (c - x);
// the _rn intrinsics keep the compiler from contracting it into an FMA),
// lo = x - hi exactly, its low 13 bits cleared (truncated to TF32).  One
// integer operation where tf32x3::split takes four (the integer pipe runs
// at half the FP32 pipe's rate on Hopper); hi + lo is x to within 2^-22.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
    const float c = __fmul_rn(x, 8193.f);
    const float h = __fsub_rn(c, __fsub_rn(c, x));
    hi = __float_as_uint(h);
    lo = __float_as_uint(__fsub_rn(x, h)) & 0xffffe000u;
}

// Blocks an SM the register allocation aims at: shared memory allows one at
// D = 128; two below, at most 255 registers a thread (at D = 32 a cap of 168
// for three blocks spilled 16-40 bytes in the backward, and dk/dv took 9 %
// longer at the sweep's shape on an H100).
template <int D>
constexpr int min_blocks() {
    return D >= 128 ? 1 : 2;
}

// Rows row0 .. row0 + TILE - 1 of an (s, ld) stripe into a tile; rows past s
// and columns past ld are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(float* tile, const float* stripe, int row0, int s, int ld, int tid) {
    tf32x3::load_tile<TILE, D, LD<D>, true>(tile, stripe + (size_t)row0 * ld, ld, s - row0, ld, tid);
}

// Split A fragment (16 x 8) of rows r0 .. r0 + 15 and head-dim columns
// 8 kk .. 8 kk + 7 of a tile: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4).
template <int D>
__device__ __forceinline__ void a_frag(uint32_t (&hi)[4], uint32_t (&lo)[4], const float* tile, int r0, int kk,
                                       int g, int t) {
    const float* p = tile + (r0 + g) * LD<D> + 8 * kk + t;
    split(p[0], hi[0], lo[0]);
    split(p[8 * LD<D>], hi[1], lo[1]);
    split(p[4], hi[2], lo[2]);
    split(p[8 * LD<D> + 4], hi[3], lo[3]);
}

// Split B fragment (8 x 8) of a product over the head dim whose columns are
// the tile's rows n0 .. n0 + 7: (k = t, n = g), (k = t + 4, n = g).
template <int D>
__device__ __forceinline__ void b_frag_rows(uint32_t (&hi)[2], uint32_t (&lo)[2], const float* tile, int n0, int kk,
                                            int g, int t) {
    const float* p = tile + (n0 + g) * LD<D> + 8 * kk + t;
    split(p[0], hi[0], lo[0]);
    split(p[4], hi[1], lo[1]);
}

// Split B fragment of a product whose depth runs over the tile's rows
// k0 .. k0 + 7 in the permuted order of a_from_c (slot t is row 2t, slot
// t + 4 row 2t + 1), for the head-dim columns n0 .. n0 + 7.
template <int D>
__device__ __forceinline__ void b_frag_cols(uint32_t (&hi)[2], uint32_t (&lo)[2], const float* tile, int k0, int n0,
                                            int g, int t) {
    const float* p = tile + (k0 + 2 * t) * LD<D> + n0 + g;
    split(p[0], hi[0], lo[0]);
    split(p[LD<D>], hi[1], lo[1]);
}

// The accumulator fragment of an 8-column tile ((g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1)), split, as the A fragment of an 8-deep step
// over those columns in the permuted order.
__device__ __forceinline__ void a_from_c(uint32_t (&hi)[4], uint32_t (&lo)[4], const float (&c)[4]) {
    split(c[0], hi[0], lo[0]);
    split(c[2], hi[1], lo[1]);
    split(c[1], hi[2], lo[2]);
    split(c[3], hi[3], lo[3]);
}

// acc += the 8-deep slice's a.b, summed on the tensor cores from zero
__device__ __forceinline__ void add_slice(float (&acc)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                          const uint32_t (&bh)[2], const uint32_t (&bl)[2]) {
    float d[4];
    tf32x3::mma3<true>(d, ah, al, bh, bl);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] += d[e];
}

}  // namespace attn_tf32x3
