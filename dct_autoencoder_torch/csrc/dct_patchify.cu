// Fused RGB -> IPT -> 2-D DCT -> crop -> patchify, for Hopper (sm_90a).
//
// Replaces dct_autoencoder_tpu/kernels/dct_patchify.py::_kernel (called from
// fused_ipt_dct_patchify).  Input (B, 3, H, W) float32 RGB in [0, 1]; output
// (B, ph*pw, 3, p*p) float32 DCT patch tokens of the cropped plane
// Y_c = D_H[:ch] . IPT_c . D_W[:cw]^T.
//
// Bound on the H100: ~1.08 GFLOP per 448x448 image against ~4.8 MB of pixels
// and tokens, so the products bound it.  One TF32 product would cut the DC
// coefficient (~sqrt(H*W)/2) to three digits, so the products keep fp32's
// precision through 3xTF32.  Three launches:
//   0. RGB -> LMS, signed power 0.43, LMS -> IPT, once per pixel, into IPT
//      planes (B, 3, H, ld) with ld = W rounded up to a multiple of 4.  (The
//      products' loads are cp.async copies, which cannot transform what they
//      carry; done in the load instead, the transform ran once per 64-row
//      output tile, 7 times a pixel at 448.)
//   1. A_c = D_H[:ch] . IPT_c into scratch (B, 3, ch, ld);
//   2. Y_c = A_c . D_W[:cw]^T with the patch layout fused into the store.
// Both products run on the tensor cores in 3xTF32 (tf32x3_gemm3.cuh): the
// bound is 3 x 1.08 GFLOP an image at 495 TFLOP/s of dense TF32.  Tiles
// stream through shared memory, so there is no limit on the image area.

#include "tf32x3_gemm3.cuh"

namespace {

using tf32x3::Color3x3;

// The patch layout: Y_c[m, n] -> out[z, (m/p)*pw + n/p, c, (m%p)*p + n%p].
struct StorePatch {
    float* out;
    int p, pw;
    long long ntok;
    __device__ __forceinline__ void store(int z, int m, int n, const float v[3]) const {
        const int pp = p * p;
        const int token = (m / p) * pw + (n / p);
        const int coeff = (m % p) * p + (n % p);
        float* po = out + (((long long)z * ntok + token) * 3) * pp + coeff;
        po[0] = v[0];
        po[pp] = v[1];
        po[2 * pp] = v[2];
    }
};

__global__ void rgb_to_ipt_kernel(const float* x, float* ipt, int H, int W, int ld, long long pixels,
                                  Color3x3 rgb2lms, Color3x3 lms2ipt, float gamma) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= pixels) return;
    const long long hw = (long long)H * W;
    const long long z = i / hw, rem = i % hw;
    const int h = (int)(rem / W), w = (int)(rem % W);
    const float* px = x + z * 3 * hw + rem;
    const float r = px[0], g = px[hw], b = px[2 * hw];
    float lms[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const float* row = rgb2lms.m + 3 * k;
        lms[k] = tf32x3::signed_pow(row[0] * r + row[1] * g + row[2] * b, gamma);
    }
    const long long plane = (long long)H * ld;
    float* po = ipt + z * 3 * plane + (long long)h * ld + w;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const float* row = lms2ipt.m + 3 * k;
        po[k * plane] = row[0] * lms[0] + row[1] * lms[1] + row[2] * lms[2];
    }
}

}  // namespace

// x (B,3,H,W); dh_hi/dh_lo (ch, ld_dh): D_H[:ch] split into TF32 parts;
// dwt_hi/dwt_lo (W, ld_dwt): D_W[:cw]^T split; ipt (B,3,H,ld) and scratch
// (B,3,ch,ld) with ld >= W; out (B,ph*pw,3,p*p); rgb2lms / lms2ipt: host
// pointers to 9 row-major floats each.  Every stride is a multiple of 4
// floats and every matrix but x and out starts at a 16-byte boundary, or the
// call returns cudaErrorInvalidValue.
extern "C" int dct_patchify_fwd(const float* x, const float* dh_hi, const float* dh_lo, int ld_dh,
                                const float* dwt_hi, const float* dwt_lo, int ld_dwt, float* ipt,
                                float* scratch, int ld, float* out, int B, int H, int W, int ch, int cw,
                                int p, const float* rgb2lms, const float* lms2ipt, float gamma,
                                void* stream) {
    using tf32x3::aligned16;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (p <= 0 || ch % p != 0 || cw % p != 0 || ch > H || cw > W) return cudaErrorInvalidValue;
    if (ld < W || ld % 4 || ld_dh < H || ld_dh % 4 || ld_dwt < cw || ld_dwt % 4) return cudaErrorInvalidValue;
    for (const void* q : {(const void*)dh_hi, (const void*)dh_lo, (const void*)dwt_hi, (const void*)dwt_lo,
                          (const void*)ipt, (const void*)scratch})
        if (!aligned16(q)) return cudaErrorInvalidValue;
    if (B == 0) return cudaSuccess;
    const long long pixels = (long long)B * H * W;
    rgb_to_ipt_kernel<<<(unsigned)((pixels + 255) / 256), 256, 0, st>>>(
        x, ipt, H, W, ld, pixels, tf32x3::color(rgb2lms), tf32x3::color(lms2ipt), gamma);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;

    const long long ipt_plane = (long long)H * ld, a_plane = (long long)ch * ld;
    tf32x3::Operand dh{dh_hi, dh_lo, ld_dh, 0, 0};
    tf32x3::Operand planes{ipt, nullptr, ld, ipt_plane, 3 * ipt_plane};
    tf32x3::StorePlane to_scratch{scratch, ld, a_plane, 3 * a_plane};
    err = tf32x3::launch<true, true>(dh, planes, ch, W, H, B, to_scratch, st);
    if (err != cudaSuccess) return err;

    tf32x3::Operand a{scratch, nullptr, ld, a_plane, 3 * a_plane};
    tf32x3::Operand dwt{dwt_hi, dwt_lo, ld_dwt, 0, 0};
    StorePatch to_tokens{out, p, cw / p, (long long)(ch / p) * (cw / p)};
    return tf32x3::launch<false, true>(a, dwt, ch, cw, W, B, to_tokens, st);
}

// Registers, spill bytes, blocks an SM and shared bytes a block of product
// `pass` (1 or 2) at its 64 x 64 tile.
extern "C" int dct_patchify_kernel_info(int pass, int* out) {
    if (pass != 1 && pass != 2) return cudaErrorInvalidValue;
    return pass == 1 ? tf32x3::info<true, true, tf32x3::StorePlane>(out)
                     : tf32x3::info<false, true, StorePatch>(out);
}
