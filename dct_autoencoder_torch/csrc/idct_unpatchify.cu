// Fused cropped DCT plane -> inverse 2-D DCT -> IPT -> RGB, for Hopper (sm_90a).
//
// Replaces dct_autoencoder_tpu/kernels/idct_unpatchify.py::_kernel (called
// from fused_idct_unpatchify_rgb).  Input (B, 3, ch, cw) float32 cropped DCT
// planes; output (B, 3, H, W) float32 RGB pixels
// X_c = D_H[:ch]^T . Y_c . D_W[:cw], i.e. zero-pad to (H, W), inverse DCT,
// IPT -> LMS, signed power 1/0.43, LMS -> RGB.  The zero pad is folded into
// the truncated DCT matrices, so the padded plane never exists.
//
// Bound on the H100: at 448x448 the products are ~1.08 GFLOP per image
// against ~4.8 MB of planes and pixels, so the products bound it; they keep
// fp32's precision (one TF32 product keeps three digits) through 3xTF32 on
// the tensor cores (tf32x3_gemm3.cuh), bound by 3 x 1.08 GFLOP an image at
// 495 TFLOP/s of dense TF32.  Two launches:
//   1. T_c = D_H[:ch]^T . Y_c into scratch (B, 3, H, ld_s);
//   2. X_c = T_c . D_W[:cw], one block per (image, pixel tile) holding all
//      three channels, so the colour transform and the signed power run in
//      the epilogue and only RGB pixels are written.
// The planes are copied 16 bytes at a time where cw is a multiple of 4 and
// they start at a 16-byte boundary, else 4 bytes at a time.  Tiles stream
// through shared memory, so there is no limit on the area.

#include "tf32x3_gemm3.cuh"

namespace {

using tf32x3::Color3x3;

// IPT -> LMS, signed power 1/gamma, LMS -> RGB of one pixel, written to (B, 3, H, W).
struct StoreRGB {
    float* out;
    int H, W;
    Color3x3 ipt2lms, lms2rgb;
    float inv_gamma;
    __device__ __forceinline__ void store(int z, int m, int n, const float v[3]) const {
        float lms[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
            const float* row = ipt2lms.m + 3 * i;
            lms[i] = tf32x3::signed_pow(row[0] * v[0] + row[1] * v[1] + row[2] * v[2], inv_gamma);
        }
        const long long plane = (long long)H * W;
        float* po = out + z * 3 * plane + (long long)m * W + n;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            const float* row = lms2rgb.m + 3 * j;
            po[j * plane] = row[0] * lms[0] + row[1] * lms[1] + row[2] * lms[2];
        }
    }
};

}  // namespace

// y (B,3,ch,cw); dht_hi/dht_lo (H, ld_dht): D_H[:ch]^T split into TF32
// parts; dw_hi/dw_lo (cw, ld_dw): D_W[:cw] split; scratch (B,3,H,ld_s) with
// ld_s >= cw; out (B,3,H,W); ipt2lms / lms2rgb: host pointers to 9 row-major
// floats each.  The matrices and scratch have strides that are multiples of
// 4 floats and start at 16-byte boundaries, or the call returns
// cudaErrorInvalidValue; y may lie anyhow.
extern "C" int idct_unpatchify_fwd(const float* y, const float* dht_hi, const float* dht_lo, int ld_dht,
                                   const float* dw_hi, const float* dw_lo, int ld_dw, float* scratch,
                                   int ld_s, float* out, int B, int ch, int cw, int H, int W,
                                   const float* ipt2lms, const float* lms2rgb, float inv_gamma,
                                   void* stream) {
    using tf32x3::aligned16;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (ch > H || cw > W) return cudaErrorInvalidValue;
    if (ld_s < cw || ld_s % 4 || ld_dht < ch || ld_dht % 4 || ld_dw < W || ld_dw % 4) return cudaErrorInvalidValue;
    for (const void* q : {(const void*)dht_hi, (const void*)dht_lo, (const void*)dw_hi, (const void*)dw_lo,
                          (const void*)scratch})
        if (!aligned16(q)) return cudaErrorInvalidValue;

    const long long y_plane = (long long)ch * cw, t_plane = (long long)H * ld_s;
    tf32x3::Operand dht{dht_hi, dht_lo, ld_dht, 0, 0};
    tf32x3::Operand planes{y, nullptr, cw, y_plane, 3 * y_plane};
    tf32x3::StorePlane to_scratch{scratch, ld_s, t_plane, 3 * t_plane};
    const bool vec = cw % 4 == 0 && aligned16(y);
    cudaError_t err = vec ? tf32x3::launch<true, true>(dht, planes, H, cw, ch, B, to_scratch, st)
                          : tf32x3::launch<true, false>(dht, planes, H, cw, ch, B, to_scratch, st);
    if (err != cudaSuccess) return err;

    tf32x3::Operand t{scratch, nullptr, ld_s, t_plane, 3 * t_plane};
    tf32x3::Operand dw{dw_hi, dw_lo, ld_dw, 0, 0};
    StoreRGB to_rgb{out, H, W, tf32x3::color(ipt2lms), tf32x3::color(lms2rgb), inv_gamma};
    return tf32x3::launch<false, true>(t, dw, H, W, cw, B, to_rgb, st);
}

// Registers, spill bytes, blocks an SM and shared bytes a block of product
// `pass` (1 or 2) at its 64 x 64 tile with 16-byte copies.
extern "C" int idct_unpatchify_kernel_info(int pass, int* out) {
    if (pass != 1 && pass != 2) return cudaErrorInvalidValue;
    return pass == 1 ? tf32x3::info<true, true, tf32x3::StorePlane>(out)
                     : tf32x3::info<false, true, StoreRGB>(out);
}
