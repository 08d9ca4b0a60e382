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
//   attn_dq_kernel   one block per (b*h, 64-row q tile): p = exp(logits - lse),
//                    dp = do.v^T, ds = p * (dp - delta) * scale, dq = ds.k
//   attn_dkv_kernel  one block per (b*h, 64-row k tile): the same p and ds,
//                    transposed: dv = p^T.do, dk = ds^T.q
//
// delta = rowsum(do * o) in float32: the JAX package computes it outside its
// kernels; here it is folded into the prologue of attn_dq_kernel, which
// holds the do rows anyway, and written to a (b, h, s) float32 buffer that
// attn_dkv_kernel reads.  So dq must be launched before dk/dv on the same
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
// its lse is an ordinary number) and for a fully masked one, so the sums
// do not depend on skip_tiles.  In 'bias' mode nothing is skipped.
//
// Rounding: the Pallas kernels cast p and ds to the operand type before the
// second product; these kernels multiply in float32 on the CUDA cores, keep
// p and ds in float32, accumulate in float32 and round once at the store.
//
// Bound on the H100: at the main-path shape (64 rows, 16 heads, s = 256,
// d = 64, bf16) the two kernels together read q, k, v, do twice and o once
// and write dq, dk, dv: ~400 MB, ~0.12 ms of memory time, and seven tile
// products per (q tile, k tile) pair where the forward has two.  As fp32
// FMAs on the CUDA cores (67 TFLOP/s peak) that is arithmetic-bound at a few
// milliseconds; a tensor-core (mma.sync / wgmma) version is later work.
//
// Design: as in the forward, a Hopper block cannot hold the whole opposite
// stripe the Pallas cells keep in VMEM, so both sides are tiled 64 x 64 and
// the opposite side streams through shared memory.  Four threads share one
// row of the block's own side, which stays in registers (q and do rows for
// dq; k and v rows for dk/dv); each takes 16 rows of the streamed tile for
// the logits and d/4 columns of the accumulators.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;  // 4 threads per row of the block's own side

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);
}

__device__ __forceinline__ float masked_logit(float dot, float scale, bool allowed, int bias_mode) {
    float logit = dot * scale;
    if (bias_mode) {
        logit += allowed ? 1.f : 0.f;
    } else if (!allowed) {
        logit = -1e9f;
    }
    return logit;
}

template <int D>
constexpr size_t dq_smem_bytes() {
    return sizeof(float) * (2 * BK * (D + 1) + BQ * (BK + 4)) + sizeof(int) * BK;
}

template <int D>
constexpr size_t dkv_smem_bytes() {
    return sizeof(float) * (2 * BQ * (D + 1) + 2 * BK * (BQ + 4) + 2 * BQ) + sizeof(int) * BQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
attn_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ o, const T* __restrict__ dout,
               const int* __restrict__ q_ids, const int* __restrict__ kv_ids,
               const float* __restrict__ lse, T* __restrict__ dq, float* __restrict__ delta,
               int h, int s, float scale, int bias_mode, int causal, int skip_tiles) {
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

    float acc[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[i] = 0.f;

    const int k_end = (causal && !bias_mode && skip_tiles) ? min(s, q0 + BQ) : s;
    for (int k0 = 0; k0 < k_end; k0 += BK) {
        for (int idx = tid; idx < BK * D; idx += THREADS) {
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

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
attn_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout,
                const int* __restrict__ q_ids, const int* __restrict__ kv_ids,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dk, T* __restrict__ dv,
                int h, int s, float scale, int bias_mode, int causal, int skip_tiles) {
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

    float dk_acc[NC], dv_acc[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) {
        dk_acc[i] = 0.f;
        dv_acc[i] = 0.f;
    }

    const int q_begin = (causal && !bias_mode && skip_tiles) ? blockIdx.y * BK : 0;
    for (int q0 = q_begin; q0 < s; q0 += BQ) {
        for (int idx = tid; idx < BQ * D; idx += THREADS) {
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
                ds = p * (dp - delta_s[j]) * scale;
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

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
                      const int* q_ids, const int* kv_ids, const float* lse, void* dq, float* delta,
                      int b, int h, int s, float scale, int bias_mode, int causal, int skip_tiles,
                      cudaStream_t stream) {
    constexpr size_t smem = dq_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        attn_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid(b * h, (s + BQ - 1) / BQ);
    attn_dq_kernel<T, D><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(o), static_cast<const T*>(dout), q_ids, kv_ids, lse,
        static_cast<T*>(dq), delta, h, s, scale, bias_mode, causal, skip_tiles);
    return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const int* q_ids, const int* kv_ids, const float* lse, const float* delta,
                       void* dk, void* dv, int b, int h, int s, float scale, int bias_mode,
                       int causal, int skip_tiles, cudaStream_t stream) {
    constexpr size_t smem = dkv_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        attn_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid(b * h, (s + BK - 1) / BK);
    attn_dkv_kernel<T, D><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), q_ids, kv_ids, lse, delta,
        static_cast<T*>(dk), static_cast<T*>(dv), h, s, scale, bias_mode, causal, skip_tiles);
    return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; causal and skip_tiles as in the header.
// Both return a cudaError_t (0 on success).

// dq (b, h, s, d) in the input type, and delta (b, h, s) float32 as a by-product.
extern "C" int attn_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                           const void* dout, const int* q_ids, const int* kv_ids,
                           const float* lse, void* dq, float* delta, int b, int h, int s, int d,
                           float scale, int bias_mode, int causal, int skip_tiles, int dtype, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (b * h == 0 || s == 0) return cudaSuccess;
    if (dtype == 1) {
        if (d == 64) return launch_dq<__nv_bfloat16, 64>(q, k, v, o, dout, q_ids, kv_ids, lse, dq, delta, b, h, s, scale, bias_mode, causal, skip_tiles, st);
        if (d == 32) return launch_dq<__nv_bfloat16, 32>(q, k, v, o, dout, q_ids, kv_ids, lse, dq, delta, b, h, s, scale, bias_mode, causal, skip_tiles, st);
    } else if (dtype == 0) {
        if (d == 64) return launch_dq<float, 64>(q, k, v, o, dout, q_ids, kv_ids, lse, dq, delta, b, h, s, scale, bias_mode, causal, skip_tiles, st);
        if (d == 32) return launch_dq<float, 32>(q, k, v, o, dout, q_ids, kv_ids, lse, dq, delta, b, h, s, scale, bias_mode, causal, skip_tiles, st);
    }
    return cudaErrorInvalidValue;
}

// dk, dv (b, h, s, d) in the input type; delta is the buffer attn_bwd_dq filled.
extern "C" int attn_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                            const int* q_ids, const int* kv_ids, const float* lse,
                            const float* delta, void* dk, void* dv, int b, int h, int s, int d,
                            float scale, int bias_mode, int causal, int skip_tiles, int dtype, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (b * h == 0 || s == 0) return cudaSuccess;
    if (dtype == 1) {
        if (d == 64) return launch_dkv<__nv_bfloat16, 64>(q, k, v, dout, q_ids, kv_ids, lse, delta, dk, dv, b, h, s, scale, bias_mode, causal, skip_tiles, st);
        if (d == 32) return launch_dkv<__nv_bfloat16, 32>(q, k, v, dout, q_ids, kv_ids, lse, delta, dk, dv, b, h, s, scale, bias_mode, causal, skip_tiles, st);
    } else if (dtype == 0) {
        if (d == 64) return launch_dkv<float, 64>(q, k, v, dout, q_ids, kv_ids, lse, delta, dk, dv, b, h, s, scale, bias_mode, causal, skip_tiles, st);
        if (d == 32) return launch_dkv<float, 32>(q, k, v, dout, q_ids, kv_ids, lse, delta, dk, dv, b, h, s, scale, bias_mode, causal, skip_tiles, st);
    }
    return cudaErrorInvalidValue;
}
