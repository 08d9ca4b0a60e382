// Packed block-diagonal attention, forward, for Hopper (sm_90a).
//
// Replaces dct_autoencoder_tpu/kernels/attention.py::_attn_fwd_kernel
// (called from _flash_attention_fwd_impl).  Same contract: q, k, v are
// (b, h, s, d); per-token segment ids arrive as q_ids / kv_ids (b, s) with
// padded queries at -2 and padded keys at -1, so the (s, s) mask is derived
// in the kernel and never stored.  mode 'block' sets a disallowed logit to
// -1e9; mode 'bias' adds +1 to an allowed logit.  Outputs o (b, h, s, d) in
// the input type and the row log-sum-exp lse (b, h, s) in float32.
//
// Bound on the H100: at the main-path shape (64 rows, 16 heads, s=256, d=64)
// the call moves ~134 MB of q/k/v/o and does ~17 GFLOP of products, so the
// tensor-core bound is memory (~40 us); this first version does its products
// as fp32 FMAs on the CUDA cores (67 TFLOP/s peak), which makes it
// arithmetic-bound at a few hundred microseconds.  A wgmma/TMA version is
// later work.
//
// Design: the Pallas kernel keeps the whole k/v stripe in VMEM; a Hopper
// block cannot, so each block takes one (b*h, 64-row q tile) and streams
// 64-row k/v tiles through shared memory with an online softmax in fp32.
// Four threads share one query row (16 keys and d/4 output columns each)
// and combine their row max and row sum with warp shuffles.  The running
// max starts at -5e8, which reproduces the reference clamp
// m = max(m, -5e8) exactly: a row whose keys are all masked keeps m = -5e8,
// gets p = exp(-1e9 + 5e8) = 0 everywhere, and ends with o = 0 and
// lse = -5e8 + log(1e-9), as in the reference; a fully masked tile met
// before a row's valid keys contributes nothing and is rescaled away.
// Keys past the end of a ragged last tile are excluded (p = 0).
//
// causal != 0 (dct_autoencoder_tpu/kernels/attention.py::_causal_allowed)
// ANDs k_pos <= q_pos into `allowed`; positions are the row indices the
// kernel already holds, so there is no new operand.  In 'bias' mode that
// only decides who gets the +1: future keys still take part in the softmax,
// as in the Pallas kernel.  In 'block' mode with skip_tiles != 0 a block
// stops at its own diagonal tile: every later tile would be all -1e9, and
// such a tile leaves m, l and acc bit for bit as they were (alpha =
// exp(0) = 1, p = exp(-1e9 - m) = 0 for every m >= -5e8), so o and lse do
// not depend on skip_tiles.  Blocks take their q tiles from the last to the
// first, so that the longest causal blocks are scheduled first.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;  // 4 threads per query row

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

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const int* __restrict__ q_ids, const int* __restrict__ kv_ids,
                T* __restrict__ o, float* __restrict__ lse,
                int h, int s, float scale, int bias_mode, int causal, int skip_tiles) {
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
            const float p = expf(sv[i] - m_new);
            psum += p;
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
        const float inv = 1.f / denom;
        T* ob = o + base + (size_t)qi * D;
#pragma unroll
        for (int i = 0; i < NC; ++i) ob[sub + 4 * i] = from_f<T>(acc[i] * inv);
        if (sub == 0) lse[(size_t)bh * s + qi] = m + logf(denom);
    }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* q_ids,
                   const int* kv_ids, void* o, float* lse, int b, int h, int s,
                   float scale, int bias_mode, int causal, int skip_tiles, cudaStream_t stream) {
    constexpr size_t smem = smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        attn_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid(b * h, (s + BQ - 1) / BQ);
    attn_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        q_ids, kv_ids, static_cast<T*>(o), lse, h, s, scale, bias_mode, causal, skip_tiles);
    return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; causal and skip_tiles as in the header.
// Returns a cudaError_t (0 on success).
extern "C" int attn_fwd(const void* q, const void* k, const void* v, const int* q_ids,
                        const int* kv_ids, void* o, float* lse, int b, int h, int s, int d,
                        float scale, int bias_mode, int causal, int skip_tiles, int dtype,
                        void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (b * h == 0 || s == 0) return cudaSuccess;
    if (dtype == 1) {
        if (d == 64) return launch<__nv_bfloat16, 64>(q, k, v, q_ids, kv_ids, o, lse, b, h, s, scale, bias_mode, causal, skip_tiles, st);
        if (d == 32) return launch<__nv_bfloat16, 32>(q, k, v, q_ids, kv_ids, o, lse, b, h, s, scale, bias_mode, causal, skip_tiles, st);
    } else if (dtype == 0) {
        if (d == 64) return launch<float, 64>(q, k, v, q_ids, kv_ids, o, lse, b, h, s, scale, bias_mode, causal, skip_tiles, st);
        if (d == 32) return launch<float, 32>(q, k, v, q_ids, kv_ids, o, lse, b, h, s, scale, bias_mode, causal, skip_tiles, st);
    }
    return cudaErrorInvalidValue;
}
