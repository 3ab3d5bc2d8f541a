// Masked co-attention pooling forward for Hopper (sm_90a).
//
// Replaces the TPU kernel body vlsa_tpu/ops/coattn.py::_coattn_fwd_body and
// its four launch variants (_coattn_fwd_kernel, _coattn_fwd_kernel_i,
// _coattn_fwd_kernel_q8, _coattn_fwd_kernel_q8i).  For each bag b and query p:
//
//     logits[p,n] = scale * inv[n] * (q[p] . x[n])      (-1e30 where masked)
//     out[b,p]    = sum_n softmax_n(logits)[p,n] * s[n] * x[n]
//
// with inv[n] = rsqrt(max(|x[n]|^2, 1e-24)) computed here or read from the
// host, and s[n] the per-patch int8 dequant scale (1 for float storage).
// The softmax of int8 rows uses the raw int8 values: the normalised logits do
// not depend on the per-patch scale, which only weights the PV sum.
//
// What bounds it on an H100: it reads B*N*C*itemsize bytes of x once and does
// 4*P*C floating-point operations per element (the logit dot and the PV
// product), about 24 FLOP/byte for bf16 at P=12 -- far below the tensor-core
// ridge, so the byte stream is the floor; on CUDA cores in f32 the arithmetic
// sits close to that floor too.  This first version runs on CUDA cores in
// f32 and is written to be right, not fast (PERF.md holds its times beside
// that bound): tensor-core mma with P padded to 16, TMA staging and int8 MMA
// are later work.
//
// Design.  The TPU grid walks N tile after tile and carries (m, l, acc) in
// VMEM scratch.  Hopper runs blocks in parallel with nothing carried between
// them, so the patch axis is split across blocks instead: block (s, b) runs
// an online softmax over its chunk of bag b and writes its partial (m, l,
// acc) to a workspace; a second small kernel merges the partials of each bag.
// The merge is deterministic and uses no atomics.  Any N is taken: the ragged
// edge of the last tile is masked here, so no bag needs a 128-aligned length.
//
// Per tile of 32 patches, with 8 warps:
//   A. each warp takes 4 patches; its lanes read the row 4 values at a time,
//      form the P dot products and the sum of squares, and reduce them across
//      the warp; the tile is staged in shared memory in its storage type.
//   B. warp w updates the online softmax of queries w and w+8, one lane per
//      patch of the tile.
//   C. each thread owns channels c = tid, tid+256, ...: it folds the tile's
//      PV product into acc[p][c] in shared memory, rescaled by the softmax
//      correction.
#include "coattn_common.cuh"

using namespace coattn;

namespace {

// Shared-memory bytes of one partial block (must match the carve-up below).
__host__ __device__ inline size_t partial_smem_bytes(int P, int C, int itemsize) {
    return sizeof(float) * (2 * (size_t)P * C          // q, acc
                            + 2 * kMaxP * kTile        // logits, weights
                            + 3 * kMaxP                // m, l, correction
                            + 2 * kTile)               // pv scale, valid flag
           + (size_t)kTile * C * itemsize;             // the x tile
}

template <typename T, bool HOST_INV, bool HAS_SCALE>
__global__ void __launch_bounds__(kThreads)
coattn_fwd_partial(const float* __restrict__ q, const T* __restrict__ x,
                   const float* __restrict__ x_scale,
                   const float* __restrict__ x_inv,
                   const uint8_t* __restrict__ mask, float scale,
                   int N, int C, int P, int chunk, int S,
                   float* __restrict__ ws_m, float* __restrict__ ws_l,
                   float* __restrict__ ws_acc) {
    extern __shared__ float4 smem_f4[];
    float* smem = reinterpret_cast<float*>(smem_f4);
    float* q_s = smem;                          // [P, C]
    float* acc_s = q_s + P * C;                 // [P, C]
    float* logit_s = acc_s + P * C;             // [kMaxP, kTile]
    float* w_s = logit_s + kMaxP * kTile;       // [kMaxP, kTile]
    float* m_s = w_s + kMaxP * kTile;           // [kMaxP]
    float* l_s = m_s + kMaxP;                   // [kMaxP]
    float* corr_s = l_s + kMaxP;                // [kMaxP]
    float* pvs_s = corr_s + kMaxP;              // [kTile] PV scale of each patch
    float* valid_s = pvs_s + kTile;             // [kTile] 1 for a valid patch
    T* x_s = reinterpret_cast<T*>(valid_s + kTile);  // [kTile, C]

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int split = blockIdx.x;
    const int b = blockIdx.y;
    const int n_begin = split * chunk;
    const int n_end = min(N, n_begin + chunk);

    const T* xb = x + (size_t)b * N * C;
    const uint8_t* mb = mask + (size_t)b * N;

    for (int i = tid; i < P * C; i += kThreads) {
        q_s[i] = q[i];
        acc_s[i] = 0.f;
    }
    if (tid < kMaxP) {
        m_s[tid] = kNegInf;
        l_s[tid] = 0.f;
    }
    __syncthreads();

    const int c4 = C / 4;  // groups of four channels
    for (int t0 = n_begin; t0 < n_end; t0 += kTile) {
        // ---- A: logits of the tile, one warp per patch ----
        for (int j = warp; j < kTile; j += kWarps) {
            const int n = t0 + j;
            const bool in_range = n < n_end;
            float dot[kMaxP];
#pragma unroll
            for (int p = 0; p < kMaxP; ++p) dot[p] = 0.f;
            float sq = 0.f;
            typename Raw4<T>::type* xrow =
                reinterpret_cast<typename Raw4<T>::type*>(x_s + (size_t)j * C);
            if (in_range) {
                const T* src = xb + (size_t)n * C;
                for (int g = lane; g < c4; g += 32) {
                    const typename Raw4<T>::type raw =
                        *reinterpret_cast<const typename Raw4<T>::type*>(src + 4 * g);
                    xrow[g] = raw;
                    float v[4];
                    load4(reinterpret_cast<const T*>(&raw), v);
                    sq += v[0] * v[0] + v[1] * v[1] + v[2] * v[2] + v[3] * v[3];
#pragma unroll
                    for (int p = 0; p < kMaxP; ++p) {
                        if (p < P) {
                            const float4 qv = *reinterpret_cast<const float4*>(q_s + p * C + 4 * g);
                            dot[p] += qv.x * v[0] + qv.y * v[1] + qv.z * v[2] + qv.w * v[3];
                        }
                    }
                }
            } else {
                for (int g = lane; g < c4; g += 32) {
                    xrow[g] = typename Raw4<T>::type{};
                }
            }
#pragma unroll
            for (int p = 0; p < kMaxP; ++p) {
                if (p < P) dot[p] = warp_sum(dot[p]);
            }
            if (!HOST_INV) sq = warp_sum(sq);
            if (lane == 0) {
                const bool valid = in_range && mb[n] != 0;
                float inv = 0.f;
                if (valid) {
                    inv = HOST_INV ? x_inv[(size_t)b * N + n] : rsqrtf(fmaxf(sq, 1e-24f));
                }
#pragma unroll
                for (int p = 0; p < kMaxP; ++p) {
                    if (p < P) logit_s[p * kTile + j] = valid ? scale * dot[p] * inv : kNegInf;
                }
                valid_s[j] = valid ? 1.f : 0.f;
                pvs_s[j] = (valid && HAS_SCALE) ? x_scale[(size_t)b * N + n] : 1.f;
            }
        }
        __syncthreads();

        // ---- B: online softmax update, one warp per query, one lane per patch ----
        for (int p = warp; p < P; p += kWarps) {
            const float lg = logit_s[p * kTile + lane];
            const bool valid = valid_s[lane] != 0.f;
            const float m_prev = m_s[p];
            const float m_new = fmaxf(m_prev, warp_max(lg));
            const float pw = valid ? expf(lg - m_new) : 0.f;
            const float psum = warp_sum(pw);
            w_s[p * kTile + lane] = pw * pvs_s[lane];
            if (lane == 0) {
                const float corr = expf(m_prev - m_new);
                corr_s[p] = corr;
                l_s[p] = l_s[p] * corr + psum;
                m_s[p] = m_new;
            }
        }
        __syncthreads();

        // ---- C: acc[p][c] = acc[p][c] * corr[p] + sum_j w[p][j] * x[j][c] ----
        for (int c = tid; c < C; c += kThreads) {
            float xv[kTile];
#pragma unroll
            for (int j = 0; j < kTile; ++j) xv[j] = to_float(x_s[(size_t)j * C + c]);
            for (int p = 0; p < P; ++p) {
                const float4* wp = reinterpret_cast<const float4*>(w_s + p * kTile);
                float s = 0.f;
#pragma unroll
                for (int j4 = 0; j4 < kTile / 4; ++j4) {
                    const float4 w = wp[j4];
                    s += w.x * xv[4 * j4] + w.y * xv[4 * j4 + 1]
                       + w.z * xv[4 * j4 + 2] + w.w * xv[4 * j4 + 3];
                }
                acc_s[p * C + c] = acc_s[p * C + c] * corr_s[p] + s;
            }
        }
        __syncthreads();
    }

    // ---- partial (m, l, acc) of this chunk ----
    const size_t part = (size_t)b * S + split;
    if (tid < P) {
        ws_m[part * P + tid] = m_s[tid];
        ws_l[part * P + tid] = l_s[tid];
    }
    float* acc_out = ws_acc + part * P * C;
    for (int i = tid; i < P * C; i += kThreads) acc_out[i] = acc_s[i];
}

// Merge the S partials of each bag: m = max_s m_s, l = sum_s l_s e^(m_s - m),
// out = sum_s acc_s e^(m_s - m) / max(l, 1e-30).  Grid (P, B).
__global__ void __launch_bounds__(kThreads)
coattn_fwd_merge(const float* __restrict__ ws_m, const float* __restrict__ ws_l,
                 const float* __restrict__ ws_acc, int C, int P, int S,
                 float* __restrict__ out, float* __restrict__ m_out,
                 float* __restrict__ l_out) {
    extern __shared__ float4 smem_f4[];
    float* e_s = reinterpret_cast<float*>(smem_f4);  // [S]
    __shared__ float red_s[kWarps];
    __shared__ float m_all, l_all;

    const int p = blockIdx.x;
    const int b = blockIdx.y;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const float* mb = ws_m + (size_t)b * S * P;
    const float* lb = ws_l + (size_t)b * S * P;

    float mx = kNegInf;
    for (int s = tid; s < S; s += kThreads) mx = fmaxf(mx, mb[s * P + p]);
    mx = warp_max(mx);
    if (lane == 0) red_s[warp] = mx;
    __syncthreads();
    if (tid == 0) {
        float v = red_s[0];
        for (int w = 1; w < kWarps; ++w) v = fmaxf(v, red_s[w]);
        m_all = v;
    }
    __syncthreads();
    const float m = m_all;

    float ls = 0.f;
    for (int s = tid; s < S; s += kThreads) {
        const float e = expf(mb[s * P + p] - m);
        e_s[s] = e;
        ls += lb[s * P + p] * e;
    }
    ls = warp_sum(ls);
    __syncthreads();  // red_s reuse
    if (lane == 0) red_s[warp] = ls;
    __syncthreads();
    if (tid == 0) {
        float v = 0.f;
        for (int w = 0; w < kWarps; ++w) v += red_s[w];
        l_all = fmaxf(v, 1e-30f);
        m_out[(size_t)b * P + p] = m;
        l_out[(size_t)b * P + p] = l_all;
    }
    __syncthreads();
    const float inv_l = 1.f / l_all;

    const float* ab = ws_acc + (size_t)b * S * P * C + (size_t)p * C;
    float* ob = out + ((size_t)b * P + p) * C;
    for (int c = tid; c < C; c += kThreads) {
        float v = 0.f;
        for (int s = 0; s < S; ++s) v += ab[(size_t)s * P * C + c] * e_s[s];
        ob[c] = v * inv_l;
    }
}

template <typename T, bool HOST_INV, bool HAS_SCALE>
cudaError_t launch_partial(const float* q, const void* x, const float* x_scale,
                           const float* x_inv, const uint8_t* mask, float scale,
                           int B, int N, int C, int P, int chunk, int S,
                           float* ws_m, float* ws_l, float* ws_acc,
                           cudaStream_t stream) {
    auto kernel = coattn_fwd_partial<T, HOST_INV, HAS_SCALE>;
    const size_t smem = partial_smem_bytes(P, C, sizeof(T));
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(S, B), kThreads, smem, stream>>>(
        q, static_cast<const T*>(x), x_scale, x_inv, mask, scale, N, C, P,
        chunk, S, ws_m, ws_l, ws_acc);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_inv(bool host_inv, bool has_scale, const float* q,
                         const void* x, const float* x_scale, const float* x_inv,
                         const uint8_t* mask, float scale, int B, int N, int C,
                         int P, int chunk, int S, float* ws_m, float* ws_l,
                         float* ws_acc, cudaStream_t stream) {
#define COATTN_LAUNCH(HI, HS)                                                  \
    return launch_partial<T, HI, HS>(q, x, x_scale, x_inv, mask, scale, B, N, \
                                     C, P, chunk, S, ws_m, ws_l, ws_acc,      \
                                     stream)
    if (host_inv) {
        if (has_scale) { COATTN_LAUNCH(true, true); }
        COATTN_LAUNCH(true, false);
    }
    if (has_scale) { COATTN_LAUNCH(false, true); }
    COATTN_LAUNCH(false, false);
#undef COATTN_LAUNCH
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one partial block needs (0 = too large).
size_t coattn_fwd_smem_bytes(int P, int C, int storage) {
    return partial_smem_bytes(P, C, storage_itemsize(storage));
}

// q [P, C] f32; x [B, N, C] (storage: 0 f32, 1 bf16, 2 int8); x_scale and
// x_inv [B, N] f32 or null; mask [B, N] bool.  Workspace: ws_m, ws_l
// [B, S, P] and ws_acc [B, S, P, C] f32.  Outputs: out [B, P, C], m and l
// [B, P] f32.  All on CUDA device `device`; the kernels go to `stream`.
// Returns the launch's cudaError_t (0 on success).
int coattn_fwd(const void* q, const void* x, const void* x_scale,
               const void* x_inv, const void* mask, float scale, int B, int N,
               int C, int P, int chunk, int S, int storage, int device,
               void* ws_m, void* ws_l, void* ws_acc, void* out, void* m_out,
               void* l_out, void* stream) {
    if (P < 1 || P > kMaxP || C % 8 != 0 || S < 1 || B < 1) {
        return (int)cudaErrorInvalidValue;
    }
    cudaError_t dev_err = cudaSetDevice(device);
    if (dev_err != cudaSuccess) return (int)dev_err;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* qf = static_cast<const float*>(q);
    const float* xs = static_cast<const float*>(x_scale);
    const float* xi = static_cast<const float*>(x_inv);
    const uint8_t* mk = static_cast<const uint8_t*>(mask);
    float* wm = static_cast<float*>(ws_m);
    float* wl = static_cast<float*>(ws_l);
    float* wa = static_cast<float*>(ws_acc);
    const bool host_inv = xi != nullptr;
    const bool has_scale = xs != nullptr;
    cudaError_t err;
    if (storage == kF32) {
        err = dispatch_inv<float>(host_inv, has_scale, qf, x, xs, xi, mk, scale,
                                  B, N, C, P, chunk, S, wm, wl, wa, st);
    } else if (storage == kBF16) {
        err = dispatch_inv<__nv_bfloat16>(host_inv, has_scale, qf, x, xs, xi, mk,
                                          scale, B, N, C, P, chunk, S, wm, wl,
                                          wa, st);
    } else if (storage == kI8) {
        err = dispatch_inv<int8_t>(host_inv, has_scale, qf, x, xs, xi, mk, scale,
                                   B, N, C, P, chunk, S, wm, wl, wa, st);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return (int)err;
    const size_t merge_smem = sizeof(float) * (size_t)S;
    if (merge_smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    coattn_fwd_merge<<<dim3(P, B), kThreads, merge_smem, st>>>(
        wm, wl, wa, C, P, S, static_cast<float*>(out),
        static_cast<float*>(m_out), static_cast<float*>(l_out));
    return (int)cudaGetLastError();
}

}  // extern "C"
