// Masked co-attention pooling, dQ-only backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel body vlsa_tpu/ops/coattn.py::_coattn_bwd_dq_body
// and its four launch variants (_coattn_bwd_dq_kernel, _coattn_bwd_dq_kernel_q8,
// _coattn_bwd_dq_kernel_q8i, _coattn_bwd_dq_kernel_i).  The patch features x
// are constants (VLFAN without a feature projecter), so only the queries get
// a gradient.  From the forward's stats (m, l) and its output `out`, for each
// bag b, query p and valid patch n:
//
//     a[p,n]  = exp(scale * inv[n] * (q[p] . x[n]) - m[p]) / l[p]
//     dA[p,n] = s[n] * (g[p] . x[n])         (s = int8 dequant scale, else 1)
//     dl[p,n] = a[p,n] * (dA[p,n] - g[p] . out[p]) * inv[n]
//     dq[p]   = scale * sum_b sum_n dl[p,n] * x[n]
//
// on the stored values (raw int8 for int8: the normalised logit and the dq
// contraction inv[n] * x[n] do not depend on the per-patch scale).  Masked
// patches and the ragged edge get a = 0 before anything multiplies it: an
// empty bag has m = -1e30 and l = 1e-30, where exp(0) / l would be 1e30.
//
// What bounds it on an H100: it reads B*N*C*itemsize bytes of x once and does
// about 6*P*C floating-point operations per element (the q and g dots, the
// dq product), ~36 FLOP/byte for bf16 at P=12 -- far below the tensor-core
// ridge, so the byte stream is the floor.  This first version runs on CUDA
// cores in f32, written to be right, not fast (PERF.md holds its times
// beside that bound); tensor-core mma, TMA staging and int8 MMA are later
// work.
//
// Design.  The TPU kernel carries one dq accumulator across its whole
// sequential (B, N) grid.  Hopper runs blocks in parallel, so the patch axis
// of each bag is split as the forward splits it (`split_plan`): block (s, b)
// accumulates the partial dq of its chunk in shared memory and writes it to
// a workspace [B*S, P, C]; a second kernel sums the B*S partials in a fixed
// order and multiplies by `scale`.  Deterministic, no atomics.
//
// Per block: s_row[p] = g[p] . out[p] once; then per tile of 32 patches,
// with 8 warps:
//   A. each warp takes 4 patches; its lanes read the row 4 values at a time
//      and form the 2P dots q[p] . x[n] and g[p] . x[n] (and |x[n]|^2 where
//      there is no host inv), reduced across the warp; lane 0 turns them into
//      the weights dl[p][j]; the tile is staged in shared memory;
//   B. each thread owns channels c = tid, tid+256, ...: it adds
//      sum_j dl[p][j] * x[j][c] to the partial dq[p][c] in shared memory.
#include "coattn_common.cuh"

using namespace coattn;

namespace {

// Shared-memory bytes of one partial block (must match the carve-up below).
__host__ __device__ inline size_t dq_partial_smem_bytes(int P, int C, int itemsize) {
    return sizeof(float) * (3 * (size_t)P * C          // q, g, partial dq
                            + kMaxP * kTile            // weights dl
                            + 3 * kMaxP)               // m, l, s_row
           + (size_t)kTile * C * itemsize;             // the x tile
}

template <typename T, bool HOST_INV, bool HAS_SCALE>
__global__ void __launch_bounds__(kThreads)
coattn_bwd_dq_partial(const float* __restrict__ q, const T* __restrict__ x,
                      const float* __restrict__ x_scale,
                      const float* __restrict__ x_inv,
                      const uint8_t* __restrict__ mask, float scale,
                      const float* __restrict__ g, const float* __restrict__ out,
                      const float* __restrict__ m, const float* __restrict__ l,
                      int N, int C, int P, int chunk, int S,
                      float* __restrict__ ws_dq) {
    extern __shared__ float4 smem_f4[];
    float* smem = reinterpret_cast<float*>(smem_f4);
    float* q_s = smem;                          // [P, C]
    float* g_s = q_s + P * C;                   // [P, C]
    float* acc_s = g_s + P * C;                 // [P, C] partial dq
    float* w_s = acc_s + P * C;                 // [kMaxP, kTile]
    float* m_s = w_s + kMaxP * kTile;           // [kMaxP]
    float* l_s = m_s + kMaxP;                   // [kMaxP]
    float* srow_s = l_s + kMaxP;                // [kMaxP]
    T* x_s = reinterpret_cast<T*>(srow_s + kMaxP);  // [kTile, C]

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int split = blockIdx.x;
    const int b = blockIdx.y;
    const int n_begin = split * chunk;
    const int n_end = min(N, n_begin + chunk);

    const T* xb = x + (size_t)b * N * C;
    const uint8_t* mb = mask + (size_t)b * N;
    const float* gb = g + (size_t)b * P * C;
    const float* ob = out + (size_t)b * P * C;

    for (int i = tid; i < P * C; i += kThreads) {
        q_s[i] = q[i];
        g_s[i] = gb[i];
        acc_s[i] = 0.f;
    }
    // s_row[p] = g[p] . out[p], one warp per query
    for (int p = warp; p < P; p += kWarps) {
        float s = 0.f;
        for (int c = lane; c < C; c += 32) s += gb[p * C + c] * ob[p * C + c];
        s = warp_sum(s);
        if (lane == 0) {
            srow_s[p] = s;
            m_s[p] = m[(size_t)b * P + p];
            l_s[p] = l[(size_t)b * P + p];
        }
    }
    __syncthreads();

    const int c4 = C / 4;  // groups of four channels
    for (int t0 = n_begin; t0 < n_end; t0 += kTile) {
        // ---- A: the 2P dots of each patch, then its weights dl[p] ----
        for (int j = warp; j < kTile; j += kWarps) {
            const int n = t0 + j;
            const bool in_range = n < n_end;
            float dot_q[kMaxP], dot_g[kMaxP];
#pragma unroll
            for (int p = 0; p < kMaxP; ++p) { dot_q[p] = 0.f; dot_g[p] = 0.f; }
            float sq = 0.f;
            typename Raw4<T>::type* xrow =
                reinterpret_cast<typename Raw4<T>::type*>(x_s + (size_t)j * C);
            if (in_range) {
                const T* src = xb + (size_t)n * C;
                for (int k = lane; k < c4; k += 32) {
                    const typename Raw4<T>::type raw =
                        *reinterpret_cast<const typename Raw4<T>::type*>(src + 4 * k);
                    xrow[k] = raw;
                    float v[4];
                    load4(reinterpret_cast<const T*>(&raw), v);
                    sq += v[0] * v[0] + v[1] * v[1] + v[2] * v[2] + v[3] * v[3];
#pragma unroll
                    for (int p = 0; p < kMaxP; ++p) {
                        if (p < P) {
                            const float4 qv = *reinterpret_cast<const float4*>(q_s + p * C + 4 * k);
                            const float4 gv = *reinterpret_cast<const float4*>(g_s + p * C + 4 * k);
                            dot_q[p] += qv.x * v[0] + qv.y * v[1] + qv.z * v[2] + qv.w * v[3];
                            dot_g[p] += gv.x * v[0] + gv.y * v[1] + gv.z * v[2] + gv.w * v[3];
                        }
                    }
                }
            } else {
                for (int k = lane; k < c4; k += 32) {
                    xrow[k] = typename Raw4<T>::type{};
                }
            }
#pragma unroll
            for (int p = 0; p < kMaxP; ++p) {
                if (p < P) {
                    dot_q[p] = warp_sum(dot_q[p]);
                    dot_g[p] = warp_sum(dot_g[p]);
                }
            }
            if (!HOST_INV) sq = warp_sum(sq);
            if (lane == 0) {
                const bool valid = in_range && mb[n] != 0;
                float inv = 0.f, s_n = 1.f;
                if (valid) {
                    inv = HOST_INV ? x_inv[(size_t)b * N + n] : rsqrtf(fmaxf(sq, 1e-24f));
                    if (HAS_SCALE) s_n = x_scale[(size_t)b * N + n];
                }
#pragma unroll
                for (int p = 0; p < kMaxP; ++p) {
                    if (p < P) {
                        float w = 0.f;  // a = 0 for a masked patch, before any product
                        if (valid) {
                            const float a = expf(scale * dot_q[p] * inv - m_s[p]) / l_s[p];
                            w = a * (dot_g[p] * s_n - srow_s[p]) * inv;
                        }
                        w_s[p * kTile + j] = w;
                    }
                }
            }
        }
        __syncthreads();

        // ---- B: partial dq[p][c] += sum_j dl[p][j] * x[j][c] ----
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
                acc_s[p * C + c] += s;
            }
        }
        __syncthreads();
    }

    float* dst = ws_dq + ((size_t)b * S + split) * P * C;
    for (int i = tid; i < P * C; i += kThreads) dst[i] = acc_s[i];
}

template <typename T, bool HOST_INV, bool HAS_SCALE>
cudaError_t launch_partial(const float* q, const void* x, const float* x_scale,
                           const float* x_inv, const uint8_t* mask, float scale,
                           const float* g, const float* out, const float* m,
                           const float* l, int B, int N, int C, int P, int chunk,
                           int S, float* ws_dq, cudaStream_t stream) {
    auto kernel = coattn_bwd_dq_partial<T, HOST_INV, HAS_SCALE>;
    const size_t smem = dq_partial_smem_bytes(P, C, sizeof(T));
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(S, B), kThreads, smem, stream>>>(
        q, static_cast<const T*>(x), x_scale, x_inv, mask, scale, g, out, m, l,
        N, C, P, chunk, S, ws_dq);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_inv(bool host_inv, bool has_scale, const float* q,
                         const void* x, const float* x_scale, const float* x_inv,
                         const uint8_t* mask, float scale, const float* g,
                         const float* out, const float* m, const float* l, int B,
                         int N, int C, int P, int chunk, int S, float* ws_dq,
                         cudaStream_t stream) {
#define COATTN_DQ_LAUNCH(HI, HS)                                                 \
    return launch_partial<T, HI, HS>(q, x, x_scale, x_inv, mask, scale, g, out, \
                                     m, l, B, N, C, P, chunk, S, ws_dq, stream)
    if (host_inv) {
        if (has_scale) { COATTN_DQ_LAUNCH(true, true); }
        COATTN_DQ_LAUNCH(true, false);
    }
    if (has_scale) { COATTN_DQ_LAUNCH(false, true); }
    COATTN_DQ_LAUNCH(false, false);
#undef COATTN_DQ_LAUNCH
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one partial block needs.
size_t coattn_bwd_dq_smem_bytes(int P, int C, int storage) {
    return dq_partial_smem_bytes(P, C, storage_itemsize(storage));
}

// q [P, C] f32; x [B, N, C] (storage: 0 f32, 1 bf16, 2 int8); x_scale and
// x_inv [B, N] f32 or null; mask [B, N] bool; g and out [B, P, C] f32 (the
// output's cotangent and the forward output); m and l [B, P] f32 (the
// forward's softmax stats).  Workspace ws_dq [B, S, P, C] f32.  Output dq
// [P, C] f32.  All on CUDA device `device`; the kernels go to `stream`.
// Returns the launch's cudaError_t (0 on success).
int coattn_bwd_dq(const void* q, const void* x, const void* x_scale,
                  const void* x_inv, const void* mask, float scale, const void* g,
                  const void* out, const void* m, const void* l, int B, int N,
                  int C, int P, int chunk, int S, int storage, int device,
                  void* ws_dq, void* dq, void* stream) {
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
    const float* gf = static_cast<const float*>(g);
    const float* of = static_cast<const float*>(out);
    const float* mf = static_cast<const float*>(m);
    const float* lf = static_cast<const float*>(l);
    float* ws = static_cast<float*>(ws_dq);
    const bool host_inv = xi != nullptr;
    const bool has_scale = xs != nullptr;
    cudaError_t err;
    if (storage == kF32) {
        err = dispatch_inv<float>(host_inv, has_scale, qf, x, xs, xi, mk, scale,
                                  gf, of, mf, lf, B, N, C, P, chunk, S, ws, st);
    } else if (storage == kBF16) {
        err = dispatch_inv<__nv_bfloat16>(host_inv, has_scale, qf, x, xs, xi, mk,
                                          scale, gf, of, mf, lf, B, N, C, P, chunk,
                                          S, ws, st);
    } else if (storage == kI8) {
        err = dispatch_inv<int8_t>(host_inv, has_scale, qf, x, xs, xi, mk, scale,
                                   gf, of, mf, lf, B, N, C, P, chunk, S, ws, st);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return (int)err;
    return (int)launch_dq_reduce(ws, B * S, P * C, scale, static_cast<float*>(dq), st);
}

}  // extern "C"
