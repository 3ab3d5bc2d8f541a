// Masked co-attention pooling, full backward (dq and dX), for Hopper (sm_90a).
//
// Replaces the TPU kernel vlsa_tpu/ops/coattn.py::_coattn_bwd_kernel (its
// launcher _coattn_pallas_bwd).  The patch features x need a gradient here
// (VLFAN with a feature projecter), so besides the queries' gradient dq this
// kernel writes dX [B, N, C] in x's type.  From the forward's stats (m, l)
// and output `out`, for each bag b, query p and patch n, with
// inv[n] = rsqrt(max(|x[n]|^2, 1e-24)):
//
//     raw[p,n] = q[p] . x[n],   dA[p,n] = g[p] . x[n]
//     a[p,n]   = exp(scale * raw[p,n] * inv[n] - m[p]) / l[p]  (0 where masked)
//     dl[p,n]  = a[p,n] * (dA[p,n] - g[p] . out[p]) * inv[n]
//     dX[n]    = sum_p a'[p,n] g'[p] + scale * sum_p dl'[p,n] q[p]
//                - x[n] * inv[n]^2 * proj[n]
//     proj[n]  = scale * sum_p dl'[p,n] raw[p,n]        (= x[n] . dxhat[n])
//     dq[p]    = scale * sum_b sum_n dl[p,n] x[n]
//
// A prime marks the TPU kernel's roundings for bf16 storage: a, g and dl go
// into the dX products rounded to bf16 (its lines 387 and 392), q stays f32,
// and dX is rounded to bf16 once, at the store; dq and everything else is
// f32.  For f32 storage nothing is rounded.  proj[n] reuses the dots of
// phase A below: the TPU kernel sums x[n] * dxhat[n] over C instead, the
// same value up to f32 summation order, so dX needs no second pass over the
// row.  Masked patches, the ragged edge and empty bags get a = 0 before any
// product (an empty bag has m = -1e30, l = 1e-30, where exp(0) / l would be
// 1e30), so their dX rows are written as exact zeros.
//
// What bounds it on an H100: it reads x once and writes dX once,
// 2*B*N*C*itemsize bytes, and does about 10*P*C floating-point operations
// per element (the q and g dots, the two dX products and the dq product):
// at P=12 that is 15 FLOP/byte for f32 and 30 for bf16, below the
// tensor-core ridge, so the bound is the byte stream; on CUDA cores in f32
// (67 TFLOP/s) the arithmetic of either storage takes ~1.6x the bf16 byte
// time.  This first version runs on CUDA cores in f32, written to be right,
// not fast (PERF.md holds its times beside that bound); wgmma for the P x C
// products and TMA staging are later work.
//
// Design.  The TPU kernel carries one dq accumulator across its whole
// sequential (B, N) grid.  Here, as in coattn_bwd_dq.cu, the patch axis of
// each bag is split into chunks (`split_plan`), one block per (chunk, bag):
// the block writes the dX rows of its chunk and its partial dq to a
// workspace [B*S, P, C], which `dq_reduce` (coattn_common.cuh) sums in a
// fixed order.  Deterministic, no atomics.
//
// Per block: q and g in shared memory, s_row[p] = g[p] . out[p] once; then
// per tile of 32 patches, with 8 warps:
//   A. each warp takes 4 patches; its lanes read the row 16 bytes at a time
//      (4 f32 or 8 bf16 values), keep it in the shared tile and form the 2P
//      dots q[p] . x[n], g[p] . x[n] and |x[n]|^2, reduced across the warp;
//      lane 0 turns them into a'[p][j], dl[p][j], scale * dl'[p][j] and
//      inv[j]^2 * proj[j] in shared memory;
//   B. each thread takes 8 patches x 16 bytes of channels at a time and
//      writes their dX with one 16-byte store per patch; then each thread
//      owns channels c = tid, tid+256, ... and adds sum_j dl[p][j] * x[j][c]
//      to the partial dq[p][c] in shared memory.
#include "coattn_common.cuh"

using namespace coattn;

namespace {

constexpr int kPatchesPerItem = 8;  // patches of one dX work item in phase B

// Shared-memory bytes of one block (must match the carve-up below).
__host__ __device__ inline size_t dx_partial_smem_bytes(int P, int C, int itemsize) {
    return sizeof(float) * (3 * (size_t)P * C          // q, g, partial dq
                            + 3 * kMaxP * kTile        // a', dl, scale * dl'
                            + kTile                    // inv^2 * proj
                            + 3 * kMaxP)               // m, l, s_row
           + (size_t)kTile * C * itemsize;             // the x tile
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
coattn_bwd_dx_partial(const float* __restrict__ q, const T* __restrict__ x,
                      const uint8_t* __restrict__ mask, float scale,
                      const float* __restrict__ g, const float* __restrict__ out,
                      const float* __restrict__ m, const float* __restrict__ l,
                      int N, int C, int P, int chunk, int S,
                      float* __restrict__ ws_dq, T* __restrict__ dx) {
    using Raw = typename Vec16<T>::raw;
    constexpr int V = Vec16<T>::n;              // values per 16 bytes
    constexpr int J = kPatchesPerItem;
    extern __shared__ float4 smem_f4[];
    float* smem = reinterpret_cast<float*>(smem_f4);
    float* q_s = smem;                          // [P, C]
    float* g_s = q_s + P * C;                   // [P, C]
    float* acc_s = g_s + P * C;                 // [P, C] partial dq
    float* a_s = acc_s + P * C;                 // [kMaxP, kTile] a'
    float* dl_s = a_s + kMaxP * kTile;          // [kMaxP, kTile] dl (f32)
    float* dls_s = dl_s + kMaxP * kTile;        // [kMaxP, kTile] scale * dl'
    float* coef_s = dls_s + kMaxP * kTile;      // [kTile] inv^2 * proj
    float* m_s = coef_s + kTile;                // [kMaxP]
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
    T* dxb = dx + (size_t)b * N * C;
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

    const int cv = C / V;  // 16-byte vectors of a row
    for (int t0 = n_begin; t0 < n_end; t0 += kTile) {
        // ---- A: the 2P dots of each patch, then its weights ----
        for (int j = warp; j < kTile; j += kWarps) {
            const int n = t0 + j;
            const bool in_range = n < n_end;
            float dot_q[kMaxP], dot_g[kMaxP];
#pragma unroll
            for (int p = 0; p < kMaxP; ++p) { dot_q[p] = 0.f; dot_g[p] = 0.f; }
            float sq = 0.f;
            Raw* xrow = reinterpret_cast<Raw*>(x_s + (size_t)j * C);
            if (in_range) {
                const Raw* src = reinterpret_cast<const Raw*>(xb + (size_t)n * C);
                for (int k = lane; k < cv; k += 32) {
                    const Raw raw = src[k];
                    xrow[k] = raw;
                    float v[V];
                    unpack(raw, v);
#pragma unroll
                    for (int i = 0; i < V; ++i) sq += v[i] * v[i];
#pragma unroll
                    for (int p = 0; p < kMaxP; ++p) {
                        if (p < P) {
                            const float* qp = q_s + p * C + V * k;
                            const float* gp = g_s + p * C + V * k;
#pragma unroll
                            for (int i = 0; i < V; i += 4) {
                                const float4 qv = *reinterpret_cast<const float4*>(qp + i);
                                const float4 gv = *reinterpret_cast<const float4*>(gp + i);
                                dot_q[p] += qv.x * v[i] + qv.y * v[i + 1]
                                          + qv.z * v[i + 2] + qv.w * v[i + 3];
                                dot_g[p] += gv.x * v[i] + gv.y * v[i + 1]
                                          + gv.z * v[i + 2] + gv.w * v[i + 3];
                            }
                        }
                    }
                }
            } else {
                for (int k = lane; k < cv; k += 32) xrow[k] = Raw{};
            }
#pragma unroll
            for (int p = 0; p < kMaxP; ++p) {
                if (p < P) {
                    dot_q[p] = warp_sum(dot_q[p]);
                    dot_g[p] = warp_sum(dot_g[p]);
                }
            }
            sq = warp_sum(sq);
            if (lane == 0) {
                const bool valid = in_range && mb[n] != 0;
                const float inv = valid ? rsqrtf(fmaxf(sq, 1e-24f)) : 0.f;
                float proj = 0.f;
#pragma unroll
                for (int p = 0; p < kMaxP; ++p) {
                    if (p < P) {
                        float a = 0.f, dl = 0.f;  // a = 0 for a masked patch, first
                        if (valid) {
                            a = expf(scale * dot_q[p] * inv - m_s[p]) / l_s[p];
                            dl = a * (dot_g[p] - srow_s[p]) * inv;
                        }
                        const float dl_r = round_as<T>(dl);
                        proj += dl_r * dot_q[p];
                        a_s[p * kTile + j] = round_as<T>(a);
                        dl_s[p * kTile + j] = dl;
                        dls_s[p * kTile + j] = scale * dl_r;
                    }
                }
                coef_s[j] = scale * proj * inv * inv;
            }
        }
        __syncthreads();

        // ---- B: dX of the tile, J patches x V channels per work item ----
        const int items = cv * (kTile / J);
        for (int w = tid; w < items; w += kThreads) {
            const int k = w % cv;         // channel vector
            const int j0 = (w / cv) * J;  // first patch of the item
            if (t0 + j0 >= n_end) continue;
            float acc[J][V];
#pragma unroll
            for (int jj = 0; jj < J; ++jj) {
#pragma unroll
                for (int i = 0; i < V; ++i) acc[jj][i] = 0.f;
            }
            for (int p = 0; p < P; ++p) {
                float qv[V], gv[V], av[J], dv[J];
#pragma unroll
                for (int i = 0; i < V; i += 4) {
                    const float4 q4 = *reinterpret_cast<const float4*>(q_s + p * C + V * k + i);
                    const float4 g4 = *reinterpret_cast<const float4*>(g_s + p * C + V * k + i);
                    qv[i] = q4.x; qv[i + 1] = q4.y; qv[i + 2] = q4.z; qv[i + 3] = q4.w;
                    gv[i] = round_as<T>(g4.x); gv[i + 1] = round_as<T>(g4.y);
                    gv[i + 2] = round_as<T>(g4.z); gv[i + 3] = round_as<T>(g4.w);
                }
#pragma unroll
                for (int jj = 0; jj < J; jj += 4) {
                    const float4 a4 = *reinterpret_cast<const float4*>(a_s + p * kTile + j0 + jj);
                    const float4 d4 = *reinterpret_cast<const float4*>(dls_s + p * kTile + j0 + jj);
                    av[jj] = a4.x; av[jj + 1] = a4.y; av[jj + 2] = a4.z; av[jj + 3] = a4.w;
                    dv[jj] = d4.x; dv[jj + 1] = d4.y; dv[jj + 2] = d4.z; dv[jj + 3] = d4.w;
                }
#pragma unroll
                for (int jj = 0; jj < J; ++jj) {
#pragma unroll
                    for (int i = 0; i < V; ++i) acc[jj][i] += av[jj] * gv[i] + dv[jj] * qv[i];
                }
            }
#pragma unroll
            for (int jj = 0; jj < J; ++jj) {
                const int n = t0 + j0 + jj;
                if (n < n_end) {
                    float xv[V], o[V];
                    unpack(reinterpret_cast<const Raw*>(x_s + (size_t)(j0 + jj) * C)[k], xv);
                    const float cf = coef_s[j0 + jj];
#pragma unroll
                    for (int i = 0; i < V; ++i) o[i] = acc[jj][i] - xv[i] * cf;
                    Raw r;
                    pack(o, r);
                    reinterpret_cast<Raw*>(dxb + (size_t)n * C)[k] = r;
                }
            }
        }
        // ---- B: partial dq[p][c] += sum_j dl[p][j] * x[j][c] ----
        for (int c = tid; c < C; c += kThreads) {
            float xv[kTile];
#pragma unroll
            for (int j = 0; j < kTile; ++j) xv[j] = to_float(x_s[(size_t)j * C + c]);
            for (int p = 0; p < P; ++p) {
                const float4* wp = reinterpret_cast<const float4*>(dl_s + p * kTile);
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

template <typename T>
cudaError_t launch_partial(const float* q, const void* x, const uint8_t* mask,
                           float scale, const float* g, const float* out,
                           const float* m, const float* l, int B, int N, int C,
                           int P, int chunk, int S, float* ws_dq, void* dx,
                           cudaStream_t stream) {
    auto kernel = coattn_bwd_dx_partial<T>;
    const size_t smem = dx_partial_smem_bytes(P, C, sizeof(T));
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(S, B), kThreads, smem, stream>>>(
        q, static_cast<const T*>(x), mask, scale, g, out, m, l, N, C, P, chunk, S,
        ws_dq, static_cast<T*>(dx));
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs.
size_t coattn_bwd_dx_smem_bytes(int P, int C, int storage) {
    return dx_partial_smem_bytes(P, C, storage_itemsize(storage));
}

// q [P, C] f32; x [B, N, C] (storage: 0 f32, 1 bf16); mask [B, N] bool; g and
// out [B, P, C] f32 (the output's cotangent and the forward output); m and l
// [B, P] f32 (the forward's softmax stats).  Workspace ws_dq [B, S, P, C]
// f32.  Outputs dq [P, C] f32 and dx [B, N, C] in x's type, every row
// written.  All on CUDA device `device`; the kernels go to `stream`.
// Returns the launch's cudaError_t (0 on success).
int coattn_bwd_dx(const void* q, const void* x, const void* mask, float scale,
                  const void* g, const void* out, const void* m, const void* l,
                  int B, int N, int C, int P, int chunk, int S, int storage,
                  int device, void* ws_dq, void* dq, void* dx, void* stream) {
    if (P < 1 || P > kMaxP || C % 8 != 0 || S < 1 || B < 1) {
        return (int)cudaErrorInvalidValue;
    }
    cudaError_t dev_err = cudaSetDevice(device);
    if (dev_err != cudaSuccess) return (int)dev_err;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* qf = static_cast<const float*>(q);
    const uint8_t* mk = static_cast<const uint8_t*>(mask);
    const float* gf = static_cast<const float*>(g);
    const float* of = static_cast<const float*>(out);
    const float* mf = static_cast<const float*>(m);
    const float* lf = static_cast<const float*>(l);
    float* ws = static_cast<float*>(ws_dq);
    cudaError_t err;
    if (storage == kF32) {
        err = launch_partial<float>(qf, x, mk, scale, gf, of, mf, lf, B, N, C, P,
                                    chunk, S, ws, dx, st);
    } else if (storage == kBF16) {
        err = launch_partial<__nv_bfloat16>(qf, x, mk, scale, gf, of, mf, lf, B, N,
                                            C, P, chunk, S, ws, dx, st);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return (int)err;
    return (int)launch_dq_reduce(ws, B * S, P * C, scale, static_cast<float*>(dq), st);
}

}  // extern "C"
