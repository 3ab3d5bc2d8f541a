// ABMIL attention pooling forward for Hopper (sm_90a).
//
// Replaces the TPU kernels vlsa_tpu/ops/abmil.py::_abmil_kernel (f32 and
// bf16 storage) and ::_abmil_q8_kernel (int8 storage).  For each bag b:
//
//     h[n]     = tanh(s[n] * (x[n] . W1^T) + b1)          [hid]
//     logit[n] = h[n] . w2                                (-1e30 where masked)
//     out[b]   = sum_n softmax_n(logit)[n] * s[n] * x[n]  [D]
//
// with s[n] the per-patch int8 dequant scale (1 for float storage).  b2
// shifts every logit alike and cancels in the softmax, so it is not an input.
// Rounding follows the TPU kernels: bf16 storage multiplies x by W1 rounded
// to bf16 (f32 accumulation); int8 multiplies the raw int8 values by W1 split
// into bf16 hi + lo (~16 bits; the TPU splits it into two int8 parts, ~15
// bits); f32 forms x . W1^T in split TF32 on the tensor cores (~2^-21
// relative per product; the plain version ops/abmil.py::abmil_fwd_reference
// stays true f32, and the TPU kernel's own f32 is the MXU's multi-pass bf16).
//
// What bounds it on an H100: the product is 2*D*hid operations per patch, 256
// per bf16 byte of x at D=512, hid=256 -- at the card's bf16 ridge (~295), so
// bytes (x read once) and tensor-core operations bound it about equally; int8
// halves the bytes.  f32 is bound by its products: 3 TF32 products each
// (495 TFLOP/s dense) beat one f32 FMA on the CUDA cores (67 TFLOP/s) 2.5x.
// PERF.md holds the times beside the bound.
//   - bf16 and int8 (written to be right, not fast) use the tensor cores
//     through nvcuda::wmma (bf16 operands, f32 accumulation), 16x16x16
//     fragments; int8 pays two products (hi, lo).  W1 [256, 512] does not fit
//     in shared memory with a tile (256 KB in bf16), so it is streamed
//     through shared memory in slices of 64 columns of D for every tile of 64
//     patches, synchronously: re-read from L2 once per tile, 4x the tile's
//     own bytes (bf16), which the 50 MB L2 serves.
//   - f32 (abmil_fwd_partial_f32): mma.sync m16n8k8 with TF32 operands, each
//     f32 operand split into hi + lo as its fragment is loaded from shared
//     memory, lo.hi + hi.lo + hi.hi into f32 accumulators (abmil_common.cuh).
//     The tile of 64 patches stays resident in shared memory (132 KB, rows
//     padded to 516 floats): it is the A operand of the h product and then
//     the PV sum's rows, so x is read from device memory once.  W1 f32
//     streams through 2 cp.async stages of 32 columns of D (36 KB each), x's
//     own 32-column slices beside it, so the product waits on no synchronous
//     restage and the x tile arrives while the first slices multiply; the
//     next tile's first W1 slice is in flight during this tile's epilogue.
//     W1 is split at fragment load (not pre-split by a prep kernel: that
//     doubles its L2 -> SM bytes), 512 KB from L2 per tile of 64: 4x x's own
//     bytes, 0.67 GB a call at B=8, N=10240.  h [64, 256] never leaves the
//     registers: 8 warps of 32 rows x 64 hid columns, 64 accumulators a
//     thread; tanh, the w2 dot and the quad and warp sums of the logit run
//     on the fragments.  209 KB of shared memory: one block per SM.
//
// Design.  The TPU grid walks N in order and carries (m, l, acc) in VMEM.
// Hopper runs blocks in parallel, so each bag's patches are split over S
// blocks (the chunk plan of ops/abmil.py::fwd_plan): block (s, b) runs the
// online softmax over its chunk and writes its partial (m, l, acc[D]); a
// second kernel merges the partials of each bag in a fixed order.
// Deterministic, no atomics.  Any N: the ragged edge of the last tile is
// masked here.  A masked or out-of-range patch gets logit -1e30 and weight 0
// before anything is multiplied; an empty bag gives out = 0, m = -1e30 and
// l = 1e-30.
//
// Per tile (bf16, int8): (1) stage the x tile in shared memory (int8 as
// exact bf16); (2) h_pre = x . W1^T into a [tile, hid] f32 tile
// (abmil_common.cuh); (3) one warp per patch: tanh, the w2 dot and the mask
// give the logit; (4) warp 0 updates the online softmax; (5) each thread
// folds the tile's weighted rows into its two channels of acc, held in
// registers.  f32: (1)-(2) are h_product_f32, (3) tanh_logit_f32 on the
// accumulators, then (4) and (5) as above.
#include "abmil_common.cuh"

using namespace abmil;

namespace {

template <typename T>
struct FwdSmem {
    static constexpr int M = Tile<T>::M;
    static constexpr size_t x = 0;
    static constexpr size_t h = x + x_tile_bytes<T>();
    static constexpr size_t w = h + round128((size_t)M * kLdH * 4);
    static constexpr size_t rows = w + w_stage_bytes<T>();  // logit, p, valid, scale [M] + 4 stats
    static constexpr size_t total = rows + round128((4 * (size_t)M + 4) * 4);
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
abmil_fwd_partial(const T* __restrict__ x, const float* __restrict__ x_scale,
                  const uint8_t* __restrict__ mask, const __nv_bfloat16* __restrict__ w1h, const __nv_bfloat16* __restrict__ w1l,
                  const float* __restrict__ b1, const float* __restrict__ w2, int N,
                  int chunk, int S, float* __restrict__ ws_m, float* __restrict__ ws_l,
                  float* __restrict__ ws_acc) {
    using L = FwdSmem<T>;
    using XS = typename Staged<T>::type;
    constexpr int M = L::M;
    constexpr int ldx = XLd<T>::value;
    extern __shared__ __align__(128) unsigned char smem[];
    XS* xs = reinterpret_cast<XS*>(smem + L::x);
    float* hs = reinterpret_cast<float*>(smem + L::h);
    void* wst = smem + L::w;
    float* logit_s = reinterpret_cast<float*>(smem + L::rows);
    float* p_s = logit_s + M;
    float* valid_s = p_s + M;
    float* scale_s = valid_s + M;
    float* stat_s = scale_s + M;  // m, l, correction

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int split = blockIdx.x, b = blockIdx.y;
    const int n_begin = split * chunk;
    const int n_end = min(N, n_begin + chunk);
    const T* xb = x + (size_t)b * N * kD;
    const uint8_t* mb = mask + (size_t)b * N;

    float b1r[kHid / 32], w2r[kHid / 32];  // this lane's columns j = lane + 32c
#pragma unroll
    for (int c = 0; c < kHid / 32; ++c) {
        b1r[c] = b1[lane + 32 * c];
        w2r[c] = w2[lane + 32 * c];
    }
    if (tid == 0) {
        stat_s[0] = kNegInf;
        stat_s[1] = 0.f;
    }
    float acc0 = 0.f, acc1 = 0.f;  // channels tid and tid + kThreads

    for (int t0 = n_begin; t0 < n_end; t0 += M) {
        stage_x(xb, t0, n_end, xs, M);
        for (int r = tid; r < M; r += kThreads) {
            const int n = t0 + r;
            const bool valid = n < n_end && mb[n] != 0;
            valid_s[r] = valid ? 1.f : 0.f;
            scale_s[r] = (valid && x_scale != nullptr) ? x_scale[(size_t)b * N + n] : 1.f;
        }
        h_gemm<T>(xs, w1h, w1l, wst, hs);  // synchronises before and after

        for (int r = warp; r < M; r += kWarps) {
            const float sr = scale_s[r];
            float s = 0.f;
#pragma unroll
            for (int c = 0; c < kHid / 32; ++c) {
                s += tanhf(fmaf(hs[r * kLdH + lane + 32 * c], sr, b1r[c])) * w2r[c];
            }
            s = warp_sum(s);
            if (lane == 0) logit_s[r] = valid_s[r] != 0.f ? s : kNegInf;
        }
        __syncthreads();

        if (warp == 0) {
            float mx = kNegInf;
            for (int r = lane; r < M; r += 32) mx = fmaxf(mx, logit_s[r]);
            mx = warp_max(mx);
            const float m_prev = stat_s[0];
            const float m_new = fmaxf(m_prev, mx);
            float psum = 0.f;
            for (int r = lane; r < M; r += 32) {
                const float p = valid_s[r] != 0.f ? expf(logit_s[r] - m_new) : 0.f;
                p_s[r] = p * scale_s[r];
                psum += p;
            }
            psum = warp_sum(psum);
            if (lane == 0) {
                const float corr = expf(m_prev - m_new);
                stat_s[2] = corr;
                stat_s[1] = stat_s[1] * corr + psum;
                stat_s[0] = m_new;
            }
        }
        __syncthreads();

        const float corr = stat_s[2];
        float s0 = 0.f, s1 = 0.f;
        for (int r = 0; r < M; ++r) {
            const float p = p_s[r];
            s0 = fmaf(p, to_float(xs[r * ldx + tid]), s0);
            s1 = fmaf(p, to_float(xs[r * ldx + tid + kThreads]), s1);
        }
        acc0 = acc0 * corr + s0;
        acc1 = acc1 * corr + s1;
        __syncthreads();  // xs and the rows are rewritten by the next tile
    }

    const size_t part = (size_t)b * S + split;
    if (tid == 0) {
        ws_m[part] = stat_s[0];
        ws_l[part] = stat_s[1];
    }
    ws_acc[part * kD + tid] = acc0;
    ws_acc[part * kD + tid + kThreads] = acc1;
}

// The same partial for f32 storage: x . W1^T in split TF32 on the tensor
// cores, the x tile resident, W1 streamed by cp.async (see the note above).
struct FwdSmemF {
    static constexpr size_t x = 0;                                      // [kMF][kLdXF]
    static constexpr size_t w = x + round128((size_t)kMF * kLdXF * 4);  // 2 stages
    static constexpr size_t cols = w + 2 * kStageF;                     // b1, w2 [kHid]
    static constexpr size_t red = cols + round128(2 * (size_t)kHid * 4);  // [4][kMF]
    static constexpr size_t rows = red + round128(4 * (size_t)kMF * 4);   // p [kMF] + 4 stats
    static constexpr size_t total = rows + round128(((size_t)kMF + 4) * 4);
};

__global__ void __launch_bounds__(kThreads, 1)
abmil_fwd_partial_f32(const float* __restrict__ x, const uint8_t* __restrict__ mask,
                      const float* __restrict__ w1, const float* __restrict__ b1,
                      const float* __restrict__ w2, int N, int chunk, int S,
                      float* __restrict__ ws_m, float* __restrict__ ws_l,
                      float* __restrict__ ws_acc) {
    using L = FwdSmemF;
    extern __shared__ __align__(128) unsigned char smem[];
    float* xs = reinterpret_cast<float*>(smem + L::x);
    float* stage0 = reinterpret_cast<float*>(smem + L::w);
    float* b1s = reinterpret_cast<float*>(smem + L::cols);
    float* w2s = b1s + kHid;
    float* red = reinterpret_cast<float*>(smem + L::red);
    float* p_s = reinterpret_cast<float*>(smem + L::rows);
    float* stat_s = p_s + kMF;  // m, l, correction

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int split = blockIdx.x, b = blockIdx.y;
    const int n_begin = split * chunk;
    const int n_end = min(N, n_begin + chunk);
    const float* xb = x + (size_t)b * N * kD;
    const uint8_t* mb = mask + (size_t)b * N;

    load_w1_cols(w1, stage0, 0);  // the first tile's first W1 slice
    cp_async_commit();
    for (int j = tid; j < kHid; j += kThreads) {
        b1s[j] = b1[j];
        w2s[j] = w2[j];
    }
    if (tid == 0) {
        stat_s[0] = kNegInf;
        stat_s[1] = 0.f;
    }
    float acc0 = 0.f, acc1 = 0.f;  // channels tid and tid + kThreads
    float acc[kMT][kNT][4];

    for (int t0 = n_begin; t0 < n_end; t0 += kMF) {
        const bool more = t0 + kMF < n_end;
        h_product_f32(acc, xb, t0, n_end, w1, xs, stage0, [&](float* st) {
            if (more) load_w1_cols(w1, st, 0);  // the next tile's first slice
        });
        tanh_logit_f32(acc, b1s, w2s, red);
        __syncthreads();

        if (warp == 0) {
            float lg[kMF / 32];
            bool valid[kMF / 32];
            float mx = kNegInf;
#pragma unroll
            for (int i = 0; i < kMF / 32; ++i) {
                const int r = lane + 32 * i, n = t0 + r;
                valid[i] = n < n_end && mb[n] != 0;
                lg[i] = valid[i] ? (red[r] + red[kMF + r]) + (red[2 * kMF + r] + red[3 * kMF + r])
                                 : kNegInf;
                mx = fmaxf(mx, lg[i]);
            }
            mx = warp_max(mx);
            const float m_prev = stat_s[0];
            const float m_new = fmaxf(m_prev, mx);
            float psum = 0.f;
#pragma unroll
            for (int i = 0; i < kMF / 32; ++i) {
                const float p = valid[i] ? expf(lg[i] - m_new) : 0.f;
                p_s[lane + 32 * i] = p;
                psum += p;
            }
            psum = warp_sum(psum);
            if (lane == 0) {
                const float corr = expf(m_prev - m_new);
                stat_s[2] = corr;
                stat_s[1] = stat_s[1] * corr + psum;
                stat_s[0] = m_new;
            }
        }
        __syncthreads();

        const float corr = stat_s[2];
        float s0 = 0.f, s1 = 0.f;
#pragma unroll 8
        for (int r = 0; r < kMF; ++r) {
            const float p = p_s[r];
            s0 = fmaf(p, xs[r * kLdXF + tid], s0);
            s1 = fmaf(p, xs[r * kLdXF + tid + kThreads], s1);
        }
        acc0 = acc0 * corr + s0;
        acc1 = acc1 * corr + s1;
        __syncthreads();  // xs, p and the stats are rewritten by the next tile
    }

    const size_t part = (size_t)b * S + split;
    if (tid == 0) {
        ws_m[part] = stat_s[0];
        ws_l[part] = stat_s[1];
    }
    ws_acc[part * kD + tid] = acc0;
    ws_acc[part * kD + tid + kThreads] = acc1;
}

// Merge the S partials of each bag: m = max_s m_s, l = sum_s l_s e^(m_s - m),
// out = sum_s acc_s e^(m_s - m) / max(l, 1e-30).  Grid (B).
__global__ void __launch_bounds__(kThreads)
abmil_fwd_merge(const float* __restrict__ ws_m, const float* __restrict__ ws_l,
                const float* __restrict__ ws_acc, int S, float* __restrict__ out,
                float* __restrict__ m_out, float* __restrict__ l_out) {
    extern __shared__ float e_s[];  // [S]
    __shared__ float m_all, l_all;
    const int b = blockIdx.x, tid = threadIdx.x;
    const float* mb = ws_m + (size_t)b * S;
    if (tid == 0) {
        float m = kNegInf;
        for (int s = 0; s < S; ++s) m = fmaxf(m, mb[s]);
        m_all = m;
    }
    __syncthreads();
    for (int s = tid; s < S; s += kThreads) e_s[s] = expf(mb[s] - m_all);
    __syncthreads();
    if (tid == 0) {
        float l = 0.f;
        for (int s = 0; s < S; ++s) l += ws_l[(size_t)b * S + s] * e_s[s];
        l_all = fmaxf(l, 1e-30f);
        m_out[b] = m_all;
        l_out[b] = l_all;
    }
    __syncthreads();
    const float inv_l = 1.f / l_all;
    const float* ab = ws_acc + (size_t)b * S * kD;
    for (int c = tid; c < kD; c += kThreads) {
        float v = 0.f;
        for (int s = 0; s < S; ++s) v += ab[(size_t)s * kD + c] * e_s[s];
        out[(size_t)b * kD + c] = v * inv_l;
    }
}

template <typename T>
cudaError_t launch_partial(const void* x, const float* x_scale, const uint8_t* mask,
                           const __nv_bfloat16* w1_bf16, const float* b1, const float* w2,
                           int B, int N, int chunk, int S, float* ws_m, float* ws_l,
                           float* ws_acc, cudaStream_t stream) {
    auto kernel = abmil_fwd_partial<T>;
    const size_t smem = FwdSmem<T>::total;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const __nv_bfloat16* w1l = w1_bf16 == nullptr ? nullptr : w1_bf16 + kHid * kD;
    kernel<<<dim3(S, B), kThreads, smem, stream>>>(
        static_cast<const T*>(x), x_scale, mask, w1_bf16, w1l, b1, w2, N, chunk, S,
        ws_m, ws_l, ws_acc);
    return cudaGetLastError();
}

cudaError_t launch_partial_f32(const float* x, const uint8_t* mask, const float* w1,
                               const float* b1, const float* w2, int B, int N, int chunk,
                               int S, float* ws_m, float* ws_l, float* ws_acc,
                               cudaStream_t stream) {
    const size_t smem = FwdSmemF::total;
    cudaError_t err = cudaFuncSetAttribute(
        abmil_fwd_partial_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    abmil_fwd_partial_f32<<<dim3(S, B), kThreads, smem, stream>>>(x, mask, w1, b1, w2, N, chunk,
                                                                   S, ws_m, ws_l, ws_acc);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one partial block needs.
size_t abmil_fwd_smem_bytes(int storage) {
    if (storage == kF32) return FwdSmemF::total;
    if (storage == kBF16) return FwdSmem<__nv_bfloat16>::total;
    return FwdSmem<int8_t>::total;
}

// x [B, N, 512] (storage: 0 f32, 1 bf16, 2 int8); x_scale [B, N] f32 for int8,
// else null; mask [B, N] bool; w1 [256, 512], b1 and w2 [256] f32.
// Workspace: w1_bf16 [2, 256, 512] bf16 (bf16 and int8 storage; null for
// f32), ws_m and ws_l [B, S], ws_acc [B, S, 512] f32.  Outputs: out [B, 512],
// m and l [B] f32.  All on CUDA device `device`; the kernels go to `stream`.
// Returns the launches' cudaError_t (0 on success).
int abmil_fwd(const void* x, const void* x_scale, const void* mask, const void* w1,
              const void* b1, const void* w2, int B, int N, int chunk, int S, int storage,
              int device, void* w1_bf16, void* ws_m, void* ws_l, void* ws_acc, void* out,
              void* m_out, void* l_out, void* stream) {
    if (B < 1 || N < 1 || S < 1 || chunk < 1 || (storage != kF32 && w1_bf16 == nullptr)
        || (storage == kI8) != (x_scale != nullptr)) {
        return (int)cudaErrorInvalidValue;
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* xs = static_cast<const float*>(x_scale);
    const uint8_t* mk = static_cast<const uint8_t*>(mask);
    const float* w1f = static_cast<const float*>(w1);
    const float* b1f = static_cast<const float*>(b1);
    const float* w2f = static_cast<const float*>(w2);
    __nv_bfloat16* wb = static_cast<__nv_bfloat16*>(w1_bf16);
    float* wm = static_cast<float*>(ws_m);
    float* wl = static_cast<float*>(ws_l);
    float* wa = static_cast<float*>(ws_acc);
    if (storage == kF32) {
        err = launch_partial_f32(static_cast<const float*>(x), mk, w1f, b1f, w2f, B, N, chunk,
                                 S, wm, wl, wa, st);
    } else if (storage == kBF16 || storage == kI8) {
        err = launch_prep_w1(w1f, wb, storage == kI8, st);
        if (err != cudaSuccess) return (int)err;
        err = storage == kBF16
            ? launch_partial<__nv_bfloat16>(x, xs, mk, wb, b1f, w2f, B, N, chunk, S, wm, wl,
                                            wa, st)
            : launch_partial<int8_t>(x, xs, mk, wb, b1f, w2f, B, N, chunk, S, wm, wl, wa, st);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return (int)err;
    const size_t merge_smem = sizeof(float) * (size_t)S;
    if (merge_smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    abmil_fwd_merge<<<B, kThreads, merge_smem, st>>>(wm, wl, wa, S, static_cast<float*>(out),
                                                     static_cast<float*>(m_out),
                                                     static_cast<float*>(l_out));
    return (int)cudaGetLastError();
}

}  // extern "C"
