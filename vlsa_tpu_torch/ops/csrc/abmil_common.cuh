// Device helpers shared by the ABMIL pooling kernels (abmil_fwd.cu,
// abmil_bwd.cu): widths, tile shapes, staging of a patch tile in shared
// memory, and the bottleneck product h_pre = x . W1^T of a tile on the
// tensor cores: bf16 operands through nvcuda::wmma (bf16 and int8 storage),
// or split TF32 through mma.sync m16n8k8 (f32 storage: each f32 operand a is
// a_hi + a_lo, both TF32, and a product is lo.hi + hi.lo + hi.hi, ~2^-21
// relative per product against f32's 2^-24; cp.async streams the operands).
#pragma once

#include <mma.h>

#include "coattn_common.cuh"

namespace abmil {

using coattn::cp_async16;
using coattn::cp_async_commit;
using coattn::cp_async_wait;
using coattn::kBF16;
using coattn::kF32;
using coattn::kI8;
using coattn::kNegInf;
using coattn::ldsm_x4;
using coattn::ldsm_x4_t;
using coattn::mma_bf16;
using coattn::mma_tf32;
using coattn::pack_bf16;
using coattn::split_tf32;
using coattn::storage_itemsize;
using coattn::to_float;
using coattn::unpack_bf16;
using coattn::warp_max;
using coattn::warp_sum;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kD = 512;     // feature width D (net_dims 512-256-K)
constexpr int kHid = 256;   // bottleneck width hid
constexpr int kPadB = 8;    // bf16 row padding: rows stay 16-byte aligned, banks shift
constexpr int kPadF = 4;    // f32 row padding
constexpr int kLdH = kHid + kPadF;  // row stride of the f32 h tile
constexpr int kKs = 64;     // D columns of W1 per shared-memory slice (tensor cores)

__host__ __device__ constexpr size_t round128(size_t n) { return (n + 127) / 128 * 128; }

// Patches per tile: 64 for every storage type (f32: the x tile resident in
// shared memory, 64 x 516 x 4 = 132,096 bytes).
template <typename T> struct Tile { static constexpr int M = 64; };
template <> struct Tile<float> { static constexpr int M = 64; };

// The tile's type in shared memory (bf16 and int8 storage): int8 values are
// exact in bf16, so int8 storage is staged as bf16 and multiplies on the
// bf16 tensor cores.
template <typename T> struct Staged { using type = __nv_bfloat16; };

template <typename T> struct XLd { static constexpr int value = kD + kPadB; };

template <typename T>
__host__ __device__ constexpr size_t x_tile_bytes() {
    return round128((size_t)Tile<T>::M * XLd<T>::value * sizeof(typename Staged<T>::type));
}

// Shared-memory bytes of the W1 staging buffer of `h_gemm_tc`.
template <typename T>
__host__ __device__ constexpr size_t w_stage_bytes() {
    return round128((size_t)(sizeof(T) == 1 ? 2 : 1) * kHid * (kKs + kPadB) * 2);
}

// Copy the patches [t0, t0 + M) of one bag (x rows of kD values) into xs,
// zeroing the rows at or past n_end.  16-byte loads; int8 becomes bf16.
__device__ __forceinline__ void stage_x(const __nv_bfloat16* xb, int t0, int n_end,
                                        __nv_bfloat16* xs, int tile_m) {
    constexpr int kVec = kD / 8;
    constexpr int ld = kD + kPadB;
    for (int i = threadIdx.x; i < tile_m * kVec; i += kThreads) {
        const int r = i / kVec, c = i % kVec;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (t0 + r < n_end) v = reinterpret_cast<const uint4*>(xb + (size_t)(t0 + r) * kD)[c];
        reinterpret_cast<uint4*>(xs + (size_t)r * ld)[c] = v;
    }
}
__device__ __forceinline__ void stage_x(const int8_t* xb, int t0, int n_end,
                                        __nv_bfloat16* xs, int tile_m) {
    constexpr int kVec = kD / 16;
    constexpr int ld = kD + kPadB;
    for (int i = threadIdx.x; i < tile_m * kVec; i += kThreads) {
        const int r = i / kVec, c = i % kVec;
        int4 raw = make_int4(0, 0, 0, 0);
        if (t0 + r < n_end) raw = reinterpret_cast<const int4*>(xb + (size_t)(t0 + r) * kD)[c];
        const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
        __align__(16) __nv_bfloat162 out[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            out[k] = __floats2bfloat162_rn(static_cast<float>(v[2 * k]),
                                           static_cast<float>(v[2 * k + 1]));
        }
        uint4* dst = reinterpret_cast<uint4*>(xs + (size_t)r * ld + 16 * c);
        dst[0] = reinterpret_cast<const uint4*>(out)[0];
        dst[1] = reinterpret_cast<const uint4*>(out)[1];
    }
}

// hs[r][j] = sum_k xs[r][k] * W1[j][k] for the 64 rows of a tile and all kHid
// columns, f32 (row stride kLdH), on the bf16 tensor cores.  W1 comes as its
// bf16 rounding w1h [kHid, kD] and, with SPLIT (int8 storage), the bf16
// rounding of the residual w1l, so that w1h + w1l holds ~16 bits of W1.  It
// is streamed through `ws` in slices of kKs columns of D.  Warp w owns the
// hid columns [32w, 32w + 32) of all 64 rows: 4 x 2 accumulator tiles.
// Starts and ends with __syncthreads().
template <bool SPLIT>
__device__ void h_gemm_tc(const __nv_bfloat16* xs, const __nv_bfloat16* __restrict__ w1h,
                          const __nv_bfloat16* __restrict__ w1l, __nv_bfloat16* ws,
                          float* hs) {
    using namespace nvcuda;
    constexpr int ldx = kD + kPadB;
    constexpr int ldw = kKs + kPadB;
    constexpr int kVec = kKs / 8;  // 16-byte groups per W1 slice row
    const int warp = threadIdx.x >> 5;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) wmma::fill_fragment(acc[mt][nt], 0.f);
    __nv_bfloat16* wsl = ws + kHid * ldw;
    for (int k0 = 0; k0 < kD; k0 += kKs) {
        __syncthreads();  // the previous slice is consumed
        for (int i = threadIdx.x; i < kHid * kVec; i += kThreads) {
            const int j = i / kVec, c = i % kVec;
            reinterpret_cast<uint4*>(ws + j * ldw)[c] =
                reinterpret_cast<const uint4*>(w1h + (size_t)j * kD + k0)[c];
            if (SPLIT) {
                reinterpret_cast<uint4*>(wsl + j * ldw)[c] =
                    reinterpret_cast<const uint4*>(w1l + (size_t)j * kD + k0)[c];
            }
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kKs; kk += 16) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bh[2], bl[2];
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
                wmma::load_matrix_sync(bh[nt], ws + (warp * 32 + nt * 16) * ldw + kk, ldw);
                if (SPLIT) {
                    wmma::load_matrix_sync(bl[nt], wsl + (warp * 32 + nt * 16) * ldw + kk, ldw);
                }
            }
#pragma unroll
            for (int mt = 0; mt < 4; ++mt) {
                wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
                wmma::load_matrix_sync(a, xs + mt * 16 * ldx + k0 + kk, ldx);
#pragma unroll
                for (int nt = 0; nt < 2; ++nt) {
                    wmma::mma_sync(acc[mt][nt], a, bh[nt], acc[mt][nt]);
                    if (SPLIT) wmma::mma_sync(acc[mt][nt], a, bl[nt], acc[mt][nt]);
                }
            }
        }
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
            wmma::store_matrix_sync(hs + mt * 16 * kLdH + warp * 32 + nt * 16, acc[mt][nt],
                                    kLdH, wmma::mem_row_major);
    __syncthreads();
}

// The tile's h_pre for storage T (bf16 or int8; see the function above).
template <typename T>
__device__ __forceinline__ void h_gemm(const typename Staged<T>::type* xs,
                                       const __nv_bfloat16* w1h, const __nv_bfloat16* w1l,
                                       void* ws, float* hs) {
    h_gemm_tc<sizeof(T) == 1>(xs, w1h, w1l, static_cast<__nv_bfloat16*>(ws), hs);
}

// ------------------------------------------------ f32 storage: split TF32

// The f32 kernels' tile and staging.  x [kMF][kLdXF] stays resident in
// shared memory for the whole tile (the A operand of h_pre, then the PV sum
// or g . x); W1 streams through a ring of 2 stages of kStageF bytes: the h
// product's slices hold kKF columns of D of all kHid rows ([kHid][kLdWF]),
// the dX product's hold kJF rows of hid by kD/2 columns ([kJF][kLdWJ]).
// Every stride below makes the 8 x 4 lanes of a fragment load hit 32
// distinct banks.
constexpr int kMF = Tile<float>::M;
constexpr int kLdXF = kD + kPadF;      // 516: A fragment rows g (4g + t)
constexpr int kKF = 32;                // D columns a slice of the h product (slice_3xtf32's depth)
constexpr int kLdWF = kKF + 4;         // 36: B fragment rows g (4g + t)
constexpr int kSlicesH = kD / kKF;     // 16
constexpr int kJF = 32;                // hid rows a slice of the dX product
constexpr int kHalfF = kD / 2;         // dX columns a half
constexpr int kLdWJ = kHalfF + 8;      // 264: B fragment rows t (8t + g)
constexpr int kLdZ = kHid + kPadF;     // 260: dz and tanh(h) rows, A fragments (4g + t)
constexpr size_t kStageF = round128((size_t)kHid * kLdWF * 4) > round128((size_t)kJF * kLdWJ * 4)
                               ? round128((size_t)kHid * kLdWF * 4)
                               : round128((size_t)kJF * kLdWJ * 4);  // 36,864
// warp layout of a [kMF, kHid] product (and of any 64 x 256 or 128 x 128
// tile): 2 x 4 (or 4 x 2) warps of 32 rows x 64 columns, MT x NT mma tiles
constexpr int kMT = 2;
constexpr int kNT = 8;

// One k-step of 8 of a warp's [16 kMT, 8 kNT] f32 product in split TF32:
// acc += A[0, 16 kMT)[k0, k0 + 8) . B[k0, k0 + 8)[0, 8 kNT), in three waves
// of kMT x kNT independent products, the small ones first: lo.hi, hi.lo,
// then hi.hi (one product's accumulator is not read back until kMT x kNT
// products later).  A is read from shared memory
// row-major (A[m][k] at a[m * lda + k]) or, A_KMAJOR, k-major (a[k * lda + m]);
// B n-major (B[k][n] at b[n * ldb + k]) or, B_KMAJOR, k-major (b[k * ldb + n]).
// Fragment layouts of m16n8k8 .tf32 (g = lane / 4, t = lane % 4): A a0..a3 =
// (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B b0, b1 = (k t, n g),
// (k t + 4, n g); C c0..c3 = (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
template <bool A_KMAJOR, bool B_KMAJOR>
__device__ __forceinline__ void kstep_3xtf32(float (&acc)[kMT][kNT][4], const float* a,
                                             int lda, const float* b, int ldb, int k0) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    uint32_t ah[kMT][4], al[kMT][4], bh[kNT][2], bl[kNT][2];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int m = 16 * mt + g + 8 * (i & 1), k = k0 + t + 4 * (i >> 1);
            split_tf32(A_KMAJOR ? a[k * lda + m] : a[m * lda + k], ah[mt][i], al[mt][i]);
        }
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int n = 8 * nt + g, k = k0 + t + 4 * i;
            split_tf32(B_KMAJOR ? b[k * ldb + n] : b[n * ldb + k], bh[nt][i], bl[nt][i]);
        }
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) mma_tf32(acc[mt][nt], al[mt], bh[nt]);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) mma_tf32(acc[mt][nt], ah[mt], bl[nt]);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) mma_tf32(acc[mt][nt], ah[mt], bh[nt]);
}

template <int MT, int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[MT][NT][4]) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
}

// acc += A[0, 16 kMT)[0, 32) . B[0, 32)[0, 8 kNT): four k-steps into a fresh
// accumulator, then added to acc on the CUDA cores.  The tensor cores' f32
// accumulation truncates the running sum's low bits at every product, an
// error that grows with the chain: chains of 12 products (4 k-steps x 3)
// keep it at ~12 ulp of a slice's sum, where one chain over a whole product
// (x . W1^T's 192, dW1's thousands) drifted on an H100 to ~1e-5 and ~2e-4
// relative (python -m vlsa_tpu_torch.ops.abmil_variants, `one_chain`).
template <bool A_KMAJOR, bool B_KMAJOR>
__device__ __forceinline__ void slice_3xtf32(float (&acc)[kMT][kNT][4], const float* a,
                                             int lda, const float* b, int ldb) {
    float part[kMT][kNT][4];
    zero_acc(part);
#pragma unroll
    for (int kk = 0; kk < 32; kk += 8) kstep_3xtf32<A_KMAJOR, B_KMAJOR>(part, a, lda, b, ldb, kk);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[mt][nt][i];
}

// cp.async of the columns [k0, k0 + kKF) of the tile's x rows [t0, t0 + kMF)
// of one bag (rows of kD f32) into xs [kMF][kLdXF]; rows at or past n_end are
// zero-filled.  Not committed.
__device__ __forceinline__ void load_x_cols(const float* __restrict__ xb, int t0, int n_end,
                                            float* xs, int k0) {
    constexpr int kVec = kKF / 4;
    for (int i = threadIdx.x; i < kMF * kVec; i += kThreads) {
        const int r = i / kVec, c = 4 * (i % kVec);
        const bool ok = t0 + r < n_end;
        cp_async16(xs + r * kLdXF + k0 + c, ok ? xb + (size_t)(t0 + r) * kD + k0 + c : xb, ok);
    }
}

// cp.async of W1 [kHid][kD] columns [k0, k0 + kKF) into a stage [kHid][kLdWF].
__device__ __forceinline__ void load_w1_cols(const float* __restrict__ w1, float* ws, int k0) {
    constexpr int kVec = kKF / 4;
    for (int i = threadIdx.x; i < kHid * kVec; i += kThreads) {
        const int j = i / kVec, c = 4 * (i % kVec);
        cp_async16(ws + j * kLdWF + c, w1 + (size_t)j * kD + k0 + c, true);
    }
}

// cp.async of slice s < 16 of the dX product's W1 stream into a stage
// [kJF][kLdWJ]: the hid rows [kJF (s % 8), +kJF) by the kD/2 columns of
// half s / 8.
__device__ __forceinline__ void load_w1_rows(const float* __restrict__ w1, float* ws, int s) {
    constexpr int kVec = kHalfF / 4;
    const float* src = w1 + (size_t)(kJF * (s % (kHid / kJF))) * kD + kHalfF * (s / (kHid / kJF));
    for (int i = threadIdx.x; i < kJF * kVec; i += kThreads) {
        const int j = i / kVec, c = 4 * (i % kVec);
        cp_async16(ws + j * kLdWJ + c, src + (size_t)j * kD + c, true);
    }
}

// acc = x . W1^T for the tile [t0, t0 + kMF) of one bag in split TF32: warp
// (wm = warp % 2, wn = warp / 2) owns rows [32 wm, +32) and hid columns
// [64 wn, +64).  x streams into xs column slice by slice beside W1's slices
// (x is resident in xs on return); W1 slice s lands in stage s % 2.  On
// entry W1's slice 0 must be committed into stage 0 (the caller issues it
// ahead, e.g. during the previous tile) and xs free.  At the last slice,
// when stage 0 is free again, `prefetch(stage0)` issues (and this function
// commits) whatever the caller streams next into stage 0.  On return all of
// xs has landed and is visible to every thread (the last slice's barrier);
// other warps may still be in their last products, so a caller synchronises
// before it overwrites xs or stage 1.
template <typename Prefetch>
__device__ __forceinline__ void h_product_f32(float (&acc)[kMT][kNT][4],
                                              const float* __restrict__ xb, int t0, int n_end,
                                              const float* __restrict__ w1, float* xs,
                                              float* stage0, Prefetch prefetch) {
    const int warp = threadIdx.x >> 5, wm = warp & 1, wn = warp >> 1;
    float* stage1 = stage0 + kStageF / 4;
    zero_acc(acc);
    load_x_cols(xb, t0, n_end, xs, 0);
    cp_async_commit();
    const float* xa = xs + 32 * wm * kLdXF;
#pragma unroll 1
    for (int s = 0; s < kSlicesH; ++s) {
        cp_async_wait<0>();
        __syncthreads();  // slice s landed for all; stage (s + 1) % 2 is consumed
        float* next = (s & 1) ? stage0 : stage1;
        if (s + 1 < kSlicesH) {
            load_x_cols(xb, t0, n_end, xs, kKF * (s + 1));
            load_w1_cols(w1, next, kKF * (s + 1));
        } else {
            prefetch(stage0);
        }
        cp_async_commit();
        const float* wb = ((s & 1) ? stage1 : stage0) + 64 * wn * kLdWF;
        slice_3xtf32<false, false>(acc, xa + kKF * s, kLdXF, wb, kLdWF);
    }
}

// From h_product_f32's accumulators: acc becomes tanh(acc + b1) in place,
// and each row's partial logit, the sum of tanh(h) * w2 over the warp's 64
// columns, goes to red[wn][row] ([4][kMF]; the row's logit is the sum of its
// 4 partials).  b1s, w2s: b1 and w2 [kHid] in shared memory.
__device__ __forceinline__ void tanh_logit_f32(float (&acc)[kMT][kNT][4], const float* b1s,
                                               const float* w2s, float* red) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3, wm = warp & 1, wn = warp >> 1;
    float part[kMT][2];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) part[mt][0] = part[mt][1] = 0.f;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
        const int j = 64 * wn + 8 * nt + 2 * t;
        const float b0 = b1s[j], b1v = b1s[j + 1], u0 = w2s[j], u1 = w2s[j + 1];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
            float* c = acc[mt][nt];
            c[0] = tanhf(c[0] + b0);
            c[1] = tanhf(c[1] + b1v);
            c[2] = tanhf(c[2] + b0);
            c[3] = tanhf(c[3] + b1v);
            part[mt][0] += c[0] * u0 + c[1] * u1;
            part[mt][1] += c[2] * u0 + c[3] * u1;
        }
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            float v = part[mt][h];
            v += __shfl_xor_sync(0xffffffffu, v, 1);
            v += __shfl_xor_sync(0xffffffffu, v, 2);
            if (t == 0) red[wn * kMF + 32 * wm + 16 * mt + 8 * h + g] = v;
        }
    }
}

// W1 f32 [n] -> its bf16 rounding hi and, when lo is given, the bf16
// rounding of the residual w - hi (bf16 and int8 storage).
__global__ void prep_w1(const float* __restrict__ w1, __nv_bfloat16* __restrict__ hi,
                        __nv_bfloat16* __restrict__ lo, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float w = w1[i];
    const __nv_bfloat16 h = __float2bfloat16(w);
    hi[i] = h;
    if (lo != nullptr) lo[i] = __float2bfloat16(w - __bfloat162float(h));
}

inline cudaError_t launch_prep_w1(const float* w1, __nv_bfloat16* w1_bf16, bool split,
                                  cudaStream_t stream) {
    const int n = kHid * kD;
    prep_w1<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        w1, w1_bf16, split ? w1_bf16 + n : nullptr, n);
    return cudaGetLastError();
}

}  // namespace abmil
