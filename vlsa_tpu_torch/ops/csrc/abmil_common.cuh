// Device helpers shared by the ABMIL pooling kernels (abmil_fwd.cu,
// abmil_bwd.cu): widths, tile shapes, staging of a patch tile in shared
// memory, and the bottleneck product h_pre = x . W1^T of a tile on the
// tensor cores (bf16 and int8 storage) or on CUDA cores (f32 storage).
#pragma once

#include <mma.h>

#include "coattn_common.cuh"

namespace abmil {

using coattn::kBF16;
using coattn::kF32;
using coattn::kI8;
using coattn::kNegInf;
using coattn::storage_itemsize;
using coattn::to_float;
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
constexpr int kKf = 16;     // D columns of W1 per slice (f32, CUDA cores)

__host__ __device__ constexpr size_t round128(size_t n) { return (n + 127) / 128 * 128; }

// Patches per tile: 64 on the tensor cores, 32 for f32 storage (its tile
// holds twice the bytes and its product runs on CUDA cores).
template <typename T> struct Tile { static constexpr int M = 64; };
template <> struct Tile<float> { static constexpr int M = 32; };

// The tile's type in shared memory: int8 values are exact in bf16, so int8
// storage is staged as bf16 and multiplies on the bf16 tensor cores.
template <typename T> struct Staged { using type = __nv_bfloat16; };
template <> struct Staged<float> { using type = float; };

template <typename T> struct XLd {
    static constexpr int value = sizeof(typename Staged<T>::type) == 2 ? kD + kPadB : kD + kPadF;
};

template <typename T>
__host__ __device__ constexpr size_t x_tile_bytes() {
    return round128((size_t)Tile<T>::M * XLd<T>::value * sizeof(typename Staged<T>::type));
}

// Shared-memory bytes of the W1 staging buffer of `h_gemm`.
template <typename T>
__host__ __device__ constexpr size_t w_stage_bytes() {
    return sizeof(T) == 4 ? round128((size_t)kKf * (kHid + 1) * 4)
                          : round128((size_t)(sizeof(T) == 1 ? 2 : 1) * kHid * (kKs + kPadB) * 2);
}

// Copy the patches [t0, t0 + M) of one bag (x rows of kD values) into xs,
// zeroing the rows at or past n_end.  16-byte loads; int8 becomes bf16.
__device__ __forceinline__ void stage_x(const float* xb, int t0, int n_end, float* xs,
                                        int tile_m) {
    constexpr int kVec = kD / 4;
    constexpr int ld = kD + kPadF;
    for (int i = threadIdx.x; i < tile_m * kVec; i += kThreads) {
        const int r = i / kVec, c = i % kVec;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (t0 + r < n_end) v = reinterpret_cast<const float4*>(xb + (size_t)(t0 + r) * kD)[c];
        reinterpret_cast<float4*>(xs + (size_t)r * ld)[c] = v;
    }
}
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

// The same product in true f32 on CUDA cores for a tile of 32 rows: thread
// (warp w, lane) owns rows 4w..4w+3 and columns lane + 32c, c < 8.  W1 f32
// [kHid, kD] is staged transposed in slices of kKf columns of D ([kKf][kHid+1]:
// the +1 spreads the transposing writes over the banks).
__device__ void h_gemm_f32(const float* xs, const float* __restrict__ w1, float* ws,
                           float* hs) {
    constexpr int ldx = kD + kPadF;
    constexpr int ldw = kHid + 1;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
    for (int k0 = 0; k0 < kD; k0 += kKf) {
        __syncthreads();
        for (int i = threadIdx.x; i < kHid * kKf; i += kThreads) {
            const int j = i / kKf, kk = i % kKf;
            ws[kk * ldw + j] = w1[(size_t)j * kD + k0 + kk];
        }
        __syncthreads();
#pragma unroll 4
        for (int kk = 0; kk < kKf; ++kk) {
            float xv[4], wv[8];
#pragma unroll
            for (int i = 0; i < 4; ++i) xv[i] = xs[(warp * 4 + i) * ldx + k0 + kk];
#pragma unroll
            for (int c = 0; c < 8; ++c) wv[c] = ws[kk * ldw + lane + 32 * c];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(xv[i], wv[c], acc[i][c]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) hs[(warp * 4 + i) * kLdH + lane + 32 * c] = acc[i][c];
    __syncthreads();
}

// The tile's h_pre for storage T (see the two functions above).
template <typename T>
__device__ __forceinline__ void h_gemm(const typename Staged<T>::type* xs, const float* w1,
                                       const __nv_bfloat16* w1h, const __nv_bfloat16* w1l,
                                       void* ws, float* hs) {
    if constexpr (sizeof(T) == 4) {
        h_gemm_f32(xs, w1, static_cast<float*>(ws), hs);
    } else {
        h_gemm_tc<sizeof(T) == 1>(xs, w1h, w1l, static_cast<__nv_bfloat16*>(ws), hs);
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
