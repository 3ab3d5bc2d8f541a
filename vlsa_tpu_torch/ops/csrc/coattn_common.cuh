// Device helpers shared by the co-attention kernels (coattn_fwd.cu,
// coattn_bwd_dq.cu, coattn_bwd_dx.cu): block shape, storage types, vector
// loads of x, warp reductions and the backward kernels' dq reduction.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace coattn {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;     // patches per tile: one lane per patch
constexpr int kMaxP = 16;     // queries a launch takes
constexpr float kNegInf = -1e30f;

enum Storage { kF32 = 0, kBF16 = 1, kI8 = 2 };

__host__ __device__ inline int storage_itemsize(int storage) {
    return storage == kF32 ? 4 : storage == kBF16 ? 2 : 1;
}

// Four consecutive storage values -> float.
__device__ __forceinline__ void load4(const float* p, float v[4]) {
    float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
    uint2 t = *reinterpret_cast<const uint2*>(p);
    __nv_bfloat162 a = *reinterpret_cast<__nv_bfloat162*>(&t.x);
    __nv_bfloat162 b = *reinterpret_cast<__nv_bfloat162*>(&t.y);
    float2 fa = __bfloat1622float2(a);
    float2 fb = __bfloat1622float2(b);
    v[0] = fa.x; v[1] = fa.y; v[2] = fb.x; v[3] = fb.y;
}
__device__ __forceinline__ void load4(const int8_t* p, float v[4]) {
    char4 t = *reinterpret_cast<const char4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

// Four raw storage values in one load (for the shared-memory tile).
template <typename T> struct Raw4;
template <> struct Raw4<float> { using type = float4; };
template <> struct Raw4<__nv_bfloat16> { using type = uint2; };
template <> struct Raw4<int8_t> { using type = char4; };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(int8_t v) { return static_cast<float>(v); }

// Sixteen bytes of float storage values in one load or store: 4 f32 or 8 bf16.
template <typename T> struct Vec16;
template <> struct Vec16<float> { using raw = float4; static constexpr int n = 4; };
template <> struct Vec16<__nv_bfloat16> { using raw = uint4; static constexpr int n = 8; };

__device__ __forceinline__ void unpack(const float4& r, float v[4]) {
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
}
__device__ __forceinline__ void unpack(const uint4& r, float v[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
    }
}
__device__ __forceinline__ void pack(const float v[4], float4& r) {
    r = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void pack(const float v[8], uint4& r) {
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
}

// v rounded to the storage type T and back (round to nearest even).
template <typename T> __device__ __forceinline__ float round_as(float v);
template <> __device__ __forceinline__ float round_as<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_as<__nv_bfloat16>(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

// dq[i] = scale * sum_k ws_dq[k][i] over the K = B*S per-block partials of a
// backward kernel, k in order: deterministic, no atomics.
__global__ void __launch_bounds__(kThreads)
dq_reduce(const float* __restrict__ ws_dq, int K, int PC, float scale,
          float* __restrict__ dq) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= PC) return;
    float s = 0.f;
    for (int k = 0; k < K; ++k) s += ws_dq[(size_t)k * PC + i];
    dq[i] = scale * s;
}

inline cudaError_t launch_dq_reduce(const float* ws_dq, int K, int PC, float scale,
                                    float* dq, cudaStream_t stream) {
    dq_reduce<<<(PC + kThreads - 1) / kThreads, kThreads, 0, stream>>>(ws_dq, K, PC,
                                                                       scale, dq);
    return cudaGetLastError();
}

}  // namespace coattn
