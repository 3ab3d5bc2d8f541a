// Device helpers shared by the co-attention kernels (coattn_fwd.cu,
// coattn_bwd_dq.cu): block shape, storage types, vector loads of x and warp
// reductions.
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

}  // namespace coattn
