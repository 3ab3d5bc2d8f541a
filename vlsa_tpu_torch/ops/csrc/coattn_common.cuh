// Device helpers shared by the co-attention kernels (coattn_fwd.cu,
// coattn_bwd_dq.cu, coattn_bwd_dx.cu) and, through abmil_common.cuh, the
// ABMIL kernels: block shape, storage types, vector loads of x, warp
// reductions, the backward kernels' dq reduction, cp.async, ldmatrix, the
// bf16 mma.sync m16n8k16 and the split-TF32 mma.sync m16n8k8.
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid (src is
// then not read, but must be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(valid ? 16 : 0));
}
// The first `bytes` (0..16) of 16 bytes global -> shared, the rest zero-filled.
__device__ __forceinline__ void cp_async16_n(void* dst, const void* src, int bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(bytes));
}
// The first `bytes` (0..8) of 8 bytes global -> shared (8-byte aligned src).
__device__ __forceinline__ void cp_async8_n(void* dst, const void* src, int bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices from shared memory (lane l gives the address of row
// l % 8 of matrix l / 8); .trans delivers each transposed.
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p)));
}

// c += a . b on the bf16 tensor cores, f32 accumulation.  Fragments of
// m16n8k16 (g = lane / 4, t = lane % 4; two bf16 a register, the lower
// index in the low half): A a0..a3 = (g, 2t..), (g + 8, 2t..), (g, 2t + 8..),
// (g + 8, 2t + 8..); B b0, b1 = (k 2t.., n g), (k 2t + 8.., n g); C c0..c3 =
// (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as one bf16x2 register (round to nearest even; lo in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}
// The two bf16 of a register as floats.
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
    return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}
// v = hi + lo to ~16 bits: hi its bf16 rounding, lo that of the residual
// (vlsa_tpu/ops/coattn.py::_mm_rows's split).
__device__ __forceinline__ void split_bf16(float v, __nv_bfloat16& hi, __nv_bfloat16& lo) {
    hi = __float2bfloat16_rn(v);
    lo = __float2bfloat16_rn(v - __bfloat162float(hi));
}

// Split TF32 (f32 operands on the tensor cores): v = hi + lo, hi v rounded to
// TF32 (to nearest, ties away: the 13 low bits of the f32 rounded off, as
// cvt.rna.tf32.f32 does), lo = v - hi exactly, |lo| <= 2^-11 |v|.  lo goes to
// the tensor cores as its f32 bits, which they read as TF32 by ignoring the
// 13 low bits: lo is truncated there, ~2^-21 of v.  A product is then
// lo.hi + hi.lo + hi.hi, ~2^-21 relative against f32's 2^-24.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
    hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(v - __uint_as_float(hi));
}

// c += a . b on the TF32 tensor cores, f32 accumulation.  Fragments of
// m16n8k8 .tf32 (g = lane / 4, t = lane % 4): A a0..a3 = (g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4); B b0, b1 = (k t, n g), (k t + 4, n g); C as
// m16n8k16's.
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], const uint32_t b[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
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
