// Hopper warpgroup products (wgmma) on operands in 128-byte swizzled shared
// memory: the layout, the matrix descriptors and the fences; and the
// mbarriers and TMA loads that fill such operands.  Shared by the bf16 and
// int8 ABMIL forward (abmil_fwd.cu) and the bf16 streamed flash kernel
// (flash_attn_fwd.cu).  sm_90a only.
//
// A k-block [rows][128 B] stores 16-byte chunk c of row r at r * 128 +
// ((c ^ (r % 8)) << 4), from a 1024-byte aligned base: the layout the tensor
// cores read through a 128-byte swizzle descriptor (8-row groups 1024 bytes
// apart).  Read K-major (a row is one row of the operand, its 128 bytes the
// reduction axis), a k-step of 32 bytes (16 bf16 or 32 int8 values) is the
// descriptor's start advanced by 32 bytes within the span.  Read MN-major
// (16-bit operands only, the instruction's transpose flag: a row is one step
// of the reduction axis, its 64 values the operand's columns), a k-step of
// 16 rows is the start advanced by 2048 bytes.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace sm90 {

constexpr int kSpan = 128;        // bytes of a row: one 128-byte swizzle span
constexpr int kAtom = 8 * kSpan;  // 1024: 8 rows, the swizzle's period

__device__ __forceinline__ int sw128(int r, int c) { return r * kSpan + ((c ^ (r & 7)) << 4); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// K-major operand at p: start >> 4, leading byte offset 1 (unused: a k-step
// stays inside the span), stride byte offset 1024 (8-row groups), 128-byte
// swizzle.
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
    return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (1ull << 16)
           | ((uint64_t)(kAtom >> 4) << 32) | (1ull << 62);
}

// MN-major operand of 64 columns (one span) at p: the stride byte offset is
// 1024, between the groups of 8 rows of the reduction axis; the leading one,
// between 64-column spans, is unused at 64 columns and set to the same 1024.
__device__ __forceinline__ uint64_t desc_sw128_mn(const void* p) {
    return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(kAtom >> 4) << 16)
           | ((uint64_t)(kAtom >> 4) << 32) | (1ull << 62);
}

// Pin the accumulators' registers across an asynchronous wgmma (the
// compiler does not know that the instruction writes them later).
template <typename Acc, int N>
__device__ __forceinline__ void fence_acc(Acc (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
        if constexpr (std::is_integral<Acc>::value) {
            asm volatile("" : "+r"(d[i])::"memory");
        } else {
            asm volatile("" : "+f"(d[i])::"memory");
        }
    }
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// cp.async's writes (the generic proxy) made visible to wgmma's reads (the
// async proxy).
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- mbarriers and TMA loads (the tensor map built on the host by
// cuTensorMapEncodeTiled)

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
                 : "memory");
}
// The barriers' initialisation made visible to the other threads and to the
// async proxy (before the block's first barrier).
__device__ __forceinline__ void mbar_fence_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// One arrival that also expects `bytes` of transactions (the TMA loads that
// complete on this barrier).
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
                 "r"(bytes)
                 : "memory");
}
// Waits until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    asm volatile(
        "{\n.reg .pred done;\n"
        "WAIT_%=:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
        "@!done bra WAIT_%=;\n}\n" ::"r"(smem_addr(bar)),
        "r"(parity)
        : "memory");
}
// A 3-d box of the tensor map at p (a __grid_constant__ kernel parameter)
// at coordinates (c0, c1, c2) into shared memory at dst, completing on bar.
__device__ __forceinline__ void tma_load_3d(void* dst, const void* tmap, int c0, int c1, int c2,
                                            uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
        "l"(tmap), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
        : "memory");
}

}  // namespace sm90
