// Device helpers shared by the co-attention kernels (coattn_fwd.cu and,
// through coattn_bwd.cuh, coattn_bwd_dq.cu and coattn_bwd_dx.cu) and,
// through abmil_common.cuh, the ABMIL kernels: block shape, storage types,
// warp reductions, cp.async, ldmatrix, the bf16 mma.sync m16n8k16 and the
// split-TF32 mma.sync m16n8k8; the per-warp x stream of the co-attention
// kernels (slice layout, cp.async staging, int8 planes, hi + lo fragments);

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace coattn {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// query groups of kRows rows a launch takes on the forward's and dQ's grid z:
// past it the caller launches the groups in chunks of this many, each with
// its first group's offset (any P)
constexpr int kMaxQueryGroups = 65535;
constexpr float kNegInf = -1e30f;

enum Storage { kF32 = 0, kBF16 = 1, kI8 = 2 };

__host__ __device__ inline int storage_itemsize(int storage) {
    return storage == kF32 ? 4 : storage == kBF16 ? 2 : 1;
}

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

// ---- the per-warp x stream of the forward and backward kernels ----

constexpr int kWarpCh = 64;                    // channels a warp owns
constexpr int kMaxWarps = 8;                   // warps a block
constexpr int kGroupCh = kWarpCh * kMaxWarps;  // 512: channels a block pools
// query rows of an mma tile: a query group.  P queries are ceil(P / 16)
// groups, the last zero-padded
constexpr int kRows = 16;
constexpr int kPlaneRow = kWarpCh * 2;         // bytes a row of a warp's bf16 plane

template <int ST> struct Store;
template <> struct Store<kF32> { using T = float; };
template <> struct Store<kBF16> { using T = __nv_bfloat16; };
template <> struct Store<kI8> { using T = int8_t; };

// Patches a tile: 64 for bf16 and int8; 32 for f32, whose slices are twice
// as large.
__host__ __device__ constexpr int tile_of(int storage) { return storage == kF32 ? 32 : 64; }
// Row stride (floats) of a block's [rows][tile] dot partials and of the bf16
// weights; f32 weights take tile + 4 (A fragment rows g at 4g + t: 32
// distinct banks).
__host__ __device__ constexpr int ld_of(int tile) { return tile + 8; }
// k-steps of q's A fragments over a warp's 64 channels: 8 of m16n8k8 (split
// TF32, f32 storage) or 4 of m16n8k16 (bf16 hi + lo).
__host__ __device__ constexpr int qsteps_of(int storage) { return storage == kF32 ? 8 : 4; }

__host__ __device__ constexpr int groups_of(int C) { return (C + kGroupCh - 1) / kGroupCh; }
__host__ __device__ constexpr int query_groups_of(int P) { return (P + kRows - 1) / kRows; }
__host__ __device__ constexpr int warps_of(int C) {
    return C > kGroupCh ? kMaxWarps : (C + kWarpCh - 1) / kWarpCh;
}

// Byte offset of 16-byte chunk c of row r of a slice: the chunk index is
// XORed with a function of the row, so that 8 rows at one chunk (ldmatrix,
// the int8 conversion) and 8 chunks of one row (cp.async) hit 8 distinct
// bank groups.  Rows are 256 (f32), 128 (bf16 and the planes) or 64 (int8)
// bytes.  f32's XOR, 2 (r % 4) + (r / 4) % 2, also makes the PV's B fragment
// loads (rows 4h + t, 8 columns g over two chunks) hit 32 distinct banks.
template <int ST>
__device__ __forceinline__ uint32_t slice_off(int r, int c) {
    if constexpr (ST == kF32) return r * 256 + ((c ^ (((r & 3) << 1) | ((r >> 2) & 1))) << 4);
    else if constexpr (ST == kBF16) return r * 128 + ((c ^ (r & 7)) << 4);
    else return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}
__device__ __forceinline__ uint32_t plane_off(int r, int c) { return slice_off<kBF16>(r, c); }

// cp.async of the warp's slice (channels [ch0, ch0 + 64)) of flat tile f
// (TT patches a tile) into a ring slot; rows past N and channels past C are
// zero-filled.  Not committed.
template <int ST, int TT = tile_of(ST)>
__device__ __forceinline__ void issue_tile(const void* x, int N, int C, int Tb, int f,
                                           unsigned char* slot, int ch0, int lane) {
    using T = typename Store<ST>::T;
    constexpr int kItem = sizeof(T);
    constexpr int kChunks = kWarpCh * kItem / 16;  // a row: f32 16, bf16 8, int8 4
    const int b = f / Tb, n0 = (f - b * Tb) * TT;
    const T* xb = static_cast<const T*>(x) + (size_t)b * N * C;
    const bool rows8 = kItem == 1 && (C & 15) != 0;  // int8 rows only 8-byte aligned
#pragma unroll 4
    for (int i = lane; i < TT * kChunks; i += 32) {
        const int r = i / kChunks, c = i % kChunks, n = n0 + r;
        const int ch = ch0 + c * (16 / kItem);
        const int bytes = n < N ? min(16, max(0, (C - ch) * kItem)) : 0;
        const T* src = bytes > 0 ? xb + (size_t)n * C + ch : static_cast<const T*>(x);
        unsigned char* dst = slot + slice_off<ST>(r, c);
        if (rows8) {
            cp_async8_n(dst, src, min(bytes, 8));
            cp_async8_n(dst + 8, bytes > 8 ? src + 8 : src, max(bytes - 8, 0));
        } else {
            cp_async16_n(dst, src, bytes);
        }
    }
}

// Row r of an int8 slice -> the bf16 plane (its exact values); returns the
// row's f32 sum of squares.
__device__ __forceinline__ float convert_row(const unsigned char* slot, unsigned char* plane,
                                             int r) {
    float sq = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        const int4 raw = *reinterpret_cast<const int4*>(slot + slice_off<kI8>(r, c));
        const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
        uint4 out[2];
        uint32_t* o = &out[0].x;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            const float v0 = v[2 * k], v1 = v[2 * k + 1];
            sq = fmaf(v0, v0, fmaf(v1, v1, sq));
            o[k] = pack_bf16(v0, v1);
        }
        *reinterpret_cast<uint4*>(plane + plane_off(r, 2 * c)) = out[0];
        *reinterpret_cast<uint4*>(plane + plane_off(r, 2 * c + 1)) = out[1];
    }
    return sq;
}

// Rows [0, 16) (zero past P) of an f32 [P, C] matrix (q, or a bag's g) at
// the channels [ch0, ch0 + 64) (zero past C) as hi + lo A fragments: TF32
// for m16n8k8 (f32 storage) or bf16 pairs for m16n8k16.
template <int ST>
__device__ __forceinline__ void load_frags(const float* __restrict__ q, int P, int C, int ch0,
                                       int lane, uint32_t (&qh)[qsteps_of(ST)][4],
                                       uint32_t (&ql)[qsteps_of(ST)][4]) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int ks = 0; ks < qsteps_of(ST); ++ks) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int p = g + 8 * (i & 1);
            if constexpr (ST == kF32) {
                const int c = ch0 + 8 * ks + t + 4 * (i >> 1);
                split_tf32(p < P && c < C ? q[(size_t)p * C + c] : 0.f, qh[ks][i], ql[ks][i]);
            } else {
                const int c = ch0 + 16 * ks + 2 * t + 8 * (i >> 1);
                float v0 = 0.f, v1 = 0.f;
                if (p < P && c < C) {  // C is a multiple of 8: so is c + 1 < C
                    v0 = q[(size_t)p * C + c];
                    v1 = q[(size_t)p * C + c + 1];
                }
                qh[ks][i] = pack_bf16(v0, v1);
                const float2 h = unpack_bf16(qh[ks][i]);
                ql[ks][i] = pack_bf16(v0 - h.x, v1 - h.y);
            }
        }
    }
}

// c += the three split-TF32 products of one m16n8k8 step, small ones first.
__device__ __forceinline__ void mma_3xtf32(float c[4], const uint32_t ah[4], const uint32_t al[4],
                                           const uint32_t bh[2], const uint32_t bl[2]) {
    mma_tf32(c, al, bh);
    mma_tf32(c, ah, bl);
    mma_tf32(c, ah, bh);
}

}  // namespace coattn
