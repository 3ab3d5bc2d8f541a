// Device helpers shared by the ABMIL pooling kernels (abmil_fwd.cu,
// abmil_bwd.cu): widths, tile shapes, and the bottleneck product h_pre =
// x . W1^T of a tile on the tensor cores through mma.sync, the product's
// accumulators held in registers: bf16 operands (m16n8k16; the backward's
// bf16 and int8 storage, int8 as an exact bf16 plane against W1's bf16 hi
// and lo), or split TF32 (m16n8k8; f32 storage: each f32 operand a is a_hi
// + a_lo, both TF32, and a product is lo.hi + hi.lo + hi.hi, ~2^-21
// relative per product against f32's 2^-24).  cp.async streams the
// operands.  (The bf16 and int8 forward runs its product on wgmma:
// abmil_fwd.cu.)
#pragma once

#include "coattn_common.cuh"

namespace abmil {

using coattn::cp_async16;
using coattn::cp_async16_n;
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

__host__ __device__ constexpr size_t round128(size_t n) { return (n + 127) / 128 * 128; }

// Copy the patches [t0, t0 + M) of one bag of int8 rows (kD values) into xs
// as bf16 (exact), zeroing the rows at or past n_end.  16-byte loads.
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

// ------------------------------------------------ f32 storage: split TF32

// The f32 kernels' tile and staging.  x [kMF][kLdXF] stays resident in
// shared memory for the whole tile (the A operand of h_pre, then the PV sum
// or g . x); W1 streams through a ring of 2 stages of kStageF bytes: the h
// product's slices hold kKF columns of D of all kHid rows ([kHid][kLdWF]),
// the dX product's hold kJF rows of hid by kD/2 columns ([kJF][kLdWJ]).
// Every stride below makes the 8 x 4 lanes of a fragment load hit 32
// distinct banks.
constexpr int kMF = 64;                // patches a tile (f32; every storage's backward pass 1)
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

// One k-step of 8 of a warp's [16 kMT, 8 NT] f32 product in split TF32 (NT
// n8 tiles: kNT for the D=512, hid=256 instances, fewer in the general ones):
// acc += A[0, 16 kMT)[k0, k0 + 8) . B[k0, k0 + 8)[0, 8 kNT), in three waves
// of kMT x kNT independent products, the small ones first: lo.hi, hi.lo,
// then hi.hi (one product's accumulator is not read back until kMT x kNT
// products later).  A is read from shared memory
// row-major (A[m][k] at a[m * lda + k]) or, A_KMAJOR, k-major (a[k * lda + m]);
// B n-major (B[k][n] at b[n * ldb + k]) or, B_KMAJOR, k-major (b[k * ldb + n]).
// Fragment layouts of m16n8k8 .tf32 (g = lane / 4, t = lane % 4): A a0..a3 =
// (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B b0, b1 = (k t, n g),
// (k t + 4, n g); C c0..c3 = (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
template <bool A_KMAJOR, bool B_KMAJOR, int NT = kNT>
__device__ __forceinline__ void kstep_3xtf32(float (&acc)[kMT][NT][4], const float* a,
                                             int lda, const float* b, int ldb, int k0) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    uint32_t ah[kMT][4], al[kMT][4], bh[NT][2], bl[NT][2];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int m = 16 * mt + g + 8 * (i & 1), k = k0 + t + 4 * (i >> 1);
            split_tf32(A_KMAJOR ? a[k * lda + m] : a[m * lda + k], ah[mt][i], al[mt][i]);
        }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int n = 8 * nt + g, k = k0 + t + 4 * i;
            split_tf32(B_KMAJOR ? b[k * ldb + n] : b[n * ldb + k], bh[nt][i], bl[nt][i]);
        }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) mma_tf32(acc[mt][nt], al[mt], bh[nt]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) mma_tf32(acc[mt][nt], ah[mt], bl[nt]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
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
template <bool A_KMAJOR, bool B_KMAJOR, int NT = kNT>
__device__ __forceinline__ void slice_3xtf32(float (&acc)[kMT][NT][4], const float* a,
                                             int lda, const float* b, int ldb) {
    float part[kMT][NT][4];
    zero_acc(part);
#pragma unroll
    for (int kk = 0; kk < 32; kk += 8) kstep_3xtf32<A_KMAJOR, B_KMAJOR, NT>(part, a, lda, b, ldb, kk);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
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

// ------------------------------------------------ bf16 and int8 storage: the backward's h product
//
// acc = x . W1^T for a tile of 32 MT patches of one bag (the backward's pass
// 1: 64) on mma.sync, 8 warps: warp (wm = warp % 2, wn = warp / 2) owns
// rows [16 MT wm, +16 MT) and hid columns [64 wn, +64), MT x kNT
// accumulator tiles of m16n8 in registers.  The x tile stays
// resident in shared memory (the A operand, then the PV sum's or g . x's
// rows); W1 streams through a ring of NS cp.async stages, one slice a
// stage, kSlicesQ = 8 slices a tile, one barrier a slice.  A slice is
// kSliceB = 128 bytes of every row: bf16 x's and W1's columns [64 s, +64),
// which land side by side.  (64-byte slices, twice the barriers, measured
// slower in a forward on this product: PERF.md.)  The operations (HOp):
//   kBf16:      bf16 x and W1 (bf16 storage), one product;
//   kBf16Split: int8 x staged as bf16 (exact) by plain loads before the
//               first slice, W1 as bf16 hi and lo in one stage, two products
//               into one f32 accumulator (W1 to ~16 bits).
enum class HOp { kBf16, kBf16Split };

constexpr int kSliceB = 128;                // bytes of a row a slice holds
constexpr int kSlicesQ = 2 * kD / kSliceB;  // 8: slices of a tile's h product
constexpr int kLdWS = kSliceB + 16;         // 144: a W1 slice row's bytes (8 rows, 8 bank groups)
constexpr size_t kStageS = (size_t)kHid * kLdWS;  // 36,864: a W1 slice (one plane)
constexpr int kLdX16 = (kD + kPadB) * 2;    // 1040: a bf16 x tile row's bytes

template <HOp OP> __host__ __device__ constexpr size_t stage_bytes() {
    return (OP == HOp::kBf16Split ? 2 : 1) * kStageS;
}

// cp.async of x's slice s (kSliceB bytes of each of the tile's 32 MT rows
// [t0, t0 + 32 MT) of one bag) into xs; rows at or past n_end are zero-filled.
// Not committed.
template <int MT>
__device__ __forceinline__ void load_x_slice(const __nv_bfloat16* __restrict__ xb, int t0,
                                             int n_end, unsigned char* xs, int s) {
    constexpr int kRow = 2 * kD;  // a row's bytes in device memory
    const unsigned char* src = reinterpret_cast<const unsigned char*>(xb);
    for (int i = threadIdx.x; i < 32 * MT * (kSliceB / 16); i += kThreads) {
        const int r = i / (kSliceB / 16), c = kSliceB * s + 16 * (i % (kSliceB / 16));
        const bool ok = t0 + r < n_end;
        cp_async16(xs + r * kLdX16 + c, ok ? src + (size_t)(t0 + r) * kRow + c : src, ok);
    }
}

// cp.async of W1's slice s, all kHid rows, into a stage [kHid][kLdWS bytes]:
// the bf16 columns [64 s, +64) of w1h and (kBf16Split), kStageS bytes on,
// of w1l.  Not committed.
template <HOp OP>
__device__ __forceinline__ void load_w1_slice(const __nv_bfloat16* __restrict__ w1h,
                                              const __nv_bfloat16* __restrict__ w1l,
                                              unsigned char* st, int s) {
    constexpr int kRow = 2 * kD;
    const unsigned char* hi = reinterpret_cast<const unsigned char*>(w1h);
    const unsigned char* lo = reinterpret_cast<const unsigned char*>(w1l);
    const int c0 = kSliceB * s;
    for (int i = threadIdx.x; i < kHid * (kSliceB / 16); i += kThreads) {
        const int j = i / (kSliceB / 16), c = 16 * (i % (kSliceB / 16));
        cp_async16(st + j * kLdWS + c, hi + (size_t)j * kRow + c0 + c, true);
        if (OP == HOp::kBf16Split) {
            cp_async16(st + kStageS + j * kLdWS + c, lo + (size_t)j * kRow + c0 + c, true);
        }
    }
}

// acc = x . W1^T of the tile [t0, t0 + 32 MT) of one bag (see above).  W1's
// slice s lands in stage s % NS of `stages` (stage_bytes<OP>() apart), x's
// in xs (row stride kLdX16 bytes).  On entry W1's slices [0, PRE) must be
// committed into their stages (the previous tile's `next`, or the caller
// before the first tile), and xs and the other stages free: the caller
// synchronises after its last read of them.  The last NS - 1 iterations
// each call `next(q, stage)`, q = 0 .. NS - 2, with the stage that slice
// kSlicesQ + q would take, to issue what the caller streams next (the next
// tile's slice q, say); this function commits it.  On return all of xs has
// landed and is visible to every thread; other warps may still be in their
// last products, so a caller synchronises before it overwrites xs or the
// last slice's stage.
template <HOp OP, int MT, int NS, int PRE, typename T, typename Next>
__device__ __forceinline__ void h_product(float (&acc)[MT][kNT][4], const T* __restrict__ xb,
                                          int t0, int n_end,
                                          const __nv_bfloat16* __restrict__ w1h,
                                          const __nv_bfloat16* __restrict__ w1l,
                                          unsigned char* xs, unsigned char* stages, Next next) {
    static_assert(kSlicesQ % NS == 0 && 0 <= PRE && PRE < NS, "slice s lives in stage s % NS");
    constexpr int kLdX = kLdX16;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, wm = warp & 1, wn = warp >> 1;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
    // the first NS - 1 slices: W1's not yet issued and x's (kBf16Split: the
    // whole tile, as bf16), one group
#pragma unroll
    for (int q = PRE; q < NS - 1; ++q) {
        load_w1_slice<OP>(w1h, w1l, stages + q * stage_bytes<OP>(), q);
    }
    if constexpr (OP == HOp::kBf16Split) {
        stage_x(xb, t0, n_end, reinterpret_cast<__nv_bfloat16*>(xs), 32 * MT);
    } else {
#pragma unroll
        for (int q = 0; q < NS - 1; ++q) load_x_slice<MT>(xb, t0, n_end, xs, q);
    }
    cp_async_commit();
    // ldmatrix row addresses: A (x rows) and B (W1 rows = hid columns)
    const unsigned char* xa =
        xs + (16 * MT * wm + (lane & 7) + 8 * ((lane >> 3) & 1)) * kLdX + 16 * (lane >> 4);
    const int bo = (64 * wn + (lane & 7) + 8 * (lane >> 4)) * kLdWS + 16 * ((lane >> 3) & 1);
#pragma unroll 1
    for (int s = 0; s < kSlicesQ; ++s) {
        // slice s landed (at s = 0 all that the prologue and PRE issued);
        // after the barrier, for all threads, and the stage of slice s - 1
        // is consumed
        if (s == 0) {
            cp_async_wait<0>();
        } else {
            cp_async_wait<NS - 2>();
        }
        __syncthreads();
        const int q = s + NS - 1;  // the slice this iteration issues
        unsigned char* st = stages + (q % NS) * stage_bytes<OP>();
        if (q < kSlicesQ) {
            load_w1_slice<OP>(w1h, w1l, st, q);
            if constexpr (OP == HOp::kBf16) load_x_slice<MT>(xb, t0, n_end, xs, q);
        } else {
            next(q - kSlicesQ, st);
        }
        cp_async_commit();
        const unsigned char* wb = stages + (s % NS) * stage_bytes<OP>() + bo;
        const unsigned char* xk = xa + kSliceB * s;
#pragma unroll
        for (int ks = 0; ks < kSliceB / 32; ++ks) {  // k-steps of 32 bytes
            uint32_t a[MT][4];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) ldsm_x4(a[mt], xk + 16 * mt * kLdX + 32 * ks);
#pragma unroll
            for (int part = 0; part < (OP == HOp::kBf16Split ? 2 : 1); ++part) {  // hi, (lo)
#pragma unroll
                for (int np = 0; np < kNT / 2; ++np) {
                    uint32_t bw[4];
                    ldsm_x4(bw, wb + part * kStageS + 16 * np * kLdWS + 32 * ks);
#pragma unroll
                    for (int mt = 0; mt < MT; ++mt) {
                        mma_bf16(acc[mt][2 * np], a[mt], bw[0], bw[1]);
                        mma_bf16(acc[mt][2 * np + 1], a[mt], bw[2], bw[3]);
                    }
                }
            }
        }
    }
}

// Entry i of W1 laid out [rows][ld] from W1 [hid, D] f32: zero past hid
// rows and past D columns (the general instances' padded workspaces; at ld =
// D and rows = hid, W1 itself).
__device__ __forceinline__ float w1_at(const float* __restrict__ w1, size_t i, int hid, int D,
                                       int ld) {
    const int j = (int)(i / ld), k = (int)(i - (i / ld) * ld);
    return j < hid && k < D ? w1[(size_t)j * D + k] : 0.f;
}

// W1 -> its bf16 rounding hi [n = rows * ld] and, when lo is given, the bf16
// rounding of the residual w - hi (bf16 and int8 storage).
__global__ void prep_w1(const float* __restrict__ w1, __nv_bfloat16* __restrict__ hi,
                        __nv_bfloat16* __restrict__ lo, int hid, int D, int ld, size_t n) {
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float w = w1_at(w1, i, hid, D, ld);
    const __nv_bfloat16 h = __float2bfloat16(w);
    hi[i] = h;
    if (lo != nullptr) lo[i] = __float2bfloat16(w - __bfloat162float(h));
}

// W1 [hid, D] to bf16 in w1_bf16 [rows, ld] and, when split, the residual's
// bf16 rounding rows * ld entries on.
inline cudaError_t launch_prep_w1(const float* w1, __nv_bfloat16* w1_bf16, bool split, int hid,
                                  int D, int rows, int ld, cudaStream_t stream) {
    const size_t n = (size_t)rows * ld;
    prep_w1<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
        w1, w1_bf16, split ? w1_bf16 + n : nullptr, hid, D, ld, n);
    return cudaGetLastError();
}

// W1 [hid, D] f32 copied into out [rows, ld], zero-padded (f32 storage on
// the general instances).
__global__ void pad_w1(const float* __restrict__ w1, float* __restrict__ out, int hid, int D,
                       int ld, size_t n) {
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) out[i] = w1_at(w1, i, hid, D, ld);
}

// ------------------------------------------------ W1's int8 split (int8 storage)

constexpr int kAmaxBlocks = 64;  // partial maxima of |W1|

// Partial maxima of |W1| [n]: block k of kAmaxBlocks writes the max over its
// ceil(n / kAmaxBlocks) entries (fewer or none at the end) to part[k].  A max
// is exact in any order.
__global__ void __launch_bounds__(kThreads) w1_absmax(const float* __restrict__ w1, size_t n,
                                                      float* __restrict__ part) {
    const size_t per = (n + kAmaxBlocks - 1) / kAmaxBlocks;
    const size_t begin = blockIdx.x * per, end = min(n, begin + per);
    __shared__ float warp_m[kWarps];
    float m = 0.f;
    for (size_t i = begin + threadIdx.x; i < end; i += kThreads) m = fmaxf(m, fabsf(w1[i]));
    m = warp_max(m);
    if ((threadIdx.x & 31) == 0) warp_m[threadIdx.x >> 5] = m;
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int w = 1; w < kWarps; ++w) m = fmaxf(m, warp_m[w]);
        part[blockIdx.x] = m;
    }
}

// W1 split into int8 hi and lo as vlsa_tpu/ops/coattn.py::_mm_rows_i8 splits
// it (and ops/abmil.py::split_w1_i8): s_w = max(max|W1|, 1e-30) * (1/127),
// v = W1 * (1 / s_w), hi = round(v), lo = round((v - hi) * 254), ties to
// even, each operation rounded on its own (no fused multiply-add), laid out
// [rows, ld] with zeros past hid and D (w1_at: their hi and lo are 0, and
// they leave max|W1| as it is).  Every block takes the max of the partial
// maxima; block 0 writes s_w to scale[0].  One thread an entry of n.
__global__ void __launch_bounds__(kThreads) prep_w1_i8(const float* __restrict__ w1,
                                                       const float* __restrict__ part,
                                                       int8_t* __restrict__ hi,
                                                       int8_t* __restrict__ lo,
                                                       float* __restrict__ scale, int hid, int D,
                                                       int ld, size_t n) {
    static_assert(kAmaxBlocks == 64, "two partial maxima a lane");
    __shared__ float inv_s;
    if (threadIdx.x < 32) {
        const float m = warp_max(fmaxf(part[threadIdx.x], part[threadIdx.x + 32]));
        if (threadIdx.x == 0) {
            const float s = __fmul_rn(fmaxf(m, 1e-30f), (float)(1.0 / 127.0));
            inv_s = __fdiv_rn(1.f, s);
            if (blockIdx.x == 0) scale[0] = s;
        }
    }
    __syncthreads();
    const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
    if (i >= n) return;
    const float v = __fmul_rn(w1_at(w1, i, hid, D, ld), inv_s);
    const float h = rintf(v);
    hi[i] = static_cast<int8_t>(h);
    lo[i] = static_cast<int8_t>(rintf(__fmul_rn(__fsub_rn(v, h), 254.f)));
}

// W1 [hid, D] f32 -> hi, lo int8 [rows, ld] each (hi, then lo at hi + rows *
// ld) and scale [1 + kAmaxBlocks] f32: s_w, then the partial maxima.  Any
// hid and D (the partial maxima and the split cover every entry).
inline cudaError_t launch_split_w1_i8(const float* w1, int hid, int D, int rows, int ld,
                                      int8_t* hi, float* scale, cudaStream_t stream) {
    w1_absmax<<<kAmaxBlocks, kThreads, 0, stream>>>(w1, (size_t)hid * D, scale + 1);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const size_t n = (size_t)rows * ld;
    prep_w1_i8<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
        w1, scale + 1, hi, hi + n, scale, hid, D, ld, n);
    return cudaGetLastError();
}

// ------------------------------------------------ any width: the general instances
//
// The instances above are built for D = 512, hid = 256 (kD, kHid) and keep
// the x tile resident.  Every other width the pooling takes -- any D >= 1
// and hid >= 1, as the TPU kernels, which tile only N, take any -- and
// bf16's precise mode go to the general instances: tiles of kGenM = 64
// patches, x never resident.  W1 reaches them as a workspace laid out
// [hid_p, ld] in the product's operand type, zero past hid and D (hid_p =
// gen_hid_pad(hid), ld = gen_ld(D); f32 at a width that needs no padding
// reads W1 itself): a padded column j has W1_j = 0, b1_j = 0 and w2_j = 0, so
// it adds tanh(0) * 0 = 0 to a logit and its dz is 0, and int8's s_w =
// max|W1| / 127 is that of W1.  The h product streams x's and W1's slices
// of kSB bytes a row through 2 cp.async stages, in passes of HP hid columns
// (hid_p = npass HP): the logit is separable over hid, sum_j tanh(h_pre_j +
// b1_j) w2_j, so each pass folds its columns into the row's logit before the
// next re-streams the tile's x slices (from L2: the tile was just read).  A
// block keeps b1 and w2 of all hid_p columns (and the backward's column
// sums) in shared memory up to hid_p = kSmemHid, and past that only the
// pass's HP values of b1 and w2 (loaded at each pass), the column sums in
// device memory; D's vectors (the forward's PV sums, the backward's g) stay
// in shared memory up to kSmemD channels and past that are read and written
// in device memory (L2), each value by one thread.  So no width is refused,
// and the widths that fit keep their shared-memory layout.  x's
// rows (D values, not padded) end in a slice whose tail is zero-filled;
// rows that are not 16-byte aligned (D * item not a multiple of 16) are
// copied into the stages by plain loads of one value each (copy16).  8
// warps, 2 x 4: warp (wm, wn) owns rows [32 wm, +32) and columns [HP/4 wn,
// +HP/4), NT = HP/32 n8 tiles of m16n8 accumulators a thread.  The products
// (GOp):
//   kF32:   split TF32, mma.sync m16n8k8 (slice_3xtf32), slices of 32 columns;
//   kBf16:  bf16 x by W1 rounded to bf16, mma.sync m16n8k16 by ldmatrix;
//   kBf16P: precise mode (vlsa_tpu/ops/abmil.py:74-97): W1 as bf16 hi + lo,
//           two products into one f32 accumulator;
//   kI8:    raw int8 x by W1's int8 hi and lo (launch_split_w1_i8), mma.sync
//           m16n8k32 into int32 P_hi and P_lo, then h_unit = s_w (P_hi +
//           P_lo / 254), as ops/abmil.py::abmil_fwd_rounded; slices of 64
//           bytes, HP <= 128 (two accumulators).  |P| <= D * 128 * 127 is
//           exact in int32 up to D = 132,104; past that it wraps, as
//           vlsa_tpu's own int32 product does (vlsa_tpu/ops/coattn.py:214).
constexpr int kGenM = 64;
constexpr int kSmemD = 8192;      // the widest D whose vectors a block keeps in shared memory
constexpr int kSmemHid = 1024;    // the widest hid_p whose vectors a block keeps there
constexpr int kSmemOptin = 232448;  // an H100 block's dynamic shared memory

enum class GOp { kF32, kBf16, kBf16P, kI8 };

// (D, hid) a width the kernels take (ops/abmil.py::kernel_widths_ok): any.
inline bool widths_ok(int D, int hid) { return D >= 1 && hid >= 1; }

// D's vectors in shared memory (D <= kSmemD), else in device memory.
__host__ __device__ constexpr bool d_in_smem(int D) { return D <= kSmemD; }

// b1, w2 (and the backward's column sums) of all hid_p columns in shared
// memory (hid_p <= kSmemHid), else a pass's b1 and w2 at a time.
__host__ __device__ constexpr bool hid_in_smem(int hid_p) { return hid_p <= kSmemHid; }

// The D = 512, hid = 256 instances take a call (every storage at that width
// but bf16 in precise mode); else the general ones.
inline bool special_widths(int storage, int D, int hid, bool precise) {
    return D == kD && hid == kHid && !(storage == kBF16 && precise);
}

inline GOp gen_op(int storage, bool precise) {
    if (storage == kF32) return GOp::kF32;
    if (storage == kI8) return GOp::kI8;
    return precise ? GOp::kBf16P : GOp::kBf16;
}

// The general instances' W1 rows (hid padded to a multiple of 64) and row
// length (D padded to a multiple of 64: every slice of W1 is whole).
__host__ __device__ inline int gen_hid_pad(int hid) { return (hid + 63) / 64 * 64; }
__host__ __device__ inline int gen_ld(int D) { return (D + 63) / 64 * 64; }

// The widest pass (hid columns) of a general instance: f32 256; int8 128,
// for its two accumulators; bf16 and its precise mode 64, as each mma's
// products are added into the accumulators on their own (gen_h_product), in
// registers that wider passes do not have.
__host__ __device__ constexpr int gen_max_pass(GOp op) {
    return op == GOp::kF32 ? 256 : (op == GOp::kI8 ? 128 : 64);
}

// The hid columns a pass of a general instance takes: the widest of 256,
// 128, 64 up to the storage's gen_max_pass that divides hid_p.
inline int gen_pass_cols(int storage, int hid) {
    const int hp = gen_hid_pad(hid), widest = gen_max_pass(gen_op(storage, false));
    if (widest >= 256 && hp % 256 == 0) return 256;
    return widest >= 128 && hp % 128 == 0 ? 128 : 64;
}

__host__ __device__ constexpr size_t round4(size_t n) { return (n + 3) / 4 * 4; }

template <GOp OP> __host__ __device__ constexpr int item_of() {
    return OP == GOp::kF32 ? 4 : (OP == GOp::kI8 ? 1 : 2);
}

// 16 bytes of a row that is not 16-byte aligned into shared memory: the
// first nb (0..16) from src by plain loads of one ITEM-byte value each (src
// aligned to ITEM; nothing read past nb), the rest zero.  (Aligned rows go
// by cp.async: a chunk then lies wholly inside or past a row.)
template <int ITEM>
__device__ __forceinline__ void copy16(void* dst, const unsigned char* src, int nb) {
    uint32_t w[4] = {0u, 0u, 0u, 0u};  // built by shifts: no byte addressing of registers
#pragma unroll
    for (int e = 0; e < 16; e += ITEM) {
        if (e < nb) {
            uint32_t v;
            if constexpr (ITEM == 4) {
                v = *reinterpret_cast<const uint32_t*>(src + e);
            } else if constexpr (ITEM == 2) {
                v = *reinterpret_cast<const uint16_t*>(src + e);
            } else {
                v = src[e];
            }
            w[e / 4] |= v << (8 * (e % 4));
        }
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// The bytes of a 16-byte chunk at byte `off` of a row of row_bytes: 0..16.
__device__ __forceinline__ int chunk_bytes(int row_bytes, int off) {
    return min(16, max(0, row_bytes - off));
}

template <GOp OP, int HP>
struct Gen {
    static constexpr bool F32 = OP == GOp::kF32;
    static constexpr bool I8 = OP == GOp::kI8;
    static constexpr int kItem = F32 ? 4 : (I8 ? 1 : 2);                // bytes a value of x, W1
    static constexpr int kParts = (OP == GOp::kBf16P || I8) ? 2 : 1;   // W1's planes
    static constexpr int kSB = I8 ? 64 : 128;  // bytes of a row a slice
    static constexpr int kLd = kSB + 16;       // a staged row's bytes: 8 rows, 8 bank groups
    static constexpr int NT = HP / 32;
    static constexpr size_t kX = (size_t)kGenM * kLd;  // the x rows of a stage
    static constexpr size_t kStage = round128(kX + (size_t)kParts * HP * kLd);
    static_assert(HP == 64 || HP == 128 || HP == 256, "a pass's columns");
    static_assert(HP <= gen_max_pass(OP), "a pass at most the op's widest (gen_max_pass)");
};

// c += a . b on the int8 tensor cores (m16n8k32, s32 accumulation); the
// fragments as m16n8k16's with four int8 a register: A a0..a3 = (g, 4t..),
// (g + 8, 4t..), (g, 4t + 16..), (g + 8, 4t + 16..); B b0, b1 = (k 4t.., n
// g), (k 4t + 16.., n g).
__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two values of a row as floats (f32, bf16 or int8 storage; p aligned to
// two values).
template <GOp OP>
__device__ __forceinline__ float2 load_pair(const unsigned char* p) {
    if constexpr (OP == GOp::kF32) {
        return *reinterpret_cast<const float2*>(p);
    } else if constexpr (OP == GOp::kI8) {
        const char2 v = *reinterpret_cast<const char2*>(p);
        return make_float2(static_cast<float>(v.x), static_cast<float>(v.y));
    } else {
        return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    }
}

// One value of a row as a float.
template <GOp OP>
__device__ __forceinline__ float load_one(const unsigned char* p) {
    if constexpr (OP == GOp::kF32) {
        return *reinterpret_cast<const float*>(p);
    } else if constexpr (OP == GOp::kI8) {
        return static_cast<float>(*reinterpret_cast<const int8_t*>(p));
    } else {
        return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
    }
}

// Values c and c + 1 (c even, c < D) of a row of D values; at an odd D (ODD)
// the rows are not aligned to two values, so they come one at a time, and
// value D (past the row) reads as 0.  The callers' loops take ODD as a
// template argument, one copy of the loop each, so that the even one stays
// as lean as before.
template <GOp OP, bool ODD>
__device__ __forceinline__ float2 load_pair_at(const unsigned char* row, int c, int D) {
    constexpr int I = item_of<OP>();
    if constexpr (!ODD) {
        return load_pair<OP>(row + (size_t)c * I);
    } else {
        return make_float2(load_one<OP>(row + (size_t)c * I),
                           c + 1 < D ? load_one<OP>(row + (size_t)(c + 1) * I) : 0.f);
    }
}

// c += a . b with the 16 products summed from zero and added to c in f32
// (add.f32, round to nearest), in one asm block so that the add follows its
// mma and the temporaries die there.
__device__ __forceinline__ void mma_bf16_add(float c[4], const uint32_t a[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "{\n"
        ".reg .f32 d0, d1, d2, d3, z;\n"
        "mov.f32 z, 0f00000000;\n"
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{d0, d1, d2, d3}, {%4, %5, %6, %7}, {%8, %9}, {z, z, z, z};\n"
        "add.f32 %0, %0, d0;\n"
        "add.f32 %1, %1, d1;\n"
        "add.f32 %2, %2, d2;\n"
        "add.f32 %3, %3, d3;\n"
        "}\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc = x[t0, t0 + 64) . W1[j0, j0 + HP)^T of one bag (xb: its rows of
// row_bytes = D * item; w1h, w1l: W1's planes, rows of w_bytes = ld * item,
// ld a multiple of 64), see the note above; sw: int8's s_w.  bf16 (and its
// precise mode): each mma's 16 products start from zero and are added into
// acc in f32, as the f32 plain version sums: the tensor cores' own
// accumulation truncates, and one chain over D put the dz of bf16 dW1 3.5-5
// times as often on the other side of a bf16 rounding as the plain version
// (chip_smoke.py: abmil_bf16_dw1_witness).  On entry both stages are free;
// on return too (a barrier ends it), with acc in registers.
template <GOp OP, int HP>
__device__ __forceinline__ void gen_h_product(float (&acc)[kMT][HP / 32][4],
                                              const unsigned char* __restrict__ xb, int t0,
                                              int n_end, int row_bytes, int w_bytes,
                                              const unsigned char* __restrict__ w1h,
                                              const unsigned char* __restrict__ w1l, int j0,
                                              float sw, unsigned char* stages) {
    using G = Gen<OP, HP>;
    constexpr int NT = G::NT;
    constexpr int kC = G::kSB / 16;  // 16-byte chunks of a row a slice
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, wm = warp & 1, wn = warp >> 1;
    const int slices = (row_bytes + G::kSB - 1) / G::kSB;
    const bool al = (row_bytes & 15) == 0;
    auto load = [&](int s, unsigned char* st) {
        const int c0 = s * G::kSB;
        if (al) {  // a chunk lies wholly inside or past its row
            for (int i = threadIdx.x; i < kGenM * kC; i += kThreads) {
                const int r = i / kC, c = 16 * (i % kC);
                const bool ok = t0 + r < n_end && c0 + c < row_bytes;
                cp_async16(st + r * G::kLd + c,
                           ok ? xb + (size_t)(t0 + r) * row_bytes + c0 + c : xb, ok);
            }
        } else {
            for (int i = threadIdx.x; i < kGenM * kC; i += kThreads) {
                const int r = i / kC, c = 16 * (i % kC);
                const int nb = t0 + r < n_end ? chunk_bytes(row_bytes, c0 + c) : 0;
                copy16<G::kItem>(st + r * G::kLd + c, xb + (size_t)(t0 + r) * row_bytes + c0 + c,
                                 nb);
            }
        }
        for (int i = threadIdx.x; i < HP * kC; i += kThreads) {
            const int j = i / kC, c = 16 * (i % kC);
            const size_t off = (size_t)(j0 + j) * w_bytes + c0 + c;
            unsigned char* dst = st + G::kX + j * G::kLd + c;
            cp_async16(dst, w1h + off, true);
            if constexpr (G::kParts == 2) cp_async16(dst + HP * G::kLd, w1l + off, true);
        }
    };
    int ph[kMT][NT][4], pl[kMT][NT][4];  // int8: P_hi, P_lo
    zero_acc(acc);
    if constexpr (G::I8) {
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int i = 0; i < 4; ++i) ph[mt][nt][i] = pl[mt][nt][i] = 0;
    }
    load(0, stages);
    cp_async_commit();
    // ldmatrix row addresses (bf16, int8): A the x rows, B the W1 rows
    const int xo = (32 * wm + (lane & 7) + 8 * ((lane >> 3) & 1)) * G::kLd + 16 * (lane >> 4);
    const int wo = (int)G::kX + ((HP / 4) * wn + (lane & 7) + 8 * (lane >> 4)) * G::kLd +
                   16 * ((lane >> 3) & 1);
#pragma unroll 1
    for (int s = 0; s < slices; ++s) {
        cp_async_wait<0>();
        __syncthreads();  // slice s landed for all; the other stage's slice s - 1 is consumed
        if (s + 1 < slices) load(s + 1, stages + ((s + 1) & 1) * G::kStage);
        cp_async_commit();
        const unsigned char* st = stages + (s & 1) * G::kStage;
        if constexpr (G::F32) {
            slice_3xtf32<false, false, NT>(
                acc, reinterpret_cast<const float*>(st + 32 * wm * G::kLd), G::kLd / 4,
                reinterpret_cast<const float*>(st + G::kX + (HP / 4) * wn * G::kLd), G::kLd / 4);
        } else {
#pragma unroll
            for (int ks = 0; ks < G::kSB / 32; ++ks) {  // k-steps of 32 bytes
                uint32_t a[kMT][4];
#pragma unroll
                for (int mt = 0; mt < kMT; ++mt) ldsm_x4(a[mt], st + xo + 16 * mt * G::kLd + 32 * ks);
#pragma unroll
                for (int part = 0; part < G::kParts; ++part) {
#pragma unroll
                    for (int np = 0; np < NT / 2; ++np) {
                        uint32_t bw[4];
                        ldsm_x4(bw, st + wo + part * HP * G::kLd + 16 * np * G::kLd + 32 * ks);
#pragma unroll
                        for (int mt = 0; mt < kMT; ++mt) {
                            if constexpr (G::I8) {
                                if (part == 0) {
                                    mma_s8(ph[mt][2 * np], a[mt], bw[0], bw[1]);
                                    mma_s8(ph[mt][2 * np + 1], a[mt], bw[2], bw[3]);
                                } else {
                                    mma_s8(pl[mt][2 * np], a[mt], bw[0], bw[1]);
                                    mma_s8(pl[mt][2 * np + 1], a[mt], bw[2], bw[3]);
                                }
                            } else {
                                mma_bf16_add(acc[mt][2 * np], a[mt], bw[0], bw[1]);
                                mma_bf16_add(acc[mt][2 * np + 1], a[mt], bw[2], bw[3]);
                            }
                        }
                    }
                }
            }
        }
    }
    __syncthreads();  // every warp is done with both stages
    if constexpr (G::I8) {
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    acc[mt][nt][i] = sw * (static_cast<float>(ph[mt][nt][i]) +
                                           static_cast<float>(pl[mt][nt][i]) * (1.f / 254.f));
                }
    }
}

// From gen_h_product's accumulators (pass columns from j0): acc becomes
// tanh(s_r acc + b1) in place (s_r the row's dequant scale from rs, int8;
// else 1), and each row's partial logit over the warp's columns goes to
// red[wn][row] ([4][kGenM]).  b1s, w2s: b1 and w2 in shared memory, column
// j0 + j at index j0 + j (all hid_p columns held), or at j (the pass's own
// slices, passed with j0 = 0).
// The pass's columns [j0, j0 + HP) of b1 and w2 into b1s, w2s [HP] (zero
// past hid).  The caller synchronises before they are read, and after the
// last read of the previous pass's.
template <int HP>
__device__ __forceinline__ void stage_pass_vecs(const float* __restrict__ b1,
                                                const float* __restrict__ w2, int hid, int j0,
                                                float* b1s, float* w2s) {
    for (int j = threadIdx.x; j < HP; j += kThreads) {
        const bool ok = j0 + j < hid;
        b1s[j] = ok ? b1[j0 + j] : 0.f;
        w2s[j] = ok ? w2[j0 + j] : 0.f;
    }
}

template <int NT, bool SCALED>
__device__ __forceinline__ void gen_tanh_logit(float (&acc)[kMT][NT][4], const float* b1s,
                                               const float* w2s, int j0, const float* rs,
                                               float* red) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3, wm = warp & 1, wn = warp >> 1;
    float part[kMT][2];
    float sr[kMT][2];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            part[mt][h] = 0.f;
            sr[mt][h] = SCALED ? rs[32 * wm + 16 * mt + 8 * h + g] : 1.f;
        }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
        const int j = j0 + 8 * NT * wn + 8 * nt + 2 * t;
        const float c0 = b1s[j], c1 = b1s[j + 1], u0 = w2s[j], u1 = w2s[j + 1];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                float* c = acc[mt][nt] + 2 * h;
                c[0] = tanhf((SCALED ? c[0] * sr[mt][h] : c[0]) + c0);
                c[1] = tanhf((SCALED ? c[1] * sr[mt][h] : c[1]) + c1);
                part[mt][h] = fmaf(c[0], u0, fmaf(c[1], u1, part[mt][h]));
            }
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            float v = part[mt][h];
            v += __shfl_xor_sync(0xffffffffu, v, 1);
            v += __shfl_xor_sync(0xffffffffu, v, 2);
            if (t == 0) red[wn * kGenM + 32 * wm + 16 * mt + 8 * h + g] = v;
        }
}

}  // namespace abmil
