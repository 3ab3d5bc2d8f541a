// ABMIL attention pooling backward for Hopper (sm_90a).
//
// Replaces the TPU kernels vlsa_tpu/ops/abmil.py::_abmil_bwd_kernel (f32 and
// bf16 storage, with dX) and ::_abmil_q8_bwd_kernel (int8, weights only).
// From the forward's output `out` [B, D] and stats (m, l) [B], and the
// output's cotangent g [B, D], for each valid patch n of bag b:
//
//     h[n]  = tanh(s[n] * (x[n] . W1^T) + b1),  a[n] = exp(h[n] . w2 - m) / l
//     ds[n] = a[n] * (s[n] * (g . x[n]) - g . out)
//     dz[n] = ds[n] * w2 * (1 - h[n]^2)                              [hid]
//     dX[n] = a[n] * g + dz[n] . W1                 (only when x needs it)
//     dW1   = sum_b,n (s[n] dz[n])^T x[n],  db1 = sum dz[n],  dw2 = sum ds[n] h[n]
//
// (s[n] the int8 dequant scale, 1 for float storage).  Rounding follows the
// TPU kernels: bf16 storage rounds W1 to bf16 for x . W1^T, dz and W1 to bf16
// for dz . W1 and dz to bf16 for dW1, accumulates in f32 and writes dX in
// bf16; int8 splits W1 and s[n] dz into bf16 hi + lo (~16 bits); f32 forms
// its three products in split TF32 on the tensor cores (~2^-21 relative per
// product; the plain version ops/abmil.py::abmil_bwd_reference stays true
// f32).  A masked or out-of-range patch gets a = 0 before anything
// multiplies it: an empty bag has m = -1e30 and l = 1e-30, where exp(0) / l
// is 1e30.
//
// What bounds it on an H100: 4*D*hid operations per patch for the weight
// gradients (the h product and the dW1 product), 6*D*hid with dX -- above
// the bf16 ridge, so tensor-core operations bound it; f32's products run as
// 3 TF32 products each (3 x 1/495 of a TFLOP/s against 1/67 on the CUDA
// cores).  PERF.md holds the times beside the bound.
//
// Design.  The TPU kernel sums dW1 [256, 512] in VMEM across its whole
// sequential grid.  That is 512 KB of f32: no block's shared memory or
// registers hold it, and ds[n] needs the logit over the full hid before any
// dz exists.  So, deterministic and without atomics, in three passes, one
// structure for every storage type (h once, x read twice, the function's 4
// (6 with dX) D*hid operations per patch; dz through a workspace).
//
// bf16 and int8 (bf16 operands on the tensor cores, mma.sync m16n8k16
// through ldmatrix):
//   pass 1 (abmil_bwd_dz_bf16<T>), blocks (chunk, bag), tiles of 64 patches:
//     h once by the forward's h_product (abmil_common.cuh), x resident
//     (66.5 KB) -- bf16: x's and W1's column slices of 64 stream through 4
//     cp.async stages; int8: the tile is staged as bf16 (exact) by plain
//     loads while W1's hi and lo slices stream through 2, two products, and
//     h_pre is scaled by s; tanh, the logit, a, g . x and ds;
//     once x is dead its space holds dz in bf16 -- the TPU kernel's own
//     rounding of dz for dW1 (vlsa_tpu/ops/abmil.py:254-256); int8: s dz as
//     bf16 hi + lo, two tiles -- written to a [B, N, 256] workspace (int8:
//     two planes) by 16-byte stores; each thread keeps its 16 hid columns'
//     db1 and dw2 sums in registers over the chunk.  With dX (bf16), dz . W1
//     (W1 rows streamed in slices of 32) in two halves of 256 columns, each
//     half plus a g staged in bf16 (16-byte chunks XOR-swizzled by the row)
//     for 16-byte stores.  220,288 bytes of shared memory (int8 221,312),
//     one block an SM.
//   pass 2 (abmil_bwd_dw_bf16, abmil_bwd_dw_i8): dW1 = sum dz^T x over all
//     B * N rows as one split-K GEMM, blocks (128 x 128 tile of dW1, chunk of
//     rows), dz and x rows through 3 cp.async stages of 64 (104,448 bytes; int8:
//     dz's hi and lo planes and x's raw rows, converted to bf16 in one tile
//     after each stage lands, 146,432 bytes); both operands are k-major, so A
//     (dz^T) and B (x) come by ldmatrix.trans.
//   pass 3 as f32's.  bf16's byte floor: x read twice and dz written and
//     read once, ~0.25 GB at B=8, N=10240 (~0.075 ms at 3.35 TB/s), beside
//     chip_smoke.py::bound_abmil's operations bound.
//
// f32 (split TF32 through mma.sync m16n8k8, abmil_common.cuh): h once, x
// read twice, the function's 4 (6) D*hid operations per patch:
//   pass 1 (abmil_bwd_dz_f32), blocks (chunk, bag), tiles of 64 patches: the
//     h product as in the forward (x tile resident, W1 and x's own column
//     slices streamed by cp.async), then tanh, the logit, a, g . x and ds;
//     once x is dead its 133 KB hold dz and tanh(h), from which each thread
//     sums its hid column of db1 and dw2 over the tile and dz [64, 256] goes
//     to a workspace [B, N, 256] by 16-byte stores (0 on masked rows, where
//     a = 0).  With dX, the product dz . W1 in two halves of 256 columns,
//     W1 streamed in slices of 32 hid rows through the same 2 stages, each
//     half staged in tanh(h)'s space and written, a g added, by 16-byte
//     stores.  213 KB of shared memory; the block's db1, dw2 partials go to
//     [B * S1, 256].
//   pass 2 (abmil_bwd_dw_f32): dW1 = sum dz^T x over all B * N patch rows as
//     one split-K GEMM: block (tile, chunk) owns a 128 x 128 tile of dW1 over
//     a chunk of rows, dz and x rows streamed through 4 cp.async stages of
//     32 rows (139 KB); the 8 tiles of a chunk run side by side, so x and dz
//     come from device memory about once (from L2 2x and 4x).  Partials
//     [S2, 256, 512].  Storing dz (1 KB a patch, written once and read once)
//     costs less than recomputing h here (2 D hid x 3 TF32 operations a
//     patch, ~2.6x the time of dz's bytes at the card's peaks).
//   pass 3 sums the S2 partials of dW1 and the B * S1 of db1, dw2, in order.
//
// The pass-1 instances above are built for D = 512, hid = 256.  Every other
// width (any D >= 1, any hid >= 1) and bf16 in vlsa_tpu's precise mode run
// abmil_bwd_dz_general (see the note above it); passes 2 and 3 take the
// widths at run time for every call.
#include <type_traits>

#include "abmil_common.cuh"

using namespace abmil;

namespace {

// ------------------------------------------------ bf16 and int8 storage: bf16 operands
//
// The f32 design below with bf16 operands on the bf16 tensor cores (mma.sync
// m16n8k16 through ldmatrix): pass 1 forms h once a tile of 64 patches,
// writes dz to a [B, N, 256] bf16 workspace and, with dX (bf16 only), forms
// dz . W1 + a g; pass 2 is one split-K GEMM dW1 = dz^T x over the B * N
// patch rows.  The h product is abmil_common.cuh's h_product, the bf16 and
// int8 forward's: bf16 x's and W1's column slices stream through 4 cp.async
// stages; dz is rounded to bf16, the TPU kernel's own rounding of dz for dW1
// (vlsa_tpu/ops/abmil.py:254-256).  int8 (the TPU's _abmil_q8_bwd_kernel,
// :419): the tile is staged as bf16 (exact) by plain loads while W1's hi and
// lo slices stream through 2 stages (two products, W1 to ~16 bits), h_pre is scaled by the
// patch's dequant scale s, and s dz goes to two bf16 planes, hi and lo, which
// pass 2 takes as two products, x's rows converted to bf16 in shared memory.

constexpr int kLdXB = kLdX16 / 2;         // 520: the x tile's rows in bf16 (h_product's kLdX16 bytes)
constexpr int kJB = 32;                    // hid rows a slice of the dX product
constexpr int kHalfB = kD / 2;             // dX columns a half
constexpr int kLdWJB = kHalfB + 8;         // 264: W1 row slice rows
constexpr int kLdZB = kHid + 8;            // 264: dz rows
static_assert((size_t)kJB * kLdWJB * 2 <= kStageS, "a dX slice fits in an h product stage");

// Shared-memory carve-up of pass 1 (T: bf16 or int8 storage).  The x tile's
// space holds, once h and g . x are formed, dz [64][kLdZB] and, with dX, the
// product's half tile [64][256] bf16 (16-byte chunks XOR-swizzled by the
// row) for 16-byte stores; int8's s dz lo tile takes the half tile's place.
// A stage holds W1's slice, hi and (int8) lo; bf16 streams through 4
// stages, int8, whose stage holds both, through 2.
template <typename T>
struct DzSmemB {
    static constexpr bool I8 = sizeof(T) == 1;
    static constexpr HOp OP = I8 ? HOp::kBf16Split : HOp::kBf16;
    static constexpr int NS = I8 ? 2 : 4;
    static constexpr size_t x = 0;
    static constexpr size_t half = round128((size_t)kMF * kLdZB * 2);      // 33,792
    // int8 67,584 (dz's hi and lo tiles); bf16 66,560 (the x tile)
    static constexpr size_t w = I8 ? 2 * half : round128((size_t)kMF * kLdXB * 2);
    static constexpr size_t stage = stage_bytes<OP>();
    static constexpr size_t cols = w + NS * stage;                         // b1, w2 [kHid], g [kD]
    static constexpr size_t red = cols + round128((2 * (size_t)kHid + kD) * 4);  // [4][64]
    static constexpr size_t rows = red + round128(4 * (size_t)kMF * 4);    // g.x, a, ds, s [64], g.out
    static constexpr size_t total = rows + round128((4 * (size_t)kMF + 4) * 4);
    static_assert(half + (size_t)kMF * (I8 ? kLdZB : kHalfB) * 2 <= w,
                  "dz and the dX half tile (int8: s dz's lo tile) fit in x's space");
    static_assert(round128((size_t)kMF * kLdXB * 2) <= w, "the x tile fits");
    static_assert(4 * (size_t)kHid * 4 <= w, "the column sums' reduction fits in x's space");
};

// cp.async of slice s < 16 of the dX product's W1 stream into a stage
// [kJB][kLdWJB]: the hid rows [kJB (s % 8), +kJB) by the columns of half s / 8.
__device__ __forceinline__ void load_w1_rows_b(const __nv_bfloat16* __restrict__ w1h,
                                               __nv_bfloat16* ws, int s) {
    constexpr int kVec = kHalfB / 8;
    const __nv_bfloat16* src =
        w1h + (size_t)(kJB * (s % (kHid / kJB))) * kD + kHalfB * (s / (kHid / kJB));
    for (int i = threadIdx.x; i < kJB * kVec; i += kThreads) {
        const int j = i / kVec, c = 8 * (i % kVec);
        cp_async16(ws + j * kLdWJB + c, src + (size_t)j * kD + c, true);
    }
}

// Pass 1 (bf16, int8): per tile of 64 patches, h (once), tanh, the logit, a,
// g . x and ds; dz = ds w2 (1 - h^2) written in bf16 to the workspace dz
// [B, N, kHid] (zeros on masked rows: a = 0 there; int8: s dz as hi in dz
// and lo in dz_lo); the block's partial db1 = sum dz and dw2 = sum ds h (f32)
// over its chunk into ws_db1 / ws_dw2 [B * S1, kHid]; WITH_DX (bf16), the dX
// tile dz . W1 + a g, W1 streamed in slices of 32 hid rows by 256 columns,
// written in bf16.  Grid (S1, B).
template <typename T, bool WITH_DX>
__global__ void __launch_bounds__(kThreads, 1)
abmil_bwd_dz_bf16(const T* __restrict__ x, const float* __restrict__ x_scale,
                  const uint8_t* __restrict__ mask, const __nv_bfloat16* __restrict__ w1h,
                  const __nv_bfloat16* __restrict__ w1l, const float* __restrict__ b1,
                  const float* __restrict__ w2, const float* __restrict__ g,
                  const float* __restrict__ out, const float* __restrict__ m,
                  const float* __restrict__ l, int N, int chunk, int S,
                  __nv_bfloat16* __restrict__ dz, __nv_bfloat16* __restrict__ dz_lo,
                  float* __restrict__ ws_db1, float* __restrict__ ws_dw2,
                  __nv_bfloat16* __restrict__ dx) {
    using L = DzSmemB<T>;
    constexpr bool I8 = L::I8;
    static_assert(!(I8 && WITH_DX), "int8 features are data: no dX");
    extern __shared__ __align__(128) unsigned char smem[];
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + L::x);
    __nv_bfloat16* dzs = xs;  // after the h product and g . x
    unsigned char* half_s = smem + L::half;
    __nv_bfloat16* dzs_lo = reinterpret_cast<__nv_bfloat16*>(half_s);  // int8
    __nv_bfloat16* stage0 = reinterpret_cast<__nv_bfloat16*>(smem + L::w);
    __nv_bfloat16* stage1 = stage0 + L::stage / 2;
    float* b1s = reinterpret_cast<float*>(smem + L::cols);
    float* w2s = b1s + kHid;
    float* gs = w2s + kHid;
    float* red = reinterpret_cast<float*>(smem + L::red);
    float* gx_s = reinterpret_cast<float*>(smem + L::rows);
    float* a_s = gx_s + kMF;
    float* ds_s = a_s + kMF;
    float* sc_s = ds_s + kMF;  // int8: the rows' dequant scales
    float* gout_s = sc_s + kMF;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int gq = lane >> 2, tq = lane & 3, wm = warp & 1, wn = warp >> 1;
    const int split = blockIdx.x, b = blockIdx.y;
    const int n_begin = split * chunk;
    const int n_end = min(N, n_begin + chunk);
    const T* xb = x + (size_t)b * N * kD;
    const uint8_t* mb = mask + (size_t)b * N;
    const float* gb = g + (size_t)b * kD;
    const float m_b = m[b], l_b = l[b];

    // the first tile's first W1 slices: with dX the previous tile's dX
    // product hands over only the next tile's first
    constexpr int kPre = WITH_DX ? 1 : L::NS - 1;
#pragma unroll
    for (int q = 0; q < kPre; ++q) {
        load_w1_slice<L::OP>(w1h, w1l, smem + L::w + q * L::stage, q);
    }
    cp_async_commit();
    for (int j = tid; j < kHid; j += kThreads) {
        b1s[j] = b1[j];
        w2s[j] = w2[j];
    }
    for (int k = tid; k < kD; k += kThreads) gs[k] = gb[k];
    if (warp == 0) {
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < kD / 32; ++c) s += gb[lane + 32 * c] * out[(size_t)b * kD + lane + 32 * c];
        s = warp_sum(s);
        if (lane == 0) gout_s[0] = s;
    }
    // this thread's partial db1, dw2 of its columns 64 wn + 8 nt + 2 tq (+1)
    float db[kNT][2], dw[kNT][2];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) db[nt][0] = db[nt][1] = dw[nt][0] = dw[nt][1] = 0.f;
    float acc[kMT][kNT][4];

    for (int t0 = n_begin; t0 < n_end; t0 += kMF) {
        const bool more = t0 + kMF < n_end;
        if (I8 && tid < kMF) sc_s[tid] = t0 + tid < n_end ? x_scale[(size_t)b * N + t0 + tid] : 0.f;
        h_product<L::OP, kMT, L::NS, kPre>(
            acc, xb, t0, n_end, w1h, w1l, smem + L::x, smem + L::w, [&](int q, unsigned char* st) {
                if (WITH_DX) {
                    if (q == 0) load_w1_rows_b(w1h, reinterpret_cast<__nv_bfloat16*>(st), 0);
                } else if (more) {
                    load_w1_slice<L::OP>(w1h, w1l, st, q);  // the next tile's first slices
                }
            });
        if constexpr (I8) {  // h_pre = s x . W1^T
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const float sr = sc_s[32 * wm + 16 * mt + 8 * h + gq];
#pragma unroll
                    for (int nt = 0; nt < kNT; ++nt) {
                        acc[mt][nt][2 * h] *= sr;
                        acc[mt][nt][2 * h + 1] *= sr;
                    }
                }
        }
        tanh_logit_f32(acc, b1s, w2s, red);
        // g . x of the warp's rows
#pragma unroll 1
        for (int r = warp * (kMF / kWarps); r < (warp + 1) * (kMF / kWarps); ++r) {
            float s = 0.f;
#pragma unroll
            for (int c = 0; c < kD / 32; ++c)
                s = fmaf(gs[lane + 32 * c], __bfloat162float(xs[r * kLdXB + lane + 32 * c]), s);
            s = warp_sum(s);
            if (lane == 0) gx_s[r] = I8 ? s * sc_s[r] : s;
        }
        __syncthreads();
        if (tid < kMF) {
            const int r = tid, n = t0 + r;
            const bool valid = n < n_end && mb[n] != 0;
            const float logit = (red[r] + red[kMF + r]) + (red[2 * kMF + r] + red[3 * kMF + r]);
            const float a = valid ? expf(logit - m_b) / l_b : 0.f;  // 0 first: see the top
            a_s[r] = a;
            ds_s[r] = a * (gx_s[r] - gout_s[0]);
        }
        __syncthreads();  // x is dead: dz takes its space

#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
            const int j = 64 * wn + 8 * nt + 2 * tq;
            const float u0 = w2s[j], u1 = w2s[j + 1];
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int r = 32 * wm + 16 * mt + 8 * h + gq;
                    const float d = ds_s[r];
                    const float h0 = acc[mt][nt][2 * h], h1 = acc[mt][nt][2 * h + 1];
                    const float z0 = d * u0 * (1.f - h0 * h0), z1 = d * u1 * (1.f - h1 * h1);
                    db[nt][0] += z0;
                    db[nt][1] += z1;
                    dw[nt][0] = fmaf(d, h0, dw[nt][0]);
                    dw[nt][1] = fmaf(d, h1, dw[nt][1]);
                    if constexpr (I8) {  // s dz as bf16 hi + lo
                        const float sr = sc_s[r], v0 = sr * z0, v1 = sr * z1;
                        const uint32_t hi = pack_bf16(v0, v1);
                        const float2 hv = unpack_bf16(hi);
                        *reinterpret_cast<uint32_t*>(dzs + r * kLdZB + j) = hi;
                        *reinterpret_cast<uint32_t*>(dzs_lo + r * kLdZB + j) =
                            pack_bf16(v0 - hv.x, v1 - hv.y);
                    } else {
                        *reinterpret_cast<uint32_t*>(dzs + r * kLdZB + j) = pack_bf16(z0, z1);
                    }
                }
            }
        }
        __syncthreads();
        {
            constexpr int kVec = kHid / 8;
#pragma unroll
            for (int part = 0; part < (I8 ? 2 : 1); ++part) {
                __nv_bfloat16* dzb = (part ? dz_lo : dz) + ((size_t)b * N + t0) * kHid;
                const __nv_bfloat16* src = part ? dzs_lo : dzs;
                for (int i = tid; i < kMF * kVec; i += kThreads) {
                    const int r = i / kVec, c = 8 * (i % kVec);
                    if (t0 + r < n_end) {
                        *reinterpret_cast<uint4*>(dzb + (size_t)r * kHid + c) =
                            *reinterpret_cast<const uint4*>(src + r * kLdZB + c);
                    }
                }
            }
        }

        if constexpr (WITH_DX) {
            __nv_bfloat16* dxb = dx + (size_t)b * N * kD;
            const __nv_bfloat16* za =
                dzs + (32 * wm + (lane & 7) + 8 * ((lane >> 3) & 1)) * kLdZB + 8 * (lane >> 4);
            const int bo = ((lane & 7) + 8 * ((lane >> 3) & 1)) * kLdWJB + 64 * wn + 8 * (lane >> 4);
            constexpr int kSlicesJ = kHid / kJB;  // slices a half
#pragma unroll 1
            for (int half = 0; half < 2; ++half) {
                zero_acc(acc);
#pragma unroll 1
                for (int q = 0; q < kSlicesJ; ++q) {
                    const int s = half * kSlicesJ + q;
                    cp_async_wait<0>();
                    __syncthreads();  // slice s landed; stage (s + 1) % 2 is consumed
                    __nv_bfloat16* next = (s & 1) ? stage0 : stage1;
                    if (s + 1 < 2 * kSlicesJ) {
                        load_w1_rows_b(w1h, next, s + 1);
                    } else if (more) {  // stage 0: the next tile's first slice
                        load_w1_slice<HOp::kBf16>(w1h, nullptr,
                                                  reinterpret_cast<unsigned char*>(next), 0);
                    }
                    cp_async_commit();
                    const __nv_bfloat16* wb = ((s & 1) ? stage1 : stage0) + bo;
#pragma unroll
                    for (int ks = 0; ks < kJB / 16; ++ks) {
                        uint32_t a[kMT][4];
#pragma unroll
                        for (int mt = 0; mt < kMT; ++mt)
                            ldsm_x4(a[mt], za + 16 * mt * kLdZB + kJB * q + 16 * ks);
#pragma unroll
                        for (int np = 0; np < kNT / 2; ++np) {
                            uint32_t bw[4];
                            ldsm_x4_t(bw, wb + 16 * ks * kLdWJB + 16 * np);
#pragma unroll
                            for (int mt = 0; mt < kMT; ++mt) {
                                mma_bf16(acc[mt][2 * np], a[mt], bw[0], bw[1]);
                                mma_bf16(acc[mt][2 * np + 1], a[mt], bw[2], bw[3]);
                            }
                        }
                    }
                }
                // a g + dz . W1 of the half tile, in bf16, through the
                // swizzled half-tile space, then 16-byte stores
#pragma unroll
                for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
                    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
                        for (int h = 0; h < 2; ++h) {
                            const int r = 32 * wm + 16 * mt + 8 * h + gq;
                            const int c = 64 * wn + 8 * nt + 2 * tq;
                            const float a = a_s[r];
                            const float* gh = gs + kHalfB * half + c;
                            *reinterpret_cast<uint32_t*>(
                                half_s + r * (kHalfB * 2) + (((c >> 3) ^ (r & 7)) << 4) + 4 * tq) =
                                pack_bf16(fmaf(a, gh[0], acc[mt][nt][2 * h]),
                                          fmaf(a, gh[1], acc[mt][nt][2 * h + 1]));
                        }
                __syncthreads();
                constexpr int kVec = kHalfB / 8;
                for (int i = tid; i < kMF * kVec; i += kThreads) {
                    const int r = i / kVec, c = i % kVec;
                    if (t0 + r < n_end) {
                        *reinterpret_cast<uint4*>(dxb + (size_t)(t0 + r) * kD + kHalfB * half + 8 * c) =
                            *reinterpret_cast<const uint4*>(half_s + r * (kHalfB * 2) +
                                                            ((c ^ (r & 7)) << 4));
                    }
                }
            }
        }
        __syncthreads();  // xs (dz, the dX half tile) and the rows are rewritten by the next tile
    }
    cp_async_wait<0>();

    // the block's db1, dw2: over the 8 row groups of a warp (lanes gq), then
    // the two row halves (wm) through x's space, in a fixed order
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int k = 0; k < 2; ++k)
#pragma unroll
            for (int o = 4; o < 32; o <<= 1) {
                db[nt][k] += __shfl_xor_sync(0xffffffffu, db[nt][k], o);
                dw[nt][k] += __shfl_xor_sync(0xffffffffu, dw[nt][k], o);
            }
    float* sums = reinterpret_cast<float*>(smem + L::x);  // [2: db, dw][2: wm][kHid]
    if (gq == 0) {
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int k = 0; k < 2; ++k) {
                const int j = 64 * wn + 8 * nt + 2 * tq + k;
                sums[wm * kHid + j] = db[nt][k];
                sums[(2 + wm) * kHid + j] = dw[nt][k];
            }
    }
    __syncthreads();
    const size_t part = (size_t)b * S + split;
    ws_db1[part * kHid + tid] = sums[tid] + sums[kHid + tid];
    ws_dw2[part * kHid + tid] = sums[2 * kHid + tid] + sums[3 * kHid + tid];
}

// ------------------------------------------------ f32 storage: split TF32

// Shared-memory carve-up of f32 pass 1.  The x tile's space holds, once h
// and g . x are formed, dz [kMF][kLdZ] and tanh(h) [kMF][kLdZ]; with dX the
// product's half tile [kMF][kLdZ] is staged in tanh(h)'s space for 16-byte
// stores.  W1 streams through 2 stages of kStageF (h product, then dX).
struct DsSmemF {
    static constexpr size_t xz = round128((size_t)kMF * kLdXF * 4) > 2 * round128((size_t)kMF * kLdZ * 4)
                                     ? round128((size_t)kMF * kLdXF * 4)
                                     : 2 * round128((size_t)kMF * kLdZ * 4);  // 133,120
    static constexpr size_t x = 0;
    static constexpr size_t hv = round128((size_t)kMF * kLdZ * 4);    // tanh(h), in xz
    static constexpr size_t w = xz;                                    // 2 stages
    static constexpr size_t cols = w + 2 * kStageF;                    // b1, w2 [kHid], g [kD]
    static constexpr size_t red = cols + round128((2 * (size_t)kHid + kD) * 4);  // [4][kMF]
    static constexpr size_t rows = red + round128(4 * (size_t)kMF * 4);  // g.x, a, ds [kMF], g.out
    static constexpr size_t total = rows + round128((3 * (size_t)kMF + 4) * 4);
};

static_assert(kThreads == kHid, "f32 pass 1 sums one hid column a thread");

// f32 pass 1: per tile of 64 patches, h in split TF32 (once), tanh, the
// logit, a, g . x and ds; dz = ds w2 (1 - h^2) written to the workspace
// dz [B, N, kHid] (zeros on masked rows: a = 0 there); the block's partial
// db1 = sum dz and dw2 = sum ds h over its chunk into ws_db1 / ws_dw2
// [B * S1, kHid]; WITH_DX, the dX tile dz . W1 + a g in split TF32, W1
// streamed by cp.async in slices of 32 hid rows by 256 columns.  Grid (S1, B).
template <bool WITH_DX>
__global__ void __launch_bounds__(kThreads, 1)
abmil_bwd_dz_f32(const float* __restrict__ x, const uint8_t* __restrict__ mask,
                 const float* __restrict__ w1, const float* __restrict__ b1,
                 const float* __restrict__ w2, const float* __restrict__ g,
                 const float* __restrict__ out, const float* __restrict__ m,
                 const float* __restrict__ l, int N, int chunk, int S, float* __restrict__ dz,
                 float* __restrict__ ws_db1, float* __restrict__ ws_dw2,
                 float* __restrict__ dx) {
    using L = DsSmemF;
    extern __shared__ __align__(128) unsigned char smem[];
    float* xs = reinterpret_cast<float*>(smem + L::x);
    float* dzs = xs;  // after the h product and g . x
    float* hvs = reinterpret_cast<float*>(smem + L::hv);
    float* stage0 = reinterpret_cast<float*>(smem + L::w);
    float* stage1 = stage0 + kStageF / 4;
    float* b1s = reinterpret_cast<float*>(smem + L::cols);
    float* w2s = b1s + kHid;
    float* gs = w2s + kHid;
    float* red = reinterpret_cast<float*>(smem + L::red);
    float* gx_s = reinterpret_cast<float*>(smem + L::rows);
    float* a_s = gx_s + kMF;
    float* ds_s = a_s + kMF;
    float* gout_s = ds_s + kMF;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int gq = lane >> 2, tq = lane & 3, wm = warp & 1, wn = warp >> 1;
    const int split = blockIdx.x, b = blockIdx.y;
    const int n_begin = split * chunk;
    const int n_end = min(N, n_begin + chunk);
    const float* xb = x + (size_t)b * N * kD;
    const uint8_t* mb = mask + (size_t)b * N;
    const float* gb = g + (size_t)b * kD;
    const float m_b = m[b], l_b = l[b];

    load_w1_cols(w1, stage0, 0);  // the first tile's first W1 slice
    cp_async_commit();
    for (int j = tid; j < kHid; j += kThreads) {
        b1s[j] = b1[j];
        w2s[j] = w2[j];
    }
    for (int k = tid; k < kD; k += kThreads) gs[k] = gb[k];
    if (warp == 0) {
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < kD / 32; ++c) s += gb[lane + 32 * c] * out[(size_t)b * kD + lane + 32 * c];
        s = warp_sum(s);
        if (lane == 0) gout_s[0] = s;
    }
    float db = 0.f, dw = 0.f;  // hid column tid
    float acc[kMT][kNT][4];

    for (int t0 = n_begin; t0 < n_end; t0 += kMF) {
        const bool more = t0 + kMF < n_end;
        h_product_f32(acc, xb, t0, n_end, w1, xs, stage0, [&](float* st) {
            if (WITH_DX) {
                load_w1_rows(w1, st, 0);  // the dX product's first slice
            } else if (more) {
                load_w1_cols(w1, st, 0);  // the next tile's first slice
            }
        });
        tanh_logit_f32(acc, b1s, w2s, red);
        // g . x of the warp's rows
#pragma unroll 1
        for (int r = warp * (kMF / kWarps); r < (warp + 1) * (kMF / kWarps); ++r) {
            float s = 0.f;
#pragma unroll
            for (int c = 0; c < kD / 32; ++c) s = fmaf(gs[lane + 32 * c], xs[r * kLdXF + lane + 32 * c], s);
            s = warp_sum(s);
            if (lane == 0) gx_s[r] = s;
        }
        __syncthreads();
        if (tid < kMF) {
            const int r = tid, n = t0 + r;
            const bool valid = n < n_end && mb[n] != 0;
            const float logit = (red[r] + red[kMF + r]) + (red[2 * kMF + r] + red[3 * kMF + r]);
            const float a = valid ? expf(logit - m_b) / l_b : 0.f;  // 0 first: see the top
            a_s[r] = a;
            ds_s[r] = a * (gx_s[r] - gout_s[0]);
        }
        __syncthreads();  // x is dead: dz and tanh(h) take its space

#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
            const int j = 64 * wn + 8 * nt + 2 * tq;
            const float u0 = w2s[j], u1 = w2s[j + 1];
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int r = 32 * wm + 16 * mt + 8 * h + gq;
                    const float d = ds_s[r];
                    const float h0 = acc[mt][nt][2 * h], h1 = acc[mt][nt][2 * h + 1];
                    *reinterpret_cast<float2*>(dzs + r * kLdZ + j) =
                        make_float2(d * u0 * (1.f - h0 * h0), d * u1 * (1.f - h1 * h1));
                    *reinterpret_cast<float2*>(hvs + r * kLdZ + j) = make_float2(h0, h1);
                }
            }
        }
        __syncthreads();

        // the tile's column sums (thread tid: column tid, rows in order) and
        // its dz rows to the workspace
        {
            float sb = 0.f, sw = 0.f;
#pragma unroll 8
            for (int r = 0; r < kMF; ++r) {
                sb += dzs[r * kLdZ + tid];
                sw = fmaf(ds_s[r], hvs[r * kLdZ + tid], sw);
            }
            db += sb;
            dw += sw;
            float* dzb = dz + ((size_t)b * N + t0) * kHid;
            constexpr int kVec = kHid / 4;
            for (int i = tid; i < kMF * kVec; i += kThreads) {
                const int r = i / kVec, c = 4 * (i % kVec);
                if (t0 + r < n_end) {
                    *reinterpret_cast<float4*>(dzb + (size_t)r * kHid + c) =
                        *reinterpret_cast<const float4*>(dzs + r * kLdZ + c);
                }
            }
        }

        if constexpr (WITH_DX) {
            float* dxb = dx + (size_t)b * N * kD;
            const float* za = dzs + 32 * wm * kLdZ;
            constexpr int kSlicesJ = kHid / kJF;  // slices a half
#pragma unroll 1
            for (int half = 0; half < 2; ++half) {
                zero_acc(acc);
#pragma unroll 1
                for (int q = 0; q < kSlicesJ; ++q) {
                    const int s = half * kSlicesJ + q;
                    cp_async_wait<0>();
                    __syncthreads();  // slice s landed; stage (s + 1) % 2 is consumed
                    float* next = (s & 1) ? stage0 : stage1;
                    if (s + 1 < 2 * kSlicesJ) {
                        load_w1_rows(w1, next, s + 1);
                    } else if (more) {
                        load_w1_cols(w1, next, 0);  // stage 0: the next tile's first slice
                    }
                    cp_async_commit();
                    const float* wb = ((s & 1) ? stage1 : stage0) + 64 * wn;
                    slice_3xtf32<false, true>(acc, za + kJF * q, kLdZ, wb, kLdWJ);
                }
                // the half tile through tanh(h)'s space (free: its sums are
                // taken), then 16-byte stores of a g + dz . W1
#pragma unroll
                for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
                    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
                        for (int h = 0; h < 2; ++h) {
                            const int r = 32 * wm + 16 * mt + 8 * h + gq;
                            *reinterpret_cast<float2*>(hvs + r * kLdZ + 64 * wn + 8 * nt + 2 * tq) =
                                make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
                        }
                __syncthreads();
                constexpr int kVec = kHalfF / 4;
                for (int i = tid; i < kMF * kVec; i += kThreads) {
                    const int r = i / kVec, c = 4 * (i % kVec);
                    if (t0 + r >= n_end) continue;
                    const float a = a_s[r];
                    const float4 v = *reinterpret_cast<const float4*>(hvs + r * kLdZ + c);
                    const float* gh = gs + kHalfF * half + c;
                    *reinterpret_cast<float4*>(dxb + (size_t)(t0 + r) * kD + kHalfF * half + c) =
                        make_float4(fmaf(a, gh[0], v.x), fmaf(a, gh[1], v.y),
                                    fmaf(a, gh[2], v.z), fmaf(a, gh[3], v.w));
                }
            }
        }
        __syncthreads();  // xs (dz, tanh(h)) and the rows are rewritten by the next tile
    }

    const size_t part = (size_t)b * S + split;
    ws_db1[part * kHid + tid] = db;
    ws_dw2[part * kHid + tid] = dw;
}

// Pass 2: dW1 = sum_k dz[k]^T x[k] over the K = B * N patch rows of the
// batch (dz [K, ldz], hid of its columns used: ldz = hid, or on the general
// instances hid_p; in f32 for f32, else bf16 -- int8: s dz as hi and lo
// planes, bf16's precise mode: dz as hi and lo; x [K, D] in the storage
// type, a chunk past D zero-filled and rows that are not 16-byte aligned
// copied a value at a time; dz is 0 on masked rows), one split-K GEMM, any
// width.  Block (tile,
// split) owns the dW1 tile [kDwM, kDwN] number `tile` (tiles_of(D) a row of
// tiles; rows past hid and columns past D masked) over the rows [split *
// chunk, +chunk) and writes it to ws_dw1[split]; the tiles of one split run
// side by side, so their dz and x rows come from device memory about once
// and from L2 for the rest.  Rows stream through DwTiling<T>::stages
// cp.async stages of ::rows (dz's rows [rows][kLdDw], x's rows, and with
// TWO planes dz's lo rows; int8 x's raw rows, converted to bf16 in one tile
// after each stage lands); both operands are k-major.  f32: split TF32
// (slice_3xtf32, 32 rows a slice); bf16 and int8: A (dz^T) and B (x) by
// ldmatrix.trans into mma.sync m16n8k16 (TWO: dz's hi and lo, two
// products).  Grid (tiles, S2).
constexpr int kDwM = 128;                                 // hid rows of a dW1 tile
constexpr int kDwN = 128;                                 // D columns of a dW1 tile
constexpr int kDwTiles = (kHid / kDwM) * (kD / kDwN);     // 8 at D = 512, hid = 256
constexpr int kRowsDw = 32;                               // f32 patch rows a stage (slice_3xtf32's depth)
constexpr int kRowsDwB = 64;                              // bf16 and int8 patch rows a stage
// precise mode (bf16 dz hi + lo): a block adds its tensor-core sum into its
// partial every kDwChain rows and starts the next from zero.  The f32
// accumulation of a longer chain drifts from the exact sums (of max|dW1|,
// on an H100: 7.8e-5 at 27,307 rows and D=2560, 4.2e-5 at 10,240 rows and
// 2.4e-5 at D=1024), where precise mode's dW1 is held within 5e-5.
constexpr int kDwChain = 8192;
// 136: f32's k-major fragments hit 32 banks (8t + g), bf16's 8 rows 8 bank groups
constexpr int kLdDw = 128 + 8;
template <typename T> struct DwTiling {                   // bf16, int8
    using Op = __nv_bfloat16;                             // the operands' type in shared memory
    static constexpr int rows = kRowsDwB, stages = 3;
};
template <> struct DwTiling<float> {
    using Op = float;
    static constexpr int rows = kRowsDw, stages = 4;
};
__host__ __device__ constexpr int dw_tiles_n(int D) { return (D + kDwN - 1) / kDwN; }
__host__ __device__ constexpr int dw_tiles(int D, int hid) {
    return (hid + kDwM - 1) / kDwM * dw_tiles_n(D);
}
// the layout of a stage: dz rows, x rows (int8: raw), then (TWO) dz's lo rows
template <typename T, bool TWO>
struct DwStage {
    using D_ = DwTiling<T>;
    using Op = typename D_::Op;
    static constexpr size_t z = (size_t)D_::rows * kLdDw * sizeof(Op);
    static constexpr size_t x = z;
    static constexpr size_t lo = x + (sizeof(T) == 1 ? (size_t)D_::rows * kDwN : z);
    static constexpr size_t bytes = lo + (TWO ? z : 0);
    // the block's: the stages and (int8) the converted x tile
    static constexpr size_t smem = D_::stages * bytes + (sizeof(T) == 1 ? z : 0);
};
template <typename T, bool TWO>
__host__ __device__ constexpr size_t dw_smem_bytes() {
    return DwStage<T, TWO>::smem;
}

// A pass-2 block's acc to its partial dst [hid, D] at tile (m0, n0), or
// (add) onto what an earlier chain put there: each thread reads back only
// the values it wrote.
__device__ __forceinline__ void dw_store(const float (&acc)[kMT][kNT][4], float* dst, int m0,
                                         int n0, int lane, int warp, int hid, int D, bool add) {
    const int gq = lane >> 2, tq = lane & 3, wm = warp & 3, wn = warp >> 2;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = m0 + 32 * wm + 16 * mt + 8 * h + gq;
                const int c = n0 + 64 * wn + 8 * nt + 2 * tq;
                if (r < hid && c < D) {
                    float* o = dst + (size_t)r * D + c;
                    float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
                    if ((D & 1) == 0) {  // c + 1 < D, and o 8-byte aligned
                        if (add) {
                            const float2 old = *reinterpret_cast<const float2*>(o);
                            v0 += old.x;
                            v1 += old.y;
                        }
                        *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
                    } else {
                        o[0] = add ? o[0] + v0 : v0;
                        if (c + 1 < D) o[1] = add ? o[1] + v1 : v1;
                    }
                }
            }
}

// AL: x's rows are 16-byte aligned (D * sizeof(T) a multiple of 16), so a
// 16-byte chunk lies wholly inside or past a row and is copied by cp.async;
// else copy16 copies a value at a time (an instance of its own, which keeps
// the aligned loop as lean as the D = 512 one).
template <typename T, bool TWO, bool AL>
__device__ __forceinline__ void dw_gemm(const T* __restrict__ x,
                                        const typename DwTiling<T>::Op* __restrict__ dz,
                                        const __nv_bfloat16* __restrict__ dz_lo, int K, int chunk,
                                        int D, int hid, int ldz, float* __restrict__ ws_dw1) {
    using Op = typename DwTiling<T>::Op;
    using St = DwStage<T, TWO>;
    constexpr bool I8 = sizeof(T) == 1;
    static_assert(!I8 || TWO, "int8's s dz comes as hi and lo");
    constexpr int kRows = DwTiling<T>::rows, kStages = DwTiling<T>::stages;
    constexpr int kVec = 16 / sizeof(Op);      // elements of a 16-byte chunk
    extern __shared__ __align__(128) unsigned char smem[];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wm = warp & 3, wn = warp >> 2;
    const int tn = dw_tiles_n(D);
    const int m0 = (blockIdx.x / tn) * kDwM, n0 = (blockIdx.x % tn) * kDwN;
    const int split = blockIdx.y;
    const int k_begin = split * chunk;
    const int k_end = min(K, k_begin + chunk);
    const int slices = (k_end - k_begin + kRows - 1) / kRows;
    constexpr bool kChains = TWO && !I8;  // precise mode: chains of kDwChain rows
    static_assert(kDwChain % kRows == 0, "a chain ends on a stage");
    auto stage = [&](int s) { return smem + (size_t)(s % kStages) * St::bytes; };
    __nv_bfloat16* xcv = reinterpret_cast<__nv_bfloat16*>(smem + kStages * St::bytes);

    const unsigned char* xbytes = reinterpret_cast<const unsigned char*>(x);
    auto load = [&](int s) {
        unsigned char* st = stage(s);
        Op* zs = reinterpret_cast<Op*>(st);
        Op* xs = reinterpret_cast<Op*>(st + St::x);
        __nv_bfloat16* zl = reinterpret_cast<__nv_bfloat16*>(st + St::lo);
        const int k = k_begin + s * kRows;
        for (int i = tid; i < kRows * (128 / kVec); i += kThreads) {
            const int r = i / (128 / kVec), c = kVec * (i % (128 / kVec));
            const bool okz = k + r < k_end && m0 + c < hid;
            const size_t zo = (size_t)(k + r) * ldz + m0 + c;
            cp_async16(zs + r * kLdDw + c, okz ? dz + zo : dz, okz);
            if constexpr (TWO) cp_async16(zl + r * kLdDw + c, okz ? dz_lo + zo : dz_lo, okz);
            if constexpr (!I8) {
                if constexpr (AL) {
                    const bool okx = k + r < k_end && n0 + c < D;
                    cp_async16(xs + r * kLdDw + c, okx ? x + (size_t)(k + r) * D + n0 + c : x, okx);
                } else {
                    const int nb = k + r < k_end ? chunk_bytes(D * (int)sizeof(T),
                                                               (n0 + c) * (int)sizeof(T))
                                                 : 0;
                    copy16<sizeof(T)>(xs + r * kLdDw + c,
                                      xbytes + ((size_t)(k + r) * D + n0 + c) * sizeof(T), nb);
                }
            }
        }
        if constexpr (I8) {
            unsigned char* x8 = st + St::x;
            for (int i = tid; i < kRows * (kDwN / 16); i += kThreads) {
                const int r = i / (kDwN / 16), c = 16 * (i % (kDwN / 16));
                if constexpr (AL) {
                    const bool ok = k + r < k_end && n0 + c < D;
                    cp_async16(x8 + r * kDwN + c, ok ? x + (size_t)(k + r) * D + n0 + c : x, ok);
                } else {
                    const int nb = k + r < k_end ? chunk_bytes(D, n0 + c) : 0;
                    copy16<1>(x8 + r * kDwN + c, xbytes + (size_t)(k + r) * D + n0 + c, nb);
                }
            }
        }
    };
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
        if (s < slices) load(s);
        cp_async_commit();
    }
    float acc[kMT][kNT][4];
    zero_acc(acc);
    float* dst = ws_dw1 + (size_t)split * hid * D;
    bool flushed = false;  // an earlier chain's sum is in the partial
    // the ldmatrix.trans row addresses (rows are patches, k): A = dz^T, B = x
    const int ao = ((lane & 7) + 8 * (lane >> 4)) * kLdDw + 32 * wm + 8 * ((lane >> 3) & 1);
    const int bo = ((lane & 7) + 8 * ((lane >> 3) & 1)) * kLdDw + 64 * wn + 8 * (lane >> 4);
#pragma unroll 1
    for (int s = 0; s < slices; ++s) {
        cp_async_wait<kStages - 2>();
        __syncthreads();  // slice s landed; stage (s - 1) % kStages and xcv are consumed
        if (s + kStages - 1 < slices) load(s + kStages - 1);
        cp_async_commit();
        const unsigned char* st = stage(s);
        const Op* zs = reinterpret_cast<const Op*>(st);
        const Op* xs = reinterpret_cast<const Op*>(st + St::x);
        if constexpr (sizeof(T) == 4) {
            slice_3xtf32<true, true>(acc, zs + 32 * wm, kLdDw, xs + 64 * wn, kLdDw);
        } else {
            if constexpr (I8) {  // the raw x rows -> bf16 (exact), then B from there
                const unsigned char* x8 = st + St::x;
                for (int i = tid; i < kRows * (kDwN / 16); i += kThreads) {
                    const int r = i / (kDwN / 16), c = 16 * (i % (kDwN / 16));
                    const int4 raw = *reinterpret_cast<const int4*>(x8 + r * kDwN + c);
                    const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
                    uint4 o[2];
                    uint32_t* ow = &o[0].x;
#pragma unroll
                    for (int e = 0; e < 8; ++e) ow[e] = pack_bf16(v[2 * e], v[2 * e + 1]);
                    *reinterpret_cast<uint4*>(xcv + r * kLdDw + c) = o[0];
                    *reinterpret_cast<uint4*>(xcv + r * kLdDw + c + 8) = o[1];
                }
                __syncthreads();
            }
            const __nv_bfloat16* xb = I8 ? xcv : reinterpret_cast<const __nv_bfloat16*>(xs);
#pragma unroll
            for (int ks = 0; ks < kRows / 16; ++ks) {
                uint32_t bx[kNT / 2][4];
#pragma unroll
                for (int np = 0; np < kNT / 2; ++np) ldsm_x4_t(bx[np], xb + 16 * ks * kLdDw + bo + 16 * np);
#pragma unroll
                for (int part = 0; part < (TWO ? 2 : 1); ++part) {  // dz (TWO: its hi, then lo)
                    const Op* za = part ? reinterpret_cast<const Op*>(st + St::lo) : zs;
                    uint32_t a[kMT][4];
#pragma unroll
                    for (int mt = 0; mt < kMT; ++mt) ldsm_x4_t(a[mt], za + 16 * ks * kLdDw + ao + 16 * mt);
#pragma unroll
                    for (int np = 0; np < kNT / 2; ++np)
#pragma unroll
                        for (int mt = 0; mt < kMT; ++mt) {
                            mma_bf16(acc[mt][2 * np], a[mt], bx[np][0], bx[np][1]);
                            mma_bf16(acc[mt][2 * np + 1], a[mt], bx[np][2], bx[np][3]);
                        }
                }
            }
        }
        if constexpr (kChains) {
            if ((s + 1) % (kDwChain / kRows) == 0 && s + 1 < slices) {
                dw_store(acc, dst, m0, n0, lane, warp, hid, D, flushed);
                flushed = true;
                zero_acc(acc);
            }
        }
    }
    cp_async_wait<0>();
    dw_store(acc, dst, m0, n0, lane, warp, hid, D, flushed);
}

template <bool AL>
__global__ void __launch_bounds__(kThreads, 1)
abmil_bwd_dw_f32(const float* __restrict__ x, const float* __restrict__ dz, int K, int chunk,
                 int D, int hid, int ldz, float* __restrict__ ws_dw1) {
    dw_gemm<float, false, AL>(x, dz, nullptr, K, chunk, D, hid, ldz, ws_dw1);
}

template <bool AL>
__global__ void __launch_bounds__(kThreads, 1)
abmil_bwd_dw_bf16(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dz,
                  int K, int chunk, int D, int hid, int ldz, float* __restrict__ ws_dw1) {
    dw_gemm<__nv_bfloat16, false, AL>(x, dz, nullptr, K, chunk, D, hid, ldz, ws_dw1);
}

// bf16's precise mode: dz as hi and lo (vlsa_tpu/ops/abmil.py:250-253)
template <bool AL>
__global__ void __launch_bounds__(kThreads, 1)
abmil_bwd_dw_bf16_split(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ dz_hi,
                        const __nv_bfloat16* __restrict__ dz_lo, int K, int chunk, int D, int hid,
                        int ldz, float* __restrict__ ws_dw1) {
    dw_gemm<__nv_bfloat16, true, AL>(x, dz_hi, dz_lo, K, chunk, D, hid, ldz, ws_dw1);
}

template <bool AL>
__global__ void __launch_bounds__(kThreads, 1)
abmil_bwd_dw_i8(const int8_t* __restrict__ x, const __nv_bfloat16* __restrict__ dz_hi,
                const __nv_bfloat16* __restrict__ dz_lo, int K, int chunk, int D, int hid,
                int ldz, float* __restrict__ ws_dw1) {
    dw_gemm<int8_t, true, AL>(x, dz_hi, dz_lo, K, chunk, D, hid, ldz, ws_dw1);
}

// Pass 3: dw1 [hid * D] = the sum of the K_w partials ws_dw1, db1 and dw2
// [hid] those of the K_b partials ws_db1, ws_dw2, k in order.
__global__ void __launch_bounds__(kThreads)
abmil_bwd_reduce(const float* __restrict__ ws_dw1, const float* __restrict__ ws_db1,
                 const float* __restrict__ ws_dw2, int K_w, int K_b, int D, int hid,
                 float* __restrict__ dw1, float* __restrict__ db1, float* __restrict__ dw2) {
    const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
    const size_t kW = (size_t)hid * D;
    float s = 0.f;
    if (i < kW) {
        for (int k = 0; k < K_w; ++k) s += ws_dw1[(size_t)k * kW + i];
        dw1[i] = s;
    } else if (i < kW + hid) {
        const int j = (int)(i - kW);
        for (int k = 0; k < K_b; ++k) s += ws_db1[(size_t)k * hid + j];
        db1[j] = s;
    } else if (i < kW + 2 * hid) {
        const int j = (int)(i - kW - hid);
        for (int k = 0; k < K_b; ++k) s += ws_dw2[(size_t)k * hid + j];
        dw2[j] = s;
    }
}

// ------------------------------------------------ any width: the general pass 1
//
// Every (D, hid) but 512, 256 and bf16's precise mode (abmil_common.cuh's
// general instances: W1 [hid_p, ld], zero-padded), one body for every
// storage.  Per tile of kGenM = 64
// patches: (a) the logits, pass by pass over hid (gen_h_product, as the
// general forward forms them, so int8 takes the forward's int8 split of W1
// and meets its (m, l) exactly), past hid_p = kSmemHid each pass's b1 and
// w2 staged at its start;
// (b) g . x of each row, its x re-read from L2 against g in shared memory
// (in blocks of kSmemD channels past kSmemD, each lane's sum carried from
// block to block in one order), and a, ds; (c) pass by pass, h (kept from
// (a) when one pass holds hid, else formed again), dz = ds w2 (1 - h^2), the
// column sums of dz and ds h into shared memory, past hid_p = kSmemHid the
// block's own rows of ws_sums [4][hid_p] in device memory (each column and
// row half owned by one thread, added tile after tile: deterministic) and dz through a tile in the stages'
// space to the workspace [B, N, hid_p] (the padded columns' dz are 0): f32
// in f32, bf16 rounded to bf16 (the TPU kernel's rounding of dz), precise as
// bf16 hi + lo (vlsa_tpu/ops/abmil.py:99-111, :250-253),
// int8 s dz as bf16 hi + lo; (d) with dX, a g + dz . W1 (precise: dz hi . W1
// + dz lo . W1, W1 rounded to bf16 once, as vlsa_tpu's _dz_w1_matmul) in
// blocks of kDxCols columns, dz's and W1's slices of kJG hid rows through
// the same 2 stages (dz re-read from L2: this block just wrote it).  dX
// blocks of 128 columns keep its registers within 255 without spills (256
// columns, with 256-column passes, spilled 16-440 bytes: PERF.md).  No
// shared-memory size grows with hid past kSmemHid, nor with D past kSmemD.
constexpr int kJG = 32;        // hid rows a slice of the general dX product
constexpr int kDxCols = 128;   // dX columns a block of it: 8 warps, 2 x 4, of 32 x 32
constexpr int kNTx = kDxCols / 32;  // n8 tiles of a warp's dX columns
constexpr int kRowsW = kGenM / kWarps;  // rows of the tile a warp takes in (b)

template <GOp OP, int HP>
struct DzSmemG {
    using G = Gen<OP, HP>;
    static constexpr int kPlanes = (OP == GOp::kBf16P || OP == GOp::kI8) ? 2 : 1;  // dz's
    static constexpr int kZ = G::F32 ? 4 : 2;                 // bytes a dz (and dX operand) value
    static constexpr int kLdZ = G::F32 ? kJG + 4 : kJG + 8;   // values a dX slice's dz row
    static constexpr int kLdW = kDxCols + 8;                  // values a dX slice's W1 row
    static constexpr size_t kDxStage =
        G::I8 ? 0 : round128((size_t)kPlanes * kGenM * kLdZ * kZ + (size_t)kJG * kLdW * kZ);
    static constexpr size_t kStage = G::kStage > kDxStage ? G::kStage : kDxStage;
    static constexpr int kLdT = G::F32 ? HP + 4 : HP + 8;     // values a dz tile row
    static constexpr size_t kTile = (size_t)kGenM * kLdT * kZ;  // a plane of the tile
    static constexpr size_t w = 0;                            // 2 stages; the dz tile
    static constexpr size_t red = round128(2 * kStage > kPlanes * kTile ? 2 * kStage
                                                                        : kPlanes * kTile);
    static constexpr size_t rows = red + 4 * (size_t)kGenM * 4;  // logit, valid, s, g.x, a, ds; g.out
    // sized at run time: b1, w2 [hid_p] (zero past hid) and the column sums
    // [4][hid_p] where hid_in_smem(hid_p), else b1, w2 [HP] (the pass's
    // columns); then g [min(D, kSmemD)] (zero-filled to a multiple of 4)
    static constexpr size_t vecs = rows + (6 * (size_t)kGenM + 4) * 4;
    __host__ __device__ static constexpr size_t g(int hid_p) {
        return vecs + (hid_in_smem(hid_p) ? 6 * (size_t)hid_p : 2 * (size_t)HP) * 4;
    }
    static constexpr size_t total(int D, int hid_p) {
        return g(hid_p) + round4((size_t)(D < kSmemD ? D : kSmemD)) * 4;
    }
};
static_assert(DzSmemG<GOp::kBf16P, gen_max_pass(GOp::kBf16P)>::total(kSmemD, kSmemHid) <=
                      kSmemOptin &&
                  DzSmemG<GOp::kF32, gen_max_pass(GOp::kF32)>::total(kSmemD, kSmemHid) <=
                      kSmemOptin,
              "the general pass 1 fits a block at every width");

// This lane's share of g . x over the channels [c0, c1) of a row of D
// values (pairs 2 lane + 64 k), gs holding g's channels from c0, added to s
// (c0 a multiple of 64: a lane's pairs continue from block to block); at an
// odd D (ODD) value D and its g are 0.
template <GOp OP, bool ODD>
__device__ __forceinline__ float lane_dot_g(const unsigned char* __restrict__ xr,
                                            const float* gs, int c0, int c1, int D, float s) {
    for (int c = c0 + 2 * (threadIdx.x & 31); c < c1; c += 64) {
        const float2 v = load_pair_at<OP, ODD>(xr, c, D);
        s = fmaf(gs[c - c0], v.x, fmaf(gs[c - c0 + 1], v.y, s));
    }
    return s;
}

// w1h, w1l: W1 as the h product takes it, [hid_p, ld] (gen_h_product;
// int8's s_w in w1_scale[0]); w1dx: W1 of the dX product (f32: its padded
// copy; bf16: its bf16 rounding).  dz, dz_lo: the workspace's planes
// [B, N, hid_p] (f32 or bf16; lo: precise and int8).  Grid (S1, B).
template <GOp OP, int HP>
__global__ void __launch_bounds__(kThreads, 1)
abmil_bwd_dz_general(const void* __restrict__ x, const float* __restrict__ x_scale,
                     const uint8_t* __restrict__ mask, const void* __restrict__ w1h,
                     const void* __restrict__ w1l, const float* __restrict__ w1_scale,
                     const void* __restrict__ w1dx, const float* __restrict__ b1,
                     const float* __restrict__ w2, const float* __restrict__ g,
                     const float* __restrict__ out, const float* __restrict__ m,
                     const float* __restrict__ l, int N, int D, int hid, int hid_p, int ld,
                     int chunk, int S, int with_dx, void* __restrict__ dz, void* __restrict__ dz_lo,
                     float* __restrict__ ws_sums, float* __restrict__ ws_db1,
                     float* __restrict__ ws_dw2, void* __restrict__ dx) {
    using G = Gen<OP, HP>;
    using L = DzSmemG<OP, HP>;
    using Z = typename std::conditional<G::F32, float, __nv_bfloat16>::type;  // dz's, dX's type
    constexpr int NT = G::NT;
    constexpr int kPlanes = L::kPlanes;
    extern __shared__ __align__(128) unsigned char smem[];
    unsigned char* stages = smem + L::w;
    Z* tile = reinterpret_cast<Z*>(smem + L::w);
    float* red = reinterpret_cast<float*>(smem + L::red);
    float* logit_s = reinterpret_cast<float*>(smem + L::rows);
    float* valid_s = logit_s + kGenM;
    float* sc_s = valid_s + kGenM;
    float* gx_s = sc_s + kGenM;
    float* a_s = gx_s + kGenM;
    float* ds_s = a_s + kGenM;
    float* gout_s = ds_s + kGenM;
    const bool hid_smem = hid_in_smem(hid_p);  // every column's b1, w2 and sums held
    float* b1s = reinterpret_cast<float*>(smem + L::vecs);
    float* w2s = b1s + (hid_smem ? hid_p : HP);
    float* gs = reinterpret_cast<float*>(smem + L::g(hid_p));

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int gq = lane >> 2, tq = lane & 3, wm = warp & 1, wn = warp >> 1;
    const int split = blockIdx.x, b = blockIdx.y;
    const int n_begin = split * chunk;
    const int n_end = min(N, n_begin + chunk);
    const int row_bytes = D * G::kItem, w_bytes = ld * G::kItem;
    const unsigned char* xb = static_cast<const unsigned char*>(x) + (size_t)b * N * row_bytes;
    const unsigned char* wh = static_cast<const unsigned char*>(w1h);
    const unsigned char* wl = static_cast<const unsigned char*>(w1l);
    const uint8_t* mb = mask + (size_t)b * N;
    const float* gb = g + (size_t)b * D;
    const float m_b = m[b], l_b = l[b];
    const float sw = G::I8 ? *w1_scale : 1.f;
    const int npass = hid_p / HP;
    const size_t part = (size_t)b * S + split;
    // the block's column sums [4][hid_p]: db1 (wm 0, 1), dw2 (wm 0, 1), in
    // shared memory after w2, else in its rows of ws_sums
    float* sums = hid_smem ? w2s + hid_p : ws_sums + part * 4 * hid_p;
    const bool g_smem = d_in_smem(D);  // g stays in gs; else a block of it at a time

    if (hid_smem) {
        for (int j = tid; j < hid_p; j += kThreads) {
            b1s[j] = j < hid ? b1[j] : 0.f;
            w2s[j] = j < hid ? w2[j] : 0.f;
        }
    }
    for (int j = tid; j < 4 * hid_p; j += kThreads) sums[j] = 0.f;
    if (g_smem) {
        for (int k = tid; k < (int)round4((size_t)D); k += kThreads) gs[k] = k < D ? gb[k] : 0.f;
    }
    // g's channel c (c < D + 1), from gs or device memory
    auto g_at = [&](int c) { return g_smem ? gs[c] : (c < D ? gb[c] : 0.f); };
    if (warp == 0) {
        float s = 0.f;
        for (int c = lane; c < D; c += 32) s += gb[c] * out[(size_t)b * D + c];
        s = warp_sum(s);
        if (lane == 0) gout_s[0] = s;
    }
    float acc[kMT][NT][4];

#pragma unroll 1
    for (int t0 = n_begin; t0 < n_end; t0 += kGenM) {
        if (tid < kGenM) {
            const int n = t0 + tid;
            valid_s[tid] = n < n_end && mb[n] != 0 ? 1.f : 0.f;
            sc_s[tid] = G::I8 && n < n_end ? x_scale[(size_t)b * N + n] : 1.f;
            logit_s[tid] = 0.f;
        }
        // (a) the logits
#pragma unroll 1
        for (int j0 = 0; j0 < hid_p; j0 += HP) {
            if (!hid_smem) stage_pass_vecs<HP>(b1, w2, hid, j0, b1s, w2s);
            gen_h_product<OP, HP>(acc, xb, t0, n_end, row_bytes, w_bytes, wh, wl, j0, sw, stages);
            gen_tanh_logit<NT, G::I8>(acc, b1s, w2s, hid_smem ? j0 : 0, sc_s, red);
            __syncthreads();
            if (tid < kGenM) {
                logit_s[tid] += (red[tid] + red[kGenM + tid]) +
                                (red[2 * kGenM + tid] + red[3 * kGenM + tid]);
            }
        }
        // (b) g . x of the warp's rows, g a block of kSmemD channels at a
        // time (one block where D <= kSmemD, staged once), then a and ds
        float gx[kRowsW];
#pragma unroll
        for (int i = 0; i < kRowsW; ++i) gx[i] = 0.f;
#pragma unroll 1
        for (int c0 = 0; c0 < D; c0 += kSmemD) {
            const int c1 = min(D, c0 + kSmemD);
            if (!g_smem) {
                __syncthreads();  // every warp is done with the previous block
                for (int k = tid; k < (int)round4((size_t)(c1 - c0)); k += kThreads)
                    gs[k] = c0 + k < D ? gb[c0 + k] : 0.f;
                __syncthreads();
            }
#pragma unroll
            for (int i = 0; i < kRowsW; ++i) {
                const int r = warp * kRowsW + i;
                if (t0 + r < n_end) {
                    const unsigned char* xr = xb + (size_t)(t0 + r) * row_bytes;
                    gx[i] = (D & 1) ? lane_dot_g<OP, true>(xr, gs, c0, c1, D, gx[i])
                                    : lane_dot_g<OP, false>(xr, gs, c0, c1, D, gx[i]);
                }
            }
        }
#pragma unroll
        for (int i = 0; i < kRowsW; ++i) {
            const int r = warp * kRowsW + i;
            const float s = warp_sum(gx[i]);
            if (lane == 0) gx_s[r] = G::I8 ? s * sc_s[r] : s;
        }
        __syncthreads();
        if (tid < kGenM) {
            const int r = tid;
            const float a = valid_s[r] != 0.f ? expf(logit_s[r] - m_b) / l_b : 0.f;  // 0 first
            a_s[r] = a;
            ds_s[r] = a * (gx_s[r] - gout_s[0]);
        }
        __syncthreads();

        // (c) dz, pass by pass
#pragma unroll 1
        for (int j0 = 0; j0 < hid_p; j0 += HP) {
            if (npass > 1) {
                if (!hid_smem) stage_pass_vecs<HP>(b1, w2, hid, j0, b1s, w2s);
                gen_h_product<OP, HP>(acc, xb, t0, n_end, row_bytes, w_bytes, wh, wl, j0, sw,
                                      stages);
                gen_tanh_logit<NT, G::I8>(acc, b1s, w2s, hid_smem ? j0 : 0, sc_s, red);
            }
            const float* w2p = hid_smem ? w2s + j0 : w2s;  // the pass's w2
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
                const int jl = 8 * NT * wn + 8 * nt + 2 * tq, j = j0 + jl;
                const float u0 = w2p[jl], u1 = w2p[jl + 1];
                float db0 = 0.f, db1v = 0.f, dw0 = 0.f, dw1v = 0.f;
#pragma unroll
                for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const int r = 32 * wm + 16 * mt + 8 * h + gq;
                        const float d = ds_s[r];
                        const float h0 = acc[mt][nt][2 * h], h1 = acc[mt][nt][2 * h + 1];
                        const float z0 = d * u0 * (1.f - h0 * h0), z1 = d * u1 * (1.f - h1 * h1);
                        db0 += z0;
                        db1v += z1;
                        dw0 = fmaf(d, h0, dw0);
                        dw1v = fmaf(d, h1, dw1v);
                        Z* dst = tile + r * L::kLdT + jl;
                        if constexpr (G::F32) {
                            *reinterpret_cast<float2*>(dst) = make_float2(z0, z1);
                        } else {
                            const float sr = G::I8 ? sc_s[r] : 1.f;
                            const float v0 = sr * z0, v1 = sr * z1;
                            const uint32_t hi = pack_bf16(v0, v1);
                            *reinterpret_cast<uint32_t*>(dst) = hi;
                            if constexpr (kPlanes == 2) {
                                const float2 hv = unpack_bf16(hi);
                                *reinterpret_cast<uint32_t*>(dst + kGenM * L::kLdT) =
                                    pack_bf16(v0 - hv.x, v1 - hv.y);
                            }
                        }
                    }
#pragma unroll
                for (int o = 4; o < 32; o <<= 1) {
                    db0 += __shfl_xor_sync(0xffffffffu, db0, o);
                    db1v += __shfl_xor_sync(0xffffffffu, db1v, o);
                    dw0 += __shfl_xor_sync(0xffffffffu, dw0, o);
                    dw1v += __shfl_xor_sync(0xffffffffu, dw1v, o);
                }
                if (gq == 0) {  // this thread owns columns j, j + 1 of row half wm
                    sums[wm * hid_p + j] += db0;
                    sums[wm * hid_p + j + 1] += db1v;
                    sums[(2 + wm) * hid_p + j] += dw0;
                    sums[(2 + wm) * hid_p + j + 1] += dw1v;
                }
            }
            __syncthreads();  // the tile is whole
            {
                constexpr int kCh = HP * L::kZ / 16;  // 16-byte chunks a tile row
                constexpr int kPer = 16 / L::kZ;
#pragma unroll
                for (int q = 0; q < kPlanes; ++q) {
                    Z* dst = static_cast<Z*>(q ? dz_lo : dz) + ((size_t)b * N + t0) * hid_p + j0;
                    const Z* src = tile + q * kGenM * L::kLdT;
                    for (int i = tid; i < kGenM * kCh; i += kThreads) {
                        const int r = i / kCh, c = kPer * (i % kCh);
                        if (t0 + r < n_end) {
                            *reinterpret_cast<uint4*>(dst + (size_t)r * hid_p + c) =
                                *reinterpret_cast<const uint4*>(src + r * L::kLdT + c);
                        }
                    }
                }
            }
            __syncthreads();  // the tile's space is the next pass's stages
        }

        // (d) dX = a g + dz . W1
        if constexpr (!G::I8) {
            if (with_dx) {
                constexpr int kLdZ = L::kLdZ, kLdW = L::kLdW;
                constexpr size_t kZp = (size_t)kGenM * kLdZ;  // values a dz plane of a slice
                const Z* w1d = static_cast<const Z*>(w1dx);
                Z* dxb = static_cast<Z*>(dx) + (size_t)b * N * D;
                const Z* z_hi = static_cast<const Z*>(dz);
                const Z* z_lo = static_cast<const Z*>(dz_lo);
                auto load = [&](int q, int d0, unsigned char* st) {
                    Z* zs = reinterpret_cast<Z*>(st);
                    Z* ws = zs + kPlanes * kZp;
                    constexpr int kCz = kJG * L::kZ / 16;       // chunks a dz row: f32 8, bf16 4
                    constexpr int kCw = kDxCols * L::kZ / 16;   // chunks a W1 row: f32 64, bf16 32
                    constexpr int kPer = 16 / L::kZ;
                    for (int i = tid; i < kPlanes * kGenM * kCz; i += kThreads) {
                        const int pl = i / (kGenM * kCz), rem = i % (kGenM * kCz);
                        const int r = rem / kCz, c = kPer * (rem % kCz);
                        const bool ok = t0 + r < n_end;
                        const Z* src =
                            (pl ? z_lo : z_hi) + ((size_t)b * N + t0 + r) * hid_p + kJG * q + c;
                        cp_async16(zs + pl * kZp + r * kLdZ + c, ok ? src : z_hi, ok);
                    }
                    for (int i = tid; i < kJG * kCw; i += kThreads) {
                        const int j = i / kCw, c = kPer * (i % kCw);
                        const bool ok = d0 + c < ld;
                        cp_async16(ws + j * kLdW + c, ok ? w1d + (size_t)(kJG * q + j) * ld + d0 + c
                                                         : w1d, ok);
                    }
                };
                const int nq = hid_p / kJG;
                const int zo = (32 * wm + (lane & 7) + 8 * ((lane >> 3) & 1)) * kLdZ + 8 * (lane >> 4);
                const int bo = ((lane & 7) + 8 * ((lane >> 3) & 1)) * kLdW + 32 * wn + 8 * (lane >> 4);
#pragma unroll 1
                for (int d0 = 0; d0 < D; d0 += kDxCols) {
                    float dacc[kMT][kNTx][4];
                    zero_acc(dacc);
                    load(0, d0, stages);
                    cp_async_commit();
#pragma unroll 1
                    for (int q = 0; q < nq; ++q) {
                        cp_async_wait<0>();
                        __syncthreads();  // slice q landed; the other stage is consumed
                        if (q + 1 < nq) load(q + 1, d0, stages + ((q + 1) & 1) * L::kStage);
                        cp_async_commit();
                        const Z* zs = reinterpret_cast<const Z*>(stages + (q & 1) * L::kStage);
                        const Z* wsl = zs + kPlanes * kZp;
                        if constexpr (G::F32) {
                            slice_3xtf32<false, true, kNTx>(dacc, zs + 32 * wm * kLdZ, kLdZ,
                                                            wsl + 32 * wn, kLdW);
                        } else {
#pragma unroll
                            for (int ks = 0; ks < kJG / 16; ++ks) {
                                uint32_t bw[kNTx / 2][4];
#pragma unroll
                                for (int np = 0; np < kNTx / 2; ++np)
                                    ldsm_x4_t(bw[np], wsl + bo + 16 * ks * kLdW + 16 * np);
#pragma unroll
                                for (int part = 0; part < kPlanes; ++part) {  // dz (precise: hi, lo)
                                    uint32_t a[kMT][4];
#pragma unroll
                                    for (int mt = 0; mt < kMT; ++mt)
                                        ldsm_x4(a[mt], zs + part * kZp + zo + 16 * mt * kLdZ + 16 * ks);
#pragma unroll
                                    for (int np = 0; np < kNTx / 2; ++np)
#pragma unroll
                                        for (int mt = 0; mt < kMT; ++mt) {
                                            mma_bf16(dacc[mt][2 * np], a[mt], bw[np][0], bw[np][1]);
                                            mma_bf16(dacc[mt][2 * np + 1], a[mt], bw[np][2], bw[np][3]);
                                        }
                                }
                            }
                        }
                    }
                    __syncthreads();  // both stages free for the next block's slices
#pragma unroll
                    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
                        for (int nt = 0; nt < kNTx; ++nt)
#pragma unroll
                            for (int h = 0; h < 2; ++h) {
                                const int r = 32 * wm + 16 * mt + 8 * h + gq;
                                const int c = d0 + 32 * wn + 8 * nt + 2 * tq;
                                if (t0 + r < n_end && c < D) {
                                    const float a = a_s[r];
                                    const float v0 = fmaf(a, g_at(c), dacc[mt][nt][2 * h]);
                                    const float v1 = fmaf(a, g_at(c + 1), dacc[mt][nt][2 * h + 1]);
                                    Z* dst = dxb + (size_t)(t0 + r) * D + c;
                                    if ((D & 1) == 0) {  // c + 1 < D, dst aligned to the pair
                                        if constexpr (G::F32) {
                                            *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
                                        } else {
                                            *reinterpret_cast<uint32_t*>(dst) = pack_bf16(v0, v1);
                                        }
                                    } else if constexpr (G::F32) {
                                        dst[0] = v0;
                                        if (c + 1 < D) dst[1] = v1;
                                    } else {
                                        dst[0] = __float2bfloat16_rn(v0);
                                        if (c + 1 < D) dst[1] = __float2bfloat16_rn(v1);
                                    }
                                }
                            }
                }
            }
        }
    }
    cp_async_wait<0>();
    __syncthreads();  // every thread's column sums are in
    for (int j = tid; j < hid; j += kThreads) {
        ws_db1[part * hid + j] = sums[j] + sums[hid_p + j];
        ws_dw2[part * hid + j] = sums[2 * hid_p + j] + sums[3 * hid_p + j];
    }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <GOp OP, int HP>
cudaError_t launch_dz_general_hp(const void* x, const float* x_scale, const uint8_t* mask,
                                 const void* w1h, const void* w1l, const float* w1_scale,
                                 const void* w1dx, const float* b1, const float* w2,
                                 const float* g, const float* out, const float* m,
                                 const float* l, int B, int N, int D, int hid, int chunk, int S,
                                 bool with_dx, void* dz, void* dz_lo, float* ws_sums,
                                 float* ws_db1, float* ws_dw2, void* dx, cudaStream_t stream) {
    auto kernel = abmil_bwd_dz_general<OP, HP>;
    const int hid_p = gen_hid_pad(hid);
    const size_t smem = DzSmemG<OP, HP>::total(D, hid_p);
    cudaError_t err = set_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(S, B), kThreads, smem, stream>>>(x, x_scale, mask, w1h, w1l, w1_scale, w1dx, b1,
                                                   w2, g, out, m, l, N, D, hid, hid_p, gen_ld(D),
                                                   chunk, S, with_dx ? 1 : 0, dz, dz_lo, ws_sums,
                                                   ws_db1, ws_dw2, dx);
    return cudaGetLastError();
}

template <GOp OP>
cudaError_t launch_dz_general(int hp, const void* x, const float* x_scale, const uint8_t* mask,
                              const void* w1h, const void* w1l, const float* w1_scale,
                              const void* w1dx, const float* b1, const float* w2, const float* g,
                              const float* out, const float* m, const float* l, int B, int N,
                              int D, int hid, int chunk, int S, bool with_dx, void* dz,
                              void* dz_lo, float* ws_sums, float* ws_db1, float* ws_dw2,
                              void* dx, cudaStream_t stream) {
    // hp is gen_pass_cols': at most gen_max_pass(OP), whose instances alone exist
    if constexpr (gen_max_pass(OP) >= 256) {
        if (hp == 256) {
            return launch_dz_general_hp<OP, 256>(x, x_scale, mask, w1h, w1l, w1_scale, w1dx, b1,
                                                 w2, g, out, m, l, B, N, D, hid, chunk, S, with_dx,
                                                 dz, dz_lo, ws_sums, ws_db1, ws_dw2, dx, stream);
        }
    }
    if constexpr (gen_max_pass(OP) >= 128) {
        if (hp == 128) {
            return launch_dz_general_hp<OP, 128>(x, x_scale, mask, w1h, w1l, w1_scale, w1dx, b1,
                                                 w2, g, out, m, l, B, N, D, hid, chunk, S, with_dx,
                                                 dz, dz_lo, ws_sums, ws_db1, ws_dw2, dx, stream);
        }
    }
    return launch_dz_general_hp<OP, 64>(x, x_scale, mask, w1h, w1l, w1_scale, w1dx, b1, w2, g,
                                        out, m, l, B, N, D, hid, chunk, S, with_dx, dz, dz_lo,
                                        ws_sums, ws_db1, ws_dw2, dx, stream);
}

template <GOp OP>
size_t dz_general_smem(int hp, int D, int hid) {
    const int hid_p = gen_hid_pad(hid);
    if constexpr (gen_max_pass(OP) >= 256) {
        if (hp == 256) return DzSmemG<OP, 256>::total(D, hid_p);
    }
    if constexpr (gen_max_pass(OP) >= 128) {
        if (hp == 128) return DzSmemG<OP, 128>::total(D, hid_p);
    }
    return DzSmemG<OP, 64>::total(D, hid_p);
}

// bf16 and int8 at D = 512, hid = 256: pass 1 over chunks of chunk1 patches
// of each bag (S1 a bag), pass 2 over chunks of chunk2 of the B * N patch
// rows (S2 in all).  w1h, w1l: W1's bf16 hi and (int8) lo; dz, dz_lo: the
// workspace planes (lo: int8 only).
template <typename T>
cudaError_t launch_passes_bf16(const T* x, const float* x_scale, const uint8_t* mask,
                               const __nv_bfloat16* w1h, const __nv_bfloat16* w1l,
                               const float* b1, const float* w2, const float* g,
                               const float* out, const float* m, const float* l, int B, int N,
                               int chunk1, int S1, int chunk2, int S2, bool with_dx,
                               __nv_bfloat16* dz, __nv_bfloat16* dz_lo, __nv_bfloat16* dx,
                               float* ws_dw1, float* ws_db1, float* ws_dw2,
                               cudaStream_t stream) {
    cudaError_t err;
    const size_t smem1 = DzSmemB<T>::total;
    auto k1 = abmil_bwd_dz_bf16<T, false>;
    if constexpr (sizeof(T) == 2) {
        if (with_dx) k1 = abmil_bwd_dz_bf16<T, true>;
    }
    if ((err = set_smem(k1, smem1)) != cudaSuccess) return err;
    k1<<<dim3(S1, B), kThreads, smem1, stream>>>(x, x_scale, mask, w1h, w1l, b1, w2, g, out, m,
                                                 l, N, chunk1, S1, dz, dz_lo, ws_db1, ws_dw2,
                                                 dx);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if constexpr (sizeof(T) == 1) {
        const size_t smem2 = dw_smem_bytes<int8_t, true>();
        if ((err = set_smem(abmil_bwd_dw_i8<true>, smem2)) != cudaSuccess) return err;
        abmil_bwd_dw_i8<true><<<dim3(kDwTiles, S2), kThreads, smem2, stream>>>(
            x, dz, dz_lo, B * N, chunk2, kD, kHid, kHid, ws_dw1);
    } else {
        const size_t smem2 = dw_smem_bytes<__nv_bfloat16, false>();
        if ((err = set_smem(abmil_bwd_dw_bf16<true>, smem2)) != cudaSuccess) return err;
        abmil_bwd_dw_bf16<true><<<dim3(kDwTiles, S2), kThreads, smem2, stream>>>(
            x, dz, B * N, chunk2, kD, kHid, kHid, ws_dw1);
    }
    return cudaGetLastError();
}

// f32 at D = 512, hid = 256: pass 1 over chunks of chunk1 patches of each
// bag (S1 a bag), pass 2 over chunks of chunk2 of the B * N patch rows (S2 in
// all).
cudaError_t launch_passes_f32(const float* x, const uint8_t* mask, const float* w1,
                              const float* b1, const float* w2, const float* g,
                              const float* out, const float* m, const float* l, int B, int N,
                              int chunk1, int S1, int chunk2, int S2, bool with_dx, float* dz,
                              float* dx, float* ws_dw1, float* ws_db1, float* ws_dw2,
                              cudaStream_t stream) {
    cudaError_t err;
    const size_t smem1 = DsSmemF::total;
    if (with_dx) {
        if ((err = set_smem(abmil_bwd_dz_f32<true>, smem1)) != cudaSuccess) return err;
        abmil_bwd_dz_f32<true><<<dim3(S1, B), kThreads, smem1, stream>>>(
            x, mask, w1, b1, w2, g, out, m, l, N, chunk1, S1, dz, ws_db1, ws_dw2, dx);
    } else {
        if ((err = set_smem(abmil_bwd_dz_f32<false>, smem1)) != cudaSuccess) return err;
        abmil_bwd_dz_f32<false><<<dim3(S1, B), kThreads, smem1, stream>>>(
            x, mask, w1, b1, w2, g, out, m, l, N, chunk1, S1, dz, ws_db1, ws_dw2, nullptr);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const size_t smem2 = dw_smem_bytes<float, false>();
    if ((err = set_smem(abmil_bwd_dw_f32<true>, smem2)) != cudaSuccess) return err;
    abmil_bwd_dw_f32<true><<<dim3(kDwTiles, S2), kThreads, smem2, stream>>>(
        x, dz, B * N, chunk2, kD, kHid, kHid, ws_dw1);
    return cudaGetLastError();
}

// Any other width, or bf16's precise mode: W1 for the h product in w1_ws,
// laid out [hid_p, ld] (f32: its padded copy; bf16: its rounding, precise: hi and lo; int8: the forward's
// int8 split, its scales in w1_scale), the general pass 1 (its blocks'
// column sums in ws_sums [B * S1, 4, hid_p]), then pass 2 over the dz planes
// [B, N, hid_p] (f32; bf16; precise and int8 two planes).
cudaError_t launch_general(const void* x, const float* x_scale, const uint8_t* mask,
                           const float* w1, const float* b1, const float* w2, const float* g,
                           const float* out, const float* m, const float* l, int B, int N, int D,
                           int hid, int chunk1, int S1, int chunk2, int S2, int storage,
                           bool precise, bool with_dx, void* w1_ws, float* w1_scale, void* ds,
                           void* dx, float* ws_dw1, float* ws_sums, float* ws_db1,
                           float* ws_dw2, cudaStream_t stream) {
    const int hid_p = gen_hid_pad(hid), ld = gen_ld(D);
    const size_t n = (size_t)hid_p * ld;
    const int hp = gen_pass_cols(storage, hid);
    const size_t plane = (size_t)B * N * hid_p;
    const dim3 grid2(dw_tiles(D, hid), S2);
    cudaError_t err;
    if (storage == kF32) {
        float* wf = static_cast<float*>(w1_ws);
        pad_w1<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, stream>>>(w1, wf, hid,
                                                                                   D, ld, n);
        if ((err = cudaGetLastError()) != cudaSuccess) return err;
        err = launch_dz_general<GOp::kF32>(hp, x, nullptr, mask, wf, nullptr, nullptr, wf, b1, w2,
                                           g, out, m, l, B, N, D, hid, chunk1, S1, with_dx, ds,
                                           nullptr, ws_sums, ws_db1, ws_dw2, dx, stream);
        if (err != cudaSuccess) return err;
        const size_t smem2 = dw_smem_bytes<float, false>();
        auto k2 = (D % 4 == 0) ? abmil_bwd_dw_f32<true> : abmil_bwd_dw_f32<false>;
        if ((err = set_smem(k2, smem2)) != cudaSuccess) return err;
        k2<<<grid2, kThreads, smem2, stream>>>(
            static_cast<const float*>(x), static_cast<const float*>(ds), B * N, chunk2, D, hid,
            hid_p, ws_dw1);
        return cudaGetLastError();
    }
    __nv_bfloat16* dzb = static_cast<__nv_bfloat16*>(ds);
    if (storage == kI8) {
        int8_t* w1_i8 = static_cast<int8_t*>(w1_ws);
        err = launch_split_w1_i8(w1, hid, D, hid_p, ld, w1_i8, w1_scale, stream);
        if (err != cudaSuccess) return err;
        err = launch_dz_general<GOp::kI8>(hp, x, x_scale, mask, w1_i8, w1_i8 + n, w1_scale,
                                          nullptr, b1, w2, g, out, m, l, B, N, D, hid, chunk1, S1,
                                          false, dzb, dzb + plane, ws_sums, ws_db1, ws_dw2,
                                          nullptr, stream);
        if (err != cudaSuccess) return err;
        const size_t smem2 = dw_smem_bytes<int8_t, true>();
        auto k2 = (D % 16 == 0) ? abmil_bwd_dw_i8<true> : abmil_bwd_dw_i8<false>;
        if ((err = set_smem(k2, smem2)) != cudaSuccess) return err;
        k2<<<grid2, kThreads, smem2, stream>>>(static_cast<const int8_t*>(x), dzb, dzb + plane,
                                               B * N, chunk2, D, hid, hid_p, ws_dw1);
        return cudaGetLastError();
    }
    __nv_bfloat16* w1_bf16 = static_cast<__nv_bfloat16*>(w1_ws);
    if ((err = launch_prep_w1(w1, w1_bf16, precise, hid, D, hid_p, ld, stream)) != cudaSuccess) {
        return err;
    }
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
    if (precise) {
        err = launch_dz_general<GOp::kBf16P>(hp, x, nullptr, mask, w1_bf16, w1_bf16 + n, nullptr,
                                             w1_bf16, b1, w2, g, out, m, l, B, N, D, hid, chunk1,
                                             S1, with_dx, dzb, dzb + plane, ws_sums, ws_db1,
                                             ws_dw2, dx, stream);
        if (err != cudaSuccess) return err;
        const size_t smem2 = dw_smem_bytes<__nv_bfloat16, true>();
        auto k2 = (D % 8 == 0) ? abmil_bwd_dw_bf16_split<true> : abmil_bwd_dw_bf16_split<false>;
        if ((err = set_smem(k2, smem2)) != cudaSuccess) return err;
        k2<<<grid2, kThreads, smem2, stream>>>(xb, dzb, dzb + plane, B * N, chunk2, D, hid,
                                               hid_p, ws_dw1);
        return cudaGetLastError();
    }
    err = launch_dz_general<GOp::kBf16>(hp, x, nullptr, mask, w1_bf16, nullptr, nullptr, w1_bf16,
                                        b1, w2, g, out, m, l, B, N, D, hid, chunk1, S1, with_dx,
                                        dzb, nullptr, ws_sums, ws_db1, ws_dw2, dx, stream);
    if (err != cudaSuccess) return err;
    const size_t smem2 = dw_smem_bytes<__nv_bfloat16, false>();
    auto k2 = (D % 8 == 0) ? abmil_bwd_dw_bf16<true> : abmil_bwd_dw_bf16<false>;
    if ((err = set_smem(k2, smem2)) != cudaSuccess) return err;
    k2<<<grid2, kThreads, smem2, stream>>>(xb, dzb, B * N, chunk2, D, hid, hid_p, ws_dw1);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory of pass 1 (with or without dX) and pass 2.
size_t abmil_bwd_smem_bytes(int storage, int D, int hid, int precise, int pass) {
    const bool bf16_precise = storage == kBF16 && precise;
    if (pass == 2) {
        if (storage == kF32) return dw_smem_bytes<float, false>();
        if (storage == kI8) return dw_smem_bytes<int8_t, true>();
        return bf16_precise ? dw_smem_bytes<__nv_bfloat16, true>()
                            : dw_smem_bytes<__nv_bfloat16, false>();
    }
    if (special_widths(storage, D, hid, precise != 0)) {
        if (storage == kF32) return DsSmemF::total;
        if (storage == kBF16) return DzSmemB<__nv_bfloat16>::total;
        return DzSmemB<int8_t>::total;
    }
    const int hp = gen_pass_cols(storage, hid);
    switch (gen_op(storage, precise != 0)) {
        case GOp::kF32: return dz_general_smem<GOp::kF32>(hp, D, hid);
        case GOp::kBf16: return dz_general_smem<GOp::kBf16>(hp, D, hid);
        case GOp::kBf16P: return dz_general_smem<GOp::kBf16P>(hp, D, hid);
        default: return dz_general_smem<GOp::kI8>(hp, D, hid);
    }
}

// x [B, N, D] (storage: 0 f32, 1 bf16, 2 int8); x_scale [B, N] f32 for
// int8, else null; mask [B, N] bool; w1 [hid, D], b1 and w2 [hid] f32; g
// and out [B, D], m and l [B] f32 (the output's cotangent, the forward
// output and its stats); precise: bf16's precise mode.  Pass 1 runs S1
// blocks of chunk1 patches a bag, pass 2 the dW1 tiles on each of S2 chunks
// of chunk2 of the B * N patch rows.  Workspace: w1_ws W1 for pass 1 -- at
// D = 512, hid = 256 [2, hid, D] bf16 (W1's bf16 hi and, int8, lo; null for
// f32); on the general instances laid out [hid_p, ld] (gen_hid_pad,
// gen_ld): [2, ...] bf16 for bf16 (its rounding, and in precise mode the
// residual's), [2, ...] int8 for int8 (the forward's split), f32 [hid_p,
// ld] for f32 (its padded copy) -- and w1_scale [65] f32
// (int8 on the general instances: s_w and the partial maxima; else null);
// ds the dz workspace, [B, N, hid'] f32 (f32) or bf16 (bf16), or [2, B, N,
// hid'] bf16 (int8: s dz's hi and lo; precise: dz's), hid' = hid_p on the
// general instances; ws_dw1 [S2, hid, D], ws_db1 and ws_dw2 [B * S1, hid]
// f32; ws_sums [B * S1, 4, hid'] f32 on the general instances past hid' =
// kSmemHid (pass 1's column sums), else null.  Outputs: dx [B, N, D] in the storage type when with_dx (f32 and
// bf16 only; else null), dw1 [hid, D], db1 and dw2 [hid] f32.  All on CUDA
// device `device`; the kernels go to `stream`.  Returns the launches'
// cudaError_t (0 on success).
int abmil_bwd(const void* x, const void* x_scale, const void* mask, const void* w1,
              const void* b1, const void* w2, const void* g, const void* out, const void* m,
              const void* l, int B, int N, int D, int hid, int chunk1, int S1, int chunk2, int S2,
              int storage, int precise, int with_dx, int device, void* w1_ws, void* w1_scale,
              void* ds, void* ws_dw1, void* ws_sums, void* ws_db1, void* ws_dw2, void* dx,
              void* dw1, void* db1, void* dw2, void* stream) {
    const bool is_precise = precise != 0 && storage == kBF16;
    const bool special = special_widths(storage, D, hid, is_precise);
    const bool gen_i8 = storage == kI8 && !special;
    const bool needs_ws = storage != kF32 || !special;
    const bool sums_ws = !special && !hid_in_smem(gen_hid_pad(hid));
    if (B < 1 || N < 1 || S1 < 1 || S2 < 1 || chunk1 < 1 || chunk2 < 1 || !widths_ok(D, hid)
        || (storage != kF32 && storage != kBF16 && storage != kI8)
        || needs_ws != (w1_ws != nullptr) || gen_i8 != (w1_scale != nullptr)
        || (storage == kI8) != (x_scale != nullptr)
        || (with_dx != 0) != (dx != nullptr) || (with_dx && storage == kI8)
        || sums_ws != (ws_sums != nullptr)) {
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
    const float* gf = static_cast<const float*>(g);
    const float* of = static_cast<const float*>(out);
    const float* mf = static_cast<const float*>(m);
    const float* lf = static_cast<const float*>(l);
    __nv_bfloat16* wb = static_cast<__nv_bfloat16*>(w1_ws);
    __nv_bfloat16* dzb = static_cast<__nv_bfloat16*>(ds);
    float* w_dw1 = static_cast<float*>(ws_dw1);
    float* w_db1 = static_cast<float*>(ws_db1);
    float* w_dw2 = static_cast<float*>(ws_dw2);
    if (!special) {
        err = launch_general(x, xs, mk, w1f, b1f, w2f, gf, of, mf, lf, B, N, D, hid, chunk1, S1,
                             chunk2, S2, storage, is_precise, with_dx != 0, w1_ws,
                             static_cast<float*>(w1_scale), ds, dx, w_dw1,
                             static_cast<float*>(ws_sums), w_db1, w_dw2, st);
    } else if (storage == kF32) {
        err = launch_passes_f32(static_cast<const float*>(x), mk, w1f, b1f, w2f, gf, of, mf,
                                lf, B, N, chunk1, S1, chunk2, S2, with_dx != 0,
                                static_cast<float*>(ds), static_cast<float*>(dx), w_dw1, w_db1,
                                w_dw2, st);
    } else {
        err = launch_prep_w1(w1f, wb, storage == kI8, kHid, kD, kHid, kD, st);
        if (err != cudaSuccess) return (int)err;
        if (storage == kBF16) {
            err = launch_passes_bf16(static_cast<const __nv_bfloat16*>(x), nullptr, mk, wb,
                                     nullptr, b1f, w2f, gf, of, mf, lf, B, N, chunk1, S1, chunk2,
                                     S2, with_dx != 0, dzb, nullptr,
                                     static_cast<__nv_bfloat16*>(dx), w_dw1, w_db1, w_dw2, st);
        } else {
            err = launch_passes_bf16(static_cast<const int8_t*>(x), xs, mk, wb, wb + kHid * kD,
                                     b1f, w2f, gf, of, mf, lf, B, N, chunk1, S1, chunk2, S2,
                                     false, dzb, dzb + (size_t)B * N * kHid, nullptr, w_dw1,
                                     w_db1, w_dw2, st);
        }
    }
    if (err != cudaSuccess) return (int)err;
    const size_t total = (size_t)hid * D + 2 * (size_t)hid;
    abmil_bwd_reduce<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, st>>>(
        w_dw1, w_db1, w_dw2, S2, B * S1, D, hid, static_cast<float*>(dw1),
        static_cast<float*>(db1), static_cast<float*>(dw2));
    return (int)cudaGetLastError();
}

}  // extern "C"
