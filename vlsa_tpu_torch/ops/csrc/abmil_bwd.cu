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
// dz exists.  So, deterministic and without atomics, in three passes.
//
// bf16 and int8 (written to be right, not fast; nvcuda::wmma bf16 fragments,
// two products for int8's hi + lo, W1 streamed through shared memory as in
// abmil_fwd.cu).  They recompute h in both passes, so they do 6 (8 with dX)
// instead of 4 (6) D*hid operations per patch:
//   pass 1, blocks (chunk, bag), tiles of patches at full hid: h, the logit,
//     a, g . x[n] and ds[n], written to a [B, N] workspace; with dX, also dz
//     and the dX tile dz . W1 + a g, written in the storage type;
//   pass 2, blocks (hid slice of 32, chunk, bag): the slice of W1 stays in
//     shared memory; per tile, that slice of h is recomputed, dz formed from
//     ds, and the block's partials of dW1 [32, 512] (in tensor-core
//     accumulators), db1 and dw2 accumulated over its chunk, then written to
//     a workspace [B * S2, 256, 512];
//   pass 3 sums the B * S2 partials in a fixed order.
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
#include "abmil_common.cuh"

using namespace abmil;

namespace {

constexpr int kSlice = 32;      // hid columns of one pass-2 block
constexpr int kJs = 32;         // W1 rows per shared-memory slice of the dX product
constexpr int kHalf = kD / 2;   // dX columns per half of the tensor-core dX product

// Shared-memory carve-up of pass 1 (bf16 and int8 storage).
template <typename T, bool WITH_DX>
struct DsSmem {
    static constexpr int M = Tile<T>::M;
    // the dX product's W1 slice: [kJs][kHalf + pad] bf16
    static constexpr size_t w_dx = round128((size_t)kJs * (kHalf + kPadB) * 2);
    static constexpr size_t w_bytes =
        WITH_DX && w_dx > w_stage_bytes<T>() ? w_dx : w_stage_bytes<T>();
    static constexpr int ldz = kHid + kPadB;  // dz row stride
    static constexpr size_t x = 0;
    static constexpr size_t h = x + x_tile_bytes<T>();
    static constexpr size_t w = h + round128((size_t)M * kLdH * 4);
    static constexpr size_t dz = w + w_bytes;
    static constexpr size_t rows = dz + (WITH_DX ? round128((size_t)M * ldz * 2) : 0);
    // valid, scale, a [M] + g . out
    static constexpr size_t total = rows + round128((3 * (size_t)M + 4) * 4);
};

// Shared-memory carve-up of pass 2 (bf16 and int8 storage).
template <typename T>
struct DwSmem {
    static constexpr int M = Tile<T>::M;
    static constexpr int ldw = kD + kPadB;  // resident W1 slice rows
    static constexpr int ldh = kSlice + kPadF;
    static constexpr int ldt = M + kPadB;  // dz^T rows
    static constexpr int parts = sizeof(T) == 1 ? 2 : 1;   // int8: hi and lo
    static constexpr size_t x = 0;
    static constexpr size_t w = x + x_tile_bytes<T>();
    static constexpr size_t h = w + round128((size_t)parts * kSlice * ldw * 2);
    static constexpr size_t dzt = h + round128((size_t)M * ldh * 4);
    static constexpr size_t rows = dzt + round128((size_t)parts * kSlice * ldt * 2);
    // ds, scale [M]; the two end-of-block reduction buffers [kWarps][kSlice]
    // reuse the h tile, which keeps bf16 within the 115,712 bytes that let
    // two blocks share an SM
    static constexpr size_t total = rows + round128(2 * (size_t)M * 4);
    static_assert(M * ldh >= 2 * kWarps * kSlice, "the reduction buffers fit in the h tile");
};

// dX = dz . W1 + a g for the 64 rows of a tile on the bf16 tensor cores, in
// two halves of 256 columns; the f32 result goes through `hs` (free by then)
// and is written in bf16.  Warp w owns the columns [32w, 32w + 32) of a half.
__device__ void dx_tile_tc(const __nv_bfloat16* dzs, const __nv_bfloat16* __restrict__ w1h,
                           __nv_bfloat16* ws, float* hs, const float* a_s,
                           const float* __restrict__ gb, int t0, int n_end,
                           __nv_bfloat16* __restrict__ dxb) {
    using namespace nvcuda;
    constexpr int ldz = kHid + kPadB;
    constexpr int ldw = kHalf + kPadB;
    constexpr int kVec = kHalf / 8;
    const int warp = threadIdx.x >> 5;
    for (int half = 0; half < 2; ++half) {
        const int c0 = half * kHalf;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) wmma::fill_fragment(acc[mt][nt], 0.f);
        for (int j0 = 0; j0 < kHid; j0 += kJs) {
            __syncthreads();
            for (int i = threadIdx.x; i < kJs * kVec; i += kThreads) {
                const int j = i / kVec, c = i % kVec;
                reinterpret_cast<uint4*>(ws + j * ldw)[c] =
                    reinterpret_cast<const uint4*>(w1h + (size_t)(j0 + j) * kD + c0)[c];
            }
            __syncthreads();
#pragma unroll
            for (int kk = 0; kk < kJs; kk += 16) {
                wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bw[2];
#pragma unroll
                for (int nt = 0; nt < 2; ++nt)
                    wmma::load_matrix_sync(bw[nt], ws + kk * ldw + warp * 32 + nt * 16, ldw);
#pragma unroll
                for (int mt = 0; mt < 4; ++mt) {
                    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
                    wmma::load_matrix_sync(a, dzs + mt * 16 * ldz + j0 + kk, ldz);
#pragma unroll
                    for (int nt = 0; nt < 2; ++nt)
                        wmma::mma_sync(acc[mt][nt], a, bw[nt], acc[mt][nt]);
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
        // rows of 256 values as 32 groups of 8 bf16
        for (int i = threadIdx.x; i < 64 * (kHalf / 8); i += kThreads) {
            const int r = i / (kHalf / 8), c = 8 * (i % (kHalf / 8));
            if (t0 + r >= n_end) continue;
            const float a = a_s[r];
            __align__(16) __nv_bfloat162 v[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                v[k] = __floats2bfloat162_rn(
                    fmaf(a, gb[c0 + c + 2 * k], hs[r * kLdH + c + 2 * k]),
                    fmaf(a, gb[c0 + c + 2 * k + 1], hs[r * kLdH + c + 2 * k + 1]));
            }
            *reinterpret_cast<uint4*>(dxb + (size_t)(t0 + r) * kD + c0 + c) =
                *reinterpret_cast<const uint4*>(v);
        }
    }
}

// Pass 1 (bf16, int8): ds [B, N] and, WITH_DX, dX.  Grid (S1, B).
template <typename T, bool WITH_DX>
__global__ void __launch_bounds__(kThreads)
abmil_bwd_ds(const T* __restrict__ x, const float* __restrict__ x_scale,
             const uint8_t* __restrict__ mask, const __nv_bfloat16* __restrict__ w1h, const __nv_bfloat16* __restrict__ w1l,
             const float* __restrict__ b1, const float* __restrict__ w2,
             const float* __restrict__ g, const float* __restrict__ out,
             const float* __restrict__ m, const float* __restrict__ l, int N, int chunk,
             float* __restrict__ ds, T* __restrict__ dx) {
    using L = DsSmem<T, WITH_DX>;
    using XS = typename Staged<T>::type;
    using DZ = typename Staged<T>::type;  // dz in the dX product's operand type
    constexpr int M = L::M;
    constexpr int ldx = XLd<T>::value;
    extern __shared__ __align__(128) unsigned char smem[];
    XS* xs = reinterpret_cast<XS*>(smem + L::x);
    float* hs = reinterpret_cast<float*>(smem + L::h);
    void* wst = smem + L::w;
    DZ* dzs = reinterpret_cast<DZ*>(smem + L::dz);
    float* valid_s = reinterpret_cast<float*>(smem + L::rows);
    float* scale_s = valid_s + M;
    float* a_s = scale_s + M;
    float* gout_s = a_s + M;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int b = blockIdx.y;
    const int n_begin = blockIdx.x * chunk;
    const int n_end = min(N, n_begin + chunk);
    const T* xb = x + (size_t)b * N * kD;
    const uint8_t* mb = mask + (size_t)b * N;
    const float* gb = g + (size_t)b * kD;
    const float m_b = m[b], l_b = l[b];

    float b1r[kHid / 32], w2r[kHid / 32], gr[kD / 32];
#pragma unroll
    for (int c = 0; c < kHid / 32; ++c) {
        b1r[c] = b1[lane + 32 * c];
        w2r[c] = w2[lane + 32 * c];
    }
#pragma unroll
    for (int c = 0; c < kD / 32; ++c) gr[c] = gb[lane + 32 * c];
    if (warp == 0) {
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < kD / 32; ++c) s += gr[c] * out[(size_t)b * kD + lane + 32 * c];
        s = warp_sum(s);
        if (lane == 0) gout_s[0] = s;
    }

    for (int t0 = n_begin; t0 < n_end; t0 += M) {
        stage_x(xb, t0, n_end, xs, M);
        for (int r = tid; r < M; r += kThreads) {
            const int n = t0 + r;
            const bool valid = n < n_end && mb[n] != 0;
            valid_s[r] = valid ? 1.f : 0.f;
            scale_s[r] = (valid && x_scale != nullptr) ? x_scale[(size_t)b * N + n] : 1.f;
        }
        h_gemm<T>(xs, w1h, w1l, wst, hs);  // synchronises before and after
        const float gout = gout_s[0];

        for (int r = warp; r < M; r += kWarps) {
            const float sr = scale_s[r];
            float hv[kHid / 32];
            float s = 0.f, gx = 0.f;
#pragma unroll
            for (int c = 0; c < kHid / 32; ++c) {
                hv[c] = tanhf(fmaf(hs[r * kLdH + lane + 32 * c], sr, b1r[c]));
                s += hv[c] * w2r[c];
            }
#pragma unroll
            for (int c = 0; c < kD / 32; ++c)
                gx = fmaf(gr[c], to_float(xs[r * ldx + lane + 32 * c]), gx);
            s = warp_sum(s);
            gx = warp_sum(gx);
            const bool valid = valid_s[r] != 0.f;
            const float a = valid ? expf(s - m_b) / l_b : 0.f;  // 0 first: see the top
            const float d = a * (gx * sr - gout);
            const int n = t0 + r;
            if (lane == 0 && n < n_end) ds[(size_t)b * N + n] = d;
            if constexpr (WITH_DX) {
                if (lane == 0) a_s[r] = a;
#pragma unroll
                for (int c = 0; c < kHid / 32; ++c) {
                    const float dz = d * w2r[c] * (1.f - hv[c] * hv[c]);
                    dzs[r * L::ldz + lane + 32 * c] = __float2bfloat16(dz);
                }
            }
        }
        if constexpr (WITH_DX) {
            __syncthreads();
            dx_tile_tc(dzs, w1h, static_cast<__nv_bfloat16*>(wst), hs, a_s, gb, t0, n_end,
                       dx + (size_t)b * N * kD);
        }
        __syncthreads();  // xs, hs and the rows are rewritten by the next tile
    }
}

// Pass 2 (bf16, int8): partial dW1, db1, dw2 of hid slice blockIdx.x over
// chunk blockIdx.y of bag blockIdx.z.  Grid (kHid / kSlice, S2, B).
template <typename T>
__global__ void __launch_bounds__(kThreads)
abmil_bwd_dw(const T* __restrict__ x, const float* __restrict__ x_scale,
             const uint8_t* __restrict__ mask, const __nv_bfloat16* __restrict__ w1h, const __nv_bfloat16* __restrict__ w1l,
             const float* __restrict__ b1, const float* __restrict__ w2,
             const float* __restrict__ ds, int N, int chunk, int S,
             float* __restrict__ ws_dw1, float* __restrict__ ws_db1,
             float* __restrict__ ws_dw2) {
    using L = DwSmem<T>;
    using XS = typename Staged<T>::type;
    constexpr int M = L::M;
    constexpr int ldx = XLd<T>::value;
    constexpr bool kSplit = sizeof(T) == 1;
    extern __shared__ __align__(128) unsigned char smem[];
    XS* xs = reinterpret_cast<XS*>(smem + L::x);
    XS* w1s = reinterpret_cast<XS*>(smem + L::w);        // [parts][kSlice][ldw]
    float* hs = reinterpret_cast<float*>(smem + L::h);   // [M][ldh]
    XS* dzt = reinterpret_cast<XS*>(smem + L::dzt);      // [parts][kSlice][ldt]
    float* ds_s = reinterpret_cast<float*>(smem + L::rows);
    float* scale_s = ds_s + M;
    float* red_b = hs;                                   // [kWarps][kSlice], after the loop
    float* red_w = red_b + kWarps * kSlice;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int j0 = blockIdx.x * kSlice;
    const int split = blockIdx.y, b = blockIdx.z;
    const int n_begin = split * chunk;
    const int n_end = min(N, n_begin + chunk);
    const T* xb = x + (size_t)b * N * kD;
    const uint8_t* mb = mask + (size_t)b * N;

    // the slice's rows of W1, resident for the whole chunk
    constexpr int kVec = kD / 8;
    for (int i = tid; i < kSlice * kVec; i += kThreads) {
        const int j = i / kVec, c = i % kVec;
        reinterpret_cast<uint4*>(w1s + j * L::ldw)[c] =
            reinterpret_cast<const uint4*>(w1h + (size_t)(j0 + j) * kD)[c];
        if (kSplit) {
            reinterpret_cast<uint4*>(w1s + (kSlice + j) * L::ldw)[c] =
                reinterpret_cast<const uint4*>(w1l + (size_t)(j0 + j) * kD)[c];
        }
    }
    const int jj = tid & (kSlice - 1);  // this thread's slice column in the elementwise step
    const float b1j = b1[j0 + jj], w2j = w2[j0 + jj];
    float db_acc = 0.f, dw_acc = 0.f;

    using namespace nvcuda;
    // dW1 partial: tensor cores, 2 x 4 accumulator tiles per warp (columns
    // [64w, 64w + 64))
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_tc[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) wmma::fill_fragment(acc_tc[mt][nt], 0.f);

    for (int t0 = n_begin; t0 < n_end; t0 += M) {
        stage_x(xb, t0, n_end, xs, M);
        for (int r = tid; r < M; r += kThreads) {
            const int n = t0 + r;
            const bool in_range = n < n_end;
            // pass 1 wrote ds = 0 for masked patches
            ds_s[r] = in_range ? ds[(size_t)b * N + n] : 0.f;
            scale_s[r] = (in_range && x_scale != nullptr && mb[n] != 0)
                ? x_scale[(size_t)b * N + n] : 1.f;
        }
        __syncthreads();

        // the slice of h_pre: [M, kSlice]
        {
            // warp w: row tile w & 3, column tile w >> 2
            const int mt = warp & 3, nt = warp >> 2;
            wmma::fragment<wmma::accumulator, 16, 16, 16, float> h;
            wmma::fill_fragment(h, 0.f);
            for (int k = 0; k < kD; k += 16) {
                wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
                wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bw;
                wmma::load_matrix_sync(a, xs + mt * 16 * ldx + k, ldx);
                wmma::load_matrix_sync(bw, w1s + nt * 16 * L::ldw + k, L::ldw);
                wmma::mma_sync(h, a, bw, h);
                if (kSplit) {
                    wmma::load_matrix_sync(bw, w1s + (kSlice + nt * 16) * L::ldw + k, L::ldw);
                    wmma::mma_sync(h, a, bw, h);
                }
            }
            wmma::store_matrix_sync(hs + mt * 16 * L::ldh + nt * 16, h, L::ldh,
                                    wmma::mem_row_major);
        }
        __syncthreads();

        // dz = ds w2 (1 - h^2); db1, dw2 in registers; s dz as the dW1 operand
        for (int r = tid >> 5; r < M; r += kWarps) {
            const float sr = scale_s[r], d = ds_s[r];
            const float hv = tanhf(fmaf(hs[r * L::ldh + jj], sr, b1j));
            const float dz = d * w2j * (1.f - hv * hv);
            db_acc += dz;
            dw_acc += d * hv;
            const float v = dz * sr;
            const __nv_bfloat16 hi = __float2bfloat16(v);
            dzt[jj * L::ldt + r] = hi;
            if (kSplit) {
                dzt[(kSlice + jj) * L::ldt + r] = __float2bfloat16(v - __bfloat162float(hi));
            }
        }
        __syncthreads();

        // dW1 partial += (s dz)^T [kSlice, M] . x [M, kD]
        {
#pragma unroll
            for (int kk = 0; kk < M; kk += 16) {
                wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bx[4];
#pragma unroll
                for (int nt = 0; nt < 4; ++nt)
                    wmma::load_matrix_sync(bx[nt], xs + kk * ldx + warp * 64 + nt * 16, ldx);
#pragma unroll
                for (int mt = 0; mt < 2; ++mt) {
                    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
                    wmma::load_matrix_sync(a, dzt + mt * 16 * L::ldt + kk, L::ldt);
#pragma unroll
                    for (int nt = 0; nt < 4; ++nt)
                        wmma::mma_sync(acc_tc[mt][nt], a, bx[nt], acc_tc[mt][nt]);
                    if (kSplit) {
                        wmma::load_matrix_sync(a, dzt + (kSlice + mt * 16) * L::ldt + kk, L::ldt);
#pragma unroll
                        for (int nt = 0; nt < 4; ++nt)
                            wmma::mma_sync(acc_tc[mt][nt], a, bx[nt], acc_tc[mt][nt]);
                    }
                }
            }
        }
        __syncthreads();  // xs, hs, dz^T and the rows are rewritten by the next tile
    }

    const size_t part = (size_t)b * S + split;
    float* dst = ws_dw1 + part * kHid * kD + (size_t)j0 * kD;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
            wmma::store_matrix_sync(dst + (size_t)mt * 16 * kD + warp * 64 + nt * 16,
                                    acc_tc[mt][nt], kD, wmma::mem_row_major);
    red_b[warp * kSlice + jj] = db_acc;  // lanes 0-31 of each warp: jj = lane
    red_w[warp * kSlice + jj] = dw_acc;
    __syncthreads();
    if (tid < kSlice) {
        float sb = 0.f, sw = 0.f;
        for (int w = 0; w < kWarps; ++w) {
            sb += red_b[w * kSlice + tid];
            sw += red_w[w * kSlice + tid];
        }
        ws_db1[part * kHid + j0 + tid] = sb;
        ws_dw2[part * kHid + j0 + tid] = sw;
    }
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

// f32 pass 2: dW1 = sum_k dz[k]^T x[k] over the K = B * N patch rows of the
// batch (dz and x as [K, kHid] and [K, kD]; dz is 0 on masked rows), a
// split-K GEMM in split TF32.  Block (tile, split) owns the dW1 tile
// [kDwM, kDwN] number `tile` over the rows [split * chunk, +chunk) and
// writes it to ws_dw1[split]; the tiles of one split run side by side, so
// their dz and x rows come from device memory about once and from L2 for
// the rest.  Rows stream through kStagesDw cp.async stages of kRowsDw.
// Grid (kDwTiles, S2).
constexpr int kDwM = 128;                                 // hid rows of a dW1 tile
constexpr int kDwN = 128;                                 // D columns of a dW1 tile
constexpr int kDwTiles = (kHid / kDwM) * (kD / kDwN);     // 8
constexpr int kRowsDw = 32;                               // patch rows a slice (slice_3xtf32's depth)
constexpr int kLdDw = 128 + 8;                            // 136: k-major fragments (8t + g)
constexpr int kStagesDw = 4;
constexpr size_t kStageDw = 2 * (size_t)kRowsDw * kLdDw * 4;  // dz and x rows: 34,816
struct DwSmemF { static constexpr size_t total = kStagesDw * kStageDw; };

__global__ void __launch_bounds__(kThreads, 1)
abmil_bwd_dw_f32(const float* __restrict__ x, const float* __restrict__ dz, int K, int chunk,
                 float* __restrict__ ws_dw1) {
    extern __shared__ __align__(128) unsigned char smem[];
    float* stages = reinterpret_cast<float*>(smem);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int gq = lane >> 2, tq = lane & 3, wm = warp & 3, wn = warp >> 2;
    const int m0 = (blockIdx.x / (kD / kDwN)) * kDwM, n0 = (blockIdx.x % (kD / kDwN)) * kDwN;
    const int split = blockIdx.y;
    const int k_begin = split * chunk;
    const int k_end = min(K, k_begin + chunk);
    const int slices = (k_end - k_begin + kRowsDw - 1) / kRowsDw;

    auto load = [&](int s) {
        float* zs = stages + (s % kStagesDw) * (kStageDw / 4);
        float* xs = zs + kRowsDw * kLdDw;
        const int k = k_begin + s * kRowsDw;
        constexpr int kVec = 128 / 4;
        for (int i = tid; i < kRowsDw * kVec; i += kThreads) {
            const int r = i / kVec, c = 4 * (i % kVec);
            const bool ok = k + r < k_end;
            cp_async16(zs + r * kLdDw + c, ok ? dz + (size_t)(k + r) * kHid + m0 + c : dz, ok);
            cp_async16(xs + r * kLdDw + c, ok ? x + (size_t)(k + r) * kD + n0 + c : x, ok);
        }
    };
#pragma unroll
    for (int s = 0; s < kStagesDw - 1; ++s) {
        if (s < slices) load(s);
        cp_async_commit();
    }
    float acc[kMT][kNT][4];
    zero_acc(acc);
#pragma unroll 1
    for (int s = 0; s < slices; ++s) {
        cp_async_wait<kStagesDw - 2>();
        __syncthreads();  // slice s landed; stage (s - 1) % kStagesDw is consumed
        if (s + kStagesDw - 1 < slices) load(s + kStagesDw - 1);
        cp_async_commit();
        const float* zs = stages + (s % kStagesDw) * (kStageDw / 4);
        const float* xs = zs + kRowsDw * kLdDw;
        slice_3xtf32<true, true>(acc, zs + 32 * wm, kLdDw, xs + 64 * wn, kLdDw);
    }
    cp_async_wait<0>();

    float* dst = ws_dw1 + (size_t)split * kHid * kD;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = m0 + 32 * wm + 16 * mt + 8 * h + gq;
                const int c = n0 + 64 * wn + 8 * nt + 2 * tq;
                *reinterpret_cast<float2*>(dst + (size_t)r * kD + c) =
                    make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
            }
}

// Pass 3: dw1 = the sum of the K_w partials ws_dw1, db1 and dw2 those of
// the K_b partials ws_db1, ws_dw2, k in order.
__global__ void __launch_bounds__(kThreads)
abmil_bwd_reduce(const float* __restrict__ ws_dw1, const float* __restrict__ ws_db1,
                 const float* __restrict__ ws_dw2, int K_w, int K_b, float* __restrict__ dw1,
                 float* __restrict__ db1, float* __restrict__ dw2) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    constexpr int kW = kHid * kD;
    float s = 0.f;
    if (i < kW) {
        for (int k = 0; k < K_w; ++k) s += ws_dw1[(size_t)k * kW + i];
        dw1[i] = s;
    } else if (i < kW + kHid) {
        const int j = i - kW;
        for (int k = 0; k < K_b; ++k) s += ws_db1[(size_t)k * kHid + j];
        db1[j] = s;
    } else if (i < kW + 2 * kHid) {
        const int j = i - kW - kHid;
        for (int k = 0; k < K_b; ++k) s += ws_dw2[(size_t)k * kHid + j];
        dw2[j] = s;
    }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T>
cudaError_t launch_passes(const void* xv, const float* x_scale, const uint8_t* mask,
                          const __nv_bfloat16* w1_bf16, const float* b1,
                          const float* w2, const float* g, const float* out, const float* m,
                          const float* l, int B, int N, int chunk1, int S1, int chunk2,
                          int S2, bool with_dx, float* ds, void* dx, float* ws_dw1,
                          float* ws_db1, float* ws_dw2, cudaStream_t stream) {
    const T* x = static_cast<const T*>(xv);
    const __nv_bfloat16* w1l = w1_bf16 == nullptr ? nullptr : w1_bf16 + kHid * kD;
    cudaError_t err;
    if (with_dx) {
        if constexpr (sizeof(T) == 1) {
            return cudaErrorInvalidValue;  // int8 storage is data: no dX
        } else {
            auto k1 = abmil_bwd_ds<T, true>;
            const size_t smem = DsSmem<T, true>::total;
            if ((err = set_smem(k1, smem)) != cudaSuccess) return err;
            k1<<<dim3(S1, B), kThreads, smem, stream>>>(x, x_scale, mask, w1_bf16, w1l,
                                                        b1, w2, g, out, m, l, N, chunk1, ds,
                                                        static_cast<T*>(dx));
        }
    } else {
        auto k1 = abmil_bwd_ds<T, false>;
        const size_t smem = DsSmem<T, false>::total;
        if ((err = set_smem(k1, smem)) != cudaSuccess) return err;
        k1<<<dim3(S1, B), kThreads, smem, stream>>>(x, x_scale, mask, w1_bf16, w1l, b1,
                                                    w2, g, out, m, l, N, chunk1, ds, nullptr);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    auto k2 = abmil_bwd_dw<T>;
    const size_t smem2 = DwSmem<T>::total;
    if ((err = set_smem(k2, smem2)) != cudaSuccess) return err;
    k2<<<dim3(kHid / kSlice, S2, B), kThreads, smem2, stream>>>(
        x, x_scale, mask, w1_bf16, w1l, b1, w2, ds, N, chunk2, S2, ws_dw1, ws_db1,
        ws_dw2);
    return cudaGetLastError();
}

// f32: pass 1 over chunks of chunk1 patches of each bag (S1 a bag), pass 2
// over chunks of chunk2 of the B * N patch rows (S2 in all).
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
    if ((err = set_smem(abmil_bwd_dw_f32, DwSmemF::total)) != cudaSuccess) return err;
    abmil_bwd_dw_f32<<<dim3(kDwTiles, S2), kThreads, DwSmemF::total, stream>>>(
        x, dz, B * N, chunk2, ws_dw1);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory of pass 1 (with or without dX) and pass 2.
size_t abmil_bwd_smem_bytes(int storage, int pass, int with_dx) {
    if (storage == kF32) return pass == 2 ? DwSmemF::total : DsSmemF::total;
    if (storage == kBF16) {
        return pass == 2 ? DwSmem<__nv_bfloat16>::total
                         : with_dx ? DsSmem<__nv_bfloat16, true>::total
                                   : DsSmem<__nv_bfloat16, false>::total;
    }
    return pass == 2 ? DwSmem<int8_t>::total : DsSmem<int8_t, false>::total;
}

// x [B, N, 512] (storage: 0 f32, 1 bf16, 2 int8); x_scale [B, N] f32 for
// int8, else null; mask [B, N] bool; w1 [256, 512], b1 and w2 [256] f32;
// g and out [B, 512], m and l [B] f32 (the output's cotangent, the forward
// output and its stats).  Pass 1 runs S1 blocks of chunk1 patches a bag.
// bf16 and int8: pass 2 runs S2 blocks of chunk2 patches a bag for each hid
// slice; workspace w1_bf16 [2, 256, 512] bf16, ds [B, N], ws_dw1
// [B * S2, 256, 512], ws_db1 and ws_dw2 [B * S2, 256] f32.  f32: pass 2
// runs 8 dW1 tiles on each of S2 chunks of chunk2 of the B * N patch rows;
// workspace w1_bf16 null, ds the dz workspace [B, N, 256], ws_dw1
// [S2, 256, 512], ws_db1 and ws_dw2 [B * S1, 256] f32.
// Outputs: dx [B, N, 512] in the storage type when with_dx (f32 and bf16
// only; else null), dw1 [256, 512], db1 and dw2 [256] f32.  All on CUDA
// device `device`; the kernels go to `stream`.  Returns the launches'
// cudaError_t (0 on success).
int abmil_bwd(const void* x, const void* x_scale, const void* mask, const void* w1,
              const void* b1, const void* w2, const void* g, const void* out, const void* m,
              const void* l, int B, int N, int chunk1, int S1, int chunk2, int S2,
              int storage, int with_dx, int device, void* w1_bf16, void* ds, void* ws_dw1,
              void* ws_db1, void* ws_dw2, void* dx, void* dw1, void* db1, void* dw2,
              void* stream) {
    if (B < 1 || N < 1 || S1 < 1 || S2 < 1 || chunk1 < 1 || chunk2 < 1
        || (storage != kF32 && w1_bf16 == nullptr)
        || (storage == kI8) != (x_scale != nullptr)
        || (with_dx != 0) != (dx != nullptr) || (with_dx && storage == kI8)) {
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
    __nv_bfloat16* wb = static_cast<__nv_bfloat16*>(w1_bf16);
    float* dsf = static_cast<float*>(ds);
    float* w_dw1 = static_cast<float*>(ws_dw1);
    float* w_db1 = static_cast<float*>(ws_db1);
    float* w_dw2 = static_cast<float*>(ws_dw2);
    if (storage != kF32) {
        err = launch_prep_w1(w1f, wb, storage == kI8, st);
        if (err != cudaSuccess) return (int)err;
    }
    if (storage == kF32) {
        err = launch_passes_f32(static_cast<const float*>(x), mk, w1f, b1f, w2f, gf, of, mf,
                                lf, B, N, chunk1, S1, chunk2, S2, with_dx != 0, dsf,
                                static_cast<float*>(dx), w_dw1, w_db1, w_dw2, st);
    } else if (storage == kBF16) {
        err = launch_passes<__nv_bfloat16>(x, xs, mk, wb, b1f, w2f, gf, of, mf, lf, B,
                                           N, chunk1, S1, chunk2, S2, with_dx != 0, dsf, dx,
                                           w_dw1, w_db1, w_dw2, st);
    } else if (storage == kI8) {
        err = launch_passes<int8_t>(x, xs, mk, wb, b1f, w2f, gf, of, mf, lf, B, N,
                                    chunk1, S1, chunk2, S2, false, dsf, nullptr, w_dw1,
                                    w_db1, w_dw2, st);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return (int)err;
    const int total = kHid * kD + 2 * kHid;
    const int k_w = storage == kF32 ? S2 : B * S2, k_b = storage == kF32 ? B * S1 : B * S2;
    abmil_bwd_reduce<<<(total + kThreads - 1) / kThreads, kThreads, 0, st>>>(
        w_dw1, w_db1, w_dw2, k_w, k_b, static_cast<float*>(dw1), static_cast<float*>(db1),
        static_cast<float*>(dw2));
    return (int)cudaGetLastError();
}

}  // extern "C"
