// Masked co-attention pooling forward for Hopper (sm_90a).
//
// Replaces the TPU kernel body vlsa_tpu/ops/coattn.py:254 _coattn_fwd_body
// and its four launch variants (_coattn_fwd_kernel :316, _coattn_fwd_kernel_q8
// :322, _coattn_fwd_kernel_q8i :328, _coattn_fwd_kernel_i :336).  For each
// bag b and query p:
//
//     logits[p,n] = scale * inv[n] * (q[p] . x[n])      (-1e30 where masked)
//     out[b,p]    = sum_n softmax_n(logits)[p,n] * s[n] * x[n]
//
// with inv[n] = rsqrt(max(|x[n]|^2, 1e-24)) computed here (an f32 sum of
// squares of the stored values) or read from the host, and s[n] the
// per-patch int8 dequant scale (1 for float storage).  The softmax of int8
// rows uses the raw int8 values: the normalised logits do not depend on the
// per-patch scale, which only weights the PV sum.  Returned: out and the
// softmax stats m (the running max, -1e30 for an empty bag) and l (clamped
// below at 1e-30) that the dQ and dX kernels consume.
//
// Rounding (the TPU kernel's _stream_matmul, vlsa_tpu/ops/coattn.py:207-237).
// bf16 and int8: both products on the bf16 tensor cores (mma.sync m16n8k16,
// f32 accumulation) with q and the PV weights split into bf16 hi + lo (~16
// bits) as _mm_rows splits them; bf16 x multiplies as stored, int8 x as its
// exact bf16 value (the TPU's int8 route rounds q and the weights to int8 hi
// + lo, ~15 bits: this is a little more exact).  f32, which the TPU takes at
// HIGHEST precision: split TF32 (mma.sync m16n8k8) with q, x and the weights
// each hi + lo and three products lo.hi + hi.lo + hi.hi (~2^-21 relative, the
// split of ABMIL's f32 kernels), in chains of at most 12 products into a
// fresh accumulator (the tensor cores' f32 accumulation truncates).  The
// plain model of both roundings is ops/coattn.py::coattn_fwd_rounded.
//
// What bounds it on an H100: x is read once (B*N*C*itemsize bytes) and every
// element takes 4*16 operations a query group of 16 rows, twice that
// for the bf16 hi + lo split (32 a byte of bf16) and three times for split
// TF32 at half bf16's rate (48 a byte of f32): far below the ~295 a byte at
// which the bf16 tensor cores become the limit.  The byte stream is the floor
// (chip_smoke.py::bound), and the design below keeps loads in flight, the
// products on the tensor cores and the SMs in one wave to approach it.
// What is left above it is the fixed cost of a tile -- two block barriers, the cross-warp sum of the
// logits and the softmax's warp reductions -- which the products and the
// loads in flight do not hide: bf16 and int8 take 64-patch tiles (one such
// cost per 64 KB of bf16), f32 32-patch ones (its ring fills the shared
// memory at 32).
//
// Design.
// - Grid: one block of ceil(C/64) warps (at most 8) per SM (its shared memory
//   fills the SM), persistent over the flat range [k*L, (k+1)*L) of the B*Tb
//   tiles (Tb = ceil(N / tile) a bag, L = ceil(B*Tb / SMs): every block takes
//   the same number of tiles, one wave).  A range can cross bag boundaries:
//   at the end of each bag's stretch the block writes that stretch's partial
//   (m, l, acc) to slot k - first_block(b) of the bag, and coattn_fwd_merge
//   combines each bag's partials in slot order: deterministic, no atomics.
//   At B=8, N=10240, P=12 the 128 blocks' ranges end on bag boundaries: 128
//   partials of 24 KB, 3.7% of bf16 x's 84 MB, written once and read once.
// - Warp w owns the channels [64w, 64w + 64): it streams that column slice of
//   every tile into its own ring of shared-memory stages with cp.async (16
//   bytes a lane; bf16 2 stages of 8 KB a warp, int8 3 of 4 KB, f32 3 of
//   8 KB: 64-192 KB an SM in flight while the block computes), waits for it
//   with its own wait_group and __syncwarp: the x ring needs no block
//   barrier.  Rows are 16-byte chunks XOR-swizzled by the row (slice_off),
//   so that every fragment load and the cp.async stores hit distinct banks.
// - Logits: q's slice is held in registers as hi + lo A fragments for the
//   whole kernel; the warp's partial q . x [16, tile] over its 64 channels
//   (ldmatrix B fragments) goes to shared memory with the slice's partial
//   sums of squares; after a barrier each warp takes query rows r = w + nw k,
//   two side by side, sums the partials (lane = patches lane + 32 u), applies
//   scale, inv and the mask, and updates the rows' online softmax (m, l in
//   shared memory); the weights p * s go to shared memory (bf16 hi + lo, or
//   f32 for split TF32), the correction e^(m_old - m_new) beside them.
// - PV: after a second barrier every warp forms the tile's [16, 64] product
//   of the weights and its slice (bf16: ldmatrix A and ldmatrix.trans B;
//   f32: 32-bit loads) into a fresh accumulator, and adds it to the running
//   [16, 64] f32 accumulator in registers, rescaled by the correction (the
//   tensor cores' f32 accumulation truncates low bits at every product: a
//   chain of thousands of tiles would drift).
// - int8 slices are first converted, lane = row, into a bf16 plane (exact),
//   which also gives the row's f32 sum of squares; bf16 and f32 take their
//   squares from the logits' B fragments.
// - Width.  Any C that is a multiple of 8 up to 512 runs the instance above:
//   channels past C are zero-filled (C < 512 runs fewer warps, C=8 one warp
//   whose slice is mostly zeros).  C > 512 runs the wide instance of the same
//   kernel: G = ceil(C/512) channel groups, blocks (range, group) of 8 warps,
//   L chosen so that the G * ranges blocks make one wave.  Block group g
//   streams a tile's G slices of warp w (channels 512 m + 64 w, m = 0..G-1,
//   in that order, so every group sums the logits alike) through the same
//   ring, accumulating the partial logits, with q's fragments of each group
//   loaded from global memory; then its own group's slice once more for PV,
//   writing the channels [512 g, 512 g + 512) of the partials (group 0 also
//   m and l).  x is read G + 1 times, the last from L2 as a rule.  Any N: the
//   ragged last tile is masked here.
// - Queries.  Any P >= 1: the P queries are QG = ceil(P/16) query groups of
//   16 rows (one mma tile, the last zero-padded: its padded rows get no
//   softmax row and are never written), and the group is the grid's z
//   dimension, an outer dimension of the persistent plan: block (range,
//   channel group, query group) pools the rows [16 z, 16 z + 16) of its
//   range, with that group's q fragments, and writes those rows of the
//   partials and the stats.  L = ceil(B*Tb / floor(SMs / (QG * G))) keeps
//   the QG * G * ranges blocks in one wave, so the QG blocks of a range run
//   side by side over the same tiles: x is read QG times (QG (G + 1) wide),
//   all but the first as a rule from L2, against the one pass of the bound.
//   The merge's partials [B, Smax, P, C] grow with P but Smax shrinks as L
//   grows: at B=8, N=10240, P=128 (QG = 8, bf16 L = 80 on 132 SMs) a bag
//   spans at most 2 ranges, 4.2 MB of f32 partials against bf16 x's 84 MB.
//   P <= 16 is QG = 1, the instance and plan of before.
#include "coattn_common.cuh"

using namespace coattn;

namespace {

// The ring's stages, and the bf16 planes a slice is converted to (int8: its
// exact values; bf16 and f32: none, the products read the ring).
__host__ __device__ constexpr int stages_of(int storage) { return storage == kBF16 ? 2 : 3; }
__host__ __device__ constexpr int planes_of(int storage) { return storage == kI8 ? 1 : 0; }

// Shared-memory carve-up of a block of nw warps (byte offsets).
struct FwdSmem {
    size_t ring, conv, red, w, rows, total;
    __host__ __device__ FwdSmem(int nw, int storage) {
        const int tile = tile_of(storage);
        const size_t slice = (size_t)tile * kWarpCh * storage_itemsize(storage);
        ring = 0;                                                         // [nw][stages] slices
        conv = ring + (size_t)nw * stages_of(storage) * slice;            // [nw][planes] bf16 slices
        red = conv + (size_t)nw * planes_of(storage) * tile * kPlaneRow;  // [nw][17][ld] f32
        // the PV weights: [2][16][ld] bf16 (hi, lo) or [16][tile + 4] f32
        w = red + (size_t)nw * (kRows + 1) * ld_of(tile) * 4;
        rows = w + 2 * (size_t)kRows * ld_of(tile) * 2;                  // corr, m, l [16] f32
        total = rows + 3 * kRows * 4;
    }
};

// Kernel arguments (see coattn_fwd below).
struct FwdArgs {
    const float* q;
    const void* x;
    const float* x_scale;
    const float* x_inv;
    const uint8_t* mask;
    float scale;
    int N, C, P, Tb, total, L, Smax;
    float* ws_m;
    float* ws_l;
    float* ws_acc;
    int qz0;  // the launch's first query group (grid z counts from it)
};

// The warp's partial logits q . x [16, tile] over its 64 channels of the
// slice xh (f32 and bf16: the ring slot; int8: its bf16 plane) to red_w
// [16][ld] and, for bf16 and f32 unless HOST_INV, the tile rows' partial sums
// of squares to red_w[16][.]; `add` adds both to what is there (the wide
// instance's later channel groups).
template <int ST, bool HOST_INV>
__device__ __forceinline__ void slice_logits(const unsigned char* xh,
                                             const uint32_t (&qh)[qsteps_of(ST)][4],
                                             const uint32_t (&ql)[qsteps_of(ST)][4],
                                             float* red_w, bool add, int lane) {
    constexpr int TT = tile_of(ST), kLd = ld_of(TT);
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < TT / 8; ++j) {
        float s[4] = {0.f, 0.f, 0.f, 0.f};
        float sq = 0.f;
        if constexpr (ST == kF32) {
            // two chains of 12 products (channels [0, 32) and [32, 64))
            float s2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                // b[u] = x[8j + g][16 kk + 4u + t]: k-step 2 kk in b[0], b[1],
                // k-step 2 kk + 1 in b[2], b[3]
                uint32_t b[4], bh[4], bl[4];
                ldsm_x4(b, xh + slice_off<kF32>(8 * j + (lane & 7), 4 * kk + (lane >> 3)));
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const float v = __uint_as_float(b[u]);
                    sq = fmaf(v, v, sq);
                    split_tf32(v, bh[u], bl[u]);
                }
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    if (kk < 2) mma_3xtf32(s, qh[2 * kk + h], ql[2 * kk + h], bh + 2 * h, bl + 2 * h);
                    else mma_3xtf32(s2, qh[2 * kk + h], ql[2 * kk + h], bh + 2 * h, bl + 2 * h);
                }
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) s[i] += s2[i];
        } else {
            uint32_t b[8];
            ldsm_x4(b, xh + plane_off(8 * j + (lane & 7), lane >> 3));
            ldsm_x4(b + 4, xh + plane_off(8 * j + (lane & 7), 4 + (lane >> 3)));
#pragma unroll
            for (int ks = 0; ks < 4; ++ks) {
                mma_bf16(s, qh[ks], b[2 * ks], b[2 * ks + 1]);
                mma_bf16(s, ql[ks], b[2 * ks], b[2 * ks + 1]);
            }
            if constexpr (ST == kBF16) {
                // b holds x[8j + g][16 ks + 2t + {0, 1, 8, 9}]
#pragma unroll
                for (int k = 0; k < 8; ++k) {
                    const float2 v = unpack_bf16(b[k]);
                    sq = fmaf(v.x, v.x, fmaf(v.y, v.y, sq));
                }
            }
        }
        if constexpr (ST != kI8 && !HOST_INV) {
            // this lane's squares of row 8j + g, summed over the quad
            sq += __shfl_xor_sync(0xffffffffu, sq, 1);
            sq += __shfl_xor_sync(0xffffffffu, sq, 2);
            float* d = red_w + kRows * kLd + 8 * j + g;
            if (t == 0) *d = (add ? *d : 0.f) + sq;
        }
        float2* d0 = reinterpret_cast<float2*>(red_w + g * kLd + 8 * j + 2 * t);
        float2* d1 = reinterpret_cast<float2*>(red_w + (g + 8) * kLd + 8 * j + 2 * t);
        const float2 o0 = add ? *d0 : make_float2(0.f, 0.f), o1 = add ? *d1 : make_float2(0.f, 0.f);
        *d0 = make_float2(o0.x + s[0], o0.y + s[1]);
        *d1 = make_float2(o1.x + s[2], o1.y + s[3]);
    }
}

// Per-patch sidecars of patch n0 + i of tile f: the mask, the dequant scale
// (0 where invalid) and the host 1/||x||.
struct PatchRow {
    bool valid;
    float sc, inv;
};

template <int TT, bool HOST_INV, bool HAS_SCALE>
__device__ __forceinline__ PatchRow patch_row(const FwdArgs& a, int f, int i) {
    const int b = f / a.Tb, n = (f - b * a.Tb) * TT + i;
    const size_t k = (size_t)b * a.N + n;
    PatchRow row;
    row.valid = n < a.N && a.mask[k] != 0;
    row.sc = HAS_SCALE ? (row.valid ? a.x_scale[k] : 0.f) : 1.f;
    row.inv = HOST_INV && row.valid ? a.x_inv[k] : 0.f;
    return row;
}

template <int ST, bool HOST_INV, bool WIDE>
__global__ void __launch_bounds__(kMaxWarps * 32, 1) coattn_fwd_stream(const FwdArgs a) {
    constexpr bool HAS_SCALE = ST == kI8;
    constexpr int R = stages_of(ST);
    constexpr int TT = tile_of(ST), kU = TT / 32;  // patches a tile, a lane
    constexpr int kLd = ld_of(TT), kLdWF = TT + 4;
    constexpr int kPB = TT * kPlaneRow;            // bytes a plane
    constexpr int kSlice = TT * kWarpCh * (ST == kF32 ? 4 : ST == kBF16 ? 2 : 1);
    extern __shared__ __align__(128) unsigned char smem[];
    const int nw = blockDim.x >> 5;
    const FwdSmem lay(nw, ST);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int ch0 = warp * kWarpCh;                // within a channel group
    // the block's query group: rows [q0, q0 + P) of the caller's P
    const int q0 = ((int)blockIdx.z + a.qz0) * kRows, P = min(kRows, a.P - q0);
    const float* qg = a.q + (size_t)q0 * a.C;
    // the wide instance: G channel groups, this block pools group grp; a
    // tile is G logit items and one PV item of the ring
    const int G = WIDE ? (int)gridDim.y : 1, grp = WIDE ? (int)blockIdx.y : 0;
    const int nI = WIDE ? G + 1 : 1;
    unsigned char* ring = smem + lay.ring + (size_t)warp * R * kSlice;
    unsigned char* plane = smem + lay.conv + (size_t)warp * planes_of(ST) * kPB;
    float* red = reinterpret_cast<float*>(smem + lay.red);
    float* red_w = red + warp * (kRows + 1) * kLd;
    __nv_bfloat16* w_hi = reinterpret_cast<__nv_bfloat16*>(smem + lay.w);
    __nv_bfloat16* w_lo = w_hi + kRows * kLd;
    float* w_f = reinterpret_cast<float*>(smem + lay.w);
    float* corr_s = reinterpret_cast<float*>(smem + lay.rows);
    float* m_s = corr_s + kRows;
    float* l_s = m_s + kRows;

    const int f0 = blockIdx.x * a.L;
    const int ntiles = min(a.total, f0 + a.L) - f0;
    const int nitems = ntiles * nI;
    // item k: tile f0 + k / nI; its channel group k % nI, or grp for the PV
    // item; into slot k % R
    const void* x = a.x;
    const int N = a.N, C = a.C, Tb = a.Tb;
    auto issue = [=](int k) {
        const int m = k % nI;
        const int cg = WIDE ? (m < G ? m : grp) * kGroupCh : 0;
        issue_tile<ST>(x, N, C, Tb, f0 + k / nI, ring + (k % R) * kSlice, cg + ch0, lane);
    };

    // the first R - 1 items of the block's range, one commit group each
#pragma unroll
    for (int s = 0; s < R - 1; ++s) {
        if (s < nitems) issue(s);
        cp_async_commit();
    }

    uint32_t qh[qsteps_of(ST)][4], ql[qsteps_of(ST)][4];
    if constexpr (!WIDE) load_frags<ST>(qg, P, a.C, ch0, lane, qh, ql);
    for (int i = tid; i < 2 * kRows * kLd; i += blockDim.x) w_hi[i] = __float2bfloat16(0.f);
    if (tid < kRows) {
        m_s[tid] = kNegInf;
        l_s[tid] = 0.f;
    }
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
    // lane's patches lane + 32 u of the next tile
    PatchRow next[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u)
        next[u] = ntiles > 0 ? patch_row<TT, HOST_INV, HAS_SCALE>(a, f0, lane + 32 * u)
                             : PatchRow{false, 0.f, 0.f};
    __syncthreads();

#pragma unroll 1
    for (int i = 0; i < ntiles; ++i) {
        const int f = f0 + i;
        PatchRow cur[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) cur[u] = next[u];
        const unsigned char* xh = nullptr;  // the slice the products read
        // item m of the tile: its slice lands, then (logit items) its logits
        auto item = [&](int m) {
            const int k = i * nI + m;
            __syncwarp();  // every lane is done with the slot refilled below
            if (k + R - 1 < nitems) issue(k + R - 1);
            cp_async_commit();
            if (m == 0 && i + 1 < ntiles) {
#pragma unroll
                for (int u = 0; u < kU; ++u)
                    next[u] = patch_row<TT, HOST_INV, HAS_SCALE>(a, f + 1, lane + 32 * u);
            }
            cp_async_wait<R - 1>();
            __syncwarp();  // item k landed for every lane
            const bool logits = !WIDE || m < G;
            xh = ring + (k % R) * kSlice;
            if constexpr (ST == kI8) {
#pragma unroll
                for (int u = 0; u < kU; ++u) {
                    const float sq = convert_row(xh, plane, lane + 32 * u);
                    float* d = red_w + kRows * kLd + lane + 32 * u;
                    if (!HOST_INV && logits) *d = (m > 0 ? *d : 0.f) + sq;
                }
                __syncwarp();
                xh = plane;
            }
            if (logits) {
                if constexpr (WIDE) load_frags<ST>(qg, P, C, m * kGroupCh + ch0, lane, qh, ql);
                slice_logits<ST, HOST_INV>(xh, qh, ql, red_w, m > 0, lane);
            }
        };
        if constexpr (WIDE) {
#pragma unroll 1
            for (int m = 0; m < nI; ++m) item(m);
        } else {
            item(0);
        }
        __syncthreads();  // every warp's partials are in

        // ---- online softmax of query rows r = warp + nw k; lane = patches
        // lane + 32 u.  A warp takes its rows two at a time (r0 and r0 + nw),
        // side by side, so that their sums and warp reductions overlap ----
        float sinv[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
            float inv = cur[u].inv;
            if (!HOST_INV) {
                float sq = 0.f;
#pragma unroll
                for (int w = 0; w < kMaxWarps; ++w)
                    if (w < nw) sq += red[(w * (kRows + 1) + kRows) * kLd + lane + 32 * u];
                inv = rsqrtf(fmaxf(sq, 1e-24f));
            }
            sinv[u] = a.scale * inv;
        }
        for (int r0 = warp; r0 < P; r0 += 2 * nw) {
            const bool two = r0 + nw < P;
            const int r1 = two ? r0 + nw : r0;  // the second row, or r0 again (not written)
            float lg0[kU], lg1[kU];
            float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
            for (int u = 0; u < kU; ++u) {
                float dot0 = 0.f, dot1 = 0.f;
#pragma unroll
                for (int w = 0; w < kMaxWarps; ++w) {
                    if (w < nw) {
                        dot0 += red[(w * (kRows + 1) + r0) * kLd + lane + 32 * u];
                        dot1 += red[(w * (kRows + 1) + r1) * kLd + lane + 32 * u];
                    }
                }
                lg0[u] = cur[u].valid ? sinv[u] * dot0 : kNegInf;
                lg1[u] = cur[u].valid ? sinv[u] * dot1 : kNegInf;
                mx0 = fmaxf(mx0, lg0[u]);
                mx1 = fmaxf(mx1, lg1[u]);
            }
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) {
                mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
                mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
            }
            const float mp0 = m_s[r0], mp1 = m_s[r1];
            const float mn0 = fmaxf(mp0, mx0), mn1 = fmaxf(mp1, mx1);
            float s0 = 0.f, s1 = 0.f;
#pragma unroll
            for (int u = 0; u < kU; ++u) {
                const float p0 = cur[u].valid ? __expf(lg0[u] - mn0) : 0.f;
                const float p1 = cur[u].valid ? __expf(lg1[u] - mn1) : 0.f;
                s0 += p0;
                s1 += p1;
                const int n = lane + 32 * u;
                if constexpr (ST == kF32) {
                    w_f[r0 * kLdWF + n] = p0;
                    if (two) w_f[r1 * kLdWF + n] = p1;
                } else {
                    __nv_bfloat16 hi, lo;
                    split_bf16(p0 * cur[u].sc, hi, lo);
                    w_hi[r0 * kLd + n] = hi;
                    w_lo[r0 * kLd + n] = lo;
                    if (two) {
                        split_bf16(p1 * cur[u].sc, hi, lo);
                        w_hi[r1 * kLd + n] = hi;
                        w_lo[r1 * kLd + n] = lo;
                    }
                }
            }
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) {
                s0 += __shfl_xor_sync(0xffffffffu, s0, o);
                s1 += __shfl_xor_sync(0xffffffffu, s1, o);
            }
            if (lane == 0) {
                const float c0 = expf(mp0 - mn0);
                corr_s[r0] = c0;
                l_s[r0] = l_s[r0] * c0 + s0;
                m_s[r0] = mn0;
                if (two) {
                    const float c1 = expf(mp1 - mn1);
                    corr_s[r1] = c1;
                    l_s[r1] = l_s[r1] * c1 + s1;
                    m_s[r1] = mn1;
                }
            }
        }
        __syncthreads();  // the weights and corrections are in

        // ---- PV: acc = acc * corr + W [16, TT] . x [TT, 64] ----
        const float c_lo = corr_s[g], c_hi = corr_s[g + 8];
        if constexpr (ST == kF32) {
            // split TF32, 4 k-steps of 8 patches: 12 products a chain
            uint32_t ah[TT / 8][4], al[TT / 8][4];
#pragma unroll
            for (int ks = 0; ks < TT / 8; ++ks)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    split_tf32(w_f[(g + 8 * (e & 1)) * kLdWF + 8 * ks + t + 4 * (e >> 1)],
                               ah[ks][e], al[ks][e]);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                // B fragments: x[8 ks + t (+4)][8j + g] of the slice
                const int col = 8 * j + g;
                const unsigned char* xc = xh + 4 * (col & 3);
                float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
                for (int ks = 0; ks < TT / 8; ++ks) {
                    uint32_t bh[2], bl[2];
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const float v = *reinterpret_cast<const float*>(
                            xc + slice_off<kF32>(8 * ks + t + 4 * h, col >> 2));
                        split_tf32(v, bh[h], bl[h]);
                    }
                    mma_3xtf32(part, ah[ks], al[ks], bh, bl);
                }
                acc[j][0] = fmaf(acc[j][0], c_lo, part[0]);
                acc[j][1] = fmaf(acc[j][1], c_lo, part[1]);
                acc[j][2] = fmaf(acc[j][2], c_hi, part[2]);
                acc[j][3] = fmaf(acc[j][3], c_hi, part[3]);
            }
        } else {
            uint32_t ah[TT / 16][4], al[TT / 16][4];
            const int wr = (lane & 7) + 8 * ((lane >> 3) & 1), wc = 8 * (lane >> 4);
#pragma unroll
            for (int ks = 0; ks < TT / 16; ++ks) {
                ldsm_x4(ah[ks], w_hi + wr * kLd + 16 * ks + wc);
                ldsm_x4(al[ks], w_lo + wr * kLd + 16 * ks + wc);
            }
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
                for (int h = 0; h < kU; ++h) {
                    // patches [32 h, 32 h + 32) of the slice, k-steps 2h and 2h + 1
                    uint32_t bx[4];
                    ldsm_x4_t(bx, xh + plane_off(32 * h + lane, j));
                    mma_bf16(part, ah[2 * h], bx[0], bx[1]);
                    mma_bf16(part, al[2 * h], bx[0], bx[1]);
                    mma_bf16(part, ah[2 * h + 1], bx[2], bx[3]);
                    mma_bf16(part, al[2 * h + 1], bx[2], bx[3]);
                }
                acc[j][0] = fmaf(acc[j][0], c_lo, part[0]);
                acc[j][1] = fmaf(acc[j][1], c_lo, part[1]);
                acc[j][2] = fmaf(acc[j][2], c_hi, part[2]);
                acc[j][3] = fmaf(acc[j][3], c_hi, part[3]);
            }
        }

        // ---- the end of a bag's stretch: its partial (m, l, acc) ----
        const int b = f / a.Tb;
        if (f - b * a.Tb == a.Tb - 1 || i == ntiles - 1) {
            const size_t part = (size_t)b * a.Smax + (blockIdx.x - (b * a.Tb) / a.L);
            float* dst = a.ws_acc + (part * a.P + q0) * a.C;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int c = grp * kGroupCh + ch0 + 8 * j + 2 * t;
                if (c < a.C) {
                    if (g < P) *reinterpret_cast<float2*>(dst + (size_t)g * a.C + c) =
                        make_float2(acc[j][0], acc[j][1]);
                    if (g + 8 < P) *reinterpret_cast<float2*>(dst + (size_t)(g + 8) * a.C + c) =
                        make_float2(acc[j][2], acc[j][3]);
                }
#pragma unroll
                for (int k = 0; k < 4; ++k) acc[j][k] = 0.f;
            }
            if (tid < P) {
                if (grp == 0) {
                    a.ws_m[part * a.P + q0 + tid] = m_s[tid];
                    a.ws_l[part * a.P + q0 + tid] = l_s[tid];
                }
                m_s[tid] = kNegInf;
                l_s[tid] = 0.f;
            }
        }
    }
    cp_async_wait<0>();
}

// Merge each bag's partials: m = max_s m_s, l = sum_s l_s e^(m_s - m),
// out = sum_s acc_s e^(m_s - m) / max(l, 1e-30), s in slot order over the
// blocks whose ranges touch the bag.  Grid (P, B).
__global__ void __launch_bounds__(kThreads)
coattn_fwd_merge(const float* __restrict__ ws_m, const float* __restrict__ ws_l,
                 const float* __restrict__ ws_acc, int C, int P, int Tb, int L, int Smax,
                 float* __restrict__ out, float* __restrict__ m_out,
                 float* __restrict__ l_out) {
    extern __shared__ float4 smem_f4[];
    float* e_s = reinterpret_cast<float*>(smem_f4);  // [Smax]
    __shared__ float red_s[kWarps];
    __shared__ float m_all, l_all;

    const int p = blockIdx.x;
    const int b = blockIdx.y;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int S = Tb > 0 ? ((b + 1) * Tb - 1) / L - (b * Tb) / L + 1 : 0;
    const float* mb = ws_m + (size_t)b * Smax * P;
    const float* lb = ws_l + (size_t)b * Smax * P;

    float mx = kNegInf;
    for (int s = tid; s < S; s += kThreads) mx = fmaxf(mx, mb[s * P + p]);
    mx = warp_max(mx);
    if (lane == 0) red_s[warp] = mx;
    __syncthreads();
    if (tid == 0) {
        float v = red_s[0];
        for (int w = 1; w < kWarps; ++w) v = fmaxf(v, red_s[w]);
        m_all = v;
    }
    __syncthreads();
    const float m = m_all;

    float ls = 0.f;
    for (int s = tid; s < S; s += kThreads) {
        const float e = expf(mb[s * P + p] - m);
        e_s[s] = e;
        ls += lb[s * P + p] * e;
    }
    ls = warp_sum(ls);
    __syncthreads();  // red_s reuse
    if (lane == 0) red_s[warp] = ls;
    __syncthreads();
    if (tid == 0) {
        float v = 0.f;
        for (int w = 0; w < kWarps; ++w) v += red_s[w];
        l_all = fmaxf(v, 1e-30f);
        m_out[(size_t)b * P + p] = m;
        l_out[(size_t)b * P + p] = l_all;
    }
    __syncthreads();
    const float inv_l = 1.f / l_all;

    const float* ab = ws_acc + (size_t)b * Smax * P * C + (size_t)p * C;
    float* ob = out + ((size_t)b * P + p) * C;
    for (int c = tid; c < C; c += kThreads) {
        float v = 0.f;
        for (int s = 0; s < S; ++s) v += ab[(size_t)s * P * C + c] * e_s[s];
        ob[c] = v * inv_l;
    }
}

// The streaming kernel over every query group: one launch of grid z =
// ceil(P / 16), or past kMaxQueryGroups one launch a chunk of that many
// groups, each from its first group (a.qz0).
template <int ST, bool HOST_INV, bool WIDE>
cudaError_t launch_stream(FwdArgs a, cudaStream_t stream) {
    auto kernel = coattn_fwd_stream<ST, HOST_INV, WIDE>;
    const int nw = warps_of(a.C);
    const size_t smem = FwdSmem(nw, ST).total;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    const int qg = query_groups_of(a.P);
    for (a.qz0 = 0; a.qz0 < qg; a.qz0 += kMaxQueryGroups) {
        const int qz = min(kMaxQueryGroups, qg - a.qz0);
        kernel<<<dim3((a.total + a.L - 1) / a.L, groups_of(a.C), qz), 32 * nw, smem, stream>>>(a);
        if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    return cudaSuccess;
}

template <int ST>
cudaError_t launch_storage(const FwdArgs& a, cudaStream_t stream) {
    const bool inv = a.x_inv != nullptr, wide = a.C > kGroupCh;
    if (wide) return inv ? launch_stream<ST, true, true>(a, stream)
                         : launch_stream<ST, false, true>(a, stream);
    return inv ? launch_stream<ST, true, false>(a, stream) : launch_stream<ST, false, false>(a, stream);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory of a streaming block for width C (0: C is
// not taken, it must be a positive multiple of 8).  P is not needed.
size_t coattn_fwd_smem_bytes(int P, int C, int storage) {
    (void)P;
    if (C < 8 || C % 8 != 0) return 0;
    return FwdSmem(warps_of(C), storage).total;
}

// q [P, C] f32 (any P >= 1); x [B, N, C] (storage: 0 f32, 1 bf16, 2 int8);
// x_scale [B, N] f32 for int8, else null; x_inv [B, N] f32 or null; mask
// [B, N] bool.  The streaming kernel runs ceil(B*Tb / L) blocks of L tiles
// (Tb = ceil(N / tile) a bag) for each of the ceil(C / 512) channel groups
// and ceil(P / 16) query groups (launched in chunks of kMaxQueryGroups
// groups past that many); workspace ws_m,
// ws_l [B, Smax, P] and ws_acc [B, Smax, P, C] f32, Smax the most blocks a
// bag's tiles span.  Outputs: out [B, P, C], m and l [B, P] f32.  All on
// CUDA device `device`; the kernels go to `stream`.  Returns the launches'
// cudaError_t (0 on success).
int coattn_fwd(const void* q, const void* x, const void* x_scale, const void* x_inv,
               const void* mask, float scale, int B, int N, int C, int P, int L, int Smax,
               int storage, int device, void* ws_m, void* ws_l, void* ws_acc, void* out,
               void* m_out, void* l_out, void* stream) {
    if (P < 1 || coattn_fwd_smem_bytes(P, C, storage) == 0 || B < 1 || N < 0
        || L < 1 || Smax < 0 || (storage == kI8) != (x_scale != nullptr)
        || (storage != kF32 && storage != kBF16 && storage != kI8)) {
        return (int)cudaErrorInvalidValue;
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int Tb = (N + tile_of(storage) - 1) / tile_of(storage);
    const FwdArgs a{static_cast<const float*>(q), x, static_cast<const float*>(x_scale),
                    static_cast<const float*>(x_inv), static_cast<const uint8_t*>(mask), scale,
                    N, C, P, Tb, B * Tb, L, Smax, static_cast<float*>(ws_m),
                    static_cast<float*>(ws_l), static_cast<float*>(ws_acc), 0};
    if (a.total > 0) {
        if (Smax < 1) return (int)cudaErrorInvalidValue;
        err = storage == kF32 ? launch_storage<kF32>(a, st)
              : storage == kBF16 ? launch_storage<kBF16>(a, st) : launch_storage<kI8>(a, st);
        if (err != cudaSuccess) return (int)err;
    }
    const size_t merge_smem = sizeof(float) * (size_t)Smax;
    if (merge_smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    coattn_fwd_merge<<<dim3(P, B), kThreads, merge_smem, st>>>(
        a.ws_m, a.ws_l, a.ws_acc, C, P, Tb, L, Smax, static_cast<float*>(out),
        static_cast<float*>(m_out), static_cast<float*>(l_out));
    return (int)cudaGetLastError();
}

}  // extern "C"
