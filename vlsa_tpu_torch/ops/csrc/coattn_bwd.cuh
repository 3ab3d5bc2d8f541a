// Masked co-attention pooling, backward, for Hopper (sm_90a): the body that
// coattn_bwd_dq.cu (dq only) and coattn_bwd_dx.cu (dq and dX) instantiate.
//
// From the forward's stats (m, l) and output `out`, for each bag b, query p
// and patch n, with inv[n] = rsqrt(max(|x[n]|^2, 1e-24)) (or the host's
// 1/||x||) and s[n] the int8 dequant scale (1 for float storage):
//
//     raw[p,n] = q[p] . x[n],   dA[p,n] = s[n] * (g[p] . x[n])
//     a[p,n]   = exp(scale * inv[n] * raw[p,n] - m[p]) / l[p]   (0 where masked)
//     dl[p,n]  = a[p,n] * (dA[p,n] - g[p] . out[p]) * inv[n]
//     dq[p]    = scale * sum_b sum_n dl[p,n] * x[n]
//     dX[n]    = sum_p a'[p,n] g'[p] + scale * sum_p dl'[p,n] q[p] - x[n] * coef[n]
//     coef[n]  = scale * inv[n]^2 * sum_p dl'[p,n] raw[p,n]
//
// on the stored values (raw int8 for int8).  coef[n] x[n] is the TPU
// kernel's x[n] inv^2 (x[n] . dxhat[n]) with the row's dots in place of a
// second pass over it.  A prime marks a value rounded to bf16 for bf16
// storage (vlsa_tpu/ops/coattn.py:386-395: a, dl and g enter the dX products
// as bf16, q as f32); f32 storage rounds nothing.  An empty bag has m =
// -1e30 and l = 1e-30: a is masked to 0 before any product, so masked rows,
// the ragged edge and empty bags give dX = 0 exactly and add nothing to dq.
//
// Rounding.  bf16 and int8 storage: the [q; g] . x^T dots, the dq product
// dl . x and dX's q term on the bf16 tensor cores (mma.sync m16n8k16, f32
// accumulation) with q, g and dl as bf16 hi + lo (~16 bits, the TPU's
// _mm_rows(q, g) / _stream_matmul([dl_inv], x), :439 and :450; :368 and
// :397 in its dX kernel); x multiplies as stored (int8 through an exact bf16
// plane); dX's a' g' and dl' q terms take a', g' = g_hi and dl' = dl_hi as
// the exact bf16 values they are.  f32 storage, which the TPU takes at
// HIGHEST precision: split TF32 (mma.sync m16n8k8), each operand hi + lo and
// three products lo.hi + hi.lo + hi.hi (~2^-21 relative), in chains of at
// most 12 products into a fresh accumulator.  Every tile's dq product goes
// into a fresh accumulator that is added on the CUDA cores to a running f32
// one: the tensor cores' f32 accumulation truncates.
//
// What bounds it on an H100: x is read once (dX also written once), B*N*C
// bytes in x's type, and the tensor cores do 3 * 2 * 16 (dq) or 6 * 2 * 16
// (dX) multiply-adds an element a query group for bf16 hi + lo -- 96 or
// 192 operations a byte of bf16, 3xTF32 about as many a byte of f32 at half
// the rate -- below the ~295 a byte at which the bf16 tensor cores bound, so
// the byte stream is the floor (chip_smoke.py::bound_dq, ::bound_dx), with
// the products close behind; the per-tile row work (two barriers, the
// cross-warp sums of the dots, one exp a weight) comes on top.
//
// Design (the forward's, coattn_fwd.cu).
// - Grid: one block of ceil(C/64) warps (at most 8) per SM, persistent over
//   the flat range [k*L, (k+1)*L) of the B*Tb tiles (ops/coattn.py::
//   fwd_plan: one wave).  dq sums over bags, so block k keeps one [P, 64]
//   f32 register accumulator a warp over its whole range and writes it to
//   row k of the workspace [blocks, P, C]; coattn_bwd_reduce sums the rows
//   in block order: deterministic, no atomics.  Where the range enters a bag the
//   block loads that bag's m, 1/l, s_row = g . out and g.
// - Warp w streams the slice [64w, 64w + 64) of each tile's channels through
//   its own 2-stage cp.async ring (XOR-swizzled rows, coattn_common.cuh);
//   int8 slices become an exact bf16 plane, which also gives the rows' sums
//   of squares (bf16 and f32 take them from the dots' B fragments).
// - Dots: q (and, for bf16 and int8, g) as hi + lo A fragments in registers
//   (f32: g staged in shared memory, split at use); the warp's partials
//   q . x and g . x [2P, tile] over its 64 channels go to shared memory; after
//   a barrier each warp takes 8 patches of the tile, lanes = 8 patches x 4
//   query rows apart: it sums the warps' partials, forms a, dl (and a', the
//   lane group's sum for coef) and writes the weights (bf16 hi + lo, or f32)
//   to shared memory.
// - After a second barrier each warp forms dl [16, tile] . x [tile, 64] into
//   a fresh accumulator (ldmatrix A and ldmatrix.trans B; f32 32-bit B
//   loads) and, with dX, dX [tile, 64] = a'^T g' + scale dl'^T q - x coef
//   with K = P padded to 16: A fragments of a' and dl' by ldmatrix.trans,
//   B fragments of g' and q hi + lo by movmatrix from the dots' A fragments
//   (f32: from g in shared memory and q through the read-only cache); x's
//   term from the ring slot, which the result overwrites in x's type and
//   then leaves in 16-byte stores.
// - Width: any C that is a multiple of 8.  C <= 512 runs the instance above
//   (channels past C zero-filled).  C > 512 runs the wide instance: blocks
//   (range, group) for the G = ceil(C/512) channel groups share the wave; a
//   tile is G dot items (the slices of every group, in one order, so every
//   group's blocks sum the dots alike, with q and g loaded for each) and one
//   product item, its own group's slice once more: x is read G + 1 times.
// - Queries.  Any P >= 1, as ceil(P/16) query groups of 16 rows (one mma
//   tile, the last zero-padded).  dQ only: the group is the grid's z, an
//   outer dimension of the plan (ops/coattn.py::kernel_plan: the QG blocks
//   of a range share the wave and read its tiles side by side, x QG times,
//   as a rule from L2 after the first); block (range, channel group, query
//   group) writes its group's rows of the dq partial.  P <= 16 is QG = 1,
//   the instance and plan of before.  dX: P is the dX product's reduction,
//   so P > 16 runs the looped instance (LOOP): on each staged tile it walks
//   the query groups -- the group's q and g fragments from global memory
//   (L2), its dots and weights (rows past P get a = dl = 0: a zero query row
//   has a uniform softmax, which would leak into dX), its dq product added
//   to the block's rows of the workspace (the groups' [16, 64] partials do
//   not fit the registers), its share of coef, and its a'g' + scale dl'q
//   into a per-warp dX [tile, 64] held in registers -- then writes dX - x
//   coef once.  That dX accumulator is 64 f32 registers a thread at tiles
//   of 32 patches (bf16); f32's split-TF32 fragments spill at 32, so f32
//   takes 16 (loop_tile_of).  Each group's stats (m, 1/l and s_row = g .
//   out, which coattn_srow forms once a call for every row) are staged with
//   its q rows as the tile walks the groups: 16 rows in shared memory, so
//   the block does not grow with P.  The dQ kernel past kMaxQueryGroups
//   groups is launched a chunk of groups at a time (a.qz0, its first).
//   x is read once a tile (wide: QG (G + 1) times); q and g are re-read
//   from L2 for each group and tile, and the workspace rows of dq written
//   and read back, against the one pass of the bound.
#pragma once

#include "coattn_common.cuh"

namespace coattn {

constexpr int kBwdStages = 2;       // ring stages a warp
constexpr int kLdG = kWarpCh + 4;   // row stride (floats) of f32 storage's staged g
// Patches a tile of the looped dX instance (P > 16): its dX [tile, 64] a warp
// sums over the query groups in registers, 64 of them a thread at 32
// patches (bf16); f32 takes 16, whose split-TF32 fragments leave no room for
// 32 (ptxas: 92 bytes of spills).
__host__ __device__ constexpr int loop_tile_of(int storage) { return storage == kF32 ? 16 : 32; }

// The looped instance: dX with more than one query group.
__host__ __device__ constexpr bool loops_groups(int P, bool with_dx) { return with_dx && P > kRows; }
// Patches a tile of the backward's instance for P queries.
__host__ __device__ constexpr int bwd_tile_of(int storage, int P, bool with_dx) {
    return loops_groups(P, with_dx) ? loop_tile_of(storage) : tile_of(storage);
}

// Shared-memory carve-up of a backward block of nw warps for P queries (byte
// offsets).  The dots' partials hold min(P, 16) rows, one query group, and
// the rows' stats the 16 of the query group at hand.
struct BwdSmem {
    size_t ring, conv, red, gs, w, wbytes, rows, total;
    __host__ __device__ BwdSmem(int nw, int storage, int P, bool with_dx) {
        const int tile = bwd_tile_of(storage, P, with_dx), ld = ld_of(tile);
        const int pr = P < kRows ? P : kRows;
        const size_t slice = (size_t)tile * kWarpCh * storage_itemsize(storage);
        ring = 0;                                                         // [nw][2] slices
        conv = ring + (size_t)nw * kBwdStages * slice;                    // [nw] int8 planes
        red = conv + (storage == kI8 ? (size_t)nw * tile * kPlaneRow : 0);  // [nw][2pr + 1][ld] f32
        gs = red + (size_t)nw * (2 * pr + 1) * ld * 4;                    // [nw][16][kLdG] f32 g
        w = gs + (storage == kF32 ? (size_t)nw * kRows * kLdG * 4 : 0);
        // the weights: f32 dl [, a] [16][tile + 4]; else bf16 dl hi, dl lo [, a'] [16][ld]
        wbytes = storage == kF32 ? (size_t)(with_dx ? 2 : 1) * kRows * (tile + 4) * 4
                                 : (size_t)(with_dx ? 3 : 2) * kRows * ld * 2;
        rows = w + wbytes;
        // m, 1/l, s_row [16]; coef, host inv, dequant scale [tile] f32; valid [tile]
        total = rows + (size_t)(3 * kRows + 3 * tile) * 4 + tile;
    }
};

// Kernel arguments (see coattn_bwd_dq / coattn_bwd_dx).
struct BwdArgs {
    const float* q;
    const void* x;
    const float* x_scale;
    const float* x_inv;
    const uint8_t* mask;
    float scale;
    const float* g;
    const float* out;
    const float* m;
    const float* l;
    int N, C, P, Tb, total, L;
    float* ws_dq;
    void* dx;
    int qz0;      // the launch's first query group (grid z counts from it)
    float* srow;  // the looped instance: s_row = g . out [B, P] (coattn_srow)
};

// The 8x8 b16 matrix of a fragment register, transposed (lane l then holds
// the elements [2(l%4)][l/4] and [2(l%4) + 1][l/4] of the original).
__device__ __forceinline__ uint32_t mov_t(uint32_t v) {
    uint32_t d;
    asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(d) : "r"(v));
    return d;
}

// Rows [0, 16) of a query group's g [P, C] (P of them, rows at stride C) at
// the channels [ch0, ch0 + 64) into the warp's f32 staging (zero past P and
// C).
__device__ __forceinline__ void stage_g(const float* __restrict__ gb, int P, int C, int ch0,
                                        int lane, float* gs_w) {
    __syncwarp();  // no lane still reads the slice it replaces
    for (int i = lane; i < kRows * kWarpCh / 4; i += 32) {
        const int r = i / (kWarpCh / 4), c = 4 * (i % (kWarpCh / 4));
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < P && ch0 + c < C) v = *reinterpret_cast<const float4*>(gb + (size_t)r * C + ch0 + c);
        *reinterpret_cast<float4*>(gs_w + r * kLdG + c) = v;
    }
    __syncwarp();
}

// The warp's partial dots over its 64 channels of the slice xh (TT patches;
// f32 and bf16: the ring slot; int8: its bf16 plane): q . x to red_w rows
// [0, P), g . x to rows [P, 2P) and, for bf16 and f32 unless HOST_INV, the
// tile rows' sums of squares to row 2P; `add` adds to what is there (the
// wide instance's later channel groups).  g: bf16 hi + lo fragments (gh, gl)
// or, for f32, the staged gs_w.
template <int ST, bool HOST_INV, int TT = tile_of(ST)>
__device__ __forceinline__ void slice_dots(const unsigned char* xh,
                                           const uint32_t (&qh)[qsteps_of(ST)][4],
                                           const uint32_t (&ql)[qsteps_of(ST)][4],
                                           const uint32_t (&gh)[qsteps_of(ST)][4],
                                           const uint32_t (&gl)[qsteps_of(ST)][4],
                                           const float* gs_w, float* red_w, int P, bool add,
                                           int lane) {
    constexpr int kLd = ld_of(TT);
    // f32 keeps its n-tiles rolled: unrolled, its instance holding q's split
    // fragments spills at 255 registers
    constexpr int kUnrollJ = ST == kF32 ? 1 : TT / 8;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll (kUnrollJ)
    for (int j = 0; j < TT / 8; ++j) {
        float s[4] = {0.f, 0.f, 0.f, 0.f}, d[4] = {0.f, 0.f, 0.f, 0.f};
        float sq = 0.f;
        if constexpr (ST == kF32) {
            // two chains of 12 products a dot (channels [0, 32) and [32, 64))
            float s2[4] = {0.f, 0.f, 0.f, 0.f}, d2[4] = {0.f, 0.f, 0.f, 0.f};
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
                    const int ks = 2 * kk + h;
                    uint32_t ah[4], al[4];
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        split_tf32(gs_w[(g + 8 * (e & 1)) * kLdG + 8 * ks + t + 4 * (e >> 1)],
                                   ah[e], al[e]);
                    if (kk < 2) {
                        mma_3xtf32(s, qh[ks], ql[ks], bh + 2 * h, bl + 2 * h);
                        mma_3xtf32(d, ah, al, bh + 2 * h, bl + 2 * h);
                    } else {
                        mma_3xtf32(s2, qh[ks], ql[ks], bh + 2 * h, bl + 2 * h);
                        mma_3xtf32(d2, ah, al, bh + 2 * h, bl + 2 * h);
                    }
                }
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                s[i] += s2[i];
                d[i] += d2[i];
            }
        } else {
            uint32_t b[8];
            ldsm_x4(b, xh + plane_off(8 * j + (lane & 7), lane >> 3));
            ldsm_x4(b + 4, xh + plane_off(8 * j + (lane & 7), 4 + (lane >> 3)));
#pragma unroll
            for (int ks = 0; ks < 4; ++ks) {
                mma_bf16(s, qh[ks], b[2 * ks], b[2 * ks + 1]);
                mma_bf16(s, ql[ks], b[2 * ks], b[2 * ks + 1]);
                mma_bf16(d, gh[ks], b[2 * ks], b[2 * ks + 1]);
                mma_bf16(d, gl[ks], b[2 * ks], b[2 * ks + 1]);
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
            float* o = red_w + 2 * P * kLd + 8 * j + g;
            if (t == 0) *o = (add ? *o : 0.f) + sq;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = g + 8 * h;
            if (r < P) {
                float2* os = reinterpret_cast<float2*>(red_w + r * kLd + 8 * j + 2 * t);
                float2* od = reinterpret_cast<float2*>(red_w + (P + r) * kLd + 8 * j + 2 * t);
                const float2 vs = add ? *os : make_float2(0.f, 0.f);
                const float2 vd = add ? *od : make_float2(0.f, 0.f);
                *os = make_float2(vs.x + s[2 * h], vs.y + s[2 * h + 1]);
                *od = make_float2(vd.x + d[2 * h], vd.y + d[2 * h + 1]);
            }
        }
    }
}


// rows[g (+8)][c, c + 1] (of P rows at stride C) += part's C fragment, or =
// where `first`; nothing past P or C.
__device__ __forceinline__ void add_rows(float* rows, int C, int P, int c, int g,
                                         const float (&part)[4], bool first) {
    if (c >= C) return;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        if (g + 8 * h < P) {
            float2* d = reinterpret_cast<float2*>(rows + (size_t)(g + 8 * h) * C + c);
            const float2 o = first ? make_float2(0.f, 0.f) : *d;
            *d = make_float2(o.x + part[2 * h], o.y + part[2 * h + 1]);
        }
    }
}

// s_row = g[b, p] . out[b, p] over the C channels, this warp's sum (lanes 4
// channels apart, 128 a step), the same on every lane.
__device__ __forceinline__ float g_dot_out(const BwdArgs& a, int b, int p, int lane) {
    const size_t row = ((size_t)b * a.P + p) * a.C;
    float s = 0.f;
    for (int c = 4 * lane; c < a.C; c += 128) {
        const float4 gv = *reinterpret_cast<const float4*>(a.g + row + c);
        const float4 ov = *reinterpret_cast<const float4*>(a.out + row + c);
        s = fmaf(gv.x, ov.x, fmaf(gv.y, ov.y, fmaf(gv.z, ov.z, fmaf(gv.w, ov.w, s))));
    }
    return warp_sum(s);
}

// a.srow [B, P] of the looped instance: a warp a row, grid (ceil(P / 8), B).
__global__ void __launch_bounds__(kThreads) coattn_srow(const BwdArgs a) {
    const int lane = threadIdx.x & 31, p = blockIdx.x * kWarps + (threadIdx.x >> 5);
    const int b = blockIdx.y;
    if (p >= a.P) return;
    const float s = g_dot_out(a, b, p, lane);
    if (lane == 0) a.srow[(size_t)b * a.P + p] = s;
}

template <int ST, bool HOST_INV, bool WITH_DX, bool WIDE, bool LOOP>
__global__ void __launch_bounds__(kMaxWarps * 32, 1) coattn_bwd_stream(const BwdArgs a) {
    using T = typename Store<ST>::T;
    static_assert(!WITH_DX || (ST != kI8 && !HOST_INV), "dX takes f32 or bf16 x, no sidecars");
    static_assert(!LOOP || WITH_DX, "the dQ kernel takes its query groups on the grid");
    constexpr bool HAS_SCALE = ST == kI8;
    constexpr int R = kBwdStages, QS = qsteps_of(ST);
    constexpr int TT = LOOP ? loop_tile_of(ST) : tile_of(ST), kLd = ld_of(TT), kLdWF = TT + 4;
    constexpr int kSlice = TT * kWarpCh * (int)sizeof(T);
    constexpr int kMT = TT / 16;                   // m-tiles of 16 patches a tile
    // the dX products' loops: LOOP unrolls them (dxa is indexed statically)
    constexpr int kUnrollMT = LOOP ? kMT : 1, kUnrollJF = LOOP ? 8 : 2;
    extern __shared__ __align__(128) unsigned char smem[];
    const int nw = blockDim.x >> 5;
    const int N = a.N, C = a.C, Tb = a.Tb;
    const BwdSmem lay(nw, ST, a.P, WITH_DX);
    const int PR = min(a.P, kRows);                // rows of the dots' partials
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int ch0 = warp * kWarpCh;                // within a channel group
    // the query rows: the block's query group [qb, qb + NQ) (grid z), or
    // every row in QG groups of 16, looped on each tile (LOOP)
    const int qb = LOOP ? 0 : ((int)blockIdx.z + a.qz0) * kRows;
    const int NQ = LOOP ? a.P : min(kRows, a.P - qb);
    const int QG = LOOP ? query_groups_of(a.P) : 1;
    // the wide instance: G channel groups, this block's dq and dX channels
    // are group grp's; a query group is G dot items and one product item
    const int G = WIDE ? (int)gridDim.y : 1, grp = WIDE ? (int)blockIdx.y : 0;
    const int nIg = WIDE ? G + 1 : 1;              // items a query group
    const int nI = WIDE ? QG * nIg : 1;            // items a tile (!WIDE: the groups share one)
    const int chg = grp * kGroupCh + ch0;
    unsigned char* ring = smem + lay.ring + (size_t)warp * R * kSlice;
    unsigned char* plane = smem + lay.conv + (size_t)warp * TT * kPlaneRow;
    float* red = reinterpret_cast<float*>(smem + lay.red);
    const int redw = (2 * PR + 1) * kLd;           // floats of a warp's partials
    float* red_w = red + warp * redw;
    float* gs_w = reinterpret_cast<float*>(smem + lay.gs) + warp * kRows * kLdG;
    __nv_bfloat16* w_hi = reinterpret_cast<__nv_bfloat16*>(smem + lay.w);
    __nv_bfloat16* w_lo = w_hi + kRows * kLd;
    __nv_bfloat16* w_a = w_lo + kRows * kLd;
    float* w_f = reinterpret_cast<float*>(smem + lay.w);
    float* wa_f = w_f + kRows * kLdWF;
    float* m_s = reinterpret_cast<float*>(smem + lay.rows);
    float* linv_s = m_s + kRows;
    float* srow_s = linv_s + kRows;
    float* coef_s = srow_s + kRows;
    float* inv_s = coef_s + TT;
    float* sc_s = inv_s + TT;
    uint8_t* valid_s = reinterpret_cast<uint8_t*>(sc_s + TT);

    const int f0 = blockIdx.x * a.L;
    const int ntiles = min(a.total, f0 + a.L) - f0;
    const int nitems = ntiles * nI;
    // item k: tile f0 + k / nI; its channel group (k % nI) % nIg, or grp for
    // a product item; into slot k % R
    const void* x = a.x;
    auto issue = [=](int k) {
        const int mi = (k % nI) % nIg;
        const int cg = WIDE ? (mi < G ? mi : grp) * kGroupCh : 0;
        issue_tile<ST, TT>(x, N, C, Tb, f0 + k / nI, ring + (k % R) * kSlice, cg + ch0, lane);
    };
#pragma unroll
    for (int s = 0; s < R - 1; ++s) {
        if (s < nitems) issue(s);
        cp_async_commit();
    }

    uint32_t qh[QS][4], ql[QS][4];  // q's A fragments: once, or per query group or dot item
    uint32_t gh[QS][4], gl[QS][4];  // g's (bf16 and int8; f32 reads gs_w)
    if constexpr (!WIDE && !LOOP) load_frags<ST>(a.q + (size_t)qb * C, NQ, C, ch0, lane, qh, ql);
    for (int i = tid; i < (int)(lay.wbytes / 4); i += blockDim.x)  // rows >= P stay 0
        reinterpret_cast<uint32_t*>(smem + lay.w)[i] = 0u;
    float acc[8][4];               // the dq partial (!LOOP)
    float dxa[LOOP ? kMT : 1][8][4];  // the tile's dX over the query groups (LOOP)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
    __syncthreads();

#pragma unroll 1
    for (int i = 0; i < ntiles; ++i) {
        const int f = f0 + i, b = f / Tb, n0 = (f - b * Tb) * TT;
        const float* gbag = a.g + (size_t)b * a.P * C;
        if (i == 0 || n0 == 0) {
            // the range enters bag b: its stats, s_row = g . out, and g (LOOP
            // stages each query group's stats as it comes)
            if constexpr (!LOOP) {
                for (int r = warp; r < NQ; r += nw) {
                    const int p = qb + r;
                    const float s = g_dot_out(a, b, p, lane);
                    if (lane == 0) {
                        srow_s[r] = s;
                        m_s[r] = a.m[(size_t)b * a.P + p];
                        linv_s[r] = 1.f / a.l[(size_t)b * a.P + p];
                    }
                }
            }
            if constexpr (!WIDE && !LOOP) {
                if constexpr (ST == kF32) stage_g(gbag + (size_t)qb * C, NQ, C, ch0, lane, gs_w);
                else load_frags<ST>(gbag + (size_t)qb * C, NQ, C, ch0, lane, gh, gl);
            }
        }
        // the tile's per-patch sidecars, loaded now and stored after the dots
        bool sv[2];
        float ssc[2], sinv[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
            const int n = n0 + tid + u * (int)blockDim.x;
            const size_t k = (size_t)b * N + n;
            sv[u] = tid + u * (int)blockDim.x < TT && n < N && a.mask[k] != 0;
            ssc[u] = HAS_SCALE && sv[u] ? a.x_scale[k] : 1.f;
            sinv[u] = HOST_INV && sv[u] ? a.x_inv[k] : 0.f;
        }
        if constexpr (LOOP) {
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
                for (int j = 0; j < 8; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) dxa[mt][j][e] = 0.f;
        }

        const unsigned char* xh = nullptr;  // the slice the products read
#pragma unroll 1
        for (int qi = 0; qi < QG; ++qi) {
            // query group qi: rows [q0, q0 + P) of the caller's
            const int q0 = qb + qi * kRows, P = LOOP ? min(kRows, a.P - q0) : NQ;
            const float* qq = a.q + (size_t)q0 * C;
            const float* gq = gbag + (size_t)q0 * C;
            if constexpr (LOOP) {
                // the group's stats (read after the barrier below; the last
                // group's were read before the barrier after the weights)
                if (tid < P) {
                    const size_t k = (size_t)b * a.P + q0 + tid;
                    m_s[tid] = a.m[k];
                    linv_s[tid] = 1.f / a.l[k];
                    srow_s[tid] = a.srow[k];
                }
            }
            if constexpr (LOOP && !WIDE) {
                load_frags<ST>(qq, P, C, ch0, lane, qh, ql);
                if constexpr (ST == kF32) stage_g(gq, P, C, ch0, lane, gs_w);
                else load_frags<ST>(gq, P, C, ch0, lane, gh, gl);
            }
#pragma unroll 1
            for (int mi = 0; mi < nIg; ++mi) {
                // a wide item streams a slice; !WIDE the tile's one slice
                // lands for the first query group and serves them all
                if (WIDE || qi == 0) {
                    const int k = i * nI + qi * nIg + mi;
                    __syncwarp();  // every lane is done with the slot refilled below
                    if (k + R - 1 < nitems) issue(k + R - 1);
                    cp_async_commit();
                    cp_async_wait<R - 1>();
                    __syncwarp();  // item k landed for every lane
                    xh = ring + (k % R) * kSlice;
                    if constexpr (ST == kI8) {
#pragma unroll
                        for (int u = 0; u < TT / 32; ++u) {
                            const float sq = convert_row(xh, plane, lane + 32 * u);
                            float* o = red_w + 2 * PR * kLd + lane + 32 * u;
                            if (!HOST_INV && mi < G) *o = (mi > 0 ? *o : 0.f) + sq;
                        }
                        __syncwarp();
                        xh = plane;
                    }
                }
                if (!WIDE || mi < G) {  // a dot item
                    if constexpr (WIDE) {
                        load_frags<ST>(qq, P, C, mi * kGroupCh + ch0, lane, qh, ql);
                        if constexpr (ST == kF32) stage_g(gq, P, C, mi * kGroupCh + ch0, lane, gs_w);
                        else load_frags<ST>(gq, P, C, mi * kGroupCh + ch0, lane, gh, gl);
                    }
                    slice_dots<ST, HOST_INV, TT>(xh, qh, ql, gh, gl, gs_w, red_w, PR, mi > 0, lane);
                }
            }
            if (qi == 0) {
#pragma unroll
                for (int u = 0; u < 2; ++u) {
                    const int n = tid + u * (int)blockDim.x;
                    if (n < TT) {
                        valid_s[n] = sv[u];
                        sc_s[n] = ssc[u];
                        inv_s[n] = sinv[u];
                    }
                }
            }
            __syncthreads();  // every warp's partials and the sidecars are in

            // ---- the weights: warp takes 8 patches of the tile at a time, lane
            // = patch 8 c + (lane % 8) x rows lane / 8 + 4 h; the group's
            // padded rows (P <= r < 16) get a = dl = 0 ----
            {
                const int pl = lane & 7, rg = lane >> 3;
                for (int c8 = warp; c8 < TT / 8; c8 += nw) {
                    const int n = 8 * c8 + pl;
                    const bool valid = valid_s[n] != 0;
                    float inv;
                    if constexpr (HOST_INV) {
                        inv = inv_s[n];
                    } else {
                        float sq = 0.f;
#pragma unroll
                        for (int w = 0; w < kMaxWarps; ++w)
                            if (w < nw) sq += red[w * redw + 2 * PR * kLd + n];
                        inv = rsqrtf(fmaxf(sq, 1e-24f));
                    }
                    const float sinv_n = a.scale * inv, s_n = sc_s[n];
                    float proj = 0.f;
#pragma unroll
                    for (int h = 0; h < 4; ++h) {
                        const int r = rg + 4 * h;
                        if (r < PR) {
                            float raw = 0.f, av = 0.f, dl = 0.f;
                            if (r < P) {
                                float da = 0.f;
#pragma unroll
                                for (int w = 0; w < kMaxWarps; ++w) {
                                    if (w < nw) {
                                        raw += red[w * redw + r * kLd + n];
                                        da += red[w * redw + (PR + r) * kLd + n];
                                    }
                                }
                                // a = 0 for a masked patch, before any product
                                av = valid ? expf(sinv_n * raw - m_s[r]) * linv_s[r] : 0.f;
                                dl = av * (da * s_n - srow_s[r]) * inv;
                            }
                            if constexpr (ST == kF32) {
                                w_f[r * kLdWF + n] = dl;
                                if constexpr (WITH_DX) {
                                    wa_f[r * kLdWF + n] = av;
                                    proj = fmaf(dl, raw, proj);
                                }
                            } else {
                                __nv_bfloat16 hi, lo;
                                split_bf16(dl, hi, lo);
                                w_hi[r * kLd + n] = hi;
                                w_lo[r * kLd + n] = lo;
                                if constexpr (WITH_DX) {
                                    w_a[r * kLd + n] = __float2bfloat16_rn(av);
                                    proj = fmaf(__bfloat162float(hi), raw, proj);
                                }
                            }
                        }
                    }
                    if constexpr (WITH_DX) {
                        proj += __shfl_xor_sync(0xffffffffu, proj, 8);
                        proj += __shfl_xor_sync(0xffffffffu, proj, 16);
                        // LOOP: coef sums over the query groups
                        if (rg == 0) coef_s[n] = (LOOP && qi > 0 ? coef_s[n] : 0.f)
                                                 + a.scale * proj * inv * inv;
                    }
                }
            }
            __syncthreads();  // the weights are in

            // ---- dq: dl [16, TT] . x [TT, 64], a fresh product a tile, added to
            // the running partial: in registers (acc), or LOOP in this block's
            // rows of the workspace (its query groups' partials do not fit) ----
            float* dq_rows = a.ws_dq + ((size_t)blockIdx.x * a.P + q0) * C;
            if constexpr (ST == kF32) {
                // split TF32, TT / 8 k-steps of 8 patches: 12 products a chain
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
                    if constexpr (LOOP) add_rows(dq_rows, C, P, chg + 8 * j + 2 * t, g, part, i == 0);
                    else {
#pragma unroll
                        for (int e = 0; e < 4; ++e) acc[j][e] += part[e];
                    }
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
                    for (int h = 0; h < TT / 32; ++h) {
                        // patches [32 h, 32 h + 32) of the slice, k-steps 2h and 2h + 1
                        uint32_t bx[4];
                        ldsm_x4_t(bx, xh + plane_off(32 * h + lane, j));
                        mma_bf16(part, ah[2 * h], bx[0], bx[1]);
                        mma_bf16(part, al[2 * h], bx[0], bx[1]);
                        mma_bf16(part, ah[2 * h + 1], bx[2], bx[3]);
                        mma_bf16(part, al[2 * h + 1], bx[2], bx[3]);
                    }
                    if constexpr (LOOP) add_rows(dq_rows, C, P, chg + 8 * j + 2 * t, g, part, i == 0);
                    else {
#pragma unroll
                        for (int e = 0; e < 4; ++e) acc[j][e] += part[e];
                    }
                }
            }

            // ---- dX [TT, 64] = a'^T g' + scale dl'^T q - x coef, into the slot:
            // !LOOP at once; LOOP the group's a'^T g' + scale dl'^T q into dxa,
            // and after the last group dxa - x coef ----
            if constexpr (WITH_DX) {
                unsigned char* slot = ring + ((i * nI + nI - 1) % R) * kSlice;
                const float scale = a.scale;
                if constexpr (WIDE) {  // this block's group
                    if constexpr (ST == kF32) stage_g(gq, P, C, chg, lane, gs_w);
                    else {
                        load_frags<ST>(qq, P, C, chg, lane, qh, ql);
                        load_frags<ST>(gq, P, C, chg, lane, gh, gl);
                    }
                }
                __syncwarp();  // every lane's dq reads of the slot are done
                if constexpr (ST == kF32) {
#pragma unroll (kUnrollMT)
                    for (int mt = 0; mt < kMT; ++mt) {
                        // A fragments (rows = patches 16 mt + g (+8), k = query
                        // rows 8 kp + t (+4)) of a and dl, split TF32
                        uint32_t aah[2][4], aal[2][4], adh[2][4], adl[2][4];
#pragma unroll
                        for (int kp = 0; kp < 2; ++kp)
#pragma unroll
                            for (int e = 0; e < 4; ++e) {
                                const int o = (8 * kp + t + 4 * (e >> 1)) * kLdWF + 16 * mt + g + 8 * (e & 1);
                                split_tf32(wa_f[o], aah[kp][e], aal[kp][e]);
                                split_tf32(w_f[o], adh[kp][e], adl[kp][e]);
                            }
#pragma unroll (kUnrollJF)
                        for (int j = 0; j < 8; ++j) {
                            // B fragments: g and q [8 kp + t (+4)][8j + g]
                            const int c = 8 * j + g, cq = chg + c;
                            uint32_t bgh[2][2], bgl[2][2], bqh[2][2], bql[2][2];
#pragma unroll
                            for (int kp = 0; kp < 2; ++kp)
#pragma unroll
                                for (int h = 0; h < 2; ++h) {
                                    const int p = 8 * kp + t + 4 * h;
                                    split_tf32(gs_w[p * kLdG + c], bgh[kp][h], bgl[kp][h]);
                                    const float qv = p < P && cq < C ? __ldg(qq + (size_t)p * C + cq) : 0.f;
                                    split_tf32(qv, bqh[kp][h], bql[kp][h]);
                                }
                            float t1[4] = {0.f, 0.f, 0.f, 0.f}, t2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
                            for (int kp = 0; kp < 2; ++kp) {
                                mma_3xtf32(t1, aah[kp], aal[kp], bgh[kp], bgl[kp]);
                                mma_3xtf32(t2, adh[kp], adl[kp], bqh[kp], bql[kp]);
                            }
#pragma unroll
                            for (int h = 0; h < 2; ++h) {
                                if constexpr (LOOP) {
                                    dxa[mt][j][2 * h] += t1[2 * h] + scale * t2[2 * h];
                                    dxa[mt][j][2 * h + 1] += t1[2 * h + 1] + scale * t2[2 * h + 1];
                                } else {
                                    const int r = 16 * mt + g + 8 * h;
                                    const float cf = coef_s[r];
                                    float2* px = reinterpret_cast<float2*>(
                                        slot + slice_off<kF32>(r, 2 * j + (t >> 1)) + 8 * (t & 1));
                                    const float2 xv = *px;
                                    *px = make_float2(t1[2 * h] + (scale * t2[2 * h] - xv.x * cf),
                                                      t1[2 * h + 1] + (scale * t2[2 * h + 1] - xv.y * cf));
                                }
                            }
                        }
                    }
                } else {
                    // m-tiles of 16 patches in a rolled loop (LOOP: unrolled, dxa
                    // is indexed statically), each over the 8 n-tiles unrolled:
                    // every fragment register is indexed statically (a rolled
                    // n-tile loop would move q's and g's to local memory) and
                    // only one m-tile's A fragments are live
                    const int lm = lane >> 3, pr = (lane & 7) + 8 * (lm >> 1);
#pragma unroll (kUnrollMT)
                    for (int mt = 0; mt < kMT; ++mt) {
                        // A fragments of a' and dl' (= dl_hi), rows = patches:
                        // ldmatrix.trans of the [16][TT] weights, matrix l / 8 at
                        // query rows 8 (l / 16).. and patches 16 mt + 8 ((l / 8) % 2)..
                        uint32_t aa[4], ad[4];
                        const int o = pr * kLd + 16 * mt + 8 * (lm & 1);
                        ldsm_x4_t(aa, w_a + o);
                        ldsm_x4_t(ad, w_hi + o);
#pragma unroll
                        for (int j = 0; j < 8; ++j) {
                            // B fragments (k = query rows, n = channels 8j..) of g' =
                            // g_hi and q hi + lo: the dots' A fragments of k-step
                            // j / 2, transposed
                            const int ks = j >> 1, hh = 2 * (j & 1);
                            float t1[4] = {0.f, 0.f, 0.f, 0.f}, t2[4] = {0.f, 0.f, 0.f, 0.f};
                            mma_bf16(t1, aa, mov_t(gh[ks][hh]), mov_t(gh[ks][hh + 1]));
                            mma_bf16(t2, ad, mov_t(ql[ks][hh]), mov_t(ql[ks][hh + 1]));
                            mma_bf16(t2, ad, mov_t(qh[ks][hh]), mov_t(qh[ks][hh + 1]));
#pragma unroll
                            for (int h = 0; h < 2; ++h) {
                                if constexpr (LOOP) {
                                    dxa[mt][j][2 * h] += t1[2 * h] + scale * t2[2 * h];
                                    dxa[mt][j][2 * h + 1] += t1[2 * h + 1] + scale * t2[2 * h + 1];
                                } else {
                                    const int r = 16 * mt + g + 8 * h;
                                    const float cf = coef_s[r];
                                    uint32_t* px = reinterpret_cast<uint32_t*>(slot + slice_off<kBF16>(r, j) + 4 * t);
                                    const float2 xv = unpack_bf16(*px);
                                    *px = pack_bf16(t1[2 * h] + (scale * t2[2 * h] - xv.x * cf),
                                                    t1[2 * h + 1] + (scale * t2[2 * h + 1] - xv.y * cf));
                                }
                            }
                        }
                    }
                }
                if (qi == QG - 1) {
                    if constexpr (LOOP) {
                        // x's term, coef summed over every group, into the slot
#pragma unroll
                        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
                            for (int j = 0; j < 8; ++j)
#pragma unroll
                                for (int h = 0; h < 2; ++h) {
                                    const int r = 16 * mt + g + 8 * h;
                                    const float cf = coef_s[r];
                                    const float d0 = dxa[mt][j][2 * h], d1 = dxa[mt][j][2 * h + 1];
                                    if constexpr (ST == kF32) {
                                        float2* px = reinterpret_cast<float2*>(
                                            slot + slice_off<kF32>(r, 2 * j + (t >> 1)) + 8 * (t & 1));
                                        const float2 xv = *px;
                                        *px = make_float2(d0 - xv.x * cf, d1 - xv.y * cf);
                                    } else {
                                        uint32_t* px = reinterpret_cast<uint32_t*>(
                                            slot + slice_off<kBF16>(r, j) + 4 * t);
                                        const float2 xv = unpack_bf16(*px);
                                        *px = pack_bf16(d0 - xv.x * cf, d1 - xv.y * cf);
                                    }
                                }
                    }
                    __syncwarp();  // the slot holds the tile's dX
                    constexpr int kChunks = kWarpCh * (int)sizeof(T) / 16;  // 16-byte chunks a row
                    T* dxb = static_cast<T*>(a.dx) + (size_t)b * N * C;
                    for (int idx = lane; idx < TT * kChunks; idx += 32) {
                        const int r = idx / kChunks, c = idx % kChunks, n = n0 + r;
                        const int ch = chg + c * (16 / (int)sizeof(T));
                        if (n < N && ch < C)
                            *reinterpret_cast<uint4*>(dxb + (size_t)n * C + ch) =
                                *reinterpret_cast<const uint4*>(slot + slice_off<ST>(r, c));
                    }
                }
            }
        }
    }

    // ---- this block's partial dq [its query group's rows, its channels] ----
    if constexpr (!LOOP) {
        float* dst = a.ws_dq + ((size_t)blockIdx.x * a.P + qb) * C;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int c = chg + 8 * j + 2 * t;
            if (c < C) {
                if (g < NQ) *reinterpret_cast<float2*>(dst + (size_t)g * C + c) = make_float2(acc[j][0], acc[j][1]);
                if (g + 8 < NQ)
                    *reinterpret_cast<float2*>(dst + (size_t)(g + 8) * C + c) = make_float2(acc[j][2], acc[j][3]);
            }
        }
    }
    cp_async_wait<0>();
}

// dq[i] = scale * sum_k ws_dq[k][i] over the K per-block partials of a
// backward kernel, k in order: deterministic, no atomics.
__global__ void __launch_bounds__(kThreads)
coattn_bwd_reduce(const float* __restrict__ ws_dq, int K, int PC, float scale,
          float* __restrict__ dq) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= PC) return;
    float s = 0.f;
    for (int k = 0; k < K; ++k) s += ws_dq[(size_t)k * PC + i];
    dq[i] = scale * s;
}

inline cudaError_t launch_bwd_reduce(const float* ws_dq, int K, int PC, float scale,
                                    float* dq, cudaStream_t stream) {
    coattn_bwd_reduce<<<(PC + kThreads - 1) / kThreads, kThreads, 0, stream>>>(ws_dq, K, PC,
                                                                              scale, dq);
    return cudaGetLastError();
}

// The streaming kernel: the looped instance in one launch (grid z 1, after
// coattn_srow); the others over every query group, grid z = ceil(P / 16),
// or past kMaxQueryGroups one launch a chunk of that many groups, each from
// its first group (a.qz0).
template <int ST, bool HOST_INV, bool WITH_DX, bool WIDE, bool LOOP>
cudaError_t launch_bwd_stream(BwdArgs a, cudaStream_t stream) {
    auto kernel = coattn_bwd_stream<ST, HOST_INV, WITH_DX, WIDE, LOOP>;
    const int nw = warps_of(a.C);
    const size_t smem = BwdSmem(nw, ST, a.P, WITH_DX).total;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.total + a.L - 1) / a.L, groups_of(a.C), 1);
    if constexpr (LOOP) {
        const int B = a.total / a.Tb;
        coattn_srow<<<dim3((a.P + kWarps - 1) / kWarps, B), kThreads, 0, stream>>>(a);
        if ((err = cudaGetLastError()) != cudaSuccess) return err;
        kernel<<<grid, 32 * nw, smem, stream>>>(a);
        return cudaGetLastError();
    }
    const int qg = query_groups_of(a.P);
    for (a.qz0 = 0; a.qz0 < qg; a.qz0 += kMaxQueryGroups) {
        kernel<<<dim3(grid.x, grid.y, min(kMaxQueryGroups, qg - a.qz0)), 32 * nw, smem,
                 stream>>>(a);
        if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    return cudaSuccess;
}

// The backward of one storage: the streaming kernel's instance for the
// width (C <= 512, or wide), the queries (dX above 16: the looped instance)
// and host norms or not, then coattn_bwd_reduce over the blocks' partials.
// Returns the launches' cudaError_t.
template <int ST, bool WITH_DX>
cudaError_t run_bwd(const BwdArgs& a, float* dq, cudaStream_t stream) {
    cudaError_t err = cudaSuccess;
    const int blocks = a.total > 0 ? (a.total + a.L - 1) / a.L : 0;
    if (blocks > 0) {
        const bool inv = a.x_inv != nullptr, wide = a.C > kGroupCh;
        if constexpr (WITH_DX) {
            if (loops_groups(a.P, true))
                err = wide ? launch_bwd_stream<ST, false, true, true, true>(a, stream)
                           : launch_bwd_stream<ST, false, true, false, true>(a, stream);
            else
                err = wide ? launch_bwd_stream<ST, false, true, true, false>(a, stream)
                           : launch_bwd_stream<ST, false, true, false, false>(a, stream);
        } else if (wide) {
            err = inv ? launch_bwd_stream<ST, true, false, true, false>(a, stream)
                      : launch_bwd_stream<ST, false, false, true, false>(a, stream);
        } else {
            err = inv ? launch_bwd_stream<ST, true, false, false, false>(a, stream)
                      : launch_bwd_stream<ST, false, false, false, false>(a, stream);
        }
        if (err != cudaSuccess) return err;
    }
    return launch_bwd_reduce(a.ws_dq, blocks, a.P * a.C, a.scale, dq, stream);
}

// Bytes of dynamic shared memory of a block for P queries and width C (0:
// not taken; C must be a positive multiple of 8, P >= 1).  No instance's
// grows with P: the looped one stages each query group's stats.
inline size_t bwd_smem_bytes(int P, int C, int storage, bool with_dx) {
    if (C < 8 || C % 8 != 0 || P < 1) return 0;
    return BwdSmem(warps_of(C), storage, P, with_dx).total;
}

}  // namespace coattn
