// Non-causal flash self-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel that vlsa_tpu/models/vision_tower.py:312
// `_flash_self_attention` reaches: JAX's library Pallas `flash_attention`
// (`:325`, call `:347`), which every layer of the CONCH ViT trunk runs during
// feature extraction.  For each (b, h), over exactly L keys:
//
//     S = Q K^T * scale            f32, operands in their storage type
//     P = exp(S - max_row S) / l   f32, l = sum_row exp(S - max_row S)
//     O = P V                      f32 accumulation
//
// The TPU call puts the whole padded sequence in one key block, so its
// kernel (`_flash_attention_kernel_single_batch_single_step`) normalises P in
// f32 and rounds the NORMALISED P to V's type before P V.  The bf16 paths
// here round at the same point: O is the TPU kernel's function up to f32
// summation order and the exponential's last bits.  The output is f32 (the
// TPU kernel rounds it to q's type; the trunk rounds it to the compute type
// at the proj linear either way).  No padding reaches device memory: ragged
// key tiles are masked to -inf before the max, and query rows past L are not
// written.  hd = 64 only (CONCH and CLIP ViT-B).
//
// What bounds it on an H100: at B=64, H=12, L=785, hd=64 the function is
// 4*B*H*L^2*hd = 121.2 GFLOP (0.123 ms at 989 TFLOP/s bf16, 1.81 ms at 67
// TFLOP/s f32) and B*H*L^2 = 473 M exponentials (0.113 ms at 16 a clock per
// SM on 132 SMs at 1.98 GHz), against 0.31-0.39 GB of q, k, v and o
// (0.09-0.12 ms at 3.35 TB/s): bf16 is bound by the tensor cores and the SFU
// about equally, f32 by the FMA pipe.
//
// Paths (the wrapper's `flash_plan(L)` chooses; L alone decides):
//   - bf16 resident (L <= 800; reached through the wrapper's `_force_path`
//     only, held and timed beside the streamed path, which the card measured
//     faster at L = 197 and 785): K and V of one (b, h) stay in shared memory
//     (2 x keys x 128 B, XOR-swizzled 16-byte chunks, loaded once by
//     cp.async: K first, V waited for only before the first P V).  A
//     persistent block of 8 warps loops over (b, h) pairs and, within a pair,
//     over 16-row query stripes, two at a time; the next pair's K and V are
//     prefetched to L2.  A stripe belongs to 4 warps, each holding a quarter
//     of the keys (16-key chunks 4j + w) so that its whole row of S stays in
//     registers: mma.sync m16n8k16 on Q fragments read from device memory a
//     stripe ahead and K fragments from ldmatrix, keys >= L at -inf, the row
//     max and then the row sum exchanged between the 4 warps through a few
//     floats of shared memory and a named barrier.  So the exact m and l are
//     known in ONE sweep, and P = p * (1/l) is rounded to bf16 straight from
//     the accumulator fragment into the A fragment of P V (the layouts
//     coincide); V's B fragments come from ldmatrix.trans.  The 4 partial O
//     of a stripe are summed through shared memory.  Each exponential is one
//     FFMA (log2(e) folded into the scale) and one ex2.approx, each row one
//     reciprocal.  S is templated on the chunks per warp (slots past the last
//     chunk re-read it and are masked), so the products are straight-line
//     code and S is register-allocated.  The capacity (800 keys) is set by
//     shared memory: 800 * 256 B of K and V + 24,576 B of partial O + 1,024 B
//     of row statistics = 230,400 of the 232,448 B a block may use.
//     What bounds it: the whole row of S in registers (223 at 800 keys) allows
//     two stripes, 8 warps, per SM; every 16 query rows re-read all of K and V
//     from shared memory (256 B of fragments per 4,096-FLOP product, so
//     shared memory, at 128 B a clock, caps mma.sync at half the tensor
//     peak); with 2 warps per scheduler the products, the exponentials and
//     the exchanges barely overlap.  `python -m vlsa_tpu_torch.ops.flash_clocks`
//     times each phase (PERF.md has the reading).
//   - bf16 streamed (any L; `flash_plan` sends every bf16 L here, the
//     resident path is kept for `_force_path`): two sweeps on wgmma.  A
//     block of one warpgroup takes 64 query rows of one (b, h), Q's A
//     fragments in registers; K (sweep 1) and K and V (sweep 2) stream in
//     tiles of 64 keys through a ring of 3 shared-memory stages in the
//     128-byte swizzled layout (wgmma_common.cuh), loaded by TMA from a
//     [B*H][L][64] tensor map (rows past L zero-filled), 2 steps ahead, one
//     barrier and one mbarrier wait a step.  Sweep 1: S = Q K^T by wgmma
//     m64n64k16 (A from registers, K K-major from shared memory), each
//     thread's running (m, l) over its own columns in f32, the quad's
//     combined once at the end.  Sweep 2 recomputes S and forms P = 2^(S c -
//     m) * (1 / l), rounded to bf16 straight from S's accumulator into the A
//     registers of the wgmma m64n64k16 P V, whose V is read MN-major from
//     its [key][dim] tile by the transpose flag.  Each exponential is one
//     FFMA and one ex2.approx in both sweeps, so l sums the very values
//     sweep 2 normalises: P is normalised before it is rounded, as the TPU
//     kernel rounds it (an online softmax rounds 2^(S c - m_running) before
//     l is known, another function).  What bounds it: two sweeps are 1.5x
//     the function's products and 2x its exponentials (at the data sheet's
//     rates 0.313 ms of tensor work and 0.386 ms of SFU work at B=64, H=12,
//     L=1025), and each step is a chain (S, its wait, the exponentials, P V,
//     its wait) that four blocks an SM overlap only in part.
//   - f32: true f32 FMAs on the CUDA cores (no TF32), a one-sweep online
//     softmax.  A block of 256 threads owns 128 query rows, a head's tiles
//     side by side; each thread a register tile of 8 rows x 2 keys of S and 8
//     rows x 4 dims of O, fed by 16-byte shared loads (10 loads per 64 FMAs
//     for S, 12 per 128 for P V) that are conflict-free.  32-key K and V
//     tiles are double-buffered with cp.async, so the next tile loads while
//     this one computes; 2 blocks per SM.  A head's last, partial tile
//     computes only its live 16-row groups.  Bound by the FMA pipe's issue
//     slots: the loads, the softmax and the barriers take ~20% of them.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_common.cuh"

namespace {

constexpr int kHd = 64;       // head dimension the kernels take

enum DType { kF32 = 0, kBF16 = 1 };
enum Path { kResident = 0, kStreamed = 1 };

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 and packed: `lo` in the low half (the lower
// column of an mma fragment pair).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// 2^x on the SFU (ex2.approx: ~2 ulp; 2^-inf = +0; results below 2^-126
// flush to 0, far below what a bf16 P times V can carry into the output).
__device__ __forceinline__ float exp2_approx(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid (src is
// then not read, but must be a mapped address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices from shared memory (lane l gives row l % 8 of
// matrix l / 8); .trans delivers them transposed.
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

// Barrier `id` (1 or 2) of the 128 threads of one stripe group.
__device__ __forceinline__ void group_sync(int id) {
    asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// ============================================================ bf16 resident

constexpr int kResW = 4;                   // warps sharing a stripe's keys
constexpr int kResThreads = 2 * kResW * 32;  // 2 stripe groups: 8 warps
constexpr int kResCapacity = 800;          // keys whose K and V fit in shared memory
constexpr int kObufFloats = (kResW - 1) * 16 * kHd;  // a group's partial O of warps 1-3
constexpr size_t kResFixedSmem = sizeof(float) * (2 * kObufFloats + 2 * 2 * kResW * 16);

// Byte offset of 16-byte chunk c (8 bf16) of row r in a [rows][64] bf16
// matrix of 128-byte rows: the chunk index XORed with r % 8, so the 8 rows of
// an ldmatrix phase hit 8 distinct bank groups.
__device__ __forceinline__ uint32_t swz(int r, int c) {
    return static_cast<uint32_t>(r * 128 + ((c ^ (r & 7)) << 4));
}

size_t resident_smem(int L) {
    const int keys_pad = (L + 15) / 16 * 16;
    return (size_t)keys_pad * 2 * kHd * sizeof(__nv_bfloat16) + kResFixedSmem;
}

#ifdef FLASH_CLOCKS
// Phase clocks of the bf16 kernels, for `python -m
// vlsa_tpu_torch.ops.flash_clocks` (built with -DFLASH_CLOCKS; the shipped
// library has none of this): SM clocks per phase, summed over warps.
constexpr int kPhases = 9;
__device__ unsigned long long g_phase_clocks[kPhases];
#define PHASE_INIT() \
    long long clk_[kPhases] = {}; \
    long long clk_prev_ = clock64()
#define PHASE(i) \
    do { \
        const long long now_ = clock64(); \
        clk_[i] += now_ - clk_prev_; \
        clk_prev_ = now_; \
    } while (0)
#define PHASE_FLUSH() \
    do { \
        if (lane == 0) { \
            for (int i_ = 0; i_ < kPhases; ++i_) \
                atomicAdd(&g_phase_clocks[i_], (unsigned long long)clk_[i_]); \
        } \
    } while (0)
#else
#define PHASE_INIT()
#define PHASE(i)
#define PHASE_FLUSH()
#endif

// The A fragments of Q rows row0 .. row0+15 (rows g and g+8, columns 2t,
// 2t+1 and 2t+8, 2t+9 of each 16-wide chunk of hd), straight from device
// memory.  Rows past L are clamped to L - 1: their S rows are finite and
// their output rows are not written.
__device__ __forceinline__ void load_q_frags(const __nv_bfloat16* __restrict__ qh, int row0, int L,
                                             int g, int t, uint32_t qf[4][4]) {
    const __nv_bfloat16* r0 = qh + (size_t)min(row0 + g, L - 1) * kHd + 2 * t;
    const __nv_bfloat16* r1 = qh + (size_t)min(row0 + g + 8, L - 1) * kHd + 2 * t;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
        qf[kc][0] = __ldg(reinterpret_cast<const unsigned int*>(r0 + kc * 16));
        qf[kc][1] = __ldg(reinterpret_cast<const unsigned int*>(r1 + kc * 16));
        qf[kc][2] = __ldg(reinterpret_cast<const unsigned int*>(r0 + kc * 16 + 8));
        qf[kc][3] = __ldg(reinterpret_cast<const unsigned int*>(r1 + kc * 16 + 8));
    }
}

static_assert(kResW == 4, "the row exchange and the partial-O reduction are written for 4 warps");

// NC: the most 16-key chunks one warp holds (the template instance covers
// L <= 16 * kResW * NC).  scale_log2 = hd^-0.5 * log2(e).
template <int NC>
__global__ void __launch_bounds__(kResThreads, 1)
flash_fwd_bf16_resident(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, float* __restrict__ out, int BH,
                        int L, float scale_log2) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int KC = (L + 15) >> 4;  // 16-key chunks, also 16-row query stripes
    const int keys_pad = KC * 16;
    float* obuf_all = reinterpret_cast<float*>(smem + (size_t)keys_pad * 256);
    float* stats_all = obuf_all + 2 * kObufFloats;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int grp = warp / kResW, wg = warp % kResW;  // stripe group; warp within it
    const int g = lane >> 2, t = lane & 3;
    const int lm = lane >> 3, lr = lane & 7;  // ldmatrix: matrix and row of this lane
    float* obuf = obuf_all + grp * kObufFloats;
    float* st_m = stats_all + grp * 2 * kResW * 16;  // [kResW warps][16 rows]
    float* st_l = st_m + kResW * 16;
    const uint32_t ks_u = smem_u32(smem), vs_u = ks_u + keys_pad * 128;
    const int n_iter = (KC + 1) >> 1;
    const int bar_id = 1 + grp;
    PHASE_INIT();

    for (int bh = blockIdx.x; bh < BH; bh += gridDim.x) {
        const size_t base = (size_t)bh * L * kHd;
        // K, then V: two cp.async groups; rows past L are zero
        for (int i = tid; i < keys_pad * 8; i += kResThreads) {
            const int r = i >> 3, c = i & 7;
            cp_async16(ks_u + swz(r, c), k + base + (size_t)(r < L ? r : 0) * kHd + c * 8, r < L);
        }
        cp_async_commit();
        for (int i = tid; i < keys_pad * 8; i += kResThreads) {
            const int r = i >> 3, c = i & 7;
            cp_async16(vs_u + swz(r, c), v + base + (size_t)(r < L ? r : 0) * kHd + c * 8, r < L);
        }
        cp_async_commit();
        if (tid < 2 && bh + (int)gridDim.x < BH) {  // the next pair's K, V to L2
            const __nv_bfloat16* nxt = (tid == 0 ? k : v) + base + (size_t)gridDim.x * L * kHd;
            asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(nxt),
                         "r"(L * kHd * 2)
                         : "memory");
        }
        // the first stripe's Q A fragments, loaded while K arrives; each
        // later stripe's during the stripe before it
        uint32_t qn[4][4];
        load_q_frags(q + base, grp * 16, L, g, t, qn);
        cp_async_wait<1>();
        __syncthreads();  // K is in
        PHASE(0);

        for (int it = 0; it < n_iter; ++it) {
            const int stripe = 2 * it + grp;
            const bool active = stripe < KC;
            float s[NC][2][4];
            float inv0 = 0.f, inv1 = 0.f;
            if (active) {
                uint32_t qf[4][4];
#pragma unroll
                for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
                    for (int e = 0; e < 4; ++e) qf[kc][e] = qn[kc][e];
                }
                load_q_frags(q + base, (stripe + 2) * 16, L, g, t, qn);
                PHASE(1);
                // ---- raw S over this warp's NC key slots, straight-line code
                // (no branch between products, so they interleave freely);
                // slot j is chunk 4j + wg, clamped to the last chunk, and
                // slots past it are masked below ----
#pragma unroll
                for (int j = 0; j < NC; ++j) {
#pragma unroll
                    for (int nt = 0; nt < 2; ++nt) {
                        s[j][nt][0] = s[j][nt][1] = s[j][nt][2] = s[j][nt][3] = 0.f;
                    }
                }
#pragma unroll
                for (int j = 0; j < NC; ++j) {
#pragma unroll
                    for (int kc = 0; kc < 4; ++kc) {
                        uint32_t b[4];
                        const int key0 = min(kResW * j + wg, KC - 1) * 16;
                        ldsm_x4(b, ks_u + swz(key0 + ((lm >> 1) << 3) + lr, 2 * kc + (lm & 1)));
                        mma_bf16(s[j][0], qf[kc], b[0], b[1]);
                        mma_bf16(s[j][1], qf[kc], b[2], b[3]);
                    }
                }
                // keys >= L (in the last chunk and the slots past it) at -inf
                float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
                for (int j = 0; j < NC; ++j) {
                    const int key0 = (kResW * j + wg) * 16;
                    if (key0 + 16 > L) {
#pragma unroll
                        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
                            for (int e = 0; e < 4; ++e) {
                                if (key0 + nt * 8 + 2 * t + (e & 1) >= L) s[j][nt][e] = -INFINITY;
                            }
                        }
                    }
#pragma unroll
                    for (int nt = 0; nt < 2; ++nt) {
                        mx0 = fmaxf(mx0, fmaxf(s[j][nt][0], s[j][nt][1]));
                        mx1 = fmaxf(mx1, fmaxf(s[j][nt][2], s[j][nt][3]));
                    }
                }
                PHASE(2);
                // ---- the exact row max, over the 4 warps ----
                mx0 = quad_max(mx0);
                mx1 = quad_max(mx1);
                if (t == 0) {
                    st_m[wg * 16 + g] = mx0;
                    st_m[wg * 16 + g + 8] = mx1;
                }
                group_sync(bar_id);  // (B)
                // the max of the scaled logits is the scaled max (scale > 0)
                const float m0 = scale_log2 *
                    fmaxf(fmaxf(st_m[g], st_m[16 + g]), fmaxf(st_m[32 + g], st_m[48 + g]));
                const float m1 = scale_log2 *
                    fmaxf(fmaxf(st_m[8 + g], st_m[24 + g]), fmaxf(st_m[40 + g], st_m[56 + g]));
                PHASE(3);
                // ---- p = 2^(s * scale_log2 - m) in place, and the row sum ----
                float l0 = 0.f, l1 = 0.f;
#pragma unroll
                for (int j = 0; j < NC; ++j) {
#pragma unroll
                    for (int nt = 0; nt < 2; ++nt) {
                        s[j][nt][0] = exp2_approx(fmaf(s[j][nt][0], scale_log2, -m0));
                        s[j][nt][1] = exp2_approx(fmaf(s[j][nt][1], scale_log2, -m0));
                        s[j][nt][2] = exp2_approx(fmaf(s[j][nt][2], scale_log2, -m1));
                        s[j][nt][3] = exp2_approx(fmaf(s[j][nt][3], scale_log2, -m1));
                        l0 += s[j][nt][0] + s[j][nt][1];
                        l1 += s[j][nt][2] + s[j][nt][3];
                    }
                }
                l0 = quad_sum(l0);
                l1 = quad_sum(l1);
                if (t == 0) {
                    st_l[wg * 16 + g] = l0;
                    st_l[wg * 16 + g + 8] = l1;
                }
                PHASE(4);
                group_sync(bar_id);  // (C)
                inv0 = 1.f / ((st_l[g] + st_l[16 + g]) + (st_l[32 + g] + st_l[48 + g]));
                inv1 = 1.f / ((st_l[8 + g] + st_l[24 + g]) + (st_l[40 + g] + st_l[56 + g]));
                PHASE(5);
            }
            if (it == 0) {  // V is waited for only before the first P V
                cp_async_wait<0>();
                __syncthreads();
                PHASE(6);
            }
            if (active) {
                // ---- this warp's partial O = P V over its slots (masked ones
                // have P = 0), straight-line code ----
                float o[8][4];
#pragma unroll
                for (int dt = 0; dt < 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
#pragma unroll
                for (int j = 0; j < NC; ++j) {
                    const int key0 = min(kResW * j + wg, KC - 1) * 16;
                    uint32_t a[4];
                    a[0] = pack_bf16(s[j][0][0] * inv0, s[j][0][1] * inv0);
                    a[1] = pack_bf16(s[j][0][2] * inv1, s[j][0][3] * inv1);
                    a[2] = pack_bf16(s[j][1][0] * inv0, s[j][1][1] * inv0);
                    a[3] = pack_bf16(s[j][1][2] * inv1, s[j][1][3] * inv1);
#pragma unroll
                    for (int dp = 0; dp < 4; ++dp) {
                        uint32_t b[4];
                        ldsm_x4_t(b, vs_u + swz(key0 + ((lm & 1) << 3) + lr, 2 * dp + (lm >> 1)));
                        mma_bf16(o[2 * dp], a, b[0], b[1]);
                        mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
                    }
                }
                PHASE(7);
                // ---- the 4 partials summed through shared memory ----
                float4* ob4 = reinterpret_cast<float4*>(obuf);
                if (wg > 0) {
#pragma unroll
                    for (int dt = 0; dt < 8; ++dt) {
                        ob4[((wg - 1) * 8 + dt) * 32 + lane] =
                            make_float4(o[dt][0], o[dt][1], o[dt][2], o[dt][3]);
                    }
                }
                group_sync(bar_id);  // (D1)
                if (wg == 0) {
                    const int row0 = stripe * 16 + g, row1 = row0 + 8;
#pragma unroll
                    for (int dt = 0; dt < 8; ++dt) {
#pragma unroll
                        for (int w = 0; w < 3; ++w) {
                            const float4 p = ob4[(w * 8 + dt) * 32 + lane];
                            o[dt][0] += p.x;
                            o[dt][1] += p.y;
                            o[dt][2] += p.z;
                            o[dt][3] += p.w;
                        }
                        const int d = dt * 8 + 2 * t;
                        if (row0 < L) {
                            *reinterpret_cast<float2*>(out + base + (size_t)row0 * kHd + d) =
                                make_float2(o[dt][0], o[dt][1]);
                        }
                        if (row1 < L) {
                            *reinterpret_cast<float2*>(out + base + (size_t)row1 * kHd + d) =
                                make_float2(o[dt][2], o[dt][3]);
                        }
                    }
                }
                PHASE(8);
            }
        }
        __syncthreads();  // K and V are reloaded for the next pair
        PHASE(0);
    }
    PHASE_FLUSH();
}

// ============================================================ bf16 streamed

// A block is one warpgroup (4 warps) and takes 64 query rows of one (b, h),
// 16 a warp, Q's A fragments in registers.  K and V stream through a ring of
// kStrStages stages of 64 keys, each a K and a V tile [64 keys][128 B] in
// the swizzled layout of wgmma_common.cuh, loaded by TMA kStrLead steps
// ahead (one thread issues a step's copies; an mbarrier a stage says they
// landed).  Four blocks an SM (106 registers, 50,200 bytes of shared memory
// each).  Against the designs tried on the card (PERF.md §6): one
// warpgroup a block beat two to four sharing a block's tiles (a block's
// warpgroups step together behind its barriers; separate blocks drift
// apart, one's exponentials beside another's products); TMA beat every
// thread's cp.async (whose address arithmetic took a large share of a
// step's instructions); 128-key tiles, and issuing the next tile's S or the
// previous tile's P V ahead of the exponentials, gained nothing.
constexpr int kStrRows = 64;                          // query rows a block
constexpr int kStrThreads = 128;                      // one warpgroup
constexpr int kStrTileK = 64;                         // keys a stage
constexpr int kStrStages = 3;
constexpr int kStrLead = kStrStages - 1;              // steps the copies run ahead
constexpr size_t kStrKV = (size_t)kStrTileK * sm90::kSpan;  // 8,192: a K or V tile
constexpr size_t kStrSmem =  // the stages, their barriers, alignment: 50,200
    kStrStages * 2 * kStrKV + kStrStages * sizeof(uint64_t) + sm90::kAtom;

// d (m64n64, f32) += A B over one k-step of 16: A's fragment in registers
// (a[0..3]: rows g and g + 8 of the warp's 16, columns 2 t, 2 t + 1 and 2 t
// + 8, 2 t + 9, the layout of mma.sync's A), B [64][16] in shared memory by
// descriptor: K-major (TRANS_B = 0: S = Q K^T, K's rows are keys) or
// MN-major (TRANS_B = 1: O += P V, V's rows are keys); scale_d = 0
// overwrites d.  d's fragment: warp w of the group holds rows 16 w + g and
// 16 w + g + 8; d[4 j .. 4 j + 3] are columns 8 j + 2 t, 8 j + 2 t + 1 of
// the first row, then of the second (g = lane / 4, t = lane % 4).  S's
// accumulator layout is P's A layout, so P goes from s to A registers
// without a shuffle.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a, uint64_t db,
                                         int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16\n"
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,\n"
        " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,\n"
        " %24, %25, %26, %27, %28, %29, %30, %31},\n"
        " {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TRANS_B));
}

// s = Q K^T over the K tile at ks (Q's fragments qf[kk] for k-step kk),
// then o += P V over the V tile at vs (P's fragments p[4 kk ..] for k-step
// kk): four k-steps each, issued and committed as one group.
__device__ __forceinline__ void issue_qk(const uint32_t (&qf)[4][4], const unsigned char* ks,
                                         float (&s)[32]) {
    sm90::fence_acc(s);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kHd / 16; ++kk) {  // 32-byte k-steps of K's rows
        wgmma_rs<0>(s, qf[kk], sm90::desc_sw128(ks + 32 * kk), kk);
    }
    sm90::wgmma_commit();
}
__device__ __forceinline__ void issue_pv(const uint32_t (&p)[16], const unsigned char* vs,
                                         float (&o)[32]) {
    sm90::fence_acc(o);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kStrTileK / 16; ++kk) {  // 16 of V's rows a k-step
        wgmma_rs<1>(o, p + 4 * kk, sm90::desc_sw128_mn(vs + 16 * kk * sm90::kSpan), 1);
    }
    sm90::wgmma_commit();
}

// Keys >= L of the tile at k0 to -inf (only the last tile has any).
__device__ __forceinline__ void mask_keys(float (&s)[32], int k0, int L, int t) {
    if (k0 + kStrTileK <= L) return;
#pragma unroll
    for (int j = 0; j < kStrTileK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            if (k0 + 8 * j + 2 * t + (e & 1) >= L) s[4 * j + e] = -INFINITY;
        }
    }
}

// Row statistics of the warp's rows g (0) and g + 8 (1): m in log2 units
// (the scaled max), l the row sum, inv 1 / l.
struct RowStats {
    float m0, m1, l0, l1, inv0, inv1;
};

// Sweep 1: folds a tile's s into this thread's running (m, l) of its rows g
// and g + 8, over its own columns only: the quad's four shares are combined
// once, after the sweep (combine_stats), not by shuffles every tile.  m is
// the scaled max (scale > 0).  A thread that has seen only keys >= L (L <
// 64) keeps m = -inf and l = 0: its exponentials subtract 0 instead.  Four
// partial maxima and sums a row keep the dependency chains short.
__device__ __forceinline__ void fold_stats(const float (&s)[32], float scale_log2, RowStats& st) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        float& m = h ? st.m1 : st.m0;
        float& l = h ? st.l1 : st.l0;
        float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < kStrTileK / 8; ++j) {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
                mx[2 * (j & 1) + c] = fmaxf(mx[2 * (j & 1) + c], s[4 * j + 2 * h + c]);
            }
        }
        const float mn = fmaxf(m, scale_log2 * fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3])));
        const float mu = mn == -INFINITY ? 0.f : mn;
        float ps[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < kStrTileK / 8; ++j) {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
                ps[2 * (j & 1) + c] += exp2_approx(fmaf(s[4 * j + 2 * h + c], scale_log2, -mu));
            }
        }
        l = l * exp2_approx(m - mu) + ((ps[0] + ps[1]) + (ps[2] + ps[3]));
        m = mn;
    }
}

// After sweep 1: each row's max over the quad, its sum of the quad's shares
// rescaled to that max (key 0 lies in lane t = 0's columns, so the max is
// finite), and 1 / l.
__device__ __forceinline__ void combine_stats(RowStats& st) {
    const float m0 = quad_max(st.m0), m1 = quad_max(st.m1);
    st.inv0 = 1.f / quad_sum(st.l0 * exp2_approx(st.m0 - m0));
    st.inv1 = 1.f / quad_sum(st.l1 * exp2_approx(st.m1 - m1));
    st.m0 = m0;
    st.m1 = m1;
}

// Sweep 2: P = 2^(s c - m) * (1 / l), the exponential by fold_stats' FFMA
// and ex2.approx, rounded to bf16 into the A fragments of P V: k-step kk,
// p[4 kk .. 4 kk + 3], takes s's key chunks 2 kk and 2 kk + 1 as (row g,
// keys 2t), (g + 8, 2t), (g, 2t + 8), (g + 8, 2t + 8): s's own order, two
// values a register.
__device__ __forceinline__ void form_p(const float (&s)[32], float scale_log2, const RowStats& st,
                                       uint32_t (&p)[16]) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
        const float m = (i & 1) ? st.m1 : st.m0, inv = (i & 1) ? st.inv1 : st.inv0;
        p[i] = pack_bf16(exp2_approx(fmaf(s[2 * i], scale_log2, -m)) * inv,
                         exp2_approx(fmaf(s[2 * i + 1], scale_log2, -m)) * inv);
    }
}

// Grid (query tiles of 64, B*H).  tmk, tmv: K's and V's tensor maps
// (kv_tensor_map); scale_log2 = hd^-0.5 * log2(e).
//
// Step i < n of a block is sweep 1's key tile i, step n + i sweep 2's; its
// copies were issued kStrLead steps ahead into stage i % kStrStages.  A
// ragged last tile runs the full m64n64 products with its keys >= L at
// -inf (at L = 1025, 63 wasted keys of 1088).  Rows past L read row L - 1's
// Q (finite S) and store nothing.
__global__ void __launch_bounds__(kStrThreads)
flash_fwd_bf16_streamed(const __grid_constant__ CUtensorMap tmk,
                        const __grid_constant__ CUtensorMap tmv,
                        const __nv_bfloat16* __restrict__ q, float* __restrict__ out, int L,
                        float scale_log2) {
    extern __shared__ unsigned char smem_raw[];
    unsigned char* stages =  // [stages][K, V][64][128 B]
        smem_raw + ((sm90::kAtom - (smem_u32(smem_raw) & (sm90::kAtom - 1))) & (sm90::kAtom - 1));
    uint64_t* full = reinterpret_cast<uint64_t*>(stages + kStrStages * 2 * kStrKV);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int q0 = blockIdx.x * kStrRows, bh = blockIdx.y;
    const size_t base = (size_t)bh * L * kHd;
    const int n = (L + kStrTileK - 1) / kStrTileK;  // key tiles

    auto kstage = [&](int i) { return stages + (size_t)(i % kStrStages) * 2 * kStrKV; };
    // step i's copies, by one thread: the K tile and, in sweep 2, the V tile
    // (rows past L zero-filled by the copy engine), completing on the stage's
    // barrier
    auto issue = [&](int i) {
        const bool sweep2 = i >= n;
        const int k0 = (sweep2 ? i - n : i) * kStrTileK;
        unsigned char* ks = kstage(i);
        uint64_t* bar = &full[i % kStrStages];
        sm90::mbar_arrive_expect_tx(bar, (sweep2 ? 2 : 1) * (uint32_t)kStrKV);
        sm90::tma_load_3d(ks, &tmk, 0, k0, bh, bar);
        if (sweep2) sm90::tma_load_3d(ks + kStrKV, &tmv, 0, k0, bh, bar);
    };
    if (tid == 0) {
        for (int i = 0; i < kStrStages; ++i) sm90::mbar_init(&full[i], 1);
        sm90::mbar_fence_init();
        for (int i = 0; i < kStrLead && i < 2 * n; ++i) issue(i);
    }
    // every warp is done with step i - 1, whose stage takes step i +
    // kStrLead's copies; then step i's copies have landed
    auto advance = [&](int i) {
        __syncthreads();
        if (tid == 0 && i + kStrLead < 2 * n) issue(i + kStrLead);
        sm90::mbar_wait(&full[i % kStrStages], (i / kStrStages) & 1);
    };

    uint32_t qf[4][4], p[16];
    load_q_frags(q + base, q0 + 16 * warp, L, g, t, qf);
    float s[32], o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = o[i] = 0.f;
    RowStats st{-INFINITY, -INFINITY, 0.f, 0.f, 0.f, 0.f};

    PHASE_INIT();

    // ---- sweep 1: the exact (m, l) of every row
    for (int j = 0; j < n; ++j) {
        advance(j);
        PHASE(0);
        issue_qk(qf, kstage(j), s);
        sm90::wgmma_wait<0>();
        sm90::fence_acc(s);
        PHASE(1);
        mask_keys(s, j * kStrTileK, L, t);
        fold_stats(s, scale_log2, st);
        PHASE(2);
    }
    combine_stats(st);

    // ---- sweep 2: O = P V
    for (int j = 0; j < n; ++j) {
        advance(n + j);
        PHASE(3);
        issue_qk(qf, kstage(n + j), s);
        sm90::wgmma_wait<0>();
        sm90::fence_acc(s);
        PHASE(4);
        mask_keys(s, j * kStrTileK, L, t);
        form_p(s, scale_log2, st, p);
        PHASE(5);
        issue_pv(p, kstage(n + j) + kStrKV, o);
        sm90::wgmma_wait<0>();
        sm90::fence_acc(p);
        PHASE(6);
    }
    sm90::fence_acc(o);

    const int row0 = q0 + 16 * warp + g, row1 = row0 + 8;
#pragma unroll
    for (int j = 0; j < kHd / 8; ++j) {
        const int d = 8 * j + 2 * t;
        if (row0 < L) {
            *reinterpret_cast<float2*>(out + base + (size_t)row0 * kHd + d) =
                make_float2(o[4 * j], o[4 * j + 1]);
        }
        if (row1 < L) {
            *reinterpret_cast<float2*>(out + base + (size_t)row1 * kHd + d) =
                make_float2(o[4 * j + 2], o[4 * j + 3]);
        }
    }
    PHASE(7);
    PHASE_FLUSH();
}

// ============================================================ f32

constexpr int kThreadsF = 256;
constexpr int kTileQF = 128;       // query rows per block
constexpr int kTileKF = 32;        // keys per double-buffered tile
constexpr int kLdF = kHd + 4;      // Q and K row stride: 16-byte rows, conflict-free float4
constexpr int kLdP = kTileKF + 16;  // P row stride: rows ty and ty+1 in distinct banks
constexpr size_t kSmemF32 =
    sizeof(float) * (kTileQF * kLdF + 2 * kTileKF * kLdF + 2 * kTileKF * kHd + kTileQF * kLdP);

// Rows row0 .. row0+rows-1 of a [L, 64] f32 matrix into dst (row stride ld)
// by 16-byte cp.async; rows past L are zero-filled.
__device__ __forceinline__ void stage_rows_f32_async(const float* __restrict__ src, int row0,
                                                     int rows, int L, float* dst, int ld) {
    for (int c = threadIdx.x; c < rows * (kHd / 4); c += kThreadsF) {
        const int r = c >> 4, ch = c & 15, row = row0 + r;
        cp_async16(smem_u32(dst + r * ld + ch * 4),
                   src + (size_t)(row < L ? row : 0) * kHd + ch * 4, row < L);
    }
}

// Reductions over the 16 lanes that share a row group (a half warp).
__device__ __forceinline__ float half_max(float v) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}
__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// One block's 128 query rows.  Thread (ty, tx) = (tid / 16, tid % 16) owns
// rows ty + 16*i (i < NI): keys tx + 16*j (j < 2) of each S tile and dims
// 4*tx .. 4*tx+3 of O.  The two row groups of a warp are adjacent rows, so
// their 16-byte Q and P loads fall in distinct banks.  NI < 8 serves a
// head's last, partial tile: its rows past 16*NI are not computed.
template <int NI>
__device__ __forceinline__ void flash_f32_tile(const float* __restrict__ q,
                                               const float* __restrict__ k,
                                               const float* __restrict__ v, float* __restrict__ out,
                                               int L, float scale_log2, int q0, size_t base,
                                               float* smf) {
    float* qs = smf;                       // [128][kLdF]
    float* ks = qs + kTileQF * kLdF;       // [2][32][kLdF]
    float* vs = ks + 2 * kTileKF * kLdF;   // [2][32][64]
    float* ps = vs + 2 * kTileKF * kHd;    // [128][kLdP]

    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
    const int n_tiles = (L + kTileKF - 1) / kTileKF;

    stage_rows_f32_async(q + base, q0, 16 * NI, L, qs, kLdF);
    stage_rows_f32_async(k + base, 0, kTileKF, L, ks, kLdF);
    stage_rows_f32_async(v + base, 0, kTileKF, L, vs, kHd);
    cp_async_commit();

    float m[NI], l[NI], acc[NI][4];  // m in log2 units; l: this thread's share
#pragma unroll
    for (int i = 0; i < NI; ++i) {
        m[i] = -INFINITY;
        l[i] = 0.f;
        acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    }
    for (int kt = 0; kt < n_tiles; ++kt) {
        const int buf = kt & 1, k0 = kt * kTileKF;
        cp_async_wait<0>();
        __syncthreads();  // tile kt is in; tile kt-1's P V is done with ps and the other buffer
        if (kt + 1 < n_tiles) {
            const int nb = buf ^ 1;
            stage_rows_f32_async(k + base, k0 + kTileKF, kTileKF, L, ks + nb * kTileKF * kLdF, kLdF);
            stage_rows_f32_async(v + base, k0 + kTileKF, kTileKF, L, vs + nb * kTileKF * kHd, kHd);
            cp_async_commit();
        }
        const float* kb = ks + buf * kTileKF * kLdF;
        const float* vb = vs + buf * kTileKF * kHd;
        float s[NI][2];
#pragma unroll
        for (int i = 0; i < NI; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 4
        for (int d = 0; d < kHd; d += 4) {
            float4 kv[2];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                kv[j] = *reinterpret_cast<const float4*>(kb + (tx + 16 * j) * kLdF + d);
            }
#pragma unroll
            for (int i = 0; i < NI; ++i) {
                const float4 qv = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * kLdF + d);
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    s[i][j] = fmaf(qv.x, kv[j].x, s[i][j]);
                    s[i][j] = fmaf(qv.y, kv[j].y, s[i][j]);
                    s[i][j] = fmaf(qv.z, kv[j].z, s[i][j]);
                    s[i][j] = fmaf(qv.w, kv[j].w, s[i][j]);
                }
            }
        }
#pragma unroll
        for (int i = 0; i < NI; ++i) {
            float mx = -INFINITY;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                s[i][j] = k0 + tx + 16 * j < L ? s[i][j] * scale_log2 : -INFINITY;
                mx = fmaxf(mx, s[i][j]);
            }
            const float mn = fmaxf(m[i], half_max(mx));
            const float corr = exp2_approx(m[i] - mn);
            const float p0 = exp2_approx(s[i][0] - mn), p1 = exp2_approx(s[i][1] - mn);
            ps[(ty + 16 * i) * kLdP + tx] = p0;
            ps[(ty + 16 * i) * kLdP + tx + 16] = p1;
            l[i] = l[i] * corr + (p0 + p1);
            m[i] = mn;
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[i][c] *= corr;
        }
        __syncthreads();  // ps is complete
#pragma unroll 2
        for (int kk = 0; kk < kTileKF; kk += 4) {
            float4 vv[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                vv[u] = *reinterpret_cast<const float4*>(vb + (kk + u) * kHd + 4 * tx);
            }
#pragma unroll
            for (int i = 0; i < NI; ++i) {
                const float4 pv = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * kLdP + kk);
                const float pu[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    acc[i][0] = fmaf(pu[u], vv[u].x, acc[i][0]);
                    acc[i][1] = fmaf(pu[u], vv[u].y, acc[i][1]);
                    acc[i][2] = fmaf(pu[u], vv[u].z, acc[i][2]);
                    acc[i][3] = fmaf(pu[u], vv[u].w, acc[i][3]);
                }
            }
        }
    }
#pragma unroll
    for (int i = 0; i < NI; ++i) {
        const int row = q0 + ty + 16 * i;
        const float inv = 1.f / half_sum(l[i]);
        if (row < L) {
            *reinterpret_cast<float4*>(out + base + (size_t)row * kHd + 4 * tx) =
                make_float4(acc[i][0] * inv, acc[i][1] * inv, acc[i][2] * inv, acc[i][3] * inv);
        }
    }
}

__global__ void __launch_bounds__(kThreadsF, 2)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out, int L, float scale_log2) {
    extern __shared__ __align__(16) float smf[];
    const int q0 = blockIdx.x * kTileQF;  // a head's query tiles run side by side (L2 reuse)
    const size_t base = (size_t)blockIdx.y * L * kHd;
    // a head's last tile computes 2 of its 8 row groups when its rows fit
    // there (17 of 128 at L = 785)
    if (L - q0 <= 32) {
        flash_f32_tile<2>(q, k, v, out, L, scale_log2, q0, base, smf);
    } else {
        flash_f32_tile<8>(q, k, v, out, L, scale_log2, q0, base, smf);
    }
}

// ============================================================ launch

// cuTensorMapEncodeTiled, reached through the runtime (no link to libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
        cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                                  &found);
#endif
        if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
            fn = reinterpret_cast<EncodeTiled>(p);
        }
    }
    return fn;
}

// The tensor map of a bf16 [BH][L][64] tensor in boxes of one head's 64
// rows, 128-byte swizzled: a box's rows past L are zero-filled.
cudaError_t kv_tensor_map(CUtensorMap* map, const void* x, int BH, int L) {
    EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint64_t dims[3] = {(cuuint64_t)kHd, (cuuint64_t)L, (cuuint64_t)BH};
    const cuuint64_t strides[2] = {(cuuint64_t)kHd * 2, (cuuint64_t)L * kHd * 2};  // bytes
    const cuuint32_t box[3] = {(cuuint32_t)kHd, (cuuint32_t)kStrTileK, 1};
    const cuuint32_t elem[3] = {1, 1, 1};
    const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x),
                              dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

cudaError_t launch_streamed(const void* q, const void* k, const void* v, void* out, int BH, int L,
                            float scale_log2, cudaStream_t st) {
    CUtensorMap tmk, tmv;
    cudaError_t err = kv_tensor_map(&tmk, k, BH, L);
    if (err != cudaSuccess) return err;
    err = kv_tensor_map(&tmv, v, BH, L);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(flash_fwd_bf16_streamed, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kStrSmem);
    if (err != cudaSuccess) return err;
    flash_fwd_bf16_streamed<<<dim3((L + kStrRows - 1) / kStrRows, BH), kStrThreads, kStrSmem, st>>>(
        tmk, tmv, static_cast<const __nv_bfloat16*>(q), static_cast<float*>(out), L, scale_log2);
    return cudaGetLastError();
}


// The resident kernel's template instances: chunks of 16 keys per warp.
constexpr int kResChunks[] = {2, 4, 7, 10, 13};

template <int NC>
cudaError_t launch_resident(const void* q, const void* k, const void* v, void* out, int BH, int L,
                            float scale_log2, int device, cudaStream_t st) {
    auto kern = flash_fwd_bf16_resident<NC>;
    const size_t smem = resident_smem(L);
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kResThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    const int grid = BH < per_sm * sms ? BH : per_sm * sms;
    kern<<<grid, kResThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<float*>(out), BH, L, scale_log2);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of (dtype, path) needs at length L.
size_t flash_attn_fwd_smem_bytes(int dtype, int path, int L) {
    if (dtype == kF32) return kSmemF32;
    return path == kResident ? resident_smem(L) : kStrSmem;
}

#ifdef FLASH_CLOCKS
// Copies the bf16 kernels' phase clocks to host_out[kPhases] and zeroes them.
int flash_phase_clocks(unsigned long long* host_out) {
    cudaError_t err = cudaMemcpyFromSymbol(host_out, g_phase_clocks, sizeof(g_phase_clocks));
    if (err != cudaSuccess) return (int)err;
    const unsigned long long zero[kPhases] = {};
    return (int)cudaMemcpyToSymbol(g_phase_clocks, zero, sizeof(zero));
}
#endif

// q, k, v [BH, L, 64] contiguous, f32 (dtype 0) or bf16 (dtype 1), 16-byte
// aligned; out [BH, L, 64] f32.  bf16 takes `path` (0 resident, 1 streamed)
// and, for the resident path, `chunks` (16-key chunks per warp: one of the
// template instances, covering L, with L <= 800); f32 ignores both.  All on
// CUDA device `device`; the kernel goes to `stream`.  Returns the launch's
// cudaError_t (0 on success); a (path, chunks) that does not fit L is
// cudaErrorInvalidValue, never another path.
int flash_attn_fwd(const void* q, const void* k, const void* v, void* out, int BH, int L,
                   float scale, int dtype, int path, int chunks, int device, void* stream) {
    if (BH < 1 || L < 1 || (dtype != kF32 && dtype != kBF16)) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float scale_log2 = scale * 1.4426950408889634f;
    if (dtype == kF32) {
        const int q_tiles = (L + kTileQF - 1) / kTileQF;
        if (BH > 65535) return (int)cudaErrorInvalidValue;
        err = cudaFuncSetAttribute(flash_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)kSmemF32);
        if (err != cudaSuccess) return (int)err;
        flash_fwd_f32<<<dim3(q_tiles, BH), kThreadsF, kSmemF32, st>>>(
            static_cast<const float*>(q), static_cast<const float*>(k),
            static_cast<const float*>(v), static_cast<float*>(out), L, scale_log2);
        return (int)cudaGetLastError();
    }
    if (path == kStreamed) {
        if (BH > 65535) return (int)cudaErrorInvalidValue;
        return (int)launch_streamed(q, k, v, out, BH, L, scale_log2, st);
    }
    if (path != kResident || L > kResCapacity || 16 * kResW * chunks < L) {
        return (int)cudaErrorInvalidValue;
    }
    switch (chunks) {
#define FLASH_RESIDENT_CASE(i)                                                           \
    case kResChunks[i]:                                                                  \
        return (int)launch_resident<kResChunks[i]>(q, k, v, out, BH, L, scale_log2, device, \
                                                   st);
        FLASH_RESIDENT_CASE(0)
        FLASH_RESIDENT_CASE(1)
        FLASH_RESIDENT_CASE(2)
        FLASH_RESIDENT_CASE(3)
        FLASH_RESIDENT_CASE(4)
#undef FLASH_RESIDENT_CASE
        default:
            return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
