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
// f32 and rounds the NORMALISED P to V's type before P V.  The bf16 variant
// here rounds at the same point: O is the TPU kernel's function up to f32
// summation order.  The output is f32 (the TPU kernel rounds it to q's type;
// the trunk rounds it to the compute type at the proj linear either way).
// No padding: the ragged last key tile is masked to -inf before the max, and
// query rows past L are not written.  hd = 64 only (CONCH and CLIP ViT-B).
//
// Variants:
//   - bf16: Q K^T and P V on the tensor cores, mma.sync m16n8k16 with f32
//     accumulators.  One block per (b*h, 64-query tile), 4 warps of 16 query
//     rows; the warp keeps its Q rows as A fragments in registers.  Two
//     sweeps over 64-key tiles staged in shared memory: the first runs the
//     online softmax statistics (m, l) per row; the second recomputes S (the
//     same products, so the same values), forms P = exp(S - m) / l, rounds it
//     to bf16 straight from the accumulator fragment into the A fragment of
//     P V (the two layouts coincide), and accumulates O.  V is staged
//     transposed so that its B fragments are 32-bit shared loads.
//   - f32: true f32 on the CUDA cores, one block of 256 threads per (b*h,
//     64-query tile), each thread a 4x4 tile of S and of O, a one-sweep
//     online softmax (m, l, acc) with P through shared memory.
//
// What bounds it on an H100: at B=64, H=12, L=785, hd=64 the function is
// 4*B*H*L^2*hd = 121.2 GFLOP, 0.123 ms at 989 TFLOP/s bf16 (1.81 ms at 67
// TFLOP/s f32), against 0.31-0.39 GB of q, k, v and o (0.09-0.12 ms at 3.35
// TB/s): bound by operations.  This first version is written to be right,
// not fast (PERF.md holds its times beside the bound):
//   - the bf16 sweep pair costs 1.5x the function's products (S twice) to
//     round P where the TPU kernel does, and pads keys and queries to 64;
//   - staging is synchronous (no cp.async/TMA pipeline) and mma.sync, not
//     wgmma, so the tensor cores idle while a tile is staged; several blocks
//     per SM (27.6 KB of shared memory each) cover part of that;
//   - exp and the divide run per element on the SFU/FMA pipes in both sweeps.
//   wgmma, TMA and a one-sweep bf16 softmax are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHd = 64;       // head dimension the kernels take
constexpr int kTileQ = 64;    // query rows per block
constexpr int kTileK = 64;    // keys per shared-memory tile
constexpr int kLdB = kHd + 8;  // bf16 row stride in shared memory: 144 B,
                               // conflict-free 32-bit fragment loads
constexpr int kThreadsB = 128;
constexpr int kLdF = kHd + 1;  // f32 row stride of the K and P tiles
constexpr int kThreadsF = 256;
constexpr size_t kSmemF32 = sizeof(float) * (3 * kTileQ * kLdF + kTileK * kHd);

enum DType { kF32 = 0, kBF16 = 1 };

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

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float quad_max(float v) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Rows row0 .. row0+63 of a [L, 64] bf16 matrix into dst[64][kLdB]; rows
// past L are zero.  16-byte loads and stores, consecutive threads on
// consecutive chunks of a row.
__device__ __forceinline__ void stage_rows_bf16(const __nv_bfloat16* __restrict__ src, int row0,
                                                int L, __nv_bfloat16* dst) {
    for (int c = threadIdx.x; c < kTileK * (kHd / 8); c += kThreadsB) {
        const int r = c >> 3, ch = c & 7;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (row0 + r < L) {
            val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * kHd + ch * 8);
        }
        *reinterpret_cast<uint4*>(dst + r * kLdB + ch * 8) = val;
    }
}

// The same rows transposed: dst[d][key] = V[row0 + key][d].  Consecutive
// threads take consecutive keys, so the scalar stores of one warp fall in
// distinct banks.
__device__ __forceinline__ void stage_rows_bf16_t(const __nv_bfloat16* __restrict__ src, int row0,
                                                  int L, __nv_bfloat16* dst) {
    for (int c = threadIdx.x; c < kTileK * (kHd / 8); c += kThreadsB) {
        const int r = c & (kTileK - 1), ch = c / kTileK;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (row0 + r < L) {
            val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * kHd + ch * 8);
        }
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
        for (int i = 0; i < 8; ++i) dst[(ch * 8 + i) * kLdB + r] = e[i];
    }
}

// S for the warp's 16 query rows against the 64 staged keys: s[nt] is the
// C fragment of keys nt*8 .. nt*8+7 (rows g and g+8, columns 2t and 2t+1),
// scaled, with keys at or past L set to -inf.
__device__ __forceinline__ void qk_tile(const uint32_t qf[4][4], const __nv_bfloat16* ks,
                                        int g, int t, int k0, int L, float scale,
                                        float s[8][4]) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        const __nv_bfloat16* krow = ks + (nt * 8 + g) * kLdB + 2 * t;
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) {
            mma_bf16(s[nt], qf[kc], ld32(krow + kc * 16), ld32(krow + kc * 16 + 8));
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int key = k0 + nt * 8 + 2 * t + (e & 1);
            s[nt][e] = key < L ? s[nt][e] * scale : -INFINITY;
        }
    }
}

__global__ void __launch_bounds__(kThreadsB)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, float* __restrict__ out, int L,
               float scale) {
    __shared__ __align__(16) __nv_bfloat16 qs[kTileQ * kLdB];
    __shared__ __align__(16) __nv_bfloat16 ks[kTileK * kLdB];
    __shared__ __align__(16) __nv_bfloat16 vt[kHd * kLdB];

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int q0 = blockIdx.y * kTileQ;
    const size_t base = (size_t)blockIdx.x * L * kHd;
    const int n_tiles = (L + kTileK - 1) / kTileK;

    stage_rows_bf16(q + base, q0, L, qs);
    __syncthreads();
    // A fragments of the warp's rows r0 = 16*warp + g and r1 = r0 + 8, for
    // the four 16-wide chunks of hd
    uint32_t qf[4][4];
    const int r0 = warp * 16 + g, r1 = r0 + 8;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
        qf[kc][0] = ld32(qs + r0 * kLdB + kc * 16 + 2 * t);
        qf[kc][1] = ld32(qs + r1 * kLdB + kc * 16 + 2 * t);
        qf[kc][2] = ld32(qs + r0 * kLdB + kc * 16 + 2 * t + 8);
        qf[kc][3] = ld32(qs + r1 * kLdB + kc * 16 + 2 * t + 8);
    }

    // sweep 1: row max m and normaliser l, online over the key tiles.  Every
    // tile holds key k0 < L, so m is finite from the first tile on.
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // l: this thread's share
    float s[8][4];
    for (int kt = 0; kt < n_tiles; ++kt) {
        const int k0 = kt * kTileK;
        stage_rows_bf16(k + base, k0, L, ks);
        __syncthreads();
        qk_tile(qf, ks, g, t, k0, L, scale, s);
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
            mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
            mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
        }
        const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
        float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
            ps0 += expf(s[nt][0] - mn0) + expf(s[nt][1] - mn0);
            ps1 += expf(s[nt][2] - mn1) + expf(s[nt][3] - mn1);
        }
        l0 = l0 * expf(m0 - mn0) + ps0;
        l1 = l1 * expf(m1 - mn1) + ps1;
        m0 = mn0;
        m1 = mn1;
        __syncthreads();  // ks is restaged next
    }
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);

    // sweep 2: P = exp(S - m) / l rounded to bf16, O += P V
    float o[8][4];
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
    for (int kt = 0; kt < n_tiles; ++kt) {
        const int k0 = kt * kTileK;
        stage_rows_bf16(k + base, k0, L, ks);
        stage_rows_bf16_t(v + base, k0, L, vt);
        __syncthreads();
        qk_tile(qf, ks, g, t, k0, L, scale, s);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {  // 16 keys: n-tiles 2kk and 2kk+1
            uint32_t a[4];
            a[0] = pack_bf16(expf(s[2 * kk][0] - m0) / l0, expf(s[2 * kk][1] - m0) / l0);
            a[1] = pack_bf16(expf(s[2 * kk][2] - m1) / l1, expf(s[2 * kk][3] - m1) / l1);
            a[2] = pack_bf16(expf(s[2 * kk + 1][0] - m0) / l0, expf(s[2 * kk + 1][1] - m0) / l0);
            a[3] = pack_bf16(expf(s[2 * kk + 1][2] - m1) / l1, expf(s[2 * kk + 1][3] - m1) / l1);
#pragma unroll
            for (int dt = 0; dt < 8; ++dt) {
                const __nv_bfloat16* vrow = vt + (dt * 8 + g) * kLdB + kk * 16 + 2 * t;
                mma_bf16(o[dt], a, ld32(vrow), ld32(vrow + 8));
            }
        }
        __syncthreads();  // ks and vt are restaged next
    }

    const int row0 = q0 + r0, row1 = q0 + r1;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
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

// Rows row0 .. row0+63 of a [L, 64] f32 matrix into dst with row stride
// `ld`; rows past L are zero.  16-byte loads, scalar stores (ld may be odd).
__device__ __forceinline__ void stage_rows_f32(const float* __restrict__ src, int row0, int L,
                                               float* dst, int ld) {
    for (int c = threadIdx.x; c < kTileK * (kHd / 4); c += kThreadsF) {
        const int r = c >> 4, ch = c & 15;
        float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row0 + r < L) {
            val = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * kHd + ch * 4);
        }
        float* d = dst + r * ld + ch * 4;
        d[0] = val.x;
        d[1] = val.y;
        d[2] = val.z;
        d[3] = val.w;
    }
}

// Reductions over the 16 lanes that share a row (a half warp).
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

// Thread (ty, tx) = (tid / 16, tid % 16) owns rows 4*ty + i and columns
// tx + 16*j (keys of S, dims of O), i, j < 4.
__global__ void __launch_bounds__(kThreadsF)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out, int L, float scale) {
    extern __shared__ __align__(16) float smf[];
    float* qs = smf;                  // [64][kLdF]
    float* ks = qs + kTileQ * kLdF;   // [64][kLdF]
    float* ps = ks + kTileK * kLdF;   // [64][kLdF]
    float* vs = ps + kTileQ * kLdF;   // [64][kHd]

    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
    const int q0 = blockIdx.y * kTileQ;
    const size_t base = (size_t)blockIdx.x * L * kHd;
    const int n_tiles = (L + kTileK - 1) / kTileK;

    stage_rows_f32(q + base, q0, L, qs, kLdF);
    float m[4], l[4], acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = -INFINITY;
        l[i] = 0.f;
        acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    }
    for (int kt = 0; kt < n_tiles; ++kt) {
        const int k0 = kt * kTileK;
        stage_rows_f32(k + base, k0, L, ks, kLdF);
        stage_rows_f32(v + base, k0, L, vs, kHd);
        __syncthreads();
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
        for (int d = 0; d < kHd; ++d) {
            float qv[4], kv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) qv[i] = qs[(4 * ty + i) * kLdF + d];
#pragma unroll
            for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * kLdF + d];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
#pragma unroll
                for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
            }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            float mx = -INFINITY;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                s[i][j] = k0 + tx + 16 * j < L ? s[i][j] * scale : -INFINITY;
                mx = fmaxf(mx, s[i][j]);
            }
            const float mn = fmaxf(m[i], half_max(mx));
            const float corr = expf(m[i] - mn);
            float psum = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float p = expf(s[i][j] - mn);
                ps[(4 * ty + i) * kLdF + tx + 16 * j] = p;
                psum += p;
                acc[i][j] *= corr;
            }
            l[i] = l[i] * corr + half_sum(psum);
            m[i] = mn;
        }
        __syncthreads();
        for (int kk = 0; kk < kTileK; ++kk) {
            float pv[4], vv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) pv[i] = ps[(4 * ty + i) * kLdF + kk];
#pragma unroll
            for (int j = 0; j < 4; ++j) vv[j] = vs[kk * kHd + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
            }
        }
        __syncthreads();  // ks, vs and ps are rewritten next
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = q0 + 4 * ty + i;
        if (row < L) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                out[base + (size_t)row * kHd + tx + 16 * j] = acc[i][j] / l[i];
            }
        }
    }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs (the bf16 kernel's 27,648
// are static).
size_t flash_attn_fwd_smem_bytes(int dtype) {
    return dtype == kF32 ? kSmemF32 : 0;
}

// q, k, v [BH, L, 64] contiguous, f32 (dtype 0) or bf16 (dtype 1), 16-byte
// aligned; out [BH, L, 64] f32.  All on CUDA device `device`; the kernel
// goes to `stream`.  Returns the launch's cudaError_t (0 on success).
int flash_attn_fwd(const void* q, const void* k, const void* v, void* out, int BH, int L,
                   float scale, int dtype, int device, void* stream) {
    const int q_tiles = (L + kTileQ - 1) / kTileQ;
    if (BH < 1 || L < 1 || q_tiles > 65535 || (dtype != kF32 && dtype != kBF16)) {
        return (int)cudaErrorInvalidValue;
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const dim3 grid(BH, q_tiles);
    if (dtype == kBF16) {
        flash_fwd_bf16<<<grid, kThreadsB, 0, st>>>(
            static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
            static_cast<const __nv_bfloat16*>(v), static_cast<float*>(out), L, scale);
    } else {
        err = cudaFuncSetAttribute(flash_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)kSmemF32);
        if (err != cudaSuccess) return (int)err;
        flash_fwd_f32<<<grid, kThreadsF, kSmemF32, st>>>(
            static_cast<const float*>(q), static_cast<const float*>(k),
            static_cast<const float*>(v), static_cast<float*>(out), L, scale);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
