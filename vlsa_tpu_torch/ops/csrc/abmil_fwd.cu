// ABMIL attention pooling forward for Hopper (sm_90a).
//
// Replaces the TPU kernels vlsa_tpu/ops/abmil.py::_abmil_kernel (f32 and
// bf16 storage) and ::_abmil_q8_kernel (int8 storage).  For each bag b:
//
//     h[n]     = tanh(s[n] * (x[n] . W1^T) + b1)          [hid]
//     logit[n] = h[n] . w2                                (-1e30 where masked)
//     out[b]   = sum_n softmax_n(logit)[n] * s[n] * x[n]  [D]
//
// with s[n] the per-patch int8 dequant scale (1 for float storage).  b2
// shifts every logit alike and cancels in the softmax, so it is not an input.
// Rounding follows the TPU kernels: bf16 storage multiplies x by W1 rounded
// to bf16 (f32 accumulation, f32 softmax weights in the PV sum); int8
// multiplies the raw int8 values by W1 split as the TPU kernel splits it
// (vlsa_tpu/ops/coattn.py::_mm_rows_i8: s_w = max|W1| / 127, hi = round(W1 /
// s_w), lo = round(254 (W1 / s_w - hi)), ~15 bits), exact in int32, h_unit =
// s_w (254 P_hi + P_lo) / 254 (the plain model of that split is
// ops/abmil.py::abmil_fwd_rounded); f32 forms x . W1^T in split TF32 on the
// tensor cores (~2^-21 relative per product; the plain version
// ops/abmil.py::abmil_fwd_reference stays true f32, and the TPU kernel's own
// f32 is the MXU's multi-pass bf16).  The int8 backward recomputes the logit
// from W1's bf16 hi + lo (~2^-16 relative), so the forward's (m, l) come from
// a logit that differs by ~2^-15 max|W1| in h_pre: the gradients are held
// against the plain path's (chip_smoke.py phases 2c and 3d).
//
// What bounds it on an H100: the product is 2*D*hid operations per patch, 256
// per bf16 byte of x at D=512, hid=256 -- at the card's bf16 ridge (~295), so
// bytes (x read once) and tensor-core operations bound it about equally; int8
// halves the bytes, and its two products at the int8 rate take one bf16
// product's tensor time.  f32 is bound by its products: 3 TF32 products each
// (495 TFLOP/s dense) beat one f32 FMA on the CUDA cores (67 TFLOP/s) 2.5x.
// PERF.md holds the times beside the bound.
//   - bf16 and int8 (abmil_fwd_partial<T>): tiles of 128 patches, two
//     warpgroups of 64 rows each, h_pre [128, 256] formed in registers by
//     wgmma m64n256 (k16 bf16 into f32; k32 int8 into s32), 128 accumulators
//     a thread, both operands read by the tensor cores from shared memory in
//     the 128-byte swizzled layout.  x and W1 go in k-blocks of 128 bytes a
//     row; x's stay resident (the A operand, then the PV sum's rows), so x
//     is read from device memory once.  W1's k-blocks stream through
//     cp.async stages of 32 KB, one slice ahead, x's beside them; x's
//     k-blocks live in a ring of slots one longer than a tile's, so the next
//     tile's first k-block and W1 slice arrive during this tile's epilogue.
//     int8 keeps one slice of products in flight (3 stages; bf16's x tile
//     leaves room for 2 and none in flight).  Each W1 slice feeds
//     128 rows: W1 comes from L2 once a tile, 2x x's bytes in bf16 (int8 hi
//     + lo 4x), ~0.17 GB a call at B=8, N=10240.  int8 runs on the int8
//     tensor cores: P_hi over slices 0-3 (with x), acc *= 254, P_lo over
//     slices 4-7.  A warp holds whole rows, so tanh, the w2 dot and each
//     row's logit take only a quad's sum.  218,128 bytes of
//     shared memory (int8 185,360): one block per SM.  Measured (PERF.md):
//     the products, the W1 and x streams and the epilogue's tanh and PV each
//     take 10-20% of the time and overlap only in part; mma.sync on
//     ldmatrix fragments (the backward's h_product) took 1.2-1.4x as long, and
//     a cluster of 2 blocks sharing W1's slices by multicast bulk copies
//     (half W1's L2 bytes) 1.0-1.4x as long, its blocks stepping together.
//   - f32 (abmil_fwd_partial_f32): mma.sync m16n8k8 with TF32 operands, each
//     f32 operand split into hi + lo as its fragment is loaded from shared
//     memory, lo.hi + hi.lo + hi.hi into f32 accumulators (abmil_common.cuh).
//     The tile of 64 patches stays resident in shared memory (132 KB, rows
//     padded to 516 floats): it is the A operand of the h product and then
//     the PV sum's rows, so x is read from device memory once.  W1 f32
//     streams through 2 cp.async stages of 32 columns of D (36 KB each), x's
//     own 32-column slices beside it, so the product waits on no synchronous
//     restage and the x tile arrives while the first slices multiply; the
//     next tile's first W1 slice is in flight during this tile's epilogue.
//     W1 is split at fragment load (not pre-split by a prep kernel: that
//     doubles its L2 -> SM bytes), 512 KB from L2 per tile of 64: 4x x's own
//     bytes, 0.67 GB a call at B=8, N=10240.  h [64, 256] never leaves the
//     registers: 8 warps of 32 rows x 64 hid columns, 64 accumulators a
//     thread; tanh, the w2 dot and the quad and warp sums of the logit run
//     on the fragments.  209 KB of shared memory: one block per SM.
//   Both are built for D = 512, hid = 256.  Every other width (any D >= 1,
//   any hid >= 1) and bf16 in vlsa_tpu's precise mode (W1 as bf16 hi + lo)
//   run abmil_fwd_general: tiles of 64 patches on mma.sync, x streamed, W1
//   from a workspace padded to whole passes and slices (see the note above
//   that kernel).
//
// Design.  The TPU grid walks N in order and carries (m, l, acc) in VMEM.
// Hopper runs blocks in parallel, so each bag's patches are split over S
// blocks (the chunk plan of ops/abmil.py::fwd_plan, one block an SM): block
// (s, b) runs the online softmax over its chunk and writes its partial (m,
// l, acc[D]); a second kernel merges the partials of each bag in a fixed
// order.  Deterministic, no atomics.  Any N: the ragged edge of the last
// tile is masked here.  A masked or out-of-range patch gets logit -1e30 and
// weight 0 before anything is multiplied; an empty bag gives out = 0, m =
// -1e30 and l = 1e-30.
//
// Per tile: (1)-(2) the h product with x's slices streaming in; (3) tanh and
// the logit on the accumulators (bf16, int8: a quad's sum; f32: partial sums
// over 4 warps); (4) warp 0 updates the online softmax; (5) each thread
// folds the tile's weighted rows into its two channels of acc, held in
// registers.  bf16 and int8 ahead of the first tile: W1 to bf16 (prep_w1),
// or max|W1| (w1_absmax, 64 partial maxima) and the int8 split
// (prep_w1_i8).
#include <type_traits>

#include "abmil_common.cuh"
#include "wgmma_common.cuh"

using namespace abmil;
using sm90::desc_sw128;
using sm90::fence_acc;
using sm90::fence_proxy_async;
using sm90::sw128;
using sm90::wgmma_commit;
using sm90::wgmma_fence;
using sm90::wgmma_wait;

namespace {

constexpr int kMQ = 128;        // patches a tile (bf16, int8)
constexpr int kKB = sm90::kSpan;  // bytes of a row a k-block holds: one 128-byte swizzle span
constexpr int kAtom = sm90::kAtom;  // 1024: 8 rows of a k-block, the swizzle's period
constexpr int kSlicesW = 8;     // W1 slices a tile: bf16 its 8 k-blocks, int8 hi's 4 then lo's 4

// h = tanh(h_pre), by the library's tanhf (1 - 2 / (e^2v + 1) with the
// fast exponential and division measured no faster: python -m
// vlsa_tpu_torch.ops.abmil_variants --storage bf16, `fast_tanh`).
__device__ __forceinline__ float tanh_h(float v) {
    return tanhf(v);
}

// ---- wgmma m64n256 on operands in shared memory (K-major, 128-byte swizzle:
// wgmma_common.cuh)

// d += A . B^T for a warpgroup: A [64 rows][k-step] and B [256 rows][k-step]
// by descriptor; d is m64n256's accumulator fragment (warp w of the group
// holds rows 16 w + g and 16 w + g + 8, g = lane / 4; d[4 j .. 4 j + 3] are
// columns 8 j + 2 t, 8 j + 2 t + 1 of the first row, then of the second,
// t = lane % 4).  bf16: m64n256k16 into f32; int8: m64n256k32 into s32.
__device__ __forceinline__ void wgmma_bf16(float (&d)[128], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16\n"
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,\n"
        " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,\n"
        " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,\n"
        " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,\n"
        " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,\n"
        " %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,\n"
        " %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,\n"
        " %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,\n"
        " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107,\n"
        " %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119,\n"
        " %120, %121, %122, %123, %124, %125, %126, %127},\n"
        " %128, %129, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[128], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8\n"
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,\n"
        " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,\n"
        " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,\n"
        " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,\n"
        " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,\n"
        " %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,\n"
        " %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,\n"
        " %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,\n"
        " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107,\n"
        " %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119,\n"
        " %120, %121, %122, %123, %124, %125, %126, %127},\n"
        " %128, %129, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
          "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
          "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
          "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
          "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
          "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
          "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
          "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
          "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
          "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
          "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
          "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
          "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
          "+r"(d[126]), "+r"(d[127])
        : "l"(da), "l"(db), "r"(1));
}

template <typename Acc>
__device__ __forceinline__ void wgmma_op(Acc (&d)[128], uint64_t da, uint64_t db) {
    if constexpr (std::is_same<Acc, int>::value) {
        wgmma_s8(d, da, db);
    } else {
        wgmma_bf16(d, da, db);
    }
}

// Shared-memory carve-up of the bf16 and int8 partial kernel, from a
// 1024-byte aligned base (`total` holds the slack to align it).
template <typename T>
struct FwdSmemQ {
    static constexpr bool I8 = sizeof(T) == 1;
    static constexpr int KB = kD * sizeof(T) / kKB;      // k-blocks of a row: 8 bf16, 4 int8
    static constexpr int LEAD = 1;                       // slices issued ahead of the products
    static constexpr int DEPTH = I8 ? 1 : 0;             // slices of products left in flight
    static constexpr int NS = LEAD + DEPTH + 1;          // W1 stages of the ring
    static constexpr int XS = KB + LEAD;  // x k-block slots: a tile's, and the next tile's first
    static constexpr size_t x = 0;                       // [XS][kMQ][128 B]
    static constexpr size_t stage = (size_t)kHid * kKB;  // 32,768: [kHid][128 B]
    static constexpr size_t w = (size_t)XS * kMQ * kKB;  // NS stages
    static constexpr size_t cols = w + NS * stage;       // b1, w2 [kHid]
    static constexpr size_t logit = cols + 2 * (size_t)kHid * 4;  // [kMQ]
    static constexpr size_t rows = logit + (size_t)kMQ * 4;       // p, valid, s [kMQ], 4 stats
    static constexpr size_t total = rows + (3 * (size_t)kMQ + 4) * 4 + kAtom;
};

// cp.async of x's k-block kb (128 bytes of each of the tile's kMQ rows [t0,
// t0 + kMQ) of one bag) into the slot dst, swizzled; rows at or past n_end
// are zero-filled.  Not committed.
template <typename T>
__device__ __forceinline__ void load_x_kblock(const T* __restrict__ xb, int t0, int n_end,
                                              unsigned char* dst, int kb) {
    constexpr int kRow = kD * sizeof(T);
    const unsigned char* src = reinterpret_cast<const unsigned char*>(xb);
    for (int i = threadIdx.x; i < kMQ * 8; i += kThreads) {
        const int r = i >> 3, c = i & 7;
        const bool ok = t0 + r < n_end;
        cp_async16(dst + sw128(r, c), ok ? src + (size_t)(t0 + r) * kRow + kb * kKB + 16 * c : src,
                   ok);
    }
}

// cp.async of W1's slice s, all kHid rows, into a stage, swizzled: bf16 the
// k-block s of W1 [kHid][kD] bf16; int8 the k-block s % 4 of hi (s < 4) or
// lo [kHid][kD] int8.  Not committed.
template <typename T>
__device__ __forceinline__ void load_w1_kblock(const unsigned char* __restrict__ w1h,
                                               const unsigned char* __restrict__ w1l,
                                               unsigned char* st, int s) {
    constexpr int kRow = kD * sizeof(T);
    constexpr int KB = kRow / kKB;
    const unsigned char* src = s >= KB ? w1l : w1h;
    const int kb = s % KB;
    for (int i = threadIdx.x; i < kHid * 8; i += kThreads) {
        const int j = i >> 3, c = i & 7;
        cp_async16(st + sw128(j, c), src + (size_t)j * kRow + kb * kKB + 16 * c, true);
    }
}

// The partial of block (split, b) for bf16 or int8 storage (see the note
// above).  Two warpgroups, each the 64 rows [64 wg, +64) of a tile against
// all kHid columns (wgmma m64n256: 128 accumulators a thread).  Each warp
// holds whole rows, so a row's logit needs only a quad's sum.  w1h: W1 in
// bf16 [kHid][kD] (bf16), or W1's int8 hi and w1l its lo [kHid][kD] (int8);
// w1_scale: s_w (int8; else null).  Grid (S, B).
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
abmil_fwd_partial(const T* __restrict__ x, const float* __restrict__ x_scale,
                  const uint8_t* __restrict__ mask, const void* __restrict__ w1h_,
                  const void* __restrict__ w1l_, const float* __restrict__ w1_scale,
                  const float* __restrict__ b1, const float* __restrict__ w2, int N, int chunk,
                  int S, float* __restrict__ ws_m, float* __restrict__ ws_l,
                  float* __restrict__ ws_acc) {
    using L = FwdSmemQ<T>;
    constexpr bool I8 = L::I8;
    using Acc = typename std::conditional<I8, int, float>::type;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem =
        smem_raw + ((kAtom - (coattn::smem_u32(smem_raw) & (kAtom - 1))) & (kAtom - 1));
    unsigned char* xs = smem + L::x;
    unsigned char* stages = smem + L::w;
    float* b1s = reinterpret_cast<float*>(smem + L::cols);
    float* w2s = b1s + kHid;
    float* logit_s = reinterpret_cast<float*>(smem + L::logit);
    float* p_s = reinterpret_cast<float*>(smem + L::rows);
    float* valid_s = p_s + kMQ;
    float* sc_s = valid_s + kMQ;  // int8: the rows' dequant scales
    float* stat_s = sc_s + kMQ;   // m, l, correction
    const unsigned char* w1h = static_cast<const unsigned char*>(w1h_);
    const unsigned char* w1l = static_cast<const unsigned char*>(w1l_);

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wg = warp >> 2, gq = lane >> 2, tq = lane & 3;
    const int row0 = 64 * wg + 16 * (warp & 3) + gq;  // this thread's rows: row0, row0 + 8
    const int split = blockIdx.x, b = blockIdx.y;
    const int n_begin = split * chunk;
    const int n_end = min(N, n_begin + chunk);
    const T* xb = x + (size_t)b * N * kD;
    const uint8_t* mb = mask + (size_t)b * N;
    const float unit = I8 ? *w1_scale / 254.f : 1.f;  // h_unit = unit (254 P_hi + P_lo)

    // k-block kb of the block's tile `it` lives in x slot (it KB + kb) % XS:
    // a tile's KB slots and the next tile's first NS - 1 are distinct, so
    // those stream in during this tile's epilogue
    auto slot = [&](int it, int kb) {
        return xs + (size_t)((it * L::KB + kb) % L::XS) * kMQ * kKB;
    };
#pragma unroll
    for (int q = 0; q < L::LEAD; ++q) {  // the first tile's first slices, a group each
        load_w1_kblock<T>(w1h, w1l, stages + (q % L::NS) * L::stage, q);
        load_x_kblock(xb, n_begin, n_end, slot(0, q), q);
        cp_async_commit();
    }
    for (int j = tid; j < kHid; j += kThreads) {
        b1s[j] = b1[j];
        w2s[j] = w2[j];
    }
    if (tid == 0) {
        stat_s[0] = kNegInf;
        stat_s[1] = 0.f;
    }
    float acc0 = 0.f, acc1 = 0.f;  // channels 2 tid and 2 tid + 1
    Acc acc[128];

#pragma unroll 1
    for (int it = 0, t0 = n_begin; t0 < n_end; ++it, t0 += kMQ) {
        const bool more = t0 + kMQ < n_end;
        if (tid < kMQ) {
            const int n = t0 + tid;
            valid_s[tid] = n < n_end && mb[n] != 0 ? 1.f : 0.f;
            if (I8) sc_s[tid] = n < n_end ? x_scale[(size_t)b * N + n] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 128; ++i) acc[i] = 0;
        // h_pre = x . W1^T: the block's slice g = 8 it + s (W1's k-block s
        // in stage g % NS, x's k-block s % KB), issued LEAD slices ahead
        // (the first ones during the previous tile), one group a slice, its
        // products left in flight for DEPTH slices; bf16 one product over 8
        // slices, int8 P_hi over slices 0-3, acc *= 254, P_lo over 4-7
#pragma unroll 1
        for (int s = 0; s < kSlicesW; ++s) {
            const int g = it * kSlicesW + s;
            cp_async_wait<L::LEAD - 1>();
            fence_proxy_async();
            // slice s landed for all; every warp is done with slice s - 1 -
            // DEPTH and with the previous tile's epilogue (its x slots)
            __syncthreads();
            const int q = s + L::LEAD;
            unsigned char* st = stages + ((g + L::LEAD) % L::NS) * L::stage;
            if (q < kSlicesW) {
                load_w1_kblock<T>(w1h, w1l, st, q);
                if (q < L::KB) load_x_kblock(xb, t0, n_end, slot(it, q), q);
            } else if (more) {  // the next tile's
                load_w1_kblock<T>(w1h, w1l, st, q - kSlicesW);
                if (q - kSlicesW < L::KB) {
                    load_x_kblock(xb, t0 + kMQ, n_end, slot(it + 1, q - kSlicesW), q - kSlicesW);
                }
            }
            cp_async_commit();
            if (I8 && s == L::KB) {  // P_hi is complete: acc = 254 P_hi, then + P_lo
                wgmma_wait<0>();
                fence_acc(acc);
#pragma unroll
                for (int i = 0; i < 128; ++i) acc[i] *= 254;
            }
            const unsigned char* xa = slot(it, s % L::KB) + 64 * wg * kKB;
            const unsigned char* wb = stages + (g % L::NS) * L::stage;
            fence_acc(acc);
            wgmma_fence();
#pragma unroll
            for (int ks = 0; ks < kKB / 32; ++ks) {
                wgmma_op(acc, desc_sw128(xa + 32 * ks), desc_sw128(wb + 32 * ks));
            }
            wgmma_commit();
            wgmma_wait<L::DEPTH>();
            fence_acc(acc);
        }
        wgmma_wait<0>();
        fence_acc(acc);

        // tanh and the w2 dot on the accumulators: each warp holds whole rows
        {
            const float f0 = I8 ? sc_s[row0] * unit : 1.f, f1 = I8 ? sc_s[row0 + 8] * unit : 1.f;
            float p0 = 0.f, p1 = 0.f;
#pragma unroll
            for (int j = 0; j < kHid / 8; ++j) {
                const int c = 8 * j + 2 * tq;
                const float c0 = b1s[c], c1 = b1s[c + 1], u0 = w2s[c], u1 = w2s[c + 1];
                const float v0 = static_cast<float>(acc[4 * j]);
                const float v1 = static_cast<float>(acc[4 * j + 1]);
                const float v2 = static_cast<float>(acc[4 * j + 2]);
                const float v3 = static_cast<float>(acc[4 * j + 3]);
                p0 = fmaf(tanh_h(I8 ? fmaf(v0, f0, c0) : v0 + c0), u0,
                          fmaf(tanh_h(I8 ? fmaf(v1, f0, c1) : v1 + c1), u1, p0));
                p1 = fmaf(tanh_h(I8 ? fmaf(v2, f1, c0) : v2 + c0), u0,
                          fmaf(tanh_h(I8 ? fmaf(v3, f1, c1) : v3 + c1), u1, p1));
            }
            p0 += __shfl_xor_sync(0xffffffffu, p0, 1);
            p0 += __shfl_xor_sync(0xffffffffu, p0, 2);
            p1 += __shfl_xor_sync(0xffffffffu, p1, 1);
            p1 += __shfl_xor_sync(0xffffffffu, p1, 2);
            if (tq == 0) {
                logit_s[row0] = p0;
                logit_s[row0 + 8] = p1;
            }
        }
        __syncthreads();

        if (warp == 0) {
            float lg[kMQ / 32];
            float mx = kNegInf;
#pragma unroll
            for (int i = 0; i < kMQ / 32; ++i) {
                const int r = lane + 32 * i;
                lg[i] = valid_s[r] != 0.f ? logit_s[r] : kNegInf;
                mx = fmaxf(mx, lg[i]);
            }
            mx = warp_max(mx);
            const float m_prev = stat_s[0];
            const float m_new = fmaxf(m_prev, mx);
            float psum = 0.f;
#pragma unroll
            for (int i = 0; i < kMQ / 32; ++i) {
                const int r = lane + 32 * i;
                const float p = valid_s[r] != 0.f ? expf(lg[i] - m_new) : 0.f;
                p_s[r] = I8 ? p * sc_s[r] : p;  // the PV weight folds in s[n]
                psum += p;
            }
            psum = warp_sum(psum);
            if (lane == 0) {
                const float corr = expf(m_prev - m_new);
                stat_s[2] = corr;
                stat_s[1] = stat_s[1] * corr + psum;
                stat_s[0] = m_new;
            }
        }
        __syncthreads();

        // PV: this thread's channels 2 tid, 2 tid + 1 are bytes [e, e + 4)
        // (bf16) or [e, e + 2) (int8) of every row, e = tid * (4 or 2): in
        // k-block e / 128, chunk (e % 128) / 16
        const float corr = stat_s[2];
        float s0 = 0.f, s1 = 0.f;
        {
            constexpr int kE = I8 ? 2 : 4;
            const int e = kE * tid;
            const unsigned char* xk = slot(it, e / kKB) + (e % 16);
            const int c = (e % kKB) / 16;
#pragma unroll 8
            for (int r = 0; r < kMQ; ++r) {
                const float p = p_s[r];
                const unsigned char* px = xk + sw128(r, c);
                float2 v;
                if constexpr (I8) {
                    const char2 cv = *reinterpret_cast<const char2*>(px);
                    v = make_float2(static_cast<float>(cv.x), static_cast<float>(cv.y));
                } else {
                    v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(px));
                }
                s0 = fmaf(p, v.x, s0);
                s1 = fmaf(p, v.y, s1);
            }
        }
        acc0 = acc0 * corr + s0;
        acc1 = acc1 * corr + s1;
    }
    cp_async_wait<0>();

    const size_t part = (size_t)b * S + split;
    if (tid == 0) {  // after the last tile's barriers: its softmax wrote these
        ws_m[part] = stat_s[0];
        ws_l[part] = stat_s[1];
    }
    *reinterpret_cast<float2*>(ws_acc + part * kD + 2 * tid) = make_float2(acc0, acc1);
}

// The same partial for f32 storage: x . W1^T in split TF32 on the tensor
// cores, the x tile resident, W1 streamed by cp.async (see the note above).
struct FwdSmemF {
    static constexpr size_t x = 0;                                      // [kMF][kLdXF]
    static constexpr size_t w = x + round128((size_t)kMF * kLdXF * 4);  // 2 stages
    static constexpr size_t cols = w + 2 * kStageF;                     // b1, w2 [kHid]
    static constexpr size_t red = cols + round128(2 * (size_t)kHid * 4);  // [4][kMF]
    static constexpr size_t rows = red + round128(4 * (size_t)kMF * 4);   // p [kMF] + 4 stats
    static constexpr size_t total = rows + round128(((size_t)kMF + 4) * 4);
};

__global__ void __launch_bounds__(kThreads, 1)
abmil_fwd_partial_f32(const float* __restrict__ x, const uint8_t* __restrict__ mask,
                      const float* __restrict__ w1, const float* __restrict__ b1,
                      const float* __restrict__ w2, int N, int chunk, int S,
                      float* __restrict__ ws_m, float* __restrict__ ws_l,
                      float* __restrict__ ws_acc) {
    using L = FwdSmemF;
    extern __shared__ __align__(128) unsigned char smem[];
    float* xs = reinterpret_cast<float*>(smem + L::x);
    float* stage0 = reinterpret_cast<float*>(smem + L::w);
    float* b1s = reinterpret_cast<float*>(smem + L::cols);
    float* w2s = b1s + kHid;
    float* red = reinterpret_cast<float*>(smem + L::red);
    float* p_s = reinterpret_cast<float*>(smem + L::rows);
    float* stat_s = p_s + kMF;  // m, l, correction

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int split = blockIdx.x, b = blockIdx.y;
    const int n_begin = split * chunk;
    const int n_end = min(N, n_begin + chunk);
    const float* xb = x + (size_t)b * N * kD;
    const uint8_t* mb = mask + (size_t)b * N;

    load_w1_cols(w1, stage0, 0);  // the first tile's first W1 slice
    cp_async_commit();
    for (int j = tid; j < kHid; j += kThreads) {
        b1s[j] = b1[j];
        w2s[j] = w2[j];
    }
    if (tid == 0) {
        stat_s[0] = kNegInf;
        stat_s[1] = 0.f;
    }
    float acc0 = 0.f, acc1 = 0.f;  // channels tid and tid + kThreads
    float acc[kMT][kNT][4];

    for (int t0 = n_begin; t0 < n_end; t0 += kMF) {
        const bool more = t0 + kMF < n_end;
        h_product_f32(acc, xb, t0, n_end, w1, xs, stage0, [&](float* st) {
            if (more) load_w1_cols(w1, st, 0);  // the next tile's first slice
        });
        tanh_logit_f32(acc, b1s, w2s, red);
        __syncthreads();

        if (warp == 0) {
            float lg[kMF / 32];
            bool valid[kMF / 32];
            float mx = kNegInf;
#pragma unroll
            for (int i = 0; i < kMF / 32; ++i) {
                const int r = lane + 32 * i, n = t0 + r;
                valid[i] = n < n_end && mb[n] != 0;
                lg[i] = valid[i] ? (red[r] + red[kMF + r]) + (red[2 * kMF + r] + red[3 * kMF + r])
                                 : kNegInf;
                mx = fmaxf(mx, lg[i]);
            }
            mx = warp_max(mx);
            const float m_prev = stat_s[0];
            const float m_new = fmaxf(m_prev, mx);
            float psum = 0.f;
#pragma unroll
            for (int i = 0; i < kMF / 32; ++i) {
                const float p = valid[i] ? expf(lg[i] - m_new) : 0.f;
                p_s[lane + 32 * i] = p;
                psum += p;
            }
            psum = warp_sum(psum);
            if (lane == 0) {
                const float corr = expf(m_prev - m_new);
                stat_s[2] = corr;
                stat_s[1] = stat_s[1] * corr + psum;
                stat_s[0] = m_new;
            }
        }
        __syncthreads();

        const float corr = stat_s[2];
        float s0 = 0.f, s1 = 0.f;
#pragma unroll 8
        for (int r = 0; r < kMF; ++r) {
            const float p = p_s[r];
            s0 = fmaf(p, xs[r * kLdXF + tid], s0);
            s1 = fmaf(p, xs[r * kLdXF + tid + kThreads], s1);
        }
        acc0 = acc0 * corr + s0;
        acc1 = acc1 * corr + s1;
        __syncthreads();  // xs, p and the stats are rewritten by the next tile
    }

    const size_t part = (size_t)b * S + split;
    if (tid == 0) {
        ws_m[part] = stat_s[0];
        ws_l[part] = stat_s[1];
    }
    ws_acc[part * kD + tid] = acc0;
    ws_acc[part * kD + tid + kThreads] = acc1;
}

// Merge the S partials of each bag: m = max_s m_s, l = sum_s l_s e^(m_s - m),
// out = sum_s acc_s e^(m_s - m) / max(l, 1e-30).  Grid (B); rows of D.
__global__ void __launch_bounds__(kThreads)
abmil_fwd_merge(const float* __restrict__ ws_m, const float* __restrict__ ws_l,
                const float* __restrict__ ws_acc, int S, int D, float* __restrict__ out,
                float* __restrict__ m_out, float* __restrict__ l_out) {
    extern __shared__ float e_s[];  // [S]
    __shared__ float m_all, l_all;
    const int b = blockIdx.x, tid = threadIdx.x;
    const float* mb = ws_m + (size_t)b * S;
    if (tid == 0) {
        float m = kNegInf;
        for (int s = 0; s < S; ++s) m = fmaxf(m, mb[s]);
        m_all = m;
    }
    __syncthreads();
    for (int s = tid; s < S; s += kThreads) e_s[s] = expf(mb[s] - m_all);
    __syncthreads();
    if (tid == 0) {
        float l = 0.f;
        for (int s = 0; s < S; ++s) l += ws_l[(size_t)b * S + s] * e_s[s];
        l_all = fmaxf(l, 1e-30f);
        m_out[b] = m_all;
        l_out[b] = l_all;
    }
    __syncthreads();
    const float inv_l = 1.f / l_all;
    const float* ab = ws_acc + (size_t)b * S * D;
    for (int c = tid; c < D; c += kThreads) {
        float v = 0.f;
        for (int s = 0; s < S; ++s) v += ab[(size_t)s * D + c] * e_s[s];
        out[(size_t)b * D + c] = v * inv_l;
    }
}

// W1 for the bf16 (W1 in bf16, w1_ws [kHid, kD]) or int8 (hi and lo, w1_ws
// [2, kHid, kD] int8; w1_scale [1 + kAmaxBlocks]: s_w, then the partial
// maxima) partial kernel, then the partials.
template <typename T>
cudaError_t launch_partial(const void* x, const float* x_scale, const uint8_t* mask,
                           const float* w1, void* w1_ws, float* w1_scale, const float* b1,
                           const float* w2, int B, int N, int chunk, int S, float* ws_m,
                           float* ws_l, float* ws_acc, cudaStream_t stream) {
    constexpr int kW = kHid * kD;
    const void* w1h = w1_ws;
    const void* w1l = nullptr;
    cudaError_t err;
    if constexpr (sizeof(T) == 1) {
        int8_t* hi = static_cast<int8_t*>(w1_ws);
        err = launch_split_w1_i8(w1, kHid, kD, kHid, kD, hi, w1_scale, stream);
        w1l = hi + kW;
    } else {
        err = launch_prep_w1(w1, static_cast<__nv_bfloat16*>(w1_ws), false, kHid, kD, kHid, kD,
                             stream);
    }
    if (err != cudaSuccess) return err;
    auto kernel = abmil_fwd_partial<T>;
    const size_t smem = FwdSmemQ<T>::total;
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem)) != cudaSuccess) {
        return err;
    }
    kernel<<<dim3(S, B), kThreads, smem, stream>>>(
        static_cast<const T*>(x), x_scale, mask, w1h, w1l, w1_scale, b1, w2, N, chunk, S, ws_m,
        ws_l, ws_acc);
    return cudaGetLastError();
}

cudaError_t launch_partial_f32(const float* x, const uint8_t* mask, const float* w1,
                               const float* b1, const float* w2, int B, int N, int chunk,
                               int S, float* ws_m, float* ws_l, float* ws_acc,
                               cudaStream_t stream) {
    const size_t smem = FwdSmemF::total;
    cudaError_t err = cudaFuncSetAttribute(
        abmil_fwd_partial_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    abmil_fwd_partial_f32<<<dim3(S, B), kThreads, smem, stream>>>(x, mask, w1, b1, w2, N, chunk,
                                                                   S, ws_m, ws_l, ws_acc);
    return cudaGetLastError();
}

// ------------------------------------------------ any width: the general instance
//
// Every (D, hid) but 512, 256 and bf16's precise mode (abmil_common.cuh's
// general instances): tiles of kGenM = 64 patches, the h product in passes
// of HP hid columns streaming x's and W1's slices (gen_h_product), each
// pass folding its columns into the rows' logits (past hid_p = kSmemHid,
// b1's and w2's HP values of the pass staged at its start); then the online
// softmax, and the PV sum
// re-reading the tile's rows, L2-hot, by plain loads, in blocks of kPvCols
// channels: each thread sums the channel pairs 2 (tid + 256 i), i <
// kPvPairs, of a block in registers and folds them into the block's running
// sums, pv [D], each entry owned by one thread: in shared memory up to
// kSmemD channels, past that in the block's own row of ws_acc in device
// memory (its partial's row, written there in place).  x is read from
// device memory once, from L2 npass + 1 times.

// Shared memory: 2 stages, the logits' partials [4][kGenM], then logit, p,
// valid, s [kGenM] and 4 stats; then, sized at run time, b1 and w2 [hid_p]
// (zero past hid) where hid_in_smem(hid_p), else [HP] (the pass's columns),
// and pv [D] where D <= kSmemD.
template <GOp OP, int HP>
struct FwdSmemG {
    static constexpr size_t w = 0;
    static constexpr size_t red = 2 * Gen<OP, HP>::kStage;
    static constexpr size_t rows = red + 4 * (size_t)kGenM * 4;
    static constexpr size_t vecs = rows + (4 * (size_t)kGenM + 4) * 4;
    __host__ __device__ static constexpr size_t pv(int hid_p) {
        return vecs + 2 * (size_t)(hid_in_smem(hid_p) ? hid_p : HP) * 4;
    }
    static constexpr size_t total(int D, int hid_p) {
        return pv(hid_p) + (d_in_smem(D) ? round4((size_t)D) : 0) * 4;
    }
};
static_assert(FwdSmemG<GOp::kF32, gen_max_pass(GOp::kF32)>::total(kSmemD, kSmemHid) <=
                      kSmemOptin &&
                  FwdSmemG<GOp::kBf16P, gen_max_pass(GOp::kBf16P)>::total(kSmemD, kSmemHid) <=
                      kSmemOptin,
              "the general forward fits a block at every width");

constexpr int kPvPairs = 4;
constexpr int kPvCols = 2 * kThreads * kPvPairs;  // 2048: channels a PV block

// The PV sums of a tile's `rows` rows (x's from xt, weights p_s) folded into
// this thread's channel pairs of pv_s, a block of kPvCols channels at a
// time: pv = pv * corr + sum.  ODD: D is odd (load_pair_at).
template <GOp OP, bool ODD>
__device__ __forceinline__ void pv_tile(const unsigned char* __restrict__ xt, int rows,
                                        int row_bytes, int D, const float* p_s, float corr,
                                        float* pv_s) {
    const int tid = threadIdx.x;
#pragma unroll 1
    for (int c0 = 0; c0 < D; c0 += kPvCols) {
        float2 sum[kPvPairs];
#pragma unroll
        for (int i = 0; i < kPvPairs; ++i) sum[i] = make_float2(0.f, 0.f);
#pragma unroll 4
        for (int r = 0; r < rows; ++r) {
            const float p = p_s[r];
            const unsigned char* xr = xt + (size_t)r * row_bytes;
#pragma unroll
            for (int i = 0; i < kPvPairs; ++i) {
                const int c = c0 + 2 * (tid + kThreads * i);
                if (c < D) {
                    const float2 v = load_pair_at<OP, ODD>(xr, c, D);
                    sum[i].x = fmaf(p, v.x, sum[i].x);
                    sum[i].y = fmaf(p, v.y, sum[i].y);
                }
            }
        }
#pragma unroll
        for (int i = 0; i < kPvPairs; ++i) {
            const int c = c0 + 2 * (tid + kThreads * i);
            if (c < D) pv_s[c] = pv_s[c] * corr + sum[i].x;
            if (c + 1 < D) pv_s[c + 1] = pv_s[c + 1] * corr + sum[i].y;
        }
    }
}

// The partial of block (split, b) at any width.  w1h, w1l: W1 as the product
// takes it, [hid_p, ld] (f32: its padded copy; bf16: its bf16
// rounding; precise: bf16 hi and lo; int8: int8 hi and lo, s_w in
// w1_scale[0]).  Grid (S, B).
template <GOp OP, int HP>
__global__ void __launch_bounds__(kThreads, 1)
abmil_fwd_general(const void* __restrict__ x, const float* __restrict__ x_scale,
                  const uint8_t* __restrict__ mask, const void* __restrict__ w1h,
                  const void* __restrict__ w1l, const float* __restrict__ w1_scale,
                  const float* __restrict__ b1, const float* __restrict__ w2, int N, int D,
                  int hid, int hid_p, int ld, int chunk, int S, float* __restrict__ ws_m,
                  float* __restrict__ ws_l, float* __restrict__ ws_acc) {
    using G = Gen<OP, HP>;
    using L = FwdSmemG<OP, HP>;
    extern __shared__ __align__(128) unsigned char smem[];
    float* red = reinterpret_cast<float*>(smem + L::red);
    float* logit_s = reinterpret_cast<float*>(smem + L::rows);
    float* p_s = logit_s + kGenM;
    float* valid_s = p_s + kGenM;
    float* sc_s = valid_s + kGenM;  // int8: the rows' dequant scales
    float* stat_s = sc_s + kGenM;   // m, l, correction
    const bool hid_smem = hid_in_smem(hid_p);  // every column's b1 and w2 held
    float* b1s = reinterpret_cast<float*>(smem + L::vecs);
    float* w2s = b1s + (hid_smem ? hid_p : HP);

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int split = blockIdx.x, b = blockIdx.y;
    const int n_begin = split * chunk;
    const int n_end = min(N, n_begin + chunk);
    const int row_bytes = D * G::kItem;
    const unsigned char* xb = static_cast<const unsigned char*>(x) + (size_t)b * N * row_bytes;
    const unsigned char* wh = static_cast<const unsigned char*>(w1h);
    const unsigned char* wl = static_cast<const unsigned char*>(w1l);
    const uint8_t* mb = mask + (size_t)b * N;
    const float sw = G::I8 ? *w1_scale : 1.f;
    const size_t part = (size_t)b * S + split;
    const bool pv_smem = d_in_smem(D);
    float* pv_s = pv_smem ? reinterpret_cast<float*>(smem + L::pv(hid_p)) : ws_acc + part * D;

    if (hid_smem) {
        for (int j = tid; j < hid_p; j += kThreads) {
            b1s[j] = j < hid ? b1[j] : 0.f;
            w2s[j] = j < hid ? w2[j] : 0.f;
        }
    }

    // this thread's channels of pv: c, c + 1 for c = c0 + 2 (tid + kThreads i)
    for (int c0 = 0; c0 < D; c0 += kPvCols) {
#pragma unroll
        for (int i = 0; i < kPvPairs; ++i) {
            const int c = c0 + 2 * (tid + kThreads * i);
            if (c < D) pv_s[c] = 0.f;
            if (c + 1 < D) pv_s[c + 1] = 0.f;
        }
    }
    if (tid == 0) {
        stat_s[0] = kNegInf;
        stat_s[1] = 0.f;
    }
    float acc[kMT][G::NT][4];

#pragma unroll 1
    for (int t0 = n_begin; t0 < n_end; t0 += kGenM) {
        if (tid < kGenM) {
            const int n = t0 + tid;
            valid_s[tid] = n < n_end && mb[n] != 0 ? 1.f : 0.f;
            sc_s[tid] = G::I8 && n < n_end ? x_scale[(size_t)b * N + n] : 1.f;
            logit_s[tid] = 0.f;
        }
#pragma unroll 1
        for (int j0 = 0; j0 < hid_p; j0 += HP) {
            if (!hid_smem) stage_pass_vecs<HP>(b1, w2, hid, j0, b1s, w2s);
            gen_h_product<OP, HP>(acc, xb, t0, n_end, row_bytes, ld * G::kItem, wh, wl, j0, sw,
                                  smem + L::w);
            gen_tanh_logit<G::NT, G::I8>(acc, b1s, w2s, hid_smem ? j0 : 0, sc_s, red);
            __syncthreads();
            if (tid < kGenM) {
                logit_s[tid] += (red[tid] + red[kGenM + tid]) +
                                (red[2 * kGenM + tid] + red[3 * kGenM + tid]);
            }
        }
        __syncthreads();

        if (warp == 0) {
            float lg[kGenM / 32];
            float mx = kNegInf;
#pragma unroll
            for (int i = 0; i < kGenM / 32; ++i) {
                const int r = lane + 32 * i;
                lg[i] = valid_s[r] != 0.f ? logit_s[r] : kNegInf;
                mx = fmaxf(mx, lg[i]);
            }
            mx = warp_max(mx);
            const float m_prev = stat_s[0];
            const float m_new = fmaxf(m_prev, mx);
            float psum = 0.f;
#pragma unroll
            for (int i = 0; i < kGenM / 32; ++i) {
                const int r = lane + 32 * i;
                const float p = valid_s[r] != 0.f ? expf(lg[i] - m_new) : 0.f;
                p_s[r] = G::I8 ? p * sc_s[r] : p;  // the PV weight folds in s[n]
                psum += p;
            }
            psum = warp_sum(psum);
            if (lane == 0) {
                const float corr = expf(m_prev - m_new);
                stat_s[2] = corr;
                stat_s[1] = stat_s[1] * corr + psum;
                stat_s[0] = m_new;
            }
        }
        __syncthreads();

        // PV over the tile's rows, re-read from L2, a block of channels at a time
        const int rows = min(kGenM, n_end - t0);
        const unsigned char* xt = xb + (size_t)t0 * row_bytes;
        if (D & 1) {
            pv_tile<OP, true>(xt, rows, row_bytes, D, p_s, stat_s[2], pv_s);
        } else {
            pv_tile<OP, false>(xt, rows, row_bytes, D, p_s, stat_s[2], pv_s);
        }
    }
    cp_async_wait<0>();

    if (tid == 0) {
        ws_m[part] = stat_s[0];
        ws_l[part] = stat_s[1];
    }
    if (!pv_smem) return;  // pv is the partial's row already
    for (int c0 = 0; c0 < D; c0 += kPvCols) {
#pragma unroll
        for (int i = 0; i < kPvPairs; ++i) {
            const int c = c0 + 2 * (tid + kThreads * i);
            if (c < D) ws_acc[part * D + c] = pv_s[c];
            if (c + 1 < D) ws_acc[part * D + c + 1] = pv_s[c + 1];
        }
    }
}

template <GOp OP, int HP>
cudaError_t launch_general_hp(const void* x, const float* x_scale, const uint8_t* mask,
                              const void* w1h, const void* w1l, const float* w1_scale,
                              const float* b1, const float* w2, int B, int N, int D, int hid,
                              int chunk, int S, float* ws_m, float* ws_l, float* ws_acc,
                              cudaStream_t stream) {
    auto kernel = abmil_fwd_general<OP, HP>;
    const int hid_p = gen_hid_pad(hid);
    const size_t smem = FwdSmemG<OP, HP>::total(D, hid_p);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(S, B), kThreads, smem, stream>>>(x, x_scale, mask, w1h, w1l, w1_scale, b1, w2,
                                                   N, D, hid, hid_p, gen_ld(D), chunk, S, ws_m,
                                                   ws_l, ws_acc);
    return cudaGetLastError();
}

template <GOp OP>
cudaError_t launch_general_op(int hp, const void* x, const float* x_scale, const uint8_t* mask,
                              const void* w1h, const void* w1l, const float* w1_scale,
                              const float* b1, const float* w2, int B, int N, int D, int hid,
                              int chunk, int S, float* ws_m, float* ws_l, float* ws_acc,
                              cudaStream_t stream) {
    // hp is gen_pass_cols': at most gen_max_pass(OP), whose instances alone exist
    if constexpr (gen_max_pass(OP) >= 256) {
        if (hp == 256) {
            return launch_general_hp<OP, 256>(x, x_scale, mask, w1h, w1l, w1_scale, b1, w2, B, N,
                                              D, hid, chunk, S, ws_m, ws_l, ws_acc, stream);
        }
    }
    if constexpr (gen_max_pass(OP) >= 128) {
        if (hp == 128) {
            return launch_general_hp<OP, 128>(x, x_scale, mask, w1h, w1l, w1_scale, b1, w2, B, N,
                                              D, hid, chunk, S, ws_m, ws_l, ws_acc, stream);
        }
    }
    return launch_general_hp<OP, 64>(x, x_scale, mask, w1h, w1l, w1_scale, b1, w2, B, N, D, hid,
                                     chunk, S, ws_m, ws_l, ws_acc, stream);
}

template <GOp OP>
size_t general_smem(int hp, int D, int hid) {
    const int hid_p = gen_hid_pad(hid);
    if constexpr (gen_max_pass(OP) >= 256) {
        if (hp == 256) return FwdSmemG<OP, 256>::total(D, hid_p);
    }
    if constexpr (gen_max_pass(OP) >= 128) {
        if (hp == 128) return FwdSmemG<OP, 128>::total(D, hid_p);
    }
    return FwdSmemG<OP, 64>::total(D, hid_p);
}

// W1 for the general instance, laid out [hid_p, ld] (bf16: its rounding,
// precise: hi and lo, in w1_ws; int8: hi and lo in w1_ws, s_w and the
// partial maxima in w1_scale; f32: its padded copy in w1_ws), then the
// partials.
cudaError_t launch_general(const void* x, const float* x_scale, const uint8_t* mask,
                           const float* w1, void* w1_ws, float* w1_scale, const float* b1,
                           const float* w2, int B, int N, int D, int hid, int chunk, int S,
                           int storage, bool precise, float* ws_m, float* ws_l, float* ws_acc,
                           cudaStream_t stream) {
    const int hid_p = gen_hid_pad(hid), ld = gen_ld(D);
    const size_t n = (size_t)hid_p * ld;
    const int hp = gen_pass_cols(storage, hid);
    cudaError_t err = cudaSuccess;
    const GOp op = gen_op(storage, precise);
    if (op == GOp::kI8) {
        int8_t* hi = static_cast<int8_t*>(w1_ws);
        err = launch_split_w1_i8(w1, hid, D, hid_p, ld, hi, w1_scale, stream);
        if (err != cudaSuccess) return err;
        return launch_general_op<GOp::kI8>(hp, x, x_scale, mask, hi, hi + n, w1_scale, b1, w2, B,
                                           N, D, hid, chunk, S, ws_m, ws_l, ws_acc, stream);
    }
    if (op == GOp::kF32) {
        float* wf = static_cast<float*>(w1_ws);
        pad_w1<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, stream>>>(w1, wf, hid,
                                                                                   D, ld, n);
        if ((err = cudaGetLastError()) != cudaSuccess) return err;
        return launch_general_op<GOp::kF32>(hp, x, nullptr, mask, wf, nullptr, nullptr, b1, w2,
                                            B, N, D, hid, chunk, S, ws_m, ws_l, ws_acc, stream);
    }
    __nv_bfloat16* wb = static_cast<__nv_bfloat16*>(w1_ws);
    if ((err = launch_prep_w1(w1, wb, precise, hid, D, hid_p, ld, stream)) != cudaSuccess) {
        return err;
    }
    if (precise) {
        return launch_general_op<GOp::kBf16P>(hp, x, nullptr, mask, wb, wb + n, nullptr, b1, w2,
                                              B, N, D, hid, chunk, S, ws_m, ws_l, ws_acc, stream);
    }
    return launch_general_op<GOp::kBf16>(hp, x, nullptr, mask, wb, nullptr, nullptr, b1, w2, B,
                                         N, D, hid, chunk, S, ws_m, ws_l, ws_acc, stream);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one partial block needs.
size_t abmil_fwd_smem_bytes(int storage, int D, int hid, int precise) {
    if (special_widths(storage, D, hid, precise != 0)) {
        if (storage == kF32) return FwdSmemF::total;
        if (storage == kBF16) return FwdSmemQ<__nv_bfloat16>::total;
        return FwdSmemQ<int8_t>::total;
    }
    const int hp = gen_pass_cols(storage, hid);
    switch (gen_op(storage, precise != 0)) {
        case GOp::kF32: return general_smem<GOp::kF32>(hp, D, hid);
        case GOp::kBf16: return general_smem<GOp::kBf16>(hp, D, hid);
        case GOp::kBf16P: return general_smem<GOp::kBf16P>(hp, D, hid);
        default: return general_smem<GOp::kI8>(hp, D, hid);
    }
}

// x [B, N, D] (storage: 0 f32, 1 bf16, 2 int8); x_scale [B, N] f32 for int8,
// else null; mask [B, N] bool; w1 [hid, D], b1 and w2 [hid] f32; precise:
// bf16's precise mode (W1 as bf16 hi + lo).  Workspace: w1_ws W1 for the
// kernel, laid out [hid_p, ld] on the general instances (gen_hid_pad,
// gen_ld) and [hid, D] on the D = 512, hid = 256 ones: f32 null there, and
// on the general instances its padded copy, f32 [hid_p, ld];
// bf16 its bf16 rounding; bf16 precise [2, ...] bf16 (hi and lo); int8
// [2, ...] int8 (hi, lo); w1_scale f32 [65] (int8: s_w
// and 64 partial maxima of |W1|; else null); ws_m and ws_l [B, S], ws_acc
// [B, S, D] f32.  Outputs: out [B, D], m and l [B] f32.  All on CUDA device
// `device`; the kernels go to `stream`.  Returns the launches' cudaError_t
// (0 on success).
int abmil_fwd(const void* x, const void* x_scale, const void* mask, const void* w1,
              const void* b1, const void* w2, int B, int N, int D, int hid, int chunk, int S,
              int storage, int precise, int device, void* w1_ws, void* w1_scale, void* ws_m,
              void* ws_l, void* ws_acc, void* out, void* m_out, void* l_out, void* stream) {
    const bool special = special_widths(storage, D, hid, precise != 0);
    const bool needs_ws = storage != kF32 || !special;
    if (B < 1 || N < 1 || S < 1 || chunk < 1 || !widths_ok(D, hid)
        || needs_ws != (w1_ws != nullptr)
        || (storage == kI8) != (w1_scale != nullptr)
        || (storage == kI8) != (x_scale != nullptr)) {
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
    float* wsc = static_cast<float*>(w1_scale);
    float* wm = static_cast<float*>(ws_m);
    float* wl = static_cast<float*>(ws_l);
    float* wa = static_cast<float*>(ws_acc);
    if (storage != kF32 && storage != kBF16 && storage != kI8) return (int)cudaErrorInvalidValue;
    if (!special) {
        err = launch_general(x, xs, mk, w1f, w1_ws, wsc, b1f, w2f, B, N, D, hid, chunk, S,
                             storage, precise != 0 && storage == kBF16, wm, wl, wa, st);
    } else if (storage == kF32) {
        err = launch_partial_f32(static_cast<const float*>(x), mk, w1f, b1f, w2f, B, N, chunk,
                                 S, wm, wl, wa, st);
    } else if (storage == kBF16) {
        err = launch_partial<__nv_bfloat16>(x, xs, mk, w1f, w1_ws, wsc, b1f, w2f, B, N, chunk,
                                            S, wm, wl, wa, st);
    } else {
        err = launch_partial<int8_t>(x, xs, mk, w1f, w1_ws, wsc, b1f, w2f, B, N, chunk, S, wm,
                                     wl, wa, st);
    }
    if (err != cudaSuccess) return (int)err;
    const size_t merge_smem = sizeof(float) * (size_t)S;
    if (merge_smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    abmil_fwd_merge<<<B, kThreads, merge_smem, st>>>(wm, wl, wa, S, D, static_cast<float*>(out),
                                                     static_cast<float*>(m_out),
                                                     static_cast<float*>(l_out));
    return (int)cudaGetLastError();
}

}  // extern "C"
