// Masked co-attention pooling, dQ-only backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel body vlsa_tpu/ops/coattn.py:407 _coattn_bwd_dq_body
// and its four launch variants (_coattn_bwd_dq_kernel :458,
// _coattn_bwd_dq_kernel_q8 :464, _coattn_bwd_dq_kernel_q8i :472,
// _coattn_bwd_dq_kernel_i :480).  The patch features x are constants (VLFAN
// without a feature projecter), so only the queries get a gradient, dq [P, C].
// int8 rows are taken raw: the normalised logit and the dq contraction
// inv[n] * x[n] do not depend on the per-patch scale, which multiplies only
// the attention cotangent g . x.
//
// The body -- its rounding (q, g and dl as bf16 hi + lo, f32 in split TF32),
// grid (persistent blocks over flat tile ranges, one dq partial a block,
// summed in block order), per-warp cp.async ring, tensor-core products and
// bound (the byte stream of x) -- is coattn_bwd.cuh's, instantiated here
// without dX for the three storages, with and without host 1/||x||, and
// for C <= 512 or wide.
#include "coattn_bwd.cuh"

using namespace coattn;

extern "C" {

// Bytes of dynamic shared memory of a block (0: P or C not taken).
size_t coattn_bwd_dq_smem_bytes(int P, int C, int storage) {
    return bwd_smem_bytes(P, C, storage, false);
}

// q [P, C] f32; x [B, N, C] (storage: 0 f32, 1 bf16, 2 int8); x_scale [B, N]
// f32 for int8, else null; x_inv [B, N] f32 or null; mask [B, N] bool; g and
// out [B, P, C] f32 (the output's cotangent and the forward output); m and l
// [B, P] f32 (the forward's softmax stats).  The kernel runs ceil(B*Tb / L)
// blocks of L tiles (Tb = ceil(N / tile) a bag) for each of the ceil(C / 512)
// channel groups and ceil(P / 16) query groups (launched in chunks of
// kMaxQueryGroups groups past that many); workspace ws_dq [ceil(B*Tb / L),
// P, C] f32.  Output dq
// [P, C] f32.  All on CUDA device `device`; the kernels go to `stream`.
// Returns the launches' cudaError_t (0 on success).
int coattn_bwd_dq(const void* q, const void* x, const void* x_scale, const void* x_inv,
                  const void* mask, float scale, const void* g, const void* out, const void* m,
                  const void* l, int B, int N, int C, int P, int L, int storage, int device,
                  void* ws_dq, void* dq, void* stream) {
    if (bwd_smem_bytes(P, C, storage, false) == 0 || B < 1 || N < 0 || L < 1
        || (storage == kI8) != (x_scale != nullptr)
        || (storage != kF32 && storage != kBF16 && storage != kI8)) {
        return (int)cudaErrorInvalidValue;
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const int tile = bwd_tile_of(storage, P, false);
    const int Tb = (N + tile - 1) / tile;
    const BwdArgs a{static_cast<const float*>(q), x, static_cast<const float*>(x_scale),
                    static_cast<const float*>(x_inv), static_cast<const uint8_t*>(mask), scale,
                    static_cast<const float*>(g), static_cast<const float*>(out),
                    static_cast<const float*>(m), static_cast<const float*>(l),
                    N, C, P, Tb, B * Tb, L, static_cast<float*>(ws_dq), nullptr, 0, nullptr};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    float* dqf = static_cast<float*>(dq);
    err = storage == kF32 ? run_bwd<kF32, false>(a, dqf, st)
          : storage == kBF16 ? run_bwd<kBF16, false>(a, dqf, st) : run_bwd<kI8, false>(a, dqf, st);
    return (int)err;
}

}  // extern "C"
