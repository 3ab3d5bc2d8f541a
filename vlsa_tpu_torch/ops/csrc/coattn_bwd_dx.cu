// Masked co-attention pooling, full backward (dq and dX), for Hopper (sm_90a).
//
// Replaces the TPU kernel vlsa_tpu/ops/coattn.py:345 _coattn_bwd_kernel (its
// launcher _coattn_pallas_bwd).  The patch features x need a gradient here
// (VLFAN with a feature projecter), so besides the queries' gradient dq this
// kernel writes dX [B, N, C] in x's type, every row: zeros where masked.
// x is f32 or bf16 and its norms are computed in the kernel.
//
// The body -- its rounding (bf16: a, g and dl enter the dX products rounded
// to bf16 as the TPU kernel rounds them, q as bf16 hi + lo, dX rounded once
// at the store; f32 in split TF32), grid, per-warp cp.async ring whose slot
// stages dX for 16-byte stores, tensor-core products and bound (x read and
// dX written once) -- is coattn_bwd.cuh's, instantiated here with dX for f32
// and bf16, for C <= 512 or wide.
#include "coattn_bwd.cuh"

using namespace coattn;

extern "C" {

// Bytes of dynamic shared memory of a block (0: P, C or the storage not taken).
size_t coattn_bwd_dx_smem_bytes(int P, int C, int storage) {
    return storage == kI8 ? 0 : bwd_smem_bytes(P, C, storage, true);
}

// q [P, C] f32; x [B, N, C] (storage: 0 f32, 1 bf16); mask [B, N] bool; g and
// out [B, P, C] f32 (the output's cotangent and the forward output); m and l
// [B, P] f32 (the forward's softmax stats).  The kernel runs ceil(B*Tb / L)
// blocks of L tiles (Tb = ceil(N / tile) a bag) for each of the ceil(C / 512)
// channel groups; workspace ws_dq [ceil(B*Tb / L), P, C] f32 and, above 16
// queries (the looped instance), ws_srow [B, P] f32 (else null).  Outputs dq
// [P, C] f32 and dx [B, N, C] in x's type, every row written.  All on CUDA
// device `device`; the kernels go to `stream`.  Returns the launches'
// cudaError_t (0 on success).
int coattn_bwd_dx(const void* q, const void* x, const void* mask, float scale, const void* g,
                  const void* out, const void* m, const void* l, int B, int N, int C, int P,
                  int L, int storage, int device, void* ws_dq, void* ws_srow, void* dq,
                  void* dx, void* stream) {
    if (coattn_bwd_dx_smem_bytes(P, C, storage) == 0 || B < 1 || N < 0 || L < 1
        || (storage != kF32 && storage != kBF16)
        || loops_groups(P, true) != (ws_srow != nullptr)) {
        return (int)cudaErrorInvalidValue;
    }
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const int tile = bwd_tile_of(storage, P, true);
    const int Tb = (N + tile - 1) / tile;
    const BwdArgs a{static_cast<const float*>(q), x, nullptr, nullptr,
                    static_cast<const uint8_t*>(mask), scale, static_cast<const float*>(g),
                    static_cast<const float*>(out), static_cast<const float*>(m),
                    static_cast<const float*>(l), N, C, P, Tb, B * Tb, L,
                    static_cast<float*>(ws_dq), dx, 0, static_cast<float*>(ws_srow)};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    float* dqf = static_cast<float*>(dq);
    err = storage == kF32 ? run_bwd<kF32, true>(a, dqf, st) : run_bwd<kBF16, true>(a, dqf, st);
    return (int)err;
}

}  // extern "C"
