"""The port's co-attention pooling (vlsa_tpu_torch.ops.coattn) against the
JAX package's Pallas kernels, run in interpret mode, and against its plain
reference, on the same inputs made with numpy.

On the CPU `coattn_pool` runs the port's plain version, so this holds the
plain version that the CUDA kernel is checked against on the card.
Tolerances are max|a-b| / max|b|:
  * f32 1e-5: both sides compute in f32;
  * bf16 2e-4: the JAX kernel splits q and the softmax weights into hi/lo
    bf16 halves, ~16 mantissa bits instead of f32's 24;
  * int8 1e-3: the JAX kernel quantizes those matrices to int8 hi/lo rows
    (vlsa_tpu/ops/coattn.py::_mm_rows_i8), the coattn_int8 forward
    tolerance of scripts/validate_kernels_chip.py.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import vlsa_tpu.ops.coattn as jco
from vlsa_tpu.data.pipeline import feats_inv_norms, quantize_feats_int8
from vlsa_tpu_torch.ops import coattn as tco

B, N, C, P, SCALE = 3, 512, 64, 12, 30.0
TOL = {"f32": 1e-5, "bf16": 2e-4, "bf16_inv": 2e-4, "int8": 1e-3, "int8_inv": 1e-3}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _inputs(variant: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(P, C)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    x = rng.normal(size=(B, N, C)).astype(np.float32)
    mask = rng.random((B, N)) > 0.1
    mask[:, N - 37:] = False   # ragged tail
    mask[-1] = False           # an empty bag
    x[~mask] = 0.0
    x_scale = x_inv = None
    if variant.startswith("int8"):
        x, x_scale = quantize_feats_int8(x)
        stored = x.astype(np.float32) * x_scale[..., None]
    elif variant.startswith("bf16"):
        x = x.astype(ml_dtypes.bfloat16)
        stored = x.astype(np.float32)
    else:
        stored = x
    if variant.endswith("_inv"):
        x_inv = feats_inv_norms(x.astype(np.float32))
    return q, x, mask, x_scale, x_inv, stored


def _jax_kernel(q, x, mask, x_scale, x_inv):
    old = jco.INTERPRET
    jco.INTERPRET = True
    try:
        args = (jnp.asarray(q), jnp.asarray(x))
        if x_scale is None and x_inv is None:
            out = jco._coattn_pool_tpu_nodx(*args, jnp.asarray(mask), jnp.float32(SCALE))
        else:
            out = jco._coattn_pool_tpu_nodx_q8(
                *args, None if x_scale is None else jnp.asarray(x_scale),
                None if x_inv is None else jnp.asarray(x_inv), jnp.asarray(mask),
                jnp.float32(SCALE))
        return np.asarray(out)
    finally:
        jco.INTERPRET = old


def _torch(a):
    if a is None:
        return None
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("variant", list(TOL))
def test_coattn_pool_matches_pallas_kernel(variant):
    q, x, mask, x_scale, x_inv, stored = _inputs(variant)
    tco.reset_launches()
    out = tco.coattn_pool(_torch(q), _torch(x), _torch(mask), SCALE,
                          x_scale=_torch(x_scale), x_inv=_torch(x_inv)).numpy()
    assert sum(tco.LAUNCHES.values()) == 0  # the CPU path launches no kernel
    assert out.shape == (B, P, C) and np.isfinite(out).all()
    assert np.all(out[-1] == 0.0)           # the empty bag pools to exactly 0

    ref_kernel = _jax_kernel(q, x, mask, x_scale, x_inv)
    assert _rel(out, ref_kernel) < TOL[variant]

    # the JAX plain reference on the same stored values, in f32
    ref_plain = np.asarray(jco.coattn_pool_reference(
        jnp.asarray(q), jnp.asarray(stored), jnp.asarray(mask), SCALE))
    assert _rel(out, ref_plain) < 1e-5


def test_attention_reference_rows_sum_to_one():
    q, x, mask, _s, _i, _st = _inputs("f32", seed=1)
    attn = tco.coattn_attention_reference(_torch(q), _torch(x), _torch(mask), SCALE)
    sums = attn.sum(-1).numpy()
    np.testing.assert_allclose(sums[:-1], 1.0, atol=1e-5)
    assert np.all(sums[-1] == 0.0)


def test_kernel_wrapper_refuses_cpu_tensors():
    q, x, mask, _s, _i, _st = _inputs("f32")
    with pytest.raises(ValueError, match="CUDA"):
        tco.coattn_fwd(_torch(q), _torch(x), _torch(mask), SCALE)
    xi, s = quantize_feats_int8(x)
    with pytest.raises(ValueError, match="x_scale"):
        tco.coattn_pool(_torch(q), _torch(xi), _torch(mask), SCALE)


@pytest.mark.parametrize("B_,N_", [(8, 10240), (64, 10240), (1, 5), (2, 0)])
def test_split_plan_covers_every_patch(B_, N_):
    chunk, S = tco.split_plan(B_, N_, n_sm=132)
    assert chunk % 32 == 0 and S >= 1
    assert (S - 1) * chunk < max(N_, 1) <= S * chunk
