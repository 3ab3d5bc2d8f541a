"""The port's full co-attention backward (dq and dX; vlsa_tpu_torch.ops.coattn)
against the JAX package's `_coattn_bwd_kernel`, run in interpret mode, on the
same inputs made with numpy: `jax.vjp` of `_coattn_pool_tpu` with respect to
q and x.  B=3, N=512, C=64, P=12, scale 30, 10% of patches masked, a ragged
tail and an empty bag; the masked rows keep nonzero features (as a feature
projecter's output has), so a zero dX there is the backward's doing.

Both port routes are held: the plain full backward from the forward's stats
(`coattn_bwd_dx_reference`, the version the CUDA kernel is checked against
on the card) and autograd through the plain forward (the CPU path of
`coattn_pool`).  Tolerances, max|a-b| / max|b| [measured]:
  * plain backward vs the kernel, f32: dq and dX 1e-5, both f32 up to
    summation order [6.0e-7, 3.4e-7];
  * bf16: dq 2e-3, the dq tolerance of scripts/validate_kernels_chip.py:87-95
    (the kernel splits its small matrices into hi/lo bf16, ~16 mantissa
    bits) [4.7e-6]; dX within one bf16 ulp at the scale of its largest
    element, 2^(floor(log2 max|b|) - 7): both sides round a, g and dl to bf16
    at the same places and dX once at the end, and their f32 sums differ only
    in order and in the kernel's hi/lo products [1.6e-5 of max|b|];
  * autograd vs the kernel: f32 1e-5 [1.1e-6]; bf16 dq 2e-3 and dX 2e-2, the
    `coattn_bf16_dx` tolerance of scripts/validate_kernels_chip.py:91 --
    autograd does not round a, g and dl [2.0e-3].
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import vlsa_tpu.ops.coattn as jco
from test_torch_coattn import _rel, _torch
from vlsa_tpu_torch.ops import coattn as tco

B, N, C, P, SCALE = 3, 512, 64, 12, 30.0
STORAGES = ("f32", "bf16")
TOL_DQ = {"f32": 1e-5, "bf16": 2e-3}
TOL_AUTOGRAD_DX = {"f32": 1e-5, "bf16": 2e-2}


def _inputs(storage: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(P, C)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    x = rng.normal(size=(B, N, C)).astype(np.float32)
    mask = rng.random((B, N)) > 0.1
    mask[:, N - 37:] = False   # ragged tail
    mask[-1] = False           # an empty bag
    if storage == "bf16":
        x = x.astype(ml_dtypes.bfloat16)
    g = rng.normal(size=(B, P, C)).astype(np.float32)
    return q, x, mask, g


def _jax_grads(q, x, mask, g):
    """(dq, dX as f32) of the Pallas full backward in interpret mode."""
    old = jco.INTERPRET
    jco.INTERPRET = True
    try:
        def fn(q_, x_):
            return jco._coattn_pool_tpu(q_, x_, jnp.asarray(mask), jnp.float32(SCALE))
        _out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(x))
        dq, dx = vjp(jnp.asarray(g))
        assert dx.dtype == x.dtype
        return np.asarray(dq), np.asarray(dx).astype(np.float32)
    finally:
        jco.INTERPRET = old


def _bf16_ulp_of_max(a) -> float:
    return float(2.0 ** (np.floor(np.log2(np.abs(a).max())) - 7))


def _plain_backward(q, x, mask, g):
    tq, tx, tm, tg = _torch(q), _torch(x), _torch(mask), _torch(g)
    out, m, l = tco.coattn_fwd_reference(tq, tx, tm, SCALE)
    return tco.coattn_bwd_dx_reference(tq, tx, tm, SCALE, tg, out, m, l)


@pytest.mark.parametrize("storage", STORAGES)
def test_dx_reference_matches_pallas_kernel(storage):
    q, x, mask, g = _inputs(storage)
    want_dq, want_dx = _jax_grads(q, x, mask, g)
    assert np.isfinite(want_dx).all() and np.all(want_dx[~mask] == 0)

    dq, dx = _plain_backward(q, x, mask, g)
    assert dq.dtype == torch.float32 and dq.shape == (P, C)
    assert dx.dtype == _torch(x).dtype and dx.shape == (B, N, C)
    assert _rel(dq.numpy(), want_dq) < TOL_DQ[storage]
    got = dx.float().numpy()
    if storage == "f32":
        assert _rel(got, want_dx) < 1e-5
    else:
        assert np.abs(got - want_dx).max() <= _bf16_ulp_of_max(want_dx)


@pytest.mark.parametrize("storage", STORAGES)
def test_autograd_matches_pallas_kernel(storage):
    """The CPU path of `coattn_pool` with q and x needing gradients: plain
    autograd, no kernel launched."""
    q, x, mask, g = _inputs(storage, seed=1)
    want_dq, want_dx = _jax_grads(q, x, mask, g)
    tq = _torch(q).requires_grad_(True)
    tx = _torch(x).requires_grad_(True)
    tco.reset_launches()
    tco.coattn_pool(tq, tx, _torch(mask), SCALE).backward(_torch(g))
    assert sum(tco.LAUNCHES.values()) + sum(tco.LAUNCHES_DX.values()) == 0
    assert tx.grad.dtype == tx.dtype
    assert _rel(tq.grad.numpy(), want_dq) < TOL_DQ[storage]
    assert _rel(tx.grad.float().numpy(), want_dx) < TOL_AUTOGRAD_DX[storage]


@pytest.mark.parametrize("storage", STORAGES)
def test_x_gradient_without_q_gradient(storage):
    """x alone needing a gradient gives the same dX as x and q together, and
    q none."""
    q, x, mask, g = _inputs(storage, seed=2)
    grads = []
    for q_grad in (True, False):
        tq = _torch(q).requires_grad_(q_grad)
        tx = _torch(x).requires_grad_(True)
        tco.coattn_pool(tq, tx, _torch(mask), SCALE).backward(_torch(g))
        grads.append((tq.grad, tx.grad))
    (dq_both, dx_both), (dq_x, dx_x) = grads
    assert dq_both is not None and dq_x is None
    assert torch.equal(dx_x, dx_both)


@pytest.mark.parametrize("storage", STORAGES)
def test_dx_is_zero_on_masked_rows_and_the_empty_bag(storage):
    q, x, mask, g = _inputs(storage, seed=3)
    assert np.abs(np.asarray(x, np.float32)[~mask]).min() > 0  # features there
    _dq, dx = _plain_backward(q, x, mask, g)
    dx = dx.float()
    tm = _torch(mask)
    assert torch.all(dx[~tm] == 0) and torch.all(dx[-1] == 0)
    assert torch.all(dx[tm].abs().sum(-1) > 0)


def test_quantized_features_with_a_gradient_raise():
    q, x, mask, _g = _inputs("f32", seed=4)
    xi = np.clip(np.round(x * 20), -127, 127).astype(np.int8)
    scale = torch.full((B, N), 0.05, requires_grad=True)
    with pytest.raises(ValueError, match="constants"):
        tco.coattn_pool(_torch(q), _torch(xi), _torch(mask), SCALE, x_scale=scale)
    with pytest.raises(ValueError, match="constants"):
        tco.coattn_pool(_torch(q), _torch(x).requires_grad_(True), _torch(mask), SCALE,
                        x_scale=scale.detach())
    with torch.no_grad():  # no gradient requested: int8 pools as before
        out = tco.coattn_pool(_torch(q), _torch(xi), _torch(mask), SCALE, x_scale=scale)
    assert out.shape == (B, P, C) and torch.isfinite(out).all()


def test_dx_wrapper_refuses_cpu_tensors():
    q, x, mask, g = _inputs("f32")
    tq, tx, tm = _torch(q), _torch(x), _torch(mask)
    out, m, l = tco.coattn_fwd_reference(tq, tx, tm, SCALE)
    with pytest.raises(ValueError, match="CUDA"):
        tco.coattn_bwd_dx(tq, tx, tm, SCALE, _torch(g), out, m, l)
