"""The port's dQ backward (vlsa_tpu_torch.ops.coattn) against the JAX
package's dQ-only Pallas kernel, run in interpret mode, on the same inputs
made with numpy: `jax.vjp` of `_coattn_pool_tpu_nodx` / `_coattn_pool_tpu_nodx_q8`,
whose backward is `_coattn_bwd_dq_body`.

Both port routes are held: the plain dQ from the forward's stats
(`coattn_bwd_dq_reference`, the version the CUDA kernel is checked against
on the card) and autograd through the plain forward (the CPU path of
`coattn_pool`).  Every variant has a ragged tail and an empty bag.

Tolerances are max|a-b| / max|b|, the dq tolerances of
scripts/validate_kernels_chip.py:87-95: f32 1e-3, bf16 and int8 2e-3.  The
JAX kernel splits its small matrices into hi/lo bf16 (bf16) or int8 (int8)
rows, ~16 bits of mantissa instead of f32's 24; the measured deviations are
far inside these bounds (8e-7 for f32, 8e-6 for bf16, 2.9e-4 for int8).
The two port routes agree with each other to 1e-5 (both f32, in another
summation order; measured 1.7e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vlsa_tpu.ops.coattn as jco
from test_torch_coattn import B, C, P, SCALE, _inputs, _rel, _torch
from vlsa_tpu_torch.ops import coattn as tco

TOL = {"f32": 1e-3, "f32_inv": 1e-3, "bf16": 2e-3, "bf16_inv": 2e-3,
       "int8": 2e-3, "int8_inv": 2e-3}


def _cotangent(seed=5):
    return np.random.default_rng(seed).normal(size=(B, P, C)).astype(np.float32)


def _jax_dq(q, x, mask, x_scale, x_inv, g):
    old = jco.INTERPRET
    jco.INTERPRET = True
    try:
        xj, mj, s = jnp.asarray(x), jnp.asarray(mask), jnp.float32(SCALE)
        if x_scale is None and x_inv is None:
            def fn(q_):
                return jco._coattn_pool_tpu_nodx(q_, xj, mj, s)
        else:
            xs = None if x_scale is None else jnp.asarray(x_scale)
            xi = None if x_inv is None else jnp.asarray(x_inv)

            def fn(q_):
                return jco._coattn_pool_tpu_nodx_q8(q_, xj, xs, xi, mj, s)
        _out, vjp = jax.vjp(fn, jnp.asarray(q))
        return np.asarray(vjp(jnp.asarray(g))[0])
    finally:
        jco.INTERPRET = old


@pytest.mark.parametrize("variant", list(TOL))
def test_dq_matches_pallas_kernel(variant):
    q, x, mask, x_scale, x_inv, _stored = _inputs(variant, seed=2)
    g = _cotangent()
    want = _jax_dq(q, x, mask, x_scale, x_inv, g)
    assert want.shape == (P, C) and np.isfinite(want).all()

    tq, tx, tm = _torch(q), _torch(x), _torch(mask)
    ts, ti, tg = _torch(x_scale), _torch(x_inv), _torch(g)
    out, m, l = tco.coattn_fwd_reference(tq, tx, tm, SCALE, ts, ti)
    assert torch.all(m[-1] == -1e30) and torch.all(l[-1] == 1e-30)  # the empty bag
    dq_stats = tco.coattn_bwd_dq_reference(tq, tx, tm, SCALE, tg, out, m, l, ts, ti)
    assert torch.isfinite(dq_stats).all()
    assert _rel(dq_stats.numpy(), want) < TOL[variant]

    tco.reset_launches()
    q_leaf = tq.clone().requires_grad_(True)
    tco.coattn_pool(q_leaf, tx, tm, SCALE, x_scale=ts, x_inv=ti).backward(tg)
    assert sum(tco.LAUNCHES.values()) + sum(tco.LAUNCHES_BWD.values()) == 0
    assert _rel(q_leaf.grad.numpy(), want) < TOL[variant]
    assert _rel(dq_stats.numpy(), q_leaf.grad.numpy()) < 1e-5


@pytest.mark.parametrize("variant", ["f32", "int8_inv"])
def test_stats_forward_matches_pooling(variant):
    """`coattn_fwd_reference` pools as `coattn_pool_reference` does, and its
    stats rebuild the softmax: sum_n exp(logit - m) / l = 1 for a bag."""
    q, x, mask, x_scale, x_inv, _stored = _inputs(variant, seed=3)
    tq, tx, tm, ts, ti = map(_torch, (q, x, mask, x_scale, x_inv))
    out, m, l = tco.coattn_fwd_reference(tq, tx, tm, SCALE, ts, ti)
    want = tco.coattn_pool_reference(tq, tx, tm, SCALE, x_scale=ts)
    assert _rel(out.numpy(), want.numpy()) < 1e-5
    assert torch.all(out[-1] == 0)
    attn = tco.coattn_attention_reference(tq, tx, tm, SCALE, x_scale=ts)
    assert torch.allclose(attn.amax(-1)[:-1] * l[:-1], torch.ones_like(l[:-1]), atol=1e-5)


def test_dq_wrapper_refuses_cpu_tensors():
    q, x, mask, _s, _i, _st = _inputs("f32")
    tq, tx, tm = _torch(q), _torch(x), _torch(mask)
    out, m, l = tco.coattn_fwd_reference(tq, tx, tm, SCALE)
    with pytest.raises(ValueError, match="CUDA"):
        tco.coattn_bwd_dq(tq, tx, tm, SCALE, torch.ones_like(out), out, m, l)
