"""The port's CONCH visual model against vlsa_tpu's, with the JAX init's
weights bridged into the port (a small model: width 64, 4 heads of 16,
2 layers, 48-pixel images, so L = 1 + 3*3 = 10), and the checkpoint import
against `import_conch_visual_state`.

On the CPU the port's trunk attention is the plain flash version, JAX's the
dense block path (no TPU); both normalise P before rounding it to the
compute type.  Tolerances (max|a-b| / max|b|): f32 1e-5 (summation order;
measured <= 1.1e-6).  bf16 2e-3: both round the linears' operands and P to
bf16 and sum in f32, but a value within summation-order distance of a bf16
boundary rounds apart, a 2^-8 step (measured 9.5e-5 to 1.6e-4), as for the
text tower.  A block that carries its residual stream in bf16 returns bf16:
there one bf16 ulp of the largest output, up to 2^-7 (measured 3.9e-3).
The import and the position-table resize are exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlsa_tpu.models import vision_tower as jvt
from vlsa_tpu.models.precision import cast_vision_tower_weights as jax_cast
from vlsa_tpu_torch.models import vision_tower as vt
from vlsa_tpu_torch.models.precision import cast_vision_tower_weights
from vlsa_tpu_torch.utils.weights import state_dict_from_jax

SMALL = dict(layers=2, width=64, heads=4, embed_dim_contrast=64, embed_dim_caption=32,
             attn_pooler_heads=4, n_queries_caption=4, patch_size=16)
TOL = {"float32": 1e-5, "bfloat16": 2e-3}
RNG = np.random.default_rng(5)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("dtype,residual", [("float32", "float32"), ("bfloat16", "float32"),
                                            ("bfloat16", "bfloat16")])
def test_block(dtype, residual):
    x = RNG.normal(size=(2, 37, 64)).astype(np.float32)
    ref = jvt.TimmViTBlock(64, 4, compute_dtype=dtype, residual_dtype=residual)
    xj = jnp.asarray(x, residual)
    params = _np(jax.jit(ref.init)(jax.random.PRNGKey(1), xj)["params"])
    want = _f32(jax.jit(ref.apply)({"params": params}, xj))
    blk = vt.TimmViTBlock(64, 4, compute_dtype=dtype, residual_dtype=residual)
    blk.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = blk(torch.from_numpy(x).to(vt.as_dtype(residual)))
    assert got.dtype == vt.as_dtype(residual)
    assert _rel(got.float().numpy(), want) <= (2 ** -7 if residual == "bfloat16" else TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trunk(dtype):
    imgs = RNG.normal(size=(2, 3, 48, 48)).astype(np.float32)
    kw = dict(image_size=48, patch_size=16, width=64, layers=2, heads=4, compute_dtype=dtype)
    ref = jvt.TimmViTTrunk(**kw)
    params = _np(jax.jit(ref.init)(jax.random.PRNGKey(2), jnp.asarray(imgs))["params"])
    want = np.asarray(jax.jit(ref.apply)({"params": params}, jnp.asarray(imgs)))
    trunk = vt.TimmViTTrunk(**kw)
    trunk.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = trunk(torch.from_numpy(imgs)).numpy()
    assert got.shape == (2, 10, 64)
    assert _rel(got, want) <= TOL[dtype]


@pytest.mark.parametrize("masked", [False, True])
def test_attentional_pooler(masked):
    x = RNG.normal(size=(3, 11, 64)).astype(np.float32)
    mask = np.ones((3, 11), bool)
    mask[1, 7:] = False
    ref = jvt.AttentionalPooler(32, 64, 4, 5)
    params = _np(ref.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"])
    want = np.asarray(ref.apply({"params": params}, jnp.asarray(x),
                                jnp.asarray(mask) if masked else None))
    pool = vt.AttentionalPooler(32, 64, 4, 5)
    pool.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = pool(torch.from_numpy(x), torch.from_numpy(mask) if masked else None).numpy()
    assert got.shape == (3, 5, 32)
    assert _rel(got, want) <= 1e-5


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def models(request):
    """(dtype, images, JAX model, its params as the extractor casts them,
    the port's model through the bridge)."""
    dtype = request.param
    imgs = RNG.normal(size=(3, 3, 48, 48)).astype(np.float32)
    ref = jvt.ConchVisualModel(image_size=48, compute_dtype=dtype, **SMALL)
    params = jax.jit(ref.init)(jax.random.PRNGKey(0), jnp.asarray(imgs))["params"]
    if dtype == "bfloat16":
        params = jax_cast(params)
    params = _np(params)
    model = vt.ConchVisualModel(image_size=48, compute_dtype=dtype, **SMALL)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    if dtype == "bfloat16":
        cast_vision_tower_weights(model)
    return dtype, imgs, ref, params, model.eval()


def test_forward_no_head(models):
    dtype, imgs, ref, params, model = models
    want = np.asarray(ref.apply({"params": params}, jnp.asarray(imgs),
                                method=jvt.ConchVisualModel.forward_no_head))
    with torch.no_grad():
        got = model.forward_no_head(torch.from_numpy(imgs)).numpy()
    assert got.shape == (3, SMALL["embed_dim_contrast"])
    assert _rel(got, want) <= TOL[dtype]


def test_forward_both_pools(models):
    dtype, imgs, ref, params, model = models
    want_pooled, want_cap = ref.apply({"params": params}, jnp.asarray(imgs))
    with torch.no_grad():
        pooled, cap = model(torch.from_numpy(imgs))
    assert pooled.shape == (3, 64) and cap.shape == (3, 4, 32)
    assert _rel(pooled.numpy(), want_pooled) <= TOL[dtype]
    assert _rel(cap.numpy(), want_cap) <= TOL[dtype]


def test_cast_matches_jax_and_changes_nothing(models):
    """The bf16 pre-cast covers the tensors JAX's covers (none for f32
    compute, where neither package casts), and the model's output is
    bit-identical with and without it."""
    dtype, imgs, _ref, params, model = models
    cast = {k for k, v in state_dict_from_jax(params).items() if v.dtype == torch.bfloat16}
    assert cast == {k for k, v in model.state_dict().items() if v.dtype == torch.bfloat16}
    f32 = vt.ConchVisualModel(image_size=48, compute_dtype=dtype, **SMALL)
    f32.load_state_dict({k: v.float() for k, v in model.state_dict().items()}, strict=True)
    with torch.no_grad():
        x = torch.from_numpy(imgs)
        assert torch.equal(f32.forward_no_head(x), model.forward_no_head(x))


def _fake_conch_state(rng, grid, W=64, L=2, Dc=64, Dcap=32, n_cap=4, P=16, fused_caption=True):
    """A torch-layout CONCH `visual.*` state dict; the caption pool with
    torch MHA's fused in_proj_weight (kdim == embed_dim), the contrast pool
    with separate projections."""
    def n(*s):
        return rng.normal(size=s).astype(np.float32) * 0.02

    st = {"visual.trunk.patch_embed.proj.weight": n(W, 3, P, P),
          "visual.trunk.patch_embed.proj.bias": n(W), "visual.trunk.cls_token": n(1, 1, W),
          "visual.trunk.pos_embed": n(1, 1 + grid * grid, W),
          "visual.trunk.norm.weight": n(W) + 1, "visual.trunk.norm.bias": n(W),
          "visual.ln_contrast.weight": n(Dc) + 1, "visual.ln_contrast.bias": n(Dc),
          "visual.proj_contrast": n(Dc, Dc),
          "visual.ln_caption.weight": n(Dcap) + 1, "visual.ln_caption.bias": n(Dcap)}
    for i in range(L):
        p = f"visual.trunk.blocks.{i}."
        st.update({p + "norm1.weight": n(W) + 1, p + "norm1.bias": n(W),
                   p + "norm2.weight": n(W) + 1, p + "norm2.bias": n(W),
                   p + "attn.qkv.weight": n(3 * W, W), p + "attn.qkv.bias": n(3 * W),
                   p + "attn.proj.weight": n(W, W), p + "attn.proj.bias": n(W),
                   p + "mlp.fc1.weight": n(4 * W, W), p + "mlp.fc1.bias": n(4 * W),
                   p + "mlp.fc2.weight": n(W, 4 * W), p + "mlp.fc2.bias": n(W)})
    for pool, d, q in (("attn_pool_contrast", Dc, 1), ("attn_pool_caption", Dcap, n_cap)):
        p = f"visual.{pool}."
        st.update({p + "query": n(q, d), p + "ln_q.weight": n(d) + 1, p + "ln_q.bias": n(d),
                   p + "ln_k.weight": n(W) + 1, p + "ln_k.bias": n(W),
                   p + "attn.in_proj_bias": n(3 * d),
                   p + "attn.out_proj.weight": n(d, d), p + "attn.out_proj.bias": n(d)})
        if pool == "attn_pool_caption" and fused_caption and d == W:
            st[p + "attn.in_proj_weight"] = n(3 * d, W)
        else:
            st.update({p + "attn.q_proj_weight": n(d, d), p + "attn.k_proj_weight": n(d, W),
                       p + "attn.v_proj_weight": n(d, W)})
    return st


@pytest.mark.parametrize("embed_dim_caption", [32, 64])
def test_checkpoint_import_trained_at_224_loaded_at_448(embed_dim_caption):
    """A 224-trained checkpoint (grid 14) into a 448-input model (grid 28):
    the port's state dict equals the bridged JAX import exactly, loads
    strictly, and its position table is JAX's resize.  At caption width 64
    (== trunk width) the caption pool's projections come fused."""
    st = _fake_conch_state(np.random.default_rng(7), grid=14, Dcap=embed_dim_caption)
    got = vt.load_conch_visual_state(st, layers=2, image_size=448, patch_size=16)
    want = state_dict_from_jax(jvt.import_conch_visual_state(st, layers=2, image_size=448,
                                                             patch_size=16))
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(), want[name].numpy(), err_msg=name)
    assert got["trunk.pos_embed"].shape == (1, 1 + 28 * 28, 64)
    model = vt.ConchVisualModel(image_size=448, **dict(SMALL, embed_dim_caption=embed_dim_caption))
    model.load_state_dict(got, strict=True)


@pytest.mark.parametrize("g_old,g_new", [(14, 28), (4, 6), (7, 3), (5, 5)])
def test_resize_pos_embed_matches_jax(g_old, g_new):
    pe = RNG.normal(size=(1, 1 + g_old * g_old, 8)).astype(np.float32)
    np.testing.assert_array_equal(vt.resize_pos_embed(pe, (g_new, g_new)),
                                  jvt.resize_pos_embed(pe, (g_new, g_new)))
