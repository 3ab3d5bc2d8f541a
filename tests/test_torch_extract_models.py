"""The rest of extraction against vlsa_tpu: the w8a8 CONCH trunk, OpenAI
CLIP's ViT and ModifiedResNet, their importers, the weight bridge, and the
extractor and its CLI with `--model clip_vit` and `--trunk_quant`.

Sizes: the quantized trunk at tests/test_int8_trunk.py's SMALL_CONCH (width
48, 4 heads, 2 layers, 64-pixel input); CLIPViT at width 64, 4 heads, 2
layers, 64-pixel input; the ModifiedResNet at layers (1, 1, 1, 1), width 16,
64-pixel input.  vlsa_tpu's init (BatchNorm statistics drawn at random) is
bridged into the port; JAX runs its CPU paths (the trunk's dense attention,
the port its plain flash version).

Tolerances (max|a-b| / max|b|):
  * the quantizers and the w8a8 linear: bit-equal on the same f32 input
    (the same operations in the same order; the s8 x s8 sums exact in int32);
  * the quantized tower: 1e-4 (f32 compute) and 2e-3 (bf16).  Its
    activations reach each linear with f32 summation-order differences, and
    one value within that distance of a rounding tie of h / s_h takes the
    neighbouring int8 level on one side: a step of s_h * s_w, up to 1/127 of
    that token's largest input to a product -- above the float tower's
    1e-5, within 1e-4 at this size (bf16: the float tower's 2e-3 reasons);
  * the quantized tower against the float one: cosine > 0.99 per row, as
    tests/test_int8_trunk.py asks of vlsa_tpu's extractor;
  * CLIPViT and the ModifiedResNet: f32 1e-5 (summation order); CLIPViT
    bf16 2e-3 (the text tower's bf16 reasons, tests/test_torch_text_tower.py);
  * the importers and the bridge: exact.
"""
import io
import json
import re
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlsa_tpu.data.extract import FeatureExtractor as JaxExtractor
from vlsa_tpu.data.extract import extract_to_store as jax_extract_to_store
from vlsa_tpu.models import vision_tower as jvt
from vlsa_tpu.models.precision import cast_vision_tower_weights as jax_cast
from vlsa_tpu.models.precision import quantize_rows as jax_quantize_rows
from vlsa_tpu.models.precision import quantize_vision_tower_weights as jax_quantize
from vlsa_tpu_torch.data.bags import read_patch_data
from vlsa_tpu_torch.data.extract import FeatureExtractor, extract_to_store
from vlsa_tpu_torch.models import vision_tower as vt
from vlsa_tpu_torch.models.precision import (cast_vision_tower_weights, quantize_rows,
                                             quantize_vision_tower_weights)
from vlsa_tpu_torch.runner import extract as extract_cli
from vlsa_tpu_torch.utils.torch_import import load_torch_state_dict
from vlsa_tpu_torch.utils.weights import jax_tree_from_state_dict, state_dict_from_jax

SMALL_CONCH = dict(layers=2, width=48, heads=4, embed_dim_contrast=64, embed_dim_caption=32,
                   attn_pooler_heads=4, n_queries_caption=4, patch_size=16)
SMALL_VIT = dict(width=64, heads=4, layers=2, output_dim=32, patch_size=16)
SMALL_RN = dict(layers=(1, 1, 1, 1), width=16, heads=4, output_dim=32)
IMAGE = 64
TOL = {"float32": 1e-5, "bfloat16": 2e-3}
TOL_Q8 = {"float32": 1e-4, "bfloat16": 2e-3}
RNG = np.random.default_rng(21)
IMAGES = RNG.normal(size=(3, 3, IMAGE, IMAGE)).astype(np.float32)
TILES = RNG.integers(0, 256, size=(5, 70, 70, 3), dtype=np.uint8)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _init(model, seed=0):
    return _np(model.init(jax.random.PRNGKey(seed),
                          jnp.zeros((1, 3, IMAGE, IMAGE), jnp.float32))["params"])


def _conch(**kw):
    return jvt.ConchVisualModel(image_size=IMAGE, **SMALL_CONCH, **kw)


def _vit(**kw):
    return jvt.CLIPViT(input_resolution=IMAGE, **SMALL_VIT, **kw)


def _resnet():
    return jvt.CLIPModifiedResNet(input_resolution=IMAGE, **SMALL_RN)


def _resnet_params():
    """vlsa_tpu's ModifiedResNet init with every BatchNorm's statistics and
    affine drawn at random (its init makes each BatchNorm the identity)."""
    rng = np.random.default_rng(3)

    def draw(path, leaf):
        name = path[-1].key
        if name == "running_var":
            return rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
        if name in ("running_mean", "bias") or (name == "weight" and leaf.ndim == 1):
            return rng.normal(0.0, 0.3 if name != "weight" else 1.0,
                              leaf.shape).astype(np.float32)
        return leaf
    return jax.tree_util.tree_map_with_path(draw, _init(_resnet()))


def _port(model, params):
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model.eval()


def _run(model, images=IMAGES, **kw):
    with torch.no_grad():
        return model(torch.from_numpy(images), **kw).numpy()


def _port_conch(params, dtype="float32", quantized=True):
    return _port(vt.ConchVisualModel(image_size=IMAGE, compute_dtype=dtype,
                                     trunk_quantized=quantized, **SMALL_CONCH), params)


def _features(model, images=IMAGES):
    with torch.no_grad():
        return model.forward_no_head(torch.from_numpy(images)).numpy()


# ---------------------------------------------------------------------------
# the quantizers and the w8a8 linear: bit-equal
# ---------------------------------------------------------------------------

def test_quantize_rows_bit_equal():
    w = RNG.normal(size=(16, 64)).astype(np.float32) \
        * RNG.uniform(0.1, 10.0, size=(16, 1)).astype(np.float32)
    # rows whose scale is exactly 1, with ties at x.5 (to even, both ways)
    w[0] = np.linspace(-127, 127, 64).round()
    w[0, 1:7] = [2.5, 3.5, -2.5, -3.5, 0.5, -0.5]
    w[1] = 0.0  # an all-zero row: scale 1e-30 / 127
    q, s = quantize_rows(torch.from_numpy(w))
    jq, js = jax_quantize_rows(w)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q[0, 1:7].tolist() == [2, 4, -2, -4, 0, 0]


def test_quantize_vision_tower_weights_bit_equal():
    params = _init(_conch())
    want = state_dict_from_jax(_np(jax_quantize(params)))
    got = quantize_vision_tower_weights(state_dict_from_jax(params))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        assert torch.equal(got[k], v), k
    blk = got["trunk.block_0.qkv_weight"]
    assert blk.dtype == torch.int8 and got["trunk.block_0.qkv_weight_scale"].shape == (144,)
    assert got["trunk.patch_embed_weight"].dtype == torch.float32
    with pytest.raises(ValueError, match="ConchVisualModel"):
        quantize_vision_tower_weights({"resblocks.0.c_fc_weight": torch.zeros(2, 2)})


@pytest.mark.parametrize("shape", [(2, 37, 64), (1, 5, 64), (4, 4, 64)])
def test_int8_dynamic_linear_bit_equal(shape):
    """Per-token scales, a row of zeros, and fewer than 17 rows (the card's
    torch._int_mm takes more than 16: the rows are padded)."""
    h = (RNG.normal(size=shape) * 3.0).astype(np.float32)
    h.reshape(-1, 64)[0] = 0.0
    w = RNG.normal(size=(48, 64)).astype(np.float32)
    jq, js = jax_quantize_rows(w)
    want = np.asarray(jvt._int8_dynamic_linear(jnp.asarray(h), jq, js))
    got = vt.int8_dynamic_linear(torch.from_numpy(h), torch.from_numpy(np.array(jq)),
                                 torch.from_numpy(np.array(js)))
    assert got.dtype == torch.float32 and got.shape == shape[:-1] + (48,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_int8_product_sums_exactly_in_int32():
    """tests/test_int8_trunk.py's fc2-shaped worst case: K=3072, same-sign
    operands, sums past f32's 2^24."""
    x = RNG.integers(64, 128, size=(64, 3072), dtype=np.int8)
    w = RNG.integers(64, 128, size=(48, 3072), dtype=np.int8)
    got = torch._int_mm(torch.from_numpy(x), torch.from_numpy(w).T)
    want = x.astype(np.int64) @ w.astype(np.int64).T
    assert int(np.abs(want).max()) > 2 ** 24
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))


# ---------------------------------------------------------------------------
# the w8a8 trunk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_tower_matches_jax(dtype):
    qparams = jax_quantize(_init(_conch()))
    if dtype == "bfloat16":
        qparams = jax_cast(qparams)
    qparams = _np(qparams)
    want = np.asarray(_conch(compute_dtype=dtype, trunk_quantized=True).apply(
        {"params": qparams}, jnp.asarray(IMAGES), method=jvt.ConchVisualModel.forward_no_head))
    model = _port_conch(qparams, dtype)
    if dtype == "bfloat16":
        cast_vision_tower_weights(model)  # the values are vlsa_tpu's cast ones already
        assert model.trunk.patch_embed_weight.dtype == torch.bfloat16
    blk = model.trunk.block_0
    assert blk.quantized and blk.fc2_weight.dtype == torch.int8
    assert blk.fc2_weight_scale.dtype == torch.float32
    assert _rel(_features(model), want) <= TOL_Q8[dtype]


def test_cast_leaves_the_int8_trunk_alone():
    sd = quantize_vision_tower_weights(state_dict_from_jax(_init(_conch())))
    model = vt.ConchVisualModel(image_size=IMAGE, trunk_quantized=True, **SMALL_CONCH)
    model.load_state_dict(sd, strict=True)
    cast_vision_tower_weights(model)
    want = state_dict_from_jax(_np(jax_cast(jax_quantize(_init(_conch())))))
    for k, v in model.state_dict().items():
        assert v.dtype == want[k].dtype and torch.equal(v, want[k]), k


def test_quantized_tower_close_to_float_twin():
    params = _init(_conch())
    fm = _port_conch(params, quantized=False)
    qm = vt.ConchVisualModel(image_size=IMAGE, trunk_quantized=True, **SMALL_CONCH)
    qm.load_state_dict(quantize_vision_tower_weights(fm.state_dict()), strict=True)
    ref, got = _features(fm), _features(qm.eval())
    cos = (got * ref).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(ref, axis=-1))
    assert cos.min() > 0.99, cos


# ---------------------------------------------------------------------------
# CLIPViT and the ModifiedResNet
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_vit_matches_jax(dtype):
    params = _init(_vit())
    if dtype == "bfloat16":
        params = _np(jax_cast(params))
        assert params["resblock_0"]["c_fc_weight"].dtype == jnp.bfloat16
    want = np.asarray(_vit(compute_dtype=dtype).apply({"params": params}, jnp.asarray(IMAGES)))
    model = _port(vt.CLIPViT(input_resolution=IMAGE, compute_dtype=dtype, **SMALL_VIT), params)
    if dtype == "bfloat16":
        # the port's cast of the f32 weights gives vlsa_tpu's cast values,
        # in the same tensors
        cast_vision_tower_weights(model)
        fresh = cast_vision_tower_weights(_port(
            vt.CLIPViT(input_resolution=IMAGE, compute_dtype=dtype, **SMALL_VIT), _init(_vit())))
        _assert_same_state(fresh.state_dict(), model.state_dict())
        assert model.resblocks[0].c_fc_weight.dtype == torch.bfloat16
        assert model.conv1_weight.dtype == torch.float32
    got = _run(model)
    assert got.shape == (3, SMALL_VIT["output_dim"])
    assert _rel(got, want) <= TOL[dtype]


def test_modified_resnet_matches_jax():
    params = _resnet_params()
    want = np.asarray(_resnet().apply({"params": params}, jnp.asarray(IMAGES)))
    model = _port(vt.CLIPModifiedResNet(input_resolution=IMAGE, **SMALL_RN), params)
    assert model.layer2_0.downsample and model.layer1_0.downsample
    got = _run(model)
    assert got.shape == (3, SMALL_RN["output_dim"])
    assert _rel(got, want) <= TOL["float32"]


# ---------------------------------------------------------------------------
# importers (synthetic OpenAI-layout checkpoints)
# ---------------------------------------------------------------------------

def _openai_vit_state(rng, grid, D=64, layers=2, out=32, P=16):
    r = lambda *s: rng.normal(size=s).astype(np.float32)
    st = {"conv1.weight": r(D, 3, P, P), "class_embedding": r(D),
          "positional_embedding": r(grid * grid + 1, D), "proj": r(D, out),
          "ln_pre.weight": r(D), "ln_pre.bias": r(D), "ln_post.weight": r(D),
          "ln_post.bias": r(D)}
    for i in range(layers):
        rb = f"transformer.resblocks.{i}."
        st.update({rb + "ln_1.weight": r(D), rb + "ln_1.bias": r(D), rb + "ln_2.weight": r(D),
                   rb + "ln_2.bias": r(D), rb + "attn.in_proj_weight": r(3 * D, D) * 0.1,
                   rb + "attn.in_proj_bias": r(3 * D), rb + "attn.out_proj.weight": r(D, D) * 0.1,
                   rb + "attn.out_proj.bias": r(D), rb + "mlp.c_fc.weight": r(4 * D, D) * 0.1,
                   rb + "mlp.c_fc.bias": r(4 * D), rb + "mlp.c_proj.weight": r(D, 4 * D) * 0.1,
                   rb + "mlp.c_proj.bias": r(D)})
    return {"visual." + k: v for k, v in st.items()}


def _openai_name(ours: str) -> str:
    """The port's ModifiedResNet name -> OpenAI CLIP's."""
    name = re.sub(r"^layer(\d)_(\d+)\.", r"layer\1.\2.", ours)
    name = name.replace("downsample_conv_weight", "downsample.0.weight")
    name = name.replace("downsample_bn.", "downsample.1.")
    return re.sub(r"(conv\d|[qkvc]_proj)_(weight|bias)$", r"\1.\2", name)


def _openai_resnet_state(rng):
    model = vt.CLIPModifiedResNet(input_resolution=IMAGE, **SMALL_RN)
    st = {}
    for k, v in model.state_dict().items():
        arr = rng.normal(size=tuple(v.shape)).astype(np.float32)
        if k.endswith("running_var"):
            arr = np.abs(arr) + 0.5
        st["visual." + _openai_name(k)] = arr
        if k.endswith("running_mean"):
            st["visual." + _openai_name(k).replace("running_mean", "num_batches_tracked")] = \
                np.array(7, np.int64)
    return st


def _save(tmp_path, st, name):
    path = str(tmp_path / name)
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in st.items()}, path)
    return load_torch_state_dict(path)


def _assert_same_state(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_clip_vit_importer_matches_jax(tmp_path):
    """A checkpoint trained at grid 2 (32 px), loaded at 64 px (grid 4):
    the positional table resized as vlsa_tpu resizes it; the model's output
    equal to vlsa_tpu's on it."""
    st = _save(tmp_path, _openai_vit_state(np.random.default_rng(1), grid=2), "clip.pt")
    params = jvt.import_clip_vit_state(st, layers=2, image_size=IMAGE, patch_size=16)
    got = vt.load_clip_vit_state(st, layers=2, image_size=IMAGE, patch_size=16)
    assert got["positional_embedding"].shape == (17, 64)
    _assert_same_state(got, state_dict_from_jax(params))
    model = vt.CLIPViT(input_resolution=IMAGE, **SMALL_VIT)
    model.load_state_dict(got, strict=True)
    ref = _vit().apply({"params": params}, jnp.asarray(IMAGES))
    assert _rel(_run(model.eval()), ref) <= TOL["float32"]


def test_clip_vit_importer_resizes_pos_embed():
    """tests/test_extract.py's case: a grid-4 table (32 px, patch 8) into a
    48-px model (grid 6), and verbatim at a matching grid."""
    D, P = 16, 8
    ones = np.ones(D, np.float32)
    st = {"conv1.weight": RNG.normal(size=(D, 3, P, P)).astype(np.float32),
          "class_embedding": RNG.normal(size=(D,)).astype(np.float32),
          "positional_embedding": RNG.normal(size=(17, D)).astype(np.float32),
          "ln_pre.weight": ones, "ln_pre.bias": ones, "ln_post.weight": ones,
          "ln_post.bias": ones, "proj": RNG.normal(size=(D, 8)).astype(np.float32)}
    out = vt.load_clip_vit_state(st, layers=0, prefix="", image_size=48, patch_size=P)
    want = jvt.import_clip_vit_state(st, layers=0, prefix="", image_size=48, patch_size=P)
    assert out["positional_embedding"].shape == (37, D)
    np.testing.assert_array_equal(out["positional_embedding"].numpy(),
                                  want["positional_embedding"])
    same = vt.load_clip_vit_state(st, layers=0, prefix="", image_size=32, patch_size=P)
    np.testing.assert_array_equal(same["positional_embedding"].numpy(),
                                  st["positional_embedding"])


def test_clip_resnet_importer_matches_jax(tmp_path):
    """An OpenAI-layout ModifiedResNet checkpoint (BatchNorm's
    num_batches_tracked included, downsample branches in every stage):
    the same state as vlsa_tpu's importer gives, and its output."""
    st = _save(tmp_path, _openai_resnet_state(np.random.default_rng(2)), "rn.pt")
    params = jvt.import_clip_resnet_state(st, layers=SMALL_RN["layers"])
    got = vt.load_clip_resnet_state(st, layers=SMALL_RN["layers"])
    _assert_same_state(got, state_dict_from_jax(params))
    assert "layer1_0.downsample_bn.running_var" in got
    model = vt.CLIPModifiedResNet(input_resolution=IMAGE, **SMALL_RN)
    model.load_state_dict(got, strict=True)
    want = _resnet().apply({"params": params}, jnp.asarray(IMAGES))
    assert _rel(_run(model.eval()), want) <= TOL["float32"]


# ---------------------------------------------------------------------------
# the weight bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["clip_vit", "resnet", "conch_w8a8"])
def test_bridge_round_trip(which):
    """vlsa_tpu's tree -> the port's state dict -> loaded strict -> back:
    the same tree, leaf for leaf and type for type (BatchNorm's `weight`,
    CLIPViT's 2-D `proj`, the int8 linears and their scales)."""
    if which == "clip_vit":
        params, model = _init(_vit()), vt.CLIPViT(input_resolution=IMAGE, **SMALL_VIT)
    elif which == "resnet":
        params = _resnet_params()
        model = vt.CLIPModifiedResNet(input_resolution=IMAGE, **SMALL_RN)
    else:
        params = _np(jax_quantize(_init(_conch())))
        model = vt.ConchVisualModel(image_size=IMAGE, trunk_quantized=True, **SMALL_CONCH)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    back = jax_tree_from_state_dict(model.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(params), jax.tree.leaves(back)):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    if which == "resnet":
        assert "weight" in back["bn1"] and "weight" in back["layer1_0"]["downsample_bn"]


# ---------------------------------------------------------------------------
# the extractor and the CLI
# ---------------------------------------------------------------------------

def _extractors(**kw):
    jex = JaxExtractor(image_size=IMAGE, batch_size=2, **kw)
    ex = FeatureExtractor(image_size=IMAGE, batch_size=2, device="cpu", **kw)
    ex.model.load_state_dict(state_dict_from_jax(_np(jex._params)), strict=True)
    return jex, ex


@pytest.mark.parametrize("which", ["clip_vit", "trunk_quant"])
def test_extract_to_store_matches_jax(tmp_path, which):
    """Both packages' extract_to_store over the same two slides, f32, the
    JAX extractor's weights bridged into the port's."""
    if which == "clip_vit":
        kw = dict(model_name="clip_vit", model_overrides=SMALL_VIT)
    else:
        kw = dict(trunk_quant=True, model_overrides=SMALL_CONCH)
    jex, ex = _extractors(compute_dtype="float32", **kw)
    assert ex.feat_dim == jex.feat_dim == (32 if which == "clip_vit" else 64)
    src = tmp_path / "tiles"
    src.mkdir()
    np.save(src / "s0.npy", TILES)
    np.save(src / "s1.npy", TILES[:3])
    jax_extract_to_store(str(src), str(tmp_path / "jax"), jex, verbose=False)
    stats = extract_to_store(str(src), str(tmp_path / "port"), ex, verbose=False)
    assert stats["slides"] == 2 and stats["tiles"] == 8
    tol = TOL["float32"] if which == "clip_vit" else TOL_Q8["float32"]
    for sid in ("s0", "s1"):
        got = read_patch_data(str(tmp_path / "port" / f"{sid}.npy"))
        want = np.load(tmp_path / "jax" / f"{sid}.npy")
        assert got.shape == want.shape and _rel(got, want) <= tol


def test_trunk_quant_quantizes_the_seeded_float_model():
    """Random weights: the float model of the seed, then quantized (the
    quantized module's own init is never used), then the bf16 cast."""
    kw = dict(image_size=IMAGE, batch_size=2, seed=4, model_overrides=SMALL_CONCH, device="cpu")
    want = quantize_vision_tower_weights(
        FeatureExtractor(compute_dtype="float32", **kw).model.state_dict())
    got = FeatureExtractor(compute_dtype="float32", trunk_quant=True, **kw).model.state_dict()
    _assert_same_state(got, want)
    q16 = FeatureExtractor(trunk_quant=True, **kw)
    assert q16.trunk_quant and q16.model.trunk.block_1.qkv_weight.dtype == torch.int8
    assert q16.model.trunk.patch_embed_weight.dtype == torch.bfloat16
    f = FeatureExtractor(**kw).extract(TILES)
    g = q16.extract(TILES)
    cos = (f * g).sum(-1) / (np.linalg.norm(f, axis=-1) * np.linalg.norm(g, axis=-1))
    assert cos.min() > 0.99, cos


def test_refusals(monkeypatch):
    with pytest.raises(ValueError, match="only supported for the CONCH trunk"):
        FeatureExtractor(model_name="clip_vit", trunk_quant=True, device="cpu")
    with pytest.raises(ValueError, match="unknown extractor model"):
        FeatureExtractor(model_name="rn50", device="cpu")
    import vlsa_tpu_torch.data.extract as extract_mod
    with monkeypatch.context() as m:  # one card, before any is touched
        m.setattr(extract_mod, "resolve_device", lambda device: torch.device("cuda"))
        m.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(ValueError, match="requested 2 devices, have 1"):
            extract_cli.main(["--synthetic", "1", "--num_devices", "2", "--out", "unused"])
    with pytest.raises(ValueError, match="batch_size 3 not divisible by num_devices 2"):
        extract_cli.main(["--synthetic", "1", "--num_devices", "2", "--batch", "3",
                          "--out", "unused", "--device", "cpu"])


@pytest.mark.parametrize("args", [["--model", "clip_vit"], ["--trunk_quant"]])
def test_cli_on_the_cpu(tmp_path, args):
    """Full width (CLIP ViT-B/16; CONCH with the w8a8 trunk) at a 32-pixel
    input: 2 synthetic slides of 3 tiles, f32 and bf16."""
    for dtype in ("float32", "bfloat16"):
        buf = io.StringIO()
        out = tmp_path / dtype
        with redirect_stdout(buf):
            stats = extract_cli.main(args + [
                "--synthetic", "2", "--synthetic_tiles", "3", "--image_size", "32", "--batch",
                "2", "--dtype", dtype, "--out", str(out), "--device", "cpu"])
        assert json.loads(buf.getvalue().splitlines()[-1]) == stats
        assert stats["model"] == ("clip_vit" if "clip_vit" in args else "conch")
        assert stats["trunk_quant"] == ("--trunk_quant" in args)
        assert stats["slides"] == 2 and stats["tiles"] == 6 and stats["feat_dim"] == 512
        assert stats["flash_launches"] == {"f32": 0, "bf16": 0}
        for i in range(2):
            feats = read_patch_data(str(out / f"synthetic_{i}.npy"))
            assert feats.shape == (3, 512) and np.isfinite(feats).all()
