"""vlsa_tpu's flax msgpack checkpoints read by the port
(`runner/ckpt.py::load_checkpoint`).

Files written by `vlsa_tpu.runner.ckpt.save_checkpoint` from the SA
baseline's and the flagship's parameter trees, with and without
`model_saver_module_filter`, with f32, bf16 (the frozen tower's matmul
weights, the vision tower's) and int8 leaves (the w8a8 trunk's), and with
optax state, read into exactly `state_dict_from_jax` of the saved tree:
same names, dtypes and bits.  flax splits an array over 2**30 bytes into
chunks; the test writes such files with the chunk size cut to a few hundred
bytes.  The port's own torch files, the zip format and the older pickle
one, are still told apart and read by torch.  The run directories vlsa_tpu
trains are read in tests/test_torch_lifecycle.py.
"""
import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_vlsa import TOWER, flagship_cfgs
from vlsa_tpu.models import load_model as jax_load_model
from vlsa_tpu.models import vision_tower as jvt
from vlsa_tpu.models.precision import cast_frozen_tower_weights, cast_vision_tower_weights
from vlsa_tpu.models.precision import quantize_vision_tower_weights
from vlsa_tpu.models.vlsa_build import build_vlsa as jax_build_vlsa
from vlsa_tpu.runner.ckpt import _filter_tree
from vlsa_tpu.runner.ckpt import save_checkpoint as jax_save_checkpoint
from vlsa_tpu_torch.runner.ckpt import load_checkpoint
from vlsa_tpu_torch.utils.weights import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(tree):
    return jax.tree.map(np.asarray, dict(tree))


@pytest.fixture(scope="module")
def trees():
    """vlsa_tpu parameter trees: the SA baseline (ABMIL with the feature
    projecter), the small flagship (f32, and its frozen tower's matmul
    weights in bf16), and a w8a8 CONCH visual model (int8 trunk weights
    beside f32 scales, a bf16 patch embedding)."""
    _m, sa = jax_load_model("DeepMIL", [64, 32, 4], rng=jax.random.PRNGKey(0),
                            network="ABMIL", pooling="attention", use_feat_proj=True)
    text, image, prompt = flagship_cfgs(os.path.join(REPO, "vlsa_tpu", "assets"))
    _jm, flagship, _tok = jax_build_vlsa(
        vlsa_api="CONCH", text_encoder_cfg=text, image_encoder_cfg=image,
        prompt_learner_cfg=prompt, rng=jax.random.PRNGKey(1), tower_overrides=TOWER)
    kw = dict(layers=2, width=64, heads=4, embed_dim_contrast=64, embed_dim_caption=32,
              attn_pooler_heads=4, n_queries_caption=4, patch_size=16, image_size=48)
    vision = jvt.ConchVisualModel(**kw).init(jax.random.PRNGKey(2),
                                             jnp.zeros((1, 3, 48, 48)))["params"]
    w8a8 = cast_vision_tower_weights(quantize_vision_tower_weights(_np(vision)))
    return {"sa": _np(sa), "flagship": _np(flagship),
            "flagship_bf16": _np(cast_frozen_tower_weights(flagship)), "w8a8": _np(w8a8)}


def _dtypes(tree):
    return {leaf.dtype.name for leaf in jax.tree.leaves(tree)}


def _assert_same_state(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("name,module_filter", [
    ("sa", None), ("sa", "feat_proj"), ("flagship", None), ("flagship", "prompt_encoder"),
    ("flagship_bf16", None), ("flagship_bf16", "prompt_encoder"), ("w8a8", None)])
def test_reads_what_vlsa_tpu_writes(trees, tmp_path, name, module_filter):
    params = trees[name]
    path = str(tmp_path / "train_model-last.ckpt")
    jax_save_checkpoint(path, 3, params, module_filter=module_filter)
    got = load_checkpoint(path)
    assert got.keys() == {"epoch", "model"} and got["epoch"] == 3
    want = state_dict_from_jax(_filter_tree(params, module_filter))
    _assert_same_state(got["model"], want)
    if module_filter is not None:
        assert not any(module_filter in k.split(".")[0] for k in got["model"])
    expected = {"sa": {"float32"}, "flagship": {"float32"},
                "flagship_bf16": {"float32", "bfloat16"},
                "w8a8": {"float32", "bfloat16", "int8"}}[name]
    assert _dtypes(params) == expected
    if name == "w8a8":
        kinds = {t.dtype for t in got["model"].values()}
        assert kinds == {torch.float32, torch.bfloat16, torch.int8}


def test_reads_optax_state_apart_from_the_model(trees, tmp_path):
    params = trees["sa"]
    opt_state = optax.adam(1e-3).init(jax.tree.map(jnp.asarray, params))
    path = str(tmp_path / "with_opt.ckpt")
    jax_save_checkpoint(path, 2, params, opt_state=opt_state)
    got = load_checkpoint(path)
    _assert_same_state(got["model"], state_dict_from_jax(params))
    want = flax.serialization.to_state_dict(opt_state)
    flat_got = jax.tree_util.tree_leaves_with_path(got["optax_state"])
    flat_want = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, want))
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (_p, a), (_q, b) in zip(flat_got, flat_want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["flagship_bf16", "w8a8"])
def test_reads_chunked_arrays(trees, tmp_path, monkeypatch, name):
    """flax's chunked layout for arrays over MAX_CHUNK_SIZE bytes (2**30),
    here cut to 256 bytes, so most leaves, bf16 and int8 ones among them,
    are written in chunks."""
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 256)
    path = str(tmp_path / "chunked.ckpt")
    jax_save_checkpoint(path, 1, trees[name])
    with open(path, "rb") as f:
        assert b"__msgpack_chunked_array__" in f.read()
    _assert_same_state(load_checkpoint(path)["model"], state_dict_from_jax(trees[name]))


@pytest.mark.parametrize("zipfile", [True, False])
def test_torch_files_are_still_read_by_torch(tmp_path, zipfile):
    payload = {"epoch": 4, "model": {"w": torch.arange(6.0).reshape(2, 3),
                                     "b": torch.ones(3, dtype=torch.bfloat16)}}
    path = str(tmp_path / "port.ckpt")
    torch.save(payload, path, _use_new_zipfile_serialization=zipfile)
    got = load_checkpoint(path)
    assert got["epoch"] == 4
    _assert_same_state(got["model"], payload["model"])


def test_orbax_backend_is_read_as_the_msgpack_one(trees, tmp_path):
    """vlsa_tpu's orbax backend: `load_checkpoint` finds the `.orbax`
    directory where vlsa_tpu's does (from the checkpoint's path, or the
    directory's own) and gives what the msgpack file of the same tree gives
    (tests/test_torch_orbax.py holds the reader leaf for leaf)."""
    params = trees["w8a8"]
    opt_state = optax.adam(1e-3).init(jax.tree.map(jnp.asarray, params))
    paths = {b: str(tmp_path / f"{b}.ckpt") for b in ("msgpack", "orbax")}
    for backend, path in paths.items():
        jax_save_checkpoint(path, 2, params, backend=backend, opt_state=opt_state)
    assert not os.path.exists(paths["orbax"]) and os.path.isdir(paths["orbax"] + ".orbax")
    want = load_checkpoint(paths["msgpack"])
    for path in (paths["orbax"], paths["orbax"] + ".orbax"):
        got = load_checkpoint(path)
        assert got["epoch"] == want["epoch"] == 2
        _assert_same_state(got["model"], want["model"])
        assert jax.tree_util.tree_structure(got["optax_state"]) == \
            jax.tree_util.tree_structure(want["optax_state"])
