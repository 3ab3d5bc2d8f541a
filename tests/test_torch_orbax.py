"""vlsa_tpu's orbax checkpoints read by the port without orbax, TensorStore
or a zstd module (`runner/orbax.py::read_orbax_checkpoint`,
`runner/ckpt.py::load_checkpoint`).

Directories written by `vlsa_tpu.runner.ckpt.save_checkpoint(...,
backend="orbax")` (orbax's PyTreeCheckpointer: an OCDBT store of zarr v2
arrays, each chunk zstd-compressed) read into exactly the tree vlsa_tpu's
`load_checkpoint` restores (orbax through TensorStore): the same keys,
the same dtypes (bfloat16 as torch.bfloat16 bits), the same values bit
for bit, optax's MaskedNodes as empty dicts, the epoch a Python int.
Trees: the SA baseline, the small flagship in f32 and with its frozen
tower's matmul weights in bf16, a w8a8 CONCH visual model (int8 and
bf16), each with and without the module filter, and optax state with
masked leaves.

Structures orbax writes only at sizes a test cannot write in seconds are
written by TensorStore directly: a b-tree of more than one node (orbax
keeps its nodes up to 100 MB decoded, `max_decoded_node_bytes`: here the
store's config is cut to 400 bytes, which gives interior nodes at two
levels), values out of line in data files (here past 16 bytes), and zarr
arrays of several chunks, ragged edge chunks and a chunk left out for its
fill value (orbax writes each leaf as one chunk here, 16 MiB included, as
the test of vlsa_tpu's own writer shows).

The committed fixtures (`vlsa_tpu_torch/assets/checkpoints/`, made by
`make_fixtures` below from a seed: a small SA DeepMIL/ABMIL run's last
checkpoint with Adam's state after three steps, with each backend, and a
tree of a bf16, an int8 and an f32 leaf) read as freshly written ones do,
and both backends give the same state dict and optimizer state.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_ckpt_msgpack import trees  # noqa: F401  (the fixture)
from vlsa_tpu.models import load_model as jax_load_model
from vlsa_tpu.optim import create_optimizer as jax_create_optimizer
from vlsa_tpu.optim.factory import frozen_mask_from_cfg as jax_frozen_mask
from vlsa_tpu.runner.ckpt import _filter_tree
from vlsa_tpu.runner.ckpt import load_checkpoint as jax_load_checkpoint
from vlsa_tpu.runner.ckpt import save_checkpoint as jax_save_checkpoint
from vlsa_tpu_torch.runner.ckpt import load_checkpoint, read_flax_checkpoint
from vlsa_tpu_torch.runner.orbax import read_ocdbt, read_orbax_checkpoint
from vlsa_tpu_torch.utils.weights import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "vlsa_tpu_torch", "assets", "checkpoints")
# the fixture SA run: DeepMIL/ABMIL 64-32-12 (TCGA-BLCA fold 0's 12 bins, so
# that the card resumes it on that fold), Adam (lr 1e-3, weight decay 1e-5,
# no frozen leaf) after FIXTURE_STEPS steps, saved at epoch 1
FIXTURE_DIMS = (64, 32, 12)
FIXTURE_STEPS = 3
FIXTURE_SEED = 24
FIXTURE_FILES = {"sa_msgpack": "sa_msgpack/train_model-last.ckpt",
                 "sa_orbax": "sa_orbax/train_model-last.ckpt",
                 "mixed_msgpack": "mixed_msgpack.ckpt", "mixed_orbax": "mixed_orbax.ckpt"}


def make_fixtures(dest: str) -> None:
    """The committed checkpoints, written by vlsa_tpu's `save_checkpoint`:
    the SA run's (parameters of vlsa_tpu's DeepMIL/ABMIL tree, values from
    numpy; Adam as vlsa_tpu's runner builds it, FIXTURE_STEPS steps on numpy
    gradients) with the msgpack and the orbax backend, and a tree of a
    bf16, an int8 and an f32 leaf with both."""
    rng = np.random.default_rng(FIXTURE_SEED)
    _m, shapes = jax_load_model("DeepMIL", list(FIXTURE_DIMS), rng=jax.random.PRNGKey(0),
                                network="ABMIL", pooling="attention", use_feat_proj=False)
    params = jax.tree.map(
        lambda v: jnp.asarray((rng.normal(size=np.shape(v)) * 0.1).astype(np.float32)),
        dict(shapes))
    tx = jax_create_optimizer("adam", 1e-3, 1e-5, params,
                              frozen=jax_frozen_mask(params, []))
    state = tx.init(params)
    for _ in range(FIXTURE_STEPS):
        grads = jax.tree.map(lambda v: jnp.asarray(rng.normal(size=v.shape).astype(np.float32)),
                             params)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
    for backend in ("msgpack", "orbax"):
        path = os.path.join(dest, FIXTURE_FILES[f"sa_{backend}"])
        os.makedirs(os.path.dirname(path), exist_ok=True)
        jax_save_checkpoint(path, 1, params, backend=backend, opt_state=state)
    mixed = {"tower": {"kernel": jnp.asarray(rng.normal(size=(8, 24)), jnp.bfloat16)},
             "trunk": {"weight": rng.integers(-127, 128, size=(16, 8)).astype(np.int8),
                       "weight_scale": rng.random(size=(16,)).astype(np.float32)}}
    for backend in ("msgpack", "orbax"):
        jax_save_checkpoint(os.path.join(dest, FIXTURE_FILES[f"mixed_{backend}"]), 0, mixed,
                            backend=backend)


# ---------------------------------------------------------------- helpers

def assert_same_tree(got, want, path=""):
    """The port's tree equals vlsa_tpu's leaf for leaf and dtype for dtype."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), (path, got, want)
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (int, float)):
        assert type(got) is type(want) and got == want, (path, got, want)
    else:
        want = np.asarray(want)
        if want.dtype.name == "bfloat16":
            assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, path
            assert tuple(got.shape) == want.shape, path
            np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16),
                                          err_msg=path)
        else:
            assert isinstance(got, np.ndarray) and got.dtype == want.dtype, (path, got.dtype)
            assert got.shape == want.shape, path
            np.testing.assert_array_equal(got, want, err_msg=path)


def _orbax(tmp_path, name, tree, **kw):
    path = str(tmp_path / name)
    jax_save_checkpoint(path, 3, tree, backend="orbax", **kw)
    return path


# ---------------------------------------------------------------- vlsa_tpu's writer

@pytest.mark.parametrize("name,module_filter", [
    ("sa", None), ("flagship", None), ("flagship", "prompt_encoder"), ("flagship_bf16", None),
    ("flagship_bf16", "prompt_encoder"), ("w8a8", None)])
def test_reads_what_vlsa_tpu_writes(trees, tmp_path, name, module_filter):  # noqa: F811
    path = _orbax(tmp_path, "train_model-last.ckpt", trees[name], module_filter=module_filter)
    want = jax_load_checkpoint(path)
    assert_same_tree(read_orbax_checkpoint(path + ".orbax"), want)
    got = load_checkpoint(path)  # the port's reader takes the path vlsa_tpu's does
    assert got["epoch"] == 3 and type(got["epoch"]) is int
    model = state_dict_from_jax(_filter_tree(trees[name], module_filter))
    assert got["model"].keys() == model.keys()
    for k, v in model.items():
        assert got["model"][k].dtype == v.dtype and torch.equal(got["model"][k], v), k
    assert load_checkpoint(path + ".orbax")["model"].keys() == model.keys()


def test_reads_optax_state_with_masked_leaves(trees, tmp_path):  # noqa: F811
    """Adam under vlsa_tpu's frozen mask: the frozen leaves' moments are
    MaskedNodes, restored as empty dicts, as are the stateless transforms'."""
    params = jax.tree.map(jnp.asarray, trees["flagship"])
    frozen = jax_frozen_mask(params, ["prompt_encoder"])
    tx = jax_create_optimizer("adam", 1e-3, 1e-5, params, frozen=frozen)
    state = tx.init(params)
    updates, state = tx.update(jax.tree.map(jnp.ones_like, params), state, params)
    path = _orbax(tmp_path, "opt.ckpt", trees["flagship"], opt_state=state,
                  module_filter="prompt_encoder")
    want = jax_load_checkpoint(path)
    got = read_orbax_checkpoint(path + ".orbax")
    assert_same_tree(got, want)
    mu = got["optimizer"]["inner_state"]["inner_states"]["train"]["inner_state"]["1"]["mu"]
    assert all(v == {} for v in jax.tree_util.tree_leaves(
        mu["prompt_encoder"], is_leaf=lambda x: x == {}))
    assert got["optimizer"]["inner_state"]["inner_states"]["frozen"] == {"inner_state": {}}
    assert load_checkpoint(path)["optax_state"].keys() == want["optimizer"].keys()


def test_orbax_writes_one_chunk_and_one_node_at_the_sizes_here(tmp_path):
    """vlsa_tpu's writer keeps a 16 MiB leaf in one chunk and 300 leaves in
    one b-tree node (orbax's defaults): the multi-node and multi-chunk
    structures are tested on stores TensorStore writes below.  A value past
    1024 bytes lies out of line in a data file of `ocdbt.process_0/`."""
    import tensorstore as ts
    rng = np.random.default_rng(0)
    tree = {"big": rng.standard_normal((2048, 2048)).astype(np.float32)}
    tree.update({f"k{i:03d}": np.full((2,), i, np.float32) for i in range(300)})
    path = _orbax(tmp_path, "big.ckpt", tree)
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}.orbax/"}).result()
    meta = json.loads(kv.read(b"model.big/.zarray").result().value)
    assert meta["chunks"] == meta["shape"] == [2048, 2048]
    assert [k for k in kv.list().result() if k.startswith(b"model.big/")] == \
        [b"model.big/.zarray", b"model.big/0.0"]
    nodes = [f for f in os.listdir(path + ".orbax/d")]
    assert len(nodes) == 1  # the root b-tree node, one leaf node
    got = read_orbax_checkpoint(path + ".orbax")
    np.testing.assert_array_equal(got["model"]["big"], tree["big"])
    assert got["model"]["k299"][0] == 299


def test_reads_the_process_stores_without_the_root_manifest(trees, tmp_path):  # noqa: F811
    """orbax writes each process's store under `ocdbt.process_<i>/` and
    then the root manifest over them; without the root manifest the
    process stores give the same keys and values."""
    import shutil
    path = _orbax(tmp_path, "p.ckpt", trees["w8a8"]) + ".orbax"
    want = read_ocdbt(path)
    cut = str(tmp_path / "cut.orbax")
    shutil.copytree(path, cut)
    os.remove(os.path.join(cut, "manifest.ocdbt"))
    assert read_ocdbt(cut) == want
    assert_same_tree(read_orbax_checkpoint(cut), jax_load_checkpoint(path[:-len(".orbax")]))


# ---------------------------------------------------------------- TensorStore's writer

def _ts_store(root, **config):
    import tensorstore as ts
    return ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/",
                            "config": config}).result()


def test_reads_a_btree_of_several_nodes(tmp_path):
    """60 keys in nodes of at most 400 bytes: a root of height 2 over
    interior and leaf nodes, keys stored relative to each subtree's common
    prefix, values inline up to 16 bytes and out of line past them."""
    import tensorstore as ts
    root = str(tmp_path / "store")
    kv = _ts_store(root, max_decoded_node_bytes=400, max_inline_value_bytes=16)
    want = {f"key{i:03d}/x": (b"v%03d" % i) * (1 + i % 7) for i in range(60)}
    with ts.Transaction() as txn:
        for k, v in want.items():
            kv.with_transaction(txn).write(k.encode(), v).result()
    man = open(os.path.join(root, "manifest.ocdbt"), "rb").read()
    from vlsa_tpu_torch.runner.orbax import _MANIFEST_MAGIC, _Reader, _Store, _body
    store = _Store(root)
    assert store.root is not None and store.root[3] >= 2, store.root  # the root's height
    _Reader(_body(man, _MANIFEST_MAGIC, "manifest"), "manifest")
    assert read_ocdbt(root) == want


def test_reads_zarr_arrays_of_several_chunks(tmp_path):
    """zarr v2 arrays on an OCDBT store as orbax lays them out, with chunks
    smaller than the array (ragged at the edges), one chunk missing (read
    as the fill value: zeros where it is null), a 0-d array and every dtype
    vlsa_tpu's trees hold."""
    import tensorstore as ts
    root = str(tmp_path / "ckpt.orbax")
    rng = np.random.default_rng(3)
    arrays = {"a.f32": rng.standard_normal((37, 21)).astype(np.float32),
              "a.i8": rng.integers(-127, 128, size=(10, 9, 4)).astype(np.int8),
              "a.i4": rng.integers(-9, 9, size=(33,)).astype(np.int32),
              "a.bf16": jnp.asarray(rng.standard_normal((17, 6)), jnp.bfloat16),
              "a.scalar": np.asarray(7, np.int64),
              "a.sparse": np.zeros((64,), np.float32)}
    arrays["a.sparse"][50:] = 1.0
    chunks = {"a.f32": [8, 5], "a.i8": [3, 4, 4], "a.i4": [10], "a.bf16": [5, 6],
              "a.scalar": [], "a.sparse": [16]}
    meta = {"tree_metadata": {}, "use_ocdbt": True, "use_zarr3": False}
    for name, arr in arrays.items():
        arr = np.asarray(arr)
        spec = {"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{root}/",
                                              "path": name + "/"},
                "metadata": {"shape": list(arr.shape), "chunks": chunks[name],
                             "dtype": "bfloat16" if arr.dtype.name == "bfloat16" else arr.dtype.str,
                             "compressor": {"id": "zstd", "level": 1},
                             "dimension_separator": "."},
                "create": True, "delete_existing": True}
        t = ts.open(spec).result()
        if name == "a.sparse":
            t[48:].write(arr[48:]).result()  # chunks 0-1 never written, chunk 2 partly
        else:
            t.write(arr).result()
        key = name.split(".")
        meta["tree_metadata"][str(tuple(key))] = {
            "key_metadata": [{"key": k, "key_type": 2} for k in key],
            "value_metadata": {"value_type": "scalar" if name == "a.scalar" else "np.ndarray",
                               "skip_deserialize": False}}
    with open(os.path.join(root, "_METADATA"), "w") as f:
        json.dump(meta, f)
    kv = read_ocdbt(root)
    assert "a.f32/4.4" in kv and "a.sparse/0" not in kv  # several chunks; one left out
    got = read_orbax_checkpoint(root)["a"]
    for name, arr in arrays.items():
        leaf = name.split(".")[1]
        if leaf == "scalar":
            assert got[leaf] == 7 and type(got[leaf]) is int
        else:
            assert_same_tree(got[leaf], np.asarray(arr), leaf)


@pytest.mark.parametrize("damage", ["crc", "magic", "length"])
def test_a_damaged_store_raises(tmp_path, trees, damage):  # noqa: F811
    path = _orbax(tmp_path, "d.ckpt", trees["sa"]) + ".orbax"
    man = os.path.join(path, "manifest.ocdbt")
    blob = bytearray(open(man, "rb").read())
    if damage == "crc":
        blob[-1] ^= 1
    elif damage == "magic":
        blob[0] ^= 1
    else:
        blob[4] ^= 1
    open(man, "wb").write(bytes(blob))
    with pytest.raises(ValueError):
        read_orbax_checkpoint(path)


# ---------------------------------------------------------------- the fixtures

@pytest.fixture(scope="module")
def fresh(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fixtures"))
    make_fixtures(root)
    return root


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("name", sorted(FIXTURE_FILES))
def test_committed_fixtures_read_as_fresh_ones(fresh, name):
    """Each committed fixture reads as a freshly written one: the same keys,
    dtypes and shapes, ints and the bf16 and int8 leaves equal, floats
    within 1e-6 relative (vlsa_tpu's Adam steps run in XLA, whose f32
    arithmetic may contract differently on another host)."""
    read = read_orbax_checkpoint if name.endswith("orbax") else read_flax_checkpoint
    suffix = ".orbax" if name.endswith("orbax") else ""
    got = dict(_flat(read(os.path.join(FIXTURES, FIXTURE_FILES[name]) + suffix)))
    want = dict(_flat(read(os.path.join(fresh, FIXTURE_FILES[name]) + suffix)))
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if isinstance(w, torch.Tensor) or isinstance(w, int) or np.asarray(w).dtype.kind in "iu":
            assert type(g) is type(w), k
            assert (torch.equal(g, w) if isinstance(w, torch.Tensor) else np.array_equal(g, w)), k
        else:
            assert g.dtype == w.dtype and g.shape == w.shape, k
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=str(k))


def test_committed_fixtures_agree_across_backends():
    """Both backends of each fixture give the port the same state dict and
    optimizer state, bit for bit, and vlsa_tpu's reader the same tree as
    the port's; the fixtures stay under 300 KB together."""
    for kind in ("sa", "mixed"):
        paths = {b: os.path.join(FIXTURES, FIXTURE_FILES[f"{kind}_{b}"])
                 for b in ("msgpack", "orbax")}
        a, b = load_checkpoint(paths["msgpack"]), load_checkpoint(paths["orbax"])
        assert a["epoch"] == b["epoch"] and a["model"].keys() == b["model"].keys()
        assert all(torch.equal(a["model"][k], b["model"][k]) for k in a["model"])
        assert ("optax_state" in a) == ("optax_state" in b) == (kind == "sa")
        if kind == "sa":
            fa, fb = dict(_flat(a["optax_state"])), dict(_flat(b["optax_state"]))
            assert fa.keys() == fb.keys()
            assert all(np.array_equal(fa[k], fb[k]) and np.asarray(fa[k]).dtype ==
                       np.asarray(fb[k]).dtype for k in fa)
        assert_same_tree(read_orbax_checkpoint(paths["orbax"] + ".orbax"),
                         jax_load_checkpoint(paths["orbax"]))
    total = sum(os.path.getsize(os.path.join(d, f))
                for d, _, fs in os.walk(FIXTURES) for f in fs)
    assert total < 300 * 1024, total


def test_the_port_resumes_the_fixture_run(tmp_path):
    """The fixture's optimizer state fits the port's SA model of
    FIXTURE_DIMS: `load_optax_state` takes it whole."""
    from vlsa_tpu_torch.optim import create_optimizer
    from vlsa_tpu_torch.optim.optax_state import load_optax_state
    from vlsa_tpu_torch.runner.sa import build_model
    ckpt = load_checkpoint(os.path.join(FIXTURES, FIXTURE_FILES["sa_msgpack"]))
    model = build_model({"arch": "DeepMIL", "net_dims": "-".join(map(str, FIXTURE_DIMS)),
                         "deepmil_network": "ABMIL", "deepmil_pooling": "attention",
                         "deepmil_use_feat_proj": False, "deepmil_drop_rate": 0.0},
                        device="cpu")
    model.load_state_dict(ckpt["model"], strict=True)
    opt = create_optimizer("adam", 1e-3, 1e-5, model)
    load_optax_state(opt, "adam", ckpt["optax_state"])
    assert len(opt.state) == len(list(model.parameters()))
    assert all(float(st["step"]) == FIXTURE_STEPS for st in opt.state.values())
