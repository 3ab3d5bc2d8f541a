"""The port's extraction path against vlsa_tpu's: `FeatureExtractor` with the
same weights (the JAX extractor's, through the bridge) on a small CONCH
model (width 64, 4 heads of 16, 2 layers, 48-pixel input from 64-pixel
tiles), the store writer and extraction loop (`.npy`/`.q8npz`, resume, an empty
slide, the one-slide prefetch, coords), the stores read back by the port's
bag dataset and training CLI, and the extraction CLI on the CPU.

Tolerances (max|a-b| / max|b|) for the features: f32 1e-5 (summation
order); bf16 2e-3 (bf16 rounding flips, as tests/test_torch_vision_tower.py
states).  Batch sizes 2 and 8 (ragged tails zero-padded) agree to 1e-6, and
so do host and device preprocessing (their inputs differ by <= 1 ulp).
Stores: `.npy` exact, `.q8npz` equal to `quantize_feats_int8`'s
dequantization.
"""
import io
import json
import os
from contextlib import redirect_stdout

import h5py
import jax
import numpy as np
import pytest
import torch
import yaml

from vlsa_tpu.data.extract import FeatureExtractor as JaxExtractor
from vlsa_tpu.data.io import read_patch_data as jax_read_patch_data
from vlsa_tpu_torch.data.bags import SurvBagDataset, read_patch_data
from vlsa_tpu_torch.data.extract import FeatureExtractor, extract_to_store, write_feature_store
from vlsa_tpu_torch.data.quant import quantize_feats_int8
from vlsa_tpu_torch.runner import extract as extract_cli
from vlsa_tpu_torch.runner import train as train_cli
from vlsa_tpu_torch.utils.weights import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(layers=2, width=64, heads=4, embed_dim_contrast=64, embed_dim_caption=32,
             attn_pooler_heads=4, n_queries_caption=4, patch_size=16)
RNG = np.random.default_rng(9)
TILES = RNG.integers(0, 256, size=(5, 64, 64, 3), dtype=np.uint8)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _port(jex, batch_size, **kw):
    """The port's extractor with the JAX extractor's weights (bf16-cast
    alike for bf16 compute)."""
    ex = FeatureExtractor(image_size=48, batch_size=batch_size, model_overrides=SMALL,
                          device="cpu", **kw)
    ex.model.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, jex._params)),
                             strict=True)
    return ex


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def extractors(request):
    dtype = request.param
    jex = JaxExtractor(image_size=48, batch_size=2, compute_dtype=dtype, model_overrides=SMALL)
    return dtype, jex, _port(jex, 2, compute_dtype=dtype)


def test_extractor_matches_jax(extractors):
    dtype, jex, ex = extractors
    want = jex.extract(TILES)
    got = ex.extract(TILES)
    assert got.shape == want.shape == (5, SMALL["embed_dim_contrast"])
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert _rel(got, want) <= (1e-5 if dtype == "float32" else 2e-3)


def test_batch_sizes_and_preprocessing_agree(extractors):
    """Batch 2 (three batches, the last padded) == batch 8 (one, padded);
    host preprocessing == device preprocessing (the default off CUDA is the
    host)."""
    dtype, jex, ex = extractors
    assert not ex._device_preprocess
    a = ex.extract(TILES)
    big = _port(jex, 8, compute_dtype=dtype, device_preprocess=True)
    b = big.extract(TILES)
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-6 * np.abs(a).max())
    np.testing.assert_array_equal(ex.extract(TILES[:0]), np.zeros((0, 64), np.float32))


def _write_slides(root):
    """slideA.h5 (5 tiles + coords), slideB.npy (3 tiles), empty.npy (0)."""
    os.makedirs(root)
    coords = RNG.integers(0, 9999, size=(5, 2))
    with h5py.File(os.path.join(root, "slideA.h5"), "w") as hf:
        hf.create_dataset("imgs", data=TILES)
        hf.create_dataset("coords", data=coords)
    np.save(os.path.join(root, "slideB.npy"), TILES[:3])
    np.save(os.path.join(root, "empty.npy"), np.zeros((0, 64, 64, 3), np.uint8))
    return coords


class _Meta:
    """The two methods SurvBagDataset asks of its label table."""

    def collect_info_by_pids(self, pids):
        return list(pids), {"p0": ["slideA", "slideB"]}, {"p0": [1, 0]}


@pytest.mark.parametrize("fmt", ["npy", "q8npz"])
def test_extract_to_store(tmp_path, fmt):
    jex = JaxExtractor(image_size=48, batch_size=2, compute_dtype="float32", model_overrides=SMALL)
    ex = _port(jex, 2, compute_dtype="float32")
    coords = _write_slides(str(tmp_path / "tiles"))
    out = str(tmp_path / "feats")
    stats = extract_to_store(str(tmp_path / "tiles"), out, ex, fmt=fmt,
                             coord_dir=str(tmp_path / "coords"))
    assert {k: stats[k] for k in ("slides", "tiles", "skipped", "empty")} == \
        {"slides": 3, "tiles": 8, "skipped": 0, "empty": 1}
    assert sorted(os.listdir(out)) == [f"slideA.{fmt}", f"slideB.{fmt}"]
    with h5py.File(str(tmp_path / "coords" / "slideA.h5"), "r") as hf:
        np.testing.assert_array_equal(hf["coords"][:], coords)

    feats = {"slideA": ex.extract(TILES), "slideB": ex.extract(TILES[:3])}
    for sid, f in feats.items():
        path = os.path.join(out, f"{sid}.{fmt}")
        want = f if fmt == "npy" else (lambda q, s: q.astype(np.float32) * s[:, None])(
            *quantize_feats_int8(f))
        np.testing.assert_array_equal(read_patch_data(path), want)
        np.testing.assert_array_equal(jax_read_patch_data(path), want)
    bag, label = SurvBagDataset(["p0"], out, _Meta(), read_format=fmt)[0]
    assert bag.shape == (8, 64) and label.tolist() == [1.0, 0.0]
    if fmt == "q8npz":  # the stored int8 bag, which batches take as it is
        bag = bag.dequantize()
    np.testing.assert_array_equal(bag, np.concatenate([read_patch_data(
        os.path.join(out, f"{s}.{fmt}")) for s in ("slideA", "slideB")]))

    # resume skips both stores; without prefetch the same stores come out
    assert extract_to_store(str(tmp_path / "tiles"), out, ex, fmt=fmt, resume=True,
                            verbose=False)["skipped"] == 2
    out2 = str(tmp_path / "feats2")
    extract_to_store(str(tmp_path / "tiles"), out2, ex, fmt=fmt, prefetch=False, verbose=False)
    for sid in feats:
        np.testing.assert_array_equal(read_patch_data(os.path.join(out2, f"{sid}.{fmt}")),
                                      read_patch_data(os.path.join(out, f"{sid}.{fmt}")))


def test_reader_matches_jax_for_every_format(tmp_path):
    f = RNG.normal(size=(7, 16)).astype(np.float32)
    paths = [write_feature_store(str(tmp_path), "s", f, fmt) for fmt in ("npy", "q8npz")]
    with h5py.File(str(tmp_path / "s.h5"), "w") as hf:
        hf.create_dataset("features", data=f)
    torch.save({"features": torch.from_numpy(f)}, str(tmp_path / "s.pt"))
    for path in paths + [str(tmp_path / "s.h5"), str(tmp_path / "s.pt")]:
        np.testing.assert_array_equal(read_patch_data(path), jax_read_patch_data(path))
    with pytest.raises(ValueError, match="unsupported"):
        read_patch_data(str(tmp_path / "s.csv"))


def test_checkpoint_matches_jax(tmp_path):
    """A torch CONCH checkpoint trained at grid 2 (32 px), loaded by both
    extractors at 48 px: the same features (f32, 1e-5)."""
    from test_torch_vision_tower import _fake_conch_state
    st = _fake_conch_state(np.random.default_rng(4), grid=2)
    ckpt = str(tmp_path / "conch.bin")
    torch.save({k: torch.from_numpy(v) for k, v in st.items()}, ckpt)
    kw = dict(checkpoint=ckpt, image_size=48, batch_size=4, compute_dtype="float32",
              model_overrides=SMALL)
    want = JaxExtractor(**kw).extract(TILES)
    got = FeatureExtractor(device="cpu", **kw).extract(TILES)
    assert _rel(got, want) <= 1e-5


def test_unported_options_raise(monkeypatch):
    """More cards than there are raise vlsa_tpu's ValueError, before any
    card is touched (the count of cards made 1 here; on the CPU any number
    of parts runs, tests/test_torch_multiprocess.py)."""
    import vlsa_tpu_torch.data.extract as extract_mod
    with monkeypatch.context() as m:
        m.setattr(extract_mod, "resolve_device", lambda device: torch.device("cuda"))
        m.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(ValueError, match="requested 2 devices, have 1"):
            FeatureExtractor(num_devices=2, batch_size=4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            FeatureExtractor(image_size=32, model_overrides=SMALL)


def _json_lines(buf):
    return [json.loads(s) for s in buf.getvalue().splitlines() if s.startswith("{")]


def test_cli_on_the_cpu(tmp_path):
    """Full CONCH width at a 32-pixel input: 2 synthetic slides of 3 tiles,
    f32."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        stats = extract_cli.main(["--synthetic", "2", "--synthetic_tiles", "3", "--image_size",
                                  "32", "--batch", "2", "--dtype", "float32", "--format",
                                  "q8npz", "--out", str(tmp_path / "f"), "--device", "cpu"])
    assert _json_lines(buf)[-1] == stats
    assert stats["slides"] == 2 and stats["tiles"] == 6 and stats["feat_dim"] == 512
    assert stats["device"] == "cpu" and stats["flash_launches"] == {"f32": 0, "bf16": 0}
    for i in range(2):
        feats = read_patch_data(str(tmp_path / "f" / f"synthetic_{i}.q8npz"))
        assert feats.shape == (3, 512) and np.isfinite(feats).all()


def test_train_cli_reads_q8npz_stores(tmp_path):
    """Stores in the extractor's `.q8npz` format for every slide of the
    TCGA-BLCA table feed `python -m vlsa_tpu_torch.runner.train` with
    `feat_format: q8npz` (the SA config, 2 steps on the CPU)."""
    cfg = yaml.safe_load(open(os.path.join(REPO, "configs/IFMLE/tcga_blca/cfg_sa_base_conch.yaml")))
    table = os.path.join(REPO, cfg["path_table"].format("tcga_blca"))
    sids = [line.split(",")[0] for line in open(table).read().splitlines()[1:]]
    header = open(table).readline().strip().split(",")
    assert header[0] == "pathology_id"
    store = str(tmp_path / "feats")
    for sid in sids:
        write_feature_store(store, sid, RNG.normal(size=(12, 512)).astype(np.float32), "q8npz")
    cfg.update(path_patch=store, feat_format="q8npz", bp_every_batch=4,
               path_table=os.path.join(REPO, cfg["path_table"]),
               data_split_path=os.path.join(REPO, cfg["data_split_path"]))
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    buf = io.StringIO()
    with redirect_stdout(buf):
        summary = train_cli.main(["--config", str(path), "--steps", "2", "--device", "cpu"])
    lines = _json_lines(buf)
    assert [r["step"] for r in lines[:2]] == [0, 1] and lines[-1] == summary
    assert all(np.isfinite(r["loss"]) and r["bags"] == 4 for r in lines[:2])
