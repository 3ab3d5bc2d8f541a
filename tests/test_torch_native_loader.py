"""The port's native batch path (vlsa_tpu_torch.data.native_loader, the
batcher's use of it) against vlsa_tpu's: both packages build
native/bagloader.cpp with g++ here.  Every comparison is exact, byte for
byte: the stores' headers, the assembled arrays, and whole batches of the
port's native path, the port's numpy path and vlsa_tpu's BagBatcher, in
f32, bf16 (compared as bits) and int8 with its sidecars, from `.npy` (f32
and f16) and `.q8npz` stores of TCGA-BLCA fold-0 patients (up to 9 slides a
patient), with a tail batch, a fixed bucket and each overflow policy."""
import os
import threading

import numpy as np
import pytest
import torch

from test_torch_data import _metas
from vlsa_tpu.data import native_loader as jax_native
from vlsa_tpu.data.bags import SurvBagDataset as JaxBagDataset
from vlsa_tpu.data.pipeline import BagBatcher as JaxBatcher
from vlsa_tpu.data.pipeline import BagOverflowError as JaxOverflowError
from vlsa_tpu_torch.data import native_loader, pipeline
from vlsa_tpu_torch.data.bags import SurvBagDataset
from vlsa_tpu_torch.data.convert import convert_dir
from vlsa_tpu_torch.data.io import synthetic_bag
from vlsa_tpu_torch.data.pipeline import BagBatcher, BagOverflowError

SYNTH = "synthetic://N=48,D=16,seed=3"
N_PATIENTS = 22
STORES = ("npy", "npy_f16", "q8npz")


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """(port meta, JAX meta, patient ids, {store: directory}): the
    synthetic bags of 22 training patients as .npy f32, .npy f16 and
    .q8npz (converted from the f32 store) slide files."""
    jmeta, meta, split = _metas(False)
    pids = split["train"][:N_PATIENTS]
    _found, pid2sids, _labels = meta.collect_info_by_pids(pids)
    root = tmp_path_factory.mktemp("stores")
    dirs = {s: str(root / s) for s in STORES}
    for d in ("npy", "npy_f16"):
        os.makedirs(dirs[d])
    for sids in pid2sids.values():
        for sid in sids:
            f = synthetic_bag(sid, SYNTH)
            np.save(os.path.join(dirs["npy"], sid + ".npy"), f)
            np.save(os.path.join(dirs["npy_f16"], sid + ".npy"), f.astype(np.float16))
    convert_dir(dirs["npy"], dirs["q8npz"], dtype="int8", verbose=False)
    assert max(len(s) for s in pid2sids.values()) > 1  # a multi-slide patient
    return meta, jmeta, pids, dirs


def _fmt(store):
    return "q8npz" if store == "q8npz" else "npy"


def _numpy_only(ds):
    ds.bag_paths = lambda i: None  # what a store without native support gives
    return ds


def _as_numpy(v):
    """Bytes to compare: bf16 tensors as their int16 bits."""
    if isinstance(v, torch.Tensor):
        return v.view(torch.int16).numpy() if v.dtype == torch.bfloat16 else v.numpy()
    v = np.asarray(v)
    return v.view(np.int16) if v.dtype.name == "bfloat16" else v


def assert_same_batch(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        g, w = _as_numpy(got[k]), _as_numpy(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: {k}")


def test_headers_match_jax(cohort):
    _meta, _jmeta, _pids, dirs = cohort
    for store in STORES:
        d = dirs[store]
        for name in sorted(os.listdir(d))[:5]:
            path = os.path.join(d, name)
            if store == "q8npz":
                assert native_loader.read_q8_info(path) == jax_native.read_q8_info(path)
            else:
                assert native_loader.read_npy_info(path) == jax_native.read_npy_info(path)
                assert native_loader.read_npy_info(path) == np.load(path).shape


@pytest.mark.parametrize("store", STORES)
def test_assembly_matches_jax(cohort, store):
    """Bags of one and of several slides, cut at target_n, written straight
    into the caller's tensors."""
    _meta, _jmeta, _pids, dirs = cohort
    d = dirs[store]
    names = sorted(os.listdir(d))
    paths = [os.path.join(d, n) for n in names]
    groups = [paths[:1], paths[1:4], paths[4:5], paths[5:9]]
    target_n, dim = 96, 16
    mask = torch.empty(len(groups), target_n, dtype=torch.bool)
    if store == "q8npz":
        q = torch.empty(len(groups), target_n, dim, dtype=torch.int8)
        scale, inv = torch.empty(len(groups), target_n), torch.empty(len(groups), target_n)
        lens = native_loader.assemble_q8_batch(groups, q, scale, inv, mask)
        want = jax_native.assemble_q8_batch(groups, target_n, dim)
        got = (q, scale, inv, mask, lens)
    else:
        feats = torch.empty(len(groups), target_n, dim)
        lens = native_loader.assemble_batch(groups, feats, mask)
        want = jax_native.assemble_batch(groups, target_n, dim)
        got = (feats, mask, lens)
    assert int(lens.max()) == target_n and int(lens.min()) < target_n  # cut, and padded
    for g, w in zip(got, want):
        g = g.numpy()
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w.astype(g.dtype))


def test_assembly_checks_the_buffers(cohort):
    paths = [[os.path.join(cohort[3]["npy"], sorted(os.listdir(cohort[3]["npy"]))[0])]]
    with pytest.raises(ValueError, match="contiguous CPU torch.float32"):
        native_loader.assemble_batch(paths, torch.empty(1, 16, 32)[:, :, :16],
                                     torch.empty(1, 16, dtype=torch.bool))
    with pytest.raises(ValueError, match="mask"):
        native_loader.assemble_batch(paths, torch.empty(1, 16, 16), torch.empty(1, 16))
    with pytest.raises(OSError, match="native batch assembly failed"):
        native_loader.assemble_batch([["/nonexistent.npy"]], torch.empty(1, 16, 16),
                                     torch.empty(1, 16, dtype=torch.bool))


CASES = [(store, dt, inv) for store in STORES
         for dt, inv in (("float32", True), ("bfloat16", True), ("int8", True), ("int8", False))]


@pytest.mark.parametrize("store,feats_dtype,inv", CASES)
def test_batches_native_numpy_and_jax_identical(cohort, store, feats_dtype, inv):
    """Two shuffled epochs of 6-bag batches (the last a tail of 4), the same
    bytes on all three paths; every port batch counted on its path."""
    meta, jmeta, pids, dirs = cohort
    fmt = _fmt(store)
    kw = dict(batch_size=6, shuffle=True, seed=7, min_bucket=32, feats_dtype=feats_dtype,
              precompute_inv=inv)
    native = BagBatcher(SurvBagDataset(pids, dirs[store], meta, read_format=fmt), **kw)
    plain = BagBatcher(_numpy_only(SurvBagDataset(pids, dirs[store], meta, read_format=fmt)),
                       **kw)
    jax = JaxBatcher(JaxBagDataset(pids, dirs[store], "patch", jmeta, read_format=fmt),
                     prefetch=0, **kw)
    pipeline.reset_batch_counts()
    for epoch in range(2):
        got, got_plain, want = list(native), list(plain), list(jax)
        assert len(got) == len(want) == 4 and not got[-1]["valid"].all()
        for j, (g, p, w) in enumerate(zip(got, got_plain, want)):
            assert_same_batch(g, w, f"epoch {epoch} batch {j}: native vs vlsa_tpu")
            assert_same_batch(p, w, f"epoch {epoch} batch {j}: numpy vs vlsa_tpu")
    # a .q8npz store in f32 or bf16 storage is dequantized on the numpy path
    native_count = 8 if store != "q8npz" or feats_dtype == "int8" else 0
    assert pipeline.BATCHES == {"native": native_count, "numpy": 16 - native_count}


@pytest.mark.parametrize("store", STORES)
@pytest.mark.parametrize("overflow", ["truncate", "warn"])
def test_fixed_bucket_and_overflow_match_jax(cohort, store, overflow, capsys):
    meta, jmeta, pids, dirs = cohort
    fmt = _fmt(store)
    dt = "int8" if store == "q8npz" else "bfloat16"
    kw = dict(batch_size=8, fixed_bucket=40, feats_dtype=dt, overflow=overflow)
    port = BagBatcher(SurvBagDataset(pids, dirs[store], meta, read_format=fmt), **kw)
    jax = JaxBatcher(JaxBagDataset(pids, dirs[store], "patch", jmeta, read_format=fmt),
                     prefetch=0, **kw)
    pipeline.reset_batch_counts()
    for j, (g, w) in enumerate(zip(port, jax)):
        assert g["feats"].shape[1] == 40
        assert_same_batch(g, w, f"batch {j}")
    assert pipeline.BATCHES == {"native": 3, "numpy": 0}
    assert port.truncated_bags > 0 and port.truncated_patches > 0
    assert ("truncated to 40" in capsys.readouterr().out) == (overflow == "warn")


@pytest.mark.parametrize("store", STORES)
def test_overflow_error_on_both_paths(cohort, store):
    meta, jmeta, pids, dirs = cohort
    fmt = _fmt(store)
    for ds in (SurvBagDataset(pids, dirs[store], meta, read_format=fmt),
               _numpy_only(SurvBagDataset(pids, dirs[store], meta, read_format=fmt))):
        with pytest.raises(BagOverflowError, match="exceeds the 40-patch bucket"):
            BagBatcher(ds, batch_size=8, fixed_bucket=40, feats_dtype="int8",
                       prefetch=0).make_batch(np.arange(8))
    with pytest.raises(JaxOverflowError):
        JaxBatcher(JaxBagDataset(pids, dirs[store], "patch", jmeta, read_format=fmt),
                   batch_size=8, fixed_bucket=40, prefetch=0)._make_batch(np.arange(8))


def test_missing_slide_falls_back_to_numpy(cohort, tmp_path, capsys):
    """A store missing one slide file: the native path reports its failure,
    the numpy path builds the batch from the slides that exist, as
    vlsa_tpu's does."""
    meta, jmeta, pids, dirs = cohort
    d = str(tmp_path / "partial")
    os.makedirs(d)
    names = sorted(os.listdir(dirs["npy"]))
    for n in names[1:]:
        os.link(os.path.join(dirs["npy"], n), os.path.join(d, n))
    kw = dict(batch_size=N_PATIENTS, feats_dtype="float32")
    pipeline.reset_batch_counts()
    got = BagBatcher(SurvBagDataset(pids, d, meta, read_format="npy"),
                     prefetch=0, **kw).make_batch(np.arange(N_PATIENTS))
    want = JaxBatcher(JaxBagDataset(pids, d, "patch", jmeta, read_format="npy"),
                      prefetch=0, **kw)._make_batch(np.arange(N_PATIENTS))
    assert_same_batch(got, want, "missing slide")
    assert pipeline.BATCHES == {"native": 0, "numpy": 1}
    out = capsys.readouterr().out
    assert "native path failed" in out and "not found slide" in out


def test_slide_lengths_and_paths(cohort):
    meta, jmeta, pids, dirs = cohort
    for store in STORES:
        ds = SurvBagDataset(pids, dirs[store], meta, read_format=_fmt(store))
        jds = JaxBagDataset(pids, dirs[store], "patch", jmeta, read_format=_fmt(store))
        sids = ds.pid2sids[pids[0]]
        assert [ds._slide_len(s) for s in sids] == [jds._slide_len(s) for s in sids]
        assert ds._slide_len("no-such-slide") == 0
        for i in range(3):
            assert ds.bag_paths(i) == jds.bag_paths(i)
            np.testing.assert_array_equal(ds.bag_label(i), jds.bag_label(i))
    assert SurvBagDataset(pids, SYNTH, meta).bag_paths(0) is None
    assert SurvBagDataset(pids, dirs["npy"], meta, read_format="pt").bag_paths(0) is None


def test_library_builds_once_under_concurrency(tmp_path, monkeypatch):
    """Threads that build the library at once into an empty directory all
    load one complete library (private file, then rename)."""
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "build")
    paths, errors = [], []

    def build():
        try:
            paths.append(native_loader._build())
        except Exception as exc:  # noqa: BLE001 - collected for the assertion
            errors.append(exc)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and len(set(paths)) == 1 and len(paths) == 4
    assert sorted(os.listdir(tmp_path / "build")) == [paths[0].name]
    native_loader._declare(__import__("ctypes").CDLL(str(paths[0])))


@pytest.mark.parametrize("feats_dtype", ["bfloat16", "int8"])
def test_batches_across_staging_chunks(cohort, feats_dtype):
    """bf16 and int8 batches from .npy go through the f32 staging buffer 8
    bags at a time: 20 bags (8, 8, then 4) in a batch of 22 rows."""
    meta, jmeta, pids, dirs = cohort
    kw = dict(batch_size=22, min_bucket=32, feats_dtype=feats_dtype)
    got = BagBatcher(SurvBagDataset(pids, dirs["npy"], meta, read_format="npy"),
                     prefetch=0, **kw).make_batch(np.arange(2, 22))
    want = JaxBatcher(JaxBagDataset(pids, dirs["npy"], "patch", jmeta, read_format="npy"),
                      prefetch=0, **kw)._make_batch(np.arange(2, 22))
    assert_same_batch(got, want, f"{feats_dtype}, 20 bags")
    assert not got["valid"][20:].any() and not got["mask"][20:].any()
