"""The port's data path (vlsa_tpu_torch.data: splits, labels, bags,
batcher) against vlsa_tpu's on the real TCGA-BLCA table and its fold-0
split, with synthetic bags.  Everything is host arithmetic, so the
comparisons are exact (bin edges to 1e-12: pandas and numpy interpolate the
quantiles in float64 in another order)."""
import os

import numpy as np
import pytest
import torch

from vlsa_tpu.data.bags import SurvBagDataset as JaxBagDataset
from vlsa_tpu.data.label_converter import MetaSurvData as JaxMeta
from vlsa_tpu.data.pipeline import BagBatcher as JaxBatcher
from vlsa_tpu.data.pipeline import bucket_length as jax_bucket_length
from vlsa_tpu.data.splits import read_file_data_splitting as jax_read_split
from vlsa_tpu_torch.data.bags import SurvBagDataset
from vlsa_tpu_torch.data.label_converter import MetaSurvData
from vlsa_tpu_torch.data.pipeline import BagBatcher, BagOverflowError, bucket_length
from vlsa_tpu_torch.data.splits import read_file_data_splitting

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COHORT = os.path.join(REPO, "assets", "data_split", "5foldcv", "tcga_blca")
TABLE = os.path.join(COHORT, "mahmoodlab_tcga_blca_survival.csv")
SPLIT = os.path.join(COHORT, "splits_0.csv")
SYNTH = "synthetic://N=48,D=16,seed=3"


def _metas(use_quantiles):
    split = read_file_data_splitting(SPLIT)
    jmeta = JaxMeta(TABLE, data_split=jax_read_split(SPLIT), verbose=False)
    jmeta.generate_discrete_label(use_quantiles=use_quantiles)
    meta = MetaSurvData(TABLE, data_split=split)
    meta.generate_discrete_label(use_quantiles=use_quantiles)
    return jmeta, meta, split


def test_split_reader_matches(tmp_path):
    want = jax_read_split(SPLIT)
    got = read_file_data_splitting(SPLIT)
    assert got == want and len(got["train"]) == 298 and len(got["test"]) == 75
    npz = str(tmp_path / "split.npz")
    np.savez(npz, train=np.array(want["train"][:5]), val=np.array(want["test"][:3]),
             test=np.array(want["test"][3:6]))
    assert read_file_data_splitting(npz) == jax_read_split(npz)


@pytest.mark.parametrize("use_quantiles", [False, True], ids=["uniform", "quantile"])
def test_fold0_bins_and_labels_match(use_quantiles):
    jmeta, meta, split = _metas(use_quantiles)
    assert meta.num_bins == jmeta.num_bins == 12
    np.testing.assert_allclose(meta.time_bins, jmeta.time_bins, rtol=0, atol=1e-12)
    assert len(meta.pids) == len(jmeta.pat_data) == 373 and len(meta.slide_ids) == 437
    pids = split["train"] + split["test"]
    want = jmeta.collect_info_by_pids(pids)
    got = meta.collect_info_by_pids(pids)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert {k: [int(v) for v in lab] for k, lab in want[2].items()} == got[2]
    assert max(len(s) for s in got[1].values()) == 9  # up to 9 slides for one patient


def test_bucket_length_matches():
    for n in (1, 255, 256, 257, 5000, 100_000):
        for mx in (None, 4096):
            assert bucket_length(n, 256, mx) == jax_bucket_length(n, 256, mx)


def _datasets(n_patients=22):
    jmeta, meta, split = _metas(False)
    pids = split["train"][:n_patients]
    return (JaxBagDataset(pids, SYNTH, "patch", jmeta, read_format="pt"),
            SurvBagDataset(pids, SYNTH, meta))


@pytest.mark.parametrize("feats_dtype,inv", [("float32", True), ("bfloat16", True),
                                             ("int8", True), ("int8", False)])
def test_batches_match(feats_dtype, inv):
    jds, ds = _datasets()
    kw = dict(batch_size=6, shuffle=True, seed=42, min_bucket=32, feats_dtype=feats_dtype,
              precompute_inv=inv)
    jb, tb = JaxBatcher(jds, prefetch=0, **kw), BagBatcher(ds, **kw)
    for _epoch in range(2):  # the order changes with the epoch
        jbatches, tbatches = list(jb), list(tb)
        assert len(jbatches) == len(tbatches) == 4
        for want, got in zip(jbatches, tbatches):
            assert set(got) == set(want)
            for key, w in want.items():
                g = got[key]
                if key == "feats" and feats_dtype == "bfloat16":
                    g, w = g.float().numpy(), np.asarray(w, np.float32)
                else:
                    g = g.numpy()
                assert g.dtype == w.dtype and g.shape == w.shape, key
                np.testing.assert_array_equal(g, w, err_msg=key)
    assert not tbatches[-1]["valid"].all()  # a ragged tail batch


def test_overflow_policy():
    jds, ds = _datasets(6)
    with pytest.raises(BagOverflowError):
        BagBatcher(ds, batch_size=6, fixed_bucket=16).make_batch(np.arange(6))
    b = BagBatcher(ds, batch_size=6, fixed_bucket=16, overflow="truncate")
    got = b.make_batch(np.arange(6))
    want = JaxBatcher(jds, batch_size=6, fixed_bucket=16, overflow="truncate",
                      prefetch=0)._make_batch(np.arange(6))
    np.testing.assert_array_equal(got["feats"].numpy(), want["feats"])
    assert b.truncated_bags == 6 and got["mask"].all()


# ---- the background producer (prefetch) ----

class _Flaky:
    """A dataset whose item `bad` raises."""

    def __init__(self, ds, bad):
        self.ds, self.bad = ds, bad

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        if i == self.bad:
            raise RuntimeError(f"cannot read bag {i}")
        return self.ds[i]


def test_prefetch_keeps_the_batches_and_their_order():
    _jds, ds = _datasets()
    kw = dict(batch_size=5, shuffle=True, seed=3, min_bucket=32, feats_dtype="bfloat16")
    ahead, inline = BagBatcher(ds, prefetch=2, **kw), BagBatcher(ds, prefetch=0, **kw)
    for _epoch in range(2):
        got, want = list(ahead), list(inline)
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                assert torch.equal(g[k], w[k]), k
        assert ahead.producer is not None and not ahead.producer.is_alive()
        assert inline.producer is None and ahead.build_s > 0 and inline.build_s > 0


def test_producer_error_is_raised_in_the_consumer():
    _jds, ds = _datasets()
    batcher = BagBatcher(_Flaky(ds, bad=12), batch_size=5, prefetch=2)  # the third batch
    seen = []
    with pytest.raises(RuntimeError, match="cannot read bag 12"):
        for batch in batcher:
            seen.append(batch["idx"].tolist())
    assert seen == [list(range(5)), list(range(5, 10))]
    batcher.producer.join(timeout=5)
    assert not batcher.producer.is_alive()


def test_producer_stops_when_the_consumer_breaks():
    """The consumer takes one batch of 22 and breaks while the producer is
    blocked on a full queue (2 batches queued, a third waiting): the
    producer ends within 5 s and builds no batch after that."""
    import time

    from vlsa_tpu_torch.data import pipeline
    _jds, ds = _datasets()
    batcher = BagBatcher(ds, batch_size=1, prefetch=2)
    pipeline.reset_batch_counts()
    for _batch in batcher:
        deadline = time.monotonic() + 30
        while pipeline.BATCHES["numpy"] < 4 and time.monotonic() < deadline:
            time.sleep(0.01)
        break
    batcher.producer.join(timeout=5)
    assert not batcher.producer.is_alive()
    assert pipeline.BATCHES["numpy"] == 4


def test_a_pass_after_a_break_counts_only_its_own_batches():
    """The producer of a pass the consumer left is joined as the loop exits,
    so it adds nothing to the next pass's batch counts or build_s."""
    from vlsa_tpu_torch.data import pipeline
    _jds, ds = _datasets()
    batcher = BagBatcher(ds, batch_size=5, prefetch=2)
    for _batch in batcher:
        break
    assert not batcher.producer.is_alive()
    pipeline.reset_batch_counts()
    assert len(list(batcher)) == len(batcher) == pipeline.BATCHES["numpy"] == 5
    assert not batcher.producer.is_alive() and batcher.build_s > 0


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("fails", [False, True])
def test_a_run_on_the_card_releases_its_pinned_batches(monkeypatch, device, fails):
    """A run's entry point on the card returns the page-locked blocks at its
    end, also when it raises; on the CPU there are none to return."""
    from types import SimpleNamespace

    from vlsa_tpu_torch.runner import base
    released = []
    monkeypatch.setattr(base, "release_pinned_batches", lambda: released.append(1))

    @base._releases_pinned_batches
    def run(self):
        if fails:
            raise RuntimeError("the run failed")
        return "metrics"
    handler = SimpleNamespace(device=torch.device(device))
    if fails:
        with pytest.raises(RuntimeError, match="the run failed"):
            run(handler)
    else:
        assert run(handler) == "metrics"
    assert released == ([1] if device == "cuda" else [])


def test_releasing_pinned_batches_without_a_card_does_nothing():
    from vlsa_tpu_torch.data.pipeline import release_pinned_batches
    assert not torch.cuda.is_available()
    assert release_pinned_batches() is None


def test_batch_counts_survive_concurrent_producers():
    """Sixteen producers at once, switching threads every microsecond: no
    count is lost."""
    import sys
    import threading

    from vlsa_tpu_torch.data import pipeline
    _jds, ds = _datasets(8)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pipeline.reset_batch_counts()
        batchers = [BagBatcher(ds, batch_size=1, prefetch=2) for _ in range(16)]
        threads = [threading.Thread(target=lambda b=b: list(b)) for b in batchers]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert pipeline.BATCHES == {"native": 0, "numpy": 16 * 8}


# ---- .q8npz stores through SurvBagDataset ----

@pytest.fixture(scope="module")
def q8_store(tmp_path_factory):
    """A .q8npz store whose q (|q| <= 50), scale and inv are not what
    quantizing q * scale again gives (inv arbitrary): a batch that
    requantizes, or recomputes 1/||q||, differs from it."""
    _jmeta, meta, split = _metas(False)
    pids = split["train"][:10]
    _found, pid2sids, _labels = meta.collect_info_by_pids(pids)
    root = str(tmp_path_factory.mktemp("q8"))
    rng = np.random.default_rng(8)
    for sids in pid2sids.values():
        for sid in sids:
            n = int(rng.integers(20, 60))
            with open(os.path.join(root, sid + ".q8npz"), "wb") as f:
                np.savez(f, q=rng.integers(-50, 51, size=(n, 16)).astype(np.int8),
                         scale=rng.uniform(0.01, 0.1, n).astype(np.float32),
                         inv=rng.uniform(0.5, 2.0, n).astype(np.float32))
    return pids, root


@pytest.mark.parametrize("feats_dtype", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_q8npz_batches_match_jax_as_stored(q8_store, feats_dtype, native):
    """int8 batches hold the stored q, scale and inv; bf16 and f32 batches
    the dequantized q * scale (bf16 as bits), as vlsa_tpu's."""
    from vlsa_tpu_torch.data.quant import read_quantized_feats
    pids, root = q8_store
    jmeta, meta, _split = _metas(False)
    ds = SurvBagDataset(pids, root, meta, read_format="q8npz")
    if not native:
        ds.bag_paths = lambda i: None
    jds = JaxBagDataset(pids, root, "patch", jmeta, read_format="q8npz")
    kw = dict(batch_size=4, min_bucket=32, feats_dtype=feats_dtype)
    got = list(BagBatcher(ds, **kw))
    want = list(JaxBatcher(jds, prefetch=0, **kw))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            a = g[k].view(torch.int16).numpy() if g[k].dtype == torch.bfloat16 else g[k].numpy()
            b = np.asarray(w[k])
            b = b.view(np.int16) if b.dtype.name == "bfloat16" else b
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a, b, err_msg=k)
    bag, label = ds[0]
    sids = ds.pid2sids[ds.pids[0]]
    stored = [read_quantized_feats(os.path.join(root, s + ".q8npz")) for s in sids]
    n = sum(s.shape[0] for s in stored)
    assert bag.shape == (n, 16) and label.dtype == np.float32
    if feats_dtype == "int8":
        b0 = got[0]
        np.testing.assert_array_equal(b0["feats"][0, :n].numpy(),
                                      np.concatenate([s.q for s in stored]))
        np.testing.assert_array_equal(b0["feats_scale"][0, :n].numpy(),
                                      np.concatenate([s.scale for s in stored]))
        np.testing.assert_array_equal(b0["feats_inv"][0, :n].numpy(),
                                      np.concatenate([s.inv for s in stored]))


# ---- few-shot sampling and its Kaplan-Meier de-censoring ----

def test_km_best_guess_matches_jax_on_fold0():
    from vlsa_tpu.data.label_converter import get_best_guess_from_training_data as jax_guess
    from vlsa_tpu_torch.data.label_converter import get_best_guess_from_training_data
    _jmeta, meta, _split = _metas(False)
    d = meta.get_patient_data(split="train", ret_columns=["t", "e"])
    got, want = get_best_guess_from_training_data(d["t"], d["e"]), jax_guess(d["t"], d["e"])
    assert got.dtype == want.dtype == np.float64 and got.shape == (298,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert np.any(got != d["t"])  # censored times were moved
    np.testing.assert_array_equal(got[d["e"] == 1], d["t"][d["e"] == 1])


@pytest.mark.parametrize("labels", ["uniform", "quantile", "origin", "ratio"])
def test_uncensored_time_bins_match_jax(labels):
    """The bins of the label format, or for continuous labels uniform bins
    of the patients' event times: exactly vlsa_tpu's."""
    from vlsa_tpu.data.label_converter import calculate_uncensored_time_bins as jax_bins
    from vlsa_tpu_torch.data.label_converter import calculate_uncensored_time_bins
    jmeta, meta, split = _labelled_metas(labels)
    for pids in (split["train"], split["test"]):
        np.testing.assert_array_equal(calculate_uncensored_time_bins(pids, meta),
                                      jax_bins(pids, jmeta))


def _labelled_metas(labels):
    """Both packages' label tables of fold 0 with discrete (uniform,
    quantile) or continuous (origin, ratio) labels."""
    if labels in ("uniform", "quantile"):
        return _metas(labels == "quantile")
    split = read_file_data_splitting(SPLIT)
    jmeta = JaxMeta(TABLE, data_split=jax_read_split(SPLIT), verbose=False)
    jmeta.generate_continuous_label(normalize=labels == "ratio")
    meta = MetaSurvData(TABLE, data_split=split)
    meta.generate_continuous_label(normalize=labels == "ratio")
    return jmeta, meta, split


@pytest.mark.parametrize("num_shot", [1, 4, 16])
@pytest.mark.parametrize("seed", [0, 42])
def test_few_shot_sample_matches_jax(num_shot, seed):
    from vlsa_tpu.data.bags import prepare_surv_dataset as jax_prepare
    from vlsa_tpu_torch.data.bags import FewShotSurvBagDataset, prepare_surv_dataset
    jmeta, meta, split = _metas(False)
    cfg = {"path_patch": SYNTH, "data_mode": "patch", "feat_format": "pt"}
    got = prepare_surv_dataset(split["train"], cfg, meta, num_shot=num_shot, seed_shot=seed)
    want = jax_prepare(split["train"], cfg, meta_data=jmeta, num_shot=num_shot, seed_shot=seed)
    assert isinstance(got, FewShotSurvBagDataset)
    assert got.few_shot_idx == want.few_shot_idx and got.uid == want.uid
    np.testing.assert_array_equal(got.uncensored_time_bins, want.uncensored_time_bins)
    assert len(got) == len(want) <= num_shot * meta.num_bins
    events = [got.pid2label[u][1] for u in got.uid]
    assert 1 <= sum(events) < len(events)
    bag, label = got[1]
    _i, (jbag, _aux), jlabel = want[1]
    np.testing.assert_array_equal(bag, jbag)
    np.testing.assert_array_equal(label, jlabel)
    assert got.bag_paths(1) is None  # synthetic bags
    np.testing.assert_array_equal(got.bag_label(1), jlabel)


def test_prepare_without_shots_and_with_ratio_sampling():
    from vlsa_tpu.data.bags import sampling_data as jax_sampling
    from vlsa_tpu_torch.data.bags import prepare_surv_dataset, sampling_data
    _jmeta, meta, split = _metas(False)
    cfg = {"path_patch": SYNTH, "feat_format": "pt"}
    ds = prepare_surv_dataset(split["train"], cfg, meta, num_shot=-1)
    assert isinstance(ds, SurvBagDataset) and ds.uid == split["train"]
    for num in (0.3, 40):
        np.random.seed(5)
        want = jax_sampling(split["train"], num)
        np.random.seed(5)
        assert sampling_data(split["train"], num) == want
    np.random.seed(5)
    want = jax_sampling(split["train"], 0.25)[0]
    np.random.seed(5)
    assert prepare_surv_dataset(split["train"], cfg, meta, ratio_sampling=0.25).uid == want
    with pytest.raises(ValueError):
        sampling_data(split["train"], 1.5)


# ---- continuous labels ----

@pytest.mark.parametrize("labels", ["origin", "ratio"])
def test_continuous_labels_match_jax(labels):
    jmeta, meta, split = _labelled_metas(labels)
    assert meta.label_format == jmeta.label_format == \
        {"origin": "continuous_time", "ratio": "continuous_ratio"}[labels]
    want = jmeta.pat_data["y_t"].to_numpy()
    assert want.dtype == meta.y_t.dtype == np.float64
    np.testing.assert_array_equal(meta.y_t, want)
    if labels == "ratio":
        assert meta.y_t.max() == 1.0 and (meta.y_t > 0).all()
    pids = split["train"] + split["test"]
    got, jgot = meta.collect_info_by_pids(pids), jmeta.collect_info_by_pids(pids)
    assert got[0] == jgot[0] and got[1] == jgot[1]
    for p in got[0]:
        assert [float(v) for v in got[2][p]] == [float(v) for v in jgot[2][p]]
    assert meta.num_bins is None and meta.time_coordinates is None
