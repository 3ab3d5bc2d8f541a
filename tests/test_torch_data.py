"""The port's data path (vlsa_tpu_torch.data: splits, labels, bags,
batcher) against vlsa_tpu's on the real TCGA-BLCA table and its fold-0
split, with synthetic bags.  Everything is host arithmetic, so the
comparisons are exact (bin edges to 1e-12: pandas and numpy interpolate the
quantiles in float64 in another order)."""
import os

import numpy as np
import pytest

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
