"""Cluster and graph bags (data_mode `cluster` for DeepAttnMISL, `graph` for
PatchGCN), the graph half of data/convert.py, and the page-locked batch
pool's logic, on the CPU.

- The batches of both modes equal vlsa_tpu's BagBatcher's bit for bit, on
  TCGA-BLCA fold-0 patients with synthetic bags (up to 9 slides a patient):
  cluster ids from `{pid}.npy`, 8-neighbour grid graphs from `{sid}.npz`.
  vlsa_tpu offsets every slide's edges after the first by the patient's
  whole node count, so a patient of two or more slides has edges past its
  last node; the port keeps them, and PatchGCN treats them as vlsa_tpu's
  JAX does (a source clamped to the bag's last row, a destination outside
  the bag reaching no node): its forward on such a batch within 1e-5.
- `convert_graph_dir` on stub torch_geometric pickles (tg1 and tg2 layouts)
  writes the `.npz` files vlsa_tpu's writes, array for array.
- `python -m vlsa_tpu_torch.main --handler SA` trains DeepAttnMISL on
  cluster bags and PatchGCN on graph bags; the serving CLI answers them.
- The pool (data/pipeline.py::BatchPool, pageable here: the same logic
  without cudaHostAlloc): an iteration holds at most prefetch + 2 buffers
  and (prefetch + 2) x its largest batch's bytes, every batch equals the
  batch built without the pool, the batch the consumer holds is never
  written over before it asks for the next one, and the buffers serve the
  next epoch and a pass after one that stopped early.
"""
import io
import json
import os
import sys
import time
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_torch_data import _metas
from test_torch_lifecycle import write_cohort
from test_torch_native_loader import assert_same_batch
from vlsa_tpu.data.bags import SurvBagDataset as JaxBagDataset
from vlsa_tpu.data.convert import convert_graph_dir as jax_convert_graph_dir
from vlsa_tpu.data.pipeline import BagBatcher as JaxBatcher
from vlsa_tpu.models import load_model as jax_load_model
from vlsa_tpu_torch.data import pipeline
from vlsa_tpu_torch.data.bags import SurvBagDataset
from vlsa_tpu_torch.data.convert import (convert_graph_dir, install_tg_unpickle_stubs,
                                         main as convert_main)
from vlsa_tpu_torch.data.io import grid_edge_index, synthetic_bag, synthetic_cluster_ids
from vlsa_tpu_torch.data.pipeline import BagBatcher, BatchPool
from vlsa_tpu_torch.main import main as port_main
from vlsa_tpu_torch.models.mil_ext import _aggregate, edge_lists
from vlsa_tpu_torch.models.registry import load_model
from vlsa_tpu_torch.runner import serve as serve_cli
from vlsa_tpu_torch.utils.weights import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH = "synthetic://N=40,D=16,seed=3"
N_PATIENTS = 14
KC = 8


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """(port meta, JAX meta, patient ids, cluster dir, graph dir)."""
    jmeta, meta, split = _metas(False)
    pids = split["train"][:N_PATIENTS]
    _found, pid2sids, _labels = meta.collect_info_by_pids(pids)
    assert max(len(s) for s in pid2sids.values()) > 1  # a multi-slide patient
    root = tmp_path_factory.mktemp("aux")
    cdir, gdir = root / "clusters", root / "graphs"
    cdir.mkdir()
    gdir.mkdir()
    for pid, sids in pid2sids.items():
        n = sum(synthetic_bag(sid, SYNTH).shape[0] for sid in sids)
        np.save(cdir / f"{pid}.npy", synthetic_cluster_ids(pid, n, KC))
        for sid in sids:
            np.savez(gdir / f"{sid}.npz", edge_index=grid_edge_index(
                synthetic_bag(sid, SYNTH).shape[0]))
    return meta, jmeta, pids, str(cdir), str(gdir)


def _pair(cohort, mode, **kw):
    meta, jmeta, pids, cdir, gdir = cohort
    paths = {"cluster_path": cdir, "graph_path": gdir}
    port = SurvBagDataset(pids, SYNTH, meta, mode=mode, **paths)
    jax_ds = JaxBagDataset(pids, SYNTH, mode, jmeta, **paths)
    return (BagBatcher(port, batch_size=4, prefetch=0, **kw),
            JaxBatcher(jax_ds, batch_size=4, prefetch=0, **kw))


@pytest.mark.parametrize("mode", ["cluster", "graph"])
@pytest.mark.parametrize("kw", [dict(min_bucket=16), dict(min_bucket=16, shuffle=True, seed=5),
                                dict(fixed_bucket=64, overflow="truncate")],
                         ids=["bucket", "shuffled", "truncated"])
def test_batches_match_jax(cohort, mode, kw):
    port, jax_b = _pair(cohort, mode, **kw)
    got, want = list(port), list(jax_b)
    assert len(got) == len(want) == -(-N_PATIENTS // 4)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_same_batch(g, w, f"{mode} batch {i}")
    assert ("cluster_id" if mode == "cluster" else "edge_index") in got[0]


def test_a_multi_slide_patient_has_edges_past_its_bag(cohort):
    """vlsa_tpu's offset (the whole bag's nodes, not the nodes before the
    slide): a patient of several slides has edges past its last node, in
    both packages alike."""
    meta, _jmeta, pids, _c, gdir = cohort
    ds = SurvBagDataset(pids, SYNTH, meta, mode="graph", graph_path=gdir)
    _f, pid2sids, _l = meta.collect_info_by_pids(pids)
    multi = [i for i, p in enumerate(ds.pids) if len(pid2sids[p]) > 1]
    feats, _label, edges = ds[multi[0]]
    assert edges.max() >= feats.shape[0]
    first = synthetic_bag(pid2sids[ds.pids[multi[0]]][0], SYNTH).shape[0]
    assert edges[:, :grid_edge_index(first).shape[1]].max() < first


def test_patchgcn_on_out_of_range_edges_matches_jax(cohort):
    """A batch holding a multi-slide patient with a tight bucket: edges whose
    source or destination lies past the bucket; PatchGCN's forward follows
    JAX's clamped gather and dropped segments."""
    port_b, jax_b = _pair(cohort, "graph", min_bucket=16)
    batches = list(jax_b)
    N = batches[0]["mask"].shape[1]
    b = next(b for b in batches if b["edge_index"].max() >= b["mask"].shape[1])
    D = b["feats"].shape[-1]
    jm, params = jax_load_model("DeepMIL", [D, 8, 4], network="PatchGCN", num_layers=2)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(b["feats"]),
                               mask=jnp.asarray(b["mask"]),
                               edge_index=jnp.asarray(b["edge_index"]),
                               edge_valid=jnp.asarray(b["edge_valid"])))
    model = load_model("DeepMIL", [D, 8, 4], device="cpu", network="PatchGCN", num_layers=2,
                       state_dict=state_dict_from_jax(jax.tree.map(np.asarray, params))).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(b["feats"]), torch.from_numpy(b["mask"]),
                    edge_index=torch.from_numpy(b["edge_index"]),
                    edge_valid=torch.from_numpy(b["edge_valid"])).numpy()
    assert N > 0 and np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max())


def test_edge_lists_hold_each_nodes_incoming_edges():
    rng = np.random.default_rng(0)
    Bn, N, E = 3, 12, 40
    ei = rng.integers(-2, N + 3, size=(Bn, 2, E))
    ev = rng.random((Bn, E)) < 0.8
    src, in_deg, by_src, out_deg = edge_lists(torch.from_numpy(ei), torch.from_numpy(ev), N)
    assert in_deg.shape == out_deg.shape == (Bn * N,) and src.shape == by_src.shape
    assert int(in_deg.sum()) == int(out_deg.sum()) == src.numel()
    start = 0
    for b in range(Bn):
        for n in range(N):
            want = [int(s) for s, d, v in zip(ei[b, 0], ei[b, 1], ev[b]) if v and d == n]
            want = [b * N + min(max(s + N if s < 0 else s, 0), N - 1) for s in want]
            got = src[start:start + int(in_deg[b * N + n])].tolist()
            start += len(got)
            assert got == want, (b, n)
    assert src[by_src].tolist() == sorted(src.tolist())
    assert torch.equal(out_deg, torch.bincount(src, minlength=Bn * N))


@pytest.mark.parametrize("skewed", [False, True])
def test_aggregation_matches_a_dense_softmax(skewed):
    """The segment softmax and its gradients (through the gather by source)
    against each node's softmax written out over a dense [N, N] edge table,
    in float64, on a uniform and on a hub-heavy in-degree (half the edges
    into two nodes), with edges that reach no node and a node without
    edges."""
    rng = np.random.default_rng(3)
    Bn, N, E, D = 2, 10, 60, 5
    ei = rng.integers(0, N, size=(Bn, 2, E))
    if skewed:
        ei[:, 1, : E // 2] = rng.integers(0, 2, size=(Bn, E // 2))
    ei[:, 1, -3:] = N + 1  # outside the bag: dropped
    ei[:, 1] = np.where(ei[:, 1] == N - 1, 0, ei[:, 1])  # node N - 1 gets no edge
    ev = rng.random((Bn, E)) < 0.9
    m = torch.tensor(rng.random((Bn, N, D)) + 0.1, dtype=torch.float64, requires_grad=True)
    t = torch.tensor(1.3, dtype=torch.float64, requires_grad=True)
    edges = edge_lists(torch.from_numpy(ei), torch.from_numpy(ev), N)
    got = _aggregate(m, t, *edges)
    w_out = torch.from_numpy(rng.standard_normal((Bn, N, D)))
    g_m, g_t = torch.autograd.grad((got * w_out).sum(), (m, t))
    count = torch.zeros(Bn, N, N, dtype=torch.float64)  # [b, dst, src] edge multiplicity
    for b in range(Bn):
        for (s_, d_), v in zip(ei[b].T, ev[b]):
            if v and 0 <= d_ < N:
                count[b, d_, s_] += 1
    logits = t * m[:, None, :, :]  # [b, dst, src, D]
    ex = count[..., None] * torch.exp(logits - logits.amax(dim=2, keepdim=True))
    want = (ex * m[:, None]).sum(2) / ex.sum(2).clamp(min=1e-16)
    w_m, w_t = torch.autograd.grad((want * w_out).sum(), (m, t))
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(g_m, w_m, rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(g_t, w_t, rtol=1e-10, atol=1e-12)
    assert float(got.detach()[:, N - 1].abs().max()) == 0.0


def _stub_graphs(root):
    """A tg1 graph (attributes on the object, with edge_latent) and a tg2
    one (behind `_store`), pickled as torch_geometric's classes."""
    install_tg_unpickle_stubs()
    tgd = sys.modules["torch_geometric.data.data"]
    tgs = sys.modules["torch_geometric.data.storage"]
    rng = np.random.default_rng(1)
    ei = rng.integers(0, 50, size=(2, 120))
    g1 = tgd.Data.__new__(tgd.Data)
    g1.__dict__.update({"x": torch.zeros(50, 8), "edge_index": torch.tensor(ei),
                        "edge_latent": torch.tensor(ei[:, :40]),
                        "centroid": torch.zeros(50, 2)})
    torch.save(g1, str(root / "S1-slide.pt"))
    store = tgs.GlobalStorage.__new__(tgs.GlobalStorage)
    store.__dict__["_mapping"] = {"x": torch.zeros(30, 8),
                                  "edge_index": torch.tensor(ei[:, :60])}
    g2 = tgd.Data.__new__(tgd.Data)
    g2.__dict__["_store"] = store
    torch.save(g2, str(root / "S2-slide.pt"))
    return ei


def test_convert_graph_dir_matches_jax(tmp_path):
    src = tmp_path / "pt"
    src.mkdir()
    ei = _stub_graphs(src)
    assert convert_graph_dir(str(src), str(tmp_path / "port"), verbose=False) == 2
    assert jax_convert_graph_dir(str(src), str(tmp_path / "jax"), verbose=False) == 2
    with redirect_stdout(io.StringIO()):
        assert convert_main(["--graphs", "--src", str(src), "--dst", str(tmp_path / "cli")]) == 2
    for name in ("S1-slide.npz", "S2-slide.npz"):
        want = np.load(tmp_path / "jax" / name)
        for out in ("port", "cli"):
            got = np.load(tmp_path / out / name)
            assert sorted(got.files) == sorted(want.files)
            for k in want.files:
                assert got[k].dtype == want[k].dtype == np.int64
                np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(np.load(tmp_path / "port" / "S1-slide.npz")["edge_index"], ei)
    assert "edge_latent" not in np.load(tmp_path / "port" / "S2-slide.npz").files


def test_a_graph_without_edges_raises(tmp_path):
    install_tg_unpickle_stubs()
    tgd = sys.modules["torch_geometric.data.data"]
    g = tgd.Data.__new__(tgd.Data)
    g.__dict__["x"] = torch.zeros(3, 2)
    (tmp_path / "pt").mkdir()
    torch.save(g, str(tmp_path / "pt" / "S.pt"))
    with pytest.raises(ValueError, match="edge_index"):
        convert_graph_dir(str(tmp_path / "pt"), str(tmp_path / "npz"), verbose=False)


def _sa_run_config(tmp_path, network, mode, **changes):
    table, split = write_cohort(str(tmp_path))
    cdir, gdir = tmp_path / "clusters", tmp_path / "graphs"
    cdir.mkdir()
    gdir.mkdir()
    synth = "synthetic://N=40,D=32,seed=3"
    with open(table) as f:
        rows = [line.split(",") for line in f.read().splitlines()[1:]]
    for sid, pid, *_ in rows:
        n = synthetic_bag(sid, synth).shape[0]
        np.save(cdir / f"{pid}.npy", synthetic_cluster_ids(pid, n, 4))
        np.savez(gdir / f"{sid}.npz", edge_index=grid_edge_index(n))
    with open(os.path.join(REPO, "configs", "IFMLE", "tcga_blca", "cfg_sa_base_conch.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg = {k: (v[0] if isinstance(v, list) else v) for k, v in cfg.items()}
    cfg.update(path_patch=synth, path_table=table, data_split_path=split, data_split_seed=0,
               bp_every_batch=4, epochs=1, net_dims="32-16-4", deepmil_network=network,
               data_mode=mode, path_cluster=str(cdir), path_graph=str(gdir),
               deepmil_num_clusters=4, deepmil_num_layers=2, min_bucket=16,
               save_path=str(tmp_path / "run"), **changes)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.mark.parametrize("network,mode", [("DeepAttnMISL", "cluster"), ("PatchGCN", "graph")])
def test_main_trains_and_serve_answers(tmp_path, network, mode):
    cfg = _sa_run_config(tmp_path, network, mode)
    pipeline.reset_batch_counts()
    with redirect_stdout(io.StringIO()):
        port_main(["--config", cfg, "--handler", "SA", "--device", "cpu"])
    assert pipeline.BATCHES["native"] == 0 and pipeline.BATCHES["numpy"] > 0
    run = tmp_path / "run"
    assert (run / "train_model-last.ckpt").exists()
    with open(run / "metrics.jsonl") as f:
        evals = [json.loads(s) for s in f if '"eval"' in s]
    assert evals and all(np.isfinite(v) for e in evals for v in e.values()
                         if isinstance(v, float))
    with redirect_stdout(io.StringIO()):
        summary = serve_cli.main(["--config", cfg, "--n_requests", "2",
                                  "--bags_per_request", "3", "--device", "cpu"])
    assert summary["requests"] == 2


def test_a_bag_without_its_cluster_file_or_graph_dir_raises(cohort):
    meta, _jmeta, pids, _c, _g = cohort
    with pytest.raises(ValueError, match="path_cluster"):
        SurvBagDataset(pids, SYNTH, meta, mode="cluster")
    with pytest.raises(ValueError, match="data_mode"):
        SurvBagDataset(pids, SYNTH, meta, mode="coords")


# ---------------------------------------------------------------- the pool

class _Bags:
    """Bags of ragged lengths, so that batches meet several buckets."""
    mode = "patch"

    def __init__(self, lengths, D=24):
        self.lengths, self.D = lengths, D

    def __len__(self):
        return len(self.lengths)

    def __getitem__(self, i):
        rng = np.random.default_rng(i)
        return (rng.normal(size=(self.lengths[i], self.D)).astype(np.float32),
                np.array([i % 4, i % 2], np.float32))


def _lengths(n=40, seed=0):
    return np.random.default_rng(seed).integers(5, 700, size=n).tolist()


def _expected(ds, **kw):
    ref = BagBatcher(ds, batch_size=4, **kw)
    return [ref.make_batch(c) for c in ref.batch_indices()]


def _free_bytes(pool):
    return sum(b.numel() for b, _e in pool.free)


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("feats_dtype", ["float32", "int8"])
def test_pool_holds_prefetch_plus_two_slots(prefetch, feats_dtype):
    ds = _Bags(_lengths())
    kw = dict(min_bucket=16, feats_dtype=feats_dtype)
    want = _expected(ds, **kw)
    pool = BatchPool(page_locked=False)
    batcher = BagBatcher(ds, batch_size=4, prefetch=prefetch, pool=pool, **kw)
    made = None
    for epoch in range(4):
        buffers = set()
        for i, batch in enumerate(batcher):
            assert batch.buffer is not None
            buffers.add(batch.buffer.data_ptr())
            assert_same_batch(batch, want[i], f"epoch {epoch} batch {i}")
        del batch
        assert 1 <= len(buffers) <= prefetch + 2
        # every buffer is back in the pool at the end of the pass
        assert len(pool.free) <= prefetch + 2 and _free_bytes(pool) == pool.nbytes
        made = pool.buffers_made if made is None else made
    largest = max(pipeline.layout_bytes(
        [(k, tuple(v.shape), v.dtype) for k, v in b.items()
         if k in ("feats", "mask", "feats_scale", "feats_inv")]) for b in want)
    assert pool.largest == largest
    assert pool.peak_bytes <= (prefetch + 2) * largest
    assert all(b.numel() <= largest for b, _e in pool.free)
    # after the first epoch a buffer grows at most once more, to the largest batch
    assert pool.buffers_made - made <= len(pool.free)
    pool.release()
    assert pool.free == [] and pool.nbytes == 0


@pytest.mark.parametrize("prefetch", [0, 1, 3])
def test_pool_never_writes_over_the_consumers_batch(prefetch):
    """A slow consumer: the producer runs as far ahead as the ring lets it
    while the consumer holds a batch, and that batch keeps its values until
    the consumer asks for the next one."""
    ds = _Bags(_lengths(24, seed=1))
    want = _expected(ds, min_bucket=16)
    pool = BatchPool(page_locked=False)
    n = 0
    for i, batch in enumerate(BagBatcher(ds, batch_size=4, prefetch=prefetch, pool=pool,
                                         min_bucket=16)):
        held = {k: v.clone() for k, v in batch.items()}
        time.sleep(0.02)
        assert_same_batch(batch, held, f"batch {i} while held")
        assert_same_batch(batch, want[i], f"batch {i}")
        n += 1
    assert n == len(want) and len(pool.free) <= prefetch + 2


def test_pool_slots_serve_the_next_pass_and_a_stopped_one():
    ds = _Bags(_lengths(20, seed=2))
    pool = BatchPool(page_locked=False)
    batcher = BagBatcher(ds, batch_size=4, prefetch=2, pool=pool, min_bucket=16)
    for batch in batcher:
        break  # a consumer that stops early: its ring's buffers go back to the pool
    del batch
    n = len(pool.free)
    assert 1 <= n <= 4 and _free_bytes(pool) == pool.nbytes
    other = BagBatcher(ds, batch_size=4, prefetch=1, pool=pool, min_bucket=16)
    assert len(list(zip(range(3), other))) == 3
    assert len(pool.free) <= max(n, 3) and _free_bytes(pool) == pool.nbytes


def test_a_batch_made_on_its_own_owns_its_buffer():
    ds = _Bags([10, 20, 30])
    want = _expected(ds, min_bucket=16)
    pool = BatchPool(page_locked=False)
    batcher = BagBatcher(ds, batch_size=4, pool=pool, min_bucket=16)
    batch = batcher.make_batch(range(3))
    assert batch.buffer is not None and pool.nbytes == 0 and pool.free == []
    assert_same_batch(batch, want[0], "make_batch")


class _NpyBags(_Bags):
    """_Bags as .npy slide files, one a bag: the native path's batches."""

    def __init__(self, lengths, root):
        super().__init__(lengths)
        self.paths = [os.path.join(root, f"s{i}.npy") for i in range(len(lengths))]
        for i, path in enumerate(self.paths):
            np.save(path, super().__getitem__(i)[0])

    def bag_paths(self, i):
        return [self.paths[i]]

    def bag_label(self, i):
        return super().__getitem__(i)[1]


@pytest.mark.parametrize("prefetch", [0, 2])
def test_a_native_pass_sizes_its_buffers_to_its_largest_batch(tmp_path, prefetch):
    """Every batch on the native path: the pass reads the bags' lengths from
    the headers at its start, and each buffer it makes holds its largest
    batch, so none is made again in the pass or the next."""
    ds = _NpyBags(_lengths(24, seed=3), str(tmp_path))
    want = _expected(_Bags(ds.lengths), min_bucket=16)
    largest = max(pipeline.layout_bytes(
        [(k, tuple(v.shape), v.dtype) for k, v in b.items() if k in ("feats", "mask")])
        for b in want)
    pool = BatchPool(page_locked=False)
    batcher = BagBatcher(ds, batch_size=4, prefetch=prefetch, pool=pool, min_bucket=16)
    pipeline.reset_batch_counts()
    for epoch in range(2):
        for i, batch in enumerate(batcher):
            assert_same_batch(batch, want[i], f"epoch {epoch} batch {i}")
        del batch
    assert pipeline.BATCHES == {"native": 2 * len(want), "numpy": 0}
    assert pool.largest == largest
    assert all(b.numel() == largest for b, _e in pool.free)
    assert pool.buffers_made == len(pool.free) <= prefetch + 2


def test_pinned_batcher_uses_the_shared_pool():
    ds = _Bags([10, 20])
    assert BagBatcher(ds, batch_size=2, pin_memory=True).pool is pipeline.PINNED_POOL
    assert BagBatcher(ds, batch_size=2).pool is None
