"""The SA baseline at 1024-d features (UNI, ResNet-50 truncated, CLIP-RN50:
net_dims 1024-256-K, DeepMIL's own default width), on the CPU:

- a DeepMIL/ABMIL at 1024-256-4 trained 5 steps in both packages on the
  same batches, as tests/test_torch_sa_train.py does at 512-32-4: vlsa_tpu's
  `TrainEngine(uses_vl=False)` with its ABMIL Pallas kernels in interpret
  mode against the port's plain pooling under autograd, from the parameters
  vlsa_tpu initialises, carried over by the bridge; the same tolerances
  (per-step loss 1e-4 relative; final parameters |a-b| <= 1e-5 + 1e-4 |b|);
- the training CLI from 1024-d `.npy` and `.q8npz` stores of fold 0's
  slides, written from synthetic bags and converted by `data.convert`;
  `python -m vlsa_tpu_torch.main --handler SA` for one epoch from the
  `.q8npz` store (int8 features, as the card's phase 3k runs it); the
  serving CLI on synthetic 1024-d bags; and the native loader
  (native/bagloader.cpp), which takes a store's column count from each
  `.npy` header, against the numpy path at 1024 columns, byte for byte.
"""
import functools
import io
import os
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import vlsa_tpu.ops.abmil as jax_abmil
from test_torch_sa_train import (K, LOSSES, LR, NET, SA_CFG, STEPS, WD, WEIGHTS, _batches,
                                 _json_lines)
from vlsa_tpu.losses import load_loss as jax_load_loss
from vlsa_tpu.models import load_model as jax_load_model
from vlsa_tpu.optim import create_optimizer as jax_create_optimizer
from vlsa_tpu.runner.engine import TrainEngine as JaxTrainEngine
from vlsa_tpu.runner.engine import make_objective as jax_make_objective
from vlsa_tpu.runner.engine import make_output_converter as jax_converter
from vlsa_tpu_torch import main as main_cli
from vlsa_tpu_torch.config import training_config
from test_torch_native_loader import _numpy_only, assert_same_batch
from vlsa_tpu_torch.data import pipeline
from vlsa_tpu_torch.data.bags import SurvBagDataset
from vlsa_tpu_torch.data.convert import convert_dir
from vlsa_tpu_torch.data.label_converter import MetaSurvData
from vlsa_tpu_torch.data.pipeline import BagBatcher
from vlsa_tpu_torch.data.splits import read_file_data_splitting
from vlsa_tpu_torch.data.io import synthetic_bag
from vlsa_tpu_torch.losses import load_loss
from vlsa_tpu_torch.models.registry import load_model
from vlsa_tpu_torch.ops import abmil
from vlsa_tpu_torch.optim import create_optimizer
from vlsa_tpu_torch.runner import serve as serve_cli
from vlsa_tpu_torch.runner import train as train_cli
from vlsa_tpu_torch.runner.engine import TrainEngine, make_objective, make_output_converter
from vlsa_tpu_torch.utils.weights import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 1024
DIMS = [D, 256, K]
STORE_BAGS = f"synthetic://N=24,D={D},seed=7"


@pytest.fixture(scope="module")
def jax_run():
    """(initial state dict, per-step losses, final state dict) of vlsa_tpu's
    TrainEngine on the Pallas kernels in interpret mode, at 1024-256-4."""
    old_interpret, old_pool = jax_abmil.INTERPRET, jax_abmil.abmil_pool
    jax_abmil.INTERPRET = True
    jax_abmil.abmil_pool = functools.partial(old_pool, use_pallas=True)
    try:
        jmodel, params = jax_load_model("DeepMIL", DIMS, rng=jax.random.PRNGKey(0), **NET)
        params = jax.tree.map(np.asarray, dict(params))
        init = state_dict_from_jax(params)
        tx = jax_create_optimizer("adam", LR, WD, params)
        objective = jax_make_objective(jax_load_loss("sa", **LOSSES), WEIGHTS,
                                       jax_converter("softmax"), uses_vl=False)
        step = JaxTrainEngine(jmodel, tx, objective, uses_vl=False).train_step()
        p, state, losses = jax.tree.map(jnp.asarray, params), tx.init(params), []
        for i, b in enumerate(_batches(D=D)):
            p, state, loss, _raw = step(p, state, {k: jnp.asarray(v) for k, v in b.items()},
                                        jax.random.PRNGKey(i))
            losses.append(float(loss))
        return init, np.array(losses), state_dict_from_jax(jax.tree.map(np.asarray, p))
    finally:
        jax_abmil.INTERPRET, jax_abmil.abmil_pool = old_interpret, old_pool


def test_five_steps_at_1024_match_jax_train_engine(jax_run):
    init, jax_losses, jax_final = jax_run
    assert init["sigma.fc1_kernel"].shape == (D, 256)
    model = load_model("DeepMIL", DIMS, device="cpu", state_dict=init, **NET)
    model.train()
    objective = make_objective(load_loss("sa", **LOSSES), WEIGHTS,
                               make_output_converter("softmax"))
    engine = TrainEngine(model, create_optimizer("adam", LR, WD, model), objective)
    abmil.reset_launches()
    losses = [float(engine.train_step({k: torch.from_numpy(v) for k, v in b.items()})[0])
              for b in _batches(D=D)]
    assert sum(abmil.LAUNCHES.values()) + sum(abmil.LAUNCHES_BWD.values()) == 0
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4)
    final = model.state_dict()
    assert set(final) == set(jax_final) == set(init)
    for name, got in final.items():
        got, want = got.numpy(), jax_final[name].numpy()
        ok = np.abs(got - want) <= 1e-5 + 1e-4 * np.abs(want)
        assert np.all(ok), f"{name}: max |a-b| {np.abs(got - want)[~ok].max():.3e}"
        if name == "sigma.fc2_bias":
            np.testing.assert_array_equal(got, init[name].numpy())
        else:
            assert not np.array_equal(got, init[name].numpy()), name


# ---- the CLIs at 1024-d ----

@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """Fold 0's label table's slides as 1024-d bags of N ~24: a `.npy` store
    and its `.q8npz` conversion."""
    root = tmp_path_factory.mktemp("sa1024_stores")
    with open(SA_CFG) as f:
        table = os.path.join(REPO, training_config(yaml.safe_load(f), 0)["path_table"])
    with open(table) as f:
        sids = sorted({line.split(",")[0] for line in f.read().splitlines()[1:]})
    npy = str(root / "npy")
    os.makedirs(npy)
    for sid in sids:
        np.save(os.path.join(npy, sid + ".npy"), synthetic_bag(sid, STORE_BAGS))
    q8 = str(root / "q8npz")
    convert_dir(npy, q8, dtype="int8", verbose=False)
    return {"npy": npy, "q8npz": q8}


def _sa_1024_config(tmp_path, **changes) -> str:
    """A copy of the shipped SA config at net_dims 1024-256-4, its grid
    lists resolved to their first value (a run without --multi_run takes
    scalars)."""
    with open(SA_CFG) as f:
        cfg = {k: v[0] if isinstance(v, list) else v for k, v in yaml.safe_load(f).items()}
    cfg.update(net_dims=f"{D}-256-4", bp_every_batch=8,
               path_table=os.path.join(REPO, cfg["path_table"]),
               data_split_path=os.path.join(REPO, cfg["data_split_path"]), **changes)
    path = tmp_path / "cfg_sa_1024.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.mark.parametrize("store, feats_dtype", [("npy", "float32"), ("q8npz", "int8")])
def test_train_cli_trains_sa_1024_from_a_store(tmp_path, stores, store, feats_dtype):
    buf = io.StringIO()
    cfg = _sa_1024_config(tmp_path, path_patch=stores[store], feat_format=store,
                          feats_dtype=feats_dtype)
    pipeline.reset_batch_counts()
    with redirect_stdout(buf):
        summary = train_cli.main(["--config", cfg, "--steps", "2", "--device", "cpu"])
    assert pipeline.BATCHES["numpy"] == 0 and pipeline.BATCHES["native"] >= 2
    lines = _json_lines(buf)
    assert [r["step"] for r in lines[:2]] == [0, 1] and lines[-1] == summary
    assert all(np.isfinite(r["loss"]) and r["bags"] == 8 for r in lines[:2])
    assert summary["num_bins"] == 12 and summary["train_bags"] == 298
    assert summary["feats_dtype"] == feats_dtype
    assert sum(summary["abmil_launches"].values()) == 0  # the CPU path launches nothing


def test_main_runs_sa_1024_from_the_q8npz_store(tmp_path, stores):
    """`python -m vlsa_tpu_torch.main --handler SA` for one epoch at
    1024-256-12 from the int8 store: finite metrics, the checkpoint of a
    1024-wide bottleneck, test predictions of the 75 test patients."""
    save = tmp_path / "run"
    cfg = _sa_1024_config(tmp_path, path_patch=stores["q8npz"], feat_format="q8npz",
                          feats_dtype="int8", epochs=1, save_path=str(save))
    with redirect_stdout(io.StringIO()):
        main_cli.main(["--config", cfg, "--handler", "SA", "--device", "cpu"])
    with open(save / "config.yaml") as f:
        assert yaml.safe_load(f)["net_dims"] == f"{D}-256-12"
    state = torch.load(save / "train_model-last.ckpt", map_location="cpu", weights_only=False)
    state = state.get("model", state)
    assert tuple(state["sigma.fc1_kernel"].shape) == (D, 256)
    with open(save / "train_metrics-last.txt") as f:
        text = f.read()
    assert "c_index" in text and "nan" not in text.lower()
    rows = (save / "sa_train_last_pred_test.csv").read_text().splitlines()
    assert len(rows) == 1 + 75


def test_serve_cli_serves_sa_1024(tmp_path):
    buf = io.StringIO()
    cfg = _sa_1024_config(tmp_path, path_patch=f"synthetic://N=48,D={D},seed=7")
    with redirect_stdout(buf):
        summary = serve_cli.main(["--config", cfg, "--n_requests", "2",
                                  "--bags_per_request", "3", "--device", "cpu"])
    lines = _json_lines(buf)
    assert [r["request"] for r in lines[:2]] == [0, 1] and lines[-1] == summary
    assert all(len(r["risk"]) == 3 and np.all(np.isfinite(r["risk"])) for r in lines[:2])
    assert sum(summary["abmil_launches"].values()) == 0
    assert serve_cli.sa_serving_config(yaml.safe_load(open(cfg)))["net_dims"] == f"{D}-256-12"


@pytest.mark.parametrize("store, feats_dtype", [("npy", "float32"), ("npy", "bfloat16"),
                                                ("q8npz", "int8")])
def test_native_loader_reads_1024_columns(stores, store, feats_dtype):
    """One batch of 16 test patients of each 1024-d store, built by the
    native loader and by the numpy path: the same bytes, 1024 columns."""
    cfg = training_config(yaml.safe_load(open(SA_CFG)), 0)
    split = read_file_data_splitting(os.path.join(REPO, cfg["data_split_path"]))
    meta = MetaSurvData(os.path.join(REPO, cfg["path_table"]), data_split=split)
    meta.generate_discrete_label(use_quantiles=False)
    pids = split["test"][:16]
    kw = dict(batch_size=16, feats_dtype=feats_dtype, prefetch=0)
    pipeline.reset_batch_counts()
    native = BagBatcher(SurvBagDataset(pids, stores[store], meta, read_format=store),
                        **kw).make_batch(range(16))
    plain = BagBatcher(_numpy_only(SurvBagDataset(pids, stores[store], meta,
                                                  read_format=store)), **kw).make_batch(range(16))
    assert pipeline.BATCHES == {"native": 1, "numpy": 1}
    assert native["feats"].shape[-1] == D
    assert_same_batch(native, plain, f"{store} {feats_dtype}")
