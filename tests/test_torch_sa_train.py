"""The SA slice as a whole: a small DeepMIL/ABMIL (D=512, hid 32) trained
for 5 steps in both packages on the same batches, then both CLIs on a small
copy of configs/IFMLE/tcga_blca/cfg_sa_base_conch.yaml.

vlsa_tpu builds the model and initialises its parameters; the bridge
(vlsa_tpu_torch.utils.weights) carries them into the port.  Both take 5 Adam
steps (lr 2e-4, weight decay 1e-5) of SurvIFMLE on the same ragged f32
batches made with numpy, the last with a padded row.  The JAX side is
`TrainEngine(uses_vl=False)` with its ABMIL Pallas kernels in interpret mode
(as tests/test_models.py runs them; its CPU default would take the plain
pooling, whose b2 gets a rounding-noise gradient that Adam turns into
+-lr steps); the port takes its plain version under autograd.

Tolerances: per-step loss 1e-4 relative; final parameters |a-b| <= 1e-5 +
1e-4 |b| (f32 on both sides; the kernel's online softmax and the plain
version sum in another order, carried through 5 Adam steps).  fc2_bias
cancels in the softmax: it gets no gradient and no decay (1-D), so it stays
exactly as initialised on both sides.
"""
import functools
import io
import json
import os
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import vlsa_tpu.ops.abmil as jax_abmil
from vlsa_tpu.losses import load_loss as jax_load_loss
from vlsa_tpu.models import load_model as jax_load_model
from vlsa_tpu.optim import create_optimizer as jax_create_optimizer
from vlsa_tpu.runner.engine import TrainEngine as JaxTrainEngine
from vlsa_tpu.runner.engine import make_objective as jax_make_objective
from vlsa_tpu.runner.engine import make_output_converter as jax_converter
from vlsa_tpu_torch.losses import load_loss
from vlsa_tpu_torch.models.registry import load_model
from vlsa_tpu_torch.ops import abmil
from vlsa_tpu_torch.optim import create_optimizer
from vlsa_tpu_torch.runner import serve as serve_cli
from vlsa_tpu_torch.runner import train as train_cli
from vlsa_tpu_torch.runner.engine import TrainEngine, make_objective, make_output_converter
from vlsa_tpu_torch.utils.weights import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SA_CFG = os.path.join(REPO, "configs", "IFMLE", "tcga_blca", "cfg_sa_base_conch.yaml")
LR, WD, STEPS, K = 2e-4, 1e-5, 5, 4
DIMS = [512, 32, K]
NET = dict(network="ABMIL", pooling="attention", use_feat_proj=False)
LOSSES = {"loss_type": ["SurvIFMLE"], "SurvIFMLE": {}}
WEIGHTS = {"SurvIFMLE": 1.0}


def _batches(n=STEPS, B=4, N=256, D=512, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for s in range(n):
        lengths = rng.integers(N // 4, N + 1, size=B)
        feats = np.zeros((B, N, D), np.float32)
        mask = np.zeros((B, N), bool)
        for j, length in enumerate(lengths):
            feats[j, :length] = rng.normal(size=(length, D))
            mask[j, :length] = True
        valid = np.ones(B, bool)
        if s == n - 1:  # a ragged tail batch: the last row is padding
            valid[-1] = False
            feats[-1], mask[-1] = 0.0, False
        out.append({"feats": feats, "mask": mask,
                    "t": rng.integers(0, K, size=B).astype(np.float32),
                    "e": (rng.random(B) < 0.6).astype(np.float32), "valid": valid})
    return out


@pytest.fixture(scope="module")
def jax_run():
    """(initial state dict, per-step losses, final state dict) of vlsa_tpu's
    TrainEngine on the Pallas kernels in interpret mode."""
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
        for i, b in enumerate(_batches()):
            p, state, loss, _raw = step(p, state, {k: jnp.asarray(v) for k, v in b.items()},
                                        jax.random.PRNGKey(i))
            losses.append(float(loss))
        return init, np.array(losses), state_dict_from_jax(jax.tree.map(np.asarray, p))
    finally:
        jax_abmil.INTERPRET, jax_abmil.abmil_pool = old_interpret, old_pool


def test_five_steps_match_jax_train_engine(jax_run):
    init, jax_losses, jax_final = jax_run
    model = load_model("DeepMIL", DIMS, device="cpu", state_dict=init, **NET)
    model.train()
    objective = make_objective(load_loss("sa", **LOSSES), WEIGHTS,
                               make_output_converter("softmax"))
    engine = TrainEngine(model, create_optimizer("adam", LR, WD, model), objective)
    assert not engine.uses_vl
    abmil.reset_launches()
    losses = [float(engine.train_step({k: torch.from_numpy(v) for k, v in b.items()})[0])
              for b in _batches()]
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
            np.testing.assert_array_equal(want, init[name].numpy())
        else:
            assert not np.array_equal(got, init[name].numpy()), name


def _small_sa_config(tmp_path) -> str:
    with open(SA_CFG) as f:
        cfg = yaml.safe_load(f)
    cfg.update(path_patch="synthetic://N=48,D=512,seed=7", bp_every_batch=4,
               path_table=os.path.join(REPO, cfg["path_table"]),
               data_split_path=os.path.join(REPO, cfg["data_split_path"]))
    path = tmp_path / "cfg_sa.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _json_lines(buf):
    return [json.loads(s) for s in buf.getvalue().splitlines() if s.startswith("{")]


def test_train_cli_trains_sa_on_the_cpu(tmp_path):
    buf = io.StringIO()
    with redirect_stdout(buf):
        summary = train_cli.main(["--config", _small_sa_config(tmp_path), "--steps", "2",
                                  "--device", "cpu"])
    lines = _json_lines(buf)
    assert [r["step"] for r in lines[:2]] == [0, 1] and lines[-1] == summary
    assert all(np.isfinite(r["loss"]) and r["bags"] == 4 for r in lines[:2])
    assert summary["num_bins"] == 12 and summary["train_bags"] == 298
    assert summary["feats_dtype"] == "float32"  # the SA config sets no feats_dtype
    assert sum(summary["abmil_launches"].values()) == 0  # the CPU path launches nothing
    assert sum(summary["abmil_bwd_launches"].values()) == 0


def test_serve_cli_serves_sa_on_the_cpu(tmp_path):
    buf = io.StringIO()
    with redirect_stdout(buf):
        summary = serve_cli.main(["--config", _small_sa_config(tmp_path), "--n_requests", "2",
                                  "--bags_per_request", "3", "--device", "cpu"])
    lines = _json_lines(buf)
    assert [r["request"] for r in lines[:2]] == [0, 1] and lines[-1] == summary
    assert all(len(r["risk"]) == 3 and np.all(np.isfinite(r["risk"])) for r in lines[:2])
    assert sum(summary["abmil_launches"].values()) == 0


def test_sa_serving_takes_fold_0_bins(tmp_path):
    """The served head gets fold 0's bin count (12 for TCGA-BLCA), not the
    config's placeholder 4, and a listed grid value of a model key raises."""
    cfg = serve_cli.sa_serving_config(yaml.safe_load(open(_small_sa_config(tmp_path))))
    assert cfg["net_dims"] == "512-256-12"
    engine = serve_cli.make_engine(cfg, device="cpu")
    assert engine.model.g.weight.shape == (12, 512)
    assert engine.text_precompute() is None
    bad = dict(yaml.safe_load(open(SA_CFG)), deepmil_network=["ABMIL", "MaxMIL"])
    with pytest.raises(ValueError, match="deepmil_network"):
        serve_cli.sa_serving_config(bad)
