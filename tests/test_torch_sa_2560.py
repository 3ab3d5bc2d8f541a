"""The SA baseline at 2560-d features (Virchow and Virchow2 tile embeddings:
a 1280-d class token beside a 1280-d mean patch token), net_dims
2560-256-K, on the CPU:

- a DeepMIL/ABMIL at 2560-256-4 trained 5 steps in both packages on the
  same batches, as tests/test_torch_sa_1024.py does at 1024-256-4:
  vlsa_tpu's `TrainEngine(uses_vl=False)` with its ABMIL Pallas kernels in
  interpret mode against the port's plain pooling under autograd, from the
  parameters vlsa_tpu initialises, carried over by the bridge; the same
  tolerances (per-step loss 1e-4 relative; final parameters |a-b| <= 1e-5 +
  1e-4 |b|);
- the serving CLI on synthetic 2560-d bags (fold 0's bins: 2560-256-12).
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
from test_torch_sa_train import K, LOSSES, LR, NET, SA_CFG, WD, WEIGHTS, _batches, _json_lines
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
from vlsa_tpu_torch.runner.engine import TrainEngine, make_objective, make_output_converter
from vlsa_tpu_torch.utils.weights import state_dict_from_jax

D = 2560
DIMS = [D, 256, K]


@pytest.fixture(scope="module")
def jax_run():
    """(initial state dict, per-step losses, final state dict) of vlsa_tpu's
    TrainEngine on the Pallas kernels in interpret mode, at 2560-256-4."""
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


def test_five_steps_at_2560_match_jax_train_engine(jax_run):
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


def _sa_2560_config(tmp_path) -> str:
    """A scalar copy of the shipped SA config at net_dims 2560-256-4 on
    synthetic 2560-d bags."""
    with open(SA_CFG) as f:
        cfg = {k: v[0] if isinstance(v, list) else v for k, v in yaml.safe_load(f).items()}
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg.update(net_dims=f"{D}-256-4", bp_every_batch=8,
               path_patch=f"synthetic://N=48,D={D},seed=7",
               path_table=os.path.join(repo, cfg["path_table"]),
               data_split_path=os.path.join(repo, cfg["data_split_path"]))
    path = tmp_path / "cfg_sa_2560.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_serve_cli_serves_sa_2560(tmp_path):
    buf = io.StringIO()
    cfg = _sa_2560_config(tmp_path)
    with redirect_stdout(buf):
        summary = serve_cli.main(["--config", cfg, "--n_requests", "2",
                                  "--bags_per_request", "3", "--device", "cpu"])
    lines = _json_lines(buf)
    assert [r["request"] for r in lines[:2]] == [0, 1] and lines[-1] == summary
    assert all(len(r["risk"]) == 3 and np.all(np.isfinite(r["risk"])) for r in lines[:2])
    assert sum(summary["abmil_launches"].values()) == 0
    assert serve_cli.sa_serving_config(yaml.safe_load(open(cfg)))["net_dims"] == f"{D}-256-12"
