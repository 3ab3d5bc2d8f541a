"""Checkpoints, resume and training control of the port's run lifecycle.

- the module filter drops exactly the top-level modules whose name contains
  it, as vlsa_tpu's `_filter_tree` drops its tree's top-level keys; loading
  is strict=False (filtered modules keep their values), an unknown entry
  raises;
- `auto_resume` restores the epoch, the parameters and Adam's moments bit
  for bit, and a resumed port run gives the next epoch's metrics of a
  resumed vlsa_tpu run within 1e-4 (the SA baseline of
  tests/test_torch_lifecycle.py, vlsa_tpu's ABMIL kernels in interpret mode);
- ReduceLROnPlateau and EarlyStopping follow vlsa_tpu's classes over fixed
  monitor sequences, and the scheduler writes each new rate into the
  optimizer;
- the prediction CSV is written byte for byte as vlsa_tpu's pandas writes it;
- `jax_tree_from_state_dict` inverts `state_dict_from_jax`.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch
from torch import nn

from test_torch_lifecycle import (COHORT_SEED, jax_abmil_interpret, jax_initial_state,
                                  lifecycle_cfg, read_events, write_cohort)
from vlsa_tpu.data.io import save_prediction_surv as jax_save_prediction_surv
from vlsa_tpu.optim import EarlyStopping as JaxEarlyStopping
from vlsa_tpu.optim import ReduceLROnPlateau as JaxReduceLROnPlateau
from vlsa_tpu.runner import SAHandler as JaxSAHandler
from vlsa_tpu.runner.ckpt import _filter_tree
from vlsa_tpu_torch.data.io import save_prediction_surv
from vlsa_tpu_torch.optim import EarlyStopping, ReduceLROnPlateau
from vlsa_tpu_torch.runner.ckpt import (filter_state, load_checkpoint, merge_state,
                                        save_checkpoint)
from vlsa_tpu_torch.runner.sa import SAHandler
from vlsa_tpu_torch.utils.weights import _flatten, jax_tree_from_state_dict, state_dict_from_jax

TOL_METRIC = 1e-4


class Toy(nn.Module):
    """Top-level modules whose names do and do not contain the filter, and
    a nested one that does."""

    def __init__(self):
        super().__init__()
        self.prompt_encoder = nn.LayerNorm(4)
        self.prompt_encoder_extra = nn.Linear(4, 4)
        self.mil_encoder = nn.Sequential()
        self.mil_encoder.add_module("prompt_encoder", nn.Linear(4, 3))
        self.logit_scale = nn.Parameter(torch.tensor(2.5))


def test_filter_drops_only_top_level_modules_named_by_it():
    sd = Toy().state_dict()
    kept = filter_state(sd, "prompt_encoder")
    assert sorted(kept) == ["logit_scale", "mil_encoder.prompt_encoder.bias",
                            "mil_encoder.prompt_encoder.weight"]
    tree = jax_tree_from_state_dict(sd)
    assert set(_filter_tree(tree, "prompt_encoder")) == set(jax_tree_from_state_dict(kept))
    assert filter_state(sd, None) == sd


def test_strict_false_load_keeps_filtered_modules_and_refuses_unknown(tmp_path):
    torch.manual_seed(0)
    a, b = Toy(), Toy()
    path = str(tmp_path / "m.ckpt")
    save_checkpoint(path, 3, a, module_filter="prompt_encoder")
    ckpt = load_checkpoint(path)
    assert ckpt["epoch"] == 3 and "optimizer" not in ckpt
    before = {k: v.clone() for k, v in b.state_dict().items()}
    merge_state(b, ckpt["model"])
    for k, v in b.state_dict().items():
        want = a.state_dict()[k] if k in ckpt["model"] else before[k]
        assert torch.equal(v, want), k
    with pytest.raises(KeyError, match="lacks"):
        merge_state(b, dict(ckpt["model"], **{"head.weight": torch.zeros(2)}))


def test_scheduler_and_early_stopping_follow_jax():
    monitors = [3.0, 2.5, 2.5, 2.6, 2.49, 2.49, -1.0, -1.0, -0.9, 4.0, 4.0, 4.0]
    for patience in (0, 1, 2):
        model = nn.Linear(2, 2)
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        ours = ReduceLROnPlateau(1e-3, factor=0.5, patience=patience, verbose=False,
                                 optimizer=opt)
        theirs = JaxReduceLROnPlateau(1e-3, factor=0.5, patience=patience, verbose=False)
        for m in monitors:
            lr = ours.step(m)
            assert lr == theirs.step(m)
            assert opt.param_groups[0]["lr"] == lr
    for warmup, patience, start in ((0, 2, 0), (2, 1, 0), (0, 1, 5)):
        ours = EarlyStopping(warmup=warmup, patience=patience, start_epoch=start)
        theirs = JaxEarlyStopping(warmup=warmup, patience=patience, start_epoch=start)
        for epoch, m in enumerate(monitors):
            ours(epoch, m)
            theirs(epoch, m)
            assert (ours.save_ckpt(), ours.stop(), ours.counter) == \
                (theirs.save_ckpt(), theirs.stop(), theirs.counter)


@pytest.mark.parametrize("kind", ["incidence", "hazard", "single"])
def test_prediction_csv_is_pandas_byte_for_byte(tmp_path, kind):
    rng = np.random.default_rng(0)
    n, k = 9, 1 if kind == "single" else 5
    y = np.stack([rng.integers(0, 5, n), rng.random(n) < 0.6], 1).astype(np.float32)
    if kind == "single":
        pred = rng.normal(size=(n, 1)).astype(np.float32)
    else:
        logits = rng.normal(size=(n, k)) * 3
        pred = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(np.float32)
        pred[0] = [1e-9, 0.5, 0.25, 0.125, 0.125 - 1e-9]  # small and near-zero values
    type_pred = "VL-IF" if kind == "incidence" else "NLL"
    pids = [f"TCGA-{i:02d}" for i in range(n)]
    save_prediction_surv(pids, y, pred, str(tmp_path / "port.csv"), type_pred=type_pred)
    jax_save_prediction_surv(pids, y, pred, str(tmp_path / "jax.csv"), type_pred=type_pred)
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()


def test_weight_bridge_round_trip():
    """A DeepMIL tree and CoCa's caption decoder (`resblock_<i>` and
    `cross_<i>` scopes) go to the port's names and back unchanged."""
    import jax.numpy as jnp

    from vlsa_tpu.models import load_model as jax_load_model
    from vlsa_tpu.models.multimodal import MultimodalDecoder as JaxDecoder
    from vlsa_tpu_torch.models.multimodal import MultimodalDecoder

    _m, params = jax_load_model("DeepMIL", [64, 32, 4], rng=jax.random.PRNGKey(0),
                                network="ABMIL", pooling="attention", use_feat_proj=True)
    dec = dict(width=32, heads=4, layers=2, context_length=24, output_dim=64)
    decoder = JaxDecoder(**dec).init(jax.random.PRNGKey(1), jnp.zeros((1, 6, 32)),
                                     jnp.zeros((1, 5, 32)))["params"]
    for params in (params, decoder):
        tree = jax.tree.map(np.asarray, dict(params))
        back = jax_tree_from_state_dict(state_dict_from_jax(tree))
        a, b = dict(_flatten(tree)), dict(_flatten(back))
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    MultimodalDecoder(**dec).load_state_dict(
        state_dict_from_jax(jax.tree.map(np.asarray, dict(decoder))), strict=True)


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """The SA baseline with auto_resume: 2 epochs, then the same run asked
    for 3, in both packages from the same initial weights."""
    root = tmp_path_factory.mktemp("resume")
    table, split = write_cohort(str(root), seed=COHORT_SEED["sa"])
    out = {}
    with jax_abmil_interpret():
        cfg = lifecycle_cfg("sa", root, table, split, root / "jax", auto_resume=True)
        first = JaxSAHandler(dict(cfg))
        init = jax_initial_state(first)
        first.exec()
        JaxSAHandler(dict(cfg, epochs=3)).exec()
    out["jax"] = cfg["save_path"]
    cfg = lifecycle_cfg("sa", root, table, split, root / "port", auto_resume=True)
    first = SAHandler(dict(cfg), device="cpu", state_dict=init)
    first.exec()
    second = SAHandler(dict(cfg, epochs=3), device="cpu", state_dict=init)
    second.exec()
    out["port"] = cfg["save_path"]
    return out, first, second, dict(cfg)


def test_auto_resume_restores_epoch_weights_and_moments_bit_for_bit(resumed):
    """A new handler resumed from the 3-epoch run's last checkpoint holds
    that run's final parameters and Adam state exactly; the 2-epoch run
    took 3 steps an epoch (21 training bags, 8 a step)."""
    _paths, first, second, cfg = resumed
    assert first.optimizer.state_dict()["state"][0]["step"] == 2 * 3
    handler = SAHandler(dict(cfg, save_path=cfg["save_path"] + "-check"), device="cpu")
    handler.last_ckpt_path = os.path.join(cfg["save_path"], "model-last.ckpt")
    assert handler.resume_model("last", "train") == 3
    for k, v in handler.model.state_dict().items():
        assert torch.equal(v, second.model.state_dict()[k]), k
    ours, want = handler.optimizer.state_dict(), second.optimizer.state_dict()
    assert ours["param_groups"] == want["param_groups"]
    assert ours["state"].keys() == want["state"].keys()
    for i, s in want["state"].items():
        for name in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(ours["state"][i][name], s[name]), (i, name)
    assert int(want["state"][0]["step"]) == 3 * 3


def test_resumed_run_matches_jax_next_epoch(resumed):
    paths, _first, _second, _cfg = resumed
    events = {k: read_events(p) for k, p in paths.items()}
    epochs = {k: [e["epoch"] for e in ev if e["event"] == "epoch"] for k, ev in events.items()}
    assert epochs["port"] == epochs["jax"] == [1, 2, 3]
    evals = {k: [e for e in ev if e["event"] == "eval"] for k, ev in events.items()}
    assert len(evals["port"]) == len(evals["jax"])
    third = [e for e in evals["jax"] if e["at"] == "3"]
    assert len(third) == 3  # train, validation, test of the resumed epoch
    for want, got in zip(evals["jax"], evals["port"]):
        assert want.keys() == got.keys() and want["at"] == got["at"]
        for k, v in want.items():
            if k not in ("event", "at", "ts"):
                assert abs(got[k] - v) <= TOL_METRIC, (want["at"], k)
    assert json.dumps(sorted(os.listdir(paths["port"]))) == \
        json.dumps(sorted(os.listdir(paths["jax"])))
