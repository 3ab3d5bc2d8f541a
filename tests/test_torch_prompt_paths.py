"""The prompt paths beside the flagship's live CoOp learner, in both
packages, with the text tower imported from a written CONCH checkpoint
(the same file for vlsa_tpu and the port):

  * the Adapter learner (PromptAdapter over the template prompts, its
    TaskRes and bottleneck heads), on tests/test_runner_modes.py::
    test_vlsa_adapter_learner's config, as a model and as a whole run;
  * the CoOp warm start from a reference-format training checkpoint that
    the test writes, its path formatted by fold and method;
  * the frozen-CoOp precompute: with both embeddings frozen, the prompts
    encoded once, and neither the tower nor the learner in the state dict;
  * `path_clip_model`'s three layouts, and the freeze flags of each path.

Every port model is built from vlsa_tpu's parameter tree through the
bridge with strict=True.  Tolerances (max|a-b| / max|b|): text features
1e-5 (f32 on both sides, summed in another order), 2e-3 with the bf16
tower (ROADMAP §C); logits 1e-4 (as tests/test_torch_vlsa.py); the run's
metrics 1e-4 and CSVs 1e-5 (as tests/test_torch_lifecycle.py).
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_runner_e2e import make_cohort, vlsa_cfg
from test_torch_lifecycle import read_csv
from test_torch_weights_import import write_conch_checkpoint
from test_torch_zero_shot import assert_events_match, assert_losses_match, record_passes
from vlsa_tpu.models.vlsa_build import build_vlsa as jax_build_vlsa
from vlsa_tpu.runner import VLSAHandler as JaxVLSAHandler
from vlsa_tpu.utils.torch_import import import_text_tower_from_checkpoint as jax_import_tower
from vlsa_tpu_torch.runner import vlsa as port_vlsa
from vlsa_tpu_torch.runner.train import frozen_paths
from vlsa_tpu_torch.runner.vlsa import VLSAHandler
from vlsa_tpu_torch.utils.weights import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_TEXT = {"float32": 1e-5, "bfloat16": 2e-3}
TOL_LOGITS, TOL_METRIC, TOL_PRED = 1e-4, 1e-4, 1e-5
TEMPLATES = "vlsa_tpu/assets/tools/survival_template_prompts.json"


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def model_cfg(tmp_path, **changes):
    """test_vlsa_adapter_learner's surface (VLFAN at width 64, 12 TaskRes
    text queries, the small tower of output 64) on a 24-patient cohort,
    the tower from a checkpoint written under `tmp_path/conch`."""
    ckpt_dir = tmp_path / "conch"
    if not (ckpt_dir / "pytorch_model.bin").exists():
        write_conch_checkpoint(ckpt_dir / "pytorch_model.bin")
    table, split = make_cohort(tmp_path, n_patients=24)
    cfg = vlsa_cfg(tmp_path, table, split)
    cfg.update(path_clip_model=str(ckpt_dir), save_path=str(tmp_path / "result"),
               _test_tower_overrides=dict(cfg["_test_tower_overrides"], dtype="float32"))
    cfg.update(changes)
    return cfg


ADAPTER = {"time_bins": 4, "vlsa_pmt_learner_name": "Adapter",
           "vlsa_pmt_learner_adapter_method": "TaskRes",
           "vlsa_pmt_learner_adapter_num_ranks": None,
           "vlsa_pmt_learner_adapter_res_ratio": 0.5,
           "vlsa_pmt_learner_adapter_init_prompt_path": TEMPLATES,
           "vlsa_pmt_learner_adapter_init_prompt_rank_idx": 0,
           "vlsa_pmt_learner_adapter_init_prompt_context_idx": 0, "epochs": 1}


def build_pair(cfg):
    """vlsa_tpu's handler-built model and the port's from its tree."""
    jh = JaxVLSAHandler(copy.deepcopy(cfg))
    jparams = jax.tree.map(np.asarray, dict(jh.params))
    sd = state_dict_from_jax(jparams)
    model = port_vlsa.build_model(copy.deepcopy(jh.cfg), device="cpu", state_dict=sd)
    return jh, jparams, model, sd


def jax_text(jh, jparams):
    return np.asarray(jh.model.apply({"params": jparams}, method=jh.model.forward_text_only))


def assert_logits_match(jh, jparams, model, D=64):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 150, D)).astype(np.float32)
    mask = np.ones((3, 150), bool)
    mask[1, 90:] = False
    want = np.asarray(jh.model.apply({"params": jparams}, jnp.asarray(x), jnp.asarray(mask))[0])
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(mask))[0].numpy()
    assert _rel(got, want) <= TOL_LOGITS


@pytest.mark.parametrize("method", ["TaskRes", "Adapter"])
def test_adapter_learner_matches_jax(tmp_path, method):
    cfg = model_cfg(tmp_path, **dict(ADAPTER, vlsa_pmt_learner_adapter_method=method))
    jh, jparams, model, sd = build_pair(cfg)
    assert "prompt_encoder" not in jparams and "prompt_adapter" in jparams
    assert model.prompt_encoder is None and model.prompt_learner is None
    assert not any(k.startswith("prompt_encoder.") for k in model.state_dict())
    assert set(model.state_dict()) == set(sd)
    with torch.no_grad():
        got = model.forward_text_only().numpy()
    assert got.shape == (4, 64)  # num_prompts = num_ranks = the template's 4 classes
    assert _rel(got, jax_text(jh, jparams)) <= TOL_TEXT["float32"]
    assert_logits_match(jh, jparams, model)


@pytest.fixture(scope="module")
def adapter_runs(tmp_path_factory):
    """test_vlsa_adapter_learner's 1-epoch run in both packages from the
    same initial weights and tower, the IF-MLE loss with alpha 1 (its
    uncensored terms): the censored term of a patient censored in the last
    bin is -log(max(1 - CIF, 1e-7)) of the CIF's rounding noise (see
    test_torch_zero_shot.assert_losses_match), and so is its gradient when
    the noise passes 1e-7, so two packages' steps part where it does."""
    out = {}
    root = tmp_path_factory.mktemp("adapter_run")
    cfg = model_cfg(root, **ADAPTER, loss_survifmle_alpha=1.0)
    for name in ("jax", "port"):
        c = dict(copy.deepcopy(cfg), save_path=str(root / name))
        if name == "jax":
            handler = JaxVLSAHandler(c)
            init = state_dict_from_jax(jax.tree.map(np.asarray, dict(handler.params)))
        else:
            handler = VLSAHandler(c, device="cpu", state_dict=init)
        passes = record_passes(handler)
        out[name] = (handler, handler.exec(), c["save_path"], passes)
    return out


def test_adapter_run_matches_jax(adapter_runs):
    """Every metric of every evaluation within 1e-4, the losses of the
    final passes as test_torch_zero_shot.assert_losses_match holds them;
    the prediction CSVs within 1e-5."""
    (jh, jmetrics, jpath, jpasses), (handler, metrics, path, passes) = (
        adapter_runs["jax"], adapter_runs["port"])
    assert set(metrics) == set(jmetrics)
    for split, rows in jmetrics.items():
        got = dict(metrics[split])
        for name, v in rows:
            if not name.endswith("loss"):
                assert abs(got[name] - v) <= TOL_METRIC, (split, name, got[name], v)
        assert_losses_match(jh, jpasses[split][-1], passes[split][-1], TOL_METRIC)
    assert_events_match(jpath, path, TOL_METRIC, equal_c_index=False)
    for split in ("train", "test"):
        name = f"vlsa_train_last_pred_{split}.csv"
        _h, ids_want, want = read_csv(os.path.join(jpath, name))
        _h, ids_got, got = read_csv(os.path.join(path, name))
        assert ids_got == ids_want
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL_PRED, err_msg=name)
    assert sorted(os.listdir(path)) == sorted(os.listdir(jpath))
    # the residuals trained; nothing of the tower is in the model
    assert handler.model.prompt_adapter.residual_features.requires_grad
    assert handler.model.prompt_encoder is None


def reference_coop_checkpoint(path, model_sd, seed=5):
    """A reference training checkpoint ({"model": learnable tensors,
    "epoch": ...}, the reference's names) with the CoOp embeddings'
    shapes of `model_sd`."""
    g = torch.Generator().manual_seed(seed)
    ctx = torch.randn(model_sd["prompt_learner.context_embeds"].shape, generator=g) * 0.02
    rank = torch.randn(model_sd["prompt_learner.rank_embeds"].shape, generator=g) * 0.02
    torch.save({"model": {"prompt_learner.context_embeds": ctx,
                          "prompt_learner.rank_embeds": rank,
                          "logit_scale": torch.tensor(4.2)},
                "epoch": 10}, str(path))
    return ctx, rank


def coop_cfg(tmp_path, frozen, dtype="float32"):
    """The flagship's CoOp rank learner, pretrained from the checkpoint
    `coop-fold{data_split_seed}-{method}.pth`; its embedding shapes come
    from a first build without the warm start."""
    cfg = model_cfg(tmp_path)
    model = port_vlsa.build_model(_resolved(cfg), device="cpu")
    reference_coop_checkpoint(tmp_path / "coop-fold0-rank.pth", model.state_dict())
    cfg.update({"vlsa_pmt_learner_pretrained": True,
                "vlsa_pmt_learner_coop_ckpt": str(tmp_path / "coop-fold{}-{}.pth"),
                "vlsa_pmt_learner_coop_frozen_context_embeds": frozen,
                "vlsa_pmt_learner_coop_frozen_rank_embeds": frozen,
                "_test_tower_overrides": dict(cfg["_test_tower_overrides"], dtype=dtype)})
    return cfg


def _resolved(cfg):
    """`cfg` with the rank and query counts a handler would fill in."""
    from vlsa_tpu_torch.data.io import load_init_text
    return dict(cfg, vlsa_pmt_learner_coop_num_ranks=4, vlsa_img_encoder_num_query=len(
        load_init_text(cfg["vlsa_img_encoder_query_text_load_path"],
                       key=cfg["vlsa_img_encoder_query_text_load_idx"])))


def test_coop_warm_start_from_a_reference_checkpoint(tmp_path):
    cfg = coop_cfg(tmp_path, frozen=False)
    assert port_vlsa.coop_checkpoint_cfg(dict(cfg, data_split_seed=0))["ckpt"] \
        == str(tmp_path / "coop-fold0-rank.pth")
    ckpt = torch.load(str(tmp_path / "coop-fold0-rank.pth"), weights_only=True)["model"]
    jh, jparams, model, _sd = build_pair(cfg)
    for name in ("context_embeds", "rank_embeds"):
        np.testing.assert_array_equal(jparams["prompt_learner"][name],
                                      ckpt[f"prompt_learner.{name}"].numpy())
    # the port's own build starts from the checkpoint too, before any bridge
    own = port_vlsa.build_model(copy.deepcopy(jh.cfg), device="cpu")
    for name in ("context_embeds", "rank_embeds"):
        assert torch.equal(getattr(own.prompt_learner, name).detach(),
                           ckpt[f"prompt_learner.{name}"])
    assert own.prompt_encoder is not None and own.prompt_learner.context_embeds.requires_grad
    with torch.no_grad():
        got = own.forward_text_only().numpy()
    assert _rel(got, jax_text(jh, jparams)) <= TOL_TEXT["float32"]
    assert_logits_match(jh, jparams, model)


def test_a_missing_coop_checkpoint_path_raises(tmp_path):
    cfg = model_cfg(tmp_path, vlsa_pmt_learner_pretrained=True, vlsa_pmt_learner_coop_ckpt=None)
    with pytest.raises(ValueError, match="null ckpt"):
        port_vlsa.coop_checkpoint_cfg(cfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_frozen_coop_is_precomputed(tmp_path, dtype):
    cfg = coop_cfg(tmp_path, frozen=True, dtype=dtype)
    jh, jparams, model, sd = build_pair(cfg)
    assert set(jparams) == {"logit_scale", "mil_encoder", "query_adapter"}
    assert model.prompt_learner is None and model.prompt_encoder is None
    assert not any(k.startswith(("prompt_encoder.", "prompt_learner.", "pretrained_"))
                   for k in model.state_dict())
    assert set(model.state_dict()) == set(sd)
    got = model.pretrained_text_features.numpy()
    want = np.asarray(jh.model.pretrained_text_features)
    assert got.shape == want.shape == (4, 64)
    assert _rel(got, want) <= TOL_TEXT[dtype]
    if dtype == "float32":
        assert_logits_match(jh, jparams, model)


@pytest.mark.parametrize("layout", ["file", "dir", "named_dir"])
def test_path_clip_model_layouts(tmp_path, layout):
    """The file itself, <root>/pytorch_model.bin, or
    <root>/<txt_encoder_name>/pytorch_model.bin; the tower then equals the
    file's and the logit scale starts at its value."""
    target = {"file": tmp_path / "w" / "conch.bin", "dir": tmp_path / "w" / "pytorch_model.bin",
              "named_dir": tmp_path / "w" / "mahmoodlab" / "conch" / "pytorch_model.bin"}[layout]
    write_conch_checkpoint(target)
    root = str(target) if layout == "file" else str(tmp_path / "w")
    cfg = _resolved(model_cfg(tmp_path, path_clip_model=root))
    assert port_vlsa.clip_checkpoint_path(cfg) == str(target)
    model = port_vlsa.build_model(cfg, device="cpu")
    want = jax_import_tower(str(target))
    sd = state_dict_from_jax({"prompt_encoder": want["text_params"]})
    for k, v in model.prompt_encoder.state_dict().items():
        assert torch.equal(v, sd["prompt_encoder." + k]), k
    assert model.logit_scale.item() == want["logit_scale"] == 4.0


def test_path_clip_model_that_names_no_file_raises(tmp_path):
    cfg = model_cfg(tmp_path, path_clip_model=str(tmp_path / "nowhere"))
    with pytest.raises(FileNotFoundError, match="nowhere"):
        port_vlsa.clip_checkpoint_path(cfg)
    assert port_vlsa.clip_checkpoint_path(dict(cfg, path_clip_model=None)) is None


@pytest.mark.parametrize("path", ["flagship", "adapter", "frozen_coop", "zero_shot"])
def test_freeze_flags_of_each_path_match_jax(tmp_path, path):
    """runner.train.frozen_paths gives vlsa_tpu's paths, and the port's
    trainable parameters are the leaves vlsa_tpu's optimizer updates."""
    changes = {"flagship": {}, "adapter": ADAPTER,
               "zero_shot": {"num_shot": 0, "vlsa_img_encoder_name": "FeatMIL",
                             "vlsa_img_encoder_frozen": True, "vlsa_frozen_logit_scale": True,
                             "vlsa_pmt_learner_coop_frozen_context_embeds": True,
                             "vlsa_pmt_learner_coop_frozen_rank_embeds": True}}
    cfg = (coop_cfg(tmp_path, frozen=True) if path == "frozen_coop"
           else model_cfg(tmp_path, **changes[path]))
    assert frozen_paths(cfg) == JaxVLSAHandler.frozen_paths(None, cfg)
    handler = VLSAHandler(copy.deepcopy(cfg), device="cpu")
    trainable = {k for k, p in handler.model.named_parameters() if p.requires_grad}
    jh = JaxVLSAHandler(copy.deepcopy(cfg))
    frozen = [p.replace("/", ".") for p in jh.frozen_paths(jh.cfg)]
    want = {name for name in state_dict_from_jax(jax.tree.map(np.asarray, dict(jh.params)))
            if not any(name == f or name.startswith(f + ".") for f in frozen)}
    assert trainable == want
    assert (handler.optimizer is None) == (not want)
