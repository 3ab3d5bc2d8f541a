"""The training slice as a whole: the small flagship VLSA trained for 5
steps in both packages on the same batches, without and with VLFAN's
feature projecter (`use_feat_proj`: the patch features then need a
gradient, which on the card is the co-attention's dX kernel).

vlsa_tpu builds the model and initialises its parameters; the bridge
(vlsa_tpu_torch.utils.weights) carries them into the port.  Both take 5 Adam
steps (lr 2e-4, weight decay 1e-5) of SurvIFMLE + SurvEMD (p=2) with the
text tower frozen, on the same ragged f32 batches made with numpy, the last
with a padded row.  On the CPU the JAX model takes its plain co-attention
and the port its plain version under autograd; the text tower runs in f32.

Tolerances: per-step loss 1e-4 relative; final learnable parameters
|a-b| <= 1e-5 + 1e-4 |b| (f32 on both sides; the differences are summation
order, carried through 5 Adam steps).  Two leaves have an exception, named in
NEAR_ZERO_GRADIENT: Adam's first step moves each element by lr * g/|g|, so
an element whose true first gradient is ~0 steps by +-lr with the sign of
float noise, on each side independently (as tests/test_train_trajectory.py
:168-172 finds for a softmax gauge direction).  Those elements -- a first
gradient below 1e-4 of the leaf's largest; 4 of them deviate here without the
projecter, one in each leaf with it -- may differ by up to 2 lr; every other
element keeps the tolerance above.  Each check runs without and with the
projecter (`_five_steps`, `_accumulation`), the first under its original name.
"""
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

from test_torch_vlsa import REPO, TOWER, flagship_cfgs
from vlsa_tpu.losses import load_loss as jax_load_loss
from vlsa_tpu.models.vlsa_build import build_vlsa as jax_build_vlsa
from vlsa_tpu.optim import create_optimizer as jax_create_optimizer
from vlsa_tpu.optim import frozen_mask_from_cfg as jax_frozen_mask
from vlsa_tpu.runner.engine import TrainEngine as JaxTrainEngine
from vlsa_tpu.runner.engine import make_objective as jax_make_objective
from vlsa_tpu.runner.engine import make_output_converter as jax_converter
from vlsa_tpu_torch.losses import load_loss
from vlsa_tpu_torch.models.vlsa_build import build_vlsa
from vlsa_tpu_torch.ops import coattn
from vlsa_tpu_torch.optim import create_optimizer, frozen_mask_from_cfg
from vlsa_tpu_torch.runner import train as train_cli
from vlsa_tpu_torch.runner.engine import TrainEngine, make_objective, make_output_converter
from vlsa_tpu_torch.utils.weights import state_dict_from_jax

LR, WD, STEPS, K = 2e-4, 1e-5, 5, 12
LOSSES = {"loss_type": ["SurvIFMLE", "SurvEMD"], "SurvIFMLE": {}, "SurvEMD": {"p": 2}}
WEIGHTS = {"SurvIFMLE": 1.0, "SurvEMD": 1.0}
# leaf -> why some of its elements start from a ~0 gradient
NEAR_ZERO_GRADIENT = {
    "mil_encoder.visual_adapter.weight":
        "the adapter's output is l2-normalised before the logits, so each row's "
        "gradient is orthogonal to the image feature and single elements can "
        "cancel to ~1e-7 of the leaf's scale at the first step",
    "mil_encoder.feat_proj.linear.weight":
        "each element's gradient is a sum over the batch's patches of products of "
        "zero-mean factors (a N(0, 1) feature and the LayerNorm's input cotangent), "
        "so single elements cancel to ~1e-5 of the leaf's scale at the first step",
}


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


def _cfgs(asset_root: str, use_feat_proj: bool):
    text, image, prompt = flagship_cfgs(asset_root)
    return text, dict(image, use_feat_proj=use_feat_proj), prompt


def _jax_train(use_feat_proj: bool):
    """(initial state dict, per-step losses, final state dict) of vlsa_tpu's
    TrainEngine, bridged into the port's names."""
    text, image, prompt = _cfgs(os.path.join(REPO, "vlsa_tpu", "assets"), use_feat_proj)
    jmodel, params, _tok = jax_build_vlsa(
        vlsa_api="CONCH", text_encoder_cfg=text, image_encoder_cfg=image,
        prompt_learner_cfg=prompt, rng=jax.random.PRNGKey(0), tower_overrides=TOWER)
    params = jax.tree.map(np.asarray, dict(params))
    init = state_dict_from_jax(params)
    frozen = jax_frozen_mask(params, ["prompt_encoder"])
    tx = jax_create_optimizer("adam", LR, WD, params, frozen=frozen)
    objective = jax_make_objective(jax_load_loss("vlsa", **LOSSES), WEIGHTS,
                                   jax_converter("softmax"), uses_vl=True)
    eng = JaxTrainEngine(jmodel, tx, objective, uses_vl=True, frozen=frozen)
    step = eng.train_step()
    p, state, losses = jax.tree.map(jnp.asarray, params), tx.init(params), []
    for i, b in enumerate(_batches()):
        p, state, loss, _raw = step(p, state, {k: jnp.asarray(v) for k, v in b.items()},
                                    jax.random.PRNGKey(i))
        losses.append(float(loss))
    return init, np.array(losses), state_dict_from_jax(jax.tree.map(np.asarray, p))


@pytest.fixture(scope="module")
def jax_run():
    return False, *_jax_train(False)


@pytest.fixture(scope="module")
def jax_run_feat_proj():
    return True, *_jax_train(True)


def _port(init, use_feat_proj, accum_steps=1):
    text, image, prompt = _cfgs("vlsa_tpu/assets", use_feat_proj)
    model, _tok = build_vlsa(text, image, prompt, tower_overrides=TOWER, device="cpu",
                             state_dict=init)
    model.train()
    frozen_mask_from_cfg(model, ["prompt_encoder"])
    opt = create_optimizer("adam", LR, WD, model)
    objective = make_objective(load_loss("vlsa", **LOSSES), WEIGHTS,
                               make_output_converter("softmax"))
    return model, TrainEngine(model, opt, objective, accum_steps=accum_steps)


def _tensors(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _five_steps(jax_run):
    use_feat_proj, init, jax_losses, jax_final = jax_run
    model, engine = _port(init, use_feat_proj)
    assert any(n.startswith("mil_encoder.feat_proj.") for n in init) == use_feat_proj
    coattn.reset_launches()
    losses, first_grad = [], {}
    for b in _batches():
        losses.append(float(engine.train_step(_tensors(b))[0]))
        first_grad = first_grad or {n: p.grad.abs().numpy() for n, p in
                                    model.named_parameters() if p.grad is not None}
    assert sum(coattn.LAUNCHES.values()) + sum(coattn.LAUNCHES_BWD.values()) \
        + sum(coattn.LAUNCHES_DX.values()) == 0
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4)
    final = model.state_dict()
    assert set(final) == set(jax_final)
    for name, got in final.items():
        got, want = got.float().numpy(), jax_final[name].float().numpy()
        if name.startswith("prompt_encoder."):
            np.testing.assert_array_equal(got, init[name].float().numpy(), err_msg=name)
            continue
        ok = np.abs(got - want) <= 1e-5 + 1e-4 * np.abs(want)
        if name in NEAR_ZERO_GRADIENT:
            g0 = first_grad[name]
            near_zero = g0 < 1e-4 * g0.max()
            assert near_zero.mean() < 1e-2, name  # the exception stays narrow
            ok |= near_zero & (np.abs(got - want) <= 2 * LR)
        assert np.all(ok), f"{name}: max |a-b| {np.abs(got - want)[~ok].max():.3e}"
    learnable = ["prompt_learner.context_embeds", "prompt_learner.rank_embeds",
                 "query_adapter.residual_features", "mil_encoder.visual_adapter.weight",
                 "logit_scale"]
    if use_feat_proj:
        learnable += [n for n in init if n.startswith("mil_encoder.feat_proj.")]
    for name in learnable:
        assert not np.array_equal(final[name].numpy(), init[name].numpy()), name


def test_five_steps_match_jax_train_engine(jax_run):
    _five_steps(jax_run)


def test_five_steps_with_feat_proj_match_jax_train_engine(jax_run_feat_proj):
    _five_steps(jax_run_feat_proj)


def _accumulation(jax_run):
    """accum_steps=2 gives the whole batch's loss, logits and gradients on a
    ragged tail batch (valid counts 2 and 1), to 1e-5 of each leaf's largest
    gradient (f32 sums in another order; measured at most 3.2e-6)."""
    use_feat_proj, init, _l, _f = jax_run
    batch = _tensors(_batches()[-1])
    runs = []
    for accum in (1, 2):
        model, engine = _port(init, use_feat_proj, accum_steps=accum)
        loss, raw = engine.train_step(batch)
        grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
        runs.append((float(loss), raw, grads))
    (l1, r1, g1), (l2, r2, g2) = runs
    np.testing.assert_allclose(l2, l1, rtol=1e-5)
    torch.testing.assert_close(r2, r1, rtol=1e-5, atol=1e-6)
    assert set(g1) == set(g2) and "prompt_learner.context_embeds" in g1
    for n in g1:
        assert float((g2[n] - g1[n]).abs().max() / g1[n].abs().max()) <= 1e-5, n


def test_accumulation_matches_one_pass(jax_run):
    _accumulation(jax_run)


def test_accumulation_with_feat_proj_matches_one_pass(jax_run_feat_proj):
    _accumulation(jax_run_feat_proj)


def _cli_summary(tmp_path, **overrides):
    """The train CLI's summary of 2 CPU steps on a small copy of the flagship
    YAML, after checking its per-step lines."""
    with open(os.path.join(REPO, "configs", "IFMLE", "tcga_blca", "cfg_vlsa_conch.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg.update(path_patch="synthetic://N=48,D=512,seed=7", bp_every_batch=4,
               _test_tower_overrides={"width": 32, "heads": 4, "layers": 2},
               path_table=os.path.join(REPO, cfg["path_table"]),
               data_split_path=os.path.join(REPO, cfg["data_split_path"]), **overrides)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    buf = io.StringIO()
    with redirect_stdout(buf):
        summary = train_cli.main(["--config", str(path), "--steps", "2", "--device", "cpu"])
    lines = [json.loads(s) for s in buf.getvalue().splitlines() if s.startswith("{")]
    assert [r["step"] for r in lines[:2]] == [0, 1] and lines[-1] == summary
    assert all(np.isfinite(r["loss"]) and r["bags"] == 4 and r["bucket"] >= 256
               for r in lines[:2])
    assert summary["num_bins"] == 12 and summary["train_bags"] == 298
    assert summary["feats_dtype"] == "bfloat16"
    return summary


def test_cli_trains_on_the_cpu(tmp_path):
    summary = _cli_summary(tmp_path)
    assert sum(summary["coattn_launches"].values()) == 0  # the CPU path launches nothing


def test_cli_trains_with_feat_proj_on_the_cpu(tmp_path):
    """`vlsa_img_encoder_use_feat_proj: True`: the projecter's bf16 output
    needs a gradient; on the CPU no kernel of either backward launches."""
    summary = _cli_summary(tmp_path, vlsa_img_encoder_use_feat_proj=True)
    assert summary["steps"] == 2
    assert set(summary["coattn_bwd_dx_launches"]) == {"f32", "bf16"}
    for key in ("coattn_launches", "coattn_bwd_launches", "coattn_bwd_dx_launches"):
        assert sum(summary[key].values()) == 0, key
