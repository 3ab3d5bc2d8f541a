"""The rest of the MIL zoo (models/mil_ext.py, models/nystrom.py) against
vlsa_tpu's on the CPU at small widths (D=64, hid=32, bags of up to N=50, so
TransMIL's grid pads and its Nyström landmarks average uneven segments).

vlsa_tpu builds each network and initialises it; the bridge
(vlsa_tpu_torch.utils.weights) carries the tree into the port, and back
bit for bit.  Tolerances (f32 on both sides, sums in another order):

- forwards: max|a-b| <= 1e-5 * max(1, max|b|) (measured <= 1.8e-7);
- the pseudo-inverse: 1e-5 of its largest element, and in float64 1e-12 of
  the same six steps in numpy;
- TransMIL's cls attention row, formed without the N x N map, 1e-6 of the
  row's largest element;
- 5 Adam steps (lr 2e-4, weight decay 1e-5) of SurvIFMLE on the same ragged
  batches, the last with a padded row, Dropout off on both sides (vlsa_tpu
  applies its model with train=False; the port's SeededDropouts at p=0), as
  the SA tests run without Dropout: per-step loss 1e-4 relative, final
  parameters |a-b| <= 1e-5 + 1e-4 |b| (NEAR_ZERO_GRADIENT's elements
  excepted as tests/test_torch_train.py does, and the key block of each
  ILRA `in_proj_bias` and the gated readout's score bias, whose gradients
  the softmax makes zero, within the 2 x 5 Adam steps their rounding noise
  can take).  The VLSA image encoders
  TransMIL and ILRA the same way on the small flagship.
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
from vlsa_tpu.models import load_model as jax_load_model
from vlsa_tpu.models.nystrom import moore_penrose_pinv as jax_pinv
from vlsa_tpu.models.vlsa_build import build_vlsa as jax_build_vlsa
from vlsa_tpu.optim import create_optimizer as jax_create_optimizer
from vlsa_tpu.optim import frozen_mask_from_cfg as jax_frozen_mask
from vlsa_tpu.runner.engine import TrainEngine as JaxTrainEngine
from vlsa_tpu.runner.engine import make_objective as jax_make_objective
from vlsa_tpu.runner.engine import make_output_converter as jax_converter
from vlsa_tpu_torch.losses import load_loss
from vlsa_tpu_torch.main import main as port_main
from vlsa_tpu_torch.models import mil_ext
from vlsa_tpu_torch.models.layers import SeededDropout
from vlsa_tpu_torch.models.nystrom import moore_penrose_pinv
from vlsa_tpu_torch.models.registry import load_model
from vlsa_tpu_torch.models.vlsa_build import build_vlsa
from vlsa_tpu_torch.optim import create_optimizer, frozen_mask_from_cfg
from vlsa_tpu_torch.runner import serve as serve_cli
from vlsa_tpu_torch.runner.engine import TrainEngine, make_objective, make_output_converter
from vlsa_tpu_torch.utils.weights import _flatten, jax_tree_from_state_dict, state_dict_from_jax

D, HID, K, N, B = 64, 32, 4, 50, 4
LR, WD, STEPS = 2e-4, 1e-5, 5
LOSSES = {"loss_type": ["SurvIFMLE"], "SurvIFMLE": {}}
WEIGHTS = {"SurvIFMLE": 1.0}
NETWORKS = {"TransMIL": {}, "ILRA": {"num_layers": 2, "num_heads": 4, "topk": 2, "ln": True},
            "DeepAttnMISL": {"num_clusters": 5}, "PatchGCN": {"num_layers": 3}}
EXTRA = {"DeepAttnMISL": "cluster", "PatchGCN": "graph"}
# leaf -> why some of its elements start from a ~0 gradient (Adam then
# steps them by +-lr with the sign of float noise, on each side alone)
NEAR_ZERO_GRADIENT = {
    "mil_encoder.fc2.weight": "VLSA l2-normalises the encoder's output before the logits, "
                              "so each row's gradient is orthogonal to the image feature "
                              "and single elements cancel",
    "mil_encoder.classifier.weight": "as mil_encoder.fc2.weight (ILRA's last layer)",
}


class _NoDropout:
    """vlsa_tpu's model applied with train=False (its Dropout off)."""

    def __init__(self, module):
        self.module = module

    def __getattr__(self, name):
        return getattr(self.module, name)

    def apply(self, variables, *args, **kws):
        kws.pop("rngs", None)
        kws["train"] = False
        return self.module.apply(variables, *args, **kws)


def _no_dropout(model):
    for m in model.modules():
        if isinstance(m, SeededDropout):
            m.p = 0.0
    return model


def _batch(rng, n_max=N, extra=None, ragged=False):
    lengths = rng.integers(n_max // 3, n_max + 1, size=B)
    feats = np.zeros((B, n_max, D), np.float32)
    mask = np.zeros((B, n_max), bool)
    for j, n in enumerate(lengths):
        feats[j, :n] = rng.normal(size=(n, D))
        mask[j, :n] = True
    valid = np.ones(B, bool)
    if ragged:
        valid[-1] = False
        feats[-1], mask[-1] = 0.0, False
    t, e = rng.integers(0, K, size=B), (rng.random(B) < 0.6).astype(np.float32)
    # no patient censored in the last bin: SurvIFMLE's term for one is
    # rounding noise in both packages (ROADMAP.md §C)
    t = np.where((e == 0) & (t == K - 1), K - 2, t).astype(np.float32)
    b = {"feats": feats, "mask": mask, "t": t, "e": e, "valid": valid}
    if extra == "cluster":
        b["cluster_id"] = np.where(mask, rng.integers(0, NETWORKS["DeepAttnMISL"]["num_clusters"],
                                                      size=(B, n_max)), 0).astype(np.int32)
    elif extra == "graph":
        E = 6 * n_max
        ei = np.zeros((B, 2, E), np.int32)
        ev = np.zeros((B, E), bool)
        for j, n in enumerate(lengths):
            e = int(rng.integers(2 * n, 6 * n + 1)) if mask[j].any() else 0
            ei[j, :, :e] = rng.integers(0, n, size=(2, e))
            ev[j, :e] = True
        b["edge_index"], b["edge_valid"] = ei, ev
    return b


def _inputs(b, lib):
    keys = ("cluster_id", "edge_index", "edge_valid")
    if lib == "jax":
        return {k: jnp.asarray(b[k]) for k in keys if k in b}
    return {k: torch.from_numpy(b[k]) for k in keys if k in b}


def _jax_model(network, seed=0):
    jm, params = jax_load_model("DeepMIL", [D, HID, K], rng=jax.random.PRNGKey(seed),
                                network=network, **NETWORKS[network])
    return jm, jax.tree.map(np.asarray, dict(params))


def _port_model(network, state_dict=None):
    return load_model("DeepMIL", [D, HID, K], device="cpu", state_dict=state_dict,
                      network=network, **NETWORKS[network])


@pytest.mark.parametrize("network", sorted(NETWORKS))
def test_forward_matches_jax(network):
    jm, params = _jax_model(network)
    b = _batch(np.random.default_rng(1), extra=EXTRA.get(network))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(b["feats"]),
                               mask=jnp.asarray(b["mask"]), **_inputs(b, "jax")))
    model = _port_model(network, state_dict_from_jax(params)).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(b["feats"]), torch.from_numpy(b["mask"]),
                    **_inputs(b, "torch")).numpy()
    assert got.shape == want.shape == (B, K)
    assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("network", sorted(NETWORKS))
def test_bridge_round_trip(network):
    """Every leaf of vlsa_tpu's tree to one tensor (strict load) and back,
    bit for bit; the port's own initialisation has the same state dict
    keys and shapes."""
    _jm, params = _jax_model(network)
    sd = state_dict_from_jax(params)
    model = _port_model(network, sd)
    back = dict(("/".join(k), v) for k, v in _flatten(jax_tree_from_state_dict(model.state_dict())))
    want = dict(("/".join(k), v) for k, v in _flatten(params))
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    own = _port_model(network).state_dict()
    assert {k: v.shape for k, v in own.items()} == {k: v.shape for k, v in sd.items()}


def test_port_initialisation_follows_vlsa_tpu_bounds():
    """The port's seeded initialisation draws from vlsa_tpu's distributions:
    PPEG's kernels U(+-1/k), Nyström's U(+-1/sqrt(33)), in_proj, latent and
    pool_seeds xavier-uniform, t = 1, in_proj_bias 0."""
    sd = _port_model("TransMIL").state_dict()
    for name, k in (("proj", 7), ("proj1", 5), ("proj2", 3)):
        w = sd[f"pos_layer.{name}"]
        assert w.shape == (HID, 1, k, k) and w.abs().max() <= 1.0 / k
        assert w.abs().max() > 0.8 / k
    w = sd["layer1.attn.res_conv_kernel"]
    assert w.shape == (8, 1, 33, 1) and w.abs().max() <= 33 ** -0.5
    sd = _port_model("ILRA").state_dict()
    w = sd["gab_0.project_forward.in_proj"]
    assert w.abs().max() <= (6.0 / (4 * HID)) ** 0.5
    assert torch.count_nonzero(sd["gab_0.project_forward.in_proj_bias"]) == 0
    assert sd["pool_seeds"].abs().max() <= (6.0 / (2 + HID)) ** 0.5
    sd = _port_model("PatchGCN").state_dict()
    assert all(float(sd[f"gcn.conv{i}.t"]) == 1.0 for i in range(3))


@pytest.mark.parametrize("shape", [(3, 16, 16), (2, 4, 25, 25)])
def test_moore_penrose_pinv_matches_jax(shape):
    x = np.random.default_rng(2).random(shape).astype(np.float32)
    x = x / x.sum(-1, keepdims=True)  # row-stochastic, as softmax(q_l k_l^T)
    want = np.asarray(jax_pinv(jnp.asarray(x)))
    got = moore_penrose_pinv(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    # float64: the same six steps in numpy
    x64 = x.astype(np.float64)
    z = np.swapaxes(x64, -1, -2) / (np.abs(x64).sum(-1).max(-1)
                                    * np.abs(x64).sum(-2).max(-1))[..., None, None]
    eye = np.eye(shape[-1])
    for _ in range(6):
        xz = x64 @ z
        z = 0.25 * z @ (13 * eye - xz @ (15 * eye - xz @ (7 * eye - xz)))
    got64 = moore_penrose_pinv(torch.from_numpy(x64)).numpy()
    assert np.abs(got64 - z).max() <= 1e-12 * np.abs(z).max()


def test_transmil_cls_row_matches_the_full_map():
    """vlsa_tpu forms the [B, h, N, N] map and slices the cls row; the port
    forms the row alone."""
    jm, params = _jax_model("TransMIL")
    b = _batch(np.random.default_rng(3))
    want_logits, want = jm.apply({"params": params}, jnp.asarray(b["feats"]),
                                 mask=jnp.asarray(b["mask"]), ret_with_attn=True)
    model = _port_model("TransMIL", state_dict_from_jax(params)).eval()
    with torch.no_grad():
        logits, got = model(torch.from_numpy(b["feats"]), torch.from_numpy(b["mask"]),
                            ret_with_attn=True)
    want = np.asarray(want)
    assert got.shape == want.shape == (B, N)
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=1e-5)


def _hold_final(final, jax_final, init, first_grad):
    assert set(final) == set(jax_final) == set(init)
    for name, got in final.items():
        got, want = got.float().numpy(), jax_final[name].float().numpy()
        ok = np.abs(got - want) <= 1e-5 + 1e-4 * np.abs(want)
        if name.endswith("in_proj_bias") and name in first_grad:
            # the key block adds q . b_k to a whole row of logits: the softmax
            # cancels it, so its gradient is rounding noise at every step
            # (Adam steps it by ~+-lr each step, on each side alone)
            d = got.shape[0] // 3
            g0 = first_grad[name]
            assert g0[d:2 * d].max() < 1e-4 * g0.max(), name
            ok[d:2 * d] |= np.abs(got - want)[d:2 * d] <= 2 * STEPS * LR
        if name.endswith(("attention_head.fc2.bias", "attention_net.fc2.bias")):
            # the gated readout's score bias adds one constant to every
            # instance's logit: the softmax over instances cancels it, so its
            # gradient is rounding noise (Adam steps it on each side alone)
            assert first_grad[name].max() < 1e-4 * max(g.max() for g in first_grad.values())
            ok |= np.abs(got - want) <= 2 * STEPS * LR
        if name in NEAR_ZERO_GRADIENT:
            g0 = first_grad[name]
            near_zero = g0 < 1e-4 * g0.max()
            assert near_zero.mean() < 1e-2, name  # the exception stays narrow
            ok |= near_zero & (np.abs(got - want) <= 2 * LR)
        assert np.all(ok), f"{name}: max |a-b| {np.abs(got - want)[~ok].max():.3e}"


def _steps_batches(extra):
    rng = np.random.default_rng(4)
    return [_batch(rng, extra=extra, ragged=s == STEPS - 1) for s in range(STEPS)]


@pytest.mark.parametrize("network", sorted(NETWORKS))
def test_five_steps_match_jax_train_engine(network):
    jm, params = _jax_model(network)
    init = state_dict_from_jax(params)
    batches = _steps_batches(EXTRA.get(network))
    tx = jax_create_optimizer("adam", LR, WD, params)
    objective = jax_make_objective(jax_load_loss("sa", **LOSSES), WEIGHTS,
                                   jax_converter("softmax"), uses_vl=False)
    step = JaxTrainEngine(_NoDropout(jm), tx, objective, uses_vl=False).train_step()
    p, state, jax_losses = jax.tree.map(jnp.asarray, params), tx.init(params), []
    for i, b in enumerate(batches):
        p, state, loss, _raw = step(p, state, {k: jnp.asarray(v) for k, v in b.items()},
                                    jax.random.PRNGKey(i))
        jax_losses.append(float(loss))
    jax_final = state_dict_from_jax(jax.tree.map(np.asarray, p))

    model = _no_dropout(_port_model(network, init)).train()
    engine = TrainEngine(model, create_optimizer("adam", LR, WD, model),
                         make_objective(load_loss("sa", **LOSSES), WEIGHTS,
                                        make_output_converter("softmax")))
    losses, first_grad = [], None
    for b in batches:
        losses.append(float(engine.train_step({k: torch.from_numpy(v)
                                               for k, v in b.items()})[0]))
        first_grad = first_grad or {n: q.grad.abs().numpy() for n, q in
                                    model.named_parameters() if q.grad is not None}
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4)
    _hold_final(model.state_dict(), jax_final, init, first_grad)
    moved = [n for n, v in model.state_dict().items() if not torch.equal(v, init[n])]
    assert len(moved) >= len(init) // 2


# ---------------------------------------------------------------- VLSA encoders

def _vlsa_cfgs(name):
    text, image, prompt = flagship_cfgs(os.path.join(REPO, "vlsa_tpu", "assets"))
    image = {"name": name, "dim_in": D, "dim_hid": HID, "num_cls": 512,
             "pooling": "logit_mean"}
    return text, image, prompt


@pytest.fixture(scope="module", params=["TransMIL", "ILRA"])
def vlsa_pair(request):
    name = request.param
    text, image, prompt = _vlsa_cfgs(name)
    jmodel, jparams, _tok = jax_build_vlsa(
        vlsa_api="CONCH", text_encoder_cfg=text, image_encoder_cfg=image,
        prompt_learner_cfg=prompt, rng=jax.random.PRNGKey(0), tower_overrides=TOWER)
    jparams = jax.tree.map(np.asarray, dict(jparams))
    return name, jmodel, jparams


def _port_vlsa(name, state_dict):
    text, image, prompt = _vlsa_cfgs(name)
    model, _tok = build_vlsa(text, image, prompt, tower_overrides=TOWER, device="cpu",
                             state_dict=state_dict)
    return model


def test_vlsa_encoder_forward_matches_jax(vlsa_pair):
    name, jmodel, jparams = vlsa_pair
    b = _batch(np.random.default_rng(5))
    want = np.asarray(jmodel.apply({"params": jparams}, jnp.asarray(b["feats"]),
                                   mask=jnp.asarray(b["mask"]))[0])
    model = _port_vlsa(name, state_dict_from_jax(jparams))
    assert isinstance(model.mil_encoder, getattr(mil_ext, name))
    with torch.no_grad():
        got = model(torch.from_numpy(b["feats"]), torch.from_numpy(b["mask"]))[0].numpy()
    assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max())
    back = dict(("/".join(k), v) for k, v in _flatten(jax_tree_from_state_dict(model.state_dict())))
    for k, v in _flatten(jparams):
        np.testing.assert_array_equal(back["/".join(k)], v, err_msg="/".join(k))


def test_vlsa_encoder_five_steps_match_jax(vlsa_pair):
    name, jmodel, jparams = vlsa_pair
    batches = _steps_batches(None)
    for b in batches:
        b["t"] = np.minimum(b["t"] * 3, 11).astype(np.float32)  # the flagship's 12 bins
    init = state_dict_from_jax(jparams)
    losses_cfg = {"loss_type": ["SurvIFMLE", "SurvEMD"], "SurvIFMLE": {}, "SurvEMD": {"p": 2}}
    weights = {"SurvIFMLE": 1.0, "SurvEMD": 1.0}
    frozen = jax_frozen_mask(jparams, ["prompt_encoder"])
    tx = jax_create_optimizer("adam", LR, WD, jparams, frozen=frozen)
    objective = jax_make_objective(jax_load_loss("vlsa", **losses_cfg), weights,
                                   jax_converter("softmax"), uses_vl=True)
    step = JaxTrainEngine(_NoDropout(jmodel), tx, objective, uses_vl=True,
                          frozen=frozen).train_step()
    p, state, jax_losses = jax.tree.map(jnp.asarray, jparams), tx.init(jparams), []
    for i, b in enumerate(batches):
        p, state, loss, _raw = step(p, state, {k: jnp.asarray(v) for k, v in b.items()},
                                    jax.random.PRNGKey(i))
        jax_losses.append(float(loss))
    jax_final = state_dict_from_jax(jax.tree.map(np.asarray, p))

    model = _no_dropout(_port_vlsa(name, init)).train()
    frozen_mask_from_cfg(model, ["prompt_encoder"])
    engine = TrainEngine(model, create_optimizer("adam", LR, WD, model),
                         make_objective(load_loss("vlsa", **losses_cfg), weights,
                                        make_output_converter("softmax")))
    losses, first_grad = [], None
    for b in batches:
        losses.append(float(engine.train_step({k: torch.from_numpy(v)
                                               for k, v in b.items()})[0]))
        first_grad = first_grad or {n: q.grad.abs().numpy() for n, q in
                                    model.named_parameters() if q.grad is not None}
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4)
    _hold_final(model.state_dict(), jax_final, init, first_grad)
    assert not torch.equal(model.state_dict()["mil_encoder.classifier.weight" if name == "ILRA"
                                              else "mil_encoder.fc2.weight"],
                           init["mil_encoder.classifier.weight" if name == "ILRA"
                                else "mil_encoder.fc2.weight"])


# ---------------------------------------------------------------- the CLIs

def _sa_config(tmp_path, network, **changes) -> str:
    with open(os.path.join(REPO, "configs", "IFMLE", "tcga_blca", "cfg_sa_base_conch.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg = {k: (v[0] if isinstance(v, list) else v) for k, v in cfg.items()}
    cfg.update(path_patch="synthetic://N=40,D=64,seed=7", bp_every_batch=8, epochs=1,
               net_dims="64-32-4", deepmil_network=network,
               path_table=os.path.join(REPO, cfg["path_table"]),
               data_split_path=os.path.join(REPO, cfg["data_split_path"]),
               save_path=str(tmp_path / "run"), **changes)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.mark.parametrize("network", ["TransMIL", "ILRA"])
def test_main_trains_and_serve_answers(tmp_path, network):
    """`python -m vlsa_tpu_torch.main --handler SA` trains one epoch of the
    network on patch bags; the serving CLI answers a request."""
    cfg = _sa_config(tmp_path, network)
    with redirect_stdout(io.StringIO()):
        port_main(["--config", cfg, "--handler", "SA", "--device", "cpu"])
    run = tmp_path / "run"
    assert (run / "train_model-last.ckpt").exists()
    with open(run / "metrics.jsonl") as f:
        evals = [json.loads(s) for s in f if '"eval"' in s]
    assert evals and all(np.isfinite(v) for e in evals for k, v in e.items()
                         if isinstance(v, float))
    buf = io.StringIO()
    with redirect_stdout(buf):
        summary = serve_cli.main(["--config", cfg, "--n_requests", "1", "--bags_per_request",
                                  "3", "--device", "cpu"])
    assert summary["requests"] == 1 and sum(summary["abmil_launches"].values()) == 0
