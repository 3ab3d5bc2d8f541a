"""Importing reference checkpoints: vlsa_tpu's importers
(vlsa_tpu/utils/torch_import.py) and the port's
(vlsa_tpu_torch/utils/torch_import.py) read the same files, which the tests
write: CONCH text towers in the CoCa layout (`text.*`, as mahmoodlab/conch's
`pytorch_model.bin`) and the CLIP layout (top level), with `visual.*` and
`text_decoder.*` decoys, the reference's learnable VLSA checkpoint and a
reference DeepMIL/ABMIL checkpoint, all under the reference's key names
with random values from a seed.

Tolerances (max|a-b| / max|b|): text features 1e-5 in f32 (the same
arithmetic, summed in another order), 2e-3 in bf16 (ROADMAP §C: bf16
rounding flips from the summation order); the imported tensors and logit
scales exactly; VLSA logits 1e-4 and DeepMIL logits 1e-5 (f32 on both
sides, as test_torch_vlsa.py and test_torch_deepmil.py hold them).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlsa_tpu.models.registry import load_model as jax_load_model
from vlsa_tpu.models.text_encoder import generate_pseudo_tokens as jax_pseudo_tokens
from vlsa_tpu.models.text_encoder import make_text_tower as jax_make_text_tower
from vlsa_tpu.models.vlsa_build import build_vlsa as jax_build_vlsa
from vlsa_tpu.utils import torch_import as jax_import
from vlsa_tpu_torch.models.registry import load_model
from vlsa_tpu_torch.models.text_encoder import generate_pseudo_tokens, make_text_tower
from vlsa_tpu_torch.models.tokenizer import Tokenizer
from vlsa_tpu_torch.models.vlsa_build import build_vlsa
from vlsa_tpu_torch.utils import torch_import
from vlsa_tpu_torch.utils.weights import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_F32, TOL_BF16, TOL_LOGITS, TOL_DEEPMIL = 1e-5, 2e-3, 1e-4, 1e-5
# a small CONCH tower: width, heads, layers, context, vocab, output
SMALL = dict(width=32, heads=4, layers=2, context_length=128, vocab_size=32007, output_dim=64)
PROMPTS = ["a histopathology image suggesting a very poor prognosis",
           "an H&E stained image associated with a good survival", "tumor"]


def tower_state(width, layers, vocab, context, output, seed=0, prefix="text.",
                cls_emb=True, logit_scale=4.0, decoys=True):
    """A CONCH text tower's state dict under the reference's key names
    (model/conch/transformer.py's TextTransformer), random from `seed`,
    with `visual.*` and `text_decoder.*` decoys and a `logit_scale`."""
    g = torch.Generator().manual_seed(seed)

    def r(*shape, std=0.02):
        return torch.randn(*shape, generator=g) * std

    def ln(n):
        return 1.0 + r(n, std=0.1), r(n, std=0.1)

    W = width
    state = {prefix + "token_embedding.weight": r(vocab, W),
             prefix + "positional_embedding": r(context, W, std=0.01),
             prefix + "text_projection": r(W, output, std=W ** -0.5)}
    state[prefix + "ln_final.weight"], state[prefix + "ln_final.bias"] = ln(W)
    if cls_emb:
        state[prefix + "cls_emb"] = r(W, std=0.01)
    for i in range(layers):
        rb = f"{prefix}transformer.resblocks.{i}."
        state[rb + "ln_1.weight"], state[rb + "ln_1.bias"] = ln(W)
        state[rb + "ln_2.weight"], state[rb + "ln_2.bias"] = ln(W)
        state.update({
            rb + "attn.in_proj_weight": r(3 * W, W, std=W ** -0.5),
            rb + "attn.in_proj_bias": r(3 * W),
            rb + "attn.out_proj.weight": r(W, W, std=W ** -0.5),
            rb + "attn.out_proj.bias": r(W),
            rb + "mlp.c_fc.weight": r(4 * W, W, std=(2 * W) ** -0.5),
            rb + "mlp.c_fc.bias": r(4 * W),
            rb + "mlp.c_proj.weight": r(W, 4 * W, std=(4 * W) ** -0.5),
            rb + "mlp.c_proj.bias": r(W)})
    if decoys:
        state.update({"visual.trunk.patch_embed.proj.weight": r(W, 3, 16, 16),
                      "visual.attn_pool_contrast.q": r(W), "visual.proj_contrast": r(W, output),
                      "text_decoder.resblocks.0.attn.in_proj_weight": r(3 * W, W)})
    if logit_scale is not None:
        state["logit_scale"] = torch.tensor(float(logit_scale))
    return state


def write_conch_checkpoint(path, layout="coca", seed=0, output=SMALL["output_dim"], **kws):
    """A released-format checkpoint of the SMALL tower (its output width
    `output`) at `path`: `coca` puts the tower under `text.`, `clip` at the
    top level."""
    state = tower_state(SMALL["width"], SMALL["layers"], SMALL["vocab_size"],
                        SMALL["context_length"], output, seed=seed,
                        prefix="text." if layout == "coca" else "", **kws)
    os.makedirs(os.path.dirname(str(path)) or ".", exist_ok=True)
    torch.save(state, str(path))
    return state


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _token_ids():
    return np.asarray(Tokenizer()(PROMPTS, return_raw_tokens=False, return_num_tokens=False))


def jax_text_features(text_params, dtype):
    tower = jax_make_text_tower("CONCH", name=None, dtype=dtype,
                                **{k: v for k, v in SMALL.items()})
    ids = _token_ids()
    pseudo = jax_pseudo_tokens(ids[:, :-1], "CONCH", eos_token_id=Tokenizer().eos_token_id)
    return np.asarray(tower.apply({"params": text_params}, prompts_text=jnp.asarray(ids),
                                  prompts_pseudo_tokens=jnp.asarray(pseudo)))


def port_tower(text_state, dtype):
    tower = make_text_tower(compute_dtype={"float32": torch.float32,
                                           "bfloat16": torch.bfloat16}[dtype], **SMALL)
    tower.load_state_dict(text_state, strict=True)
    return tower


def port_text_features(tower):
    ids = _token_ids()
    pseudo = generate_pseudo_tokens(ids[:, :-1])
    with torch.no_grad():
        return tower(prompts_text=torch.as_tensor(ids),
                     prompts_pseudo_tokens=torch.as_tensor(pseudo)).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["coca", "clip"])
def test_tower_import_gives_jax_text_features(tmp_path, layout, dtype):
    path = tmp_path / "pytorch_model.bin"
    written = write_conch_checkpoint(path, layout=layout)
    want = jax_import.import_text_tower_from_checkpoint(str(path), api="CONCH")
    got = torch_import.import_text_tower_from_checkpoint(str(path), api="CONCH")
    assert got["logit_scale"] == want["logit_scale"] == 4.0
    prefix = "text." if layout == "coca" else ""
    assert torch.equal(got["text_state"]["resblocks.1.c_fc_weight"],
                       written[prefix + "transformer.resblocks.1.mlp.c_fc.weight"])
    # every tensor the port imports is the one vlsa_tpu imports
    bridged = state_dict_from_jax({"prompt_encoder": want["text_params"]})
    assert {"prompt_encoder." + k for k in got["text_state"]} == set(bridged)
    for k, v in got["text_state"].items():
        assert torch.equal(v, bridged["prompt_encoder." + k]), k
    a = port_text_features(port_tower(got["text_state"], dtype))
    b = jax_text_features(want["text_params"], dtype)
    assert a.shape == (len(PROMPTS), SMALL["output_dim"])
    assert _rel(a, b) <= (TOL_F32 if dtype == "float32" else TOL_BF16)


def test_visual_and_decoder_keys_are_ignored(tmp_path):
    write_conch_checkpoint(tmp_path / "a.bin", decoys=True)
    write_conch_checkpoint(tmp_path / "b.bin", decoys=False)
    a = torch_import.import_text_tower_from_checkpoint(str(tmp_path / "a.bin"))
    b = torch_import.import_text_tower_from_checkpoint(str(tmp_path / "b.bin"))
    assert a["text_state"].keys() == b["text_state"].keys()
    assert all(torch.equal(a["text_state"][k], b["text_state"][k]) for k in a["text_state"])
    assert not any(k.startswith(("visual", "text_decoder")) for k in a["text_state"])


def test_layer_count_comes_from_the_keys(tmp_path):
    state = tower_state(32, 3, 32007, 128, 64, prefix="text.")
    torch.save(state, str(tmp_path / "m.bin"))
    got = torch_import.import_text_tower_from_checkpoint(str(tmp_path / "m.bin"))
    assert {int(k.split(".")[1]) for k in got["text_state"] if k.startswith("resblocks.")} \
        == {0, 1, 2}


@pytest.mark.parametrize("change", [dict(width=48, heads=4), dict(layers=3)],
                         ids=["width", "layers"])
def test_a_tower_of_another_shape_raises(tmp_path, change):
    """vlsa_tpu installs whatever shapes the file has; the port loads with
    strict=True, so a tower of another width or depth raises."""
    write_conch_checkpoint(tmp_path / "m.bin")
    got = torch_import.import_text_tower_from_checkpoint(str(tmp_path / "m.bin"))
    tower = make_text_tower(**dict(SMALL, **change))
    with pytest.raises(RuntimeError, match="size mismatch|Missing key"):
        tower.load_state_dict(got["text_state"], strict=True)


def test_only_the_conch_api_is_imported(tmp_path):
    write_conch_checkpoint(tmp_path / "m.bin")
    with pytest.raises(NotImplementedError, match="A.15"):
        torch_import.import_text_tower_from_checkpoint(str(tmp_path / "m.bin"), api="CLIP")


def test_loader_takes_tensors_and_refuses_pickled_code(tmp_path):
    """weights_only=True: a reference training checkpoint ({"model": ...,
    "epoch": ...}) loads; a pickled module does not."""
    torch.save({"model": {"a": torch.ones(2, dtype=torch.float16)}, "epoch": 3},
               str(tmp_path / "train.pth"))
    got = torch_import.load_torch_state_dict(str(tmp_path / "train.pth"))
    assert list(got) == ["a"] and got["a"].dtype == torch.float32
    torch.save(torch.nn.Linear(2, 2), str(tmp_path / "module.pth"))
    with pytest.raises(Exception, match="[Ww]eights only|weights_only"):
        torch_import.load_torch_state_dict(str(tmp_path / "module.pth"))


# ---------------------------------------------------------------- VLSA, DeepMIL

TOWER = {"dtype": "float32", "width": 32, "heads": 4, "layers": 2, "output_dim": 512}


def vlsa_cfgs(asset_root, variant):
    image = {"name": "VLFAN", "dim_in": 512, "dim_hid": 256, "use_feat_proj": False,
             "pred_head": "default", "query": "Text", "num_query": 12, "query_pooling": "mean",
             "gated_query": False, "query_text_method": "TaskRes",
             "query_text_res_ratio": 0.5,
             "query_text_load_path": asset_root + "/tools/survival_text_prototypes.json",
             "query_text_load_idx": "tcga_blca_0"}
    if variant == "parameter_query":
        image.update(query="Parameter", num_query=6, use_feat_proj=True,
                     query_pooling="weight")
    prompt = {"name": "CoOp", "method": "rank", "pretrained": False, "num_ranks": 12,
              "num_base_ranks": 4, "num_tokens_per_rank": 4, "num_context_tokens": 8,
              "rank_tokens_position": "tail",
              "init_prompt_path": asset_root + "/tools/survival_prompts.json",
              "init_prompt_context_idx": 0, "init_prompt_rank_idx": 0,
              "rank_specific_context": False}
    return {"name": "mahmoodlab/conch", "frozen": True}, image, prompt


def reference_vlsa_state(port_sd, variant, seed=3):
    """The reference's learnable-parameter checkpoint (its names, the
    port's shapes), random from `seed`."""
    g = torch.Generator().manual_seed(seed)

    def like(name):
        return torch.randn(port_sd[name].shape, generator=g) * 0.1

    state = {"logit_scale": torch.tensor(3.0),
             "prompt_learner.context_embeds": like("prompt_learner.context_embeds"),
             "prompt_learner.rank_embeds": like("prompt_learner.rank_embeds"),
             "mil_encoder.visual_adapter.weight": like("mil_encoder.visual_adapter.weight"),
             "mil_encoder.visual_adapter.bias": like("mil_encoder.visual_adapter.bias")}
    if variant == "text_query":
        state["mil_encoder.Q.residual_features"] = like("query_adapter.residual_features")
    else:
        state.update({
            "mil_encoder.Q": like("mil_encoder.Q"),
            "mil_encoder.query_pooling": like("mil_encoder.query_pool_weight"),
            "mil_encoder.feat_proj.projecter.0.weight": like("mil_encoder.feat_proj.linear.weight"),
            "mil_encoder.feat_proj.projecter.0.bias": like("mil_encoder.feat_proj.linear.bias"),
            "mil_encoder.feat_proj.projecter.1.weight": like("mil_encoder.feat_proj.norm.weight"),
            "mil_encoder.feat_proj.projecter.1.bias": like("mil_encoder.feat_proj.norm.bias")})
    return state


@pytest.mark.parametrize("variant", ["text_query", "parameter_query"])
def test_vlsa_learnable_import_matches_jax(variant):
    """import_vlsa_learnable_state on a reference-named checkpoint: the
    port's result equals vlsa_tpu's import followed by the bridge, and the
    imported models give the same logits."""
    text, image, prompt = vlsa_cfgs(os.path.join(REPO, "vlsa_tpu", "assets"), variant)
    jmodel, jparams, _ = jax_build_vlsa(vlsa_api="CONCH", text_encoder_cfg=text,
                                        image_encoder_cfg=image, prompt_learner_cfg=prompt,
                                        rng=jax.random.PRNGKey(0), tower_overrides=TOWER)
    jparams = jax.tree.map(np.asarray, dict(jparams))
    text, image, prompt = vlsa_cfgs("vlsa_tpu/assets", variant)
    model, _ = build_vlsa(text, image, prompt, tower_overrides=TOWER, device="cpu",
                          state_dict=state_dict_from_jax(jparams))
    ref = reference_vlsa_state(model.state_dict(), variant)

    want = state_dict_from_jax(jax_import.import_vlsa_learnable_state(
        jparams, {k: v.numpy() for k, v in ref.items()}))
    got = torch_import.import_vlsa_learnable_state(model.state_dict(), ref)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k].float(), want[k].float()), k
    model.load_state_dict(got, strict=True)

    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 200, 512)).astype(np.float32)
    mask = np.ones((2, 200), bool)
    mask[1, 150:] = False
    jlogits = jmodel.apply({"params": jax_import.import_vlsa_learnable_state(
        jparams, {k: v.numpy() for k, v in ref.items()})}, jnp.asarray(x), jnp.asarray(mask))[0]
    with torch.no_grad():
        logits = model(torch.from_numpy(x), torch.from_numpy(mask))[0].numpy()
    assert _rel(logits, jlogits) <= TOL_LOGITS


def reference_deepmil_state(head, seed=4, D=64, hid=32, ncls=4):
    g = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, generator=g) * 0.1

    state = {"feat_proj.projecter.0.weight": r(D, D), "feat_proj.projecter.0.bias": r(D),
             "feat_proj.projecter.1.weight": 1 + r(D), "feat_proj.projecter.1.bias": r(D),
             "sigma.attention.0.weight": r(hid, D), "sigma.attention.0.bias": r(hid),
             "sigma.attention.2.weight": r(1, hid), "sigma.attention.2.bias": r(1)}
    if head == "Adapter":
        state.update({"visual_adapter.fc.0.weight": r(D // 4, D),
                      "visual_adapter.fc.2.weight": r(D, D // 4)})
    else:
        state.update({"g.weight": r(ncls, D), "g.bias": r(ncls)})
    return state


@pytest.mark.parametrize("head", ["default", "Adapter"])
def test_deepmil_import_matches_jax(head):
    ref = reference_deepmil_state(head)
    kws = dict(network="ABMIL", pooling="attention", use_feat_proj=True, pred_head=head)
    jmodel, _jparams = jax_load_model("DeepMIL", [64, 32, 4], rng=jax.random.PRNGKey(0), **kws)
    jtree = jax_import.import_deepmil_state({k: v.numpy() for k, v in ref.items()})
    want = state_dict_from_jax(jtree)
    got = torch_import.import_deepmil_state(ref)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    model = load_model("DeepMIL", [64, 32, 4], device="cpu", state_dict=got, **kws)

    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 90, 64)).astype(np.float32)
    mask = np.ones((3, 90), bool)
    mask[2, 40:] = False
    jlogits = jmodel.apply({"params": jtree}, jnp.asarray(x), jnp.asarray(mask))
    with torch.no_grad():
        logits = model(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    assert _rel(logits, jlogits) <= TOL_DEEPMIL


@pytest.mark.parametrize("key,item", [("sigma.fc1.0.weight", "A.10"),
                                      ("sigma.score.0.weight", "A.10"),
                                      ("sigma.fc2.weight", "A.10"),
                                      ("i_classifier.fc.weight", "A.10")])
def test_keys_of_unported_modules_are_refused(key, item):
    """vlsa_tpu prints a warning and drops such keys; the port refuses them
    with the ROADMAP item that ports the module."""
    state = dict(reference_deepmil_state("default"), **{key: torch.zeros(4, 4)})
    with pytest.raises(NotImplementedError, match=item):
        torch_import.import_deepmil_state(state)
    with pytest.raises(NotImplementedError, match=item):
        torch_import.import_vlsa_learnable_state({}, {"mil_encoder." + key: torch.zeros(1)})


def test_keys_without_a_counterpart_are_refused():
    with pytest.raises(ValueError, match="no counterpart"):
        torch_import.import_deepmil_state({"classifier.weight": torch.zeros(2, 2)})
    with pytest.raises(ValueError, match="no counterpart"):
        torch_import.import_vlsa_learnable_state({}, {"prompt_learner.adapter.w": torch.zeros(1)})
    with pytest.raises(KeyError, match="does not have"):
        torch_import.import_vlsa_learnable_state({}, {"logit_scale": torch.zeros(())})
