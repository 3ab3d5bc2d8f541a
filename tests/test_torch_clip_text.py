"""The CLIP and HF text APIs: the port's pure-Python tokenizers, HF directory
export, text towers and whole VLSA model against vlsa_tpu's.

vlsa_tpu's CLIP tokenizer splits with the `regex` package, its HF tokenizer
is transformers' CLIPTokenizerFast read from the directory that
`export_hf_clip_tokenizer` writes; the port has neither package.  UNICODE_CASES
holds text where a close copy goes wrong: superscripts and fractions
(category No, which `re`'s `\\w` takes as letters), Roman numerals and
circled digits, HTML entities (which CLIP unescapes and HF does not),
control whitespace (U+001C, which `re`'s `\\s` takes and `regex`'s does
not), full-width letters, emoji, contractions, a final capital sigma
(str.lower() gives "ς", the tokenizers normaliser "σ"), special tokens in
the text, and a text past CLIP's 77-token context.

Towers (width 64, 4 heads, 2 layers; vlsa_tpu's init bridged into the port):
f32 within 1e-5 of max|b|; bf16 compute by tests/test_torch_text_tower.py's
`bf16_gaps` (each block within 2e-3 of vlsa_tpu's fed the same input, the
end-to-end error against vlsa_tpu's f32 tower at most 1.25 times vlsa_tpu's
own bf16 error; that file says why the towers are not compared end to end
at 2e-3 in bf16).  The whole small flagship
VLSA with `vlsa_api` CLIP and HF: text features 1e-5 and logits 1e-4
(tests/test_torch_vlsa.py's limits), and one Adam step of SurvIFMLE +
SurvEMD with tests/test_torch_train.py's limits (loss 1e-4 relative,
parameters 1e-5 + 1e-4 |b|, NEAR_ZERO_GRADIENT's exception).
"""
import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_text_tower import (BF16_BLOCK_TOL, _forward_without_prob_rounding,
                                   assert_bf16_tower, bf16_gaps)
from test_torch_train import (LOSSES, LR, NEAR_ZERO_GRADIENT, WD, WEIGHTS, _batches,
                              _tensors)
from test_torch_vlsa import REPO, TOWER, flagship_cfgs
from vlsa_tpu.losses import load_loss as jax_load_loss
from vlsa_tpu.models.clip_bpe import ClipBPETokenizer as JaxClipBPE
from vlsa_tpu.models.clip_bpe import clip_tokenize as jax_clip_tokenize
from vlsa_tpu.models.hf_export import export_hf_clip_tokenizer as jax_export
from vlsa_tpu.models.text_encoder import generate_pseudo_tokens as jax_pseudo
from vlsa_tpu.models.text_encoder import make_text_tower as jax_tower
from vlsa_tpu.models.tokenizer import Tokenizer as JaxTokenizer
from vlsa_tpu.models.vlsa_build import build_vlsa as jax_build_vlsa
from vlsa_tpu.optim import create_optimizer as jax_create_optimizer
from vlsa_tpu.optim import frozen_mask_from_cfg as jax_frozen_mask
from vlsa_tpu.runner.engine import TrainEngine as JaxTrainEngine
from vlsa_tpu.runner.engine import make_objective as jax_make_objective
from vlsa_tpu.runner.engine import make_output_converter as jax_converter
from vlsa_tpu_torch.data.io import resolve_asset
from vlsa_tpu_torch.losses import load_loss
from vlsa_tpu_torch.models.clip_bpe import DEFAULT_BPE_PATH, ClipBPETokenizer, clip_tokenize
from vlsa_tpu_torch.models.hf_export import export_hf_clip_tokenizer
from vlsa_tpu_torch.models import text_encoder
from vlsa_tpu_torch.models.text_encoder import generate_pseudo_tokens, make_text_tower
from vlsa_tpu_torch.models.tokenizer import Tokenizer
from vlsa_tpu_torch.models.vlsa_build import build_vlsa
from vlsa_tpu_torch.optim import create_optimizer, frozen_mask_from_cfg
from vlsa_tpu_torch.runner.engine import TrainEngine, make_objective, make_output_converter
from vlsa_tpu_torch.utils import torch_import
from vlsa_tpu_torch.utils.weights import jax_tree_from_state_dict, state_dict_from_jax

UNICODE_CASES = [
    "12,5 mg/m²", "T²N¹", "dose ½mg", "stage Ⅳ ①", "x² y³ 10⁻³ mm²", "H₂O CO₂",
    "&amp; &lt;b&gt; &quot;q&quot; &#39;s &amp;amp; &nbsp;x",
    "tabs\tand\nnewlines\r\n  spaced   out\x0b\x0c\x1c\x85  　end",
    "Café naïve résumé ÀÉÎÕÜ ñ ß œ Ångström", "ﬁne ﬂow",
    "ＦＵＬＬ－ｗｉｄｔｈ ＡＢＣ１２３", "emoji 🧬🔬 tumor 👩‍⚕️",
    "it's we're they've I'm you'll he'd IT'S DON'T", "ΟΔΟΣ Σίσυφος", "İstanbul ǅ ǈ",
    "aͅb ͅ", "<|startoftext|> <|endoftext|> <|ENDOFTEXT|>", "ſ's <|ſtartoftext|>",
    "grade_3 __init__ Ki-67 1,234.5 40x", "", "   ",
]
OVERFLOW = "x" + " word" * 90  # 93 ids: past CLIP's 77-token context
SMALL = dict(width=64, heads=4, layers=2, output_dim=32)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.fixture(scope="module")
def hf_root(tmp_path_factory):
    """A directory `hf` written by vlsa_tpu's exporter, beside the port's."""
    root = tmp_path_factory.mktemp("hf_tokenizer")
    jax_export(str(root / "hf"))
    export_hf_clip_tokenizer(str(root / "port_hf"))
    return str(root)


# ---------------------------------------------------------------- tokenizers

def test_bpe_asset_is_the_port_copy():
    assert resolve_asset("vlsa_tpu/assets/tokenizers/bpe_simple_vocab_16e6.txt.gz") \
        == DEFAULT_BPE_PATH
    assert filecmp.cmp(DEFAULT_BPE_PATH, os.path.join(
        REPO, "vlsa_tpu", "assets", "tokenizers", "bpe_simple_vocab_16e6.txt.gz"), shallow=False)


@pytest.mark.parametrize("truncate", [False, True])
def test_clip_ids_match_regex_tokenizer(truncate):
    port, ref = ClipBPETokenizer(), JaxClipBPE()
    for text in UNICODE_CASES:
        assert port.encode(text) == ref.encode(text), text
    np.testing.assert_array_equal(clip_tokenize(port, UNICODE_CASES, truncate=truncate),
                                  jax_clip_tokenize(ref, UNICODE_CASES, truncate=truncate))
    if truncate:
        got = clip_tokenize(port, [OVERFLOW], truncate=True)
        np.testing.assert_array_equal(got, jax_clip_tokenize(ref, [OVERFLOW], truncate=True))
        assert got[0, -1] == port.eot_token
    else:
        with pytest.raises(RuntimeError, match="too long"):
            jax_clip_tokenize(ref, [OVERFLOW])
        with pytest.raises(RuntimeError, match="too long"):
            clip_tokenize(port, [OVERFLOW])


@pytest.mark.parametrize("raw", [True, False])
def test_clip_facade_matches(raw):
    port, ref = Tokenizer(api="CLIP"), JaxTokenizer(api="CLIP")
    assert (port.pad_token_id, port.bos_token_id, port.eos_token_id) == \
        (ref.pad_token_id, ref.bos_token_id, ref.eos_token_id) == (0, 49406, 49407)
    ids, cnt = port(UNICODE_CASES, return_raw_tokens=raw)
    want, want_cnt = ref(UNICODE_CASES, return_raw_tokens=raw)
    np.testing.assert_array_equal(ids, want)
    np.testing.assert_array_equal(cnt, want_cnt)
    for text in ("X.", UNICODE_CASES[0]):  # the single-string surface
        got1, c1 = port(text, return_raw_tokens=raw)
        want1, w1 = ref(text, return_raw_tokens=raw)
        np.testing.assert_array_equal(got1, want1)
        assert c1 == w1


@pytest.mark.parametrize("raw", [True, False])
def test_hf_ids_match_transformers(hf_root, raw):
    """One batch: the HF api pads to the longest text (the overflow, which it
    does not truncate) with the directory's pad token."""
    port = Tokenizer(root=hf_root, name="port_hf", api="HF")
    ref = JaxTokenizer(root=hf_root, name="hf", api="HF")
    assert (port.pad_token_id, port.bos_token_id, port.eos_token_id) == \
        (ref.pad_token_id, ref.bos_token_id, ref.eos_token_id) == (49407, 49406, 49407)
    texts = UNICODE_CASES + [OVERFLOW]
    ids, cnt = port(texts, return_raw_tokens=raw)
    want, want_cnt = ref(texts, return_raw_tokens=raw)
    assert ids.dtype == want.dtype and ids.shape[1] == (91 if raw else 93)
    np.testing.assert_array_equal(ids, want)
    np.testing.assert_array_equal(cnt, want_cnt)
    got1, c1 = port("X.", return_raw_tokens=raw)
    want1, w1 = ref("X.", return_raw_tokens=raw)
    np.testing.assert_array_equal(got1, want1)
    assert c1 == w1 == 2


def test_export_writes_vlsa_tpu_files(hf_root):
    names = sorted(os.listdir(os.path.join(hf_root, "hf")))
    assert names == sorted(os.listdir(os.path.join(hf_root, "port_hf"))) == \
        ["merges.txt", "special_tokens_map.json", "tokenizer_config.json", "vocab.json"]
    for name in names:
        assert filecmp.cmp(os.path.join(hf_root, "hf", name),
                           os.path.join(hf_root, "port_hf", name), shallow=False), name


@pytest.mark.parametrize("change", ["no_merges", "other_class", "no_directory"])
def test_hf_refuses_what_it_cannot_read(hf_root, tmp_path, change):
    import json
    import shutil
    path = str(tmp_path / "tok")
    shutil.copytree(os.path.join(hf_root, "port_hf"), path)
    if change == "no_merges":
        os.remove(os.path.join(path, "merges.txt"))
        match = "merges.txt"
    elif change == "other_class":
        with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
            json.dump({"tokenizer_class": "BertTokenizer"}, f)
        match = "BertTokenizer"
    else:
        path, match = str(tmp_path / "missing"), "vocab.json"
    with pytest.raises(ValueError, match=match):
        Tokenizer(root=path, api="HF")


# ---------------------------------------------------------------- towers

def _jax_params(api):
    ref = jax_tower(api, name=None, **SMALL)
    L = ref.max_num_tokens
    pseudo = jnp.zeros((2, L), jnp.int32).at[:, :4].set(jnp.arange(1, 5))
    params = ref.init(jax.random.PRNGKey(3), prompts_embedding=jnp.zeros((2, L, 64)),
                      prompts_pseudo_tokens=pseudo)["params"]
    return ref, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module", params=["CLIP", "HF"])
def towers(request, hf_root):
    api = request.param
    ref, params = _jax_params(api)
    tok = (JaxTokenizer(api="CLIP") if api == "CLIP"
           else JaxTokenizer(root=hf_root, name="hf", api="HF"))
    texts = ["Tumor cells within blood vessels or lymphatic channels.", "X.",
             "a histopathology image suggesting a very poor prognosis"]
    ids = tok(texts, return_raw_tokens=False, return_num_tokens=False)
    pseudo = jax_pseudo(ids, api, eos_token_id=tok.eos_token_id)
    return api, ref, params, ids, pseudo, tok.eos_token_id


def _port_tower(api, params, dtype=torch.float32):
    tower = make_text_tower(api, compute_dtype=dtype, **SMALL)
    tower.load_state_dict(state_dict_from_jax(params), strict=True)
    return tower.eval()


def test_tower_has_no_cls_and_quick_gelu(towers):
    api, _ref, params, *_ = towers
    assert "cls_emb" not in params
    tower = _port_tower(api, params)
    assert tower.max_num_tokens == 77 and not hasattr(tower, "cls_emb")
    x = torch.linspace(-3, 3, 7)
    assert torch.equal(tower.resblocks[0].act(x), x * torch.sigmoid(1.702 * x))


def _check_tower(api, params, dtype, tol, jax_kw, port_kw):
    """f32: the port's tower against vlsa_tpu's within `tol`; bf16: the
    block-wise check of `bf16_gaps` (each block within `tol`)."""
    assert dtype == "float32" or tol == BF16_BLOCK_TOL
    tower = _port_tower(api, params, getattr(torch, dtype))
    if dtype == "bfloat16":
        assert_bf16_tower(bf16_gaps(jax_tower(api, name=None, **SMALL),
                                    jax_tower(api, name=None, dtype=dtype, **SMALL),
                                    params, params, tower, jax_kw, port_kw))
        return
    want = jax_tower(api, name=None, **SMALL).apply({"params": params}, **jax_kw)
    with torch.no_grad():
        got = tower(**port_kw)
    assert got.shape == (3, SMALL["output_dim"])
    assert _rel(got.numpy(), want) < tol


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-3)])
def test_tower_from_token_ids(towers, dtype, tol):
    api, _ref, params, ids, pseudo, eos = towers
    np.testing.assert_array_equal(generate_pseudo_tokens(ids, api, eos_token_id=eos), pseudo)
    _check_tower(api, params, dtype, tol,
                 dict(prompts_text=jnp.asarray(ids), prompts_pseudo_tokens=jnp.asarray(pseudo)),
                 dict(prompts_text=torch.as_tensor(ids),
                      prompts_pseudo_tokens=torch.as_tensor(pseudo)))


def _trimmed(params, ids, pseudo):
    return params["token_embedding"][ids][:, :16].astype(np.float32), pseudo[:, :16]


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-3)])
def test_tower_from_trimmed_embeddings(towers, dtype, tol):
    api, _ref, params, ids, pseudo, _eos = towers
    emb, pseudo = _trimmed(params, ids, pseudo)
    _check_tower(api, params, dtype, tol,
                 dict(prompts_embedding=jnp.asarray(emb),
                      prompts_pseudo_tokens=jnp.asarray(pseudo)),
                 dict(prompts_embedding=torch.from_numpy(emb),
                      prompts_pseudo_tokens=torch.from_numpy(pseudo)))


def test_bf16_check_catches_unrounded_probabilities(towers, monkeypatch):
    """The bf16 check fails a port that leaves the attention probabilities
    unrounded (tests/test_torch_text_tower.py's mutation)."""
    api, _ref, params, ids, pseudo, _eos = towers
    monkeypatch.setattr(text_encoder.TorchMultiheadAttention, "forward",
                        _forward_without_prob_rounding)
    emb, pseudo = _trimmed(params, ids, pseudo)
    blocks, _port_err, _ref_err = bf16_gaps(
        jax_tower(api, name=None, **SMALL), jax_tower(api, name=None, dtype="bfloat16", **SMALL),
        params, params, _port_tower(api, params, torch.bfloat16),
        dict(prompts_embedding=jnp.asarray(emb), prompts_pseudo_tokens=jnp.asarray(pseudo)),
        dict(prompts_embedding=torch.from_numpy(emb), prompts_pseudo_tokens=torch.from_numpy(pseudo)))
    assert max(blocks) >= BF16_BLOCK_TOL, blocks


def test_hf_pad_keys_are_masked(towers):
    """tests/test_text_hf.py's invariance: tokens past the eos change nothing
    (HF masks them as keys; CLIP's causal mask keeps them from the eos)."""
    api, _ref, params, ids, pseudo, _eos = towers
    tower = _port_tower(api, params)
    emb = params["token_embedding"][ids].astype(np.float32)
    mutated = emb.copy()
    mutated[1, 5:] = params["token_embedding"][33]
    with torch.no_grad():
        base = tower(prompts_embedding=torch.from_numpy(emb),
                     prompts_pseudo_tokens=torch.from_numpy(pseudo))
        mut = tower(prompts_embedding=torch.from_numpy(mutated),
                    prompts_pseudo_tokens=torch.from_numpy(pseudo))
    np.testing.assert_allclose(mut.numpy(), base.numpy(), rtol=1e-6, atol=1e-7)


def test_token_ids_without_pseudo_tokens(towers):
    """CLIP derives the pseudo tokens from the ids (the eot id is the
    largest); HF cannot find its eos without the id, and both packages
    refuse."""
    api, ref, params, ids, _pseudo, _eos = towers
    tower = _port_tower(api, params)
    if api == "HF":
        with pytest.raises(AssertionError):
            ref.apply({"params": params}, prompts_text=jnp.asarray(ids))
        with pytest.raises(ValueError, match="eos_token_id"):
            tower(prompts_text=torch.as_tensor(ids))
        return
    want = ref.apply({"params": params}, prompts_text=jnp.asarray(ids))
    with torch.no_grad():
        got = tower(prompts_text=torch.as_tensor(ids))
    assert _rel(got.numpy(), want) < 1e-5


def test_weight_bridge_round_trip(towers):
    api, _ref, params, *_ = towers
    sd = state_dict_from_jax(params)
    tower = make_text_tower(api, **SMALL)
    tower.load_state_dict(sd, strict=True)
    back = jax_tree_from_state_dict(tower.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(lambda a: a, params))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(params),
                            jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_import_clip_layout_checkpoint(towers, tmp_path):
    """An OpenAI-CLIP state dict (text keys at the top level, no cls_emb,
    `visual.*` beside them) written with torch.save."""
    api, _ref, params, *_ = towers
    tower = _port_tower(api, params)
    state = {"logit_scale": torch.tensor(4.2), "visual.proj": torch.ones(3)}
    for k, v in tower.state_dict().items():
        if k.startswith("resblocks."):
            _blk, i, rest = k.split(".", 2)
            rest = {"attn.out_proj_weight": "attn.out_proj.weight",
                    "attn.out_proj_bias": "attn.out_proj.bias",
                    "c_fc_weight": "mlp.c_fc.weight", "c_fc_bias": "mlp.c_fc.bias",
                    "c_proj_weight": "mlp.c_proj.weight",
                    "c_proj_bias": "mlp.c_proj.bias"}.get(rest, rest)
            k = f"transformer.resblocks.{i}.{rest}"
        elif k == "token_embedding":
            k = "token_embedding.weight"
        state[k] = v.clone()
    torch.save(state, str(tmp_path / "clip.pt"))
    got = torch_import.import_text_tower_from_checkpoint(str(tmp_path / "clip.pt"), api=api)
    assert got["logit_scale"] == pytest.approx(4.2)
    fresh = make_text_tower(api, **SMALL)
    fresh.load_state_dict(got["text_state"], strict=True)
    for k, v in tower.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


# ---------------------------------------------------------------- the VLSA model

@pytest.fixture(scope="module", params=["CLIP", "HF"])
def vlsa_pair(request, hf_root):
    api = request.param
    text, image, prompt = flagship_cfgs(os.path.join(REPO, "vlsa_tpu", "assets"))
    text = dict(text, name="hf")
    jmodel, jparams, _tok = jax_build_vlsa(
        vlsa_api=api, text_encoder_cfg=text, image_encoder_cfg=image,
        prompt_learner_cfg=prompt, rng=jax.random.PRNGKey(0), tower_overrides=TOWER,
        path_clip_model=hf_root)
    jparams = jax.tree.map(np.asarray, dict(jparams))
    text, image, prompt = flagship_cfgs("vlsa_tpu/assets")
    text = dict(text, name="port_hf")
    sd = state_dict_from_jax(jparams)

    def port(state_dict):
        return build_vlsa(text, image, prompt, vlsa_api=api, tower_overrides=TOWER,
                          device="cpu", state_dict=state_dict, path_clip_model=hf_root)[0]
    return api, jmodel, jparams, sd, port


def test_vlsa_serves_as_vlsa_tpu(vlsa_pair):
    api, jmodel, jparams, sd, port = vlsa_pair
    model = port(sd)
    assert set(model.state_dict()) == set(sd) and "prompt_encoder.cls_emb" not in sd
    assert model.text_trim_len == jmodel.text_trim_len
    jtext, jquery = jmodel.apply({"params": jparams}, method=jmodel.text_precompute)
    with torch.no_grad():
        text, query = model.text_precompute()
    assert _rel(text.numpy(), jtext) < 1e-5 and _rel(query.numpy(), jquery) < 1e-5
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 200, 512)).astype(np.float32)
    mask = np.ones((3, 200), bool)
    mask[1, 150:] = mask[2, 90:] = False
    x[~mask] = 0.0
    want, _img, _txt = jmodel.apply({"params": jparams}, jnp.asarray(x), jnp.asarray(mask))
    with torch.no_grad():
        got, _img, _txt = model(torch.from_numpy(x), torch.from_numpy(mask))
    assert got.shape == (3, 12) and _rel(got.numpy(), want) < 1e-4


# the logit scale a CLIP or HF checkpoint brings (`logit_scale` of its file,
# the log of CLIP's trained 100): chip_smoke.py phase 3p imports it
IMPORTED_LOGIT_SCALE = 4.5


def test_vlsa_serves_as_vlsa_tpu_at_an_imported_logit_scale(vlsa_pair):
    """Served logits at a checkpoint's logit scale, exp(4.5) = 90, which
    multiplies any gap of the cosines ~18x over the random tower's initial
    scale (ROADMAP.md §C): both models built with the scale a checkpoint
    imports (`logit_scale` in the weights, as `vl_weights` sets it), the
    logits within test_vlsa_serves_as_vlsa_tpu's 1e-4."""
    api, jmodel, jparams, sd, port = vlsa_pair
    jparams = dict(jparams, logit_scale=np.asarray(IMPORTED_LOGIT_SCALE, np.float32))
    model = port(dict(sd, logit_scale=torch.tensor(IMPORTED_LOGIT_SCALE)))
    assert float(model.get_logit_scale().detach()) == pytest.approx(np.exp(IMPORTED_LOGIT_SCALE))
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 200, 512)).astype(np.float32)
    mask = np.ones((3, 200), bool)
    mask[1, 120:] = mask[2, 60:] = False
    x[~mask] = 0.0
    want, _img, _txt = jmodel.apply({"params": jparams}, jnp.asarray(x), jnp.asarray(mask))
    with torch.no_grad():
        got, _img, _txt = model(torch.from_numpy(x), torch.from_numpy(mask))
    assert got.shape == (3, 12) and _rel(got.numpy(), want) < 1e-4


def test_vlsa_training_step_as_vlsa_tpu(vlsa_pair):
    api, jmodel, jparams, sd, port = vlsa_pair
    frozen = jax_frozen_mask(jparams, ["prompt_encoder"])
    tx = jax_create_optimizer("adam", LR, WD, jparams, frozen=frozen)
    objective = jax_make_objective(jax_load_loss("vlsa", **LOSSES), WEIGHTS,
                                   jax_converter("softmax"), uses_vl=True)
    step = JaxTrainEngine(jmodel, tx, objective, uses_vl=True, frozen=frozen).train_step()
    batch = _batches(n=1)[0]
    p, _state, jloss, _raw = step(jax.tree.map(jnp.asarray, jparams), tx.init(jparams),
                                  {k: jnp.asarray(v) for k, v in batch.items()},
                                  jax.random.PRNGKey(0))
    want = state_dict_from_jax(jax.tree.map(np.asarray, p))

    model = port(sd)
    model.train()
    frozen_mask_from_cfg(model, ["prompt_encoder"])
    engine = TrainEngine(model, create_optimizer("adam", LR, WD, model),
                         make_objective(load_loss("vlsa", **LOSSES), WEIGHTS,
                                        make_output_converter("softmax")))
    loss, _raw = engine.train_step(_tensors(batch))
    grad = {n: q.grad.abs().numpy() for n, q in model.named_parameters() if q.grad is not None}
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    for name, got in model.state_dict().items():
        got, ref = got.float().numpy(), want[name].float().numpy()
        ok = np.abs(got - ref) <= 1e-5 + 1e-4 * np.abs(ref)
        if name in NEAR_ZERO_GRADIENT:
            near_zero = grad[name] < 1e-4 * grad[name].max()
            ok |= near_zero & (np.abs(got - ref) <= 2 * LR)
        assert np.all(ok), f"{api} {name}: max |a-b| {np.abs(got - ref)[~ok].max():.3e}"
    assert not np.array_equal(model.state_dict()["prompt_learner.context_embeds"].numpy(),
                              sd["prompt_learner.context_embeds"].numpy())
