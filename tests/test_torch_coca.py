"""CoCa caption generation in the port against vlsa_tpu on the CPU: the
cross-attention block and `MultimodalDecoder`, the text tower's per-token
output, CONCH's decoder checkpoint import, the numpy processors and grouped
beam search, and `coca_generate` on every path, from CONCH's visual model to
the token ids.

Small widths (width 32, 4 heads, 2 layers, context 24, a vocabulary of 64);
inputs from a numpy seed; the JAX init's weights bridged into the port by
`state_dict_from_jax`.  Tolerances (max|a-b| / max|b|): the decoder's
logits and the per-token outputs 1e-5 (f32 on both sides, summed in another
order).  The processors, the warpers and the beam search are host numpy in
both packages and must agree bit for bit; the generated ids must be equal,
and the test holds the top-2 logit margins along each generated path above
the logit gap, so that an unequal id is a fault, not a float tie.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlsa_tpu.models import generation as jgen
from vlsa_tpu.models import multimodal as jmm
from vlsa_tpu.models import vision_tower as jvt
from vlsa_tpu.models.text_encoder import generate_pseudo_tokens as jax_pseudo
from vlsa_tpu.models.text_encoder import make_text_tower as jax_tower
from vlsa_tpu_torch.models import generation as gen
from vlsa_tpu_torch.models import multimodal as mm
from vlsa_tpu_torch.models import vision_tower as vt
from vlsa_tpu_torch.models.text_encoder import make_text_tower
from vlsa_tpu_torch.utils.weights import state_dict_from_jax

WIDTH, HEADS, LAYERS, CONTEXT, VOCAB = 32, 4, 2, 24, 64
TOWER = dict(width=WIDTH, heads=HEADS, layers=LAYERS, output_dim=16, vocab_size=VOCAB,
             context_length=CONTEXT)
DECODER = dict(width=WIDTH, heads=HEADS, layers=LAYERS, context_length=CONTEXT,
               output_dim=VOCAB)
TOL = 1e-5
SEQ_LEN, MIN_SEQ_LEN = 10, 3
# the four paths: beam search at its defaults, greedy top_k with a
# repetition penalty, sampled top_k, and top_p at a tiny temperature (its
# surviving top token then takes all the probability, as
# tests/test_generation.py runs it)
PATHS = {"beam": dict(),
         "greedy": dict(generation_type="top_k", top_k=1, repetition_penalty=1.3),
         "top_k5": dict(generation_type="top_k", top_k=5, seed=3),
         "top_p": dict(generation_type="top_p", top_p=0.1, temperature=1e-3,
                       repetition_penalty=1.3)}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_tower_params(api, seed=3):
    ref = jax_tower(api, name=None, **TOWER)
    L = ref.max_num_tokens
    pseudo = jnp.zeros((2, L), jnp.int32).at[:, :4].set(jnp.arange(1, 5))
    params = ref.init(jax.random.PRNGKey(seed), prompts_embedding=jnp.zeros((2, L, WIDTH)),
                      prompts_pseudo_tokens=pseudo)["params"]
    return ref, _np(params)


def _port_tower(api, params):
    tower = make_text_tower(api, **TOWER)
    tower.load_state_dict(state_dict_from_jax(params), strict=True)
    return tower.eval()


@pytest.fixture(scope="module")
def coca():
    """vlsa_tpu's CONCH tower and decoder (JAX init, seeds 3 and 4) and the
    port's, bridged; the decoder's text_projection drawn at width^-0.5 as
    tests/test_generation.py draws it, so the logits spread."""
    ref, tparams = _jax_tower_params("CONCH")
    dec = jmm.MultimodalDecoder(**DECODER)
    dparams = _np(dec.init(jax.random.PRNGKey(4), jnp.zeros((1, 6, WIDTH)),
                           jnp.zeros((1, SEQ_LEN, WIDTH)))["params"])
    dparams["text_projection"] = np.random.default_rng(8).normal(
        0.0, WIDTH ** -0.5, (WIDTH, VOCAB)).astype(np.float32)
    decoder = mm.MultimodalDecoder(**DECODER)
    decoder.load_state_dict(state_dict_from_jax(dparams), strict=True)
    return ref, tparams, dec, dparams, _port_tower("CONCH", tparams), decoder.eval()


# ----------------------------------------------------------------- modules

def test_cross_block_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, WIDTH)).astype(np.float32)
    kv = rng.normal(size=(2, 6, WIDTH)).astype(np.float32)
    ref = jmm.CrossResidualAttentionBlock(WIDTH, HEADS)
    params = _np(ref.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(kv))["params"])
    want = np.asarray(ref.apply({"params": params}, jnp.asarray(x), jnp.asarray(kv)))
    blk = mm.CrossResidualAttentionBlock(WIDTH, HEADS)
    blk.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = blk(torch.from_numpy(x), torch.from_numpy(kv)).numpy()
    assert _rel(got, want) <= TOL


def test_decoder_logits_match_jax(coca):
    _ref, _tp, dec, dparams, _tower, decoder = coca
    rng = np.random.default_rng(1)
    img = rng.normal(size=(3, 6, WIDTH)).astype(np.float32)
    txt = rng.normal(size=(3, 11, WIDTH)).astype(np.float32)
    want = np.asarray(dec.apply({"params": dparams}, jnp.asarray(img), jnp.asarray(txt)))
    with torch.no_grad():
        got = decoder(torch.from_numpy(img), torch.from_numpy(txt)).numpy()
    assert got.shape == (3, 11, VOCAB)
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("api", ["CONCH", "CLIP", "HF"])
def test_return_tokens_matches_jax(api):
    """Pooled features and per-token outputs: CONCH's before ln_final and
    without the <cls> slot, CLIP's and HF's after ln_final."""
    ref, params = _jax_tower_params(api)
    tower = _port_tower(api, params)
    ids = np.random.default_rng(2).integers(3, VOCAB, size=(3, 9))
    ids[1, 6:] = 0
    ids[2, 3:] = 0
    if api == "CONCH":  # the decode step's call: the ids are their own pseudo tokens
        pseudo = ids
    else:
        ids[:, 0] = 1
        ids[0, 8], ids[1, 5], ids[2, 2] = VOCAB - 1, VOCAB - 1, VOCAB - 1  # <eot>: the largest
        pseudo = jax_pseudo(ids, api, eos_token_id=VOCAB - 1)
    emb = np.asarray(ref.apply({"params": params}, jnp.asarray(ids), method=ref.embed_tokens))
    want_pooled, want_tokens = ref.apply({"params": params}, prompts_embedding=jnp.asarray(emb),
                                         prompts_pseudo_tokens=jnp.asarray(pseudo),
                                         return_tokens=True)
    with torch.no_grad():
        t_ids = torch.from_numpy(ids)
        got_pooled, got_tokens = tower(prompts_embedding=tower.embed_tokens(t_ids),
                                       prompts_pseudo_tokens=torch.from_numpy(pseudo),
                                       return_tokens=True)
        plain = tower(prompts_embedding=tower.embed_tokens(t_ids),
                      prompts_pseudo_tokens=torch.from_numpy(pseudo))
    assert got_tokens.shape == (3, 9, WIDTH)
    assert torch.equal(plain, got_pooled)
    assert _rel(got_pooled.numpy(), want_pooled) <= TOL
    assert _rel(got_tokens.numpy(), want_tokens) <= TOL


def _conch_decoder_state(layers, prefix="text_decoder."):
    """CONCH's `text_decoder.*` tensors, random from a seed."""
    rng = np.random.default_rng(9)
    D = WIDTH
    out = {}

    def put(name, *shape):
        out[prefix + name] = torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    def block(p, cross):
        for ln in ("ln_1", "ln_2") + (("ln_1_kv",) if cross else ()):
            put(f"{p}{ln}.weight", D)
            put(f"{p}{ln}.bias", D)
        put(f"{p}attn.in_proj_weight", 3 * D, D)
        put(f"{p}attn.in_proj_bias", 3 * D)
        put(f"{p}attn.out_proj.weight", D, D)
        put(f"{p}attn.out_proj.bias", D)
        put(f"{p}mlp.c_fc.weight", 4 * D, D)
        put(f"{p}mlp.c_fc.bias", 4 * D)
        put(f"{p}mlp.c_proj.weight", D, 4 * D)
        put(f"{p}mlp.c_proj.bias", D)

    for i in range(layers):
        block(f"resblocks.{i}.", False)
        block(f"cross_attn.{i}.", True)
    put("ln_final.weight", D)
    put("ln_final.bias", D)
    put("text_projection", D, VOCAB)
    return out


def test_load_multimodal_state_equals_jax_import_and_bridge():
    state = _conch_decoder_state(LAYERS)
    got = mm.load_multimodal_state(state, LAYERS)
    want = state_dict_from_jax(jmm.import_multimodal_state(
        {k: v.numpy() for k, v in state.items()}, LAYERS))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    decoder = mm.MultimodalDecoder(**DECODER)
    decoder.load_state_dict(got, strict=True)


# ------------------------------------------------ processors and beam search

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_processors_are_bit_equal(dtype):
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(5, 40)).astype(dtype)
    logits[1, 7] = logits[1, 8] = logits[1, 9]  # ties
    ids = rng.integers(0, 40, size=(5, 6))
    for cur_len in (2, 5, 9):
        np.testing.assert_array_equal(gen.min_length_process(logits, cur_len, 5, 2),
                                      jgen.min_length_process(logits, cur_len, 5, 2))
    for pen in (1.0, 1.3, 2.0):
        np.testing.assert_array_equal(gen.repetition_penalty_process(logits, ids, pen),
                                      jgen.repetition_penalty_process(logits, ids, pen))
    for k in (1, 3, 17, 40, 99):
        np.testing.assert_array_equal(gen.top_k_warp(logits, k), jgen.top_k_warp(logits, k))
    for p in (0.05, 0.1, 0.5, 0.9, 0.999):
        np.testing.assert_array_equal(gen.top_p_warp(logits, p), jgen.top_p_warp(logits, p))
    np.testing.assert_array_equal(gen.log_softmax(logits), jgen.log_softmax(logits))


def _det_step_fn(V, ties=False):
    """Deterministic per-prefix logits; with `ties`, rounded to halves so
    candidates tie and the tie-breaks decide."""
    def step(ids):
        out = np.zeros((ids.shape[0], V))
        for r, row in enumerate(ids):
            seed = int(np.sum((row.astype(np.int64) + 3)
                              * (7 ** np.arange(len(row), dtype=np.int64) % 1009)) % (2 ** 31))
            out[r] = np.random.default_rng(seed).normal(size=V)
        return np.round(out * 2) / 2 if ties else out.astype(np.float32)
    return step


@pytest.mark.parametrize("case", [
    dict(batch_size=1, num_beams=6, num_beam_groups=3, min_seq_len=5),
    dict(batch_size=3, num_beams=6, num_beam_groups=3, min_seq_len=2),
    dict(batch_size=2, num_beams=1, num_beam_groups=1, min_seq_len=3),
    dict(batch_size=2, num_beams=4, num_beam_groups=2, min_seq_len=2, diversity_penalty=0.7),
    dict(batch_size=3, num_beams=6, num_beam_groups=3, min_seq_len=2, repetition_penalty=1.3),
    dict(batch_size=2, num_beams=6, num_beam_groups=2, min_seq_len=2, ties=True),
], ids=["one", "batch3", "one_beam", "diversity", "repetition", "near_ties"])
def test_beam_search_is_bit_equal(case):
    case = dict(case)
    step = _det_step_fn(7, ties=case.pop("ties", False))
    kw = dict(seq_len=12, sot_token_id=1, eos_token_id=2, pad_token_id=0, **case)
    got = gen.beam_search(step, **kw)
    want = jgen.beam_search(step, **kw)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- generation

def _margins_and_gap(coca, img, ids):
    """Along the generated rows `ids`: the smallest top-2 margin of the
    port's logits at the generated positions, and the largest gap between
    the port's and vlsa_tpu's logits there (teacher-forced, one forward)."""
    ref, tparams, dec, dparams, tower, decoder = coca
    R = ids.shape[0]
    buf = np.zeros((R, SEQ_LEN), np.int64)
    buf[:, :ids.shape[1]] = ids
    embs = np.repeat(img, R // img.shape[0], axis=0)
    with torch.no_grad():
        port = mm.caption_logits(tower, decoder, torch.from_numpy(embs),
                                 torch.from_numpy(buf)).numpy()
    emb = ref.apply({"params": tparams}, jnp.asarray(buf), method=ref.embed_tokens)
    _p, tokens = ref.apply({"params": tparams}, prompts_embedding=emb,
                           prompts_pseudo_tokens=jnp.asarray(buf), return_tokens=True)
    want = np.asarray(dec.apply({"params": dparams}, jnp.asarray(embs), tokens))
    margins, gaps = [], []
    for r, row in enumerate(ids):
        # the positions whose logits chose a token: up to the first <eos>
        end = int(np.argmax(row == 2)) if (row == 2).any() else len(row)
        top2 = np.sort(port[r, :end], axis=-1)[:, -2:]
        margins.append((top2[:, 1] - top2[:, 0]).min())
        gaps.append(np.abs(port[r, :end] - want[r, :end]).max())
    return float(min(margins)), float(max(gaps))


@pytest.mark.parametrize("path", list(PATHS))
def test_coca_generate_matches_jax(coca, path):
    ref, tparams, dec, dparams, tower, decoder = coca
    img = np.random.default_rng(6).normal(size=(2, 6, WIDTH)).astype(np.float32)
    kw = dict(seq_len=SEQ_LEN, min_seq_len=MIN_SEQ_LEN, **PATHS[path])
    want = jmm.coca_generate(ref, tparams, dec, dparams, jnp.asarray(img), **kw)
    timings = {}
    got = mm.coca_generate(tower, decoder, torch.from_numpy(img), device="cpu",
                           timings=timings, **kw)
    assert got.dtype == np.int64 and (got[:, 0] == 1).all()
    np.testing.assert_array_equal(got, want)
    assert timings["steps"] >= 1 and timings["step_s"] > 0 and timings["host_s"] >= 0
    margin, gap = _margins_and_gap(coca, img, got)
    assert gap <= TOL and margin > 10 * gap, (margin, gap)
    if path != "beam":
        assert got.shape == (2, SEQ_LEN)
        for row in got:  # pads only after the first <eos>
            eos = int(np.argmax(row == 2))
            assert row[eos] == 2 and (row[eos + 1:] == 0).all()


def test_unknown_generation_type_raises(coca):
    _ref, _tp, _dec, _dp, tower, decoder = coca
    with pytest.raises(ValueError, match="generation_type"):
        mm.coca_generate(tower, decoder, torch.zeros(1, 6, WIDTH), device="cpu",
                         generation_type="nucleus")


def test_default_device_needs_a_card(coca):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    _ref, _tp, _dec, _dp, tower, decoder = coca
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mm.coca_generate(tower, decoder, torch.zeros(1, 6, WIDTH))


def test_conch_visual_model_to_captions_matches_jax(coca):
    """CONCH's visual model (width 64, 2 layers, 48-px images; its caption
    pool's 4 tokens at the decoder's width) into beam search and greedy
    decoding, against vlsa_tpu end to end; the port's trunk takes the plain
    attention on the CPU, vlsa_tpu's its dense path."""
    ref, tparams, dec, dparams, tower, decoder = coca
    kw = dict(layers=2, width=64, heads=4, embed_dim_contrast=64, embed_dim_caption=WIDTH,
              attn_pooler_heads=4, n_queries_caption=4, patch_size=16, image_size=48)
    imgs = np.random.default_rng(7).normal(size=(2, 3, 48, 48)).astype(np.float32)
    jmodel = jvt.ConchVisualModel(**kw)
    vparams = _np(jmodel.init(jax.random.PRNGKey(5), jnp.asarray(imgs))["params"])
    _pooled, jcap = jmodel.apply({"params": vparams}, jnp.asarray(imgs))
    model = vt.ConchVisualModel(**kw)
    model.load_state_dict(state_dict_from_jax(vparams), strict=True)
    with torch.no_grad():
        _pooled, cap = model(torch.from_numpy(imgs))
    assert cap.shape == (2, 4, WIDTH)
    assert _rel(cap.numpy(), jcap) <= TOL
    for path in ("beam", "greedy"):
        gkw = dict(seq_len=SEQ_LEN, min_seq_len=MIN_SEQ_LEN, **PATHS[path])
        want = jmm.coca_generate(ref, tparams, dec, dparams, jcap, **gkw)
        got = mm.coca_generate(tower, decoder, cap, device="cpu", **gkw)
        np.testing.assert_array_equal(got, want)
