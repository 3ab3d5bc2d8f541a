"""The port's CONCH text tower against vlsa_tpu's, with the JAX init's
weights bridged into the port (a small tower: width 64, 4 heads, 2 layers).

Tolerances (max|a-b| / max|b|): f32 1e-5, both sides in f32 up to summation
order.  bf16 compute: both round the matmul operands and the attention
probabilities to bf16 and accumulate in f32, so only summation order
differs -- but an intermediate whose f32 value lies within that difference
of a bf16 rounding boundary rounds to the neighbouring bf16 value on one
side, a step of 2^-8 relative, and later blocks carry the flip on.  Which
values flip depends on the host's f32 summation order: on one host the CLIP
and HF towers of tests/test_torch_clip_text.py read 2.22e-3 end to end
(one q/k element of one prompt a bf16 ulp apart in the first block, then
two of its attention probabilities), on another under 2e-3.  So the bf16
check (`bf16_gaps`) does not compare the towers end to end at 2e-3: it
holds each block's output at 2e-3 against vlsa_tpu's block fed the same
input (a flip cannot compound across blocks), and the port's end-to-end
error against vlsa_tpu's f32 tower at no more than BF16_END_TO_END times
vlsa_tpu's own bf16 tower's error against it.  A port that skips a bf16
rounding fails the block check (test_bf16_check_catches_unrounded_
probabilities)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlsa_tpu.models.precision import cast_frozen_tower_weights as jax_cast
from vlsa_tpu.models.text_encoder import ResidualAttentionBlock as JaxBlock
from vlsa_tpu.models.text_encoder import generate_pseudo_tokens as jax_pseudo
from vlsa_tpu.models.text_encoder import make_text_tower as jax_tower
from vlsa_tpu.models.tokenizer import Tokenizer as JaxTokenizer
from vlsa_tpu_torch.models.precision import cast_frozen_tower_weights
from vlsa_tpu_torch.models import text_encoder
from vlsa_tpu_torch.models.text_encoder import generate_pseudo_tokens, make_text_tower
from vlsa_tpu_torch.utils.weights import state_dict_from_jax

SMALL = dict(width=64, heads=4, layers=2, output_dim=32)
BF16_BLOCK_TOL = 2e-3
BF16_END_TO_END = 1.25
TEXTS = ["Tumor cells within blood vessels or lymphatic channels.",
         "a histopathology image suggesting a very poor prognosis", "X."]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def bf16_gaps(ref32, ref16, params, params16, port, jax_kw, port_kw):
    """The bf16 check's numbers: (each block's gap, the port's end-to-end
    error, vlsa_tpu's own).  Block i of the port and vlsa_tpu's block i (its
    bf16 weights `params16`) are fed the same input -- the port's own at
    block 0, vlsa_tpu's bf16 tower's at the others -- and the port's mask;
    the end-to-end errors are the port's bf16 tower's and vlsa_tpu's bf16
    tower's against vlsa_tpu's f32 tower (`params`).  Gaps are max|a-b| /
    max|b|."""
    want16, state = ref16.apply({"params": params16}, **jax_kw, capture_intermediates=True)
    want32 = ref32.apply({"params": params}, **jax_kw)
    seen = []
    hooks = [blk.register_forward_pre_hook(lambda _m, args: seen.append(args))
             for blk in port.resblocks]
    try:
        with torch.no_grad():
            got = port(**port_kw)
    finally:
        for h in hooks:
            h.remove()
    inter = state["intermediates"]
    blocks = []
    for i, (x, mask) in enumerate(seen):
        if i > 0:
            x = torch.from_numpy(np.array(inter[f"resblock_{i - 1}"]["__call__"][0]))
        ref_block = JaxBlock(ref16.width, ref16.heads, quick_gelu=ref16.api != "CONCH",
                             compute_dtype="bfloat16")
        want = ref_block.apply({"params": params16[f"resblock_{i}"]}, jnp.asarray(x.numpy()),
                               None if mask is None else jnp.asarray(mask.numpy()))
        with torch.no_grad():
            blocks.append(_rel(port.resblocks[i](x, mask).numpy(), want))
    return blocks, _rel(got.numpy(), want32), _rel(want16, want32)


def assert_bf16_tower(gaps):
    blocks, port_err, ref_err = gaps
    assert max(blocks) < BF16_BLOCK_TOL, blocks
    assert port_err <= BF16_END_TO_END * ref_err, (port_err, ref_err)


def _forward_without_prob_rounding(self, x, attn_mask=None):
    """TorchMultiheadAttention.forward with the bf16 rounding of the
    attention probabilities left out: the mutation the bf16 check must
    catch."""
    K, L, D = x.shape
    H, cdt = self.heads, self.compute_dtype
    qkv = text_encoder._mm(x, self.in_proj_weight, cdt) + self.in_proj_bias

    def heads(t):
        return t.reshape(K, L, H, D // H).transpose(1, 2).to(cdt).float()

    q, k, v = (heads(t) for t in qkv.split(D, dim=-1))
    logits = (q @ k.transpose(-1, -2)) / (D // H) ** 0.5
    if attn_mask is not None:
        logits = logits + attn_mask
    ctx = (torch.softmax(logits, dim=-1) @ v).transpose(1, 2).reshape(K, L, D)
    return text_encoder._mm(ctx, self.out_proj_weight, cdt) + self.out_proj_bias


@pytest.fixture(scope="module")
def towers():
    ref = jax_tower("CONCH", name=None, **SMALL)
    L = ref.max_num_tokens
    params = ref.init(jax.random.PRNGKey(0), prompts_embedding=jnp.zeros((2, L, 64)),
                      prompts_pseudo_tokens=jnp.zeros((2, L), jnp.int32))["params"]
    params = jax.tree.map(np.asarray, params)
    ids = JaxTokenizer(api="CONCH")(TEXTS, return_raw_tokens=False, return_num_tokens=False)
    return ref, params, ids


def _port(params, dtype=torch.float32):
    tower = make_text_tower(compute_dtype=dtype, **SMALL)
    tower.load_state_dict(state_dict_from_jax(params), strict=True)
    return tower.eval()


def test_token_ids_forward_f32(towers):
    ref, params, ids = towers
    want = ref.apply({"params": params}, prompts_text=jnp.asarray(ids))
    with torch.no_grad():
        got = _port(params)(prompts_text=torch.as_tensor(ids))
    assert got.shape == (len(TEXTS), SMALL["output_dim"])
    assert _rel(got.numpy(), want) < 1e-5


def _trimmed_inputs(params, ids, trim=16):
    body = ids[:, :-1]
    pseudo = jax_pseudo(body, "CONCH")
    np.testing.assert_array_equal(pseudo, generate_pseudo_tokens(body))
    emb = np.asarray(params["token_embedding"])[body]
    return emb[:, :trim].astype(np.float32), pseudo[:, :trim]


def test_trimmed_embeddings_f32(towers):
    ref, params, ids = towers
    emb, pseudo = _trimmed_inputs(params, ids)
    want = ref.apply({"params": params}, prompts_embedding=jnp.asarray(emb),
                     prompts_pseudo_tokens=jnp.asarray(pseudo))
    full = ref.apply({"params": params}, prompts_text=jnp.asarray(ids))
    assert _rel(want, full) < 1e-5  # trimming is exact in the reference too
    with torch.no_grad():
        got = _port(params)(prompts_embedding=torch.from_numpy(emb),
                            prompts_pseudo_tokens=torch.from_numpy(pseudo))
    assert _rel(got.numpy(), want) < 1e-5


def _bf16_conch_gaps(params, ids):
    ref = jax_tower("CONCH", name=None, dtype="bfloat16", **SMALL)
    cast = jax_cast({"prompt_encoder": params})["prompt_encoder"]
    emb, pseudo = _trimmed_inputs(params, ids)
    tower = cast_frozen_tower_weights(_port(params, torch.bfloat16))
    assert tower.resblocks[0].c_fc_weight.dtype == torch.bfloat16
    assert tower.resblocks[0].c_fc_bias.dtype == torch.float32
    return bf16_gaps(
        jax_tower("CONCH", name=None, **SMALL), ref, params, cast, tower,
        dict(prompts_embedding=jnp.asarray(emb), prompts_pseudo_tokens=jnp.asarray(pseudo)),
        dict(prompts_embedding=torch.from_numpy(emb), prompts_pseudo_tokens=torch.from_numpy(pseudo)))


def test_bf16_compute_with_bf16_stored_weights(towers):
    _ref, params, ids = towers
    assert_bf16_tower(_bf16_conch_gaps(params, ids))


def test_bf16_check_catches_unrounded_probabilities(towers, monkeypatch):
    _ref, params, ids = towers
    monkeypatch.setattr(text_encoder.TorchMultiheadAttention, "forward",
                        _forward_without_prob_rounding)
    blocks, _port_err, _ref_err = _bf16_conch_gaps(params, ids)
    assert max(blocks) >= BF16_BLOCK_TOL, blocks


def test_full_width_bf16_prototypes_match_jax():
    """The full-width CONCH text tower (width 768, 12 heads, 12 layers, as
    the flagship runs it) in bf16 with its frozen weights stored in bf16,
    against vlsa_tpu's on the CPU by the rounding-flip rule of this file:
    each of the 12 blocks within BF16_BLOCK_TOL of vlsa_tpu's fed the same
    input, and the prototypes' error against vlsa_tpu's f32 tower within
    BF16_END_TO_END times vlsa_tpu's own bf16 error (measured: blocks up to
    1.6e-3; 5.3e-3 against vlsa_tpu's 4.8e-3)."""
    ref = jax_tower("CONCH", name=None)
    assert (ref.width, ref.heads, ref.layers) == (768, 12, 12)
    L = ref.max_num_tokens
    params = ref.init(jax.random.PRNGKey(0), prompts_embedding=jnp.zeros((2, L, ref.width)),
                      prompts_pseudo_tokens=jnp.zeros((2, L), jnp.int32))["params"]
    params = jax.tree.map(np.asarray, params)
    ids = JaxTokenizer(api="CONCH")(TEXTS, return_raw_tokens=False, return_num_tokens=False)
    emb, pseudo = _trimmed_inputs(params, ids, trim=32)
    tower = make_text_tower(compute_dtype=torch.bfloat16)
    tower.load_state_dict(state_dict_from_jax(params), strict=True)
    tower = cast_frozen_tower_weights(tower.eval())
    gaps = bf16_gaps(
        ref, jax_tower("CONCH", name=None, dtype="bfloat16"), params,
        jax_cast({"prompt_encoder": params})["prompt_encoder"], tower,
        dict(prompts_embedding=jnp.asarray(emb), prompts_pseudo_tokens=jnp.asarray(pseudo)),
        dict(prompts_embedding=torch.from_numpy(emb), prompts_pseudo_tokens=torch.from_numpy(pseudo)))
    assert len(gaps[0]) == 12
    assert_bf16_tower(gaps)
