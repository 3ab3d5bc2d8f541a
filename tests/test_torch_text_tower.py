"""The port's CONCH text tower against vlsa_tpu's, with the JAX init's
weights bridged into the port (a small tower: width 64, 4 heads, 2 layers).

Tolerances (max|a-b| / max|b|): f32 1e-5, both sides in f32 up to summation
order.  bf16 compute 2e-3: both round the matmul operands to bf16 and
accumulate in f32, so only summation order differs -- but an intermediate
whose f32 value lies within that difference of a bf16 rounding boundary
rounds to the neighbouring bf16 value on one side, a step of 2^-8 relative;
measured here: 2e-7 on two of the three prompts and 6.6e-4 on the third."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlsa_tpu.models.precision import cast_frozen_tower_weights as jax_cast
from vlsa_tpu.models.text_encoder import generate_pseudo_tokens as jax_pseudo
from vlsa_tpu.models.text_encoder import make_text_tower as jax_tower
from vlsa_tpu.models.tokenizer import Tokenizer as JaxTokenizer
from vlsa_tpu_torch.models.precision import cast_frozen_tower_weights
from vlsa_tpu_torch.models.text_encoder import generate_pseudo_tokens, make_text_tower
from vlsa_tpu_torch.utils.weights import state_dict_from_jax

SMALL = dict(width=64, heads=4, layers=2, output_dim=32)
TEXTS = ["Tumor cells within blood vessels or lymphatic channels.",
         "a histopathology image suggesting a very poor prognosis", "X."]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


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


def test_bf16_compute_with_bf16_stored_weights(towers):
    _ref, params, ids = towers
    ref = jax_tower("CONCH", name=None, dtype="bfloat16", **SMALL)
    cast = jax_cast({"prompt_encoder": params})["prompt_encoder"]
    emb, pseudo = _trimmed_inputs(params, ids)
    want = ref.apply({"params": cast}, prompts_embedding=jnp.asarray(emb),
                     prompts_pseudo_tokens=jnp.asarray(pseudo))
    tower = cast_frozen_tower_weights(_port(params, torch.bfloat16))
    assert tower.resblocks[0].c_fc_weight.dtype == torch.bfloat16
    assert tower.resblocks[0].c_fc_bias.dtype == torch.float32
    with torch.no_grad():
        got = tower(prompts_embedding=torch.from_numpy(emb),
                    prompts_pseudo_tokens=torch.from_numpy(pseudo))
    assert _rel(got.numpy(), want) < 2e-3
