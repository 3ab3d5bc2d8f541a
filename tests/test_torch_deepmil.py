"""The port's DeepMIL (ABMIL attention, mean and max pooling; default and
Adapter heads; with and without the feature projecter) against vlsa_tpu's
`load_model("DeepMIL", ...)`, its parameters carried over by the weight
bridge with strict loading.

Tolerances (max|a-b| / max|b| of the logits; measured in brackets):
  - f32 storage: 1e-5 -- both sides f32, summation order apart [6.4e-7];
  - int8 storage: 1e-5 on the raw-feature attention path (the JAX CPU path
    dequantizes, the port's plain version scales x_i . W1^T by s[n]: the
    same f32 products in another order) [2.3e-7];
  - bf16 storage on the attention path: 2e-2.  On the CPU the JAX model
    takes `abmil_pool_reference` with W1 in f32, while the port's plain
    version rounds W1 to bf16 as the TPU kernel does (tests/test_models.py
    ::test_abmil_bf16_storage_accuracy allows 2e-2 for that gap) [5.3e-4];
  - bf16 features elsewhere (bf16 storage, and int8 dequantized to bf16
    before a projecter or mean/max pooling): 1e-2, one bf16 ulp (2^-8) of a
    mean or projection that the two packages sum in another order [3.3e-3].
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlsa_tpu.models import load_model as jax_load_model
from vlsa_tpu_torch.data.quant import quantize_feats_int8
from vlsa_tpu_torch.models.mil import DeepMIL
from vlsa_tpu_torch.models.registry import load_model
from vlsa_tpu_torch.optim.factory import decay_mask
from vlsa_tpu_torch.utils.weights import state_dict_from_jax

D, HID, K = 64, 32, 4

CASES = {
    "abmil": dict(network="ABMIL", use_feat_proj=False),
    "abmil_featproj_adapter": dict(network="ABMIL", use_feat_proj=True, pred_head="Adapter"),
    "mean": dict(network="MeanMIL", use_feat_proj=False),
    "max_featproj": dict(network="MaxMIL", use_feat_proj=True),
    "mean_adapter": dict(network="MeanMIL", use_feat_proj=False, pred_head="Adapter",
                         keep_ratio=0.6),
}
# storage -> (tolerance where the features reach the ABMIL pooling raw, elsewhere)
TOL = {"float32": (1e-5, 1e-5), "int8": (1e-5, 1e-2), "bfloat16": (2e-2, 1e-2)}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _bags(lengths, seed=0):
    rng = np.random.default_rng(seed)
    x = np.zeros((len(lengths), max(lengths), D), np.float32)
    mask = np.zeros(x.shape[:2], bool)
    for j, n in enumerate(lengths):
        x[j, :n] = rng.normal(size=(n, D))
        mask[j, :n] = True
    return x, mask


def _models(case):
    kws = CASES[case]
    jmodel, params = jax_load_model("DeepMIL", [D, HID, K], rng=jax.random.PRNGKey(3), **kws)
    params = jax.tree.map(np.asarray, dict(params))
    model = load_model("DeepMIL", [D, HID, K], device="cpu",
                       state_dict=state_dict_from_jax(params), **kws)
    return jmodel, params, model.eval()


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_deepmil_matches_jax(case, storage):
    jmodel, params, model = _models(case)
    # the max pooling of an empty bag is -1e30: no empty bag there
    lengths = (300, 180, 40) if "max" in case else (300, 180, 0)
    x, mask = _bags(lengths)
    jkw, tkw = {}, {}
    if storage == "int8":
        q, s = quantize_feats_int8(x)
        jx, tx = jnp.asarray(q), torch.from_numpy(q)
        jkw["x_scale"], tkw["x_scale"] = jnp.asarray(s), torch.from_numpy(s)
    elif storage == "bfloat16":
        jx, tx = jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    else:
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    want = jmodel.apply({"params": params}, jx, mask=jnp.asarray(mask), **jkw)
    with torch.no_grad():
        got = model(tx, torch.from_numpy(mask), **tkw)
    raw_abmil = CASES[case]["network"] == "ABMIL" and not CASES[case]["use_feat_proj"]
    tol = TOL[storage][0 if raw_abmil else 1]
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(got, jnp.asarray(want, jnp.float32)) <= tol


def test_bridge_names_and_decay_split_match():
    """Every leaf of the JAX tree maps to one port tensor (strict load), and
    the decay split decays the same leaves as vlsa_tpu's (ndim != 1):
    fc2_kernel [hid, 1] decays, fc2_bias [1] does not."""
    _j, params, model = _models("abmil")
    sd = state_dict_from_jax(params)
    assert set(sd) == {"sigma.fc1_kernel", "sigma.fc1_bias", "sigma.fc2_kernel",
                       "sigma.fc2_bias", "g.weight", "g.bias"}
    decays = decay_mask(model)
    want = {n: np.ndim(v) != 1 for n, v in sd.items()}
    assert decays == want and decays["sigma.fc2_kernel"] and not decays["sigma.fc2_bias"]


def test_registry_defaults_and_refusals():
    kws = dict(network="ABMIL", pooling="attention", use_feat_proj=False, drop_rate=0.25)
    model = load_model("DeepMIL", [512, 256, 4], seed=42, device="cpu", **kws)
    again = load_model("DeepMIL", [512, 256, 4], seed=42, device="cpu", **kws)
    other = load_model("DeepMIL", [512, 256, 4], seed=7, device="cpu", **kws)
    assert isinstance(model, DeepMIL) and model.sigma.fc1_kernel.shape == (512, 256)
    for n, a in model.state_dict().items():
        assert torch.equal(a, again.state_dict()[n]), n
        assert not torch.equal(a, other.state_dict()[n]), n
    bound = 1 / np.sqrt(512)
    assert float(model.sigma.fc1_kernel.detach().abs().max()) <= bound
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        load_model("DeepMIL", [512, 256, 4], device="cpu", network="TransMIL")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        load_model("DeepMIL", [512, 256, 4], device="cpu", network="PatchGCN")
