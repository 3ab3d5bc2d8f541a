"""The attention maps and the rest of the pooling surface of the port
against vlsa_tpu's, with vlsa_tpu's initial parameters carried over by the
weight bridge (strict loads): VLFAN's `ret_with_attn` (A [B, P, N] and the
query pooling's own attention) for all five query poolings; DeepMIL's
`ret_with_attn` and its gated attention pooling; DSMIL; gradients in eval
mode; the Dropout of the port (`SeededDropout`); the bridge's new leaves.

Tolerances (max|a-b| / max|b|): 1e-5 for every forward output (f32 on both
sides, summation order apart).  bf16 bags go to the port as bf16 and to
vlsa_tpu as their f32 values: the port computes on the stored values in
f32, as vlsa_tpu's kernel does, while vlsa_tpu's plain CPU path would
normalise bf16 rows in bf16 (ROADMAP.md §C).  int8 bags go to both as int8
with their per-patch scales.  Gradients 1e-4: the backward's sums run in
another order on each side, over products of up to three factors.
Dropout is statistical: vlsa_tpu draws from threefry, the port from torch's
generator, so train mode is held by the keep fraction (within 5 standard
deviations of a binomial draw) and the 1/(1-p) scale, not by parity.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlsa_tpu.models.mil import DSMIL as JaxDSMIL
from vlsa_tpu.models.mil import VLFAN as JaxVLFAN
from vlsa_tpu.models.registry import load_model as jax_load_model
from vlsa_tpu_torch.data.quant import quantize_feats_int8
from vlsa_tpu_torch.models.layers import GatedAttentionPooling, SeededDropout
from vlsa_tpu_torch.models.mil import DSMIL, QUERY_POOLINGS, VLFAN
from vlsa_tpu_torch.models.registry import load_model
from vlsa_tpu_torch.utils.weights import (_flatten, jax_tree_from_state_dict,
                                          state_dict_from_jax)

C, HID, K = 64, 32, 4
TOL = 1e-5
TOL_GRAD = 1e-4


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _bags(lengths=(96, 61, 0), seed=0, D=C):
    rng = np.random.default_rng(seed)
    x = np.zeros((len(lengths), max(lengths), D), np.float32)
    mask = np.zeros(x.shape[:2], bool)
    for j, n in enumerate(lengths):
        x[j, :n] = rng.normal(size=(n, D))
        mask[j, :n] = True
    return x, mask


def _stored(x, storage):
    """(the JAX inputs, the port's inputs): (x, kws) each."""
    if storage == "int8":
        q, s = quantize_feats_int8(x)
        return ((jnp.asarray(q), {"x_scale": jnp.asarray(s)}),
                (torch.from_numpy(q), {"x_scale": torch.from_numpy(s)}))
    if storage == "bfloat16":
        tx = torch.from_numpy(x).to(torch.bfloat16)
        return (jnp.asarray(tx.float().numpy()), {}), (tx, {})
    return (jnp.asarray(x), {}), (torch.from_numpy(x), {})


def _np_tree(params):
    return jax.tree.map(np.asarray, dict(params))


def _vlfan_pair(pooling, x, mask, **kw):
    kw = dict(dict(query="Parameter", num_query=5, use_feat_proj=False), **kw)
    ref = JaxVLFAN(dim_in=C, dim_hid=HID, query_pooling=pooling, **kw)
    params = _np_tree(ref.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(mask))
                      ["params"])
    port = VLFAN(dim_in=C, dim_hid=HID, query_pooling=pooling, **kw)
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    return ref, params, port.eval()


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("pooling", QUERY_POOLINGS)
def test_vlfan_attention_matches_jax(pooling, storage):
    x, mask = _bags()
    ref, params, port = _vlfan_pair(pooling, x, mask, gated_query=pooling == "max")
    (jx, jkw), (tx, tkw) = _stored(x, storage)
    jfeat, jattn = ref.apply({"params": params}, jx, jnp.asarray(mask), ret_with_attn=True,
                             **jkw)
    with torch.no_grad():
        feat, attn = port(tx, torch.from_numpy(mask), ret_with_attn=True, **tkw)
    assert _rel(feat.numpy(), jfeat) <= TOL
    has_ext = pooling in ("attention", "gated_attention")
    assert isinstance(attn, tuple) == has_ext == isinstance(jattn, tuple)
    A, jA = (attn[0], jattn[0]) if has_ext else (attn, jattn)
    assert A.shape == (3, 5, x.shape[1]) and _rel(A.numpy(), jA) <= TOL
    # the rows of a bag sum to 1 over its patches, the empty bag's to 0
    np.testing.assert_allclose(A.sum(-1).numpy(), [[1] * 5, [1] * 5, [0] * 5], atol=1e-5)
    assert float(A[1, :, 61:].abs().max()) == 0.0
    if has_ext:
        assert attn[1].shape == (3, 5) and _rel(attn[1].numpy(), jattn[1]) <= TOL
    with torch.no_grad():  # without ret_with_attn: the features alone
        assert torch.equal(port(tx, torch.from_numpy(mask), **tkw), feat)


@pytest.mark.parametrize("pooling", ["attention", "gated_attention"])
def test_vlfan_attention_query_pooling_with_text_queries_and_projecter(pooling):
    x, mask = _bags((80, 33))
    q = np.random.default_rng(3).normal(size=(6, C)).astype(np.float32)
    ref = JaxVLFAN(dim_in=C, dim_hid=HID, query="Text", num_query=5, gated_query=True,
                   use_feat_proj=True, query_pooling=pooling)
    params = _np_tree(ref.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(mask),
                               query=jnp.asarray(q))["params"])
    port = VLFAN(dim_in=C, dim_hid=HID, query="Text", num_query=5, gated_query=True,
                 use_feat_proj=True, query_pooling=pooling)
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    jfeat, (jA, jext) = ref.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask),
                                  query=jnp.asarray(q), ret_with_attn=True)
    with torch.no_grad():
        feat, (A, ext) = port.eval()(torch.from_numpy(x), torch.from_numpy(mask),
                                     query=torch.from_numpy(q), ret_with_attn=True)
    for got, want in ((feat, jfeat), (A, jA), (ext, jext)):
        assert _rel(got.numpy(), want) <= TOL


DEEPMIL_CASES = {
    "attention": dict(network="ABMIL", pooling="attention", use_feat_proj=False),
    "gated": dict(network="ABMIL", pooling="gated_attention", use_feat_proj=False),
    "gated_featproj_adapter": dict(network="ABMIL", pooling="gated_attention",
                                   use_feat_proj=True, pred_head="Adapter"),
}


def _deepmil_pair(case):
    kws = DEEPMIL_CASES[case]
    jmodel, params = jax_load_model("DeepMIL", [C, HID, K], rng=jax.random.PRNGKey(3), **kws)
    params = _np_tree(params)
    model = load_model("DeepMIL", [C, HID, K], device="cpu",
                       state_dict=state_dict_from_jax(params), **kws)
    return jmodel, params, model.eval()


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("case", sorted(DEEPMIL_CASES))
def test_deepmil_attention_matches_jax(case, storage):
    """vlsa_tpu's explicit path: the raw attention of ABMIL (b2 included),
    the softmaxed one of gated attention; and the logits without it."""
    jmodel, params, model = _deepmil_pair(case)
    x, mask = _bags((90, 40, 0))
    (jx, jkw), (tx, tkw) = _stored(x, storage)
    if storage == "bfloat16":  # the JAX DeepMIL takes bf16 as such
        jx = jnp.asarray(x).astype(jnp.bfloat16)
    jlogits, jattn = jmodel.apply({"params": params}, jx, mask=jnp.asarray(mask),
                                  ret_with_attn=True, **jkw)
    with torch.no_grad():
        logits, attn = model(tx, torch.from_numpy(mask), ret_with_attn=True, **tkw)
        plain = model(tx, torch.from_numpy(mask), **tkw)
    # bf16 through a projecter: one bf16 ulp of a projection summed in
    # another order (tests/test_torch_deepmil.py's 1e-2)
    tol = 1e-2 if storage != "float32" and "featproj" in case else TOL
    assert _rel(logits.numpy(), jnp.asarray(jlogits, jnp.float32)) <= tol
    assert attn.shape == (3, 90) and _rel(attn.numpy(), jnp.asarray(jattn, jnp.float32)) <= tol
    assert _rel(plain.numpy(), logits.numpy()) <= (1e-2 if storage == "bfloat16" else TOL)
    if case.startswith("gated"):
        np.testing.assert_allclose(attn.sum(-1).numpy(), [1, 1, 0], atol=1e-5)
        assert float(attn[1, 40:].abs().max()) == 0.0


DSMIL_CASES = {"plain": dict(use_feat_proj=False), "featproj": dict(use_feat_proj=True)}


def _dsmil_pair(case, x, mask, num_cls=K):
    ref = JaxDSMIL(dim_in=C, dim_hid=HID, num_cls=num_cls, **DSMIL_CASES[case])
    params = _np_tree(ref.init(jax.random.PRNGKey(4), jnp.asarray(x), jnp.asarray(mask))
                      ["params"])
    port = DSMIL(dim_in=C, dim_hid=HID, num_cls=num_cls, **DSMIL_CASES[case])
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    return ref, params, port.eval()


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(DSMIL_CASES))
def test_dsmil_matches_jax(case, storage):
    """Bags of 96 and 61 patches, one of a single patch, and an empty one
    (its logits -5e29 on both sides: the masked max of no patch); each bag
    is held on its own."""
    x, mask = _bags((96, 61, 1, 0))
    ref, params, port = _dsmil_pair(case, x, mask)
    (jx, _), (tx, _) = _stored(x, storage)
    jlogits, jattn = ref.apply({"params": params}, jx, jnp.asarray(mask), ret_with_attn=True)
    with torch.no_grad():
        logits, attn = port(tx, torch.from_numpy(mask), ret_with_attn=True)
        plain = port(tx, torch.from_numpy(mask))
    assert torch.equal(plain, logits) and logits.shape == (4, K) and attn.shape == (4, 96)
    for b in range(4):
        assert _rel(logits[b].numpy(), jlogits[b]) <= TOL, b
        assert _rel(attn[b].numpy(), jattn[b]) <= TOL or float(np.abs(jattn[b]).max()) == 0.0
    assert float(attn[3].abs().max()) == 0.0 and float(logits[3].max()) < -1e29
    np.testing.assert_allclose(attn[:3].sum(-1).numpy(), [1, 1, 1], atol=1e-5)
    # without a mask: every row is a patch
    jfull = ref.apply({"params": params}, jx[:1, :96])
    with torch.no_grad():
        assert _rel(port(tx[:1, :96]).numpy(), jfull) <= TOL


def _grad_tree_rel(got: dict, jgrads) -> float:
    """The largest gap of a leaf relative to its own largest entry, floored
    at 1e-2 of the model's largest gradient: the ABMIL fc2 bias cancels in
    the softmax, and its gradient is rounding noise (below 1e-6) on both sides."""
    want = {k: v.numpy().astype(np.float64)
            for k, v in state_dict_from_jax(_np_tree(jgrads)).items()}
    assert set(got) == set(want)
    top = max(float(np.abs(v).max()) for v in want.values())
    return max(float(np.abs(got[k] - v).max()) / max(float(np.abs(v).max()), 1e-2 * top)
               for k, v in want.items())


def _port_grads(model, loss):
    model.zero_grad()
    loss.backward()
    return {n: p.grad.numpy() if p.grad is not None else np.zeros(p.shape, np.float32)
            for n, p in model.named_parameters()}


@pytest.mark.parametrize("what", ["vlfan_attention", "vlfan_gated_attention",
                                  "deepmil_gated", "deepmil_attention_explicit", "dsmil"])
def test_gradients_match_jax_in_eval_mode(what):
    """d(sum(out * w))/d(params) with Dropout off (train=False on both sides)."""
    x, mask = _bags((90, 40, 7))
    width = K if what in ("dsmil", "deepmil_attention_explicit") else C
    w = np.random.default_rng(5).normal(size=(3, width)).astype(np.float32)
    if what.startswith("vlfan"):
        ref, params, port = _vlfan_pair(what[len("vlfan_"):], x, mask, use_feat_proj=True)

        def jf(p):
            return jnp.sum(ref.apply({"params": p}, jnp.asarray(x), jnp.asarray(mask)) * w)

        def tf():
            return port(torch.from_numpy(x), torch.from_numpy(mask))
    elif what == "dsmil":
        ref, params, port = _dsmil_pair("featproj", x, mask)

        def jf(p):
            return jnp.sum(ref.apply({"params": p}, jnp.asarray(x), jnp.asarray(mask)) * w)

        def tf():
            return port(torch.from_numpy(x), torch.from_numpy(mask))
    else:
        case = "gated_featproj_adapter" if what == "deepmil_gated" else "attention"
        ref, params, port = _deepmil_pair(case)

        def jf(p):
            out, _a = ref.apply({"params": p}, jnp.asarray(x), mask=jnp.asarray(mask),
                                ret_with_attn=True)
            return jnp.sum(out * w)

        def tf():
            return port(torch.from_numpy(x), torch.from_numpy(mask), ret_with_attn=True)[0]
    jgrads = jax.grad(jf)(params)
    got = _port_grads(port, (tf() * torch.from_numpy(w)).sum())
    assert _grad_tree_rel(got, jgrads) <= TOL_GRAD


def test_dropout_keep_fraction_scale_and_seed():
    p, n = 0.25, 1_000_000
    x = torch.ones(n)
    drop = SeededDropout(p, seed=7)
    y = drop(x, train=True)
    kept = y != 0
    frac = float(kept.float().mean())
    sd = np.sqrt(p * (1 - p) / n)
    assert abs(frac - (1 - p)) <= 5 * sd
    assert torch.equal(y[kept], torch.full((int(kept.sum()),), 1 / (1 - p)))
    assert torch.equal(drop(x, train=False), x)  # eval mode: the identity
    # one seed, the same masks in the same calls; another seed, others
    again = SeededDropout(p, seed=7)
    assert torch.equal(again(x, train=True), y)
    assert torch.equal(again(x, train=True), drop(x, train=True))
    assert not torch.equal(SeededDropout(p, seed=8)(x, train=True), y)


def test_gated_pooling_train_mode_is_seeded_and_statistical():
    """Two gated poolings built from one seed give the same train-mode
    outputs; train mode differs from eval mode; its mean over many draws
    tracks the eval-mode attention only in distribution (not checked for
    parity with vlsa_tpu, whose masks come from threefry)."""
    x, mask = _bags((50, 20))
    tx, tm = torch.from_numpy(x), torch.from_numpy(mask)
    g = torch.Generator().manual_seed(0)
    a = GatedAttentionPooling(C, HID, dropout=0.5, seed=3, generator=g)
    b = GatedAttentionPooling(C, HID, dropout=0.5, seed=3)
    b.load_state_dict(a.state_dict())
    with torch.no_grad():
        pa, aa = a(tx, tm, train=True)
        pb, ab = b(tx, tm, train=True)
        pe, ae = a(tx, tm)
    assert torch.equal(pa, pb) and torch.equal(aa, ab)
    assert not torch.allclose(aa, ae)
    np.testing.assert_allclose(aa.sum(-1).numpy(), [1, 1], atol=1e-5)
    assert float(aa[1, 20:].abs().max()) == 0.0


def _round_trip(model, params):
    back = jax_tree_from_state_dict(model.state_dict())
    want = dict(_flatten(params))
    got = dict(_flatten(back))
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("what", ["vlfan_attention", "vlfan_gated_attention", "deepmil_gated",
                                  "dsmil"])
def test_bridge_round_trips_the_new_leaves(what):
    """vlsa_tpu tree -> state dict (strict load) -> vlsa_tpu tree, equal."""
    x, mask = _bags((30, 10))
    if what.startswith("vlfan"):
        _ref, params, port = _vlfan_pair(what[len("vlfan_"):], x, mask)
        names = {"query_pool.fc1_kernel", "query_pool.fc2_bias"} if what.endswith(
            "_attention") and "gated" not in what else {"query_pool.fc1.weight",
                                                        "query_pool.score.bias",
                                                        "query_pool.fc2.weight"}
    elif what == "dsmil":
        _ref, params, port = _dsmil_pair("featproj", x, mask)
        names = {"i_fc.weight", "q.weight", "v.bias", "fcc_kernel", "fcc_bias"}
    else:
        _j, params, port = _deepmil_pair("gated")
        names = {"sigma.fc1.weight", "sigma.score.weight", "sigma.fc2.bias"}
    assert names <= set(port.state_dict())
    _round_trip(port, params)


def test_attention_poolings_return_raw_or_softmaxed_attention():
    """`ret_raw_attn` picks a_raw (b2 included) or its masked softmax, as
    in vlsa_tpu; the pooled features are the same either way."""
    from vlsa_tpu_torch.models.layers import AttentionPooling
    from vlsa_tpu_torch.ops.masked import masked_softmax
    x, mask = _bags((40, 25))
    tx, tm = torch.from_numpy(x), torch.from_numpy(mask)
    g = torch.Generator().manual_seed(1)
    for pool, kws in ((AttentionPooling(C, HID, generator=g), {"need_attn": True}),
                      (GatedAttentionPooling(C, HID, generator=g), {})):
        with torch.no_grad():
            p_raw, raw = pool(tx, tm, ret_raw_attn=True, **kws)
            p_soft, soft = pool(tx, tm, ret_raw_attn=False, **kws)
        assert torch.equal(p_raw, p_soft)
        assert torch.equal(soft, masked_softmax(raw, tm, dim=-1))
        assert float(raw[1, 25:].abs().min()) > 0 and float(soft[1, 25:].abs().max()) == 0
