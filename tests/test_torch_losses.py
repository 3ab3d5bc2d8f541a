"""The port's survival losses (vlsa_tpu_torch.losses) against vlsa_tpu's, on
the same numpy inputs: the value and the gradient with respect to the
prediction, with and without a `sample_mask` that drops padded rows.

Tolerance 1e-5 relative (plus 1e-7 absolute for gradients that are zero):
both sides compute in f32; only the summation order differs.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vlsa_tpu.losses.registry as jreg
import vlsa_tpu.losses.surv as jsurv
import vlsa_tpu.losses.surv_ext as jext
from vlsa_tpu_torch.losses import registry as treg
from vlsa_tpu_torch.losses import surv as tsurv
from vlsa_tpu_torch.losses import surv_ext as text

B, K = 7, 6
LOGIT_SCALE = float(np.exp(np.log(1 / 0.07)))


def _labels(seed=0):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, K, size=B).astype(np.float32)
    e = (rng.random(B) < 0.6).astype(np.float32)
    e[0], e[1] = 1.0, 0.0  # both kinds present
    mask = np.ones(B, np.float32)
    mask[-2:] = 0.0        # two padded rows
    return t, e, mask


def _pred(kind, seed=1):
    rng = np.random.default_rng(seed)
    raw = rng.normal(size=(B, K)).astype(np.float32) * 2.0
    if kind == "softmax":
        z = np.exp(raw - raw.max(-1, keepdims=True))
        return (z / z.sum(-1, keepdims=True)).astype(np.float32)
    if kind == "sigmoid":
        return (1.0 / (1.0 + np.exp(-raw))).astype(np.float32)
    if kind == "scalar":
        return raw[:, :1] * 0.25
    return raw


# name -> (vlsa_tpu fn, port fn, prediction kind, keyword arguments)
CASES = {
    "surv_mle": (jsurv.surv_mle, tsurv.surv_mle, "sigmoid", {}),
    "surv_mle_alpha": (jsurv.surv_mle, tsurv.surv_mle, "sigmoid", {"alpha": 0.4}),
    "surv_ifmle": (jsurv.surv_ifmle, tsurv.surv_ifmle, "softmax", {}),
    "surv_ifmle_alpha": (jsurv.surv_ifmle, tsurv.surv_ifmle, "softmax", {"alpha": 0.4}),
    "surv_ple": (jsurv.surv_ple, tsurv.surv_ple, "scalar", {}),
    "recon_l1": (jsurv.recon_loss, tsurv.recon_loss, "scalar", {"alpha": 0.2}),
    "recon_l2": (jsurv.recon_loss, tsurv.recon_loss, "scalar", {"norm": "l2"}),
    "rank_l1": (jsurv.rank_loss, tsurv.rank_loss, "scalar", {}),
    "rank_l2_weighted": (jsurv.rank_loss, tsurv.rank_loss, "scalar",
                         {"norm": "l2", "add_weight": True}),
    "mse": (jsurv.mse_loss, tsurv.mse_loss, "scalar", {}),
    "mse_all": (jsurv.mse_loss, tsurv.mse_loss, "scalar", {"include_censored": True}),
    "surv_emd_p2": (jext.surv_emd, text.surv_emd, "softmax",
                    {"cur_logit_scale": LOGIT_SCALE, "p": 2}),
    "surv_emd_p1_sum": (jext.surv_emd, text.surv_emd, "softmax",
                        {"cur_logit_scale": LOGIT_SCALE, "p": 1, "reduction": "sum"}),
    "surv_t2i_cl": (jext.surv_t2i, text.surv_t2i, "raw",
                    {"cur_logit_scale": LOGIT_SCALE, "loss": "CL"}),
    "surv_t2i_kl": (jext.surv_t2i, text.surv_t2i, "raw",
                    {"cur_logit_scale": LOGIT_SCALE, "loss": "KL"}),
}


def _both(jfn, tfn, pred, t, e, kws, mask):
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    jval, jgrad = jax.value_and_grad(
        lambda p: jfn(p, jnp.asarray(t), jnp.asarray(e), sample_mask=jm, **kws))(
        jnp.asarray(pred))
    tp = torch.from_numpy(pred).requires_grad_(True)
    tval = tfn(tp, torch.from_numpy(t), torch.from_numpy(e), sample_mask=tm, **kws)
    tval.backward()
    return (float(jval), np.asarray(jgrad)), (float(tval.detach()), tp.grad.numpy())


@pytest.mark.parametrize("masked", [False, True], ids=["all_rows", "sample_mask"])
@pytest.mark.parametrize("name", list(CASES))
def test_loss_value_and_gradient(name, masked):
    jfn, tfn, kind, kws = CASES[name]
    t, e, mask = _labels()
    (jv, jg), (tv, tg) = _both(jfn, tfn, _pred(kind), t, e, kws, mask if masked else None)
    assert np.isfinite(tv) and tv != 0.0
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-7)
    if masked:  # padded rows get no gradient from per-row losses
        if name not in ("surv_ple", "rank_l1", "rank_l2_weighted", "surv_t2i_cl",
                        "surv_t2i_kl"):
            assert np.all(tg[-2:] == 0.0)


def test_sup_con_and_cdf_losses():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(B, K)).astype(np.float32)
    targets = (rng.random((B, K)) < 0.4).astype(np.float32)
    targets[:, 0] = 1.0
    jv, jg = jax.value_and_grad(lambda x: jext.sup_con_loss(x, jnp.asarray(targets)))(
        jnp.asarray(logits))
    tl = torch.from_numpy(logits).requires_grad_(True)
    tv = text.sup_con_loss(tl, torch.from_numpy(targets))
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-7)
    a, b = _pred("softmax", 5), _pred("softmax", 6)
    for p, raw in ((1, False), (2, False), (2, True), (3, False)):
        np.testing.assert_allclose(
            text.cdf_loss(torch.from_numpy(a), torch.from_numpy(b), p=p, ret_raw=raw).numpy(),
            np.asarray(jext.cdf_loss(jnp.asarray(a), jnp.asarray(b), p=p, ret_raw=raw)),
            rtol=1e-5)


def test_survival_label_targets_are_exact():
    t, e, _m = _labels(seed=7)
    want = np.asarray(jext.convert_survival_label(jnp.asarray(t), jnp.asarray(e), K))
    got = text.convert_survival_label(torch.from_numpy(t), torch.from_numpy(e), K).numpy()
    np.testing.assert_array_equal(got, want)


def test_registry_matches():
    kws = {"loss_type": ["SurvIFMLE", "SurvEMD", "QueryDiv", "CE"],
           "SurvIFMLE": {"weight": 1.0}, "SurvEMD": {"weight": 1.0, "p": 2}}
    jl, tl = jreg.load_loss("vlsa", **kws), treg.load_loss("vlsa", **kws)
    assert list(jl) == list(tl) and tl["QueryDiv"] is None
    assert isinstance(tl["SurvEMD"], functools.partial) and tl["SurvEMD"].keywords == {"p": 2}
    t, e, _m = _labels()
    pred = _pred("softmax")
    for name in ("SurvIFMLE", "CE"):
        np.testing.assert_allclose(
            float(tl[name](torch.from_numpy(pred), torch.from_numpy(t), torch.from_numpy(e))),
            float(jl[name](jnp.asarray(pred), jnp.asarray(t), jnp.asarray(e))), rtol=1e-5)
    assert list(treg.load_loss("clf", loss_type=["CE"])) == ["CE"]  # tests/test_torch_clf.py
    with pytest.raises(NotImplementedError):
        treg.load_loss("seg", loss_type=["CE"])
    with pytest.raises(ValueError):
        treg.load_loss("sa", loss_type=["NoSuchLoss"])
