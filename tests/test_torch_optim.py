"""The port's optimizer factory (vlsa_tpu_torch.optim) against vlsa_tpu's
optax one: the weight-decay split, freezing, and 13 update steps with weight
decay on the same parameters and gradients (made with numpy) for every name
of vlsa_tpu's factory and `lookahead_<name>` (two syncs at k=6, the first a
no-op), with a frozen subtree; `ModelEma` against vlsa_tpu's.

The parameters hold a Dense layer of 160 x 130 (vlsa_tpu's kernel [in, out],
the port's `nn.Linear.weight` [out, in]): both dimensions >= 128, so that
Adafactor factors it, and its gradients are orthogonal to each of its
channels (vlsa_tpu's axis 0), so that AdamP's and SGDP's channel view
projects; a transposed view would give other updates.  Adahessian gets the
same Hessian-diagonal estimates (made with numpy) on both sides.

Tolerance |a-b| <= 1e-6 + 1e-5 |b| after 13 steps: both sides update in f32
with the same formulas, in another order of operations.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from vlsa_tpu.optim import create_optimizer as jax_create_optimizer
from vlsa_tpu.optim.ema import ModelEma as JaxModelEma
from vlsa_tpu.optim.factory import decay_mask as jax_decay_mask
from vlsa_tpu.optim.factory import frozen_mask_from_cfg as jax_frozen_mask
from vlsa_tpu_torch.optim import ModelEma, create_optimizer, decay_mask, frozen_mask_from_cfg
from vlsa_tpu_torch.optim.factory import OPTIMIZERS

LR, WD, STEPS = 2e-4, 1e-5, 13
FAN_IN, FAN_OUT = 160, 130


def _init(seed=0):
    rng = np.random.default_rng(seed)
    return {"scale": np.float32(2.6),                       # a scalar, like logit_scale
            "vec": rng.normal(size=(5,)).astype(np.float32),   # 1-D: no decay
            "mat": rng.normal(size=(4, 3)).astype(np.float32),
            "fc": {"kernel": (rng.normal(size=(FAN_IN, FAN_OUT)) * FAN_IN ** -0.5
                              ).astype(np.float32),
                   "bias": rng.normal(size=(FAN_OUT,)).astype(np.float32)},
            "tower": {"mat": rng.normal(size=(3, 3)).astype(np.float32)}}


class Net(nn.Module):
    def __init__(self, init):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(init["scale"]))
        self.vec = nn.Parameter(torch.from_numpy(init["vec"].copy()))
        self.mat = nn.Parameter(torch.from_numpy(init["mat"].copy()))
        self.fc = nn.Linear(FAN_IN, FAN_OUT)
        with torch.no_grad():
            self.fc.weight.copy_(torch.from_numpy(init["fc"]["kernel"].T.copy()))
            self.fc.bias.copy_(torch.from_numpy(init["fc"]["bias"]))
        self.tower = nn.Module()
        self.tower.mat = nn.Parameter(torch.from_numpy(init["tower"]["mat"].copy()))


def _leaf(tree, name):
    """The numpy leaf of a port parameter name, in the port's layout."""
    parts = name.split(".")
    if parts[-1] == "weight":  # a Dense kernel [in, out] -> [out, in]
        parts[-1] = "kernel"
    for part in parts:
        tree = tree[part]
    return np.asarray(tree).T if name.endswith(".weight") else np.asarray(tree)


def _grads(init, seed=1):
    """STEPS gradient trees; the Dense kernel's orthogonal to each of its
    rows (vlsa_tpu's channels) of the initial weights."""
    rng = np.random.default_rng(seed)
    out = []
    k = init["fc"]["kernel"].astype(np.float64)
    for _ in range(STEPS):
        g = jax.tree.map(lambda v: rng.normal(size=np.shape(v)).astype(np.float32), init)
        gk = g["fc"]["kernel"].astype(np.float64)
        gk -= k * ((gk * k).sum(1, keepdims=True) / (k * k).sum(1, keepdims=True))
        g["fc"]["kernel"] = gk.astype(np.float32)
        out.append(g)
    return out


def test_decay_split_matches():
    init = _init()
    jmask = jax_decay_mask(jax.tree.map(jnp.asarray, init))
    tmask = decay_mask(Net(init))
    assert tmask == {"scale": True, "vec": False, "mat": True, "fc.weight": True,
                     "fc.bias": False, "tower.mat": True}
    assert tmask == {"scale": bool(jmask["scale"]), "vec": bool(jmask["vec"]),
                     "mat": bool(jmask["mat"]), "fc.weight": bool(jmask["fc"]["kernel"]),
                     "fc.bias": bool(jmask["fc"]["bias"]),
                     "tower.mat": bool(jmask["tower"]["mat"])}


def test_frozen_params_get_no_state_and_no_update():
    net = Net(_init())
    frozen = frozen_mask_from_cfg(net, ["tower"])
    assert frozen == {"scale": False, "vec": False, "mat": False, "fc.weight": False,
                      "fc.bias": False, "tower.mat": True}
    assert not net.tower.mat.requires_grad
    before = net.tower.mat.detach().clone()
    opt = create_optimizer("adam", LR, WD, net)
    names = sorted(n for g in opt.param_groups for n in g["names"])
    assert names == ["fc.bias", "fc.weight", "mat", "scale", "vec"]
    for _ in range(3):
        opt.zero_grad()
        (net.scale * 2 + net.vec.sum() + net.mat.sum() + (net.tower.mat * net.mat[:3]).sum()
         ).backward()
        opt.step()
    assert net.tower.mat.grad is None and net.tower.mat not in opt.state
    assert torch.equal(net.tower.mat, before)
    # an unknown name raises, as do the two vlsa_tpu cannot run
    for name in ("adamq", "lookahead_adamq"):
        with pytest.raises(NotImplementedError):
            create_optimizer(name, LR, WD, net)
    with pytest.raises(ValueError, match="lookahead_adahessian"):
        create_optimizer("lookahead_adahessian", LR, WD, net)


# vlsa_tpu's adamp and sgdp cannot take a frozen subtree: their decay mask
# covers every leaf, optax.multi_transform hands them the trainable ones
# (a tree-structure error); there the frozen subtree is left out of the tree
# instead, which gives the other leaves the same updates
_NO_FROZEN_MASK = ("adamp", "sgdp")


def _jax_run(opt_name, init, grads, hessians):
    params = jax.tree.map(jnp.asarray, init)
    frozen = jax_frozen_mask(params, ["tower"])
    if opt_name.split("_")[-1] in _NO_FROZEN_MASK:
        params, frozen = {k: v for k, v in params.items() if k != "tower"}, None
        grads = [{k: v for k, v in g.items() if k != "tower"} for g in grads]
    tx = jax_create_optimizer(opt_name, LR, WD, params, frozen=frozen)
    state = tx.init(params)
    for g, h in zip(grads, hessians):
        extra = {} if h is None else {"hessian_diag": jax.tree.map(jnp.asarray, h)}
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, params, **extra)
        params = optax.apply_updates(params, updates)
    return dict(params, tower=params.get("tower", init["tower"]))


@pytest.mark.parametrize("opt_name", list(OPTIMIZERS) + [
    "lookahead_" + n for n in OPTIMIZERS if n != "adahessian"])
def test_updates_match_optax(opt_name):
    init = _init()
    grads = _grads(init)
    hessians = [None] * STEPS
    if opt_name == "adahessian":
        rng = np.random.default_rng(2)
        hessians = [jax.tree.map(lambda v: np.abs(rng.normal(size=np.shape(v))).astype(
            np.float32), init) for _ in range(STEPS)]
    params = _jax_run(opt_name, init, grads, hessians)

    net = Net(init)
    frozen_mask_from_cfg(net, ["tower"])
    opt = create_optimizer(opt_name, LR, WD, net)
    for g, h in zip(grads, hessians):
        for name, p in net.named_parameters():
            if p.requires_grad:
                p.grad = torch.as_tensor(_leaf(g, name)).clone()
        if h is None:
            opt.step()
        else:
            opt.step(hessian={p: torch.as_tensor(_leaf(h, n)).clone()
                              for n, p in net.named_parameters() if p.requires_grad})

    for name, p in net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), _leaf(params, name), rtol=1e-5,
                                   atol=1e-6, err_msg=f"{opt_name}: {name}")
    np.testing.assert_array_equal(net.tower.mat.detach().numpy(), init["tower"]["mat"])
    assert not np.allclose(net.mat.detach().numpy(), init["mat"])


def test_model_ema_matches_jax():
    """`ModelEma`'s shadow after 3 updates equals vlsa_tpu's, leaf by leaf
    (the same f32 formula: 1e-6 relative)."""
    init = _init()
    net = Net(init)
    jema = JaxModelEma(jax.tree.map(jnp.asarray, init), decay=0.9)
    ema = ModelEma(net, decay=0.9)
    params = init
    for g in _grads(init)[:3]:
        params = jax.tree.map(lambda a, b: np.asarray(a) + np.asarray(b), params, g)
        with torch.no_grad():
            for name, p in net.named_parameters():
                p.copy_(torch.as_tensor(_leaf(params, name)))
        shadow = ema.update(net)
        jshadow = jema.update(jax.tree.map(jnp.asarray, params))
    assert set(shadow) == {n for n, _p in net.named_parameters()}
    for name, t in shadow.items():
        np.testing.assert_allclose(t.numpy(), _leaf(jshadow, name), rtol=1e-6, atol=1e-7,
                                   err_msg=name)
