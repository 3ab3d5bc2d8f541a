"""The port's optimizer factory (vlsa_tpu_torch.optim) against vlsa_tpu's
optax one: the weight-decay split, freezing, and 10 update steps with weight
decay on the same parameters and gradients (made with numpy).

Tolerance |a-b| <= 1e-6 + 1e-5 |b| after 10 steps: both sides update in f32
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
from vlsa_tpu.optim.factory import decay_mask as jax_decay_mask
from vlsa_tpu.optim.factory import frozen_mask_from_cfg as jax_frozen_mask
from vlsa_tpu_torch.optim import create_optimizer, decay_mask, frozen_mask_from_cfg

LR, WD, STEPS = 2e-4, 1e-5, 10


def _init(seed=0):
    rng = np.random.default_rng(seed)
    return {"scale": np.float32(2.6),                       # a scalar, like logit_scale
            "vec": rng.normal(size=(5,)).astype(np.float32),   # 1-D: no decay
            "mat": rng.normal(size=(4, 3)).astype(np.float32),
            "tower": {"mat": rng.normal(size=(3, 3)).astype(np.float32)}}


class Net(nn.Module):
    def __init__(self, init):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(init["scale"]))
        self.vec = nn.Parameter(torch.from_numpy(init["vec"].copy()))
        self.mat = nn.Parameter(torch.from_numpy(init["mat"].copy()))
        self.tower = nn.Module()
        self.tower.mat = nn.Parameter(torch.from_numpy(init["tower"]["mat"].copy()))


def test_decay_split_matches():
    init = _init()
    jmask = jax_decay_mask(jax.tree.map(jnp.asarray, init))
    tmask = decay_mask(Net(init))
    assert tmask == {"scale": True, "vec": False, "mat": True, "tower.mat": True}
    assert tmask == {"scale": bool(jmask["scale"]), "vec": bool(jmask["vec"]),
                     "mat": bool(jmask["mat"]), "tower.mat": bool(jmask["tower"]["mat"])}


def test_frozen_params_get_no_state_and_no_update():
    net = Net(_init())
    frozen = frozen_mask_from_cfg(net, ["tower"])
    assert frozen == {"scale": False, "vec": False, "mat": False, "tower.mat": True}
    assert not net.tower.mat.requires_grad
    before = net.tower.mat.detach().clone()
    opt = create_optimizer("adam", LR, WD, net)
    names = sorted(n for g in opt.param_groups for n in g["names"])
    assert names == ["mat", "scale", "vec"]
    for _ in range(3):
        opt.zero_grad()
        (net.scale * 2 + net.vec.sum() + net.mat.sum() + (net.tower.mat * net.mat[:3]).sum()
         ).backward()
        opt.step()
    assert net.tower.mat.grad is None and net.tower.mat not in opt.state
    assert torch.equal(net.tower.mat, before)
    with pytest.raises(NotImplementedError):
        create_optimizer("radam", LR, WD, net)


@pytest.mark.parametrize("opt_name", ["adam", "adamw", "sgd", "nesterov", "momentum"])
def test_updates_match_optax(opt_name):
    init = _init()
    rng = np.random.default_rng(1)
    grads = [jax.tree.map(lambda v: rng.normal(size=np.shape(v)).astype(np.float32), init)
             for _ in range(STEPS)]

    params = jax.tree.map(jnp.asarray, init)
    frozen = jax_frozen_mask(params, ["tower"])
    tx = jax_create_optimizer(opt_name, LR, WD, params, frozen=frozen)
    state = tx.init(params)
    for g in grads:
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, params)
        params = optax.apply_updates(params, updates)

    net = Net(init)
    frozen_mask_from_cfg(net, ["tower"])
    opt = create_optimizer(opt_name, LR, WD, net)
    for g in grads:
        for name, p in net.named_parameters():
            if p.requires_grad:
                leaf = g
                for part in name.split("."):
                    leaf = leaf[part]
                p.grad = torch.as_tensor(np.asarray(leaf)).clone()
        opt.step()

    for name, p in net.named_parameters():
        want = params
        for part in name.split("."):
            want = want[part]
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6,
                                   err_msg=f"{opt_name}: {name}")
    np.testing.assert_array_equal(net.tower.mat.detach().numpy(), init["tower"]["mat"])
    assert not np.allclose(net.mat.detach().numpy(), init["mat"])
