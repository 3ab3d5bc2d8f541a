"""Adahessian and the switch off the kernels, on the CPU.

`optim.extra.hutchinson_hessian_diag` against vlsa_tpu's on a small DeepMIL
(D=512, hid 32, as tests/test_torch_sa_train.py) and the small flagship VLSA
(tests/test_torch_train.py's, text tower frozen): the test draws z as
vlsa_tpu/optim/extra.py:236-239 draws it (one key a leaf, Rademacher) and
hands it to both, through the weight bridge (a Dense kernel's z transposed).
vlsa_tpu's estimate runs under `disable_pallas` (its engine's adahessian
step), the port's under `ops.flags.disable_kernels` (its engine's).  Then 3
adahessian steps of the port's `TrainEngine(needs_hessian=True)` against
vlsa_tpu's, each step's z as vlsa_tpu's engine draws it (from
fold_in(rng, 7)), and the switch's nesting.

Tolerances: the estimates, each leaf within 1e-4 of its largest element
(f32 second derivatives summed in another order); per-step loss 1e-4
relative; parameters after 3 steps |a-b| <= 1e-5 + 1e-4 |b|.  One leaf has
an exception: DeepMIL's `sigma.fc2_bias` (b2) cancels in the softmax, so its
true gradient and Hessian are 0; vlsa_tpu's plain pooling adds it before the
softmax and gets rounding noise there (its estimate within 1e-6), which
adahessian's m / |h| turns into steps of up to lr; the port's pooling does
not use b2, so it stays put.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_sa_train import DIMS, NET
from test_torch_sa_train import LOSSES as SA_LOSSES
from test_torch_sa_train import WEIGHTS as SA_WEIGHTS
from test_torch_sa_train import _batches as sa_batches
from test_torch_train import LOSSES as VLSA_LOSSES
from test_torch_train import WEIGHTS as VLSA_WEIGHTS
from test_torch_train import _batches as vlsa_batches
from test_torch_train import _cfgs
from test_torch_vlsa import REPO, TOWER
from vlsa_tpu.losses import load_loss as jax_load_loss
from vlsa_tpu.models import load_model as jax_load_model
from vlsa_tpu.models.vlsa_build import build_vlsa as jax_build_vlsa
from vlsa_tpu.ops.flags import disable_pallas
from vlsa_tpu.optim import create_optimizer as jax_create_optimizer
from vlsa_tpu.optim import frozen_mask_from_cfg as jax_frozen_mask
from vlsa_tpu.optim.extra import hutchinson_hessian_diag as jax_hutchinson
from vlsa_tpu.runner.engine import TrainEngine as JaxTrainEngine
from vlsa_tpu.runner.engine import _feats_inputs as jax_feats_inputs
from vlsa_tpu.runner.engine import make_objective as jax_make_objective
from vlsa_tpu.runner.engine import make_output_converter as jax_converter
from vlsa_tpu_torch.losses import load_loss
from vlsa_tpu_torch.models.registry import load_model
from vlsa_tpu_torch.models.vlsa_build import build_vlsa
from vlsa_tpu_torch.ops import abmil, coattn, flags
from vlsa_tpu_torch.optim import create_optimizer, frozen_mask_from_cfg
from vlsa_tpu_torch.optim.extra import hutchinson_hessian_diag
from vlsa_tpu_torch.runner.engine import TrainEngine, make_objective, make_output_converter
from vlsa_tpu_torch.utils.weights import state_dict_from_jax

LR, WD, STEPS = 2e-4, 1e-5, 3
NOISE_LEAF = "sigma.fc2_bias"


def _jax_z(params, rng):
    """z as vlsa_tpu/optim/extra.py:236-239 draws it."""
    leaves, treedef = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(rng, len(leaves))
    return jax.tree_util.tree_unflatten(treedef, [
        jax.random.rademacher(k, shape=leaf.shape, dtype=leaf.dtype)
        for k, leaf in zip(keys, leaves)])


def _to_port(tree) -> dict:
    return state_dict_from_jax(jax.tree.map(np.asarray, tree))


def _jax_loss_fn(model, objective, batch, uses_vl, frozen=None):
    """vlsa_tpu/runner/engine.py's loss_fn (train=True, dropout rng 0)."""
    batch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        if frozen is not None:
            p = jax.tree.map(lambda v, f: jax.lax.stop_gradient(v) if f else v, p, frozen)
        feats, kws = jax_feats_inputs(model, batch)
        out = model.apply({"params": p}, feats, mask=batch["mask"], train=True,
                          rngs={"dropout": jax.random.PRNGKey(0)}, **kws)
        raw = out[0] if isinstance(out, tuple) else out
        ls = jnp.exp(p["logit_scale"]) if uses_vl else None
        return objective(raw, batch["t"], batch["e"], batch["valid"].astype(raw.dtype),
                         logit_scale=ls)
    return loss_fn


def _port_diag(model, engine, batch, z_port):
    names, params = engine._trainable()
    with flags.disable_kernels():
        loss, _raw = engine.loss({k: torch.from_numpy(v) for k, v in batch.items()})
        _g, diag = hutchinson_hessian_diag(loss, params, names, z=[z_port[n] for n in names])
    return dict(zip(names, diag))


def _hold_diag(got: dict, want: dict):
    assert got and set(got) <= set(want)
    for name, d in got.items():
        w = want[name].float().numpy()
        d = d.numpy()
        if name == NOISE_LEAF:
            assert np.abs(d).max() == 0 and np.abs(w).max() <= 1e-6, name
            continue
        assert np.abs(w).max() > 0, name
        assert np.abs(d - w).max() <= 1e-4 * np.abs(w).max(), (
            f"{name}: {np.abs(d - w).max():.3e} of {np.abs(w).max():.3e}")


def _sa():
    jmodel, params = jax_load_model("DeepMIL", DIMS, rng=jax.random.PRNGKey(0), **NET)
    params = jax.tree.map(np.asarray, dict(params))
    model = load_model("DeepMIL", DIMS, device="cpu", state_dict=_to_port(params), **NET)
    model.train()
    objective = make_objective(load_loss("sa", **SA_LOSSES), SA_WEIGHTS,
                               make_output_converter("softmax"))
    jobjective = jax_make_objective(jax_load_loss("sa", **SA_LOSSES), SA_WEIGHTS,
                                    jax_converter("softmax"), uses_vl=False)
    return jmodel, params, jobjective, model, objective


def test_hessian_diag_matches_jax_on_deepmil():
    jmodel, params, jobjective, model, objective = _sa()
    batch = sa_batches(1)[0]
    rng = jax.random.PRNGKey(3)
    with disable_pallas():
        want = jax_hutchinson(_jax_loss_fn(jmodel, jobjective, batch, False),
                              jax.tree.map(jnp.asarray, params), rng)
    engine = TrainEngine(model, create_optimizer("adahessian", LR, WD, model), objective,
                         needs_hessian=True)
    abmil.reset_launches()
    got = _port_diag(model, engine, batch, _to_port(_jax_z(params, rng)))
    assert sum(abmil.LAUNCHES.values()) + sum(abmil.LAUNCHES_BWD.values()) == 0
    assert "sigma.fc1_kernel" in got and "g.weight" in got
    _hold_diag(got, _to_port(want))


def test_hessian_diag_matches_jax_on_vlsa():
    text, image, prompt = _cfgs(f"{REPO}/vlsa_tpu/assets", False)
    jmodel, params, _tok = jax_build_vlsa(
        vlsa_api="CONCH", text_encoder_cfg=text, image_encoder_cfg=image,
        prompt_learner_cfg=prompt, rng=jax.random.PRNGKey(0), tower_overrides=TOWER)
    params = jax.tree.map(np.asarray, dict(params))
    frozen = jax_frozen_mask(params, ["prompt_encoder"])
    jobjective = jax_make_objective(jax_load_loss("vlsa", **VLSA_LOSSES), VLSA_WEIGHTS,
                                    jax_converter("softmax"), uses_vl=True)
    batch = vlsa_batches(1)[0]
    rng = jax.random.PRNGKey(4)
    with disable_pallas():
        want = jax_hutchinson(_jax_loss_fn(jmodel, jobjective, batch, True, frozen),
                              jax.tree.map(jnp.asarray, params), rng)
    text, image, prompt = _cfgs("vlsa_tpu/assets", False)
    model, _tok = build_vlsa(text, image, prompt, tower_overrides=TOWER, device="cpu",
                             state_dict=_to_port(params))
    model.train()
    frozen_mask_from_cfg(model, ["prompt_encoder"])
    objective = make_objective(load_loss("vlsa", **VLSA_LOSSES), VLSA_WEIGHTS,
                               make_output_converter("softmax"))
    engine = TrainEngine(model, create_optimizer("adahessian", LR, WD, model), objective,
                         needs_hessian=True)
    coattn.reset_launches()
    got = _port_diag(model, engine, batch, _to_port(_jax_z(params, rng)))
    assert sum(coattn.LAUNCHES.values()) + sum(coattn.LAUNCHES_BWD.values()) == 0
    assert "mil_encoder.visual_adapter.weight" in got and "logit_scale" in got
    assert not any(n.startswith("prompt_encoder.") for n in got)
    _hold_diag(got, _to_port(want))


def test_three_adahessian_steps_match_jax_train_engine():
    jmodel, params, jobjective, model, objective = _sa()
    tx = jax_create_optimizer("adahessian", LR, WD, params)
    step = JaxTrainEngine(jmodel, tx, jobjective, uses_vl=False, needs_hessian=True).train_step()
    engine = TrainEngine(model, create_optimizer("adahessian", LR, WD, model), objective,
                         needs_hessian=True)
    names, _params = engine._trainable()
    p, state = jax.tree.map(jnp.asarray, params), tx.init(params)
    for i, b in enumerate(sa_batches(STEPS)):
        z = _to_port(_jax_z(p, jax.random.fold_in(jax.random.PRNGKey(i), 7)))
        p, state, jloss, _raw = step(p, state, {k: jnp.asarray(v) for k, v in b.items()},
                                     jax.random.PRNGKey(i))
        loss, _raw = engine.train_step({k: torch.from_numpy(v) for k, v in b.items()},
                                       hessian_z=[z[n] for n in names])
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    want = _to_port(p)
    init = _to_port(params)
    for name, got in model.state_dict().items():
        got, w = got.numpy(), want[name].numpy()
        if name == NOISE_LEAF:
            np.testing.assert_array_equal(got, init[name].numpy())
            assert np.abs(w - got).max() <= STEPS * LR
            continue
        ok = np.abs(got - w) <= 1e-5 + 1e-4 * np.abs(w)
        assert np.all(ok), f"{name}: max |a-b| {np.abs(got - w)[~ok].max():.3e}"
        assert not np.array_equal(got, init[name].numpy()), name


def test_adahessian_refuses_what_vlsa_tpu_cannot_run():
    _jmodel, _params, _jobjective, model, objective = _sa()
    with pytest.raises(ValueError, match="accum_steps"):
        TrainEngine(model, create_optimizer("adahessian", LR, WD, model), objective,
                    accum_steps=2, needs_hessian=True)
    with pytest.raises(ValueError, match="lookahead_adahessian"):
        create_optimizer("lookahead_adahessian", LR, WD, model)


def test_hessian_through_a_once_differentiable_function_raises():
    """A loss whose gradient went through a `once_differentiable` backward
    (every kernel's) raises in `hutchinson_hessian_diag` -- the H z autograd
    would give through it is a silent zero -- and the same loss on plain
    operations does not."""
    from torch.autograd.function import once_differentiable

    class Square(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * x

        @staticmethod
        @once_differentiable
        def backward(ctx, g):
            (x,) = ctx.saved_tensors
            return 2 * x * g

    w = torch.randn(5, requires_grad=True)
    with pytest.raises(RuntimeError, match="disable_kernels"):
        hutchinson_hessian_diag(Square.apply(w).square().sum(), [w], ["w"])
    _g, (d,) = hutchinson_hessian_diag((w * w).square().sum(), [w], ["w"],
                                       z=[torch.ones(5)])
    torch.testing.assert_close(d, 12 * w.detach() ** 2)


def test_the_switch_nests():
    """disable_kernels() nests; the kernels come back when the outermost
    block exits, also when a block raises; the scope is the thread's."""
    assert not flags.kernels_disabled()
    with flags.disable_kernels():
        assert flags.kernels_disabled()
        with flags.disable_kernels():
            assert flags.kernels_disabled()
        assert flags.kernels_disabled()
        with pytest.raises(RuntimeError):
            with flags.disable_kernels():
                raise RuntimeError("inside")
        assert flags.kernels_disabled()
        seen = []
        other = threading.Thread(target=lambda: seen.append(flags.kernels_disabled()))
        other.start()
        other.join()
        assert seen == [False]  # another thread keeps the kernels
    assert not flags.kernels_disabled()
