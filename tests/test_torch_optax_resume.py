"""Resuming vlsa_tpu's optimizer state in the port
(`optim/optax_state.py::load_optax_state`, `runner/base.py::resume_model`).

Optimizer level: vlsa_tpu's optax chain (`vlsa_tpu.optim.create_optimizer`,
with weight decay on both of its groups and, but for adamp and sgdp, a
frozen subtree) takes K steps on tests/test_torch_optim.py's parameters
plus a square 128 x 128 Dense kernel (which Adafactor factors with its row
and column factors swapped between the two layouts), and
`vlsa_tpu.runner.ckpt.save_checkpoint` writes its parameters and optax
state with each backend, msgpack and orbax.  vlsa_tpu then takes K more
steps.  The port reads the file (`runner.ckpt.load_checkpoint`), loads the
parameters and the optimizer state, and takes the same K steps: its
parameters are within 1e-6 + 1e-5 |b| of vlsa_tpu's, the tolerance of
tests/test_torch_optim.py (both update in f32 with the same formulas, in
another order of operations), for every name of vlsa_tpu's factory and
`lookahead_adam`.  Lookahead is resumed before its first sync (k = 6) and
after it; a learning rate that vlsa_tpu's runner halved (as its
ReduceLROnPlateau does, into the injected hyperparameter) comes back as the
port's rate.  A tree that does not fit the optimizer raises a ValueError
and loads nothing.

Handler level: vlsa_tpu's SA and tiny flagship runs (the lifecycle runs of
tests/test_torch_lifecycle.py) train epoch 1 of 2 with `auto_resume`; two
copies of that run directory are resumed for epoch 2, one by vlsa_tpu and
one by the port (from the same initial weights, which the filtered-out
frozen tower keeps): every final metric within rtol 1e-4 / atol 1e-5.
"""
import contextlib
import functools
import io
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from test_torch_lifecycle import (COHORT_SEED, jax_abmil_interpret, jax_initial_state,
                                  lifecycle_cfg, write_cohort)
from test_torch_optim import FAN_IN, FAN_OUT, LR, WD, _grads, _init, _leaf
from vlsa_tpu.optim import create_optimizer as jax_create_optimizer
from vlsa_tpu.optim.factory import frozen_mask_from_cfg as jax_frozen_mask
from vlsa_tpu.runner import SAHandler as JaxSAHandler
from vlsa_tpu.runner import VLSAHandler as JaxVLSAHandler
from vlsa_tpu.runner.ckpt import save_checkpoint as jax_save_checkpoint
from vlsa_tpu_torch.optim import create_optimizer, frozen_mask_from_cfg
from vlsa_tpu_torch.optim.factory import OPTIMIZERS
from vlsa_tpu_torch.optim.optax_state import load_optax_state
from vlsa_tpu_torch.runner.ckpt import load_checkpoint
from vlsa_tpu_torch.runner.sa import SAHandler
from vlsa_tpu_torch.runner.vlsa import VLSAHandler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 5
SQ = 128
_NO_FROZEN_MASK = ("adamp", "sgdp")  # vlsa_tpu cannot mask them (ROADMAP.md §C)


def _init_sq(seed=0):
    """tests/test_torch_optim.py's parameters under the weight bridge's
    names (its scalar `scale` would be a LayerNorm's; here `logit_scale`,
    as the models name theirs) and a square Dense kernel."""
    init = _init(seed)
    init["logit_scale"] = init.pop("scale")
    rng = np.random.default_rng(seed + 7)
    init["sq"] = {"kernel": (rng.normal(size=(SQ, SQ)) * SQ ** -0.5).astype(np.float32)}
    return init


class SqNet(nn.Module):
    def __init__(self, init):
        super().__init__()
        self.logit_scale = nn.Parameter(torch.tensor(init["logit_scale"]))
        self.vec = nn.Parameter(torch.from_numpy(init["vec"].copy()))
        self.mat = nn.Parameter(torch.from_numpy(init["mat"].copy()))
        self.fc = nn.Linear(FAN_IN, FAN_OUT)
        self.sq = nn.Linear(SQ, SQ, bias=False)
        with torch.no_grad():
            self.fc.weight.copy_(torch.from_numpy(init["fc"]["kernel"].T.copy()))
            self.fc.bias.copy_(torch.from_numpy(init["fc"]["bias"]))
            self.sq.weight.copy_(torch.from_numpy(init["sq"]["kernel"].T.copy()))
        self.tower = nn.Module()
        self.tower.mat = nn.Parameter(torch.from_numpy(init["tower"]["mat"].copy()))


def _hessians(init, n, seed=2):
    rng = np.random.default_rng(seed)
    return [jax.tree.map(lambda v: np.abs(rng.normal(size=np.shape(v))).astype(np.float32),
                         init) for _ in range(n)]


def _tree_grads(init, n):
    """n gradient trees: tests/test_torch_optim.py's (the Dense kernel's
    orthogonal to its channels) and random ones for the square kernel."""
    base = {k: v for k, v in init.items() if k not in ("sq", "logit_scale")}
    grads = []
    for seed in range(1, n):
        grads += _grads(dict(base, scale=init["logit_scale"]), seed=seed)
        if len(grads) >= n:
            break
    rng = np.random.default_rng(5)
    return [dict({k: v for k, v in g.items() if k != "scale"}, logit_scale=g["scale"],
                 sq={"kernel": rng.normal(size=(SQ, SQ)).astype(np.float32)})
            for g in grads[:n]]


@functools.lru_cache(maxsize=None)
def jax_run(opt_name, k_first, halve_lr, root):
    """vlsa_tpu's K-step run: the checkpoints after `k_first` steps (msgpack
    and orbax, under `root`) and the parameters after K more."""
    init = _init_sq()
    grads = _tree_grads(init, k_first + K)
    hessians = _hessians(init, k_first + K) if opt_name == "adahessian" else \
        [None] * (k_first + K)
    params = jax.tree.map(jnp.asarray, init)
    frozen = jax_frozen_mask(params, ["tower"])
    if opt_name.split("_")[-1] in _NO_FROZEN_MASK:
        params, frozen = {k: v for k, v in params.items() if k != "tower"}, None
        grads = [{k: v for k, v in g.items() if k != "tower"} for g in grads]
    tx = jax_create_optimizer(opt_name, LR, WD, params, frozen=frozen)
    state = tx.init(params)
    paths = {}
    for step, (g, h) in enumerate(zip(grads, hessians)):
        if step == k_first:
            if halve_lr:  # vlsa_tpu/runner/base.py:373-377
                state.hyperparams["learning_rate"] = jnp.asarray(LR * 0.5)
            for backend in ("msgpack", "orbax"):
                paths[backend] = os.path.join(root, f"{opt_name}-{k_first}-{backend}.ckpt")
                jax_save_checkpoint(paths[backend], 3, params, backend=backend,
                                    opt_state=state)
        extra = {} if h is None else {"hessian_diag": jax.tree.map(jnp.asarray, h)}
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, params, **extra)
        params = optax.apply_updates(params, updates)
    final = jax.tree.map(np.asarray, dict(params, tower=params.get("tower", init["tower"])))
    return paths, final, grads[k_first:], hessians[k_first:]


def port_resume(opt_name, path, grads, hessians):
    """The port's optimizer over SqNet, resumed from `path`, after the
    given steps."""
    init = _init_sq()
    net = SqNet(init)
    frozen_mask_from_cfg(net, ["tower"])
    opt = create_optimizer(opt_name, LR, WD, net)
    ckpt = load_checkpoint(path)
    assert ckpt["epoch"] == 3 and "optax_state" in ckpt
    net.load_state_dict(ckpt["model"], strict=False)
    load_optax_state(opt, opt_name, ckpt["optax_state"])
    for g, h in zip(grads, hessians):
        for name, p in net.named_parameters():
            if p.requires_grad:
                p.grad = torch.as_tensor(_leaf(g, name)).clone()
        if h is None:
            opt.step()
        else:
            opt.step(hessian={p: torch.as_tensor(_leaf(h, n)).clone()
                              for n, p in net.named_parameters() if p.requires_grad})
    return net, opt


@pytest.fixture(scope="module")
def ckpt_root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("optax"))


CASES = [(n, 3, False) for n in OPTIMIZERS] + [
    ("lookahead_adam", 4, False),   # before the first sync
    ("lookahead_adam", 8, False),   # after it (the slow weights exist)
    ("adam", 3, True)]              # a halved learning rate


@pytest.mark.parametrize("backend", ["msgpack", "orbax"])
@pytest.mark.parametrize("opt_name,k_first,halve_lr", CASES,
                         ids=[f"{n}-{k}" + ("-halved" if h else "") for n, k, h in CASES])
def test_port_resumes_vlsa_tpus_optimizer(ckpt_root, opt_name, k_first, halve_lr, backend):
    paths, want, grads, hessians = jax_run(opt_name, k_first, halve_lr, ckpt_root)
    net, opt = port_resume(opt_name, paths[backend], grads, hessians)
    for name, p in net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), _leaf(want, name), rtol=1e-5, atol=1e-6,
                                   err_msg=f"{opt_name}: {name}")
    assert all(g["lr"] == (LR * 0.5 if halve_lr else LR) for g in opt.param_groups)
    if opt_name.startswith("lookahead_"):
        assert opt._count == k_first + K
        assert all(("slow" in opt.state[p]) == (k_first + K >= 6)
                   for p in net.parameters() if p.requires_grad)


def test_the_state_is_the_one_optax_has(ckpt_root):
    """Adam's moments land on their parameters in the port's layout (the
    Dense kernel's transposed), with optax's count as the step."""
    paths, _want, _g, _h = jax_run("adam", 3, False, ckpt_root)
    ckpt = load_checkpoint(paths["msgpack"])
    mu = ckpt["optax_state"]["inner_state"]["inner_states"]["train"]["inner_state"]["1"]["mu"]
    net = SqNet(_init_sq())
    frozen_mask_from_cfg(net, ["tower"])
    opt = create_optimizer("adam", LR, WD, net)
    load_optax_state(opt, "adam", ckpt["optax_state"])
    st = opt.state[net.fc.weight]
    assert float(st["step"]) == 3.0
    np.testing.assert_array_equal(st["exp_avg"].numpy(), mu["fc"]["kernel"].T)
    assert mu["tower"]["mat"] == {} and net.tower.mat not in opt.state


def _adam_tree(ckpt_root):
    paths, _w, _g, _h = jax_run("adam", 3, False, ckpt_root)
    return load_checkpoint(paths["msgpack"])["optax_state"]


def _train(tree):
    return tree["inner_state"]["inner_states"]["train"]["inner_state"]["1"]


@pytest.mark.parametrize("change,match", [
    (lambda t: _train(t)["mu"].pop("vec"), "no state for vec"),
    (lambda t: _train(t)["mu"].update(extra=np.zeros(3, np.float32)), "extra"),
    (lambda t: _train(t)["nu"]["fc"].update(kernel=np.zeros((3, 3), np.float32)),
     "fc/kernel has shape"),
    (lambda t: t.pop("hyperparams"), "inject_hyperparams"),
    (lambda t: _train(t).pop("nu"), "fields"),
])
def test_a_tree_that_does_not_fit_raises_and_loads_nothing(ckpt_root, change, match):
    tree = _adam_tree(ckpt_root)
    change(tree)
    net = SqNet(_init_sq())
    frozen_mask_from_cfg(net, ["tower"])
    opt = create_optimizer("adam", LR, WD, net)
    with pytest.raises(ValueError, match=match):
        load_optax_state(opt, "adam", tree)
    assert not opt.state and all(g["lr"] == LR for g in opt.param_groups)


def test_the_name_must_be_the_optimizers(ckpt_root):
    net = SqNet(_init_sq())
    opt = create_optimizer("adam", LR, WD, net)
    with pytest.raises(ValueError, match="Adam"):
        load_optax_state(opt, "lookahead_adam", _adam_tree(ckpt_root))


# ---------------------------------------------------------------- handlers

@pytest.fixture(scope="module", params=["sa", "vlsa"])
def resumed(request, tmp_path_factory):
    """vlsa_tpu's run trains epoch 1 of 2 (auto_resume: a last checkpoint
    each epoch); vlsa_tpu and the port each resume a copy for epoch 2:
    (kind, vlsa_tpu's handler, its metrics, the port's handler, its
    metrics, the port's output)."""
    kind = request.param
    root = tmp_path_factory.mktemp(f"resume_{kind}")
    table, split = write_cohort(str(root), seed=COHORT_SEED[kind])
    interp = jax_abmil_interpret if kind == "sa" else contextlib.nullcontext
    jax_cls = JaxVLSAHandler if kind == "vlsa" else JaxSAHandler
    first = lifecycle_cfg(kind, root, table, split, root / "first", epochs=1, auto_resume=True)
    with interp():
        handler = jax_cls(first)
        init = jax_initial_state(handler)
        handler.exec()
    for name in ("jax", "port"):
        shutil.copytree(first["save_path"], str(root / name))
    with interp():
        jax_handler = jax_cls(lifecycle_cfg(kind, root, table, split, root / "jax", epochs=2,
                                            auto_resume=True))
        jax_metrics = jax_handler.exec()
    port_cls = VLSAHandler if kind == "vlsa" else SAHandler
    port = port_cls(lifecycle_cfg(kind, root, table, split, root / "port", epochs=2,
                                  auto_resume=True), device="cpu", state_dict=init)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        port_metrics = port.exec()
    return kind, jax_handler, jax_metrics, port, port_metrics, out.getvalue()


def test_port_resumes_a_vlsa_tpu_run(resumed):
    _kind, _jh, want, port, got, out = resumed
    assert "[train] auto-resume: continuing from epoch 1" in out
    assert [t["epoch"] for t in port.timings["epochs"]] == [2]
    assert got.keys() == want.keys()
    for split in want:
        w, g = dict(want[split]), dict(got[split])
        assert g.keys() == w.keys()
        for name, value in w.items():
            assert np.isclose(g[name], value, rtol=1e-4, atol=1e-5), (split, name, g[name], value)


def _structure(tree):
    """Keys, empty dicts, and each leaf's shape and dtype."""
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    return (np.shape(tree), np.asarray(tree).dtype.name)


def test_chip_smokes_optax_packer_gives_vlsa_tpus_tree(resumed):
    """chip_smoke.py's `optax_adam_tree`, which packs the port's Adam state
    into vlsa_tpu's optimizer tree for phase 3u, gives the tree of vlsa_tpu's
    own runner (keys, masked leaves, shapes, dtypes); `load_optax_state`
    takes its moments back into the port's optimizer bit for bit."""
    import flax.serialization
    sys.path.insert(0, REPO)
    import chip_smoke
    kind, jax_handler, _w, port, _g, _o = resumed
    want = jax.tree.map(np.asarray, flax.serialization.to_state_dict(jax_handler.opt_state))
    packed = chip_smoke.optax_adam_tree(port.model, port.optimizer.state_dict(),
                                        port.cfg["opt_weight_decay"])
    assert _structure(packed) == _structure(want)
    if kind == "vlsa":  # the frozen tower's moments are MaskedNodes
        mu = want["inner_state"]["inner_states"]["train"]["inner_state"]["1"]["mu"]
        assert mu["prompt_encoder"] and all(
            v == {} for v in jax.tree_util.tree_leaves(mu["prompt_encoder"],
                                                       is_leaf=lambda x: x == {}))
    fresh = port_cls_optimizer(port)
    load_optax_state(fresh, port.cfg["opt_name"], packed)
    got, ref = fresh.state_dict(), port.optimizer.state_dict()
    assert got["state"].keys() == ref["state"].keys()
    count = max(float(st["step"]) for st in ref["state"].values())
    for i, st in ref["state"].items():
        # optax counts every update, torch a parameter's own (ABMIL's fc2_bias
        # gets no gradient, so its torch step stops where the resume set it)
        assert float(got["state"][i]["step"]) == count, i
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(got["state"][i][k], st[k]), (i, k)
    assert [g["lr"] for g in got["param_groups"]] == [g["lr"] for g in ref["param_groups"]]


def port_cls_optimizer(handler):
    """A fresh optimizer over `handler`'s model, as its trainer builds it."""
    return create_optimizer(handler.cfg["opt_name"], handler.cfg["opt_lr"],
                            handler.cfg.get("opt_weight_decay", 0.0), handler.model)
