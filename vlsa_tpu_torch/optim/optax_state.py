"""vlsa_tpu's optimizer state (optax's tree, as a checkpoint holds it) put
into this package's optimizers, so a run vlsa_tpu saved resumes here with
the same moments, step counts and learning rate.

vlsa_tpu builds its optimizer as (vlsa_tpu/optim/factory.py:108-140)

    inject_hyperparams(learning_rate)(
        multi_transform({"train": tx, "frozen": set_to_zero()}, labels))

(adahessian: `chain(tx, masked(set_to_zero(), frozen))`; no mask at all
where no frozen tree is given), with `tx` the chain of `_base_tx` and, for
`lookahead_<name>`, `extra.lookahead(tx)`.  flax's state dict of that state
has `hyperparams/learning_rate`, and under `inner_state` the chain's states
as {"0": ..., "1": ...}.  The state of each transformation that keeps
moments is found in the chain by its fields:

    adam, adamw, nadam, radam,     {count, mu, nu}   -> step, exp_avg /
      adamp, adahessian                                  exp_avg_sq or mu / nu
    novograd, nvnovograd           {count, mu, nu}   -> mu, nu (0-d per leaf)
    sgd, nesterov, momentum        {trace}           -> momentum_buffer
    rmsprop, rmsproptf             {nu} and {trace}  -> nu, trace
    adadelta                       {e_g, e_x}        -> e_g, e_x
    adafactor                      {count, v_row, v_col, v} -> step, v_row /
                                                           v_col or v
    sgdp                           the buffer tree itself -> buf
    lookahead_<name>               {inner, slow, count} -> the inner one's
                                                           state, slow, count

Each moment tree has the parameter tree's paths, with an empty dict (optax's
MaskedNode) at every frozen leaf.  A path is this package's parameter name
through the weight bridge (`utils.weights.leaf_name`), and a moment takes
the permutation its weight takes (a Dense kernel transposed).  Adafactor
factors the two largest axes of a leaf, optax in vlsa_tpu's layout and
`extra.Adafactor` in this package's: its row factor (the largest axis
averaged out) and column factor are matched by the axis each averages out,
so a transposed square weight swaps them.

Nothing is loaded unless every leaf matches: a tree with a leaf the
optimizer lacks, without one it has, or of another shape raises a
ValueError naming the first mismatch.  The learning rate, an f32 in
optax's state, becomes each group's `lr` as the shortest decimal that
gives that f32 (0.001 stays 0.001; a rate ReduceLROnPlateau halved stays
its half).
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from ..utils.weights import leaf_name
from . import extra
from .factory import OPTIMIZERS, split_opt_name

_ADAM = frozenset({"count", "mu", "nu"})
_TRACE = frozenset({"trace"})
_RMS = frozenset({"nu"})
_DELTA = frozenset({"e_g", "e_x"})
_FACTOR = frozenset({"count", "v_row", "v_col", "v"})
_LOOKAHEAD = frozenset({"inner", "slow", "count"})


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    return torch.from_numpy(np.array(x))


def _find(node, fields: frozenset, where: str) -> dict:
    """The one dict of `node`'s chain whose keys are `fields`."""
    found = []

    def walk(n):
        if isinstance(n, dict):
            if frozenset(n) == fields:
                found.append(n)
                return
            for v in n.values():
                walk(v)

    walk(node)
    if len(found) != 1:
        raise ValueError(f"{where}: expected one state with fields {sorted(fields)} in the "
                         f"optimizer tree, found {len(found)}")
    return found[0]


def _leaves(tree, path=()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    """(path, leaf) of a moment tree; optax's MaskedNodes (empty dicts, the
    frozen leaves) left out."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    else:
        yield path, tree


def _inner(tree: dict, base: str) -> Tuple[dict, bool]:
    """The state of `tx` (the factory's chain, or lookahead's) under
    inject_hyperparams and the frozen mask, and whether its moments also
    cover the frozen leaves (adahessian's chain: its updates are zeroed
    after it, so it keeps moments for every leaf)."""
    if not isinstance(tree, dict) or "inner_state" not in tree or "hyperparams" not in tree:
        raise ValueError("not vlsa_tpu's optimizer tree: no inject_hyperparams state "
                         "(inner_state, hyperparams)")
    inner = tree["inner_state"]
    if isinstance(inner, dict) and "inner_states" in inner:  # multi_transform
        return inner["inner_states"]["train"]["inner_state"], False
    if base == "adahessian" and isinstance(inner, dict) and set(inner) == {"0", "1"}:
        return inner["0"], True  # chain(tx, masked(set_to_zero(), frozen))
    return inner, False


class _Params:
    """The optimizer's parameters by name, and the moment trees' check
    against them."""

    def __init__(self, optimizer: torch.optim.Optimizer, frozen_too: bool = False):
        self.frozen_too = frozen_too
        self.by_name: Dict[str, torch.Tensor] = {}
        for group in optimizer.param_groups:
            names = group.get("names")
            if names is None:
                raise ValueError("the optimizer's param_groups carry no 'names' "
                                 "(optim.factory.create_optimizer gives them)")
            self.by_name.update(zip(names, group["params"]))

    def moments(self, tree, what: str, reshape=None) -> Dict[str, torch.Tensor]:
        """{name: moment in this package's layout} of a moment tree, which
        must hold exactly the optimizer's parameters.  `reshape(name, path,
        value)` maps a leaf whose shape is not the parameter's."""
        out: Dict[str, torch.Tensor] = {}
        for path, value in _leaves(tree):
            arr = _tensor(value)
            name, axes = leaf_name(path, arr.dim())
            if name not in self.by_name and self.frozen_too:
                continue  # a frozen leaf's moment, zeroed out by the chain's mask
            if name not in self.by_name:
                raise ValueError(f"{what}: {'/'.join(path)} ({name}) is not a parameter the "
                                 f"optimizer trains")
            if name in out:
                raise ValueError(f"{what}: two leaves map to {name}")
            if reshape is not None:
                out[name] = reshape(name, path, arr)
                continue
            arr = arr if axes is None else arr.permute(*axes)
            want = self.by_name[name].shape
            if arr.shape != want:
                raise ValueError(f"{what}: {'/'.join(path)} has shape {tuple(arr.shape)}, "
                                 f"{name} {tuple(want)}")
            out[name] = arr.contiguous()
        missing = [n for n in self.by_name if n not in out]
        if missing:
            raise ValueError(f"{what}: no state for {missing[0]}"
                             + (f" and {len(missing) - 1} more" if len(missing) > 1 else ""))
        return out


def _count(state: dict) -> int:
    return int(np.asarray(state["count"]).reshape(()))


def _by_name(tree) -> Dict[str, Tuple[Tuple[str, ...], torch.Tensor]]:
    return {leaf_name(path, 0)[0]: (path, _tensor(v)) for path, v in _leaves(tree)}


def _jax_shape(shape, axes) -> Tuple[int, ...]:
    """A shape in this package's layout in vlsa_tpu's (torch axis i is
    vlsa_tpu's axis axes[i])."""
    if axes is None:
        return tuple(shape)
    jshape = [0] * len(shape)
    for i, a in enumerate(axes):
        jshape[a] = shape[i]
    return tuple(jshape)


def _optax_factored_dims(shape):
    """optax's `_factored_dims` (adafactor's defaults: factored, min dim
    128) on a shape in vlsa_tpu's layout."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < 128:
        return None
    return int(order[-2]), int(order[-1])


def _adafactor_state(params: _Params, st: dict, what: str) -> Dict[str, dict]:
    """{name: {step, v_row, v_col} or {step, v}} in `extra.Adafactor`'s
    layout from optax's FactoredState."""
    count = _count(st)
    rows, cols, full = _by_name(st["v_row"]), _by_name(st["v_col"]), _by_name(st["v"])
    for tree in (rows, cols, full):
        for name, (path, _v) in tree.items():
            if name not in params.by_name:
                raise ValueError(f"{what}: {'/'.join(path)} ({name}) is not a parameter the "
                                 f"optimizer trains")
    out = {}
    for name, p in params.by_name.items():
        if not (name in rows and name in cols and name in full):
            raise ValueError(f"{what}: no state for {name}")
        path, v = full[name]
        _n, axes = leaf_name(path, p.dim())
        jshape = _jax_shape(p.shape, axes)
        dims_j = _optax_factored_dims(jshape)
        dims_t = extra.Adafactor._factored_dims(tuple(p.shape), 128)
        if (dims_j is None) != (dims_t is None):
            raise ValueError(f"{what}: {name} is factored by one package only")
        if dims_j is None:
            v = v if axes is None else v.permute(*axes)
            if v.shape != p.shape:
                raise ValueError(f"{what}: {'/'.join(path)} has shape {tuple(v.shape)}, "
                                 f"{name} {tuple(p.shape)}")
            out[name] = {"step": count, "v": v.contiguous()}
            continue
        to_j = list(axes) if axes is not None else list(range(p.dim()))
        # optax's v_row averages out its largest axis d1, v_col its second d0
        by_reduced = {dims_j[1]: rows[name][1], dims_j[0]: cols[name][1]}
        factors = []
        for t_axis in (dims_t[1], dims_t[0]):  # extra.Adafactor's v_row, then v_col
            j_axis = to_j[t_axis]
            if j_axis not in by_reduced:
                raise ValueError(f"{what}: {name}'s factored axes differ between the packages")
            kept_j = [a for a in range(p.dim()) if a != j_axis]
            kept_t = [to_j[i] for i in range(p.dim()) if i != t_axis]
            f = by_reduced[j_axis]
            want = tuple(jshape[a] for a in kept_j)
            if tuple(f.shape) != want:
                raise ValueError(f"{what}: {name}'s factor has shape {tuple(f.shape)}, "
                                 f"expected {want}")
            factors.append(f.permute(*[kept_j.index(a) for a in kept_t]).contiguous())
        out[name] = {"step": count, "v_row": factors[0], "v_col": factors[1]}
    return out


def _lr(tree: dict) -> float:
    """The injected learning rate as the shortest decimal of its f32."""
    return float(str(np.float32(np.asarray(tree["hyperparams"]["learning_rate"]).reshape(()))))


def _base_state(base: str, inner, params: _Params, what: str) -> Dict[str, dict]:
    """{parameter name: the torch optimizer's state} of the base optimizer
    `base` from its optax state `inner`."""
    if base == "sgdp":
        return {n: {"buf": m} for n, m in params.moments(inner, what).items()}
    if base in ("sgd", "nesterov", "momentum"):
        trace = params.moments(_find(inner, _TRACE, what)["trace"], what)
        return {n: {"momentum_buffer": m} for n, m in trace.items()}
    if base in ("rmsprop", "rmsproptf"):
        nu = params.moments(_find(inner, _RMS, what)["nu"], what)
        trace = params.moments(_find(inner, _TRACE, what)["trace"], what)
        return {n: {"nu": nu[n], "trace": trace[n]} for n in nu}
    if base == "adadelta":
        st = _find(inner, _DELTA, what)
        e_g, e_x = params.moments(st["e_g"], what), params.moments(st["e_x"], what)
        return {n: {"e_g": e_g[n], "e_x": e_x[n]} for n in e_g}
    if base == "adafactor":
        return _adafactor_state(params, _find(inner, _FACTOR, what), what)
    if base not in OPTIMIZERS:
        raise ValueError(f"optimizer {base!r}: vlsa_tpu's factory has {OPTIMIZERS}")
    st = _find(inner, _ADAM, what)
    count = _count(st)
    if base in ("novograd", "nvnovograd"):
        mu = params.moments(st["mu"], what)
        nu = params.moments(st["nu"], what, reshape=lambda n, p, v: v.reshape(()).clone())
        return {n: {"mu": mu[n], "nu": nu[n]} for n in mu}
    mu, nu = params.moments(st["mu"], what), params.moments(st["nu"], what)
    if base in ("adam", "adamw"):
        return {n: {"step": torch.tensor(float(count), dtype=torch.float32),
                    "exp_avg": mu[n], "exp_avg_sq": nu[n]} for n in mu}
    return {n: {"step": count, "mu": mu[n], "nu": nu[n]} for n in mu}


def _fill(optimizer: torch.optim.Optimizer, states: Dict[str, dict], lr: float) -> None:
    """Load {name: state} and the learning rate through the optimizer's
    own `load_state_dict` (which puts each tensor on its parameter's
    device)."""
    sd = optimizer.state_dict()
    index = {}
    for g_sd, group in zip(sd["param_groups"], optimizer.param_groups):
        g_sd["lr"] = lr
        index.update(zip(group["names"], g_sd["params"]))
    sd["state"] = {index[n]: st for n, st in states.items()}
    optimizer.load_state_dict(sd)


def load_optax_state(optimizer: torch.optim.Optimizer, opt_name: str, tree: dict) -> None:
    """Put vlsa_tpu's optimizer state `tree` (flax's state dict of optax's
    state, as `runner.ckpt.load_checkpoint` gives it under "optax_state")
    into `optimizer`, built by `optim.factory.create_optimizer(opt_name,
    ...)` over the same model (see the module's docstring)."""
    base, lookahead = split_opt_name(opt_name)
    what = f"optimizer state of {opt_name!r}"
    if lookahead != isinstance(optimizer, extra.Lookahead):
        raise ValueError(f"{what}: the optimizer is {type(optimizer).__name__}")
    inner, frozen_too = _inner(tree, base)
    lr = _lr(tree)
    params = _Params(optimizer, frozen_too)
    # before any update (inject_hyperparams' count 0) a torch optimizer has no state yet
    fresh = _count(tree) == 0
    if not lookahead:
        states = _base_state(base, inner, params, what)
        _fill(optimizer, {} if fresh else states, lr)
        return
    la = _find(inner, _LOOKAHEAD, what) if frozenset(inner) != _LOOKAHEAD else inner
    states = _base_state(base, la["inner"], params, what)
    slow = params.moments(la["slow"], f"{what} (lookahead's slow weights)")
    la_count = _count(la)
    _fill(optimizer.inner, {} if fresh else states, lr)
    sd = optimizer.state_dict()
    index = {}
    for g_sd, group in zip(sd["lookahead"]["param_groups"], optimizer.param_groups):
        index.update(zip(group["names"], g_sd["params"]))
    # the slow weights exist from the first sync on (k steps), as extra.Lookahead keeps them
    sd["lookahead"]["state"] = ({index[n]: {"slow": s} for n, s in slow.items()}
                                if la_count >= optimizer.k else {})
    sd["count"] = la_count
    sd["inner"] = optimizer.inner.state_dict()
    optimizer.load_state_dict(sd)
