"""The optimizers of vlsa_tpu's factory beyond Adam and SGD, as
`torch.optim.Optimizer` subclasses over the factory's `param_groups`
(counterpart of vlsa_tpu/optim/factory.py:60-85 and vlsa_tpu/optim/extra.py).

Each follows vlsa_tpu's optax chain update for update, not the torch class
of the same name:

  * `Nadam`: optax's Nesterov Adam (`optax.nadam`), the bias-corrected
    b1 m / (1 - b1^(t+1)) + (1 - b1) g / (1 - b1^t), no momentum decay;
  * `RAdam`: `optax.radam`, the rectified step where rho_t >= 5, else the
    bias-corrected momentum alone;
  * `Adadelta`: `optax.adadelta(lr)` (rho 0.9, eps 1e-6, scaled by lr);
  * `Adafactor`: `optax.adafactor(lr)`: the second moment factored into row
    and column means for leaves whose two largest dimensions are >= 128,
    decay 1 - t^-0.8, updates clipped to block RMS 1, scaled by the
    parameter's RMS (at least 1e-3); no weight decay, as in vlsa_tpu;
  * `NovoGrad`: `optax.novograd` with the factory's betas: a per-leaf
    second moment of ||g||^2, the first moment's first step g / sqrt(nu);
  * `RMSprop`: `optax.rmsprop(lr, decay=0.9, momentum=0.9)`: eps inside the
    square root, the scale from 0, the momentum traced on lr-scaled steps;
  * `AdamP`, `SGDP`: vlsa_tpu/optim/extra.py's projections and their own
    weight decay (times 0.1 where they project; delta 0.1);
  * `Adahessian`: Adam whose second moment is the Hutchinson estimate of the
    Hessian diagonal (`hutchinson_hessian_diag`), given to `step(hessian=)`;
  * `Lookahead`: k = 6 fast steps of an inner optimizer, then the slow
    weights pulled alpha = 0.5 of the way to the fast ones (the first sync a
    no-op).

Weight decay is the factory's: each group's "weight_decay" (0 for 1-D
leaves, timm's mask) added to the gradient before the update (optax's
`add_decayed_weights` ahead of the chain) for every optimizer but AdamP and
SGDP (their own) and Adafactor (none).

Layouts.  vlsa_tpu's Dense kernel is [in, out]; this package's
`nn.Linear.weight` is [out, in] (`utils.weights`: a 2-D `.weight` was a
Dense kernel, every other leaf keeps vlsa_tpu's layout).  Where a rule
depends on the axes -- AdamP's and SGDP's channel view (axis 0), the
Hessian estimate's spatial average (axes 1..) -- it is applied to
`jax_layout(name, t)`, the tensor in vlsa_tpu's layout.  (Adafactor factors
by the dimensions' sizes, and its row and column factors give the same
product either way round: it needs no view.)
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import torch


def is_dense_weight(name: str, t: torch.Tensor) -> bool:
    """A 2-D `.weight`: vlsa_tpu's Dense kernel, transposed."""
    return t.dim() == 2 and name.split(".")[-1] == "weight"


def jax_layout(name: str, t: torch.Tensor) -> torch.Tensor:
    """`t` (a parameter named `name`, or a tensor of its shape) in vlsa_tpu's
    layout: a Dense weight transposed, anything else as it is."""
    return t.T if is_dense_weight(name, t) else t


class _Base(torch.optim.Optimizer):
    """Per-parameter updates over the factory's groups (each with "names")."""

    def _leaves(self):
        for group in self.param_groups:
            names = group.get("names") or [""] * len(group["params"])
            for name, p in zip(names, group["params"]):
                if p.grad is not None:
                    yield group, name, p

    @staticmethod
    def _decayed(group, p):
        """The gradient with the group's coupled weight decay."""
        wd = group.get("weight_decay", 0.0)
        return p.grad + wd * p if wd else p.grad


class Nadam(_Base):
    def __init__(self, params, lr, betas=(0.9, 0.999), eps=1e-8):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group, _name, p in self._leaves():
            b1, b2 = group["betas"]
            g = self._decayed(group, p)
            st = self.state[p]
            if not st:
                st.update(step=0, mu=torch.zeros_like(p), nu=torch.zeros_like(p))
            st["step"] += 1
            t = st["step"]
            st["mu"].mul_(b1).add_(g, alpha=1 - b1)
            st["nu"].mul_(b2).addcmul_(g, g, value=1 - b2)
            mu_hat = b1 * st["mu"] / (1 - b1 ** (t + 1)) + (1 - b1) * g / (1 - b1 ** t)
            nu_hat = st["nu"] / (1 - b2 ** t)
            p.add_(mu_hat / (nu_hat.sqrt() + group["eps"]), alpha=-group["lr"])


class RAdam(_Base):
    def __init__(self, params, lr, betas=(0.9, 0.999), eps=1e-8, threshold=5.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, threshold=threshold))

    @torch.no_grad()
    def step(self, closure=None):
        for group, _name, p in self._leaves():
            b1, b2 = group["betas"]
            g = self._decayed(group, p)
            st = self.state[p]
            if not st:
                st.update(step=0, mu=torch.zeros_like(p), nu=torch.zeros_like(p))
            st["step"] += 1
            t = st["step"]
            st["mu"].mul_(b1).add_(g, alpha=1 - b1)
            st["nu"].mul_(b2).addcmul_(g, g, value=1 - b2)
            mu_hat = st["mu"] / (1 - b1 ** t)
            ro_inf = 2.0 / (1.0 - b2) - 1.0
            b2t = b2 ** t
            ro = ro_inf - 2 * t * b2t / (1 - b2t)
            if ro >= group["threshold"]:
                r = math.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                              / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
                nu_hat = st["nu"] / (1 - b2t)
                upd = r * mu_hat / (nu_hat.sqrt() + group["eps"])
            else:
                upd = mu_hat
            p.add_(upd, alpha=-group["lr"])


class Adadelta(_Base):
    def __init__(self, params, lr, rho=0.9, eps=1e-6):
        super().__init__(params, dict(lr=lr, rho=rho, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group, _name, p in self._leaves():
            rho, eps = group["rho"], group["eps"]
            g = self._decayed(group, p)
            st = self.state[p]
            if not st:
                st.update(e_g=torch.zeros_like(p), e_x=torch.zeros_like(p))
            st["e_g"].mul_(rho).addcmul_(g, g, value=1 - rho)
            upd = (st["e_x"] + eps).sqrt() / (st["e_g"] + eps).sqrt() * g
            st["e_x"].mul_(rho).addcmul_(upd, upd, value=1 - rho)
            p.add_(upd, alpha=-group["lr"])


class Adafactor(_Base):
    """`optax.adafactor(lr)` with its defaults (factored, decay rate 0.8,
    min dim 128 to factor, eps 1e-30, clipping 1.0, parameter scale, no
    momentum, no weight decay)."""

    def __init__(self, params, lr, decay_rate=0.8, min_dim_size_to_factor=128, eps=1e-30,
                 clipping_threshold=1.0, min_scale=1e-3):
        super().__init__(params, dict(lr=lr, decay_rate=decay_rate, min_dim=min_dim_size_to_factor,
                                      eps=eps, clip=clipping_threshold, min_scale=min_scale))

    @staticmethod
    def _factored_dims(shape, min_dim):
        if len(shape) < 2:
            return None
        order = sorted(range(len(shape)), key=lambda i: (shape[i], i))  # numpy's argsort
        if shape[order[-2]] < min_dim:
            return None
        return order[-2], order[-1]

    @torch.no_grad()
    def step(self, closure=None):
        for group, _name, p in self._leaves():
            g, pj = p.grad, p
            st = self.state[p]
            dims = self._factored_dims(tuple(pj.shape), group["min_dim"])
            if not st:
                st["step"] = 0
                if dims is None:
                    st["v"] = torch.zeros_like(pj)
                else:
                    st["v_row"] = torch.zeros_like(pj.sum(dims[1]))  # axis d0 reduced
                    st["v_col"] = torch.zeros_like(pj.sum(dims[0]))  # axis d1 reduced
            decay = 1.0 - (st["step"] + 1.0) ** (-group["decay_rate"])
            st["step"] += 1
            g_sq = g * g + group["eps"]
            if dims is None:
                st["v"].mul_(decay).add_(g_sq, alpha=1.0 - decay)
                upd = g * st["v"].rsqrt()
            else:
                d1, d0 = dims
                st["v_row"].mul_(decay).add_(g_sq.mean(d0), alpha=1.0 - decay)
                st["v_col"].mul_(decay).add_(g_sq.mean(d1), alpha=1.0 - decay)
                r1 = d1 - 1 if d1 > d0 else d1
                row = (st["v_row"] / st["v_row"].mean(r1, keepdim=True)).rsqrt()
                col = st["v_col"].rsqrt()
                upd = g * row.unsqueeze(d0) * col.unsqueeze(d1)
            upd = upd / torch.clamp(upd.square().mean().sqrt() / group["clip"], min=1.0)
            upd = upd * group["lr"] * torch.clamp(pj.square().mean().sqrt(), min=group["min_scale"])
            p.sub_(upd)


class NovoGrad(_Base):
    def __init__(self, params, lr, betas=(0.9, 0.999), eps=1e-8):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group, _name, p in self._leaves():
            b1, b2 = group["betas"]
            g = self._decayed(group, p)
            st = self.state[p]
            sq = g.square().sum()
            if not st:
                st["nu"] = sq
                st["mu"] = g / (st["nu"].sqrt() + group["eps"])
            else:
                st["nu"] = b2 * st["nu"] + (1 - b2) * sq
                st["mu"] = b1 * st["mu"] + g / (st["nu"].sqrt() + group["eps"])
            p.add_(st["mu"], alpha=-group["lr"])


class RMSprop(_Base):
    def __init__(self, params, lr, decay=0.9, eps=1e-8, momentum=0.9):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps, momentum=momentum))

    @torch.no_grad()
    def step(self, closure=None):
        for group, _name, p in self._leaves():
            g = self._decayed(group, p)
            st = self.state[p]
            if not st:
                st.update(nu=torch.zeros_like(p), trace=torch.zeros_like(p))
            st["nu"].mul_(group["decay"]).addcmul_(g, g, value=1 - group["decay"])
            upd = -group["lr"] * g * (st["nu"] + group["eps"]).rsqrt()
            st["trace"].mul_(group["momentum"]).add_(upd)
            p.add_(st["trace"])


# ------------------------------------------------------------- AdamP and SGDP

_DELTA, _WD_RATIO = 0.1, 0.1   # vlsa_tpu's adamp / sgdp defaults


def _projection(g, p, perturb, eps=1e-8):
    """vlsa_tpu/optim/extra.py::_adamp_projection on tensors in vlsa_tpu's
    layout: the channel view (axis 0) tested first, then the layer view; on
    a hit the perturbation loses its component along the weights and the
    weight decay is scaled by _WD_RATIO.  -> (perturb, ratio)."""
    if p.dim() < 2:
        return perturb, 1.0
    gv, pv = g.reshape(p.shape[0], -1), p.reshape(p.shape[0], -1)
    cos_ch = ((gv * pv).sum(1).abs() / ((gv.norm(dim=1) + eps) * (pv.norm(dim=1) + eps))).max()
    gl, pl = g.reshape(1, -1), p.reshape(1, -1)
    cos_ly = (gl * pl).sum().abs() / ((gl.norm() + eps) * (pl.norm() + eps))
    if cos_ch < _DELTA / math.sqrt(gv.shape[1]):
        pn = pv / (pv.norm(dim=1, keepdim=True) + eps)
        u = perturb.reshape(pv.shape)
        return (u - pn * (pn * u).sum(1, keepdim=True)).reshape(perturb.shape), _WD_RATIO
    if cos_ly < _DELTA / math.sqrt(gl.shape[1]):
        pn = pl / (pl.norm() + eps)
        u = perturb.reshape(1, -1)
        return (u - pn * (pn * u).sum()).reshape(perturb.shape), _WD_RATIO
    return perturb, 1.0


class AdamP(_Base):
    def __init__(self, params, lr, betas=(0.9, 0.999), eps=1e-8):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group, name, p in self._leaves():
            b1, b2 = group["betas"]
            g = p.grad
            st = self.state[p]
            if not st:
                st.update(step=0, mu=torch.zeros_like(p), nu=torch.zeros_like(p))
            st["step"] += 1
            t = st["step"]
            st["mu"].mul_(b1).add_(g, alpha=1 - b1)
            st["nu"].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = st["nu"].sqrt() / math.sqrt(1 - b2 ** t) + group["eps"]
            perturb, ratio = _projection(jax_layout(name, g), jax_layout(name, p),
                                         jax_layout(name, st["mu"] / denom))
            upd = jax_layout(name, perturb) / (1 - b1 ** t)
            wd = group.get("weight_decay", 0.0)
            if wd:
                upd = upd + wd * ratio * p
            p.add_(upd, alpha=-group["lr"])


class SGDP(_Base):
    def __init__(self, params, lr, momentum=0.9, eps=1e-8, nesterov=True):
        super().__init__(params, dict(lr=lr, momentum=momentum, eps=eps, nesterov=nesterov))

    @torch.no_grad()
    def step(self, closure=None):
        for group, name, p in self._leaves():
            mom, g = group["momentum"], p.grad
            st = self.state[p]
            if not st:
                st["buf"] = torch.zeros_like(p)
            st["buf"].mul_(mom).add_(g)
            d_p = g + mom * st["buf"] if group["nesterov"] else st["buf"]
            d_p, ratio = _projection(jax_layout(name, g), jax_layout(name, p),
                                     jax_layout(name, d_p))
            upd = jax_layout(name, d_p)
            wd = group.get("weight_decay", 0.0)
            if wd:
                upd = upd + wd * ratio * p / (1 - mom)
            p.add_(upd, alpha=-group["lr"])


# ----------------------------------------------------------------- AdaHessian

class Adahessian(_Base):
    """Adam with the Hessian diagonal's estimate as its second moment
    (vlsa_tpu/optim/extra.py::scale_by_adahessian after the factory's coupled
    weight decay): `step(hessian={param: diag})`, the estimate of this step
    (`hutchinson_hessian_diag`)."""

    def __init__(self, params, lr, betas=(0.9, 0.999), eps=1e-8):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))

    @torch.no_grad()
    def step(self, closure=None, hessian: Optional[Dict[torch.Tensor, torch.Tensor]] = None):
        if hessian is None:
            raise ValueError("adahessian needs this step's Hessian diagonal "
                             "(optim.extra.hutchinson_hessian_diag)")
        for group, _name, p in self._leaves():
            b1, b2 = group["betas"]
            g = self._decayed(group, p)
            h = hessian[p]
            st = self.state[p]
            if not st:
                st.update(step=0, mu=torch.zeros_like(p), nu=torch.zeros_like(p))
            st["step"] += 1
            t = st["step"]
            st["mu"].mul_(b1).add_(g, alpha=1 - b1)
            st["nu"].mul_(b2).addcmul_(h, h, value=1 - b2)
            den = (st["nu"] / (1 - b2 ** t)).sqrt() + group["eps"]
            p.add_(st["mu"] / (1 - b1 ** t) / den, alpha=-group["lr"])


def _through_a_kernel(grads) -> bool:
    """True if a gradient's graph holds the node a `once_differentiable`
    backward (every kernel's) leaves for create_graph: differentiating it
    would raise, or, where its inputs are not needed, give nothing."""
    stack = [g.grad_fn for g in grads if g is not None and g.grad_fn is not None]
    seen = set()
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        if fn.name() == "torch::autograd::Error":
            return True
        stack.extend(n for n, _i in fn.next_functions)
    return False


def rademacher(p: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """+-1 of p's shape, type and device, each with probability 1/2."""
    z = torch.randint(0, 2, p.shape, generator=generator, device=p.device)
    return (2 * z - 1).to(p.dtype)


def hutchinson_hessian_diag(loss: torch.Tensor, params: Sequence[torch.Tensor],
                            names: Sequence[str], z: Optional[Sequence[torch.Tensor]] = None,
                            generator: Optional[torch.Generator] = None,
                            reduce: Optional[Callable[[List[torch.Tensor]], None]] = None):
    """One-sample Hutchinson estimate z * (H z) of the Hessian diagonal of
    `loss` in `params` (vlsa_tpu/optim/extra.py::hutchinson_hessian_diag):
    H z = d(g . z)/dparams from the gradient g taken with create_graph=True,
    z Rademacher as given (in this package's layouts) or drawn from
    `generator`.  A leaf of >= 2 dimensions gets the
    mean of |z * Hz| over vlsa_tpu's axes 1.. (a Dense weight's torch axis
    0).  A parameter the loss does not reach gets a zero gradient and
    estimate.  `reduce` (a mesh's sums of a rank's shares, in place) takes
    the gradients and then the H z before the estimates are formed.  ->
    (gradients, estimates), detached, in `params`' order.  The
    second derivative runs through every operation of the loss: call it
    inside `ops.flags.disable_kernels()`.  The kernels have none: a gradient
    that went through one raises a RuntimeError here, not a zero estimate."""
    params = list(params)
    grads = torch.autograd.grad(loss, params, create_graph=True, allow_unused=True)
    if _through_a_kernel(grads):
        raise RuntimeError("the gradient went through a kernel with no second derivative "
                           "(a once_differentiable backward), whose H z would be a silent "
                           "zero: estimate the Hessian inside ops.flags.disable_kernels()")
    if z is None:
        z = [rademacher(p, generator) for p in params]
    live = [i for i, g in enumerate(grads) if g is not None and g.requires_grad]
    hz = [None] * len(params)
    if live:
        got = torch.autograd.grad([grads[i] for i in live], [params[i] for i in live],
                                  grad_outputs=[z[i] for i in live], allow_unused=True)
        for i, h in zip(live, got):
            hz[i] = h
    out_g = [torch.zeros_like(p) if g is None else g.detach() for p, g in zip(params, grads)]
    hz = [torch.zeros_like(p) if h is None else h.detach() for p, h in zip(params, hz)]
    if reduce is not None:
        reduce(out_g)
        reduce(hz)
    out_d: List[torch.Tensor] = []
    for name, zi, h in zip(names, z, hz):
        d = zi * h
        if d.dim() >= 2:
            dj = jax_layout(name, d)
            dj = dj.abs().mean(dim=tuple(range(1, dj.dim())), keepdim=True).expand_as(dj)
            d = jax_layout(name, dj).contiguous()
        out_d.append(d)
    return out_g, out_d


# ------------------------------------------------------------------ Lookahead

class Lookahead(torch.optim.Optimizer):
    """vlsa_tpu/optim/extra.py::lookahead over `inner` (timm's `lookahead_`
    names, k = 6 and alpha = 0.5): every k-th step the slow weights move
    alpha of the way to the fast ones and the parameters take them; the first sync sets the slow
    weights to the fast ones.  Shares the inner optimizer's param_groups, so
    a scheduler's learning rate reaches it."""

    def __init__(self, inner: torch.optim.Optimizer):
        if isinstance(inner, Adahessian):
            raise ValueError("lookahead_adahessian: vlsa_tpu cannot run it either (its "
                             "Hessian estimate does not reach the inner optimizer)")
        self.inner, self.k, self.alpha = inner, 6, 0.5
        super().__init__(inner.param_groups, inner.defaults)
        self.param_groups = inner.param_groups
        self._count = 0

    @torch.no_grad()
    def step(self, closure=None):
        self.inner.step()
        self._count += 1
        if self._count % self.k:
            return
        for group in self.param_groups:
            for p in group["params"]:
                st = self.state[p]
                if self._count == self.k or "slow" not in st:
                    st["slow"] = p.detach().clone()
                else:
                    st["slow"].add_(p - st["slow"], alpha=self.alpha)
                    p.copy_(st["slow"])

    def zero_grad(self, set_to_none: bool = True):
        self.inner.zero_grad(set_to_none=set_to_none)

    def state_dict(self):
        return {"lookahead": super().state_dict(), "count": self._count,
                "inner": self.inner.state_dict()}

    def load_state_dict(self, state_dict):
        super().load_state_dict(state_dict["lookahead"])
        self.inner.load_state_dict(state_dict["inner"])
        self.param_groups = self.inner.param_groups
        self._count = state_dict["count"]
