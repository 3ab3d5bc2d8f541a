"""The per-call switch off the hand-written kernels (counterpart of
vlsa_tpu/ops/flags.py).

`disable_kernels()` scopes the kernel entry points -- `abmil.abmil_pool`,
`coattn.coattn_pool`, `flash_attn.flash_self_attention` -- to their plain
PyTorch versions for whatever runs inside the `with` block, on the tensors'
own device: a CUDA tensor then takes the plain version on the card, never a
copy on the CPU.  The user is the adahessian train step: its Hutchinson
estimate differentiates twice (`torch.autograd.grad(..., create_graph=True)`),
and the kernels' `autograd.Function`s have no double backward (they are
`once_differentiable`, so outside the switch a second backward through them
raises).  Everything else in the process -- the evaluation pass after that
step, serving, extraction -- keeps the kernels.

It is a scope only: no environment variable turns the kernels off for a
whole process.  The blocks nest; the kernels come back when the outermost
one exits.  The scope is the calling thread's (a context variable): a
batch-building or serving thread keeps the kernels.
"""
from __future__ import annotations

import contextvars
from contextlib import contextmanager

_DEPTH = contextvars.ContextVar("kernels_disabled_depth", default=0)


@contextmanager
def disable_kernels():
    """Route the kernel entry points to their plain versions within the
    block (nesting)."""
    token = _DEPTH.set(_DEPTH.get() + 1)
    try:
        yield
    finally:
        _DEPTH.reset(token)


def kernels_disabled() -> bool:
    """True inside a `disable_kernels()` block of this thread."""
    return _DEPTH.get() > 0
