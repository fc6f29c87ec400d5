"""The kernel wrappers' forwards as dispatcher ops, ``torch.ops.jimm.*``.

A kernel launches through ``ctypes``, which the dispatcher never sees: a
``TorchDispatchMode``, such as the selective-checkpoint contexts of
``torch.utils.checkpoint``, sees only the ``aten.empty`` buffers that the
launch fills afterwards. Each forward a remat policy may keep (the
LayerNorm's y, mean and rstd; the flash kernels' o and lse) is therefore
registered here as one op of the ``jimm`` library, with one
``CompositeExplicitAutograd`` kernel for every device: the wrapper itself,
which launches the kernel on a CUDA tensor and runs the plain version on a
CPU one. A policy that saves the op's outputs skips the wrapper, and so the
launch, when the block is recomputed (``nn/remat.py``). The autograd
Functions call the op inside their forward, where autograd is off.

:func:`checkpoint_name` is the counterpart of JAX's ``checkpoint_name``: it
names the ops that run inside it, and a policy that saves the name keeps
their outputs.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Iterator

import torch

_scope = threading.local()


@contextlib.contextmanager
def checkpoint_name(name: str) -> Iterator[None]:
    """Name the ops run inside the block ``name`` (``ln_out``, ``act_out``,
    ``attn_probs``): a remat policy that saves the name keeps every output
    of them but views, so that the recompute skips them; no policy keeps
    those of ``branch_out``. Without a remat policy it changes nothing. The name lives per thread: autograd runs a
    recompute in its own thread, inside the same block."""
    outer = getattr(_scope, "name", None)
    _scope.name = name
    try:
        yield
    finally:
        _scope.name = outer


def current_name() -> str | None:
    """The innermost :func:`checkpoint_name` of this thread, or None."""
    return getattr(_scope, "name", None)


_LIB = torch.library.Library("jimm", "DEF")


def define_op(schema: str, impl: Callable) -> torch._ops.OpOverload:
    """Define ``jimm::<schema>`` with ``impl`` as its kernel on every
    device; returns the op. ``impl`` should look its wrapper up when called
    (a module global), so that patching the wrapper patches the op."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    _LIB.impl(name, impl, "CompositeExplicitAutograd")
    return getattr(torch.ops.jimm, name).default
