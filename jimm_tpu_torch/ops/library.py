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

Each op also has a fake (``torch.library.register_fake``): the output
shapes, dtypes and device from the inputs' alone, which is what
``torch.export`` runs while it traces (`jimm_tpu_torch/aot/export.py`).
A fake never launches and never returns data; without one the tracer would
run the wrapper on tensors without storage. :func:`schemas_hash` digests
every op's schema, so that an AOT artifact that names a changed op is a
miss, not a crash.

:func:`checkpoint_name` is the counterpart of JAX's ``checkpoint_name``: it
names the ops that run inside it, and a policy that saves the name keeps
their outputs.
"""

from __future__ import annotations

import contextlib
import hashlib
import threading
from typing import Callable, Iterator

import torch
from torch._guards import detect_fake_mode

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
#: every schema :func:`define_op` was given, by op name
SCHEMAS: dict[str, str] = {}
#: the modules that define ``jimm::`` ops (:func:`schemas_hash` imports them)
OP_MODULES = ("jimm_tpu_torch.ops.layer_norm",
              "jimm_tpu_torch.ops.flash_attention",
              "jimm_tpu_torch.ops.flash_attention_int8",
              "jimm_tpu_torch.ops.int8_matmul",
              "jimm_tpu_torch.parallel.comm")


def _traced_only(name: str, fake: Callable) -> Callable:
    """``fake`` for a tracer's fake tensors only. The dispatcher also sends
    plain ``meta`` tensors to a fake; they are neither on the card nor on
    the CPU, so the op refuses them as its wrapper refuses any other
    device."""
    def run(*args, **kwargs):
        if detect_fake_mode((*args, *kwargs.values())) is None:
            devices = sorted({a.device.type for a in (*args, *kwargs.values())
                              if isinstance(a, torch.Tensor)})
            raise ValueError(f"jimm::{name} runs on CUDA or CPU tensors, "
                             f"not {', '.join(devices)}")
        return fake(*args, **kwargs)
    return run


def define_op(schema: str, impl: Callable,
              fake: Callable) -> torch._ops.OpOverload:
    """Define ``jimm::<schema>`` with ``impl`` as its kernel on every
    device and ``fake`` as its fake; returns the op. ``impl`` should look
    its wrapper up when called (a module global), so that patching the
    wrapper patches the op."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    _LIB.impl(name, impl, "CompositeExplicitAutograd")
    torch.library.register_fake(f"jimm::{name}", _traced_only(name, fake),
                                lib=_LIB)
    SCHEMAS[name] = schema
    return getattr(torch.ops.jimm, name).default


def schemas_hash() -> str:
    """SHA-256 over every ``jimm::`` op's schema, sorted by name (the op
    modules imported first, so that the digest does not depend on what the
    caller happened to import)."""
    import importlib
    for module in OP_MODULES:
        importlib.import_module(module)
    text = "\n".join(SCHEMAS[n] for n in sorted(SCHEMAS))
    return hashlib.sha256(text.encode()).hexdigest()


def stats_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype the plain versions keep statistics in (mean, rstd, lse):
    f64 for f64 input, else f32; the fakes' answer too."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32
