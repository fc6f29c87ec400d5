"""Serve forwards as ``torch.export`` programs; the counterpart of
``jimm_tpu/aot/export.py``'s ``serialize_serve_forward`` and
``load_serve_forward`` (here :func:`serialize_serve_forward` and
:func:`load_program`).

What an artifact holds: ``torch.export.export`` of ``model.<method>`` at
one padded input shape, saved with ``torch.export.save``, with the model's
parameters and buffers as call arguments, not state in the program. The
payload therefore holds no weights and fits any checkpoint of the same
architecture: on load the live model's tensors are passed in at every call.
The example inputs the exporter keeps are dropped before saving, and so are
its ``aten._assert_tensor_metadata`` checks, which record the device the
program was exported on; :func:`load_program` moves what device the graph
still names (a tensor made inside the forward) to the live model's.

What an artifact is not: not AOTInductor, not ``torch.compile``, not a CUDA
graph. The graph names the ``torch.ops.jimm.*`` ops (`ops/library.py`: the
LayerNorm, flash-attention and int8-matmul forwards, and the in-process
collectives of a wide replica), so the loaded program launches the same
hand-written kernels as the model's own forward; each op's fake is what the
exporter ran while tracing.

What the JAX module also does and this one does not: JAX's persistent
compilation cache (``enable_persistent_cache``) is XLA's; nothing compiles
in eager torch.
"""

from __future__ import annotations

import hashlib
import io
import threading
from collections import OrderedDict
from typing import Any, Callable, Sequence

import torch
from torch import nn
from torch.export.passes import move_to_device_pass
from torch.func import functional_call

__all__ = ["export_program", "load_program", "model_state",
           "save_program", "serialize_serve_forward"]


def model_state(model: nn.Module) -> dict[str, torch.Tensor]:
    """The model's parameters and buffers by name (sorted): the call
    arguments of its exported programs."""
    state = {name: p.detach() for name, p in model.named_parameters()}
    state.update(dict(model.named_buffers()))
    return {name: state[name] for name in sorted(state)}


class _Program(nn.Module):
    """``model.<method>(*args)`` with ``state`` swapped in for the model's
    tensors. The model is held outside the module's attributes, so that
    none of its tensors is state of the exported program."""

    def __init__(self, model: nn.Module, method: str):
        super().__init__()
        self.__dict__["_entry"] = _Entry(model, method)

    def forward(self, state: dict, *args):
        entry = self.__dict__["_entry"]
        return functional_call(
            entry, {f"model.{k}": v for k, v in state.items()}, args,
            strict=True)


class _Entry(nn.Module):
    def __init__(self, model: nn.Module, method: str):
        super().__init__()
        self.model = model
        self.method = method

    def forward(self, *args):
        fn = (self.model if self.method == "forward"
              else getattr(self.model, self.method))
        return fn(*args)


def _strip_device_asserts(ep: torch.export.ExportedProgram) -> None:
    """Erase the exporter's ``aten._assert_tensor_metadata`` nodes (dtype
    and device checks of ``.to`` calls, none of which has a user)."""
    graph = ep.graph_module.graph
    for node in list(graph.nodes):
        if (node.op == "call_function"
                and node.target is torch.ops.aten._assert_tensor_metadata
                .default and not node.users):
            graph.erase_node(node)
    ep.graph_module.recompile()


def export_program(model: nn.Module, method: str,
                   args: Sequence[torch.Tensor]
                   ) -> torch.export.ExportedProgram:
    """``model.<method>(*args)`` exported with the model's tensors as the
    first call argument (a dict, :func:`model_state`'s). Exported outside
    inference mode (its tensors cannot be traced), under ``no_grad``."""
    with torch.no_grad():
        ep = torch.export.export(_Program(model, method),
                                 (model_state(model), *args))
    _strip_device_asserts(ep)
    ep.example_inputs = None
    return ep


def save_program(ep: torch.export.ExportedProgram) -> bytes:
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def serialize_serve_forward(model: nn.Module, method: str, batch: int,
                            item_shape: Sequence[int]) -> bytes:
    """The artifact bytes of ``model.<method>`` over one padded bucket: a
    ``(batch, *item_shape)`` batch in the model's dtype on its device, as
    ``serve.engine.image_forward`` hands it over."""
    param = next(model.parameters())
    x = torch.zeros((int(batch), *item_shape), dtype=param.dtype,
                    device=param.device)
    return save_program(export_program(model, method, (x,)))


def _check_inputs(ep: torch.export.ExportedProgram,
                  state: dict[str, torch.Tensor]) -> None:
    """Raise ``ValueError`` unless the program's state arguments are the
    live model's, name for name, in shape and dtype."""
    specs = [s for s in ep.graph_signature.input_specs
             if s.kind == torch.export.graph_signature.InputKind.USER_INPUT]
    nodes = {n.name: n for n in ep.graph.nodes if n.op == "placeholder"}
    vals = [nodes[s.arg.name].meta.get("val") for s in specs]
    if len(vals) < len(state):
        raise ValueError(f"artifact takes {len(vals)} inputs, the live model "
                         f"has {len(state)} tensors: architecture drift")
    for (name, t), val in zip(state.items(), vals):
        if val is None or tuple(val.shape) != tuple(t.shape) \
                or val.dtype != t.dtype:
            raise ValueError(
                f"artifact input for {name} is "
                f"{None if val is None else (tuple(val.shape), val.dtype)}, "
                f"the live tensor {(tuple(t.shape), t.dtype)}: architecture "
                f"drift")


#: programs this process has loaded, by payload digest and device, newest
#: last: deserializing one costs about a second of host time, and a replan
#: or a second model of one architecture loads the same programs again
_LOADED: OrderedDict[tuple[str, str], torch.export.ExportedProgram] = \
    OrderedDict()
_LOADED_MAX = 64
_LOADED_LOCK = threading.Lock()


def _deserialize(payload: bytes, device: torch.device
                 ) -> torch.export.ExportedProgram:
    key = (hashlib.sha256(payload).hexdigest(), str(device))
    with _LOADED_LOCK:
        ep = _LOADED.get(key)
        if ep is not None:
            _LOADED.move_to_end(key)
            return ep
    ep = move_to_device_pass(torch.export.load(io.BytesIO(payload)), device)
    with _LOADED_LOCK:
        _LOADED[key] = ep
        while len(_LOADED) > _LOADED_MAX:
            _LOADED.popitem(last=False)
    return ep


def load_program(payload: bytes, model: nn.Module
                 ) -> Callable[..., Any]:
    """An artifact loaded against a live model: a callable over the
    method's remaining arguments, each call passing the model's tensors.
    Raises on any incompatibility (arity, shape or dtype drift, an unknown
    op): the caller then runs the model's own forward instead. A program
    this process already loaded for the device is not deserialized
    again."""
    ep = _deserialize(payload, next(model.parameters()).device)
    state = model_state(model)
    _check_inputs(ep, state)
    module = ep.module()

    def program(*args):
        return module(state, *args)

    return program
