"""Dropout and per-block activation rematerialisation; the counterpart of
``nnx.Dropout`` and of ``jimm_tpu/nn/transformer.py``'s ``nnx.remat`` over
the layer scan with its save sets (``_remat_policy``).

A block runs under ``torch.utils.checkpoint.checkpoint(...,
use_reentrant=False)``: its activations are dropped after the forward and
recomputed in the backward. The remat policy picks what survives:

- ``"none"`` (``remat=True``, ``--remat full``): nothing; the backward
  recomputes the whole block.
- ``"dots"``: the outputs of matmuls without batch dims (``aten.mm`` and
  ``aten.addmm``: the Linears, not the batched attention einsums) and the
  flash kernels' o and lse (the ``jimm::*_fwd`` ops of
  `jimm_tpu_torch/ops/library.py`), through a selective-checkpoint
  context; but not the two projections that close the residual branches
  (the attention's ``out`` and ``fc2``, run inside
  ``checkpoint_name("branch_out")``). XLA keeps only the residuals the
  backward reads; eager checkpointing keeps every output a policy names.
  No backward reads fc2's output, and the recompute stops before it; the
  attention projection's feeds the residual sum that the second
  LayerNorm's backward reads, so the recompute reruns that one matmul
  instead of holding a token-width tensor a block.
- ``"+ln"``, ``"+act"``, ``"+attn"``: also every op run inside
  ``checkpoint_name("ln_out")`` (the blocks' LayerNorms),
  ``("act_out")`` (the MLP activation) or ``("attn_probs")`` (the
  ``"saveable"`` attention's probabilities); ``"+attn"`` needs
  ``attn_impl="saveable"`` and raises JAX's ``ValueError`` otherwise.

Eager recomputation replays the block's ops in order and takes a saved
op's outputs from the cache instead of running it, so saving an op skips
that op; ops that only feed saved ones still run.

State that a block's forward mutates changes once a step, as under
``nnx.remat``, whose recompute discards it: the recompute starts from the
dropout generator's state and the block's buffers (the fp8 amax
histories) as they were before the forward, and puts the live ones back
afterwards (:class:`_Replay`).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Iterator

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from jimm_tpu_torch.configs import TransformerConfig, remat_policy_parts
from jimm_tpu_torch.ops import flash_attention as fa
from jimm_tpu_torch.ops import flash_attention_int8 as fa8
from jimm_tpu_torch.ops.library import current_name
from jimm_tpu_torch.parallel.sharding import (sequence_sharded,
                                              sharded_sequence_axis)

#: outputs kept by every "dots" policy: matmuls without batch dims, and
#: the flash kernels' o and lse (JAX's ``flash_o`` / ``flash_lse``)
DOTS_OPS = frozenset({
    torch.ops.aten.mm.default, torch.ops.aten.addmm.default, fa.fwd_op,
    fa.sigmoid_fwd_op, fa8.fwd_op})
#: the block that no save set keeps: the projections closing the residual
#: branches
RECOMPUTED_NAME = "branch_out"


class Dropout(nn.Module):
    """Inverted dropout, as ``nnx.Dropout``: where kept, ``x / (1 - rate)``;
    the identity at rate 0 and in ``eval()``; zeros at rate 1. The masks
    come from a ``torch.Generator`` of its own, seeded by :meth:`seed_` from
    the model constructor's generator (never the global RNG), made on the
    input's device at the first draw."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.seed = 0
        self._generator: torch.Generator | None = None

    @property
    def active(self) -> bool:
        """Whether a forward draws a mask."""
        return self.training and 0.0 < self.rate < 1.0

    def seed_(self, generator: torch.Generator) -> None:
        """Seed the mask stream from ``generator`` (one draw)."""
        self.seed = int(torch.randint(2**62, (), generator=generator,
                                      device=generator.device))
        self._generator = None

    def generator(self, device: torch.device) -> torch.Generator:
        """The mask stream on ``device``."""
        g = self._generator
        if g is None or g.device != torch.device(device):
            g = torch.Generator(device=device).manual_seed(self.seed)
            self._generator = g
        return g

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        keep = 1.0 - self.rate
        u = torch.rand(x.shape, generator=self.generator(x.device),
                       device=x.device)
        return torch.where(u < keep, x / keep, 0.0)

    def extra_repr(self) -> str:
        return f"rate={self.rate}"


def saved_names(cfg: TransformerConfig) -> frozenset[str] | None:
    """The ``checkpoint_name`` blocks that ``cfg.remat_policy`` keeps, None
    for ``"none"`` (full recompute). Raises JAX's ``ValueError`` for a
    malformed policy, and for ``"+attn"`` unless ``attn_impl ==
    "saveable"`` (no other impl names its probabilities)."""
    policy = cfg.remat_policy
    if policy == "none":
        return None
    parts = remat_policy_parts(policy)
    names = set()
    if "ln" in parts:
        names.add("ln_out")
    if "act" in parts:
        names.add("act_out")
    if "attn" in parts:
        if cfg.attn_impl != "saveable":
            raise ValueError(
                f"remat_policy {policy!r} saves attention probabilities, "
                f"but attn_impl={cfg.attn_impl!r} never emits them; "
                "use attn_impl='saveable'")
        names.add("attn_probs")
    return frozenset(names)


class SavePolicy:
    """The selective-checkpoint policy of a "dots" save set: keep
    :data:`DOTS_OPS` outside :data:`RECOMPUTED_NAME`, and every op but
    views inside a ``checkpoint_name`` in ``names``; recompute the rest."""

    def __init__(self, names: frozenset[str]):
        self.names = names

    def __call__(self, ctx, op, *args, **kwargs) -> CheckpointPolicy:
        name = current_name()
        if name == RECOMPUTED_NAME:
            return CheckpointPolicy.PREFER_RECOMPUTE
        if op in DOTS_OPS or (not op.is_view and name in self.names):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE


def context_fn(cfg: TransformerConfig) -> Callable | None:
    """The checkpoint ``context_fn`` of ``cfg.remat_policy`` (a fresh pair
    of selective-checkpoint contexts per call), None for ``"none"``."""
    names = saved_names(cfg)
    if names is None:
        return None
    return functools.partial(create_selective_checkpoint_contexts,
                             SavePolicy(names))


class _Replay:
    """What one forward of ``block`` mutates, as it was before it: the
    state of each active dropout generator and a copy of each buffer. The
    first run (the forward) leaves them be; a second (the recompute) runs
    from them and puts the live state back after."""

    def __init__(self, block: nn.Module, device: torch.device):
        self.first = True
        self.generators = [m.generator(device) for m in block.modules()
                           if isinstance(m, Dropout) and m.active]
        self.states = [g.get_state() for g in self.generators]
        self.buffers = [(m, name, buf.clone())
                        for m in block.modules()
                        for name, buf in m._buffers.items()
                        if buf is not None]

    @contextlib.contextmanager
    def __call__(self) -> Iterator[None]:
        if self.first:
            self.first = False
            yield
            return
        # buffers swap by attribute, not by copy: an op here would run
        # under the recompute's dispatch mode and upset its op counts
        live_states = [g.get_state() for g in self.generators]
        live_buffers = [m._buffers[name] for m, name, _ in self.buffers]
        for g, state in zip(self.generators, self.states):
            g.set_state(state)
        for m, name, before in self.buffers:
            m._buffers[name] = before
        try:
            yield
        finally:
            for g, state in zip(self.generators, live_states):
                g.set_state(state)
            for (m, name, _), live in zip(self.buffers, live_buffers):
                m._buffers[name] = live


def checkpoint_block(block: nn.Module, x: torch.Tensor,
                     mask: torch.Tensor | None,
                     context: Callable | None) -> torch.Tensor:
    """``block(x, mask=mask)`` with its activations recomputed in the
    backward, keeping what ``context`` (:func:`context_fn`) saves."""
    replay = _Replay(block, x.device)
    # the recompute runs in the backward, outside the tower's context: it
    # re-enters the sequence sharding the forward ran under
    seq = sharded_sequence_axis()

    def run(x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
        with replay(), sequence_sharded(seq):
            return block(x, mask=mask)

    extra = {} if context is None else {"context_fn": context}
    return checkpoint(run, x, mask, use_reentrant=False,
                      preserve_rng_state=False, **extra)
