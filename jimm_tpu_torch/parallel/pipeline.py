"""Pipeline parallelism: an encoder's blocks split over the ``stage`` mesh
axis, microbatches passed stage to stage, in JAX's GPipe or interleaved
(circular placement) schedule; the counterpart of
``jimm_tpu/parallel/pipeline.py``.

Schedules (``n_virtual = V``, ``S`` stages, ``M`` microbatches):

- ``V = 1`` (GPipe fill-and-drain): stage ``d`` holds layers
  ``[d*L/S, (d+1)*L/S)``; ``T = M + S - 1`` ticks; bubble ``(S-1)/T``.
- ``V > 1`` (interleaved, circular placement): stage ``d`` holds the ``V``
  non-contiguous chunks ``{v*S + d}`` and each microbatch makes ``V`` laps
  around the ring. Needs ``M % S == 0``.

Scheduling identity: microbatch ``m = g*S + r`` is processed by stage ``d``
on lap ``v`` at tick ``t = g*V*S + v*S + r + d``; given ``(t, d)`` the
base-S / base-V decomposition of ``t - d`` recovers ``(g, v, r)``.

JAX runs the schedule as one ``lax.scan`` and differentiates through it.
The port runs it as a Python loop inside one ``torch.autograd.Function``
whose backward walks the ticks in reverse: autograd through the hops
would run a hop's backward only on the ranks whose copy of it reached the
loss, and a collective that some ranks skip hangs the others. Here every
stage rank issues the same collectives in the same order, bubbles
included: one ``comm.ppermute`` per tick each way (an
``all_to_all_single``: gloo carries no ``send``/``recv`` on the card), the
output's sum over the stages in the forward and the input gradient's in the
backward. A bubble tick computes nothing and sends zeros (JAX computes on
whatever is in the ring and never collects it; the results are the
same). Each real tick's blocks run once, under autograd, and keep their
graph to the backward (remat inside a block works as it does unpipelined).

Gradients: the output is the last stage's, summed to every stage (JAX's
``psum`` of the masked accumulator); every stage computes the same loss
from it, so the backward takes the loss's gradient once, on the last stage.
The input reaches the blocks only on stage 0 (its injection), so its
gradient is summed over the stages: every stage then holds the whole
gradient of what feeds the pipeline (the embeddings), as the transpose of
JAX's ``shard_map`` gives it, and no parameter gradient needs a reduction
over ``stage``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from jimm_tpu_torch.configs import check_pp_schedule
from jimm_tpu_torch.parallel import comm

__all__ = ["circular_layer_order", "held_layers", "num_ticks",
           "pipeline_forward", "tick_work"]


def circular_layer_order(n_layers: int, n_stages: int, n_virtual: int
                         ) -> np.ndarray:
    """JAX's storage order of a circularly placed stack: row ``j`` of a
    JAX model built with ``pp_virtual > 1`` and ``pp_stages`` holds layer
    ``order[j]``; stage ``d``'s contiguous rows are the global chunks
    ``{v*n_stages + d}``."""
    if n_layers % (n_stages * n_virtual):
        raise ValueError(f"{n_layers} layers not divisible by "
                         f"{n_stages} stages x {n_virtual} virtual chunks")
    chunk = n_layers // (n_stages * n_virtual)
    idx = []
    for d in range(n_stages):
        for v in range(n_virtual):
            block = v * n_stages + d
            idx.extend(range(block * chunk, (block + 1) * chunk))
    return np.asarray(idx)


def held_layers(n_layers: int, n_stages: int, n_virtual: int,
                stage: int) -> list[list[int]]:
    """The layers stage ``stage`` holds, by virtual chunk: chunk ``v`` is
    global chunk ``v*n_stages + stage``, layers in order."""
    order = circular_layer_order(n_layers, n_stages, n_virtual)
    chunk = n_layers // (n_stages * n_virtual)
    mine = order[stage * n_virtual * chunk:(stage + 1) * n_virtual * chunk]
    return [mine[v * chunk:(v + 1) * chunk].tolist()
            for v in range(n_virtual)]


def num_ticks(n_microbatches: int, n_stages: int, n_virtual: int = 1) -> int:
    """Schedule length in ticks."""
    m, s, v = n_microbatches, n_stages, n_virtual
    if v == 1:
        return m + s - 1
    return (m // s - 1) * v * s + (v + 1) * s - 1


def tick_work(t: int, stage: int, n_microbatches: int, n_stages: int,
              n_virtual: int) -> tuple[int, int] | None:
    """``(microbatch, lap)`` stage ``stage`` works on at tick ``t``, or
    None for a bubble."""
    td = t - stage
    if td < 0:
        return None
    q, r = divmod(td, n_stages)
    g, v = divmod(q, n_virtual)
    m = g * n_stages + r
    return None if m >= n_microbatches else (m, v)


def _hop(x: torch.Tensor, grp: comm.AxisGroup, shift: int) -> torch.Tensor:
    return comm._ppermute(x, grp, comm.ring_perm(grp.size, shift))


def _stage_sum(x: torch.Tensor, grp: comm.AxisGroup) -> torch.Tensor:
    if grp.pg is not None:
        dist.all_reduce(x, group=grp.pg)
    return x


def _schedule(x: torch.Tensor, stage_apply, grp: comm.AxisGroup,
              n_micro: int, n_virtual: int, keep: bool):
    """The forward ticks: the result on every stage rank and, with
    ``keep``, each real tick's ``(t, m, v, inject, input, output)`` with
    its graph."""
    s, d = grp.size, grp.index
    micro = x.reshape(n_micro, x.shape[0] // n_micro, *x.shape[1:])
    acc = torch.zeros_like(micro)
    ring = torch.zeros_like(micro[0])
    ticks = []
    for t in range(num_ticks(n_micro, s, n_virtual)):
        work = tick_work(t, d, n_micro, s, n_virtual)
        out = None
        if work is not None:
            m, v = work
            inject = d == 0 and v == 0
            inp = micro[m] if inject else ring
            if keep:
                inp = inp.detach().requires_grad_()
                with torch.enable_grad():
                    out = stage_apply(v, inp)
                ticks.append((t, m, v, inject, inp, out))
            else:
                out = stage_apply(v, inp)
            if d == s - 1 and v == n_virtual - 1:
                acc[m] = out.detach()
        ring = _hop(torch.zeros_like(ring) if out is None else out.detach(),
                    grp, 1)
    return _stage_sum(acc, grp).reshape(x.shape), ticks


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, stage_apply, grp, n_micro, n_virtual, *params):
        out, ctx.ticks = _schedule(x, stage_apply, grp, n_micro, n_virtual,
                                   keep=True)
        ctx.grp, ctx.n_micro, ctx.n_virtual = grp, n_micro, n_virtual
        ctx.n_params = len(params)
        return out

    @staticmethod
    def backward(ctx, dy):
        grp, n_micro, n_virtual = ctx.grp, ctx.n_micro, ctx.n_virtual
        s, d = grp.size, grp.index
        dy = dy.reshape(n_micro, dy.shape[0] // n_micro, *dy.shape[1:])
        dmicro = torch.zeros_like(dy)
        by_tick = {t: rest for t, *rest in ctx.ticks}
        ctx.ticks = None
        # the gradient of what this rank received at the end of tick t
        g_recv = torch.zeros_like(dy[0])
        for t in reversed(range(num_ticks(n_micro, s, n_virtual))):
            g_out = _hop(g_recv, grp, -1)
            g_recv = torch.zeros_like(g_recv)
            if t not in by_tick:
                continue
            m, v, inject, inp, out = by_tick.pop(t)
            if d == s - 1 and v == n_virtual - 1:
                # the loss's gradient, taken once: on the last stage
                g_out = g_out + dy[m]
            # the blocks' parameter gradients accumulate here
            torch.autograd.backward(out, g_out)
            if inject:
                dmicro[m] = inp.grad
            else:
                g_recv = inp.grad
        # the input fed the blocks on stage 0 alone
        dx = _stage_sum(dmicro, grp).reshape(-1, *dmicro.shape[2:])
        return (dx, None, None, None, None) + (None,) * ctx.n_params


def pipeline_forward(stage_apply: Callable[[int, torch.Tensor], torch.Tensor],
                     x: torch.Tensor, *, n_microbatches: int,
                     n_virtual: int = 1,
                     axis: str | comm.AxisGroup = "stage",
                     params=()) -> torch.Tensor:
    """Run this rank's ``(B, ...)`` activations ``x`` through a stack of
    blocks pipelined over ``axis`` (a name: of the ambient mesh).

    - ``stage_apply(v, xm)``: this stage's virtual chunk ``v`` applied to a
      microbatch.
    - ``x``: the same on every stage rank (stage 0 injects it); ``B`` must
      divide by ``n_microbatches``. The result is the last stage's, on
      every stage rank.
    - ``params``: the parameters ``stage_apply`` reads, passed so that
      autograd calls the backward when only they need a gradient.

    Differentiable (see the module docstring). Without autograd the same
    schedule runs and keeps no graph."""
    grp = comm.axis_group(axis)
    check_pp_schedule(n_microbatches, n_virtual, n_stages=grp.size,
                      local_batch=x.shape[0])
    if torch.is_grad_enabled():
        return _Pipeline.apply(x, stage_apply, grp, n_microbatches,
                               n_virtual, *params)
    return _schedule(x, stage_apply, grp, n_microbatches, n_virtual,
                     keep=False)[0]
