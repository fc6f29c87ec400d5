"""Mixed-precision training policies; the counterpart of
``jimm_tpu/quant/policy.py``.

``bf16``
    The identity policy: no surgery, the model trains as built.
``fp8_hybrid``
    Every eligible ``nn.Linear`` becomes an :class:`Fp8Linear`: forward
    operands quantize to e4m3, gradients to e5m2, through the fp8 matmul of
    ``ops/fp8_matmul.py`` (kernel row 12 on the card). The master weights
    stay the Linear's own ``weight``/``bias`` Parameters, so the optimizer
    never meets fp8; per-tensor scales come from rolling amax histories
    (delayed scaling), kept as buffers. Eligibility is ``quantize_model``'s:
    q/k/v under ``fused_qkv`` stay Linears.
``int8_qk``
    Attention only: every ``Attention`` module, the MAP probe's included,
    switches its ``impl`` to ``"flash_int8"``, the differentiable int8-QK
    flash attention of ``ops/flash_attention_int8.py`` (kernel rows 9 and 10
    on the card). Linears are untouched.

The port's blocks are separate modules, so a policy counts each layer's
module once (151 Linears and 25 attentions in SigLIP-B/16), where the JAX
package counts a stacked role once (19 and 3).
"""

from __future__ import annotations

import torch
from torch import nn

from jimm_tpu_torch.nn.transformer import Attention
from jimm_tpu_torch.parallel import comm
from jimm_tpu_torch.ops.fp8_matmul import (E4M3, delayed_scale, fp8_matmul,
                                           tensor_amax, update_amax_history)
from jimm_tpu_torch.quant import swap_linears

__all__ = ["POLICIES", "DEFAULT_AMAX_HISTORY", "Fp8Linear", "fp8_linear",
           "apply_precision_policy", "sync_amax_histories"]

POLICIES = ("bf16", "fp8_hybrid", "int8_qk")

#: steps of amax history kept per tensor for delayed scaling (the JAX
#: package's default, the one value its callers use)
DEFAULT_AMAX_HISTORY = 16
#: :func:`sync_amax_histories`' all-reduces since last set to 0
amax_syncs = 0


class Fp8Linear(nn.Module):
    """An ``nn.Linear`` replacement that matmuls in fp8 but owns no fp8
    weights.

    ``weight`` (``(out, in)``) and ``bias`` are the replaced Linear's own
    Parameter objects, updated by the optimizer as before. ``x_amax`` and
    ``w_amax`` are ``(DEFAULT_AMAX_HISTORY,)`` f32 buffers: rolling amax
    histories from which the delayed e4m3 scales of the input and the
    weight come. The forward takes both scales from the histories as they
    stand, runs the fp8 matmul (e5m2 gradients at a dynamic scale in the
    backward), then rolls both histories with this call's amax of the input
    and the weight, in training and in eval mode alike (the JAX module makes
    no distinction). The output comes back in the weight's dtype.

    On a mesh ``amax_group`` is set (``parallel.sharding.shard_model``: the
    ranks of every mesh axis but ``stage``), and every amax a scale reads is
    the max over the group, as JAX's amax of a global array is the max over
    its shards: the input split over the batch, sequence and, for a
    row-parallel product, ``model`` axes; a weight sliced over ``model``;
    the gradient split like the output. The backward reduces its gradient's
    amax where it takes it. The forward keeps its observations of x and the
    weight as the step's running max (over every call: a pipelined block
    runs once a microbatch) until :func:`sync_amax_histories` reduces all
    of them in one all-reduce and rolls each history once
    (``sharding.finish_gradients`` calls it after the backward): the
    histories, and so the scales, are the same on every rank."""

    #: the ranks each amax is the max over (None: no mesh)
    amax_group: comm.AxisGroup | None = None
    #: a projection's or classifier's ``model`` group (``gathered_linear``)
    tp: comm.AxisGroup | None = None

    def __init__(self, weight: nn.Parameter, bias: nn.Parameter | None):
        super().__init__()
        self.weight = weight
        self.bias = bias
        for name in ("x_amax", "w_amax"):
            self.register_buffer(name, torch.zeros(
                DEFAULT_AMAX_HISTORY, dtype=torch.float32,
                device=weight.device))
        #: this step's (x, weight) amax on this rank, on a mesh
        self.seen: torch.Tensor | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._matmul(x, None)

    def row_parallel(self, x: torch.Tensor, grp: comm.AxisGroup
                     ) -> torch.Tensor:
        """A row-parallel product on a ``model`` axis (``x`` and ``weight``
        this rank's slices of the input features): the fp8 GEMM's partial
        products in f32, summed over ``grp``, then scaled, the bias added
        once and rounded once, as ``comm.tp_row_linear`` sums a Linear's."""
        return self._matmul(x, grp)

    def _matmul(self, x: torch.Tensor, sum_group) -> torch.Tensor:
        x_scale = delayed_scale(self.x_amax, E4M3)
        w_scale = delayed_scale(self.w_amax, E4M3)
        lead = x.shape[:-1]
        y = fp8_matmul(x.reshape(-1, x.shape[-1]), self.weight, self.bias,
                       x_scale=x_scale, w_scale=w_scale,
                       amax_group=self.amax_group, sum_group=sum_group)
        self._observe(x)
        return y.reshape(*lead, self.weight.shape[0]).to(self.weight.dtype)

    @torch.no_grad()
    def _observe(self, x: torch.Tensor) -> None:
        x_amax, w_amax = tensor_amax(x), tensor_amax(self.weight)
        if self.amax_group is None:
            self.x_amax.copy_(update_amax_history(self.x_amax, x_amax))
            self.w_amax.copy_(update_amax_history(self.w_amax, w_amax))
            return
        seen = torch.stack([x_amax, w_amax])
        self.seen = seen if self.seen is None else torch.maximum(self.seen,
                                                                 seen)


@torch.no_grad()
def sync_amax_histories(model: nn.Module) -> int:
    """Roll the histories of every :class:`Fp8Linear` of ``model`` that ran
    on a mesh since the last call, each once, with its observations' max
    over its ``amax_group`` (one all-reduce for the model; its modules
    share the group). Returns the modules rolled."""
    global amax_syncs
    mods = [m for m in model.modules()
            if isinstance(m, Fp8Linear) and m.seen is not None]
    if not mods:
        return 0
    seen = torch.stack([m.seen for m in mods])
    comm.all_reduce_max_(seen, mods[0].amax_group)
    amax_syncs += 1
    for m, (x_amax, w_amax) in zip(mods, seen):
        m.x_amax.copy_(update_amax_history(m.x_amax, x_amax))
        m.w_amax.copy_(update_amax_history(m.w_amax, w_amax))
        m.seen = None
    return len(mods)


def fp8_linear(lin: nn.Linear) -> Fp8Linear:
    """Wrap one Linear for fp8 training, sharing its ``weight`` and ``bias``
    Parameters (no copy); only the amax histories are new state."""
    return Fp8Linear(lin.weight, lin.bias)


def apply_precision_policy(model: nn.Module, policy: str) -> int:
    """Rewrite ``model`` in place for the named precision policy. Returns the
    number of modules rewritten (0 for ``bf16``); an unknown policy raises
    ``ValueError`` before any surgery. Apply it before the optimizer is
    built, as the JAX train command does."""
    if policy not in POLICIES:
        raise ValueError(f"unknown precision policy {policy!r}; expected one "
                         f"of {', '.join(POLICIES)}")
    if policy == "bf16":
        return 0
    if policy == "fp8_hybrid":
        return swap_linears(model, fp8_linear)
    count = 0
    for module in model.modules():
        if isinstance(module, Attention):
            module.impl = "flash_int8"
            count += 1
    return count
