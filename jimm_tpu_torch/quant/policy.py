"""Mixed-precision training policies; the counterpart of
``jimm_tpu/quant/policy.py``.

``bf16``
    The identity policy: no surgery, the model trains as built.
``int8_qk``
    Attention only: every ``Attention`` module, the MAP probe's included,
    switches its ``impl`` to ``"flash_int8"``, the differentiable int8-QK
    flash attention of ``ops/flash_attention_int8.py`` (kernel rows 9 and 10
    on the card). Linears are untouched.
``fp8_hybrid``
    Not ported yet: its fp8 matmul is kernel row 12, the next slice.
"""

from __future__ import annotations

from torch import nn

from jimm_tpu_torch.nn.transformer import Attention

__all__ = ["POLICIES", "FP8_NOT_PORTED", "apply_precision_policy"]

POLICIES = ("bf16", "fp8_hybrid", "int8_qk")

#: where the ROADMAP queues the fp8_hybrid policy
FP8_NOT_PORTED = ("the fp8 matmul is kernel row 12 (fp8_matmul.py), "
                  "ROADMAP.md queue 2, the next slice")


def apply_precision_policy(model: nn.Module, policy: str) -> int:
    """Rewrite ``model`` in place for the named precision policy. Returns the
    number of modules rewritten (0 for ``bf16``); an unknown policy raises
    ``ValueError`` before any surgery."""
    if policy not in POLICIES:
        raise ValueError(f"unknown precision policy {policy!r}; expected one "
                         f"of {', '.join(POLICIES)}")
    if policy == "bf16":
        return 0
    if policy == "fp8_hybrid":
        raise NotImplementedError(
            f"precision policy 'fp8_hybrid' is not ported yet: "
            f"{FP8_NOT_PORTED}")
    count = 0
    for module in model.modules():
        if isinstance(module, Attention):
            module.impl = "flash_int8"
            count += 1
    return count
