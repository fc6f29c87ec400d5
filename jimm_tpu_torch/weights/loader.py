"""Declarative checkpoint-mapping engine; the semantics of
``jimm_tpu/weights/loader.py`` over torch modules.

HF's torch layouts are the port's (a Linear is ``(out, in)``, a Conv2d
OIHW), so the JAX package's transposes are identities here, and a per-layer
HF tensor maps to one layer module (``blocks.{i}``) with no stacking. What
remains are the transforms of :class:`T`. :func:`apply_mapping` is strict,
as the JAX engine is: every model parameter is assigned exactly once, every
checkpoint tensor is used (``position_ids`` buffers the only leftovers
allowed), and every shape must match; anything else raises
:class:`MappingError`.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Mapping

import torch
from torch import nn

#: checkpoint tensors a mapping may leave unused (HF's position-id buffers)
ALLOWED_UNUSED = ("position_ids",)


class Transform:
    """An invertible tensor transform: ``fwd`` maps the HF layout to the
    port's, ``inv`` maps back (used by the HF exporter)."""

    def __init__(self, fwd: Callable[[torch.Tensor], torch.Tensor],
                 inv: Callable[[torch.Tensor], torch.Tensor]):
        self.fwd = fwd
        self.inv = inv

    def __call__(self, w: torch.Tensor) -> torch.Tensor:
        return self.fwd(w)


class Chunk(Transform):
    """The idx-th of n equal chunks along axis 0: torch's fused MAP-head
    ``in_proj_*``. The exporter re-fuses the n chunks of one source key."""

    def __init__(self, n: int, idx: int):
        self.n = n
        self.idx = idx
        super().__init__(lambda w: w.chunk(n, dim=0)[idx], lambda w: w)


def _patch_linear_to_oihw(w: torch.Tensor) -> torch.Tensor:
    """SigLIP2's NaFlex Linear patch embedding ``(D, p*p*3)`` -> the conv's
    OIHW weight. The flattened input is ordered (patch_row, patch_col,
    channel), as transformers' ``convert_image_to_patches`` makes it."""
    out, flat = w.shape
    p = int(round((flat // 3) ** 0.5))
    if p * p * 3 != flat:
        raise ValueError(f"patch linear input dim {flat} is not p*p*3")
    return w.reshape(out, p, p, 3).permute(0, 3, 1, 2).contiguous()


class T:
    """The transforms between HF's layout and the port's."""

    unsqueeze = Transform(lambda w: w[None], lambda w: w[0])
    #: a scalar; the exporter restores a rank-1 (1,) tensor where the
    #: checkpoint has one (SigLIP's logit_scale and logit_bias are (1,),
    #: CLIP's logit_scale is ())
    scalar = Transform(lambda w: w.reshape(()), lambda w: w.reshape(()))
    scalar_1d = Transform(lambda w: w.reshape(()), lambda w: w.reshape((1,)))
    reshape_1_1_d = Transform(lambda w: w.reshape(1, 1, -1),
                              lambda w: w.reshape(-1))
    #: the patch embedding: the Conv2d OIHW layout (ViT, CLIP, SigLIP v1)
    #: as it is, or SigLIP2's NaFlex Linear (2-D). The exporter writes the
    #: Conv2d layout.
    patch = Transform(lambda w: w if w.ndim == 4 else _patch_linear_to_oihw(w),
                      lambda w: w)
    chunk = Chunk


@dataclass(frozen=True)
class M:
    """One mapping entry: port parameter ``dst`` from checkpoint tensor
    ``src``. Either may hold ``{i}``, a layer index (:func:`per_layer`)."""

    dst: str
    src: str
    transform: Transform | None = None


def per_layer(entries: list[M], depth: int) -> list[M]:
    """Each ``{i}`` entry once per layer, the rest as they are."""
    out = []
    for e in entries:
        if "{i}" in e.src:
            out += [replace(e, dst=e.dst.format(i=i), src=e.src.format(i=i))
                    for i in range(depth)]
        else:
            out.append(e)
    return out


class MappingError(ValueError):
    pass


@torch.no_grad()
def apply_mapping(model: nn.Module, weights: Mapping[str, torch.Tensor],
                  entries: list[M]) -> None:
    """Fill ``model``'s parameters from ``weights`` by ``entries``, cast to
    each parameter's dtype and device. Nothing is written unless the whole
    mapping checks out."""
    params = dict(model.named_parameters())
    consumed: set[str] = set()
    assigned: dict[str, torch.Tensor] = {}
    for e in entries:
        if e.dst not in params:
            raise MappingError(f"model has no parameter {e.dst!r}")
        if e.src not in weights:
            raise MappingError(f"checkpoint missing tensor {e.src!r}")
        consumed.add(e.src)
        arr = weights[e.src]
        if e.transform is not None:
            arr = e.transform(arr)
        target = params[e.dst]
        if tuple(arr.shape) != tuple(target.shape):
            raise MappingError(
                f"shape mismatch for {e.dst}: checkpoint {tuple(arr.shape)} "
                f"vs model {tuple(target.shape)} (src {e.src!r})")
        if e.dst in assigned:
            raise MappingError(f"parameter {e.dst} assigned twice")
        assigned[e.dst] = arr
    not_assigned = sorted(set(params) - set(assigned))
    if not_assigned:
        raise MappingError(f"model parameters not loaded: {not_assigned}")
    leftovers = sorted(k for k in weights if k not in consumed
                       and not k.endswith(ALLOWED_UNUSED))
    if leftovers:
        raise MappingError(f"unused checkpoint tensors: {leftovers}")
    for name, arr in assigned.items():
        params[name].copy_(arr)
