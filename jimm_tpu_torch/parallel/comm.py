"""Collectives over a mesh axis, differentiable; what JAX takes from
``jax.lax`` (``ppermute``, ``all_gather``, ``all_to_all``, ``psum``) written
out over ``torch.distributed``.

Each takes a mesh-axis name, or a tuple of names whose product axis is
linearised in the tuple's order (the ring loss over ``("data", "seq")``),
and runs inside every group of ranks that differ only along those axes.
:func:`axis_group` resolves the names once per mesh into one process
group per such set, made by every rank in the same order.

Each is a ``torch.autograd.Function`` whose backward is the collective's
adjoint: ``ppermute`` the reverse permutation, ``all_gather`` a
reduce-scatter (sum), ``all_to_all`` the inverse exchange, ``psum`` a
``psum``. A caller whose every rank computes the same replicated loss
therefore gets, on each rank, the gradient of the sum of the ranks'
losses; averaging the parameter gradients over the ranks
(``sharding.finish_gradients``, FSDP2's reduce-scatter) gives the gradient
of the loss itself.

Transport: the backend is fixed when the group is made
(``mesh.initialize_distributed``), never on a failure. On an in-process
mesh (`parallel/local.py`: a serving replica wider than one device, one
thread per position) the group is a ``local.LocalGroup``, and the
collectives of a forward (``ppermute``, ``all_gather``, ``all_to_all``,
``psum`` and the row-parallel sum) are exchanges between the positions'
threads (``all_gather``'s reduce-scatter backward and the mean and max
all-reduces of training run over ranks only). ``ppermute`` is an
``all_to_all_single`` with per-peer split sizes, not ``send``/``recv``:
on the H100's machine gloo carries every collective used here on CUDA
tensors except the point-to-point ones (``python -m
jimm_tpu_torch.parallel.probe``), and NCCL carries all of them. So nothing
here stages a tensor through host memory: gloo copies CUDA tensors to the
host itself.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from jimm_tpu_torch.parallel.local import LocalGroup, ShardMesh

__all__ = ["AxisGroup", "all_gather", "all_reduce_max_",
           "all_reduce_mean_", "all_to_all", "axis_group", "axis_names",
           "ppermute", "prepare_groups", "psum", "ring_perm", "tp_copy",
           "tp_gather", "tp_reduce", "tp_row_linear"]

AxisName = str | tuple[str, ...]


@dataclass(frozen=True)
class AxisGroup:
    """This rank's group along one (product) mesh axis: the global ranks in
    the axis's linear order, this rank's position among them, and the
    process group (None when the axis has one rank; a ``LocalGroup`` on an
    in-process mesh)."""

    ranks: tuple[int, ...]
    index: int
    pg: dist.ProcessGroup | LocalGroup | None

    @property
    def size(self) -> int:
        return len(self.ranks)

    def group_rank(self, position: int) -> int:
        """The process-group rank of the rank at ``position`` (a process
        group numbers its ranks in ascending global order)."""
        return sorted(self.ranks).index(self.ranks[position])


def axis_names(axis: AxisName | None) -> tuple[str, ...]:
    """An axis name, a tuple of names or None, as a tuple of names."""
    if axis is None:
        return ()
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _rows(mesh: DeviceMesh, names: tuple[str, ...]) -> list[list[int]]:
    """The global ranks of every group along ``names``, each in the axes'
    linear order."""
    dims = list(mesh.mesh_dim_names)
    order = [dims.index(n) for n in names]
    rest = [i for i in range(len(dims)) if i not in order]
    return mesh.mesh.permute(*rest, *order).reshape(
        -1, math.prod(mesh.mesh.shape[i] for i in order)).tolist()


def _process_group(mesh: DeviceMesh, row: list[int]
                   ) -> dist.ProcessGroup | None:
    """The process group of the ranks ``row`` (None for one rank), made
    once per rank set on the mesh. Making one is a collective over every
    rank of the default group: a mesh over a subset of the ranks
    (``--max-devices``) has all of its groups made up front
    (:func:`prepare_groups`, which the ranks outside it call too), and
    asking such a mesh for another raises rather than hang."""
    if len(row) < 2:
        return None
    if isinstance(mesh, ShardMesh):
        return mesh.local.group(row)
    made = mesh.__dict__.setdefault("_jimm_process_groups", {})
    key = tuple(sorted(row))
    if key not in made:
        if mesh.__dict__.get("_jimm_groups_frozen"):
            raise RuntimeError(
                f"mesh {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))} "
                f"over a subset of the ranks has no group for ranks {key}: "
                f"prepare_groups makes every group such a mesh may use")
        made[key] = dist.new_group(list(key))
    return made[key]


def prepare_groups(mesh: DeviceMesh) -> None:
    """Make the process groups of every combination of ``mesh``'s axes, in
    one order, then refuse any later one. Every rank of the default group
    calls it, the ranks outside the mesh included: the groups of a mesh
    over a subset of the ranks can then be used by its own ranks alone,
    which the ranks outside it never follow."""
    dims = tuple(mesh.mesh_dim_names)
    for r in range(1, len(dims) + 1):
        for names in itertools.combinations(dims, r):
            for row in _rows(mesh, names):
                _process_group(mesh, row)
    mesh.__dict__["_jimm_groups_frozen"] = True


def axis_group(axis: AxisName | AxisGroup,
               mesh: DeviceMesh | None = None) -> AxisGroup:
    """This rank's :class:`AxisGroup` along ``axis`` of ``mesh`` (None: the
    ambient mesh of ``sharding.use_sharding``). The groups are made at the
    first call for a (mesh, axis) on every rank, and kept on the mesh;
    every rank must make that call, as every rank runs the same
    program."""
    if isinstance(axis, AxisGroup):
        return axis
    from jimm_tpu_torch.parallel.mesh import resolve_mesh_axis
    if mesh is None:
        from jimm_tpu_torch.parallel.sharding import current_mesh
        mesh = current_mesh()
    resolve_mesh_axis(mesh, axis)
    names = axis_names(axis)
    made = mesh.__dict__.setdefault("_jimm_axis_groups", {})
    if names in made:
        return made[names]
    me = mesh.position if isinstance(mesh, ShardMesh) else dist.get_rank()
    mine = None
    for row in _rows(mesh, names):
        # every rank makes every group, in the same order
        pg = _process_group(mesh, row)
        if me in row:
            mine = AxisGroup(tuple(row), row.index(me), pg)
    if mine is None:
        raise ValueError(f"rank {me} is not in mesh {mesh}")
    made[names] = mine
    return mine


def ring_perm(size: int, shift: int = 1) -> list[tuple[int, int]]:
    """JAX's ring permutation: position i sends to i + shift."""
    return [(i, (i + shift) % size) for i in range(size)]


def _ppermute(x: torch.Tensor, grp: AxisGroup,
              perm: list[tuple[int, int]]) -> torch.Tensor:
    me = grp.index
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if grp.pg is None:
        return x.clone() if src else torch.zeros_like(x)
    if isinstance(grp.pg, LocalGroup):
        return grp.pg.permute(x, me, src[0] if src else None)
    flat = x.contiguous().view(-1)
    n = flat.numel()
    send = [0] * grp.size
    recv = [0] * grp.size
    if dst:
        send[grp.group_rank(dst[0])] = n
    if src:
        recv[grp.group_rank(src[0])] = n
    out = torch.empty(n if src else 0, dtype=x.dtype, device=x.device)
    dist.all_to_all_single(out, flat if dst else flat[:0],
                           output_split_sizes=recv, input_split_sizes=send,
                           group=grp.pg)
    # a position no one sends to receives zeros, as in JAX
    return out.view(x.shape) if src else torch.zeros_like(x)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp, perm):
        ctx.grp, ctx.perm = grp, perm
        return _ppermute(x, grp, perm)

    @staticmethod
    def backward(ctx, g):
        return _ppermute(g, ctx.grp, [(d, s) for s, d in ctx.perm]), None, None


def ppermute(x: torch.Tensor, axis: AxisName | AxisGroup,
             perm: list[tuple[int, int]], *,
             mesh: DeviceMesh | None = None) -> torch.Tensor:
    """``jax.lax.ppermute``: position ``s`` of the axis sends ``x`` to
    position ``d`` for each ``(s, d)`` of ``perm``; a position that receives
    nothing gets zeros. Backward: the reverse permutation."""
    return _PPermute.apply(x, axis_group(axis, mesh), list(perm))


def _gather(x: torch.Tensor, grp: AxisGroup, dim: int) -> torch.Tensor:
    if isinstance(grp.pg, LocalGroup):
        return grp.pg.gather(x, grp.index, dim)
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((grp.size * xt.shape[0], *xt.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, xt, group=grp.pg)
    # group-rank order -> the axis's position order
    out = out.view(grp.size, *xt.shape)
    out = out[[grp.group_rank(p) for p in range(grp.size)]]
    return out.reshape(-1, *xt.shape[1:]).movedim(0, dim)


def _reduce_scatter(g: torch.Tensor, grp: AxisGroup, dim: int
                    ) -> torch.Tensor:
    gt = g.movedim(dim, 0)
    n0 = gt.shape[0] // grp.size
    chunks = gt.reshape(grp.size, n0, *gt.shape[1:])
    # position order -> group-rank order
    by_rank = [0] * grp.size
    for p in range(grp.size):
        by_rank[grp.group_rank(p)] = p
    inp = chunks[by_rank].reshape(-1, *gt.shape[1:]).contiguous()
    out = torch.empty((n0, *gt.shape[1:]), dtype=g.dtype, device=g.device)
    dist.reduce_scatter_tensor(out, inp, group=grp.pg)
    return out.movedim(0, dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp, dim):
        ctx.grp, ctx.dim = grp, dim
        return _gather(x, grp, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.grp, ctx.dim), None, None


def all_gather(x: torch.Tensor, axis: AxisName | AxisGroup, *,
               dim: int = 0, mesh: DeviceMesh | None = None) -> torch.Tensor:
    """``jax.lax.all_gather(..., tiled=True)``: the axis's chunks of ``x``
    concatenated along ``dim`` in position order. Backward: a
    reduce-scatter (sum) along ``dim``."""
    grp = axis_group(axis, mesh)
    if grp.pg is None:
        return x
    return _AllGather.apply(x, grp, dim % x.ndim)


def _all_to_all(x: torch.Tensor, grp: AxisGroup, split_dim: int,
                concat_dim: int) -> torch.Tensor:
    chunks = x.chunk(grp.size, dim=split_dim)
    if len(chunks) != grp.size or chunks[0].shape != chunks[-1].shape:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} "
                         f"does not split {grp.size} ways")
    if isinstance(grp.pg, LocalGroup):
        return grp.pg.all_to_all(x, grp.index, split_dim, concat_dim)
    by_rank = [0] * grp.size
    for p in range(grp.size):
        by_rank[grp.group_rank(p)] = p
    inp = torch.stack([chunks[p] for p in by_rank]).contiguous()
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=grp.pg)
    return torch.cat([out[grp.group_rank(p)] for p in range(grp.size)],
                     dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp, split_dim, concat_dim):
        ctx.grp, ctx.dims = grp, (split_dim, concat_dim)
        return _all_to_all(x, grp, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return (_all_to_all(g, ctx.grp, concat_dim, split_dim), None, None,
                None)


def all_to_all(x: torch.Tensor, axis: AxisName | AxisGroup, split_dim: int,
               concat_dim: int, *, mesh: DeviceMesh | None = None
               ) -> torch.Tensor:
    """``jax.lax.all_to_all(..., tiled=True)``: ``x`` split ``size`` ways
    along ``split_dim``, chunk ``p`` sent to position ``p``, the chunks
    received concatenated along ``concat_dim`` in source order. Backward:
    the inverse exchange."""
    grp = axis_group(axis, mesh)
    if grp.pg is None:
        return x
    return _AllToAll.apply(x, grp, split_dim % x.ndim, concat_dim % x.ndim)


def _sum(x: torch.Tensor, grp: AxisGroup) -> torch.Tensor:
    """The sum of ``x`` over the group: ``x`` itself summed in place over a
    process group; a new tensor, added in position order, in process."""
    if isinstance(grp.pg, LocalGroup):
        return grp.pg.sum(x, grp.index)
    dist.all_reduce(x, group=grp.pg)
    return x


def _psum(x: torch.Tensor, grp: AxisGroup) -> torch.Tensor:
    return _sum(x if isinstance(grp.pg, LocalGroup) else x.clone(), grp)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return _psum(x, grp)

    @staticmethod
    def backward(ctx, g):
        return _psum(g, ctx.grp), None


def psum(x: torch.Tensor, axis: AxisName | AxisGroup, *,
         mesh: DeviceMesh | None = None) -> torch.Tensor:
    """``jax.lax.psum``: the sum over the axis, on every position.
    Backward: a ``psum`` of the cotangents (see the module docstring)."""
    grp = axis_group(axis, mesh)
    if grp.pg is None:
        return x
    return _PSum.apply(x, grp)


# -- tensor parallelism's operators ----------------------------------------
# Under the ``model`` axis every rank of a group computes the same loss from
# the same replicated activations, and each holds one shard of a layer's
# weights. Megatron's operators then give every rank the gradient of that
# one loss (not of the sum over the group, as the collectives above do): a
# column-parallel product's input is copied forward and its partial input
# gradients summed backward; a row-parallel product's partial outputs are
# summed forward and the (replicated) output gradient passed through
# backward; a column-parallel output gathered forward gives each rank its
# own slice of the gradient backward.

class _TpCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _psum(g, ctx.grp), None


class _TpReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        return _psum(x, grp)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _TpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp, dim):
        ctx.grp, ctx.dim = grp, dim
        return _gather(x, grp, dim)

    @staticmethod
    def backward(ctx, g):
        grp = ctx.grp
        return g.chunk(grp.size, dim=ctx.dim)[grp.index], None, None


class _TpRowLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, grp):
        ctx.save_for_backward(x, weight)
        ctx.has_bias = bias is not None
        flat = x.reshape(-1, x.shape[-1])
        if flat.is_cuda and flat.dtype != torch.float32:
            # the partial products leave the GEMM in f32, as the whole
            # product's sum stays in f32 until its one rounding
            y = torch.mm(flat, weight.t(), out_dtype=torch.float32)
        else:
            y = flat.float() @ weight.float().t()
        y = _sum(y, grp)
        if bias is not None:
            y += bias.float()
        return y.to(x.dtype).reshape(*x.shape[:-1], y.shape[-1])

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        flat = g.reshape(-1, g.shape[-1])
        dw = flat.t().mm(x.reshape(-1, x.shape[-1]))
        db = flat.sum(0) if ctx.has_bias else None
        return g.matmul(weight), dw, db, None


def tp_row_linear(x: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor | None, grp: AxisGroup) -> torch.Tensor:
    """A row-parallel product: ``x`` (this rank's slice of the input
    features) times this rank's slice ``weight`` of the input columns,
    summed over the group in f32 and rounded once, plus ``bias`` once
    (``tp_reduce`` of the rounded partial products would round twice more);
    backward, the gradients of this rank's slices."""
    if grp.pg is None:
        return torch.nn.functional.linear(x, weight, bias)
    return _TpRowLinear.apply(x, weight, bias, grp)


def tp_copy(x: torch.Tensor, grp: AxisGroup) -> torch.Tensor:
    """The input of a column-parallel product: ``x`` itself; backward, the
    sum of the group's gradients."""
    return x if grp.pg is None else _TpCopy.apply(x, grp)


def tp_reduce(x: torch.Tensor, grp: AxisGroup) -> torch.Tensor:
    """The output of a row-parallel product: the sum over the group;
    backward, the gradient itself."""
    return x if grp.pg is None else _TpReduce.apply(x, grp)


def tp_gather(x: torch.Tensor, grp: AxisGroup, dim: int = -1
              ) -> torch.Tensor:
    """A column-parallel output made whole: the group's slices of ``dim``
    concatenated in position order; backward, this rank's slice of the
    gradient."""
    return x if grp.pg is None else _TpGather.apply(x, grp, dim % x.ndim)


@torch.no_grad()
def all_reduce_mean_(tensors: list[torch.Tensor],
                     grp: AxisGroup) -> None:
    """Average ``tensors`` in place over the group, in one all-reduce of
    one flat buffer per dtype."""
    if grp.pg is None or not tensors:
        return
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat, group=grp.pg)
        flat /= grp.size
        torch._foreach_copy_(group, [
            piece.view_as(t) for piece, t in
            zip(flat.split([t.numel() for t in group]), group)])


@torch.no_grad()
def all_reduce_max_(t: torch.Tensor,
                    grp: AxisGroup | dist.ProcessGroup | None
                    ) -> torch.Tensor:
    """``t`` replaced in place by its elementwise max over ``grp``'s ranks
    (an :class:`AxisGroup` or a process group; None, or an axis of one
    rank: ``t`` as it is), in one all-reduce; returned."""
    pg = grp.pg if isinstance(grp, AxisGroup) else grp
    if pg is not None:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=pg)
    return t
