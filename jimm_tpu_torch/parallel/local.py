"""An in-process mesh: one process drives every device of a serving
replica, one thread per mesh position, as JAX's single controller drives a
submesh.

The SPMD code of `sharding.py`, `comm.py` and `seqpar.py` was written for
one process per rank. :class:`LocalMesh` gives it the same surface inside
one process: ``mesh_dim_names`` and a ``mesh`` tensor of positions (so
``mesh.mesh_shape`` and ``comm``'s row arithmetic read it as they read a
``DeviceMesh``), and one :class:`LocalGroup` per set of positions that
differ only along some axes, in place of a process group. A position's
view, :class:`ShardMesh`, is what ``sharding.use_sharding`` installs in
that position's thread (the ambient mesh is a ``contextvar``, so each
thread has its own), and ``comm.axis_group`` then returns an ``AxisGroup``
whose ``pg`` is the in-process group.

A :class:`LocalGroup` collective is one exchange: each position posts its
tensor, every position waits at one barrier, then reads its peers'
tensors. On CUDA a poster records an event on its current stream; a reader
makes the stream it reads on wait on that event and records the peer's
tensor on it (``record_stream``), so the caching allocator does not hand
the block out again before the read has run. Peers on one card are read in
place by plain ops; a peer on another card is copied device to device.
Nothing goes through host memory. A reduction adds the posted tensors in
position order, so every position computes the same bits.

Two slot arrays alternate between exchanges, so one barrier wait an
exchange suffices: a position can be at most one exchange ahead of the
slowest reader. A position that raises aborts every barrier of its mesh,
and its peers' waits raise :class:`RendezvousError` at once; a barrier
wait longer than ``timeout_s`` breaks the barrier too. After a failed call
whose threads have all returned, :meth:`LocalMesh.reset` makes every
barrier new.
"""

from __future__ import annotations

import itertools
import math
import threading
from typing import Mapping, Sequence

import torch

__all__ = ["LocalGroup", "LocalMesh", "RendezvousError", "ShardMesh"]


class RendezvousError(RuntimeError):
    """A collective of an in-process mesh gave up: a peer position failed
    (its error aborted the mesh) or a barrier wait timed out."""


def _posted(x: torch.Tensor) -> tuple[torch.Tensor, torch.cuda.Event | None]:
    """``x`` with, on CUDA, an event recorded after the work that made it."""
    if not x.is_cuda:
        return x, None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(x.device))
    return x, event


def _read(entry: tuple[torch.Tensor, torch.cuda.Event | None],
          device: torch.device, *, copy: bool = False) -> torch.Tensor:
    """A peer's posted tensor, readable by work queued next on this
    thread's current stream of ``device``: after the peer's event, kept
    alive for that stream, copied device to device from another card (and
    whenever ``copy``)."""
    t, event = entry
    if event is not None:
        # a copy from another card runs on the source card's current
        # stream, and a read on this card on this card's: either way, the
        # stream of t.device in this thread
        stream = torch.cuda.current_stream(t.device)
        stream.wait_event(event)
        t.record_stream(stream)
    if t.device != device:
        return t.to(device)
    return t.clone() if copy else t


class LocalGroup:
    """The in-process counterpart of a process group: the positions of one
    row of a :class:`LocalMesh` (in the row's order), a barrier, and the
    collectives a served forward reaches as exchanges over it. ``index``
    arguments are a position's place in the row."""

    def __init__(self, devices: Sequence[torch.device], timeout_s: float):
        self.devices = tuple(devices)
        self.size = len(self.devices)
        self.timeout_s = timeout_s
        self.reset()

    def reset(self) -> None:
        """A new barrier and empty slots (no position may be inside)."""
        self._barrier = threading.Barrier(self.size, timeout=self.timeout_s)
        self._slots = ([None] * self.size, [None] * self.size)
        self._turns = [0] * self.size

    def abort(self) -> None:
        self._barrier.abort()

    def exchange(self, x: torch.Tensor, index: int) -> list:
        """Post ``x`` and return every position's posted entry, in order."""
        turn = self._turns[index]
        self._turns[index] = turn + 1
        slots = self._slots[turn % 2]
        slots[index] = _posted(x)
        try:
            self._barrier.wait()
        except threading.BrokenBarrierError:
            raise RendezvousError(
                f"in-process collective over {self.size} positions gave up "
                f"(a peer failed, or a wait passed {self.timeout_s} s)"
            ) from None
        return list(slots)

    def sum(self, x: torch.Tensor, index: int) -> torch.Tensor:
        """The sum of every position's ``x``, added in position order."""
        entries = self.exchange(x, index)
        out = _read(entries[0], x.device, copy=True)
        for entry in entries[1:]:
            out += _read(entry, x.device)
        return out

    def gather(self, x: torch.Tensor, index: int, dim: int) -> torch.Tensor:
        """Every position's ``x`` concatenated along ``dim`` in order."""
        entries = self.exchange(x, index)
        return torch.cat([x if i == index else _read(e, x.device)
                          for i, e in enumerate(entries)], dim)

    def all_to_all(self, x: torch.Tensor, index: int, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
        """Chunk ``p`` of each position's ``x`` (split ``size`` ways along
        ``split_dim``) to position ``p``; the chunks received concatenated
        along ``concat_dim`` in source order."""
        entries = self.exchange(x, index)
        pieces = []
        for i, (t, event) in enumerate(entries):
            piece = t.chunk(self.size, split_dim)[index]
            pieces.append(piece if i == index
                          else _read((piece, event), x.device))
        return torch.cat(pieces, concat_dim)

    def permute(self, x: torch.Tensor, index: int, src: int | None
                ) -> torch.Tensor:
        """Position ``src``'s ``x`` (a copy of its own), or zeros when no
        position sends here."""
        entries = self.exchange(x, index)
        if src is None:
            return torch.zeros_like(x)
        return _read(entries[src], x.device, copy=True)


class LocalMesh:
    """A replica's devices as a mesh of named axes driven by one process:
    ``axes`` in order (``{"data": 1, "model": k, "seq": s}``), one device
    per position in row-major order (a card may stand more than once).
    The :class:`LocalGroup` of every row of every combination of axes is
    made here, so an abort reaches each group a position could wait in."""

    def __init__(self, axes: Mapping[str, int],
                 devices: Sequence[torch.device], *, timeout_s: float):
        sizes = tuple(int(s) for s in axes.values())
        if math.prod(sizes) != len(devices):
            raise ValueError(f"mesh {dict(axes)} needs {math.prod(sizes)} "
                             f"devices, got {len(devices)}")
        self.mesh_dim_names = tuple(axes)
        self.mesh = torch.arange(len(devices)).reshape(sizes)
        self.devices = tuple(torch.device(d) for d in devices)
        self.timeout_s = timeout_s
        self._groups: dict[tuple[int, ...], LocalGroup] = {}
        self._lock = threading.Lock()
        dims = range(len(sizes))
        for r in range(1, len(sizes) + 1):
            for order in itertools.combinations(dims, r):
                rest = [i for i in dims if i not in order]
                for row in self.mesh.permute(*rest, *order).reshape(
                        -1, math.prod(sizes[i] for i in order)).tolist():
                    if len(row) > 1:
                        self.group(row)

    @property
    def size(self) -> int:
        return len(self.devices)

    def group(self, row: Sequence[int]) -> LocalGroup:
        """The group of the positions ``row`` (in that order; ``comm``
        lists a row as its ``_rows`` does)."""
        key = tuple(row)
        with self._lock:
            if key not in self._groups:
                self._groups[key] = LocalGroup(
                    [self.devices[p] for p in key], self.timeout_s)
            return self._groups[key]

    def shard(self, position: int) -> "ShardMesh":
        return ShardMesh(self, position)

    def abort(self) -> None:
        """Break every barrier: a position's collective raises at once."""
        with self._lock:
            groups = list(self._groups.values())
        for g in groups:
            g.abort()

    def reset(self) -> None:
        """Every barrier new, after a call whose threads have all
        returned."""
        with self._lock:
            for g in self._groups.values():
                g.reset()

    def __repr__(self) -> str:
        return (f"LocalMesh({dict(zip(self.mesh_dim_names, self.mesh.shape))}"
                f", {[str(d) for d in self.devices]})")


class ShardMesh:
    """One position's view of a :class:`LocalMesh`: what its thread
    installs with ``use_sharding``."""

    def __init__(self, mesh: LocalMesh, position: int):
        self.local = mesh
        self.position = position
        self.mesh_dim_names = mesh.mesh_dim_names
        self.mesh = mesh.mesh

    @property
    def device(self) -> torch.device:
        return self.local.devices[self.position]

    def __repr__(self) -> str:
        return f"ShardMesh({self.local!r}, position={self.position})"
