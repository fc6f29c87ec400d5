"""Serving topology: the device list partitioned into replica groups; the
counterpart of ``jimm_tpu/serve/topology.py``.

One process serves R independent *replicas* (each computes a whole
micro-batch) that are each ``model_parallel * seq_parallel`` devices wide.
The planner partitions an explicit device list into R contiguous groups;
:func:`build_replica_forwards` gives each group its own copy of the model
and its own forward. The ``1x1x1`` plan is *trivial*: callers take the
single-replica path.

A device of the plan is an entry of ``serve --device``: a comma-separated
list in which one card may stand more than once (``cuda:0,cuda:0``, or
``cpu,cpu`` on the CPU). Each replica on a card then has its own model
copy, its own executor thread (the engine's) and its own CUDA stream.
This is the port's counterpart of the reference's forced virtual device
count; plain ``--device cuda`` lists each visible card once.

A replica wider than one device (``model_parallel`` or ``seq_parallel``
above 1) is a :class:`ShardedReplicaForward`: its group is an in-process
``(data=1, model=k[, seq=s])`` mesh (`parallel/local.py`), each position
holds a copy of the model sliced Megatron-style over ``model`` (the
``tp`` rules' layout, `parallel/sharding.py`) on its own device, and one
thread per position runs the forward under ``use_sharding``: with ``seq``
in the mesh, a tower whose sequence divides runs its encoder on the
position's chunk of the tokens and attention crosses the chunks on the
ring (`parallel/seqpar.py`). The batch is whole on every position, and so
is the output.

Plans are revisable at runtime: :meth:`TopologyPlan.revise` derives a new
plan, and the forwards built over it are what ``InferenceEngine.replan``
swaps in live.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import wait as wait_futures
from typing import Sequence

import numpy as np
import torch

from jimm_tpu_torch.parallel import comm
from jimm_tpu_torch.parallel.local import LocalMesh, RendezvousError
from jimm_tpu_torch.parallel.sharding import (TENSOR_PARALLEL,
                                              _split_model, partition_specs,
                                              use_sharding)
from jimm_tpu_torch.serve.engine import image_forward

__all__ = ["ReplicaForward", "ShardedReplicaForward", "TopologyPlan",
           "build_replica_forwards", "plan_topology", "visible_devices"]

#: how long a position of a wide replica waits at a collective for its
#: peers before the call gives up
SHARD_TIMEOUT_S = 300.0


def visible_devices() -> list[torch.device]:
    """Each visible card once (empty without CUDA)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@dataclasses.dataclass(frozen=True)
class TopologyPlan:
    """The outcome of partitioning ``n_devices`` into replica groups.

    ``device_groups`` holds one tuple of ``model_parallel * seq_parallel``
    devices per replica, in the order of the device list. Devices beyond
    ``devices_used`` are left unused (reported, not dropped silently)."""

    replicas: int
    model_parallel: int
    n_devices: int
    device_groups: tuple[tuple, ...]
    seq_parallel: int = 1

    @property
    def is_trivial(self) -> bool:
        """True for the 1x1x1 plan: callers use the single-replica path."""
        return (self.replicas == 1 and self.model_parallel == 1
                and self.seq_parallel == 1)

    @property
    def devices_used(self) -> int:
        return self.replicas * self.model_parallel * self.seq_parallel

    def meshes(self, *, timeout_s: float = SHARD_TIMEOUT_S
               ) -> list[LocalMesh]:
        """One in-process ``(data=1, model=k[, seq=s])`` mesh per replica
        group; the ``seq`` axis exists only when ``seq_parallel > 1``."""
        axes = {"data": 1, "model": self.model_parallel}
        if self.seq_parallel > 1:
            axes["seq"] = self.seq_parallel
        return [LocalMesh(axes, [_concrete(d) for d in group],
                          timeout_s=timeout_s)
                for group in self.device_groups]

    def describe(self) -> dict:
        """Flat JSON-able summary for the ready line and healthz."""
        return {"n_devices": self.n_devices, "replicas": self.replicas,
                "model_parallel": self.model_parallel,
                "seq_parallel": self.seq_parallel,
                "devices_used": self.devices_used,
                "devices_unused": self.n_devices - self.devices_used}

    def revise(self, *, replicas: int | None = None,
               model_parallel: int | None = None,
               seq_parallel: int | None = None,
               devices: Sequence | None = None) -> "TopologyPlan":
        """A runtime revision of this plan: the same partitioning rules, a
        new shape and/or device set. Unspecified dimensions keep their
        values; ``devices=None`` re-plans over this plan's own groups (the
        unused tail is not recoverable here: pass the surviving devices
        explicitly)."""
        if devices is None:
            devices = [d for group in self.device_groups for d in group]
        return plan_topology(
            self.replicas if replicas is None else replicas,
            self.model_parallel if model_parallel is None else model_parallel,
            self.seq_parallel if seq_parallel is None else seq_parallel,
            devices=devices)


def _feasible_splits(n: int, limit: int = 16) -> str:
    """Every (data, model, seq) factorization of ``n``."""
    triples = [(r, m, (n // r) // m)
               for r in range(1, n + 1) if n % r == 0
               for m in range(1, n // r + 1) if (n // r) % m == 0]
    shown = ", ".join(f"data={r} model={m} seq={s}" for r, m, s in
                      triples[:limit])
    extra = len(triples) - limit
    return shown + (f", ... ({extra} more)" if extra > 0 else "")


def plan_topology(replicas: int | None = None,
                  model_parallel: int | None = None,
                  seq_parallel: int | None = None,
                  devices: Sequence | None = None) -> TopologyPlan:
    """Partition ``devices`` (default: each visible card once) into
    ``replicas`` groups of ``model_parallel * seq_parallel``.

    Defaults give the trivial plan. Raises ``ValueError`` when the split
    does not fit the device count, naming both sides of the inequality and
    every feasible (data, model, seq) factorization of the count."""
    devices = visible_devices() if devices is None else list(devices)
    n = len(devices)
    replicas = 1 if replicas is None else int(replicas)
    model_parallel = 1 if model_parallel is None else int(model_parallel)
    seq_parallel = 1 if seq_parallel is None else int(seq_parallel)
    if replicas < 1 or model_parallel < 1 or seq_parallel < 1:
        raise ValueError(
            f"replicas ({replicas}), model_parallel ({model_parallel}) and "
            f"seq_parallel ({seq_parallel}) must all be >= 1")
    need = replicas * model_parallel * seq_parallel
    if need > n:
        one = str(devices[0]) if devices else "cuda:0"
        raise ValueError(
            f"topology needs replicas * model_parallel * seq_parallel = "
            f"{replicas} * {model_parallel} * {seq_parallel} = {need} "
            f"devices but only {n} are visible; feasible splits for {n} "
            f"device(s): {_feasible_splits(n)}. Lower "
            f"--replicas/--model-parallel/--seq-parallel or raise the "
            f"device count (e.g. list one device {need} times: --device "
            f"{','.join([one] * need)})")
    group_size = model_parallel * seq_parallel
    groups = tuple(tuple(devices[i * group_size:(i + 1) * group_size])
                   for i in range(replicas))
    return TopologyPlan(replicas=replicas, model_parallel=model_parallel,
                        seq_parallel=seq_parallel, n_devices=n,
                        device_groups=groups)


def _concrete(device) -> torch.device:
    """``device`` with a CUDA device's index filled in."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class ReplicaForward:
    """One replica's forward: its own model copy on its device and, on a
    card, its own CUDA stream, under which the batch's copy to the device,
    the forward (every kernel wrapper launches on the current stream) and
    the readback run. The engine waits on that stream alone
    (:meth:`synchronize`), so replicas sharing a card overlap."""

    def __init__(self, model: torch.nn.Module, method: str,
                 device: torch.device):
        self.model = model
        self.method = method
        self.device = torch.device(device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        self._forward = image_forward(model, method)

    def _on_stream(self):
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def __call__(self, padded: np.ndarray) -> torch.Tensor:
        with self._on_stream():
            return self._forward(padded)

    def synchronize(self) -> None:
        """Block until this replica's queued work is done."""
        if self.stream is not None:
            self.stream.synchronize()

    def to_host(self, out: torch.Tensor) -> np.ndarray:
        """The result as f32 numpy, copied on this replica's stream."""
        with self._on_stream():
            return out.float().cpu().numpy()


class ShardedReplicaForward:
    """A replica wider than one device: one model copy per position of an
    in-process mesh, each sliced over ``model`` and on its position's
    device, its own CUDA stream and its own thread (one single-thread
    executor per position, so no position waits behind another's work).

    A call runs every position's forward (``image_forward`` of its copy)
    under its ``use_sharding(ShardMesh, rules)`` and returns position 0's
    output, which is whole. The same surface as :class:`ReplicaForward`:
    ``synchronize`` waits on every position's stream, ``to_host`` reads on
    position 0's, ``model`` is position 0's copy and ``models`` every copy.

    A position that raises aborts the mesh, its peers' collectives raise at
    once, and the call raises the first error that is not a peer's abort;
    the barriers are made new for the next call. A position that has not
    returned within the mesh's timeout (plus a second) breaks this forward
    for good: the call raises, later calls raise at once, and only a fresh
    forward (the engine's heal factory) serves again."""

    def __init__(self, model: torch.nn.Module, mesh: LocalMesh, rules, *,
                 method: str):
        if len({d.type for d in mesh.devices}) > 1:
            raise ValueError(f"a replica's positions are on one kind of "
                             f"device: {mesh!r}")
        self.mesh = mesh
        self.rules = rules
        self.method = method
        sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
        specs = (partition_specs(model, sizes, rules)
                 if sizes.get("model", 1) > 1 else None)
        self.views = [mesh.shard(p) for p in range(mesh.size)]
        self.models: list[torch.nn.Module] = []
        for view in self.views:
            piece = copy.deepcopy(model)
            if specs is not None:
                _split_model(piece, specs, comm.axis_group("model", view))
            self.models.append(piece.to(view.device))
        self.model = self.models[0]
        self.devices = mesh.devices
        self.streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
                        for d in self.devices]
        self.stream = self.streams[0]
        self._forwards = [image_forward(m, method) for m in self.models]
        self._threads = self._fresh_threads()
        self._broken: str | None = None

    def _fresh_threads(self) -> list[ThreadPoolExecutor]:
        return [ThreadPoolExecutor(max_workers=1,
                                   thread_name_prefix=f"jimm-shard-p{p}")
                for p in range(self.mesh.size)]

    def _run(self, position: int, padded: np.ndarray) -> torch.Tensor:
        device, stream = self.devices[position], self.streams[position]
        try:
            with contextlib.ExitStack() as stack:
                if stream is not None:
                    stack.enter_context(torch.cuda.device(device))
                    stack.enter_context(torch.cuda.stream(stream))
                stack.enter_context(use_sharding(self.views[position],
                                                 self.rules))
                return self._forwards[position](padded)
        except BaseException:
            self.mesh.abort()
            raise

    def __call__(self, padded: np.ndarray) -> torch.Tensor:
        if self._broken is not None:
            raise RendezvousError(self._broken)
        futures = [pool.submit(self._run, p, padded)
                   for p, pool in enumerate(self._threads)]
        limit = self.mesh.timeout_s + 1.0
        _, pending = wait_futures(futures, timeout=limit)
        if pending:
            self.mesh.abort()
            for pool in self._threads:
                pool.shutdown(wait=False)
            self._threads = self._fresh_threads()
            late = sorted(futures.index(f) for f in pending)
            self._broken = (f"positions {late} of {self.mesh!r} did not "
                            f"return within {limit} s")
            raise RendezvousError(self._broken)
        errors = [f.exception() for f in futures]
        if any(e is not None for e in errors):
            # every thread has returned: the barriers can start over
            self.mesh.reset()
            raised = [e for e in errors if e is not None]
            raise next((e for e in raised
                        if not isinstance(e, RendezvousError)), raised[0])
        return futures[0].result()

    def synchronize(self) -> None:
        """Block until every position's queued work is done."""
        for stream in self.streams:
            if stream is not None:
                stream.synchronize()

    def to_host(self, out: torch.Tensor) -> np.ndarray:
        """The result as f32 numpy, copied on position 0's stream."""
        if self.stream is None:
            return out.float().cpu().numpy()
        with torch.cuda.stream(self.stream):
            return out.float().cpu().numpy()


def build_replica_forwards(model: torch.nn.Module, plan: TopologyPlan, *,
                           method: str, timeout_s: float = SHARD_TIMEOUT_S
                           ) -> list:
    """One model copy and forward per replica group of ``plan``.

    One device a group: the first replica on the model's own device serves
    ``model`` itself; every other replica gets a deep copy moved to its
    device, bit-equal to ``model``. Wider groups: a
    :class:`ShardedReplicaForward` over each group's mesh (``timeout_s``:
    how long its collectives wait), its copies sliced from ``model``."""
    if plan.model_parallel * plan.seq_parallel > 1:
        # tp; with a seq axis the sequence and the position table on it too
        rules = (dataclasses.replace(TENSOR_PARALLEL, seq="seq", pos="seq")
                 if plan.seq_parallel > 1 else TENSOR_PARALLEL)
        forwards = [ShardedReplicaForward(model, mesh, rules, method=method)
                    for mesh in plan.meshes(timeout_s=timeout_s)]
        if any(d.type == "cuda" for f in forwards for d in f.devices):
            # the copies were made on the default stream; the positions'
            # own streams read them
            torch.cuda.synchronize()
        return forwards
    home = next(model.parameters()).device
    forwards: list[ReplicaForward] = []
    used_home = False
    for (device,) in plan.device_groups:
        device = _concrete(device)
        if device == home and not used_home:
            replica, used_home = model, True
        else:
            replica = copy.deepcopy(model).to(device)
        forwards.append(ReplicaForward(replica, method, device))
    if any(f.stream is not None for f in forwards):
        # the copies were made on the default stream; the replicas' own
        # streams read them
        torch.cuda.synchronize()
    return forwards
