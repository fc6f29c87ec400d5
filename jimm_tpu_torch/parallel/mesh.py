"""Process groups and device meshes; the counterpart of
``jimm_tpu/parallel/mesh.py``.

JAX is single-controller: one process sees every device and XLA writes
the collectives. The port is multi-process SPMD: one process per rank,
started by ``python -m torch.distributed.run`` (or by the tests), each
holding one device, with every collective written out
(`jimm_tpu_torch/parallel/comm.py`). A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` whose dimension names are
the JAX mesh-axis names.

The backend is chosen here, when the group is set up, from where the ranks
run: NCCL when every rank of the host has a card of its own, gloo when the
ranks are CPU processes or share a card (NCCL refuses two ranks on one
device). A rank's device is ``cuda:(LOCAL_RANK % device_count())``.
"""

from __future__ import annotations

import math
import os
from collections import OrderedDict
from datetime import timedelta
from typing import Mapping

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["MESH_AXES", "TOPOLOGIES", "check_max_devices",
           "initialize_distributed", "local_device", "make_hybrid_mesh",
           "make_mesh", "make_topology", "mesh_shape", "mesh_sizes",
           "outcome_group", "planned_world_size", "resolve_mesh_axis",
           "shutdown_distributed"]

#: the mesh-axis names, JAX's vocabulary
MESH_AXES: tuple[str, ...] = ("data", "model", "replica", "seq", "stage")

#: the device this process computes on, set by :func:`initialize_distributed`
_DEVICE: torch.device | None = None

#: how long the outcome group's collective waits: ranks that
#: ``--max-devices`` leaves out of an attempt wait in it through the whole
#: attempt, which may run for days
OUTCOME_TIMEOUT_S = 30 * 24 * 3600.0

#: every rank of the default group, on gloo, with :data:`OUTCOME_TIMEOUT_S`
_OUTCOME_GROUP: dist.ProcessGroup | None = None


def _env_int(*names: str) -> int | None:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def _pick_backend(device: torch.device, local_world: int) -> str:
    """NCCL when every rank of the host has a card of its own, else gloo."""
    if device.type == "cuda" and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None, *,
                           device: str | torch.device | None = None,
                           backend: str | None = None,
                           init_method: str | None = None,
                           timeout_s: float = 600.0) -> torch.device:
    """Join (or make) the default process group and return this rank's
    device. Safe to call twice.

    Arguments left None come from ``JIMM_COORDINATOR`` /
    ``JIMM_NUM_PROCESSES`` / ``JIMM_PROCESS_ID`` (JAX's launcher variables),
    then from torchrun's ``MASTER_ADDR``:``MASTER_PORT`` / ``WORLD_SIZE`` /
    ``RANK``; with neither set the process makes a one-rank group. The
    device defaults to the card (``cuda:(LOCAL_RANK % device_count())``)
    when there is one, else the CPU; ``device="cpu"`` asks for the CPU. The
    backend (NCCL or gloo, see the module docstring) is fixed here, unless
    ``backend`` names one; ``timeout_s`` bounds every collective but the
    outcome group's (:func:`outcome_group`, made here too). Errors
    are raised, never downgraded: a misconfigured multi-process run that
    went on single-process would train the wrong thing."""
    global _DEVICE, _OUTCOME_GROUP
    if dist.is_initialized():
        return local_device()
    coordinator_address = coordinator_address or os.environ.get(
        "JIMM_COORDINATOR")
    if num_processes is None:
        num_processes = _env_int("JIMM_NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("JIMM_PROCESS_ID", "RANK")
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    world = num_processes or 1
    rank = process_id or 0
    if not 0 <= rank < world:
        raise ValueError(f"process id {rank} outside [0, {world})")
    local_rank = _env_int("LOCAL_RANK")
    local_rank = rank if local_rank is None else local_rank
    local_world = _env_int("LOCAL_WORLD_SIZE") or world
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = backend or _pick_backend(dev, local_world)
    kwargs = {"backend": backend, "rank": rank, "world_size": world,
              "timeout": timedelta(seconds=timeout_s)}
    if init_method is not None:
        kwargs["init_method"] = init_method
    elif coordinator_address is not None:
        kwargs["init_method"] = f"tcp://{coordinator_address}"
    elif world == 1:
        kwargs["store"] = dist.HashStore()
    else:
        raise ValueError(f"{world} processes need a coordinator address "
                         f"(JIMM_COORDINATOR or MASTER_ADDR)")
    if backend == "nccl":
        kwargs["device_id"] = dev
    dist.init_process_group(**kwargs)
    _DEVICE = dev
    _OUTCOME_GROUP = None
    if world > 1:
        _OUTCOME_GROUP = dist.new_group(
            backend="gloo", timeout=timedelta(seconds=OUTCOME_TIMEOUT_S))
    return dev


def shutdown_distributed() -> None:
    """Leave the default process group: the end of a run that
    :func:`initialize_distributed` started."""
    global _DEVICE, _OUTCOME_GROUP
    if dist.is_initialized():
        dist.destroy_process_group()
    _DEVICE = _OUTCOME_GROUP = None


def outcome_group() -> dist.ProcessGroup | None:
    """The group an attempt's outcome is agreed over: every rank of the
    default group, on gloo (CPU tensors, whatever the default backend),
    with a collective timeout of :data:`OUTCOME_TIMEOUT_S` instead of the
    default group's, since the ranks ``--max-devices`` leaves out wait in
    it while the others train. None with one rank."""
    return _OUTCOME_GROUP


def local_device() -> torch.device:
    """This rank's device (the CPU before :func:`initialize_distributed`)."""
    return _DEVICE if _DEVICE is not None else torch.device("cpu")


def planned_world_size() -> int:
    """The number of ranks this process's group has, or will have once
    :func:`initialize_distributed` runs (its environment's word)."""
    if dist.is_initialized():
        return dist.get_world_size()
    return _env_int("JIMM_NUM_PROCESSES", "WORLD_SIZE") or 1


def _world_size() -> int:
    if not dist.is_initialized():
        initialize_distributed()
    return dist.get_world_size()


def mesh_sizes(axes: Mapping[str, int], n: int) -> dict[str, int]:
    """``axes`` with its ``-1`` resolved against ``n`` ranks; an unknown
    axis name, more than one ``-1`` or a product other than ``n`` raises
    ``ValueError``."""
    axes = OrderedDict(axes)
    for name in axes:
        if name not in MESH_AXES:
            raise ValueError(f"unknown mesh axis {name!r} (one of "
                             f"{MESH_AXES})")
    sizes = list(axes.values())
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis may be -1")
    known = math.prod(s for s in sizes if s != -1)
    if -1 in sizes:
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        sizes[sizes.index(-1)] = n // known
    if math.prod(sizes) != n or min(sizes) < 1:
        raise ValueError(f"mesh {dict(zip(axes, sizes))} != {n} devices")
    return dict(zip(axes, sizes))


def make_mesh(axes: Mapping[str, int] | None = None, *,
              max_devices: int | None = None) -> DeviceMesh:
    """A mesh from ``{"axis": size}`` over every rank of the default group
    (made first, one-rank, when there is none); ``-1`` means "all remaining
    ranks". Axis order follows dict order, outermost first, and rank ``r``
    sits at the row-major coordinates of ``r``.

    ``max_devices``: the mesh over ranks ``0..max_devices-1`` only (JAX's
    ``--max-devices``: a device is a rank here), with JAX's range check.
    When that leaves ranks out, every rank of the default group makes it,
    the ranks outside it included, and then every process group it may use
    (``comm.prepare_groups``): making a group is a collective over the
    default group."""
    n = _world_size()
    if max_devices is not None:
        check_max_devices(max_devices, n)
    k = n if max_devices is None else max_devices
    sizes = mesh_sizes(axes if axes is not None else {"data": k}, k)
    if k == n:
        return init_device_mesh(local_device().type, tuple(sizes.values()),
                                mesh_dim_names=tuple(sizes))
    mesh = DeviceMesh(local_device().type,
                      torch.arange(k).reshape(tuple(sizes.values())),
                      mesh_dim_names=tuple(sizes))
    from jimm_tpu_torch.parallel.comm import prepare_groups
    prepare_groups(mesh)
    return mesh


def check_max_devices(max_devices: int, visible: int) -> None:
    """JAX's range check of ``--max-devices`` against the ranks there
    are."""
    if not 1 <= max_devices <= visible:
        raise ValueError(f"--max-devices {max_devices} out of range "
                         f"(1..{visible} visible)")


def make_hybrid_mesh(ici: Mapping[str, int],
                     dcn: Mapping[str, int]) -> DeviceMesh:
    """JAX's multi-slice mesh: the ``dcn`` axes outermost (slowest
    varying), then the ``ici`` axes. Ranks have no slice index here, so
    this is :func:`make_mesh` over the dcn axes followed by the ici axes."""
    both = OrderedDict(dcn)
    for name, size in ici.items():
        if name in both:
            raise ValueError(f"axis {name!r} is both dcn and ici")
        both[name] = size
    return make_mesh(both)


#: JAX's named pod topologies, as data: mesh recipe, rules preset, ring
#: axis of the sigmoid loss (the names are JAX's; nothing here is a TPU
#: number)
TOPOLOGIES: dict[str, dict] = {
    "v5e-16-fsdp": {"axes": {"data": 16}, "rules": "fsdp",
                    "ring_axis": "data"},
    "v5e-16-dp": {"axes": {"data": 16}, "rules": "dp", "ring_axis": "data"},
    "v5e-64-fsdp-tp": {"ici": {"data": 4, "model": 4},
                       "dcn": {"replica": 4}, "rules": "hybrid_fsdp_tp",
                       "ring_axis": ("replica", "data")},
}


def make_topology(name: str):
    """``(mesh, rules_name, ring_axis)`` for a named topology."""
    spec = TOPOLOGIES[name]
    if "ici" in spec:
        mesh = make_hybrid_mesh(spec["ici"], spec["dcn"])
    else:
        mesh = make_mesh(spec["axes"])
    return mesh, spec["rules"], spec["ring_axis"]


def mesh_shape(mesh: DeviceMesh) -> dict[str, int]:
    """``{"axis": size}`` in the mesh's order (JAX's ``mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def resolve_mesh_axis(mesh: DeviceMesh | None,
                      axis_name: str | tuple[str, ...]) -> dict[str, int]:
    """Check that ``axis_name`` (or each name of a tuple) is an axis of
    ``mesh`` (None: the ambient mesh of ``use_sharding``) and return the
    mesh's shape dict."""
    if mesh is None:
        from jimm_tpu_torch.parallel.sharding import current_mesh
        mesh = current_mesh()
        if mesh is None:
            raise ValueError("no mesh given and no ambient mesh installed "
                             "(use use_sharding(mesh, ...))")
        where = "ambient mesh"
    else:
        where = "mesh"
    shape = mesh_shape(mesh)
    for name in (axis_name,) if isinstance(axis_name, str) else axis_name:
        if name not in shape:
            raise ValueError(f"{where} {shape} has no {name!r} axis")
    return shape
