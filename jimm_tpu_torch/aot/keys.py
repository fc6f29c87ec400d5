"""Canonical cache keys for AOT artifacts; the counterpart of
``jimm_tpu/aot/keys.py``.

An artifact is reusable only when everything that shaped the exported
program matches: the model architecture (config), the entry method, the
padded batch bucket and item shape, the batch dtype the engine assembles,
the parameter dtypes, the mesh layout and the position in it, the device
kind, the torch and CUDA versions that exported it, the schemas of the
``jimm::`` ops it may name, and the donation signature. All of them are
folded into one SHA-256 fingerprint over a canonical JSON form (sorted
keys, no whitespace, primitives only), byte-stable across processes
(``tests/test_torch_aot.py`` pins a golden digest).

torch is imported lazily and only to default the version, device and
op-schema fields; with every field passed in the module stays torch-free,
so ``aot ls|gc|verify`` never import torch.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Mapping, Sequence

__all__ = ["AOT_FORMAT_VERSION", "AotKey", "canonical_json", "config_hash",
           "donation_signature", "runtime_versions", "serve_forward_key"]

#: bump when the artifact payload layout changes; old entries then
#: quarantine instead of loading garbage. The store's ``meta.json`` records
#: it for every entry, cascade calibrations included, which the JAX
#: package's store reads too: both packages stay at the same version.
AOT_FORMAT_VERSION = 1


def _canonical(obj: Any) -> Any:
    """``obj`` reduced to JSON primitives, deterministically: dataclasses,
    mappings (key-sorted), sequences, dtypes (by name) and scalars;
    anything else by ``repr``."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return _canonical(dataclasses.asdict(obj))
    if isinstance(obj, Mapping):
        return {str(k): _canonical(obj[k]) for k in sorted(obj, key=str)}
    if isinstance(obj, (list, tuple)):
        return [_canonical(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    if hasattr(obj, "name") and hasattr(obj, "itemsize"):  # numpy dtype
        return str(obj.name)
    return repr(obj)


def canonical_json(obj: Any) -> str:
    """The one serialization fingerprints hash: sorted keys, tightest
    separators, no NaN: identical bytes in every process."""
    return json.dumps(_canonical(obj), sort_keys=True,
                      separators=(",", ":"), allow_nan=False)


def config_hash(config: Any) -> str:
    """SHA-256 over the canonical JSON of a model config: the architecture
    half of the key. Weights are not hashed: artifacts hold the program,
    parameters ride in as call arguments, so every checkpoint of one
    architecture shares the same artifacts."""
    return hashlib.sha256(canonical_json(config).encode()).hexdigest()


def donation_signature(donate_argnums: Sequence[int] = (),
                       donate_argnames: Sequence[str] = ()) -> str:
    """Stable encoding of buffer-donation settings: two programs differing
    only in donation never share an artifact."""
    return canonical_json({"argnums": sorted(int(i) for i in donate_argnums),
                           "argnames": sorted(str(s)
                                              for s in donate_argnames)})


def runtime_versions() -> dict:
    """The running torch's and CUDA runtime's versions, under the names the
    store's ``meta.json`` records them (``cuda`` is ``"cpu"`` for a torch
    built without CUDA)."""
    import torch
    return {"torch": torch.__version__, "cuda": torch.version.cuda or "cpu"}


def device_backend(device: Any) -> str:
    """The device kind an artifact was exported for: ``"cpu"``, or
    ``"cuda:sm_<major><minor>"`` (``"cuda:sm_90"`` on the H100)."""
    import torch
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    major, minor = torch.cuda.get_device_capability(device)
    return f"cuda:sm_{major}{minor}"


def _mesh_axes(mesh: Any) -> tuple[tuple[str, int], ...]:
    """A mesh's ``(name, size)`` pairs, sorted: from a mapping, an object
    with a ``shape`` mapping, or one with ``mesh_dim_names`` and a ``mesh``
    tensor (the port's in-process meshes)."""
    if mesh is None:
        return ()
    if isinstance(mesh, Mapping):
        shape = dict(mesh)
    elif hasattr(mesh, "mesh_dim_names"):
        shape = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    else:
        shape = dict(mesh.shape)
    return tuple(sorted((str(k), int(v)) for k, v in shape.items()))


@dataclasses.dataclass(frozen=True)
class AotKey:
    """Every field that must match for an artifact to be reusable."""

    config_hash: str
    method: str
    bucket: int
    item_shape: tuple[int, ...]
    in_dtype: str
    param_dtype: str
    mesh_axes: tuple[tuple[str, int], ...]
    #: this program's position in the mesh: positions of a wide replica
    #: slice their own chunk of the tokens, so each has its own program
    position: int
    backend: str
    torch_version: str
    cuda_version: str
    #: :func:`jimm_tpu_torch.ops.library.schemas_hash` when exported
    op_schemas: str
    donation: str
    format_version: int = AOT_FORMAT_VERSION

    def fingerprint(self) -> str:
        """Hex SHA-256 over the canonical JSON of all fields: the store's
        content address."""
        return hashlib.sha256(
            canonical_json(dataclasses.asdict(self)).encode()).hexdigest()

    def describe(self) -> dict:
        """The metadata recorded in the store entry."""
        return {"method": self.method, "bucket": self.bucket,
                "item_shape": list(self.item_shape),
                "in_dtype": self.in_dtype, "param_dtype": self.param_dtype,
                "mesh": [list(a) for a in self.mesh_axes],
                "position": self.position, "backend": self.backend,
                "torch": self.torch_version, "cuda": self.cuda_version,
                "config_hash": self.config_hash[:12]}


def serve_forward_key(config: Any, *, method: str, bucket: int,
                      item_shape: Sequence[int], in_dtype: Any,
                      param_dtype: Any, mesh: Any = None, position: int = 0,
                      backend: str | None = None,
                      torch_version: str | None = None,
                      cuda_version: str | None = None,
                      op_schemas: str | None = None,
                      donation: str | None = None) -> AotKey:
    """The key of one serve bucket's forward. The version, backend and
    op-schema fields default from the running torch (the backend from the
    default device: ``"cuda:sm_XY"`` with a card, else ``"cpu"``); every
    field takes an explicit value, so keys can be computed without
    torch."""
    if torch_version is None or cuda_version is None:
        versions = runtime_versions()
        torch_version = torch_version or versions["torch"]
        cuda_version = cuda_version or versions["cuda"]
    if backend is None:
        import torch
        backend = device_backend("cuda" if torch.cuda.is_available()
                                 else "cpu")
    if op_schemas is None:
        from jimm_tpu_torch.ops.library import schemas_hash
        op_schemas = schemas_hash()
    import numpy as np
    return AotKey(
        config_hash=config_hash(config),
        method=str(method),
        bucket=int(bucket),
        item_shape=tuple(int(d) for d in item_shape),
        in_dtype=str(np.dtype(in_dtype).name),
        param_dtype=str(param_dtype),
        mesh_axes=_mesh_axes(mesh),
        position=int(position),
        backend=str(backend),
        torch_version=str(torch_version),
        cuda_version=str(cuda_version),
        op_schemas=str(op_schemas),
        donation=donation if donation is not None else donation_signature(),
    )
