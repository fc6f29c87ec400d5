"""Persistent, fingerprint-keyed store of tuning results; the counterpart of
``jimm_tpu/tune/cache.py``.

A tuned launch parameter is reusable only when everything that shaped its
measurement matches: the kernel (name and implementation version), the
operand shapes and dtypes, the device kind the timing ran on, the torch
version that launched it, and the digest of the CUDA sources
(``_build._digest()``), so that a rebuilt ``csrc/`` misses instead of
reusing timings of other code. All of it folds into one SHA-256
fingerprint over canonical JSON (`jimm_tpu_torch/aot/keys.py`'s
``canonical_json``), and the record lands in the port's
:class:`~jimm_tpu_torch.aot.store.ArtifactStore` (atomic writes, an
integrity hash on every read, quarantine, LRU gc) as a small JSON payload.

torch is imported only to default the device and version fields of
:func:`tune_key`; with every field given the module stays torch-free, so
``tune ls`` runs on a machine without torch's CUDA.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import os
from pathlib import Path
from typing import Any, Mapping, Sequence

from jimm_tpu_torch.aot.keys import canonical_json
from jimm_tpu_torch.aot.store import ArtifactStore

__all__ = ["DEFAULT_CACHE_ROOT", "TUNE_FORMAT_VERSION", "TuneCache",
           "TuneKey", "default_root", "tune_key"]

#: bump when the record payload layout changes: old entries then read as
#: misses (another fingerprint) instead of decoding garbage
TUNE_FORMAT_VERSION = 1

#: override with JIMM_TUNE_CACHE, `tune.configure(root)` or the CLI --store
DEFAULT_CACHE_ROOT = "~/.cache/jimm_tpu_torch/tune"


def default_root() -> str:
    return os.environ.get("JIMM_TUNE_CACHE", DEFAULT_CACHE_ROOT)


def dtype_name(d: Any) -> str:
    """Canonical dtype string: ``'bfloat16'``, ``torch.bfloat16``,
    ``np.float32`` and ``np.dtype('float32')`` all give their bare name."""
    if isinstance(d, str):
        return d.removeprefix("torch.")
    name = getattr(d, "name", None)
    if isinstance(name, str):
        return name
    text = str(d)
    if text.startswith("torch."):
        return text.removeprefix("torch.")
    import numpy as np
    return str(np.dtype(d).name)


@functools.cache
def kernels_digest() -> str:
    """``_build._digest()`` of the CUDA sources, read once a process."""
    from jimm_tpu_torch import _build
    return _build._digest()


@dataclasses.dataclass(frozen=True)
class TuneKey:
    """Every field that must match for a tuned config to be reusable."""

    kernel: str
    kernel_version: int
    shapes: tuple[tuple[int, ...], ...]
    dtypes: tuple[str, ...]
    #: ``aot.keys.device_backend``: ``"cuda:sm_90"`` on the H100, ``"cpu"``
    device: str
    torch_version: str
    #: ``_build._digest()`` of the CUDA sources the timing launched
    kernels: str
    format_version: int = TUNE_FORMAT_VERSION

    def fingerprint(self) -> str:
        """Hex SHA-256 over the canonical JSON of every field: byte-stable
        across processes (`tests/test_torch_tune.py` pins goldens)."""
        return hashlib.sha256(
            canonical_json(dataclasses.asdict(self)).encode()).hexdigest()

    def describe(self) -> dict:
        """Human-facing metadata recorded in the store entry."""
        return {"kernel": self.kernel, "kernel_version": self.kernel_version,
                "shapes": [list(s) for s in self.shapes],
                "dtypes": list(self.dtypes), "device": self.device,
                "torch": self.torch_version, "kernels": self.kernels}


def tune_key(kernel: str, *, shapes: Sequence[Sequence[int]],
             dtypes: Sequence[Any], kernel_version: int,
             device: Any = None, torch_version: str | None = None,
             kernels: str | None = None) -> TuneKey:
    """The key of one (kernel, shapes, dtypes) tuning point. ``device`` is a
    device kind string (``"cuda:sm_90"``) or a torch device, whose kind is
    taken; the device, torch version and source digest default from the
    running process (the device to ``"cpu"``)."""
    if device is None or not isinstance(device, str):
        from jimm_tpu_torch.aot.keys import device_backend
        device = device_backend(device if device is not None else "cpu")
    if torch_version is None:
        import torch
        torch_version = torch.__version__
    if kernels is None:
        kernels = kernels_digest()
    return TuneKey(kernel=str(kernel), kernel_version=int(kernel_version),
                   shapes=tuple(tuple(int(d) for d in s) for s in shapes),
                   dtypes=tuple(dtype_name(d) for d in dtypes),
                   device=str(device), torch_version=str(torch_version),
                   kernels=str(kernels))


class TuneCache:
    """Tuned-config records on top of an :class:`ArtifactStore`.

    ``get`` memoizes hits by fingerprint. The hot path's memo of misses as
    well (one store probe a shape a process) is
    :func:`jimm_tpu_torch.tune.api.best_config`'s, on :attr:`resolved`,
    which a new cache (``configure()``) starts empty. The store's directory
    is made at the first ``put``: a lookup in a cache that was never
    written misses and creates nothing.
    """

    def __init__(self, root: str | os.PathLike | None = None,
                 max_bytes: int | None = None):
        self._root = Path(root or default_root()).expanduser()
        self._max_bytes = max_bytes
        self._store: ArtifactStore | None = None
        self._memo: dict[str, dict] = {}
        #: best_config's resolutions: (kernel, shapes, dtypes, device) ->
        #: the stored config, or None for a miss
        self.resolved: dict[tuple, dict | None] = {}
        #: store probes made through :meth:`get` (hits of the memo excluded)
        self.probes = 0

    @property
    def root(self) -> Path:
        return self._root

    @property
    def store(self) -> ArtifactStore:
        if self._store is None:
            self._store = ArtifactStore(self._root,
                                        max_bytes=self._max_bytes)
        return self._store

    def _written(self) -> bool:
        return self._store is not None or (self._root / "objects").is_dir()

    def get(self, key: TuneKey) -> dict | None:
        """The stored record ``{"config": ..., "metrics": ..., "key": ...}``
        or None; an undecodable record is quarantined and reads as a
        miss."""
        fp = key.fingerprint()
        rec = self._memo.get(fp)
        if rec is not None:
            return rec
        self.probes += 1
        if not self._written():
            return None
        payload = self.store.get(fp)
        if payload is None:
            return None
        try:
            rec = json.loads(payload.decode())
        except (UnicodeDecodeError, ValueError):
            self.store.quarantine(fp, "undecodable tune record")
            return None
        if not isinstance(rec, dict) or not isinstance(rec.get("config"),
                                                       dict):
            self.store.quarantine(fp, "tune record missing config mapping")
            return None
        self._memo[fp] = rec
        return rec

    def put(self, key: TuneKey, config: Mapping[str, Any],
            metrics: Mapping[str, Any] | None = None) -> str:
        """Persist the winning ``config`` with its measurement; returns the
        fingerprint."""
        fp = key.fingerprint()
        rec = {"config": dict(config), "metrics": dict(metrics or {}),
               "key": key.describe()}
        self.store.put(fp, canonical_json(rec).encode(),
                       meta={"label": f"tune:{key.kernel}",
                             **key.describe()})
        self._memo[fp] = rec
        # a memoized miss of this point must now resolve to the record
        self.resolved.clear()
        return fp

    def entries(self):
        return self.store.entries() if self._written() else []
