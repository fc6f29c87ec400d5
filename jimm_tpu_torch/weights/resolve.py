"""Checkpoint resolution over local files and directories; the counterpart
of ``jimm_tpu/weights/resolve.py`` with the same precedence: a sharded
``model.safetensors.index.json``, ``model.safetensors``, any
``*.safetensors``, then ``pytorch_model.bin`` (sharded or single), the
``.bin`` first when ``use_pytorch=True``; a file's config from its sibling
``config.json``, or from the parent of a ``model/`` directory. ``.bin``
files are read by ``torch.load(..., weights_only=True)``. A name that is
no local path and looks like ``org/repo`` is fetched from the Hugging Face
hub (``huggingface_hub``, imported when needed) with bounded retries and a
last local-cache attempt.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Any, Callable

import torch

from jimm_tpu_torch.weights.safetensors_io import load_file

_TORCH_SUFFIXES = (".bin", ".pt", ".pth")

Weights = dict[str, torch.Tensor]


def load_torch_file(path: str | os.PathLike) -> Weights:
    """A ``pytorch_model.bin`` state dict, on the CPU, unpickled with
    ``weights_only=True`` (tensors and plain containers only)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def _load_config(path: Path) -> dict[str, Any] | None:
    if path.is_file():
        with open(path) as f:
            return json.load(f)
    return None


def _sharded(d: Path, index: Path, loader: Callable[[Path], Weights]
             ) -> Weights:
    with open(index) as f:
        weight_map: dict[str, str] = json.load(f)["weight_map"]
    weights: Weights = {}
    for shard in sorted(set(weight_map.values())):
        weights.update(loader(d / shard))
    return weights


def _torch_format(d: Path) -> Weights | None:
    index = d / "pytorch_model.bin.index.json"
    if index.is_file():
        return _sharded(d, index, load_torch_file)
    single = d / "pytorch_model.bin"
    return load_torch_file(single) if single.is_file() else None


def _from_dir(d: Path, use_pytorch: bool) -> tuple[Weights, dict | None]:
    config = _load_config(d / "config.json")
    if use_pytorch:
        weights = _torch_format(d)
        if weights is None:
            raise FileNotFoundError(f"no pytorch_model.bin under {d}")
        return weights, config
    index = d / "model.safetensors.index.json"
    if index.is_file():
        return _sharded(d, index, load_file), config
    single = d / "model.safetensors"
    if single.is_file():
        return load_file(single), config
    candidates = sorted(d.glob("*.safetensors"))
    if candidates:
        weights: Weights = {}
        for c in candidates:
            weights.update(load_file(c))
        return weights, config
    # the torch format only when no safetensors exist at all
    weights = _torch_format(d)
    if weights is None:
        raise FileNotFoundError(f"no .safetensors or pytorch_model.bin "
                                f"weights under {d}")
    return weights, config


def _from_file(p: Path) -> tuple[Weights, dict | None]:
    weights = (load_torch_file(p) if p.suffix in _TORCH_SUFFIXES
               else load_file(p))
    config = _load_config(p.parent / "config.json")
    if config is None and p.parent.name == "model":
        config = _load_config(p.parent.parent / "config.json")
    return weights, config


# the hub's not-found family, matched by class name (huggingface_hub need
# not be importable): sharded-vs-single probing uses them as control flow,
# so retrying them would turn every probe into retries * backoff of waiting
_NO_RETRY_ERRORS = ("EntryNotFoundError", "RepositoryNotFoundError",
                    "RevisionNotFoundError", "GatedRepoError",
                    "FileNotFoundError")


def _retryable(exc: BaseException) -> bool:
    return not any(cls.__name__ in _NO_RETRY_ERRORS
                   for cls in type(exc).__mro__)


def _hub_download_with_retry(hf_hub_download, repo_id: str, filename: str,
                             *, retries: int | None = None,
                             backoff_s: float | None = None,
                             sleep=None) -> str:
    """``hf_hub_download`` with bounded retry and a local-cache last resort.

    Transient failures (timeouts, 5xx, resets) get ``retries`` attempts
    (``JIMM_HUB_RETRIES``, default 3) with exponential backoff from
    ``backoff_s`` (``JIMM_HUB_BACKOFF_S``, default 0.5); not-found errors
    propagate at once. When the network never recovers, one final
    ``local_files_only=True`` attempt serves a previously cached copy; if
    that fails too, the transient error is raised."""
    from jimm_tpu_torch.resilience import BackoffPolicy
    if retries is None:
        retries = int(os.environ.get("JIMM_HUB_RETRIES", "3"))
    if backoff_s is None:
        backoff_s = float(os.environ.get("JIMM_HUB_BACKOFF_S", "0.5"))
    sleep = sleep or time.sleep
    # jitter 0: the exact exponential delays, base * 2**attempt
    backoff = BackoffPolicy(retries=max(1, retries), base_s=backoff_s)
    last: BaseException | None = None
    for attempt in range(backoff.retries):
        try:
            return hf_hub_download(repo_id, filename)
        except Exception as e:
            if not _retryable(e):
                raise
            last = e
            if attempt + 1 < backoff.retries:
                sleep(backoff.delay(attempt))
    try:
        return hf_hub_download(repo_id, filename, local_files_only=True)
    except Exception:
        raise last  # the transient error, not the cache miss


def _from_hub(repo_id: str, use_pytorch: bool = False
              ) -> tuple[Weights, dict | None]:
    """A hub checkpoint: the sharded index first, then the single file, in
    the preferred format and then the other; ``config.json`` when the
    repository has one."""
    try:
        from huggingface_hub import hf_hub_download
    except ImportError as e:
        raise FileNotFoundError(
            f"{repo_id!r} is not a local path and huggingface_hub is "
            "unavailable") from e

    def download(filename: str) -> str:
        return _hub_download_with_retry(hf_hub_download, repo_id, filename)

    def fetch(single: str, loader: Callable[[str], Weights]) -> Weights:
        try:
            index_path = download(single + ".index.json")
            with open(index_path) as f:
                weight_map: dict[str, str] = json.load(f)["weight_map"]
            out: Weights = {}
            for shard in sorted(set(weight_map.values())):
                out.update(loader(download(shard)))
            return out
        except Exception:
            return loader(download(single))

    formats = [("model.safetensors", load_file),
               ("pytorch_model.bin", load_torch_file)]
    if use_pytorch:
        formats.reverse()
    try:
        try:
            weights = fetch(*formats[0])
        except Exception:
            weights = fetch(*formats[1])  # the repo has only the other
    except Exception as e:
        raise FileNotFoundError(
            f"could not fetch {repo_id!r} from the HF hub "
            f"(offline, or repo has neither format?): {e}") from e
    try:
        config = _load_config(Path(download("config.json")))
    except Exception:
        config = None
    return weights, config


def resolve_checkpoint(name_or_path: str | os.PathLike, *,
                       use_pytorch: bool = False
                       ) -> tuple[Weights, dict | None]:
    """Return ``(flat HF tensor dict, HF config dict | None)`` for a local
    checkpoint file or directory, or a hub repository id."""
    p = Path(name_or_path).expanduser()
    if p.is_dir():
        return _from_dir(p, use_pytorch)
    if p.is_file():
        return _from_file(p)
    name = str(name_or_path)
    if name.startswith((".", "/", "~")) or name.count("/") != 1:
        raise FileNotFoundError(f"no checkpoint file or directory at {name!r}")
    return _from_hub(name, use_pytorch)
