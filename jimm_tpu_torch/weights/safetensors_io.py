"""safetensors reader/writer over torch tensors, without the ``safetensors``
wheel; the counterpart of ``jimm_tpu/weights/safetensors_io.py``.

The format (https://github.com/huggingface/safetensors) is: an 8-byte
little-endian header length, a JSON header mapping tensor name -> {dtype,
shape, data_offsets}, then the raw little-endian tensor bytes. A file this
module writes is byte for byte the one the JAX package writes for the same
tensors and metadata; like it, it writes a 0-d tensor with shape ``[1]``
(the JAX writer's ``np.ascontiguousarray`` makes 0-d arrays 1-d), which
both packages' loaders, and transformers', read back.
"""

from __future__ import annotations

import json
import mmap
import os
from typing import Any, Mapping

import numpy as np
import torch

_DTYPES: dict[str, torch.dtype] = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "F8_E4M3": torch.float8_e4m3fn,
    "F8_E5M2": torch.float8_e5m2,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "U16": torch.uint16,
    "U32": torch.uint32,
    "U64": torch.uint64,
    "BOOL": torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in _DTYPES.items()}


def _raw(dtype: torch.dtype) -> tuple[np.dtype, torch.dtype]:
    """The numpy dtype that carries ``dtype``'s bytes (an unsigned integer
    of its width where numpy has no such type, as for bf16 and fp8), and the
    torch dtype that numpy type arrives as."""
    if dtype == torch.bool:
        return np.dtype(np.bool_), torch.bool
    if dtype.is_floating_point and dtype not in (torch.float16, torch.float32,
                                                 torch.float64):
        unsigned = {1: torch.uint8, 2: torch.uint16}[dtype.itemsize]
        return np.dtype(f"<u{dtype.itemsize}"), unsigned
    return np.dtype(str(dtype).removeprefix("torch.")), dtype


def read_header(path: str | os.PathLike) -> tuple[dict[str, Any], int]:
    """Parse just the JSON header: ``(header, data_start_offset)``.

    ``header`` maps tensor name -> {dtype, shape, data_offsets} (plus the
    optional ``__metadata__`` entry) without touching the tensor bytes."""
    with open(path, "rb") as f:
        header_len = int.from_bytes(f.read(8), "little")
        header: dict[str, Any] = json.loads(f.read(header_len))
    return header, 8 + header_len


def load_file(path: str | os.PathLike) -> dict[str, torch.Tensor]:
    """Read every tensor of a .safetensors file as CPU tensors over a
    copy-on-write map of the file: nothing is read until a tensor is used,
    the tensors are writable, and a write reaches no byte of the file."""
    header, data_start = read_header(path)
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    out: dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _DTYPES[info["dtype"]]
        raw, arrives_as = _raw(dtype)
        start, end = info["data_offsets"]
        arr = np.frombuffer(mm, dtype=raw, count=(end - start) // raw.itemsize,
                            offset=data_start + start)
        t = torch.from_numpy(arr)
        out[name] = (t if arrives_as == dtype else t.view(dtype)
                     ).reshape(info["shape"])
    return out


def save_file(tensors: Mapping[str, torch.Tensor], path: str | os.PathLike,
              metadata: Mapping[str, str] | None = None) -> None:
    """Write tensors to a .safetensors file (HF-interoperable export)."""
    header: dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    offset = 0
    blobs: list[bytes] = []
    for name, t in tensors.items():
        if t.dtype not in _DTYPE_NAMES:
            raise ValueError(f"unsupported dtype {t.dtype} for tensor {name!r}")
        t = t.detach().cpu().contiguous()
        _, arrives_as = _raw(t.dtype)
        blob = t.view(arrives_as).numpy().tobytes()
        header[name] = {"dtype": _DTYPE_NAMES[t.dtype],
                        "shape": list(t.shape) if t.dim() else [1],
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    hjson = json.dumps(header, separators=(",", ":")).encode()
    # pad the header to 8-byte alignment like the upstream implementation
    hjson += b" " * ((8 - len(hjson) % 8) % 8)
    with open(path, "wb") as f:
        f.write(len(hjson).to_bytes(8, "little"))
        f.write(hjson)
        for blob in blobs:
            f.write(blob)
