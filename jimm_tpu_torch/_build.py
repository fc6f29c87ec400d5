"""Build and load the port's CUDA kernels.

Every kernel lives in ``jimm_tpu_torch/csrc/*.cu`` behind a plain C
interface. At first use this module compiles all of them with ``nvcc`` for
``sm_90a`` into one shared library named after a hash of the sources,
``build/jimm_tpu_torch/libjimm_kernels_<hash>.so`` beside the package, and
loads it with ``ctypes``. An edited source gets a new hash and is rebuilt; an
unchanged one is loaded as built. A failed build raises with nvcc's stderr.

Nothing here runs at import: the CPU tests import every module, and this
machine class has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "jimm_tpu_torch"

#: dtype codes of the C interface (csrc/common.cuh ``jimm::DType``)
DTYPE_CODES = {"float32": 0, "bfloat16": 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
#: argtypes of every exported function: each pointer and the stream is a
#: c_void_p, or ctypes would pass it as a 32-bit int and cut it
_SIGNATURES = {
    "jimm_layer_norm_fwd": [_P] * 6 + [_L, _I, ctypes.c_float, _I, _P],
    "jimm_flash_attention_fwd": ([_P] * 5 + [_I] * 5 + [_L] * 9
                                 + [ctypes.c_float, _I, _I, _P]),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def sources() -> list[pathlib.Path]:
    """The translation units, one per kernel."""
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> pathlib.Path:
    return BUILD_DIR / f"libjimm_kernels_{_digest()}.so"


def nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc`` when CUDA_HOME is set, else the one on PATH,
    else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME")
    if home:
        return str(pathlib.Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def build_command(out: pathlib.Path) -> list[str]:
    return [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(out),
            *(str(p) for p in sources())]


def build() -> pathlib.Path:
    """Compile the library unless this exact source set is already built.
    The output is written under a temporary name and renamed into place, so
    a concurrent build or a killed one never leaves a torn library."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(build_command(pathlib.Path(tmp)),
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built at first call and loaded once."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raise on a launch that returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{rc}")
