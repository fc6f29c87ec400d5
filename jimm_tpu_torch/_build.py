"""Build and load the port's CUDA kernels.

Every kernel lives in ``jimm_tpu_torch/csrc/*.cu`` behind a plain C
interface. At first use this module compiles each source with its own
``nvcc`` for ``sm_90a``, all of them at once, links the objects into one
shared library named after a hash of the sources,
``build/jimm_tpu_torch/libjimm_kernels_<hash>.so`` beside the package, and
loads it with ``ctypes``. An edited source gets a new hash and is rebuilt; an
unchanged one is loaded as built. A failed build raises with nvcc's stderr.

Nothing here runs at import: the CPU tests import every module, and this
machine class has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import threading
import time

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
    # x, scale, mean, rstd, dy, dx, partial rows, dscale, dbias, rows, F,
    # CTAs, dtype, stream
    "jimm_layer_norm_bwd": [_P] * 9 + [_L, _I, _I, _I, _P],
    # x, scale, dy, rows, F, dtype, out: the CTAs (partial rows) to give it
    "jimm_layer_norm_bwd_grid": [_P] * 3 + [_L, _I, _I, _P],
    # ..., scale, causal, mask (null for none), mask batch stride, dtype,
    # stream
    "jimm_flash_attention_fwd": ([_P] * 5 + [_I] * 5 + [_L] * 9
                                 + [ctypes.c_float, _I, _P, _L, _I, _P]),
    "jimm_flash_attention_bwd": ([_P] * 9 + [_I] * 5 + [_L] * 12
                                 + [ctypes.c_float, _I, _P, _L, _I, _P]),
    # x_q, x_scale, w_q, w_scale, bias (null for none), out, M, N, K,
    # activation, stream
    "jimm_int8_matmul": [_P] * 6 + [_I] * 4 + [_P],
    # ..., v strides, [do strides,] scale, causal, dtype, stream
    "jimm_flash_attention_int8_fwd": ([_P] * 7 + [_I] * 5 + [_L] * 3
                                      + [ctypes.c_float, _I, _I, _P]),
    "jimm_flash_attention_int8_bwd": ([_P] * 11 + [_I] * 5 + [_L] * 6
                                      + [ctypes.c_float, _I, _I, _P]),
    # a, b, scale, bias (null for none), out, split-K workspace (null for
    # one range), M, N, K, K range, a format, b format, stream
    "jimm_fp8_matmul": [_P] * 6 + [_I] * 6 + [_P],
    # ..., scale, logit_bias, causal, mask (null for none), mask batch
    # stride, dtype, stream
    "jimm_sigmoid_attention_fwd": ([_P] * 4 + [_I] * 5 + [_L] * 9
                                   + [ctypes.c_float] * 2
                                   + [_I, _P, _L, _I, _P]),
    "jimm_sigmoid_attention_bwd": ([_P] * 7 + [_I] * 5 + [_L] * 12
                                   + [ctypes.c_float] * 2
                                   + [_I, _P, _L, _I, _P]),
    # ..., q/k/v[/do] strides, bias head and row strides, scale, causal,
    # dtype, stream
    "jimm_flash_attention_bias_fwd": ([_P] * 6 + [_I] * 5 + [_L] * 11
                                      + [ctypes.c_float, _I, _I, _P]),
    "jimm_flash_attention_bias_bwd": ([_P] * 10 + [_I] * 5 + [_L] * 14
                                      + [ctypes.c_float, _I, _I, _P]),
    # ..., dbias, batch-range workspace (null for one range), B, N, Sq, Sk,
    # D, samples a range, strides, scale, causal, dtype, stream
    "jimm_flash_attention_dbias": ([_P] * 9 + [_I] * 6 + [_L] * 14
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


_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]


def compile_commands(obj_dir: pathlib.Path
                     ) -> list[tuple[list[str], pathlib.Path]]:
    """One ``nvcc -c`` per source, with the object it writes."""
    out = []
    for src in sources():
        obj = obj_dir / (src.stem + ".o")
        out.append(([nvcc(), *_ARCH, "-Xcompiler", "-fPIC", "-c", "-o",
                     str(obj), str(src)], obj))
    return out


def link_command(objs: list[pathlib.Path], out: pathlib.Path) -> list[str]:
    return [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
            "-o", str(out), *(str(o) for o in objs)]


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands at once; raise with nvcc's stderr if any fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    errors = []
    for cmd, proc in zip(cmds, procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{cmd[-1]}: nvcc failed ({proc.returncode}):\n"
                          f"{err}")
    if errors:
        raise RuntimeError("\n".join(errors))


def _compile(out: pathlib.Path) -> None:
    """The sources compile in parallel into a temporary directory beside
    ``out``, and the linked library is renamed into place, so a concurrent
    build or a killed one never leaves a torn library."""
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        tmp_dir = pathlib.Path(tmp)
        compiles = compile_commands(tmp_dir)
        _run_all([cmd for cmd, _ in compiles])
        lib = tmp_dir / out.name
        _run_all([link_command([obj for _, obj in compiles], lib)])
        os.replace(lib, out)


def build() -> pathlib.Path:
    """Compile the library unless this exact source set is already built."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    _compile(out)
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


_count_lock = threading.Lock()


def count_launch(module: str, counter: str) -> None:
    """Add one to the launch counter ``counter`` of the module named
    ``module``; under a lock, because serving replicas launch from several
    threads at once."""
    mod = sys.modules[module]
    with _count_lock:
        setattr(mod, counter, getattr(mod, counter) + 1)


def time_builds() -> None:
    """Times the parallel build against one ``nvcc -shared`` over every
    source, on the same sources, in the order one, parallel, parallel, one,
    into a temporary directory; prints one JSON line per build."""
    one = [nvcc(), *_ARCH, "-shared", "-Xcompiler", "-fPIC", "-o"]
    with tempfile.TemporaryDirectory() as tmp:
        for way in ("one_nvcc", "parallel", "parallel", "one_nvcc"):
            out = pathlib.Path(tmp) / f"{way}.so"
            t0 = time.perf_counter()
            if way == "parallel":
                _compile(out)
            else:
                _run_all([one + [str(out), *(str(p) for p in sources())]])
            print(json.dumps({"build": way, "sources": len(sources()),
                              "cpus": os.cpu_count(),
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
            out.unlink()


if __name__ == "__main__":
    # python -m jimm_tpu_torch._build: times the two ways to build
    time_builds()
