"""Build and load the native host-preprocessing library.

The sources are the repository's ``native/preprocess.cpp`` (multithreaded
uint8 -> float32 normalization, bilinear resize, center crop; the TFRecord
framing's CRC32C) and
``native/decode.cpp`` (JPEG/PNG decode through libjpeg and libpng), the
same files ``native/Makefile`` builds for the JAX package; they are not
copied or edited here. At first use this module compiles them with g++ and
``native/Makefile``'s flags into
``build/jimm_tpu_torch/libjimm_preprocess_<hash>.so`` beside the package,
the hash over the sources, the compiler and the flags, and loads the
library with ``ctypes``. As the Makefile does, it probes for ``jpeglib.h``
and ``png.h`` and builds the decode stubs (``-DJIMM_NO_IMAGE_CODECS``)
when either is missing.

A failed compile or load raises with the compiler's stderr: the port's
preprocessing never turns quietly into numpy. ``$CXX`` names the compiler
(default ``g++``). Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile
import threading

import numpy as np

NATIVE_DIR = pathlib.Path(__file__).resolve().parents[2] / "native"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / \
    "jimm_tpu_torch"
SOURCES = ("preprocess.cpp", "decode.cpp")
#: native/Makefile's CXXFLAGS
CXXFLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-pthread"]
#: the Makefile's probes: each header must parse on its own
_PROBES = {"jpeg": "#include <cstdio>\n#include <jpeglib.h>\n",
           "png": "#include <png.h>\n"}

_I64 = ctypes.c_int64
_F32P = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_U8P = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
#: (argtypes, restype) of every exported function, as the JAX package's
#: ``jimm_tpu/data/preprocess.py`` declares them
SIGNATURES = {
    "jimm_u8_to_f32_normalize": ([_U8P, _F32P, _I64, _I64, _I64, _I64,
                                  _F32P, _F32P, ctypes.c_int], None),
    "jimm_f32_normalize": ([_F32P, _I64, _I64, _I64, _I64, _F32P, _F32P,
                            ctypes.c_int], None),
    "jimm_resize_bilinear_f32": ([_F32P, _F32P, _I64, _I64, _I64, _I64,
                                  _I64, _I64, ctypes.c_int], None),
    "jimm_center_crop_f32": ([_F32P, _F32P, _I64, _I64, _I64, _I64, _I64,
                              _I64, ctypes.c_int], None),
    "jimm_image_info": ([ctypes.c_char_p, _I64, ctypes.POINTER(_I64),
                         ctypes.POINTER(_I64)], ctypes.c_int),
    "jimm_decode_image": ([ctypes.c_char_p, _I64, _U8P, _I64, _I64],
                          ctypes.c_int),
    "jimm_has_image_codecs": ([], ctypes.c_int),
    "jimm_crc32c": ([ctypes.c_char_p, _I64], ctypes.c_uint32),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def compiler() -> str:
    return os.environ.get("CXX") or "g++"


def _has_header(cxx: str, code: str) -> bool:
    try:
        proc = subprocess.run([cxx, "-x", "c++", "-fsyntax-only", "-"],
                              input=code, capture_output=True, text=True,
                              timeout=120)
    except OSError:
        return False
    return proc.returncode == 0


def build_flags(cxx: str | None = None) -> tuple[list[str], list[str]]:
    """(compile flags, link libraries): the Makefile's, with the codecs
    when both headers parse, else the stubs."""
    cxx = cxx or compiler()
    if all(_has_header(cxx, code) for code in _PROBES.values()):
        return list(CXXFLAGS), ["-ljpeg", "-lpng"]
    return CXXFLAGS + ["-DJIMM_NO_IMAGE_CODECS"], []


def library_path(cxx: str, flags: list[str], libs: list[str]) -> pathlib.Path:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((NATIVE_DIR / name).read_bytes())
    h.update(" ".join([cxx, *flags, *libs]).encode())
    return BUILD_DIR / f"libjimm_preprocess_{h.hexdigest()[:16]}.so"


def target() -> tuple[str, list[str], list[str], pathlib.Path]:
    """(compiler, flags, libraries, the library's path) of this build."""
    cxx = compiler()
    flags, libs = build_flags(cxx)
    return cxx, flags, libs, library_path(cxx, flags, libs)


def build() -> pathlib.Path:
    """Compile the library unless this exact build exists. The compiler
    writes into a temporary directory beside the target, and the library is
    renamed into place, so concurrent builds never see a torn file."""
    cxx, flags, libs, out = target()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = pathlib.Path(tmp) / out.name
        cmd = [cxx, *flags, "-shared", "-o", str(lib),
               *(str(NATIVE_DIR / s) for s in SOURCES), *libs]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=600)
        except OSError as e:
            raise RuntimeError(f"native preprocessing: cannot run {cxx}: "
                               f"{e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"native preprocessing: {' '.join(cmd)} "
                               f"failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(lib, out)
    return out


def load() -> ctypes.CDLL:
    """The library, built at first call and loaded once."""
    global _lib
    if _lib is not None:  # every preprocessing call: no lock once loaded
        return _lib
    with _lock:
        if _lib is None:
            path = build()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise RuntimeError(f"native preprocessing: cannot load "
                                   f"{path}: {e}") from e
            for name, (argtypes, restype) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
    return _lib


def threads() -> int:
    """Threads a batch call spreads over: ``$JIMM_PREPROCESS_THREADS``,
    else up to 8 of the host's cores."""
    return int(os.environ.get("JIMM_PREPROCESS_THREADS",
                              min(8, os.cpu_count() or 1)))


def codecs_available() -> bool:
    """Whether the library was built with libjpeg and libpng."""
    return bool(load().jimm_has_image_codecs())
