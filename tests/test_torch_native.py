"""The port's native host preprocessing (``jimm_tpu_torch/data/native.py``
building ``native/preprocess.cpp`` and ``native/decode.cpp`` with g++):
normalize, resize, crop and ``preprocess_batch`` within 1e-6 of the port's
numpy plain versions and of the JAX package's numpy path, at odd shapes
with one and three channels; the plain versions equal to the JAX numpy path
bit for bit; native decoding equal to PIL for the PNG and JPEG it takes,
and PIL for what it declines; a failed build raises, it never falls back;
``build-native``."""

import ctypes
import io
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from jimm_tpu.data import preprocess as jax_pre
from jimm_tpu.data import records as jax_records
from jimm_tpu_torch.data import native, preprocess, records, tfrecord

REPO = pathlib.Path(__file__).resolve().parent.parent
#: the native path's agreement with numpy (float32 rounding in another
#: order: x * (1/255) for x / 255, * (1/std) for / std)
NATIVE_ATOL = 1e-6
#: (batch, height, width) of the odd shapes, each with 1 and 3 channels
SHAPES = [(2, 1, 1), (3, 17, 23), (2, 288, 320)]
NORMS = [(preprocess.CLIP_MEAN, preprocess.CLIP_STD),
         (preprocess.IMAGENET_MEAN, preprocess.IMAGENET_STD),
         (0.0, 1.0)]


@pytest.fixture
def jax_numpy(monkeypatch):
    """The JAX package's preprocessing on its numpy path."""
    monkeypatch.setattr(jax_pre, "_LIB", None)
    return jax_pre


def _images(shape, channels, dtype, seed=0):
    rng = np.random.default_rng(seed)
    full = (*shape, channels)
    if dtype == np.uint8:
        return rng.integers(0, 256, full, dtype=np.uint8)
    return rng.uniform(0, 1, full).astype(np.float32)


def _close(native_out, plain_out, jax_out):
    assert native_out.dtype == plain_out.dtype == jax_out.dtype == np.float32
    assert native_out.shape == plain_out.shape == jax_out.shape
    np.testing.assert_array_equal(plain_out, jax_out)
    np.testing.assert_allclose(native_out, plain_out, rtol=0,
                               atol=NATIVE_ATOL)


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [np.uint8, np.float32],
                         ids=["u8", "f32"])
def test_normalize_matches_numpy(jax_numpy, shape, channels, dtype):
    images = _images(shape, channels, dtype)
    for mean, std in NORMS:
        if channels == 1 and np.ndim(mean):
            mean, std = mean[:1], std[:1]
        _close(preprocess.to_float_normalized(images, mean, std),
               preprocess.to_float_normalized_plain(images, mean, std),
               jax_numpy.to_float_normalized(images, mean, std))


RESIZES = {(1, 1): [(4, 4), (1, 3)], (17, 23): [(32, 32), (8, 40), (1, 1)],
           (288, 320): [(256, 256), (224, 224)]}


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_resize_matches_numpy(jax_numpy, shape, channels):
    images = _images(shape, channels, np.float32, seed=1)
    for size in RESIZES[shape[1:]]:
        _close(preprocess.resize_bilinear(images, size),
               preprocess.resize_bilinear_plain(images, size),
               jax_numpy.resize_bilinear(images, size))


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_center_crop_matches_numpy(jax_numpy, shape, channels):
    images = _images(shape, channels, np.float32, seed=2)
    h, w = shape[1:]
    for size in {(h, w), (max(1, h // 2), max(1, w - 3)), (1, 1)}:
        got = preprocess.center_crop(images, size)
        np.testing.assert_array_equal(
            got, preprocess.center_crop_plain(images, size))
        np.testing.assert_array_equal(got, jax_numpy.center_crop(images,
                                                                 size))
    for crop in (preprocess.center_crop, preprocess.center_crop_plain):
        with pytest.raises(ValueError, match="larger than image"):
            crop(images, (h + 1, w))


@pytest.mark.parametrize("crop", [False, True], ids=["resize", "crop"])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_preprocess_batch_matches_numpy(jax_numpy, shape, channels, crop):
    images = _images(shape, channels, np.uint8, seed=3)
    mean, std = ((preprocess.CLIP_MEAN[:channels], preprocess.CLIP_STD[:channels])
                 if channels == 3 else (0.5, 0.5))
    size = 256 if shape[1] == 288 else 7
    kw = dict(image_size=size, mean=mean, std=std, crop=crop)
    _close(preprocess.preprocess_batch(images, **kw),
           preprocess.preprocess_batch_plain(images, **kw),
           jax_numpy.preprocess_batch(images, **kw))


def test_threads_do_not_change_the_result(monkeypatch):
    images = _images((5, 33, 47), 3, np.uint8, seed=4)
    many = preprocess.preprocess_batch(images, image_size=20)
    monkeypatch.setenv("JIMM_PREPROCESS_THREADS", "1")
    assert native.threads() == 1
    np.testing.assert_array_equal(
        preprocess.preprocess_batch(images, image_size=20), many)


def test_native_calls_release_the_interpreter_lock():
    # a CDLL (not a PyDLL) drops the GIL for the length of each call: what
    # lets a prefetch thread preprocess while the main thread dispatches
    lib = native.load()
    assert isinstance(lib, ctypes.CDLL) and not isinstance(lib, ctypes.PyDLL)
    assert native.codecs_available()  # jpeglib.h and png.h are here


def test_crc32c_matches_its_python_version():
    rng = np.random.default_rng(7)
    for n in (0, 1, 7, 8, 9, 1000, 276480):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert tfrecord.crc32c(data) == tfrecord.crc32c_plain(data)
    assert tfrecord.crc32c(b"123456789") == 0xE3069283


def _encoded(arr, fmt, mode, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, format=fmt, **kw)
    return buf.getvalue()


DECODE_CASES = {"png_rgb": ("PNG", "RGB", {}),
                "png_gray": ("PNG", "L", {}),
                "jpeg_rgb": ("JPEG", "RGB", {"quality": 90}),
                "jpeg_gray": ("JPEG", "L", {"quality": 90}),
                "jpeg_progressive": ("JPEG", "RGB", {"progressive": True}),
                "jpeg_444": ("JPEG", "RGB", {"subsampling": 0})}


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_native_decode_equals_pil(case):
    fmt, mode, kw = DECODE_CASES[case]
    rng = np.random.default_rng(5)
    for shape in ((17, 23), (288, 320)):
        arr = rng.integers(0, 256, shape + ((3,) if mode == "RGB" else ()),
                           dtype=np.uint8)
        data = _encoded(arr, fmt, mode, **kw)
        got = preprocess.decode_image_native(data)
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        assert got is not None and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(records.decode_image(data), want)


def test_declined_images_go_to_pil():
    rng = np.random.default_rng(6)
    rgba = _encoded(rng.integers(0, 256, (9, 11, 4), dtype=np.uint8), "PNG",
                    "RGBA")
    assert preprocess.decode_image_native(rgba) is None  # alpha: PIL's
    want = np.asarray(Image.open(io.BytesIO(rgba)).convert("RGB"))
    np.testing.assert_array_equal(records.decode_image(rgba), want)
    np.testing.assert_array_equal(jax_records.decode_image(rgba), want)
    assert preprocess.decode_image_native(b"\x89PNG junk") is None
    with pytest.raises(ValueError, match="neither PNG/JPEG"):
        records.decode_image(b"\x00\x01")


def _run(code: str, **env) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env={**os.environ, **env}, capture_output=True,
                          text=True, timeout=300)


def test_failed_build_raises_and_never_falls_back():
    # /bin/false as the compiler: a build of its own (the hash holds the
    # compiler), so no cached library, and the compile fails
    proc = _run("import numpy as np\n"
                "from jimm_tpu_torch.data import preprocess\n"
                "preprocess.to_float_normalized("
                "np.zeros((1, 2, 2, 3), np.uint8))\n"
                "print('fell back')\n", CXX="/bin/false")
    assert proc.returncode != 0
    assert "fell back" not in proc.stdout
    assert "RuntimeError: native preprocessing: /bin/false" in proc.stderr
    assert "failed (1)" in proc.stderr


def test_build_native_command():
    proc = _run("from jimm_tpu_torch.cli import main\n"
                "raise SystemExit(main(['build-native']))\n")
    assert proc.returncode == 0, proc.stderr
    line = proc.stdout.strip().splitlines()[-1]
    assert '"status": "found"' in line and '"codecs": true' in line
    assert str(native.build()) in line
    proc = _run("from jimm_tpu_torch.cli import main\n"
                "raise SystemExit(main(['build-native']))\n",
                CXX="/bin/false")
    assert proc.returncode == 1
    assert "build-native: native preprocessing" in proc.stderr
