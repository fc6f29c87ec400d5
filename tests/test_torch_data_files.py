"""The port's file readers and writers against the JAX package's:
``data/tfrecord.py`` (CRC32C, framing, ``tf.train.Example``),
``data/records.py`` (the batch builders), ``data/webdataset.py``,
``data/preprocess.py`` and the ``prepare-data`` command. Shards written by
either package are byte-identical and read back the same; batches are
equal bit for bit, the JAX package's native path given the port's build of
the same ``native/`` sources (the numpy paths are held to each other in
``tests/test_torch_native.py``)."""

import io
import json
import pathlib
import tarfile

import numpy as np
import pytest
from PIL import Image

from jimm_tpu import cli as jax_cli
from jimm_tpu.data import preprocess as jax_pre
from jimm_tpu.data import records as jax_records
from jimm_tpu.data import tfrecord as jax_tfrecord
from jimm_tpu.data import webdataset as jax_wds
from jimm_tpu_torch import cli
from jimm_tpu_torch.data import (native, preprocess, records, tfrecord,
                                  webdataset)

#: the JAX package's batches equal the port's bit for bit when both run
#: the same native library
BATCH_ATOL = 0.0
#: (data, CRC32C): RFC 3720 B.4's vectors and the usual check value
CRC_VECTORS = [(b"", 0), (b"123456789", 0xE3069283),
               (bytes(32), 0x8A9136AA), (b"\xff" * 32, 0x62A8AB43),
               (bytes(range(32)), 0x46DD794E),
               (bytes(range(31, -1, -1)), 0x113FDB5C)]


@pytest.fixture(autouse=True)
def same_native_library(monkeypatch):
    """The JAX package's preprocessing on the port's native library: both
    packages then run the same C++ on the same inputs."""
    monkeypatch.setattr(jax_pre, "_LIB", native.load())


@pytest.mark.parametrize("data,want", CRC_VECTORS,
                         ids=[str(i) for i in range(len(CRC_VECTORS))])
def test_crc32c_known_vectors(data, want):
    assert tfrecord.crc32c(data) == want == jax_tfrecord._crc32c_py(data)
    assert tfrecord.masked_crc32c(data) == jax_tfrecord.masked_crc32c(data)


def test_crc32c_matches_jax_on_random_bytes():
    rng = np.random.default_rng(0)
    for n in (1, 7, 1000, 4099):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert tfrecord.crc32c(data) == jax_tfrecord.crc32c(data)


def _images(rng, sizes):
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            for h, w in sizes]


SIZES = [(8, 8), (12, 20), (20, 12), (16, 16), (9, 27)]


def _pairs(kind, rng):
    images = _images(rng, SIZES)
    if kind == "classification":
        return [(im, i % 3) for i, im in enumerate(images)]
    return [(im, list(range(1, 3 + i))) for i, im in enumerate(images)]


WRITERS = {"classification": ("write_classification_records",),
           "image_text": ("write_image_text_records",)}


@pytest.mark.parametrize("encoding", ["raw", "png"])
@pytest.mark.parametrize("kind", ["classification", "image_text"])
def test_shards_byte_identical_and_cross_read(tmp_path, kind, encoding):
    pairs = _pairs(kind, np.random.default_rng(1))
    name = WRITERS[kind][0]
    ours, theirs = tmp_path / "port.tfrecord", tmp_path / "jax.tfrecord"
    assert getattr(records, name)(ours, pairs, encoding=encoding) == 5
    getattr(jax_records, name)(theirs, pairs, encoding=encoding)
    assert ours.read_bytes() == theirs.read_bytes()
    # each reads the other's file (with the CRCs checked) to the same
    # examples
    got = [tfrecord.decode_example(r)
           for r in tfrecord.read_tfrecord(theirs, verify=True)]
    want = [jax_tfrecord.decode_example(r)
            for r in jax_tfrecord.read_tfrecord(ours, verify=True)]
    assert got == want and len(got) == 5


def test_example_codec_matches_jax():
    feats = {"image": b"\x00\x01", "names": ["a", "bc"], "label": 7,
             "neg": [-1, 2**40, -(2**63)], "score": [0.5, -1.25],
             "one": np.float32(3.0), "n": np.int64(4)}
    payload = tfrecord.encode_example(feats)
    assert payload == jax_tfrecord.encode_example(feats)
    assert tfrecord.decode_example(payload) == \
        jax_tfrecord.decode_example(payload)
    with pytest.raises(ValueError, match="is empty"):
        tfrecord.encode_example({"x": []})


def _corrupt(path: pathlib.Path, how: str) -> None:
    data = bytearray(path.read_bytes())
    if how == "length_crc":
        data[0] ^= 1
    elif how == "record_crc":
        data[20] ^= 1
    elif how == "truncated_header":
        data = data[:7]
    elif how == "truncated_body":
        data = data[:20]
    elif how == "truncated_crc":
        n = int.from_bytes(data[:8], "little")
        data = data[:12 + n + 2]
    path.write_bytes(bytes(data))


@pytest.mark.parametrize("how", ["length_crc", "record_crc",
                                 "truncated_header", "truncated_body",
                                 "truncated_crc"])
def test_corruption_is_refused_as_jax_refuses_it(tmp_path, how):
    path = tmp_path / "bad.tfrecord"
    tfrecord.write_tfrecord(path, [b"x" * 40, b"y" * 10])
    _corrupt(path, how)
    with pytest.raises(ValueError) as ours:
        list(tfrecord.read_tfrecord(path, verify=True))
    with pytest.raises(ValueError) as theirs:
        list(jax_tfrecord.read_tfrecord(path, verify=True))
    assert str(ours.value) == str(theirs.value)
    if how == "record_crc":  # without verify the body is taken as it is
        assert len(list(tfrecord.read_tfrecord(path, verify=False))) == 2


def test_decode_image_shape_wins_over_magic():
    raw = np.zeros((2, 3, 3), np.uint8)
    raw.flat[:2] = (0xFF, 0xD8)  # raw pixels that start like a JPEG
    got = records.decode_image(raw.tobytes(), [2, 3, 3])
    np.testing.assert_array_equal(got, raw)
    np.testing.assert_array_equal(
        got, jax_records.decode_image(raw.tobytes(), [2, 3, 3]))
    with pytest.raises(ValueError, match="neither PNG/JPEG"):
        records.decode_image(b"\x00\x01")


def _assert_batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g_img, g_rest = g
        w_img, w_rest = w
        g_img = g_img if isinstance(g_img, tuple) else (g_img,)
        w_img = w_img if isinstance(w_img, tuple) else (w_img,)
        for a, b in zip(g_img, w_img):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=0, atol=BATCH_ATOL)
        np.testing.assert_array_equal(g_rest, w_rest)
        assert g_rest.dtype == w_rest.dtype


BUILDERS = {
    "classification": ("classification_batches", "classification",
                       dict(image_size=16)),
    "image_text": ("image_text_batches", "image_text",
                   dict(image_size=16, seq_len=6)),
    "naflex": ("naflex_image_text_batches", "image_text",
               dict(patch_size=4, max_num_patches=12, seq_len=6)),
}


@pytest.mark.parametrize("encoding", ["raw", "png"])
@pytest.mark.parametrize("builder", list(BUILDERS))
def test_batches_match_jax(tmp_path, builder, encoding):
    """Two shards, five examples of mixed sizes, batch 3 without dropping
    the remainder, CLIP's normalization; then a repeating, shuffled,
    sharded stream with a skip."""
    name, kind, kw = BUILDERS[builder]
    rng = np.random.default_rng(2)
    writer = WRITERS[kind][0]
    for i in range(2):
        getattr(records, writer)(tmp_path / f"part-{i}.tfrecord",
                                 _pairs(kind, rng), encoding=encoding)
    norm = dict(mean=preprocess.CLIP_MEAN, std=preprocess.CLIP_STD)
    once = dict(repeat=False, drop_remainder=False)
    _assert_batches_equal(
        getattr(records, name)(str(tmp_path), 3, **kw, **norm, **once),
        getattr(jax_records, name)(str(tmp_path), 3, **kw, **norm, **once))
    stream = dict(shuffle_buffer=4, seed=3, shard_index=1, shard_count=2,
                  skip_examples=1)
    ours = getattr(records, name)(str(tmp_path / "*.tfrecord"), 2, **kw,
                                  **stream)
    theirs = getattr(jax_records, name)(str(tmp_path / "*.tfrecord"), 2,
                                        **kw, **stream)
    _assert_batches_equal([next(ours) for _ in range(6)],
                          [next(theirs) for _ in range(6)])


def test_resolve_paths_matches_jax(tmp_path):
    for name in ("b.tfrecord", "a.tfrecord", "c.tfrecord-00001", "x.txt"):
        (tmp_path / name).write_bytes(b"")
    for data in (str(tmp_path), str(tmp_path / "*.tfrecord"),
                 str(tmp_path / "a.tfrecord"),
                 [tmp_path / "b.tfrecord", tmp_path / "a.tfrecord"]):
        assert records.resolve_paths(data) == jax_records.resolve_paths(data)
    with pytest.raises(FileNotFoundError, match="no tfrecord files"):
        records.resolve_paths(str(tmp_path / "*.none"))


PREPROCESS_CASES = {
    "u8_square": ((2, 24, 24, 3), np.uint8, 24, False),
    "u8_resize": ((2, 20, 30, 3), np.uint8, 16, False),
    "u8_crop": ((2, 20, 30, 3), np.uint8, 16, True),
    "u8_crop_tall": ((1, 33, 17, 3), np.uint8, 16, True),
    "u8_crop_square": ((1, 20, 20, 3), np.uint8, 16, True),
    "f32_crop": ((2, 18, 26, 3), np.float32, 12, True),
    "f32_resize": ((2, 18, 26, 3), np.float32, 12, False),
}


@pytest.mark.parametrize("case", list(PREPROCESS_CASES))
def test_preprocess_batch_matches_jax(case):
    shape, dtype, size, crop = PREPROCESS_CASES[case]
    rng = np.random.default_rng(4)
    images = (rng.integers(0, 256, shape, dtype=np.uint8) if dtype == np.uint8
              else rng.uniform(0, 1, shape).astype(np.float32))
    for mean, std in ((preprocess.CLIP_MEAN, preprocess.CLIP_STD),
                      (preprocess.SIGLIP_MEAN, preprocess.SIGLIP_STD)):
        got = preprocess.preprocess_batch(images, image_size=size, mean=mean,
                                          std=std, crop=crop)
        want = jax_pre.preprocess_batch(images, image_size=size, mean=mean,
                                        std=std, crop=crop)
        assert got.shape == want.shape == (shape[0], size, size, 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=BATCH_ATOL)
    for name in ("IMAGENET_MEAN", "IMAGENET_STD", "CLIP_MEAN", "CLIP_STD",
                 "SIGLIP_MEAN", "SIGLIP_STD"):
        np.testing.assert_array_equal(getattr(preprocess, name),
                                      getattr(jax_pre, name))


def test_center_crop_refuses_a_larger_crop():
    with pytest.raises(ValueError, match="larger than image"):
        preprocess.center_crop(np.zeros((1, 4, 4, 3), np.float32), (5, 4))


def _wds_examples(rng):
    return [{"image": im, "label": i % 4, "tokens": [i + 1, i + 2]}
            for i, im in enumerate(_images(rng, SIZES))]


def test_webdataset_shard_byte_identical_and_read_alike(tmp_path):
    examples = _wds_examples(np.random.default_rng(5))
    ours, theirs = tmp_path / "a" / "s0.tar", tmp_path / "b" / "s0.tar"
    ours.parent.mkdir()
    theirs.parent.mkdir()
    assert webdataset.write_wds_shard(ours, examples) == 5
    jax_wds.write_wds_shard(theirs, examples)
    assert ours.read_bytes() == theirs.read_bytes()
    with pytest.raises(ValueError, match="ENCODED images"):
        webdataset.write_wds_shard(tmp_path / "raw.tar", examples,
                                   encoding="raw")
    once = dict(repeat=False, drop_remainder=False)
    _assert_batches_equal(
        webdataset.wds_classification_batches(str(ours.parent), 2,
                                              image_size=8, **once),
        jax_wds.wds_classification_batches(str(ours.parent), 2,
                                           image_size=8, **once))
    _assert_batches_equal(
        webdataset.wds_image_text_batches(str(ours), 3, image_size=8,
                                          seq_len=4, **once),
        jax_wds.wds_image_text_batches(str(ours), 3, image_size=8,
                                       seq_len=4, **once))


def test_webdataset_grouping_and_stream_match_jax(tmp_path):
    """Members grouped by key up to the last extension, unknown extensions
    and keys without an image skipped, a gzip shard read; the repeating
    shuffled sharded stream equal to JAX's."""
    path = tmp_path / "s.tar.gz"
    png = io.BytesIO()
    Image.fromarray(np.full((4, 4, 3), 9, np.uint8)).save(png, format="PNG")
    with tarfile.open(path, "w:gz") as tf:
        for name, data in (("d/a.b.png", png.getvalue()), ("d/a.b.cls", b"3"),
                           ("d/a.b.txt", b"x"), ("d/c.json", b'{"tokens":[1]}'),
                           ("d/e.PNG", png.getvalue()),
                           ("d/e.json", b'{"tokens":[4,5]}')):
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    kw = dict(shuffle_buffer=2, seed=1, shard_index=0, shard_count=1)
    ours = webdataset.iter_wds_examples([str(path)], **kw)
    theirs = jax_wds.iter_wds_examples([str(path)], **kw)
    got = [next(ours) for _ in range(5)]
    assert got == [next(theirs) for _ in range(5)]
    assert {tuple(sorted(ex)) for ex in got} == {("image", "label"),
                                                 ("image", "tokens")}
    assert webdataset.resolve_tar_paths(str(tmp_path)) == \
        jax_wds.resolve_tar_paths(str(tmp_path))


def _png(path: pathlib.Path, rng, size=(6, 10)) -> None:
    Image.fromarray(rng.integers(0, 256, (*size, 3), dtype=np.uint8)).save(
        path)


def _classification_src(root: pathlib.Path) -> pathlib.Path:
    rng = np.random.default_rng(6)
    src = root / "src"
    for cls, n in (("zebra", 2), ("ant", 3), ("moth", 1)):
        (src / cls).mkdir(parents=True)
        for i in range(n):
            _png(src / cls / f"{i}.png", rng)
        (src / cls / "notes.txt").write_text("skipped")
    return src


def _contrastive_src(root: pathlib.Path, long_len: int = 9) -> tuple:
    rng = np.random.default_rng(7)
    src = root / "src"
    src.mkdir()
    lines = []
    for i in range(5):
        _png(src / f"im{i}.png", rng, (8, 5 + i))
        ids = list(range(1, 3 + i)) if i != 2 else list(range(1, long_len))
        lines.append(f"im{i}.png\t" + " ".join(map(str, ids)))
    (root / "caps.tsv").write_text("\n".join(lines[:3] + [""] + lines[3:]))
    return src, root / "caps.tsv"


def _tree(d: pathlib.Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


@pytest.mark.parametrize("task", ["classification", "contrastive"])
def test_prepare_data_writes_jax_shards(tmp_path, capsys, task):
    """The same shards (rotated at --shard-size) and classes.json as JAX's
    ``prepare-data``; a caption longer than --seq-len keeps its final
    token."""
    if task == "classification":
        src, extra = _classification_src(tmp_path), []
    else:
        src, caps = _contrastive_src(tmp_path)
        extra = ["--task", "contrastive", "--captions", str(caps),
                 "--seq-len", "5"]
    argv = ["prepare-data", str(src)]
    assert cli.main(argv + [str(tmp_path / "ours"), "--shard-size", "2",
                            *extra]) == 0
    ours_said = capsys.readouterr().out
    assert jax_cli.main(argv + [str(tmp_path / "theirs"), "--shard-size",
                                "2", *extra]) == 0
    theirs_said = capsys.readouterr().out
    assert ours_said.replace("ours", "theirs") == theirs_said
    assert _tree(tmp_path / "ours") == _tree(tmp_path / "theirs")
    examples = [tfrecord.decode_example(r) for p in
                sorted((tmp_path / "ours").glob("*.tfrecord"))
                for r in tfrecord.read_tfrecord(p)]
    if task == "classification":
        assert json.loads((tmp_path / "ours" / "classes.json").read_text()) \
            == {"ant": 0, "moth": 1, "zebra": 2}
        assert [ex["label"] for ex in examples] == [[0]] * 3 + [[1]] + [[2]] * 2
    else:
        assert examples[2]["tokens"] == [1, 2, 3, 4, 8]
        assert not (tmp_path / "ours" / "classes.json").exists()


def _refusal_case(case: str, root: pathlib.Path) -> list[str]:
    """The arguments of one refused ``prepare-data`` run, its inputs made
    under ``root``."""
    out = str(root / "out")
    if case == "stale_shards":
        src = _classification_src(root)
        (root / "out").mkdir()
        (root / "out" / "part-00003.tfrecord").write_bytes(b"")
        return [str(src), out]
    if case == "no_class_dirs":
        (root / "src").mkdir()
        return [str(root / "src"), out]
    if case == "no_images":
        (root / "src" / "empty").mkdir(parents=True)
        return [str(root / "src"), out]
    if case == "no_captions":
        (root / "src").mkdir()
        return [str(root / "src"), out, "--task", "contrastive"]
    src, caps = _contrastive_src(root)
    if case == "text_caption":
        caps.write_text("im0.png\ta photo of a cat\n")
    elif case == "empty_caption":
        caps.write_text("im0.png\t   \n")
    return [str(src), out, "--task", "contrastive", "--captions", str(caps)]


@pytest.mark.parametrize("case", ["stale_shards", "no_class_dirs",
                                  "no_images", "no_captions", "text_caption",
                                  "empty_caption"])
def test_prepare_data_refusals_match_jax(tmp_path, case):
    argv = _refusal_case(case, tmp_path)
    with pytest.raises(SystemExit) as ours:
        cli.main(["prepare-data", *argv])
    with pytest.raises(SystemExit) as theirs:
        jax_cli.main(["prepare-data", *argv])
    assert str(ours.value) == str(theirs.value)
    assert not (tmp_path / "out" / "classes.json").exists()
