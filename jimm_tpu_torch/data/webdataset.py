"""WebDataset-style tar shards as a second input format; the port's copy of
``jimm_tpu/data/webdataset.py``.

A shard is a plain POSIX tar whose members are grouped by key — the filename
up to the LAST extension. Per example:

- ``<key>.jpg`` / ``.jpeg`` / ``.png``: encoded image bytes (required, so
  reading a shard's images needs Pillow)
- ``<key>.cls``: ascii integer class label (classification)
- ``<key>.json``: JSON object with a ``tokens`` list of int ids
  (contrastive; pre-tokenized)

Batches are identical to ``jimm_tpu_torch.data.records``': the decode /
resize / normalize / pad code is records', only the container differs.
Sequential tar read (no index needed), sharding by example stride, buffer
shuffle, epoch repeat: the records loader semantics.
"""

from __future__ import annotations

import glob as _glob
import io
import json
import random
import tarfile
from pathlib import Path
from typing import Iterator, Sequence

import numpy as np

from jimm_tpu_torch.data.preprocess import SIGLIP_MEAN, SIGLIP_STD
from jimm_tpu_torch.data.records import (classification_batches_from,
                                         encode_image_feature,
                                         image_text_batches_from)

_IMAGE_EXTS = {".jpg", ".jpeg", ".png"}


def resolve_tar_paths(data: str | Sequence[str | Path]) -> list[str]:
    """Glob pattern, directory, single tar, or explicit list -> tar files.
    Directory scans match ``*.tar*`` so compressed shards (``.tar.gz``,
    ``.tar.zst`` ...) route here too — `_iter_tar` reads any compression."""
    if isinstance(data, (str, Path)):
        p = Path(data)
        if p.is_dir():
            paths = sorted(str(q) for q in p.glob("*.tar*"))
        elif any(ch in str(data) for ch in "*?["):
            paths = sorted(_glob.glob(str(data)))
        else:
            paths = [str(p)]
    else:
        paths = [str(p) for p in data]
    if not paths:
        raise FileNotFoundError(f"no tar shards match {data!r}")
    return paths


def _split_key(name: str) -> tuple[str, str]:
    base = name.rsplit("/", 1)[-1]
    _, dot, ext = base.rpartition(".")
    return (name[: len(name) - len(ext) - 1], "." + ext.lower()) if dot \
        else (name, "")


def _iter_tar(path: str) -> Iterator[dict]:
    """Group consecutive members sharing a key into one example dict in the
    records schema ({"image": [bytes], "label": [int], "tokens": [ids]})."""
    with tarfile.open(path, "r|*") as tf:  # streaming read, any compression
        cur_key, cur = None, {}
        for member in tf:
            if not member.isfile():
                continue
            key, ext = _split_key(member.name)
            if key != cur_key:
                if cur_key is not None and "image" in cur:
                    yield cur
                cur_key, cur = key, {}
            data = tf.extractfile(member).read()
            if ext in _IMAGE_EXTS:
                cur["image"] = [data]
            elif ext == ".cls":
                cur["label"] = [int(data.decode().strip())]
            elif ext == ".json":
                tokens = json.loads(data.decode()).get("tokens")
                if tokens is not None:
                    cur["tokens"] = [int(t) for t in tokens]
            # unknown extensions are carried metadata: ignored
        if cur_key is not None and "image" in cur:
            yield cur


def iter_wds_examples(paths: Sequence[str], *, repeat: bool = True,
                      shuffle_buffer: int = 0, seed: int = 0,
                      shard_index: int = 0, shard_count: int = 1
                      ) -> Iterator[dict]:
    """records.iter_examples semantics over tar shards."""
    rng = random.Random(seed)
    buf: list[dict] = []
    while True:
        files = list(paths)
        if shuffle_buffer:
            rng.shuffle(files)
        idx = 0
        for path in files:
            for ex in _iter_tar(path):
                idx += 1
                if (idx - 1) % shard_count != shard_index:
                    continue
                if shuffle_buffer:
                    buf.append(ex)
                    if len(buf) >= shuffle_buffer:
                        yield buf.pop(rng.randrange(len(buf)))
                else:
                    yield ex
        if not repeat:
            break
    while buf:
        yield buf.pop(rng.randrange(len(buf)))


def wds_image_text_batches(data, batch_size: int, *, image_size: int,
                           seq_len: int, pad_id: int = 0, mean=SIGLIP_MEAN,
                           std=SIGLIP_STD, shuffle_buffer: int = 0,
                           seed: int = 0, repeat: bool = True,
                           shard_index: int = 0, shard_count: int = 1,
                           skip_examples: int = 0,
                           drop_remainder: bool = True
                           ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Contrastive batches from tar shards — records' batch builder over
    the tar example stream."""
    examples = iter_wds_examples(resolve_tar_paths(data), repeat=repeat,
                                 shuffle_buffer=shuffle_buffer, seed=seed,
                                 shard_index=shard_index,
                                 shard_count=shard_count)
    return image_text_batches_from(
        examples, batch_size, image_size=image_size, seq_len=seq_len,
        pad_id=pad_id, mean=mean, std=std, skip_examples=skip_examples,
        drop_remainder=drop_remainder)


def wds_classification_batches(data, batch_size: int, *, image_size: int,
                               mean=SIGLIP_MEAN, std=SIGLIP_STD,
                               shuffle_buffer: int = 0, seed: int = 0,
                               repeat: bool = True, shard_index: int = 0,
                               shard_count: int = 1, skip_examples: int = 0,
                               drop_remainder: bool = True
                               ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Classification batches from tar shards — records' batch builder."""
    examples = iter_wds_examples(resolve_tar_paths(data), repeat=repeat,
                                 shuffle_buffer=shuffle_buffer, seed=seed,
                                 shard_index=shard_index,
                                 shard_count=shard_count)
    return classification_batches_from(
        examples, batch_size, image_size=image_size, mean=mean, std=std,
        skip_examples=skip_examples, drop_remainder=drop_remainder)


# ---------------------------------------------------------------------------
# Writing (dataset preparation tooling)
# ---------------------------------------------------------------------------

def write_wds_shard(path: str | Path, examples: Sequence[dict], *,
                    encoding: str = "png") -> int:
    """[{"image": array|bytes, "label": int | "tokens": [ids]}, ...] -> one
    tar shard. Returns the example count."""
    with tarfile.open(path, "w") as tf:
        for i, ex in enumerate(examples):
            key = f"{i:08d}"
            feats = encode_image_feature(ex["image"], encoding=encoding)
            img_ext = ".png" if feats["image"][:4] == b"\x89PNG" else (
                ".jpg" if feats["image"][:2] == b"\xff\xd8" else ".png")
            if "shape" in feats:
                raise ValueError("webdataset shards hold ENCODED images; "
                                 "use encoding='png' or 'jpeg'")
            _add(tf, key + img_ext, feats["image"])
            if "label" in ex:
                _add(tf, key + ".cls", str(int(ex["label"])).encode())
            if "tokens" in ex:
                _add(tf, key + ".json", json.dumps(
                    {"tokens": [int(t) for t in ex["tokens"]]}).encode())
    return len(examples)


def _add(tf: tarfile.TarFile, name: str, data: bytes) -> None:
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))
