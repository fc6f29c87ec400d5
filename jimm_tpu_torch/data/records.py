"""Input pipeline over TFRecord files on disk; the port's copy of
``jimm_tpu/data/records.py``: decode (native libjpeg/libpng, PIL for what
the C side declines, or raw) -> native multithreaded resize/normalize
(``jimm_tpu_torch.data.preprocess``) -> numpy batches, and the writers that
make such shards. Built on the zero-dependency codec in
``jimm_tpu_torch.data.tfrecord``.

Record schema (standard TF conventions):
- ``image``: one PNG/JPEG-encoded image, OR raw uint8 bytes with an
  accompanying ``shape`` int64 feature [h, w, c]
- ``tokens``: pre-tokenized int64 caption ids (contrastive pairs)
- ``label``: int64 class id (classification)

PNG/JPEG bytes decode natively where the library was built with the
codecs; what it declines needs Pillow (imported when such an image is met).
Raw records need nothing beyond numpy.
"""

from __future__ import annotations

import glob as _glob
import io
import random
from pathlib import Path
from typing import Any, Iterator, Sequence

import numpy as np

from jimm_tpu_torch.data.naflex import patchify_naflex
from jimm_tpu_torch.data.preprocess import (SIGLIP_MEAN, SIGLIP_STD,
                                            decode_image_native,
                                            resize_bilinear,
                                            to_float_normalized)
from jimm_tpu_torch.data.tfrecord import (TFRecordWriter, decode_example,
                                          encode_example, read_tfrecord)

_PNG_MAGIC = b"\x89PNG"
_JPEG_MAGIC = b"\xff\xd8"


def resolve_paths(data: str | Sequence[str | Path]) -> list[str]:
    """A glob pattern, directory, single file, or explicit list -> file list."""
    if isinstance(data, (str, Path)):
        p = Path(data)
        if p.is_dir():
            paths = sorted(str(q) for q in p.glob("*.tfrecord*"))
        elif any(ch in str(data) for ch in "*?["):
            paths = sorted(_glob.glob(str(data)))
        else:
            paths = [str(p)]
    else:
        paths = [str(p) for p in data]
    if not paths:
        raise FileNotFoundError(f"no tfrecord files match {data!r}")
    return paths


def decode_image(value: bytes, shape: Sequence[int] | None = None
                 ) -> np.ndarray:
    """Encoded (PNG/JPEG) or raw-uint8 image bytes -> uint8 [H, W, C].

    An explicit ``shape`` wins over magic-number sniffing: raw pixel data can
    legitimately begin with the JPEG/PNG magic bytes (e.g. a white-ish
    top-left pixel gives ``\\xff\\xd8``), and records written with
    ``encoding="raw"`` always carry ``shape``."""
    if shape:
        h, w, c = (int(s) for s in shape)
        return np.frombuffer(value, np.uint8).reshape(h, w, c)
    if value[:4] == _PNG_MAGIC or value[:2] == _JPEG_MAGIC:
        # native libjpeg/libpng (no PIL import); PIL takes the image
        # classes the C side declines (alpha, palette, CMYK, 16-bit)
        image = decode_image_native(value)
        if image is not None:
            return image
        from PIL import Image
        return np.asarray(Image.open(io.BytesIO(value)).convert("RGB"))
    raise ValueError("image bytes are neither PNG/JPEG nor raw-with-'shape'")


def iter_examples(paths: Sequence[str], *, repeat: bool = True,
                  shuffle_buffer: int = 0, seed: int = 0,
                  shard_index: int = 0, shard_count: int = 1,
                  verify: bool = False) -> Iterator[dict[str, list]]:
    """Decoded examples, optionally epoch-repeating and buffer-shuffled.
    Multi-process sharding takes every ``shard_count``-th example."""
    rng = random.Random(seed)
    buf: list[dict[str, list]] = []
    while True:
        files = list(paths)
        if shuffle_buffer:
            rng.shuffle(files)
        idx = 0
        for path in files:
            for record in read_tfrecord(path, verify=verify):
                idx += 1
                if (idx - 1) % shard_count != shard_index:
                    continue
                ex = decode_example(record)
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


def prep_image(ex: dict[str, list], image_size: int) -> np.ndarray:
    """One decoded example -> float32 [S, S, 3] in [0, 1] (resized if
    needed, NOT yet mean/std-normalized)."""
    return _unit_resized(decode_image(ex["image"][0], ex.get("shape"))[None],
                         image_size)[0]


def _unit_resized(images: np.ndarray, image_size: int) -> np.ndarray:
    """uint8 [B,H,W,C] -> float32 in [0, 1] at [B,S,S,C]."""
    return resize_bilinear(images.astype(np.float32) / 255.0,
                           (image_size, image_size))


def pad_tokens(tokens: Sequence[int], seq_len: int, pad_id: int = 0
               ) -> np.ndarray:
    """Token ids -> int32 [seq_len], truncated/right-padded with
    ``pad_id``."""
    out = np.full((seq_len,), pad_id, np.int32)
    t = tokens[:seq_len]
    out[:len(t)] = t
    return out


def _image_batch(examples: list[dict[str, list]], image_size: int,
                 mean, std) -> np.ndarray:
    images = [decode_image(ex["image"][0], ex.get("shape"))
              for ex in examples]
    if len({im.shape for im in images}) == 1:
        # one resize call over the batch, threaded over its images: per
        # image the arithmetic of prep_image
        batch = _unit_resized(np.stack(images), image_size)
    else:
        batch = np.stack([_unit_resized(im[None], image_size)[0]
                          for im in images])
    return to_float_normalized(batch, mean, std)


def skip(examples: Iterator, n: int) -> None:
    """Fast-forward the raw example stream (protobuf parse only — no image
    decode/resize) for deterministic resume at step N."""
    for _ in range(n):
        next(examples, None)


def _chunks(examples: Iterator, batch_size: int, drop_remainder: bool
            ) -> Iterator[list]:
    """Group a (possibly finite) example stream into batch-sized lists.
    ``drop_remainder=False`` yields the short final chunk of a non-repeating
    pass — evaluation must count every example; training wants fixed
    shapes."""
    while True:
        chunk = []
        for ex in examples:
            chunk.append(ex)
            if len(chunk) == batch_size:
                break
        if not chunk or (len(chunk) < batch_size and drop_remainder):
            return
        yield chunk
        if len(chunk) < batch_size:
            return


def image_text_batches(data: str | Sequence[str], batch_size: int, *,
                       image_size: int, seq_len: int, pad_id: int = 0,
                       mean=SIGLIP_MEAN, std=SIGLIP_STD,
                       shuffle_buffer: int = 0, seed: int = 0,
                       repeat: bool = True, shard_index: int = 0,
                       shard_count: int = 1, skip_examples: int = 0,
                       drop_remainder: bool = True,
                       ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """(images f32 [B,S,S,3] normalized, tokens i32 [B,L]) batches for
    CLIP/SigLIP contrastive pairs. Tokens pad/truncate to ``seq_len``.
    See `_chunks` for ``drop_remainder``."""
    examples = iter_examples(resolve_paths(data), repeat=repeat,
                             shuffle_buffer=shuffle_buffer, seed=seed,
                             shard_index=shard_index, shard_count=shard_count)
    return image_text_batches_from(
        examples, batch_size, image_size=image_size, seq_len=seq_len,
        pad_id=pad_id, mean=mean, std=std, skip_examples=skip_examples,
        drop_remainder=drop_remainder)


def image_text_batches_from(examples: Iterator[dict], batch_size: int, *,
                            image_size: int, seq_len: int, pad_id: int = 0,
                            mean=SIGLIP_MEAN, std=SIGLIP_STD,
                            skip_examples: int = 0,
                            drop_remainder: bool = True
                            ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Batch builder over ANY decoded-example stream (records schema) —
    shared by the tfrecord and webdataset front-ends so batch semantics
    live in one place."""
    skip(examples, skip_examples)
    for chunk in _chunks(examples, batch_size, drop_remainder):
        images = _image_batch(chunk, image_size, mean, std)
        tokens = np.stack([pad_tokens(ex["tokens"], seq_len, pad_id)
                           for ex in chunk])
        yield images, tokens


def naflex_image_text_batches(data: str | Sequence[str], batch_size: int, *,
                              patch_size: int, max_num_patches: int,
                              seq_len: int, pad_id: int = 0,
                              mean=SIGLIP_MEAN, std=SIGLIP_STD,
                              shuffle_buffer: int = 0, seed: int = 0,
                              repeat: bool = True, shard_index: int = 0,
                              shard_count: int = 1, skip_examples: int = 0,
                              drop_remainder: bool = True):
    """NaFlex contrastive batches: images keep their native aspect ratio
    (resized to the largest patch-divisible grid within
    ``max_num_patches``) instead of being squashed to a square. Yields
    ``((patches, spatial_shapes, mask), tokens)``, the image triple
    ``SigLIP.encode_image_naflex`` takes."""
    examples = iter_examples(resolve_paths(data), repeat=repeat,
                             shuffle_buffer=shuffle_buffer, seed=seed,
                             shard_index=shard_index, shard_count=shard_count)
    return naflex_image_text_batches_from(
        examples, batch_size, patch_size=patch_size,
        max_num_patches=max_num_patches, seq_len=seq_len, pad_id=pad_id,
        mean=mean, std=std, skip_examples=skip_examples,
        drop_remainder=drop_remainder)


def naflex_image_text_batches_from(examples: Iterator[dict],
                                   batch_size: int, *, patch_size: int,
                                   max_num_patches: int, seq_len: int,
                                   pad_id: int = 0, mean=SIGLIP_MEAN,
                                   std=SIGLIP_STD, skip_examples: int = 0,
                                   drop_remainder: bool = True):
    """NaFlex batch builder over any decoded-example stream — see
    `naflex_image_text_batches`."""
    skip(examples, skip_examples)
    for chunk in _chunks(examples, batch_size, drop_remainder):
        imgs = [to_float_normalized(
            (decode_image(ex["image"][0], ex.get("shape"))
             .astype(np.float32) / 255.0)[None], mean, std)[0]
                for ex in chunk]
        triple = patchify_naflex(imgs, patch_size=patch_size,
                                 max_num_patches=max_num_patches)
        tokens = np.stack([pad_tokens(ex["tokens"], seq_len, pad_id)
                           for ex in chunk])
        yield triple, tokens


def classification_batches(data: str | Sequence[str], batch_size: int, *,
                           image_size: int, mean=SIGLIP_MEAN, std=SIGLIP_STD,
                           shuffle_buffer: int = 0, seed: int = 0,
                           repeat: bool = True, shard_index: int = 0,
                           shard_count: int = 1, skip_examples: int = 0,
                           drop_remainder: bool = True,
                           ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """(images f32 [B,S,S,3] normalized, labels i32 [B]) batches. See
    `_chunks` for ``drop_remainder``."""
    examples = iter_examples(resolve_paths(data), repeat=repeat,
                             shuffle_buffer=shuffle_buffer, seed=seed,
                             shard_index=shard_index, shard_count=shard_count)
    return classification_batches_from(
        examples, batch_size, image_size=image_size, mean=mean, std=std,
        skip_examples=skip_examples, drop_remainder=drop_remainder)


def classification_batches_from(examples: Iterator[dict], batch_size: int, *,
                                image_size: int, mean=SIGLIP_MEAN,
                                std=SIGLIP_STD, skip_examples: int = 0,
                                drop_remainder: bool = True
                                ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Batch builder over any decoded-example stream — see
    `image_text_batches_from`."""
    skip(examples, skip_examples)
    for chunk in _chunks(examples, batch_size, drop_remainder):
        images = _image_batch(chunk, image_size, mean, std)
        labels = np.asarray([int(ex["label"][0]) for ex in chunk], np.int32)
        yield images, labels


# ---------------------------------------------------------------------------
# Writing (dataset preparation tooling)
# ---------------------------------------------------------------------------

def encode_image_feature(image: np.ndarray | bytes, *, encoding: str = "png"
                         ) -> dict[str, Any]:
    """uint8 [H,W,C] array (or already-encoded bytes) -> feature dict."""
    if isinstance(image, bytes):
        return {"image": image}
    image = np.ascontiguousarray(image, np.uint8)
    if encoding == "raw":
        return {"image": image.tobytes(), "shape": list(image.shape)}
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format=encoding.upper())
    return {"image": buf.getvalue()}


def write_image_text_records(path: str | Path,
                             pairs: Sequence[tuple[Any, Sequence[int]]], *,
                             encoding: str = "png") -> int:
    """[(image, token-ids), ...] -> one tfrecord shard. Returns count."""
    with TFRecordWriter(path) as w:
        for image, tokens in pairs:
            feats = encode_image_feature(image, encoding=encoding)
            feats["tokens"] = [int(t) for t in tokens]
            w.write(encode_example(feats))
    return len(pairs)


def write_classification_records(path: str | Path,
                                 pairs: Sequence[tuple[Any, int]], *,
                                 encoding: str = "png") -> int:
    """[(image, label), ...] -> one tfrecord shard. Returns count."""
    with TFRecordWriter(path) as w:
        for image, label in pairs:
            feats = encode_image_feature(image, encoding=encoding)
            feats["label"] = int(label)
            w.write(encode_example(feats))
    return len(pairs)
