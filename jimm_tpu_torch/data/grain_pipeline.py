"""The indexed, multi-worker loader over TFRecord shards: the port's
counterpart of ``jimm_tpu/data/grain_pipeline.py`` (``train --loader
grain``), named after it so that a reader finds it. No grain is involved:
``import grain.python`` loads JAX, which the port does not import. The same
parts are built on PyTorch's ``DataLoader``:

- a random-access record source (:class:`TFRecordDataSource`, a copy of the
  reference's: a header-only offset scan, ``os.pread``);
- grain's ``IndexSampler`` order (:class:`IndexPlan`): the records split
  between processes by grain's ``even_split`` with the remainder dropped,
  each epoch in order or shuffled by index from the seed ``(seed + epoch) %
  2**32``, as grain's ``_shuffled_index`` seeds it (the permutation itself
  is numpy's: grain's C++ ``index_shuffle`` is not reproduced), in full
  batches;
- parallel workers (``worker_count`` processes) that decode and preprocess
  whole batches, the batches arriving in the sampler's order whatever the
  worker count;
- an iterator whose ``get_state()``/``set_state()`` bytes (source, seed,
  epoch, position) resume at the exact next batch without decoding a
  record.

Without a shuffle the batches equal the reference's grain loader's (one
process, ``worker_count=0``), batch for batch.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Iterator, Sequence

import numpy as np
import torch

from jimm_tpu_torch.data import native
from jimm_tpu_torch.data.preprocess import (SIGLIP_MEAN, SIGLIP_STD,
                                            to_float_normalized)
from jimm_tpu_torch.data.records import pad_tokens, prep_image, resolve_paths
from jimm_tpu_torch.data.tfrecord import decode_example
from jimm_tpu_torch.obs.registry import enabled as _obs_enabled, get_registry

_LEN_BYTES = 8
_CRC_BYTES = 4
#: what a loader's iterator state records of its plan; a state is refused
#: unless all of them but the position and epoch match
_PLAN_KEYS = ("source", "shuffle", "seed", "num_epochs", "shard_index",
              "shard_count", "batch_size")


def _scan_offsets(path: str) -> list[tuple[int, int]]:
    """(payload_offset, payload_length) of every record in one shard —
    header-only scan (seeks past payloads), so indexing is IO-light.
    Truncated shards (interrupted copy/write) fail HERE with a clear error,
    like `read_tfrecord` — not later with a confusing worker decode error."""
    out = []
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        while True:
            head = f.read(_LEN_BYTES)
            if not head:
                break
            if len(head) != _LEN_BYTES:
                raise ValueError(f"truncated tfrecord length in {path}")
            n = int.from_bytes(head, "little")
            f.seek(_CRC_BYTES, 1)  # length crc
            off = f.tell()
            end = off + n + _CRC_BYTES
            if end > size:
                raise ValueError(
                    f"truncated tfrecord payload in {path}: record at "
                    f"offset {off} claims {n} bytes but the file ends at "
                    f"{size}")
            out.append((off, n))
            f.seek(end)
    return out


class TFRecordDataSource:
    """Random-access view over tfrecord shards (``len`` + ``getitem`` ->
    payload bytes). Builds a per-record offset index at construction. Reads
    use ``os.pread`` on a per-path fd: positionless, so concurrent readers
    never interleave seeks. The source pickles to worker processes; fds
    reopen lazily there."""

    def __init__(self, data: str | Sequence[str]):
        self._paths = resolve_paths(data)
        self._index: list[tuple[int, int, int]] = []  # (path_i, off, len)
        for pi, path in enumerate(self._paths):
            self._index.extend((pi, off, n)
                               for off, n in _scan_offsets(path))
        self._fds: dict[int, int] = {}

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_fds"] = {}  # fds don't pickle; workers reopen
        return state

    def __repr__(self) -> str:
        # stable across processes: the iterator state records it, and a
        # state is refused when it differs (the default object repr holds
        # the memory address, which never matches)
        return (f"TFRecordDataSource(paths={self._paths!r}, "
                f"records={len(self._index)})")

    def __len__(self) -> int:
        return len(self._index)

    def __getitem__(self, i: int) -> bytes:
        pi, off, n = self._index[int(i)]
        fd = self._fds.get(pi)
        if fd is None:
            new = os.open(self._paths[pi], os.O_RDONLY)
            fd = self._fds.setdefault(pi, new)  # GIL-atomic; lose the race
            if fd is not new:                   # -> close the extra fd
                os.close(new)
        data = os.pread(fd, n, off)
        if len(data) != n:
            raise ValueError(f"short read at offset {off} of "
                             f"{self._paths[pi]} (file changed underfoot?)")
        return data

    def close(self) -> None:
        while self._fds:
            os.close(self._fds.popitem()[1])

    def __del__(self):  # best-effort; close() is the real API
        try:
            self.close()
        except Exception:
            pass


class IndexPlan:
    """The record keys of one process's stream, by position: grain's
    ``IndexSampler`` with ``ShardOptions(drop_remainder=True)``. The process
    owns the consecutive ``len(source) // shard_count`` records from
    ``shard_index`` times that; epoch ``e`` visits them in order, or in
    the permutation numpy's generator draws from ``(seed + e) % 2**32``.
    ``num_epochs=None`` repeats without end."""

    def __init__(self, num_records: int, *, shuffle: bool, seed: int,
                 num_epochs: int | None, shard_index: int = 0,
                 shard_count: int = 1):
        if num_records <= 0:
            raise ValueError(f"no records to sample from ({num_records})")
        if num_epochs is not None and num_epochs <= 0:
            raise ValueError(f"num_epochs must be positive, got "
                             f"{num_epochs}")
        if not 0 <= shard_index < shard_count:
            raise ValueError(f"shard_index={shard_index} outside "
                             f"[0, {shard_count})")
        self.size = num_records // shard_count
        if not self.size:
            raise ValueError(f"{num_records} records cannot give each of "
                             f"{shard_count} shards one")
        self.start = self.size * shard_index
        self.shuffle, self.seed = shuffle, seed
        self.total = None if num_epochs is None else self.size * num_epochs
        self._epoch, self._order = -1, None

    def order(self, epoch: int) -> np.ndarray:
        """Epoch ``epoch``'s record keys."""
        if epoch != self._epoch:
            offsets = (np.random.default_rng(
                (self.seed + epoch) % 2**32).permutation(self.size)
                if self.shuffle else np.arange(self.size))
            self._epoch, self._order = epoch, offsets + self.start
        return self._order

    def keys(self, position: int, count: int) -> list[int]:
        """The record keys at stream positions ``[position, position +
        count)``, across an epoch's end as grain's batches run on."""
        return [int(self.order(p // self.size)[p % self.size])
                for p in range(position, position + count)]


class _Batches(torch.utils.data.Sampler):
    """Full batches of record keys from ``start`` on."""

    def __init__(self, plan: IndexPlan, batch_size: int, start: int):
        self.plan, self.batch_size, self.start = plan, batch_size, start

    def __iter__(self) -> Iterator[list[int]]:
        p = self.start
        while self.plan.total is None or p + self.batch_size <= \
                self.plan.total:
            yield self.plan.keys(p, self.batch_size)
            p += self.batch_size


class _Parse:
    """One payload -> (image f32 [S,S,3] normalized, tokens i32 [L] or an
    i32 label): the reference's ``_Parse`` transform, picklable to worker
    processes."""

    def __init__(self, task: str, image_size: int, seq_len: int | None,
                 pad_id: int, mean, std):
        self.task, self.image_size = task, image_size
        self.seq_len, self.pad_id = seq_len, pad_id
        self.mean, self.std = np.asarray(mean), np.asarray(std)

    def __call__(self, payload: bytes):
        ex = decode_example(payload)
        image = to_float_normalized(prep_image(ex, self.image_size)[None],
                                    self.mean, self.std)[0]
        if self.task == "classification":
            return image, np.int32(ex["label"][0])
        return image, pad_tokens(ex["tokens"], self.seq_len, self.pad_id)


class _Records(torch.utils.data.Dataset):
    def __init__(self, source: TFRecordDataSource, parse: _Parse):
        self.source, self.parse = source, parse

    def __len__(self) -> int:
        return len(self.source)

    def __getitem__(self, key: int):
        return self.parse(self.source[key])


def _stack(samples: list[tuple]) -> tuple[torch.Tensor, torch.Tensor]:
    """A batch of (image, aux) samples stacked, as tensors: a worker hands
    a tensor to the main process through shared memory, where a numpy
    array would be pickled through a pipe (a batch of 128 f32 256 x 256
    images is 100 MB)."""
    return (torch.from_numpy(np.stack([s[0] for s in samples])),
            torch.from_numpy(np.stack([s[1] for s in samples])))


class IndexedLoader:
    """The loader :func:`make_grain_loader` builds: iterate it, or take
    ``iter(loader)`` for an :class:`IndexedIterator` with
    ``get_state()/set_state()``."""

    def __init__(self, source: TFRecordDataSource, parse: _Parse,
                 plan: IndexPlan, batch_size: int, worker_count: int, *,
                 shard_index: int, shard_count: int,
                 num_epochs: int | None):
        self.plan = plan
        self.batch_size, self.worker_count = batch_size, worker_count
        self.dataset = _Records(source, parse)
        self.plan_state = {"source": repr(source), "shuffle": plan.shuffle,
                           "seed": plan.seed, "num_epochs": num_epochs,
                           "shard_index": shard_index,
                           "shard_count": shard_count,
                           "batch_size": batch_size}

    def batches_from(self, position: int) -> Iterator:
        """Batches from stream position ``position`` on, the workers
        started now.

        The workers are forked, not spawned. A spawned worker starts a
        fresh interpreter that imports the main module (for the train
        command, the whole CLI and torch: seconds a worker, paid again at
        every resume). A forked worker runs host code only: the record
        reads, numpy and the native library, whose threads live only
        inside a call. It never touches CUDA (torch marks a forked child
        and keeps CUDA off in it) or pinned memory (the main process's
        prefetch thread pins). The train command starts the workers from
        its main thread before its prefetch thread exists, with the native
        library already loaded, so no lock of this package is held across
        the fork."""
        workers = self.worker_count
        return iter(torch.utils.data.DataLoader(
            self.dataset, batch_sampler=_Batches(self.plan, self.batch_size,
                                                 position),
            num_workers=workers, collate_fn=_stack,
            multiprocessing_context="fork" if workers else None))

    def __iter__(self) -> "IndexedIterator":
        return IndexedIterator(self)


class IndexedIterator:
    """Batches in the plan's order. ``get_state()`` is the position after
    the last batch returned, as bytes; ``set_state()`` on any iterator of
    the same plan (a fresh process's too) continues from there, decoding
    nothing skipped."""

    def __init__(self, loader: IndexedLoader):
        self._loader = loader
        self._position = 0
        self._it = None  # made by start() or the first batch, so that a
        #                  set_state before it starts no worker for nothing

    def __iter__(self) -> "IndexedIterator":
        return self

    def start(self) -> "IndexedIterator":
        """Start the workers at the current position (the first batch does
        it otherwise)."""
        if self._it is None:
            self._it = self._loader.batches_from(self._position)
        return self

    def __next__(self) -> tuple[np.ndarray, np.ndarray]:
        images, aux = next(self.start()._it)
        self._position += self._loader.batch_size
        return images.numpy(), aux.numpy()

    def get_state(self) -> bytes:
        size = self._loader.plan.size
        return json.dumps({**self._loader.plan_state,
                           "epoch": self._position // size,
                           "position": self._position},
                          sort_keys=True).encode()

    def set_state(self, state: bytes) -> None:
        saved = json.loads(state)
        ours = self._loader.plan_state
        clash = [f"{k} {saved.get(k)!r} (this loader's: {ours[k]!r})"
                 for k in _PLAN_KEYS if saved.get(k) != ours[k]]
        if clash:
            raise ValueError(f"iterator state of another loader: "
                             f"{', '.join(clash)}")
        self.close()
        self._position = int(saved["position"])

    def close(self) -> None:
        """Shut the workers down (a later batch starts new ones)."""
        self._it = None


def make_grain_loader(data: str | Sequence[str], batch_size: int, *,
                      task: str = "contrastive", image_size: int,
                      seq_len: int | None = None, pad_id: int = 0,
                      mean=SIGLIP_MEAN, std=SIGLIP_STD, seed: int = 0,
                      num_epochs: int | None = None, shuffle: bool = True,
                      worker_count: int = 0, shard_index: int = 0,
                      shard_count: int = 1) -> IndexedLoader:
    """A loader yielding the same batch tuples as
    ``jimm_tpu_torch.data.records``:

    - ``task="contrastive"``: ``(images f32 [B,S,S,3], tokens i32 [B,L])``
      (requires ``seq_len``)
    - ``task="classification"``: ``(images f32 [B,S,S,3], labels i32 [B])``

    Iterate it directly, or take ``iter(loader)`` and use
    ``get_state()/set_state()`` for an exact resume."""
    if task == "contrastive" and seq_len is None:
        raise ValueError("contrastive task needs seq_len")
    if task not in ("contrastive", "classification"):
        raise ValueError(f"unknown task {task!r}")
    # build the native library here, once, before any worker needs it
    native.load()
    source = TFRecordDataSource(data)
    plan = IndexPlan(len(source), shuffle=shuffle, seed=seed,
                     num_epochs=num_epochs, shard_index=shard_index,
                     shard_count=shard_count)
    return IndexedLoader(source, _Parse(task, image_size, seq_len, pad_id,
                                        mean, std),
                         plan, batch_size, worker_count,
                         shard_index=shard_index, shard_count=shard_count,
                         num_epochs=num_epochs)


def grain_batches(loader) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Adapter: a loader -> the plain ``(images, aux)`` tuple stream the
    trainer consumes (``jimm_tpu_torch.cli.cmd_train``). Per-batch
    production time lands in the ``jimm_train`` registry
    (``grain_produce_seconds``) so input-bound runs show up in the unified
    dump, not just as mysteriously slow steps."""
    it = iter(loader)
    while True:
        t0 = time.perf_counter()
        try:
            batch = next(it)
        except StopIteration:
            return
        if _obs_enabled():
            get_registry("jimm_train").histogram(
                "grain_produce_seconds").observe(time.perf_counter() - t0)
        yield tuple(np.asarray(b) for b in batch)


class CheckpointableGrainStream:
    """Exact resume under prefetch: pairs every produced batch with the
    iterator state captured right after pulling it, and exposes
    ``consumed_state`` — the state as of the last batch the *training loop*
    received, not the producer's read-ahead position.

    A ``PrefetchIterator`` runs the producer in a worker thread up to
    ``prefetch`` batches ahead, so checkpointing ``iterator.get_state()``
    directly skips those in-flight batches on resume (they were produced,
    never trained on). Iterate ``.batches()`` as the producer, wrap the
    consumer side with ``.track()``, and checkpoint ``consumed_state``.

    Thread-safety: the producer appends and the consumer pops on a
    ``deque`` — both operations are atomic, and batch order is preserved
    end-to-end (the prefetch queue is FIFO), so state i always pairs with
    batch i.
    """

    def __init__(self, grain_iter):
        self._it = grain_iter
        self._produced: "deque[bytes]" = deque()
        #: state to checkpoint; resumes at the batch AFTER the last consumed
        self.consumed_state: bytes = grain_iter.get_state()

    def close(self) -> None:
        """Shut the iterator's workers down."""
        self._it.close()

    def batches(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Producer side: (images, aux) tuples off the iterator."""
        for batch in self._it:
            self._produced.append(self._it.get_state())
            yield tuple(np.asarray(b) for b in batch)

    def track(self, iterator: Iterator) -> Iterator:
        """Consumer side: pass batches through, advancing consumed_state."""
        for batch in iterator:
            if not self._produced:
                # a batch this stream never produced would silently mispair
                # state i with batch i+1 from here on — fail loudly instead
                raise RuntimeError(
                    "track() received a batch not produced by batches(): "
                    "the consumer iterator must be fed (possibly via "
                    "prefetch) from this stream's batches() only")
            self.consumed_state = self._produced.popleft()
            yield batch
