"""Host-side input pipeline: background prefetch and placement on the
device; the port's counterpart of ``jimm_tpu/data/pipeline.py``.

A worker thread pulls host batches (nested tuples of numpy arrays) from the
source and places them on the device ahead of the training step, so the
next batch's host work and host-to-device copy overlap the current step. On
a CUDA device each array is staged in pinned host memory and copied
``non_blocking`` on a side stream, and an event is recorded after the
copies; the consumer makes its current stream wait on that event and
records the stream on the tensors, so no device buffer is reused before the
step that reads it has run. A pinned staging buffer goes back to PyTorch's
pinned-memory cache when its tensor dies, and the cache reuses it only once
the copy recorded on it has finished. On the CPU placing is a plain
``.to(device)``.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Iterator

import numpy as np
import torch

from jimm_tpu_torch.obs.registry import enabled as _obs_enabled, get_registry

#: seconds a blocked producer waits between looks at the stop flag
_POLL_S = 0.1


def place(batch: Any, device: torch.device, dtype: torch.dtype) -> Any:
    """A host batch's numpy leaves as tensors on ``device``, the nesting
    kept: floating arrays in ``dtype`` (the model's), integer arrays as
    int64 (labels, tokens, NaFlex grid shapes), boolean ones as bool
    (NaFlex masks). On a CUDA device each array is pinned first, copied
    without blocking in its own dtype and converted there, all on the
    caller's current stream."""
    if isinstance(batch, (tuple, list)):
        return tuple(place(b, device, dtype) for b in batch)
    a = np.asarray(batch)
    to = (dtype if a.dtype.kind == "f"
          else torch.bool if a.dtype.kind == "b" else torch.long)
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t.to(device, to)


def _tensors(tree: Any) -> Iterator[torch.Tensor]:
    if isinstance(tree, (tuple, list)):
        for item in tree:
            yield from _tensors(item)
    elif isinstance(tree, torch.Tensor):
        yield tree


class PrefetchIterator:
    """Wrap a host batch iterator; yields ``(host_batch, device_batch)``
    pairs, up to ``prefetch`` of them made ahead by a daemon thread. The
    host batch is the source's own item (what ``--batch-fingerprint``
    hashes); the device batch is :func:`place`'s. A producer's exception is
    raised on the consumer's side, after the batches made before it."""

    def __init__(self, source: Iterator[Any], *, device: torch.device,
                 dtype: torch.dtype = torch.float32, prefetch: int = 2):
        self._source = source
        self._device = torch.device(device)
        self._dtype = dtype
        self._cuda = self._device.type == "cuda"
        self._side = (torch.cuda.Stream(device=self._device) if self._cuda
                      else None)
        self._queue: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._done = False
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="jimm-prefetch")
        self._thread.start()

    def _put(self, item: Any) -> bool:
        """Queue ``item`` unless the iterator is closed meanwhile."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def _stage(self, batch: Any) -> tuple[Any, Any, Any]:
        if not self._cuda:
            return batch, place(batch, self._device, self._dtype), None
        with torch.cuda.stream(self._side):
            placed = place(batch, self._device, self._dtype)
            ready = torch.cuda.Event()
            ready.record(self._side)
        return batch, placed, ready

    def _worker(self) -> None:
        try:
            for batch in self._source:
                if self._stop.is_set() or not self._put(self._stage(batch)):
                    return
        except BaseException as e:  # surface producer errors to the consumer
            self._put(e)
            if not isinstance(e, Exception):
                raise
            return
        self._put(StopIteration())

    def __iter__(self) -> "PrefetchIterator":
        return self

    def __next__(self) -> tuple[Any, Any]:
        if self._done:
            raise StopIteration
        if _obs_enabled():
            # time blocked on the producer: the consumer-side data wait
            # that the goodput accounter's data_wait bucket corroborates
            t0 = time.perf_counter()
            item = self._queue.get()
            get_registry("jimm_train").histogram(
                "prefetch_wait_seconds").observe(time.perf_counter() - t0)
        else:
            item = self._queue.get()
        if isinstance(item, StopIteration):
            self._done = True
            raise StopIteration
        if isinstance(item, BaseException):
            self._done = True
            raise item
        host, placed, ready = item
        if ready is not None:
            current = torch.cuda.current_stream(self._device)
            current.wait_event(ready)
            for t in _tensors(placed):
                t.record_stream(current)
        return host, placed

    def close(self, timeout: float = 5.0) -> None:
        """Stop the producer: it exits at its next batch or blocked put,
        waited for up to ``timeout`` seconds (a source blocked inside its
        own ``next`` finishes that call first)."""
        self._stop.set()
        self._done = True
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout)
