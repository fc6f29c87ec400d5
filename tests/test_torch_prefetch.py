"""``jimm_tpu_torch.data.pipeline`` on the CPU: ``PrefetchIterator`` keeps
the source's order, yields each host batch beside its placed tensors,
re-raises a producer's exception after the batches made before it, stops
its producer on ``close()`` and fills the ``prefetch_wait_seconds``
histogram; ``place`` keeps the nesting and gives floats the model dtype,
integers int64 and booleans bool; and the consumed-state tracker pairs
state i with batch i behind the prefetch queue under a short switch
interval. (On the card the staging goes through pinned memory and a side
stream: ``chip_smoke.py`` phase 16(e) holds it to synchronous copies.)"""

import itertools
import sys
import threading
import time

import numpy as np
import pytest
import torch

from jimm_tpu_torch import obs
from jimm_tpu_torch.data.grain_pipeline import CheckpointableGrainStream
from jimm_tpu_torch.data.pipeline import PrefetchIterator, place

CPU = torch.device("cpu")
JOIN_S = 10.0


def _batches(n: int, start: int = 0):
    for i in range(start, start + n):
        yield (np.full((2, 3), i, np.float32), np.arange(2, dtype=np.int32) + i)


def test_order_and_host_batches_kept():
    it = PrefetchIterator(_batches(7), device=CPU, dtype=torch.float64)
    got = list(it)
    assert len(got) == 7
    for i, (host, (images, target)) in enumerate(got):
        assert host[0][0, 0] == i and host[0].dtype == np.float32
        assert images.dtype == torch.float64 and images.device == CPU
        assert target.dtype == torch.long
        np.testing.assert_array_equal(images.numpy(), host[0])
        np.testing.assert_array_equal(target.numpy(), host[1])
    with pytest.raises(StopIteration):
        next(it)


def test_place_keeps_the_naflex_nesting():
    triple = (np.ones((2, 4, 12), np.float32),
              np.asarray([[2, 2], [1, 3]], np.int32),
              np.asarray([[True, True, True, False]] * 2))
    (patches, shapes, mask), tokens = place(
        (triple, np.zeros((2, 5), np.int32)), CPU, torch.bfloat16)
    assert patches.dtype == torch.bfloat16 and shapes.dtype == torch.long
    assert mask.dtype == torch.bool and tokens.dtype == torch.long
    assert mask.tolist() == triple[2].tolist()


def test_producer_exception_after_its_batches():
    def broken():
        yield from _batches(3)
        raise ValueError("bad shard")

    it = PrefetchIterator(broken(), device=CPU)
    for i in range(3):
        host, _ = next(it)
        assert host[0][0, 0] == i
    with pytest.raises(ValueError, match="bad shard"):
        next(it)
    with pytest.raises(StopIteration):
        next(it)


def test_close_stops_the_producer():
    pulled = itertools.count()

    def endless():
        for i in pulled:
            yield (np.full((1,), i, np.float32),)

    it = PrefetchIterator(endless(), device=CPU, prefetch=2)
    assert next(it)[0][0][0] == 0
    it.close(timeout=JOIN_S)
    assert not it._thread.is_alive()
    made = next(pulled)
    # the producer stopped at its blocked put: at most the queue's two,
    # the one in hand and the one returned were made
    assert made <= 5
    with pytest.raises(StopIteration):
        next(it)


def test_wait_histogram_fills():
    obs.set_enabled(True)
    hist = obs.get_registry("jimm_train").histogram("prefetch_wait_seconds")
    before = hist.count

    def slow():
        for batch in _batches(3):
            time.sleep(0.05)
            yield batch

    assert len(list(PrefetchIterator(slow(), device=CPU))) == 3
    assert hist.count == before + 4  # three batches and the end
    assert hist.sum > 0


class _Counting:
    """An iterator whose state is how many batches it has handed out."""

    def __init__(self, n: int):
        self.n, self.i = n, 0

    def __iter__(self):
        return self

    def __next__(self):
        if self.i == self.n:
            raise StopIteration
        self.i += 1
        return (np.full((4,), self.i - 1, np.int32),)

    def get_state(self) -> bytes:
        return str(self.i).encode()


def test_consumed_state_pairs_with_its_batch_behind_prefetch():
    """A stress test: 400 batches through the prefetch queue with the
    interpreter switching threads every microsecond; after each consumed
    batch i the tracked state must say i + 1 batches, never the
    producer's read-ahead."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        stream = CheckpointableGrainStream(_Counting(400))
        prefetch = PrefetchIterator(stream.batches(), device=CPU, prefetch=3)
        assert stream.consumed_state == b"0"
        done = threading.Event()
        seen = []

        def consume():
            for host, _ in stream.track(prefetch):
                seen.append((int(host[0][0]), stream.consumed_state))
            done.set()

        worker = threading.Thread(target=consume, daemon=True)
        worker.start()
        worker.join(JOIN_S * 6)
        assert done.is_set() and not worker.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert [i for i, _ in seen] == list(range(400))
    assert all(state == str(i + 1).encode() for i, state in seen)
