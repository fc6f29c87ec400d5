"""The port's indexed loader (``jimm_tpu_torch/data/grain_pipeline.py``, the
``--loader grain`` counterpart, built on ``torch.utils.data``): without a
shuffle, one epoch, its batches equal the JAX package's grain loader's bit
for bit in the cases of ``tests/test_grain.py`` (contrastive,
classification, 2-way sharding), the JAX side given the port's native
library; shuffled, it is deterministic by seed, differs between epochs and
covers each record of its shard once an epoch; ``set_state`` on a fresh
loader continues exactly, and state of another loader is refused; two
worker processes give what none does; the random-access source."""

import pathlib
import pickle

import numpy as np
import pytest

from jimm_tpu.data import grain_pipeline as jax_grain
from jimm_tpu.data import preprocess as jax_pre
from jimm_tpu_torch import obs
from jimm_tpu_torch.data import native
from jimm_tpu_torch.data.grain_pipeline import (IndexPlan,
                                                TFRecordDataSource,
                                                grain_batches,
                                                make_grain_loader)
from jimm_tpu_torch.data.records import (write_classification_records,
                                         write_image_text_records)
from jimm_tpu_torch.data.tfrecord import decode_example


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """Two shards of 6 raw 8 x 8 image-text records, record k's tokens
    starting at k + 1 (tests/test_grain.py's layout)."""
    rng = np.random.default_rng(0)
    d = tmp_path_factory.mktemp("indexed")
    paths, k = [], 0
    for s in range(2):
        pairs = []
        for _ in range(6):
            pairs.append((rng.integers(0, 255, (8, 8, 3), dtype=np.uint8),
                          [k + 1, k + 2, k + 3]))
            k += 1
        write_image_text_records(d / f"part-{s}.tfrecord", pairs,
                                 encoding="raw")
        paths.append(str(d / f"part-{s}.tfrecord"))
    return paths


@pytest.fixture
def same_native_library(monkeypatch):
    monkeypatch.setattr(jax_pre, "_LIB", native.load())


def _equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w) == 2
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


PARITY = {
    "contrastive": dict(batch_size=4, task="contrastive", image_size=16,
                        seq_len=5),
    "sharded_0": dict(batch_size=2, task="contrastive", image_size=8,
                      seq_len=3, shard_index=0, shard_count=2),
    "sharded_1": dict(batch_size=2, task="contrastive", image_size=8,
                      seq_len=3, shard_index=1, shard_count=2),
}


@pytest.mark.parametrize("case", list(PARITY))
def test_unshuffled_batches_match_jax(shards, same_native_library, case):
    kw = dict(PARITY[case])
    bs = kw.pop("batch_size")
    ours = make_grain_loader(shards, bs, shuffle=False, num_epochs=1, **kw)
    theirs = jax_grain.make_grain_loader(shards, bs, shuffle=False,
                                         num_epochs=1, **kw)
    _equal(list(grain_batches(ours)), list(jax_grain.grain_batches(theirs)))


def test_classification_batches_match_jax(tmp_path, same_native_library):
    rng = np.random.default_rng(1)
    pairs = [(rng.integers(0, 255, (8, 12, 3), dtype=np.uint8), i % 3)
             for i in range(9)]
    path = str(tmp_path / "cls.tfrecord")
    write_classification_records(path, pairs, encoding="raw")
    kw = dict(task="classification", image_size=8, shuffle=False,
              num_epochs=1)
    got = list(grain_batches(make_grain_loader(path, 4, **kw)))
    want = list(jax_grain.grain_batches(jax_grain.make_grain_loader(
        path, 4, **kw)))
    _equal(got, want)
    assert len(got) == 2  # 9 records: the short third batch dropped
    np.testing.assert_array_equal(got[0][1], [0, 1, 2, 0])


def _first_tokens(loader) -> list[int]:
    return [int(t[0]) for _, toks in grain_batches(loader) for t in toks]


def test_shuffled_epochs_cover_each_record_once(shards):
    kw = dict(task="contrastive", image_size=8, seq_len=3, num_epochs=3)
    order = _first_tokens(make_grain_loader(shards, 3, seed=7, **kw))
    assert order == _first_tokens(make_grain_loader(shards, 3, seed=7, **kw))
    assert order != _first_tokens(make_grain_loader(shards, 3, seed=8, **kw))
    epochs = [order[i:i + 12] for i in range(0, 36, 12)]
    for epoch in epochs:
        assert sorted(epoch) == list(range(1, 13))
    assert epochs[0] != epochs[1] != epochs[2]
    # a shard's process sees its own half, each record once an epoch
    half = _first_tokens(make_grain_loader(shards, 2, seed=7, shard_index=1,
                                           shard_count=2, **kw))
    for e in range(3):
        assert sorted(half[6 * e:6 * e + 6]) == list(range(7, 13))


def test_plan_runs_batches_across_an_epoch_end():
    plan = IndexPlan(5, shuffle=False, seed=0, num_epochs=None)
    assert plan.keys(3, 4) == [3, 4, 0, 1]
    shuffled = IndexPlan(10, shuffle=True, seed=3, num_epochs=None,
                         shard_index=1, shard_count=3)
    assert sorted(shuffled.keys(0, 3)) == [3, 4, 5]
    with pytest.raises(ValueError, match="cannot give each"):
        IndexPlan(2, shuffle=False, seed=0, num_epochs=1, shard_count=3)


def test_set_state_continues_on_a_fresh_loader(shards):
    def make():
        return make_grain_loader(shards, 2, task="contrastive",
                                 image_size=8, seq_len=3, seed=3,
                                 num_epochs=2)

    it = iter(make())
    for _ in range(4):
        next(it)
    state = it.get_state()
    rest = [t.tolist() for _, t in it]
    assert len(rest) == 8  # 2 epochs of 6 batches, 4 taken
    again = iter(make())
    again.set_state(state)
    assert [t.tolist() for _, t in again] == rest
    # another loader's state: refused, the iterator untouched
    other = iter(make_grain_loader(shards, 3, task="contrastive",
                                   image_size=8, seq_len=3, seed=3))
    with pytest.raises(ValueError, match="batch_size 2"):
        other.set_state(state)
    single = iter(make_grain_loader(shards[0], 2, task="contrastive",
                                    image_size=8, seq_len=3, seed=3,
                                    num_epochs=2))
    with pytest.raises(ValueError, match="another loader: source"):
        single.set_state(state)


def test_two_workers_equal_none(shards):
    def run(workers):
        loader = make_grain_loader(shards, 3, task="contrastive",
                                   image_size=16, seq_len=3, seed=5,
                                   num_epochs=2, worker_count=workers)
        return list(grain_batches(loader))

    _equal(run(2), run(0))


def test_random_access_source(shards, tmp_path):
    src = TFRecordDataSource(shards)
    assert len(src) == 12
    assert decode_example(src[11])["tokens"] == [12, 13, 14]
    assert decode_example(src[0])["tokens"] == [1, 2, 3]
    assert src._fds
    clone = pickle.loads(pickle.dumps(src))
    assert clone._fds == {} and repr(clone) == repr(src)
    assert clone[5] == src[5]
    src.close()
    clone.close()
    cut = tmp_path / "cut.tfrecord"
    cut.write_bytes(pathlib.Path(shards[0]).read_bytes()[:-7])
    with pytest.raises(ValueError, match="truncated tfrecord payload"):
        TFRecordDataSource(str(cut))


def test_produce_time_is_observed(shards):
    hist = obs.get_registry("jimm_train").histogram("grain_produce_seconds")
    before = hist.count
    loader = make_grain_loader(shards, 4, task="contrastive", image_size=8,
                               seq_len=3, num_epochs=1)
    assert len(list(grain_batches(loader))) == 3
    assert hist.count == before + 3
