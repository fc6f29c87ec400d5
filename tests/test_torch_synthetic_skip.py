"""The synthetic generators' ``skip(n)`` (``train --resume``'s replay of
the stream): after it, the next batches equal a full generation's at the
same place bit for bit, for every generator and option, while the skip
builds no image and resizes nothing."""

import numpy as np
import pytest

from jimm_tpu_torch.data import synthetic

GENERATORS = {
    "blobs": lambda: synthetic.blob_classification(3, image_size=20,
                                                   num_classes=5, seed=2),
    "clips": lambda: synthetic.blob_classification(2, image_size=16,
                                                   num_frames=3, seed=1),
    "pairs": lambda: synthetic.contrastive_pairs(4, image_size=16,
                                                 vocab_size=50, seed=3),
    "pairs_shard": lambda: synthetic.contrastive_pairs(
        4, image_size=16, seed=3, shard_index=1, shard_count=2),
    "naflex": lambda: synthetic.naflex_contrastive_pairs(
        5, patch_size=4, max_num_patches=12, seed=4),
}


def _leaves(batch):
    if isinstance(batch, tuple):
        for item in batch:
            yield from _leaves(item)
    else:
        yield batch


@pytest.mark.parametrize("skipped", [0, 1, 3])
@pytest.mark.parametrize("name", list(GENERATORS))
def test_skip_then_next_equals_full_generation(name, skipped, monkeypatch):
    full = GENERATORS[name]()
    for _ in range(skipped):
        next(full)
    want = [next(full) for _ in range(2)]
    fast = GENERATORS[name]()

    def built(*_a, **_k):
        raise AssertionError("skip built an image")

    with monkeypatch.context() as mp:
        mp.setattr(synthetic, "resize_bilinear", built)
        mp.setattr(synthetic, "patchify_naflex", built)
        mp.setattr(np, "exp", built)
        fast.skip(skipped)
    got = [next(fast) for _ in range(2)]
    for g, w in zip(got, want):
        for a, b in zip(_leaves(g), _leaves(w)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
