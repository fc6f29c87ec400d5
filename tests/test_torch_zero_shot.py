"""Zero-shot classification against the JAX package: the CLIP tokenizer
(the same ids; the port's standard-library word split against the
``regex`` pattern over every code point), the class-embedding cache (the
same keys, LRU, counters), ``token_table_rows`` and the ensemble weights and
logits of tiny CLIP and SigLIP checkpoints, loaded by both packages, at
1e-4 in f32 (``tests/test_clip.py``'s tolerance)."""

import dataclasses
import unicodedata

import jax.numpy as jnp
import numpy as np
import pytest
import regex
import torch

from jimm_tpu.data.clip_tokenizer import CLIPTokenizer as JaxTokenizer
from jimm_tpu.models.clip import CLIP as JaxCLIP
from jimm_tpu.models.siglip import SigLIP as JaxSigLIP
from jimm_tpu.serve import cache as jax_cache
from jimm_tpu.utils import zero_shot as jax_zs
from jimm_tpu_torch import cli, configs
from jimm_tpu_torch.data import clip_tokenizer
from jimm_tpu_torch.data.clip_tokenizer import CLIPTokenizer
from jimm_tpu_torch.serve import cache
from jimm_tpu_torch.utils import zero_shot as zs

TOL = dict(atol=1e-4, rtol=0)
#: the tiny CLIP's vocabulary covers the synthetic one of
#: ``tests/conftest.py::clip_vocab_dir`` (526 ids, EOT the largest)
CLIP_VOCAB = 526
TEXTS = ["a photo of the cat.", "The CAT and  the dog!!", "naïve café 42",
         "中文 and 日本語", "<|startoftext|>hello<|endoftext|>",
         "it's what we'll do, they're here", "tab\tand\nnewline\r",
         "", "   ", "ſ's odd 'ſ case", "xͅy z", "emoji 🐱🐶 ok",
         "<|ENDOFTEXT|> <|ſtartoftext|> !<|endoftext|>", "1234 5.6e7",
         "\x00ctrl\x07chars​", "a'b''s 'S '"]
#: the split pattern of ``jimm_tpu/data/clip_tokenizer.py``
PATTERN = regex.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
    r"""|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""", regex.IGNORECASE)


@pytest.fixture(scope="module")
def tokenizers(clip_vocab_dir):
    return (CLIPTokenizer.from_dir(clip_vocab_dir),
            JaxTokenizer.from_dir(clip_vocab_dir))


@pytest.mark.parametrize("text", TEXTS, ids=[str(i) for i in range(len(TEXTS))])
def test_tokenizer_ids_match_jax(tokenizers, text):
    ours, theirs = tokenizers
    assert ours.encode(text) == theirs.encode(text)


@pytest.mark.parametrize("context_length", [4, 8, 77])
def test_tokenizer_batches_match_jax(tokenizers, context_length):
    """Truncation keeps the final EOT; rows pad with EOT."""
    ours, theirs = tokenizers
    got = ours(TEXTS, context_length=context_length)
    want = theirs(TEXTS, context_length=context_length)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (got[:, -1] == ours.eot_id).all() or context_length == 77
    np.testing.assert_array_equal(ours("one text"), theirs("one text"))


@pytest.mark.parametrize("prefix", ["", "'", "a", "1", "!"])
def test_word_split_matches_the_regex_pattern_on_every_code_point(prefix):
    """All code points (surrogates aside) in one run after ``prefix``; and
    each one that cleaning keeps (every ``C*`` goes) after ``prefix`` and
    before a letter, the groups apart by spaces (which end every
    alternative). Through the cleaning both tokenizers apply first."""
    points = [chr(c) for c in range(0x110000) if not 0xD800 <= c < 0xE000]
    kept = [ch for ch in points
            if not unicodedata.category(ch).startswith("C")]
    for text in (prefix + "".join(points),
                 " ".join(prefix + ch + "x" for ch in kept)):
        cleaned = clip_tokenizer._basic_clean(text)
        assert clip_tokenizer.split_words(cleaned) == PATTERN.findall(cleaned)


def test_bytes_to_unicode_matches_jax():
    from jimm_tpu.data.clip_tokenizer import bytes_to_unicode
    assert clip_tokenizer.bytes_to_unicode() == bytes_to_unicode()


ROWS = {"int32": np.arange(12, dtype=np.int32).reshape(3, 4),
        "int64": np.arange(12, dtype=np.int64).reshape(3, 4) * 1000,
        "list": [[1, 2, 3], [4, 5, 6]],
        "one_row": np.array([[49406, 320, 49407]])}


@pytest.mark.parametrize("rows", list(ROWS))
@pytest.mark.parametrize("model_key", ["clip:/ckpt:bf16", "siglip:p:f32"])
def test_prompt_set_key_matches_jax(rows, model_key):
    assert cache.prompt_set_key(model_key, ROWS[rows]) == \
        jax_cache.prompt_set_key(model_key, ROWS[rows])


def test_embedding_cache_lru_and_counters_match_jax():
    ours, theirs = cache.EmbeddingCache(2), jax_cache.EmbeddingCache(2)
    for c in (ours, theirs):
        c.put("a", np.zeros(1))
        c.put("b", np.ones(1))
        assert c.get("a") is not None       # a is now the most recent
        c.put("c", np.full(1, 2.0))          # evicts b
        assert c.get("b") is None
        c.put("a", np.full(1, 3.0))          # refresh, no eviction
        built = c.get_or_build("d", lambda: [4.0])  # evicts c
        assert built.tolist() == [4.0]
        assert c.get_or_build("d", lambda: [5.0]).tolist() == [4.0]
        assert list(c._data) == ["a", "d"] and len(c) == 2
    assert ours.stats() == theirs.stats() == {
        "cache_entries": 2, "cache_hits": 2, "cache_misses": 2,
        "cache_evictions": 2, "cache_hit_rate": 0.5}
    with pytest.raises(ValueError) as a:
        cache.EmbeddingCache(0)
    with pytest.raises(ValueError) as b:
        jax_cache.EmbeddingCache(0)
    assert str(a.value) == str(b.value)
    assert cache.class_embedding_cache() is cache.class_embedding_cache()
    assert cache.class_embedding_cache().capacity == 32


TABLES = {
    "flat": ({"cat": [1, 2, 9], "dog": [3, 9]}, None),
    "ragged": ({"fly": [[5, 6], [7, 8, 9]], "ant": [1, 2], "bee": [[3]]},
               ["ant", "bee", "fly"]),
}


@pytest.mark.parametrize("table", list(TABLES))
def test_token_table_rows_match_jax(table):
    tbl, labels = TABLES[table]
    got = zs.token_table_rows(tbl, 5, labels)
    want = jax_zs.token_table_rows(tbl, 5, labels)
    assert got[0] == want[0] and got[2] == want[2]
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("case", ["missing", "overlong"])
def test_token_table_rows_refusals_match_jax(case):
    tbl, labels = ({"cat": [1]}, ["cat", "owl"]) if case == "missing" else (
        {"cat": [[1, 2, 3, 4, 5, 6]]}, None)
    with pytest.raises(ValueError) as a:
        zs.token_table_rows(tbl, 5, labels)
    with pytest.raises(ValueError) as b:
        jax_zs.token_table_rows(tbl, 5, labels)
    assert str(a.value) == str(b.value)


def test_templates_match_jax():
    assert zs.TEMPLATES == jax_zs.TEMPLATES
    assert zs.expand_templates(["a", "b"]) == jax_zs.expand_templates(
        ["a", "b"])


def tiny_config(fam: str):
    """The CLI's --tiny size of the family's base preset; CLIP's text
    vocabulary widened to the synthetic one's 526 ids."""
    name = {"clip": "clip-vit-base-patch16",
            "siglip": "siglip-base-patch16-256"}[fam]
    cfg = cli.tiny_override(configs.preset(name))
    if fam == "clip":
        cfg = dataclasses.replace(cfg, text=dataclasses.replace(
            cfg.text, vocab_size=CLIP_VOCAB))
    return cfg


@pytest.fixture(scope="module", params=["clip", "siglip"])
def pair(request, tmp_path_factory):
    """(family, port model, JAX model) from one checkpoint the port wrote
    (seeded, f32), loaded by both packages; and seeded inputs."""
    fam = request.param
    d = tmp_path_factory.mktemp(fam)
    model = cli.MODELS[fam](tiny_config(fam), device="cpu",
                            generator=torch.Generator().manual_seed(3))
    model.save_pretrained(d)
    ours = cli.MODELS[fam].from_pretrained(d, device="cpu").eval()
    theirs = (JaxCLIP if fam == "clip" else JaxSigLIP).from_pretrained(str(d))
    rng = np.random.default_rng(4)
    ctx = ours.config.text.context_length
    eot = CLIP_VOCAB - 1 if fam == "clip" else 63
    table = {label: [list(rng.integers(1, eot, n)) + [eot]
                     for n in (2, 4, ctx - 1)]
             for label in ("ant", "bee", "fly")}
    images = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    return fam, ours, theirs, table, images


def test_weights_from_rows_match_jax(pair):
    _, ours, theirs, table, _ = pair
    labels, rows, owner = zs.token_table_rows(table, 8)
    got = zs.weights_from_rows(ours, rows, owner, len(labels))
    want = jax_zs.weights_from_rows(theirs, jnp.asarray(rows.numpy()),
                                    owner, len(labels))
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=1), 1.0,
                               atol=1e-6)


def test_classifier_weights_match_jax(pair):
    _, ours, theirs, table, _ = pair
    _, rows, _ = zs.token_table_rows(table, 8)
    got = zs.classifier_weights(ours, rows, 3)
    want = jax_zs.classifier_weights(theirs, jnp.asarray(rows.numpy()), 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="not divisible"):
        zs.classifier_weights(ours, rows[:4], 3)


def test_zero_shot_logits_match_jax(pair):
    fam, ours, theirs, table, images = pair
    labels, rows, owner = zs.token_table_rows(table, 8)
    weights = zs.weights_from_rows(ours, rows, owner, len(labels))
    got = zs.zero_shot_logits(ours, torch.from_numpy(images), weights)
    want = jax_zs.zero_shot_logits(theirs, jnp.asarray(images),
                                   jnp.asarray(weights.numpy()))
    assert got.shape == (3, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    feats = ours.encode_image(torch.from_numpy(images))
    np.testing.assert_allclose(
        zs.zero_shot_logits_from_features(ours, feats, weights).numpy(),
        np.asarray(want), **TOL)
    if fam == "siglip":  # the bias is there: logits near logit_bias
        assert float(got.mean()) < -5
