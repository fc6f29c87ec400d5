"""Pure-python CLIP byte-level BPE tokenizer; the port's copy of
``jimm_tpu/data/clip_tokenizer.py``.

CLIP's text cleanup (control-char dropping, CJK spacing, NFC normalization,
lowercase + whitespace cleanup: ``transformers.CLIPTokenizer``'s no-ftfy
preprocessing), then byte-level BPE with ``</w>`` end-of-word marks,
``<|startoftext|>``/``<|endoftext|>`` specials and endoftext padding, from
the ``vocab.json`` + ``merges.txt`` files that ship inside every CLIP
checkpoint: ``CLIP.from_pretrained(dir)`` + ``CLIPTokenizer.from_dir(dir)``
is a complete offline zero-shot pipeline.

The JAX package splits words with the ``regex`` module's pattern
``<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|
[^\\s\\p{L}\\p{N}]+`` (case-insensitive). The port scans the cleaned text
with ``unicodedata`` instead and needs nothing beyond the standard library.
On cleaned text the two agree exactly: cleaning drops every ``C*``
character (where the two Unicode tables differ: code points one of them
leaves unassigned) and leaves a single space as the only whitespace, and
under case folding only ``ſ`` (U+017F), which lowercasing keeps, matches a
letter of the literal alternatives (``s``), and only U+0345 falls
between the classes (see ``_kind``).

SigLIP's tokenizer is SentencePiece and is not reimplemented: use
``--tokenizer`` (transformers) or pre-tokenized ids there.
"""

from __future__ import annotations

import functools
import json
import unicodedata
from pathlib import Path

import numpy as np

#: BasicTokenizer's CJK ranges (spaced out before BPE, HF parity)
_CJK = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF),
        (0x2A700, 0x2B73F), (0x2B740, 0x2B81F), (0x2B820, 0x2CEAF),
        (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))
SOT = "<|startoftext|>"
EOT = "<|endoftext|>"
#: the literal alternatives of the split pattern, in its order
_LITERALS = (SOT, EOT, "'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def _basic_clean(text: str) -> str:
    """Mirror ``transformers.CLIPTokenizer``'s no-ftfy preprocessing
    (BasicTokenizer with strip_accents=False, do_split_on_punc=False):
    drop NUL/replacement/control chars, map whitespace to spaces, space out
    CJK chars, NFC-normalize, collapse whitespace, lowercase."""
    out = []
    for ch in text:
        cp = ord(ch)
        if cp in (0, 0xFFFD):
            continue
        cat = unicodedata.category(ch)
        # any C* category (control/format/unassigned/private/surrogate)
        # except the whitespace trio is dropped, like HF's _is_control
        if cat.startswith("C") and ch not in "\t\n\r":
            continue
        if ch in "\t\n\r" or cat == "Zs":
            out.append(" ")
        elif cp >= 0x3400 and any(lo <= cp <= hi for lo, hi in _CJK):
            out.append(f" {ch} ")
        else:
            out.append(ch)
    text = unicodedata.normalize("NFC", "".join(out))
    return " ".join(t.lower() for t in text.split())


def _kind(ch: str) -> str:
    """'L' (letter), 'N' (number), ' ' (skipped) or '' (anything else).
    Skipped: whitespace, and U+0345 (a combining mark, Mn), which
    case-folds to a letter (U+03B9): the case-insensitive negated class
    excludes it and the letter class does not take it, so no alternative
    matches it."""
    if ch.isspace() or ch == "\u0345":
        return " "
    cat = unicodedata.category(ch)[0]
    return cat if cat in "LN" else ""


def split_words(text: str) -> list[str]:
    """The split pattern's ``findall`` over cleaned text: at each position
    the first alternative that matches (a literal, a run of letters, one
    number, a run of anything else but whitespace); whitespace is
    skipped."""
    words = []
    folded = text.replace("ſ", "s")  # 'ſ' case-folds to 's'
    i, n = 0, len(text)
    while i < n:
        lit = next((s for s in _LITERALS if folded.startswith(s, i)), None)
        if lit is not None:
            words.append(text[i:i + len(lit)])
            i += len(lit)
            continue
        kind = _kind(text[i])
        if kind == " ":
            i += 1
            continue
        j = i + 1
        if kind != "N":  # letters and the rest run; a number stands alone
            while j < n and _kind(text[j]) == kind:
                j += 1
        words.append(text[i:j])
        i = j
    return words


@functools.lru_cache()
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte <-> printable-unicode table (the byte-level
    BPE alphabet)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _get_pairs(word: tuple[str, ...]) -> set[tuple[str, str]]:
    return set(zip(word[:-1], word[1:]))


class CLIPTokenizer:
    """Byte-level BPE with CLIP's text cleanup and special tokens."""

    SOT = SOT
    EOT = EOT

    def __init__(self, vocab: dict[str, int],
                 merges: list[tuple[str, str]]):
        self.encoder = dict(vocab)
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.sot_id = self.encoder[self.SOT]
        self.eot_id = self.encoder[self.EOT]
        self._cache: dict[str, str] = {}

    @classmethod
    def from_dir(cls, path: str | Path) -> "CLIPTokenizer":
        """Load ``vocab.json`` + ``merges.txt`` from a checkpoint directory
        (the files every HF CLIP checkpoint ships)."""
        p = Path(path)
        vocab = json.loads((p / "vocab.json").read_text(encoding="utf-8"))
        merges = []
        for line in (p / "merges.txt").read_text(
                encoding="utf-8").splitlines():
            if line.startswith("#version") or not line.strip():
                continue
            a, _, b = line.partition(" ")
            merges.append((a, b))
        return cls(vocab, merges)

    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            pair = min(pairs,
                       key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if pair not in self.bpe_ranks:
                break
            a, b = pair
            out = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(a, i)
                except ValueError:
                    out.extend(word[i:])
                    break
                out.extend(word[i:j])
                if j < len(word) - 1 and word[j + 1] == b:
                    out.append(a + b)
                    i = j + 2
                else:
                    out.append(word[j])
                    i = j + 1
            word = tuple(out)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        result = " ".join(word)
        self._cache[token] = result
        return result

    def encode(self, text: str) -> list[int]:
        """Text -> token ids, WITH the sot/eot specials (HF parity)."""
        ids = [self.sot_id]
        for token in split_words(_basic_clean(text)):
            if token in (self.SOT, self.EOT):
                # literal specials map to their single id (HF's added-token
                # trie does the same), never through byte-level BPE
                ids.append(self.encoder[token])
                continue
            mapped = "".join(self.byte_encoder[b]
                             for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(mapped).split(" "))
        ids.append(self.eot_id)
        return ids

    def __call__(self, texts: str | list[str], *, context_length: int = 77
                 ) -> np.ndarray:
        """Batch-encode to int32 [B, context_length], truncated (keeping the
        final EOT) and endoftext-padded like HF's ``padding="max_length"``."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), context_length), self.eot_id, np.int32)
        for i, t in enumerate(texts):
            ids = self.encode(t)
            if len(ids) > context_length:
                ids = ids[: context_length - 1] + [self.eot_id]
            out[i, : len(ids)] = ids
        return out
