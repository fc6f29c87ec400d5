"""Exact top-k retrieval on the card: blocked scoring and a streaming merge;
the port's counterpart of ``jimm_tpu/retrieval/topk.py``.

The ``(B, N)`` score matrix is never built. A partition's rows live on its
device; the scan takes one ``(block_n, D)`` block at a time, scores it
against the ``(B, D)`` queries with ``torch.matmul`` and folds the block
into a running ``(B, k)`` carry with one ``torch.topk``. Block offsets and
row counts are host integers, so the loop makes no host sync (no
``.item()``, no ``.cpu()``): one sync a partition, when its ``(B, k)``
result is read. JAX scores outside any Pallas kernel too (``lax.scan``
over ``lax.top_k``), so this is plain torch by design, not a kernel port.

Exactness (recall@k == 1.0 against a NumPy oracle, ties included) is by
construction:

- **Scores** are each query row dotted with each corpus row in float64
  (every f32 and bf16 value widens exactly, and every product is exact in
  f64), then rounded once to f32. That is the f32 score a stable oracle in
  f64 rounds to, whatever order a GEMM sums in; TF32, which would cut the
  operands to 10 bits, never applies to f64, so the searcher needs no
  precision setting and no global flag of the process can change its
  answer. The corpus is widened once, when it is placed on the device:
  the device holds 8 bytes a value (twice an f32 store's bytes, four
  times a bf16 one's), and a query reads them once.
- **Order** is (score desc, global index asc), stated explicitly:
  ``torch.topk`` makes no promise about tied values on CUDA, so each
  (score, column) pair becomes one int64 key, the f32 score's bits in an
  order-preserving form (``-0.0`` joined to ``+0.0``) in the high half and
  ``2**31 - 1 - column`` in the low half. Keys are unique, so the block
  selection and the carry merge are one ``topk`` of integers with no tie
  to break, and the lowest index wins every equal score, as
  ``tests/test_retrieval.py::test_exact_ties_follow_stable_order`` asks of
  JAX's ``lax.top_k``.
- The empty carry holds the lowest key, so ``k`` past the corpus gives
  ``(-inf, -1)`` tails, as JAX's.

Partitions ride the serving topology (`serve/topology.py`): an ``R``
replica plan splits the corpus into R contiguous row partitions, one a
replica, each sharded over the replica's positions (its devices) as
:func:`corpus_layout` (JAX's layout) cuts it; ``merge_partials`` then
folds the ``R * shards * k`` candidates on the host with an explicit
lexsort, never anything corpus-sized. A shard's device holds its live rows
only: the padding that gives JAX's compiled scan one shape is a host
array here, and a partial last block is scored as a shorter slice.

JAX registers the scan in its AOT store only to skip XLA's compile. Eager
torch compiles nothing, and ``torch.export`` would unroll the block loop,
so the port has no retrieval artifact: ``warmup()`` runs each query bucket
once and reports ``"eager"`` for it, and the trace count stays 0.
``block_n`` resolves through ``tune.best_config("retrieval_topk", ...)``,
whose default without a record is `tune/space.py::retrieval_default`;
an explicit one wins.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Sequence

import numpy as np

from jimm_tpu_torch.retrieval.store import LoadedIndex, normalize_rows

__all__ = ["IndexSearcher", "Searcher", "corpus_layout", "merge_partials",
           "scan_partition", "streaming_topk", "synthetic_scan"]

#: the low half of a key: 2**31 - 1 - column, so a lower column ranks first
_IDX_MAX = 2 ** 31 - 1
#: the empty carry: below every real key (whose high half is at least
#: -2**31 + 1)
_EMPTY_KEY = -2 ** 63 + 1


def _ceil_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


# ---------------------------------------------------------------------------
# device scan
# ---------------------------------------------------------------------------

def _keys(scores, low):
    """int64 keys of f32 ``scores`` (B, n) at columns whose low halves are
    ``low`` (n,): the score's bits made order-preserving (a negative
    float's magnitude bits flipped, then 1 added so that -0.0 joins +0.0)
    in the high half."""
    import torch
    bits = scores.view(torch.int32)
    ordered = torch.where(bits < 0, (bits ^ 0x7FFFFFFF) + 1, bits)
    return (ordered.to(torch.int64) << 32) + low


def _decode(keys):
    """``(values f32, indices int64)`` of keys; the empty key gives ``(-inf,
    -1)``."""
    import torch
    ordered = (keys >> 32).to(torch.int32)
    bits = torch.where(ordered < 0, (ordered - 1) ^ 0x7FFFFFFF, ordered)
    values = bits.view(torch.float32)
    indices = _IDX_MAX - (keys & 0xFFFFFFFF)
    empty = keys <= _EMPTY_KEY
    return (values.masked_fill(empty, -math.inf),
            indices.masked_fill(empty, -1))


def scan_partition(rows, start: int, block_n: int, queries, k: int):
    """Top-k of one shard: ``rows`` ``(n, D)`` f64 on a device, the live
    rows of global rows ``start .. start + n``, scored ``block_n`` at a
    time against ``queries`` ``(B, D)`` on the same device. Returns
    ``(values (B, k) f32, indices (B, k) int64)`` on the device, best
    first; no host sync."""
    import torch
    device = rows.device
    q = queries.to(device=device, dtype=torch.float64)
    cols = torch.arange(block_n, device=device, dtype=torch.int64)
    carry = torch.full((q.shape[0], k), _EMPTY_KEY, dtype=torch.int64,
                       device=device)
    for lo in range(0, rows.shape[0], block_n):
        block = rows[lo:lo + block_n]
        scores = (q @ block.T).to(torch.float32)
        keys = _keys(scores, (_IDX_MAX - start - lo) - cols[:block.shape[0]])
        carry = torch.cat([carry, keys], dim=1).topk(k, dim=1).values
    return _decode(carry)


def _to_torch(mat: np.ndarray):
    """A host corpus as a tensor: f32, or bf16 from its ``uint16`` bits."""
    import torch
    if mat.dtype == np.uint16:
        return torch.from_numpy(mat.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.asarray(mat, np.float32))


def _on_device(mat: np.ndarray, device: Any):
    """Host rows (f32, or bf16 as ``uint16`` bits) as f64 on ``device``,
    widened there."""
    import torch
    return _to_torch(mat).to(device).to(torch.float64)


def synthetic_scan(batch: int, n_rows: int, dim: int, dtype, block_n: int,
                   device: Any, k: int = 10):
    """The tune bench's closure: one scan of ``batch`` seeded unit queries
    against a seeded unit corpus of ``n_rows`` x ``dim`` stored in
    ``dtype``, held on ``device`` as the searcher holds it (f64)."""
    import torch
    g = torch.Generator(device=device).manual_seed(0)
    rows = torch.randn((n_rows, dim), generator=g, device=device)
    rows = torch.nn.functional.normalize(rows, dim=1).to(dtype).to(
        torch.float64)
    queries = torch.randn((batch, dim), generator=g, device=device)
    return lambda: scan_partition(rows, 0, block_n, queries, k)


# ---------------------------------------------------------------------------
# host-side layout and merge
# ---------------------------------------------------------------------------

def corpus_layout(corpus: np.ndarray, *, block_n: int, shards: int = 1,
                  base: int = 0,
                  pad_rows: int | None = None
                  ) -> tuple[np.ndarray, np.ndarray, int]:
    """Pack an ``(N, D)`` corpus into the device layout (JAX's).

    Returns ``(blocks (S, nb, bn, D), offsets (S, nb) i32, valid)``.
    ``pad_rows`` pads the partition to a common row count so every replica
    partition of one index shares shapes; ``base`` shifts offsets so
    indices stay global across partitions.
    """
    corpus = np.asarray(corpus)
    if corpus.ndim != 2:
        raise ValueError(f"corpus must be (N, D); got {corpus.shape}")
    n, dim = corpus.shape
    shards = max(1, int(shards))
    block_n = max(1, int(block_n))
    target = max(int(pad_rows) if pad_rows is not None else n, 1)
    if target < n:
        raise ValueError(f"pad_rows={target} < corpus rows {n}")
    per_shard = _ceil_to(math.ceil(target / shards), block_n)
    nblocks = per_shard // block_n
    padded = np.zeros((shards * per_shard, dim), corpus.dtype)
    padded[:n] = corpus
    blocks = padded.reshape(shards, nblocks, block_n, dim)
    offsets = (base
               + np.arange(shards, dtype=np.int32)[:, None] * per_shard
               + np.arange(nblocks, dtype=np.int32)[None, :] * block_n)
    return blocks, np.ascontiguousarray(offsets), base + n


def merge_partials(values: np.ndarray, indices: np.ndarray,
                   k: int) -> tuple[np.ndarray, np.ndarray]:
    """Fold ``(P, B, k)`` per-shard/per-replica partials into the global
    ``(B, k)`` result (JAX's): the candidate set is ``P * k`` per query,
    bounded by the merge fan-in, never by corpus size, so an explicit
    (score desc, global index asc) lexsort here reproduces the stable
    oracle's tie order exactly."""
    values = np.asarray(values, np.float32)
    indices = np.asarray(indices, np.int64)
    partials, batch, kk = values.shape
    flat_v = values.transpose(1, 0, 2).reshape(batch, partials * kk)
    flat_i = indices.transpose(1, 0, 2).reshape(batch, partials * kk)
    if flat_v.shape[1] < k:
        # k past the whole fan-in: keep the (B, k) shape and let (-inf, -1)
        # padding mark the underfill
        pad = k - flat_v.shape[1]
        flat_v = np.pad(flat_v, ((0, 0), (0, pad)),
                        constant_values=-np.inf)
        flat_i = np.pad(flat_i, ((0, 0), (0, pad)), constant_values=-1)
    # padding candidates (idx -1, val -inf) lose every comparison
    sort_i = np.where(flat_i < 0, np.iinfo(np.int64).max, flat_i)
    order = np.lexsort((sort_i, -flat_v), axis=-1)[:, :k]
    return (np.take_along_axis(flat_v, order, axis=1),
            np.take_along_axis(flat_i, order, axis=1))


def streaming_topk(queries: np.ndarray, corpus: np.ndarray, k: int, *,
                   block_n: int | None = None, device: Any = "cuda"
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Single-device convenience: exact top-k of ``queries`` against
    ``corpus`` by the streaming scan (``block_n`` resolved as the
    searcher's). Returns host ``(values (B, k), indices (B, k))`` with
    ``-1``/``-inf`` tails when ``k > N``. The parity tests drive this
    directly."""
    import torch
    queries = np.asarray(queries, np.float32)
    corpus = np.asarray(corpus)
    dtype = "bfloat16" if corpus.dtype == np.uint16 else "float32"
    block_n = _resolve_block_n(corpus.shape[0], corpus.shape[1], dtype,
                               queries.shape[0], block_n, device)
    vals, idx = scan_partition(_on_device(corpus, device), 0, block_n,
                               torch.from_numpy(queries), int(k))
    return vals.cpu().numpy(), idx.cpu().numpy()


# ---------------------------------------------------------------------------
# searchers (tune-resolved; eager, so nothing to warm but the buckets)
# ---------------------------------------------------------------------------

def _resolve_block_n(n: int, dim: int, dtype: str, batch: int,
                     block_n: int | None, device: Any) -> int:
    """Explicit block wins (the tuner's bench must not recurse); otherwise
    the tune cache's record at this shape, else JAX's default rule."""
    if block_n is not None:
        if int(block_n) < 1:
            raise ValueError(f"block_n must be >= 1; got {block_n}")
        return int(block_n)
    from jimm_tpu_torch.tune.api import best_config
    # one dtype an operand, as `tune run` keys them: f32 queries
    config = best_config("retrieval_topk",
                         shapes=[(int(batch), int(dim)), (int(n), int(dim))],
                         dtypes=["float32", dtype], device=device)
    return int(config["block_n"])


class Searcher:
    """One partition's scan: its rows resident on its devices in f64 (one
    shard a device), the query buckets it pads batches to.

    ``search_partial`` returns host partials ``(values (S, B, k), indices
    (S, B, k))`` with global indices. Batches past the largest bucket run
    as chunks of it, and smaller ones pad to their bucket, so each bucket
    keeps one shape (and one GEMM choice) on the card."""

    def __init__(self, corpus: np.ndarray, *, k: int,
                 buckets: Sequence[int] = (1,), block_n: int | None = None,
                 devices: Sequence[Any] = ("cuda",), base: int = 0,
                 pad_rows: int | None = None):
        import torch
        corpus = np.ascontiguousarray(np.asarray(corpus))
        self.k = int(k)
        self.buckets = tuple(sorted(int(b) for b in buckets))
        self.dim = int(corpus.shape[1])
        self.n_rows = int(corpus.shape[0])
        self.devices = [torch.device(d) for d in devices]
        self.shards = len(self.devices)
        dtype = "bfloat16" if corpus.dtype == np.uint16 else "float32"
        self.block_n = _resolve_block_n(self.n_rows, self.dim, dtype,
                                        self.buckets[-1], block_n,
                                        self.devices[0])
        # JAX's layout cuts the shards; each device gets its shard's live
        # rows, widened to f64 once (see the module docstring)
        blocks, offsets, valid = corpus_layout(
            corpus, shards=self.shards, block_n=self.block_n, base=base,
            pad_rows=pad_rows)
        per_shard = blocks.shape[1] * blocks.shape[2]
        self._starts = [int(offsets[s, 0]) for s in range(self.shards)]
        self._rows = [
            _on_device(blocks[s].reshape(per_shard, self.dim)[
                :min(per_shard, max(0, valid - start))], d)
            for s, (d, start) in enumerate(zip(self.devices, self._starts))]

    def trace_count(self) -> int:
        """Programs traced or compiled to serve: none, eager torch."""
        return 0

    def resident_bytes(self) -> int:
        """Device-resident corpus bytes (the shards' f64 rows)."""
        return sum(r.numel() * r.element_size() for r in self._rows)

    def warmup(self) -> dict[int, str]:
        """Run every bucket once (the card's first GEMMs of each shape);
        returns {bucket: "eager"}, the source JAX's AOT store reports."""
        for bucket in self.buckets:
            self.search_partial(np.zeros((bucket, self.dim), np.float32))
        return {bucket: "eager" for bucket in self.buckets}

    def _bucket_for(self, batch: int) -> int:
        for bucket in self.buckets:
            if batch <= bucket:
                return bucket
        raise ValueError(f"query batch {batch} exceeds largest retrieval "
                         f"bucket {self.buckets[-1]}")

    def search_partial(self, queries: np.ndarray
                       ) -> tuple[np.ndarray, np.ndarray]:
        """Score a ``(B, D)`` f32 query batch; host partials ``(values (S,
        B, k), indices (S, B, k))`` with global indices."""
        import torch
        queries = np.asarray(queries, np.float32)
        batch = queries.shape[0]
        top = self.buckets[-1]
        if batch > top:
            outs = [self.search_partial(queries[i:i + top])
                    for i in range(0, batch, top)]
            return (np.concatenate([o[0] for o in outs], axis=1),
                    np.concatenate([o[1] for o in outs], axis=1))
        bucket = self._bucket_for(batch)
        padded = np.zeros((bucket, self.dim), np.float32)
        padded[:batch] = queries
        host = torch.from_numpy(padded)
        # every shard's scan is launched before any is read
        partials = [scan_partition(rows, start, self.block_n,
                                   host.to(rows.device), self.k)
                    for rows, start in zip(self._rows, self._starts)]
        values = np.stack([v.cpu().numpy() for v, _ in partials])
        indices = np.stack([i.cpu().numpy() for _, i in partials])
        return values[:, :batch], indices[:, :batch]


class IndexSearcher:
    """Search one :class:`LoadedIndex` across the serving topology.

    On a trivial (or absent) plan this is one :class:`Searcher` on
    ``device``. On an ``R``-replica plan the corpus splits into R
    contiguous, equally padded row partitions, one a replica, each sharded
    over the replica's devices (its positions); ``search`` merges the
    partials on the host and maps global row indices back to ids.
    """

    def __init__(self, index: LoadedIndex, *, k: int = 10,
                 buckets: Sequence[int] = (1,),
                 block_n: int | None = None, plan: Any = None,
                 device: Any = "cuda"):
        if len(index) == 0:
            raise ValueError(f"index {index.name!r} is empty")
        self.index = index
        self.k = int(k)
        self.buckets = tuple(sorted(int(b) for b in buckets))
        corpus = index.vectors
        if plan is not None and not plan.is_trivial:
            replicas = plan.replicas
            chunk = math.ceil(len(index) / replicas)
            self.searchers = [
                Searcher(corpus[r * chunk:(r + 1) * chunk], k=self.k,
                         buckets=self.buckets, block_n=block_n,
                         devices=plan.device_groups[r], base=r * chunk,
                         pad_rows=chunk)
                for r in range(replicas)]
        else:
            self.searchers = [Searcher(corpus, k=self.k,
                                       buckets=self.buckets,
                                       block_n=block_n, devices=(device,))]
        #: {bucket: "eager"} after warmup
        self.warmup_report: dict[int, str] = {}
        self._dispatch_lock = threading.Lock()

    @property
    def block_n(self) -> int:
        return self.searchers[0].block_n

    def trace_count(self) -> int:
        return sum(s.trace_count() for s in self.searchers)

    def resident_bytes(self) -> int:
        return sum(s.resident_bytes() for s in self.searchers)

    def warmup(self) -> dict[int, str]:
        """Warm every (partition, bucket); returns the {bucket: source} map
        the serve ready line reports."""
        for searcher in self.searchers:
            self.warmup_report = searcher.warmup()
        return dict(self.warmup_report)

    def search(self, queries: np.ndarray
               ) -> tuple[np.ndarray, np.ndarray, list[list[str]]]:
        """Top-k over the whole index for a ``(B, D)`` (or ``(D,)``) query
        batch, unit-normalized on the host (cosine). Returns ``(values (B,
        k'), indices (B, k'), ids)`` with ``k' = min(k, N)``."""
        queries = np.asarray(queries, np.float32)
        if queries.ndim == 1:
            queries = queries[None, :]
        if queries.ndim != 2 or queries.shape[1] != self.index.dim:
            raise ValueError(
                f"queries must be (B, {self.index.dim}); got "
                f"{queries.shape}")
        queries = normalize_rows(queries)
        # one search on the devices at a time: handler threads all land
        # here, and the scans share the default streams
        with self._dispatch_lock:
            partials = [s.search_partial(queries) for s in self.searchers]
        values = np.concatenate([p[0] for p in partials], axis=0)
        indices = np.concatenate([p[1] for p in partials], axis=0)
        k_eff = min(self.k, len(self.index))
        vals, idx = merge_partials(values, indices, k_eff)
        ids = [[self.index.ids[j] for j in row] for row in idx]
        return vals, idx, ids
