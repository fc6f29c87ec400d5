"""Service facade joining the vector store and the top-k searcher to the
serving stack, and the ``jimm_retrieval`` metric namespace; the
counterpart of ``jimm_tpu/retrieval/api.py``.

:class:`RetrievalService` is what ``serve --index`` builds and
:class:`~jimm_tpu_torch.serve.server.ServingServer` consults for
``/v1/search``: the loaded index, its exact
:class:`~jimm_tpu_torch.retrieval.topk.IndexSearcher`, and the series
(JAX's names):

- ``jimm_retrieval_search_total`` / ``jimm_retrieval_embed_total``
  counters (embed counts rows, not requests: a bulk ``/v1/embed`` of 16
  images is 16),
- ``jimm_retrieval_index_size`` / ``jimm_retrieval_index_segments`` /
  ``jimm_retrieval_index_staleness_seconds`` gauges (staleness: seconds
  since the on-disk manifest last changed; a server holds the snapshot it
  loaded),
- the ``retrieval_topk`` span around every scoring call (device scan and
  host merge), in ``jimm_spans_*`` like every span.

``mode="ivf"`` and ``mode="tiered"`` (JAX's approximate and tiered
searchers) are not ported yet: they raise, naming ROADMAP.md queue 1 item
9. Everything here is callable from HTTP handler threads and the CLI.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np

from jimm_tpu_torch.retrieval.store import LoadedIndex, VectorStore
from jimm_tpu_torch.retrieval.topk import IndexSearcher

__all__ = ["ModeNotPorted", "RetrievalService", "retrieval_metrics"]

_MODES = ("exact", "ivf", "tiered")


class ModeNotPorted(ValueError):
    """An index mode whose searcher the port does not have yet."""

    def __init__(self, mode: str):
        super().__init__(
            f"--index-mode {mode} is not ported yet: "
            + ("IVF search, ROADMAP.md queue 1 item 9 part 2" if mode == "ivf"
               else "tiered residency, ROADMAP.md queue 1 item 9 part 3"))


def _check_mode(mode: str) -> None:
    if mode not in _MODES:
        raise ValueError(f"mode must be 'exact', 'ivf', or 'tiered'; "
                         f"got {mode!r}")
    if mode != "exact":
        raise ModeNotPorted(mode)


def retrieval_metrics():
    """The ``jimm_retrieval`` registry's (search_total, embed_total)
    counters, shared by the service and the bulk-embed endpoint."""
    from jimm_tpu_torch import obs
    reg = obs.get_registry("jimm_retrieval")
    return reg.counter("search_total"), reg.counter("embed_total")


class RetrievalService:
    """One named index, searchable: the loaded snapshot, its searcher and
    the metrics. Built once at serve startup (:meth:`from_store`) or
    directly with a searcher."""

    def __init__(self, index: LoadedIndex, searcher: Any, *,
                 store: VectorStore | None = None, mode: str = "exact"):
        from jimm_tpu_torch import obs
        _check_mode(mode)
        self.index = index
        self.searcher = searcher
        self.store = store
        self.mode = mode
        self.search_counter, self.embed_counter = retrieval_metrics()
        reg = obs.get_registry("jimm_retrieval")
        reg.gauge("index_size", lambda: float(len(self.index)))
        reg.gauge("index_segments", fn=self._segments_now)
        reg.gauge("index_staleness_seconds", fn=self._staleness_now)

    @classmethod
    def from_store(cls, store: VectorStore, name: str, *, k: int = 10,
                   buckets=(1,), block_n: int | None = None,
                   plan: Any = None, device: Any = "cuda",
                   mode: str = "exact") -> "RetrievalService":
        _check_mode(mode)
        index = store.load(name)
        searcher = IndexSearcher(index, k=k, buckets=buckets,
                                 block_n=block_n, plan=plan, device=device)
        return cls(index, searcher, store=store, mode=mode)

    # -- gauges -----------------------------------------------------------

    def _segments_now(self) -> float:
        if self.store is None:
            return 1.0
        try:
            return float(self.store.stats(self.index.name)["segments"])
        except Exception:  # noqa: BLE001 — a gauge must never raise
            return 0.0

    def _staleness_now(self) -> float:
        """Seconds since the *on-disk* manifest last changed (concurrent
        writers move it though the serving snapshot is pinned)."""
        updated = self.index.updated
        if self.store is not None:
            try:
                updated = float(
                    self.store.manifest(self.index.name)["updated"])
            except Exception:  # noqa: BLE001
                pass
        return max(0.0, round(time.time() - updated, 3))

    # -- lifecycle --------------------------------------------------------

    def warmup(self) -> dict[int, str]:
        """Run every (partition, bucket) once; the ready line reports the
        per-bucket sources ("eager")."""
        return self.searcher.warmup()

    def trace_count(self) -> int:
        return self.searcher.trace_count()

    def describe(self) -> dict:
        return {"index": self.index.name, "rows": len(self.index),
                "dim": self.index.dim, "dtype": self.index.dtype,
                "metric": self.index.metric, "k": self.searcher.k,
                "block_n": self.searcher.block_n,
                "buckets": list(self.searcher.buckets),
                "partitions": len(getattr(self.searcher, "searchers", [0])),
                "mode": self.mode, "staleness_s": self._staleness_now()}

    # -- queries ----------------------------------------------------------

    def search_blocking(self, queries: np.ndarray, k: int | None = None,
                        nprobe: int | None = None
                        ) -> tuple[np.ndarray, list[list[str]]]:
        """Top-k ids and scores for a ``(D,)`` or ``(B, D)`` query batch.
        ``k`` may trim below the searcher's k but never exceed it (its
        carry width). ``nprobe`` belongs to the IVF mode and is refused.
        Blocks on the device."""
        from jimm_tpu_torch import obs
        from jimm_tpu_torch.serve.admission import RequestError
        queries = np.asarray(queries, np.float32)
        if queries.ndim == 1:
            queries = queries[None, :]
        if queries.ndim != 2 or queries.shape[1] != self.index.dim:
            raise RequestError(
                f"query must have dim {self.index.dim} (index "
                f"{self.index.name!r}); got shape {tuple(queries.shape)}")
        if not np.all(np.isfinite(queries)):
            raise RequestError("query contains non-finite values")
        k_eff = self.searcher.k if k is None else int(k)
        if k_eff < 1 or k_eff > self.searcher.k:
            raise RequestError(
                f"k must be in [1, {self.searcher.k}] (the searcher's "
                f"compiled carry width); got {k_eff}")
        if nprobe is not None:
            raise RequestError(
                "nprobe is only valid in ivf index mode (this server "
                "runs --index-mode exact)")
        with obs.span("retrieval_topk"):
            values, _indices, ids = self.searcher.search(queries)
        self.search_counter.inc(queries.shape[0])
        return values[:, :k_eff], [row[:k_eff] for row in ids]
