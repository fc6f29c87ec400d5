"""Embedding and exact top-k retrieval on the card; the counterpart of
``jimm_tpu/retrieval/`` (its exact half: ROADMAP.md queue 1 item 9 part 1).

- :mod:`~jimm_tpu_torch.retrieval.store`: the persistent vector store
  (content-addressed segments + atomic manifests), byte-compatible with the
  JAX package's both ways, with the prompt-embedding LRU as its hot tier.
- :mod:`~jimm_tpu_torch.retrieval.topk`: exact streaming top-k on the card
  (blocked scoring and a running merge with an explicit tie order, the
  corpus split over the serving topology), tune-resolved.
- :mod:`~jimm_tpu_torch.retrieval.api`: the service ``serve --index`` and
  ``/v1/search`` ride, and the ``jimm_retrieval`` metric namespace.
- :mod:`~jimm_tpu_torch.retrieval.cli`: ``index build|add|ls|verify|
  compact|stats``.

JAX's ``ann/`` (IVF) and ``tier/`` wait for item 9's parts 2 and 3.
Importing this package never imports torch (the scan imports it inside its
functions), so the index CLI stays a host tool.
"""

from jimm_tpu_torch.retrieval.api import (ModeNotPorted, RetrievalService,
                                          retrieval_metrics)
from jimm_tpu_torch.retrieval.store import (LoadedIndex,
                                            PersistentEmbeddingCache,
                                            RetrievalStoreError, VectorStore,
                                            normalize_rows)
from jimm_tpu_torch.retrieval.topk import (IndexSearcher, Searcher,
                                           corpus_layout, merge_partials,
                                           streaming_topk)

__all__ = ["IndexSearcher", "LoadedIndex", "ModeNotPorted",
           "PersistentEmbeddingCache", "RetrievalService",
           "RetrievalStoreError", "Searcher", "VectorStore", "corpus_layout",
           "merge_partials", "normalize_rows", "retrieval_metrics",
           "streaming_topk"]
