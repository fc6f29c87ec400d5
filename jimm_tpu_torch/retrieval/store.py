"""Persistent, incrementally-updatable vector store (host side, no torch);
the port's copy of ``jimm_tpu/retrieval/store.py``, byte-compatible with it
both ways: the same ids and vectors give the same segment payloads and
fingerprints, and either package loads a store the other wrote.

An *index* is a named, append-only set of immutable **segments** plus a
tombstone list. Each segment is one content-addressed payload (a header
JSON line + raw row-major vector bytes) in the port's
:class:`~jimm_tpu_torch.aot.store.ArtifactStore`: atomic tempdir +
``os.replace`` writes, a SHA-256 check on every read, quarantine (never
delete) on corruption. The per-index **manifest** (``indexes/<name>.json``)
lists segment fingerprints and deleted ids and is itself replaced
atomically, so a crashed writer never leaves an index half-trusted.

- ``add`` writes one new segment, then swaps in a manifest that references
  it. Rows are L2-normalized first (the ``cosine`` metric is a dot product
  over unit rows, what `retrieval/topk.py` scores).
- ``delete`` only touches the manifest (tombstones).
- ``compact`` folds every live row into one fresh segment, clears the
  tombstones and drops the unreferenced segment entries.

The **hot tier** is `serve/cache.py`'s LRU: loaded matrices are memoized by
manifest state (any mutation changes the key, so a stale matrix never
serves), and :class:`PersistentEmbeddingCache` puts the zero-shot
class-weight cache in front of this store, so repeat label sets skip the
text tower across processes.

IVF (item 9 part 2 of ROADMAP.md queue 1) is not ported: the codebook and
cluster-run members (``set_codebook``, ``build_ivf``, ``ann_status``, ...)
wait for it. A manifest's ``ann`` block and a segment's ``clusters`` runs,
which JAX's IVF writes, are read and preserved: such a store loads for
exact search, ``add`` and ``delete`` keep the codebook entry as it was, and
the state hash (the hot tier's and the staleness gauge's key) covers it as
JAX's does. Rows this package appends carry no cluster runs, which JAX's
``ann_status`` counts as unassigned (its ``build-ivf`` assigns them);
``compact`` of such an index is refused rather than dropping the runs.

bfloat16 matrices need no ``ml_dtypes``: rows round to bfloat16 by the
same round-to-nearest-even on their f32 bits, and a loaded bf16 index
holds its rows as ``uint16`` bit patterns (:meth:`LoadedIndex.matrix_f32`
widens them exactly).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import tempfile
import time
from pathlib import Path
from typing import Callable, Sequence

import numpy as np

from jimm_tpu_torch.aot.store import ArtifactStore
from jimm_tpu_torch.serve.cache import EmbeddingCache

__all__ = ["LoadedIndex", "PersistentEmbeddingCache", "RetrievalStoreError",
           "RETRIEVAL_FORMAT_VERSION", "VectorStore", "bf16_bits",
           "bf16_to_f32", "decode_segment", "encode_segment",
           "normalize_rows"]

#: bump when the segment framing or manifest schema changes (JAX's value:
#: both packages read one format)
RETRIEVAL_FORMAT_VERSION = 1

#: vector stores hold data, not derived artifacts: the backing store's LRU
#: eviction must effectively never fire
VECTOR_STORE_MAX_BYTES = 1 << 40

_DTYPES = ("float32", "bfloat16")


class RetrievalStoreError(RuntimeError):
    """Index-level failure: unknown index, schema mismatch, or a segment
    that failed integrity validation (already quarantined)."""


def _check_dtype(name: str) -> None:
    if name not in _DTYPES:
        raise RetrievalStoreError(
            f"unsupported vector dtype {name!r}; choose from {_DTYPES}")


def _itemsize(name: str) -> int:
    _check_dtype(name)
    return 4 if name == "float32" else 2


def bf16_bits(mat: np.ndarray) -> np.ndarray:
    """bfloat16 bit patterns (``uint16``) of a matrix: ``uint16`` input is
    taken as bits already; anything else rounds from f32 to nearest, ties
    to even (``ml_dtypes``' cast, for finite values)."""
    mat = np.asarray(mat)
    if mat.dtype == np.uint16:
        return mat
    u = np.ascontiguousarray(mat, np.float32).view(np.uint32)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    """The f32 values of bfloat16 bit patterns (exact)."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16).view(
        np.float32)


def normalize_rows(vectors: np.ndarray) -> np.ndarray:
    """Unit-L2 rows in float32 (zero rows stay zero instead of NaN)."""
    mat = np.asarray(vectors, np.float32)
    norms = np.linalg.norm(mat, axis=-1, keepdims=True)
    return mat / np.where(norms == 0.0, 1.0, norms)


def _storage(mat: np.ndarray, dtype: str) -> np.ndarray:
    """A matrix as its stored rows: f32, or bfloat16 bits."""
    _check_dtype(dtype)
    if dtype == "bfloat16":
        return bf16_bits(mat)
    return np.asarray(mat, np.float32)


def encode_segment(ids: Sequence[str], vectors: np.ndarray,
                   dtype: str) -> bytes:
    """Frame one segment payload: header JSON line + raw row bytes."""
    mat = np.ascontiguousarray(_storage(vectors, dtype))
    header = {"retrieval_format": RETRIEVAL_FORMAT_VERSION,
              "ids": list(ids), "rows": int(mat.shape[0]),
              "dim": int(mat.shape[1]), "dtype": dtype}
    return json.dumps(header, sort_keys=True,
                      separators=(",", ":")).encode() + b"\n" + mat.tobytes()


def decode_segment(payload: bytes) -> tuple[list[str], np.ndarray]:
    """Inverse of :func:`encode_segment` (bf16 rows as ``uint16`` bits);
    raises RetrievalStoreError on any framing or shape inconsistency (the
    caller quarantines)."""
    head, sep, body = payload.partition(b"\n")
    if not sep:
        raise RetrievalStoreError("segment payload has no header line")
    try:
        header = json.loads(head)
    except ValueError as e:
        raise RetrievalStoreError(f"bad segment header: {e}") from None
    if header.get("retrieval_format") != RETRIEVAL_FORMAT_VERSION:
        raise RetrievalStoreError(
            f"segment retrieval_format {header.get('retrieval_format')!r} "
            f"!= {RETRIEVAL_FORMAT_VERSION}")
    itemsize = _itemsize(header["dtype"])
    rows, dim = int(header["rows"]), int(header["dim"])
    expected = rows * dim * itemsize
    if len(body) != expected:
        raise RetrievalStoreError(
            f"segment body is {len(body)} bytes, header promises {expected}")
    ids = [str(s) for s in header["ids"]]
    if len(ids) != rows:
        raise RetrievalStoreError(
            f"segment has {len(ids)} ids for {rows} rows")
    dtype = np.float32 if itemsize == 4 else np.uint16
    return ids, np.frombuffer(body, dtype).reshape(rows, dim)


@dataclasses.dataclass(frozen=True)
class LoadedIndex:
    """One index materialized on host: live ids + the (N, D) matrix (f32,
    or bfloat16 bits as ``uint16``).

    ``state`` hashes the manifest's segment list, tombstones and ``ann``
    block: it changes on every mutation, so it keys the hot tier and the
    staleness gauges serving exposes."""

    name: str
    ids: tuple[str, ...]
    vectors: np.ndarray
    dim: int
    dtype: str
    metric: str
    state: str
    updated: float

    def __len__(self) -> int:
        return len(self.ids)

    def matrix_f32(self) -> np.ndarray:
        """Float32 view of the corpus (the NumPy-oracle / scoring form)."""
        if self.dtype == "bfloat16":
            return bf16_to_f32(self.vectors)
        return np.asarray(self.vectors, np.float32)


class VectorStore:
    """See module docstring. One root holds many named indexes plus the
    persistent prompt-embedding tier; segment payloads share one
    content-addressed :class:`ArtifactStore`."""

    def __init__(self, root: str | os.PathLike,
                 max_bytes: int | None = None):
        self.root = Path(root).expanduser()
        self.artifacts = ArtifactStore(
            self.root, max_bytes if max_bytes is not None
            else VECTOR_STORE_MAX_BYTES)
        self.indexes_dir = self.root / "indexes"
        self.indexes_dir.mkdir(parents=True, exist_ok=True)
        #: hot tier for loaded matrices, keyed by (name, state)
        self.hot = EmbeddingCache(capacity=8)

    # -- manifests --------------------------------------------------------

    def _manifest_path(self, name: str) -> Path:
        if not name or "/" in name or name.startswith("."):
            raise RetrievalStoreError(f"bad index name {name!r}")
        return self.indexes_dir / f"{name}.json"

    def manifest(self, name: str) -> dict:
        path = self._manifest_path(name)
        try:
            man = json.loads(path.read_text())
        except FileNotFoundError:
            raise RetrievalStoreError(
                f"no index {name!r} under {self.root} (create it with "
                f"`index build`)") from None
        except (OSError, ValueError) as e:
            raise RetrievalStoreError(f"unreadable manifest for {name!r}: "
                                      f"{e}") from None
        if man.get("retrieval_format") != RETRIEVAL_FORMAT_VERSION:
            raise RetrievalStoreError(
                f"index {name!r} has retrieval_format "
                f"{man.get('retrieval_format')!r}, this build reads "
                f"{RETRIEVAL_FORMAT_VERSION}")
        return man

    def _write_manifest(self, name: str, man: dict) -> None:
        man["updated"] = time.time()
        path = self._manifest_path(name)
        fd, tmp = tempfile.mkstemp(prefix=f".{name}-", dir=self.indexes_dir)
        try:
            with os.fdopen(fd, "w") as f:
                f.write(json.dumps(man, indent=1, sort_keys=True))
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def names(self) -> list[str]:
        return sorted(p.stem for p in self.indexes_dir.glob("*.json"))

    @staticmethod
    def _state_hash(man: dict) -> str:
        # JAX's: the ann block rides in the state too (a codebook swap
        # changes what an IVF searcher returns)
        h = hashlib.sha256()
        h.update(json.dumps(
            {"segments": man.get("segments", []),
             "tombstones": sorted(man.get("tombstones", [])),
             "ann": man.get("ann")},
            sort_keys=True, separators=(",", ":")).encode())
        return h.hexdigest()

    # -- mutation ---------------------------------------------------------

    def create(self, name: str, dim: int, *, dtype: str = "float32",
               metric: str = "cosine", exist_ok: bool = False) -> dict:
        if dtype not in _DTYPES:
            raise RetrievalStoreError(
                f"unsupported dtype {dtype!r}; choose from {_DTYPES}")
        if metric != "cosine":
            raise RetrievalStoreError(
                f"unsupported metric {metric!r} (only 'cosine' for now)")
        path = self._manifest_path(name)
        if path.exists():
            if exist_ok:
                return self.manifest(name)
            raise RetrievalStoreError(f"index {name!r} already exists")
        man = {"retrieval_format": RETRIEVAL_FORMAT_VERSION, "name": name,
               "dim": int(dim), "dtype": dtype, "metric": metric,
               "created": time.time(), "segments": [], "tombstones": []}
        self._write_manifest(name, man)
        return man

    @staticmethod
    def _live_ids(man: dict) -> set[str]:
        dead = set(man.get("tombstones", []))
        live: set[str] = set()
        for seg in man.get("segments", []):
            live.update(i for i in seg["ids"] if i not in dead)
        return live

    def _put_segment(self, name: str, man: dict, ids: list[str],
                     rows: np.ndarray) -> str:
        payload = encode_segment(ids, rows, man["dtype"])
        fp = hashlib.sha256(payload).hexdigest()
        self.artifacts.put(fp, payload,
                           meta={"label": f"retrieval:{name}",
                                 "kind": "segment", "rows": len(ids),
                                 "dim": int(man["dim"]),
                                 "vector_dtype": man["dtype"],
                                 "retrieval_format":
                                     RETRIEVAL_FORMAT_VERSION})
        return fp

    def add(self, name: str, ids: Sequence[str],
            vectors: np.ndarray) -> str:
        """Persist one batch of (id, vector) rows as a new segment and
        reference it from the manifest. Returns the segment fingerprint.
        Rows are unit-normalized; re-adding a tombstoned id revives it."""
        man = self.manifest(name)
        ids = [str(i) for i in ids]
        mat = np.asarray(vectors)
        if mat.ndim != 2 or mat.shape[0] != len(ids):
            raise RetrievalStoreError(
                f"vectors must be (len(ids), dim); got {mat.shape} for "
                f"{len(ids)} ids")
        if mat.shape[1] != man["dim"]:
            raise RetrievalStoreError(
                f"index {name!r} is dim {man['dim']}, vectors are dim "
                f"{mat.shape[1]}")
        if len(set(ids)) != len(ids):
            raise RetrievalStoreError("duplicate ids within one add() batch")
        if not ids:
            raise RetrievalStoreError("add() needs at least one row")
        clashes = self._live_ids(man) & set(ids)
        if clashes:
            raise RetrievalStoreError(
                f"ids already live in index {name!r}: "
                f"{sorted(clashes)[:5]}{'...' if len(clashes) > 5 else ''} "
                f"(delete them first)")
        if not np.all(np.isfinite(np.asarray(mat, np.float32))):
            raise RetrievalStoreError("vectors contain non-finite values")
        fp = self._put_segment(name, man, ids, normalize_rows(mat))
        man["segments"] = list(man.get("segments", [])) + [
            {"fingerprint": fp, "rows": len(ids), "ids": ids}]
        man["tombstones"] = sorted(set(man.get("tombstones", [])) - set(ids))
        self._write_manifest(name, man)
        return fp

    def delete(self, name: str, ids: Sequence[str]) -> int:
        """Tombstone ``ids``; returns how many were live. Segment bytes are
        untouched until ``compact``."""
        man = self.manifest(name)
        live = self._live_ids(man)
        dead = [str(i) for i in ids if str(i) in live]
        if dead:
            man["tombstones"] = sorted(set(man.get("tombstones", []))
                                       | set(dead))
            self._write_manifest(name, man)
        return len(dead)

    def compact(self, name: str) -> dict:
        """Fold live rows into one segment, clear tombstones, and drop the
        old segment entries. Returns a {segments_before/after, rows,
        reclaimed_bytes} report. An index with a codebook is refused: its
        compaction re-emits cluster runs, which waits for IVF."""
        man = self.manifest(name)
        if man.get("ann"):
            raise RetrievalStoreError(
                f"index {name!r} has an IVF codebook: compacting it "
                f"re-clusters its rows, which is not ported yet (ROADMAP.md "
                f"queue 1 item 9 part 2)")
        loaded = self.load(name)
        before = list(man.get("segments", []))
        new_segments = []
        if len(loaded):
            fp = self._put_segment(name, man, list(loaded.ids),
                                   np.asarray(loaded.vectors))
            new_segments = [{"fingerprint": fp, "rows": len(loaded),
                             "ids": list(loaded.ids)}]
        man["segments"] = new_segments
        man["tombstones"] = []
        self._write_manifest(name, man)
        keep = {s["fingerprint"] for s in new_segments}
        reclaimed = 0
        for seg in before:
            if seg["fingerprint"] in keep:
                continue
            entry = self.artifacts.entry_dir(seg["fingerprint"])
            if entry.exists():
                reclaimed += sum(p.stat().st_size
                                 for p in entry.rglob("*") if p.is_file())
                shutil.rmtree(entry, ignore_errors=True)
        return {"segments_before": len(before),
                "segments_after": len(new_segments),
                "rows": len(loaded), "reclaimed_bytes": reclaimed}

    # -- read -------------------------------------------------------------

    def _read_segment(self, name: str, fingerprint: str
                      ) -> tuple[list[str], np.ndarray]:
        payload = self.artifacts.get(fingerprint)
        if payload is None:
            raise RetrievalStoreError(
                f"index {name!r} references segment "
                f"{fingerprint[:12]}... which is missing or failed "
                f"integrity checks (see {self.artifacts.quarantine_dir})")
        try:
            return decode_segment(payload)
        except RetrievalStoreError:
            self.artifacts.quarantine(fingerprint,
                                      "segment payload failed to decode")
            raise

    def load(self, name: str) -> LoadedIndex:
        """Materialize an index on host; hot-tier memoized by manifest
        state so repeat loads of an unmutated index are a dict probe."""
        man = self.manifest(name)
        state = self._state_hash(man)
        cache_key = f"index:{name}:{state}"
        cached = self.hot.get(cache_key)
        if cached is not None:
            ids, mat = cached
        else:
            dead = set(man.get("tombstones", []))
            # a re-added id leaves its stale row in the older segment; the
            # newest segment mentioning an id owns it
            owner: dict[str, int] = {}
            for si, seg in enumerate(man.get("segments", [])):
                for sid in seg["ids"]:
                    owner[sid] = si
            id_list: list[str] = []
            parts: list[np.ndarray] = []
            for si, seg in enumerate(man.get("segments", [])):
                seg_ids, seg_mat = self._read_segment(name,
                                                      seg["fingerprint"])
                keep = [i for i, sid in enumerate(seg_ids)
                        if sid not in dead and owner.get(sid) == si]
                if keep:
                    id_list.extend(seg_ids[i] for i in keep)
                    parts.append(seg_mat[keep])
            mat = (np.concatenate(parts, axis=0) if parts
                   else np.zeros((0, man["dim"]),
                                 np.float32 if man["dtype"] == "float32"
                                 else np.uint16))
            ids = tuple(id_list)
            self.hot.put(cache_key, (ids, mat))  # type: ignore[arg-type]
        return LoadedIndex(name=name, ids=tuple(ids), vectors=mat,
                           dim=int(man["dim"]), dtype=man["dtype"],
                           metric=man["metric"], state=state,
                           updated=float(man.get("updated",
                                                 man.get("created", 0.0))))

    def stats(self, name: str) -> dict:
        """Row, segment and byte counts of one index (JAX's fields; an IVF
        index's ``ann`` block, JAX's ``ann_status``, waits for IVF)."""
        man = self.manifest(name)
        segs = man.get("segments", [])
        total_rows = sum(int(s["rows"]) for s in segs)
        live = len(self._live_ids(man))
        nbytes = 0
        for seg in segs:
            art = self.artifacts.entry_dir(seg["fingerprint"]) / \
                "artifact.bin"
            if art.is_file():
                nbytes += art.stat().st_size
        return {"name": name, "rows": live, "dim": int(man["dim"]),
                "dtype": man["dtype"], "metric": man["metric"],
                "segments": len(segs), "dead_rows": total_rows - live,
                "tombstones": len(man.get("tombstones", [])),
                "bytes": nbytes,
                "updated": float(man.get("updated",
                                         man.get("created", 0.0)))}

    def ls(self) -> list[dict]:
        return [self.stats(name) for name in self.names()]

    def verify(self, name: str | None = None) -> list[dict]:
        """Re-validate manifests and segment payloads; quarantine bad
        segments. Returns one record per problem found (empty == healthy).
        """
        problems: list[dict] = []
        names = [name] if name is not None else self.names()
        for nm in names:
            try:
                man = self.manifest(nm)
            except RetrievalStoreError as e:
                problems.append({"index": nm, "reason": str(e)})
                continue
            for seg in man.get("segments", []):
                fp = seg["fingerprint"]
                payload = self.artifacts.get(fp)
                reason = None
                if payload is None:
                    reason = ("segment missing or failed store integrity "
                              "(quarantined)")
                else:
                    try:
                        seg_ids, seg_mat = decode_segment(payload)
                    except RetrievalStoreError as e:
                        reason = str(e)
                        self.artifacts.quarantine(fp, reason)
                    else:
                        runs = seg.get("clusters")
                        if seg_ids != [str(s) for s in seg["ids"]]:
                            reason = "segment ids disagree with manifest"
                        elif seg_mat.shape[1] != man["dim"]:
                            reason = (f"segment dim {seg_mat.shape[1]} != "
                                      f"index dim {man['dim']}")
                        elif runs is not None and \
                                sum(int(r[1]) for r in runs) != \
                                int(seg["rows"]):
                            reason = (f"cluster runs cover "
                                      f"{sum(int(r[1]) for r in runs)} "
                                      f"rows, segment has {seg['rows']}")
                        if reason:
                            self.artifacts.quarantine(fp, reason)
                if reason:
                    problems.append({"index": nm, "segment": fp,
                                     "reason": reason})
            ann = man.get("ann")
            if ann and self.artifacts.get(ann["codebook"]) is None:
                problems.append({"index": nm,
                                 "segment": ann["codebook"],
                                 "reason": "codebook artifact missing or "
                                           "failed store integrity"})
        return problems

    # -- prompt-embedding tier --------------------------------------------

    def prompt_cache(self, capacity: int = 32) -> "PersistentEmbeddingCache":
        """The persistent form of ``serve.cache.class_embedding_cache()``:
        the LRU in front of this store, so repeat zero-shot label sets skip
        the text tower across process restarts."""
        return PersistentEmbeddingCache(self, capacity=capacity)


class PersistentEmbeddingCache:
    """Two-tier embedding matrix cache: `serve/cache.py`'s LRU in host RAM,
    this store on disk. Same ``get``/``put``/``get_or_build`` surface as
    :class:`EmbeddingCache`, so ``classify`` swaps it in unchanged; its
    entries are JAX's (the same fingerprints and payloads)."""

    def __init__(self, store: VectorStore, capacity: int = 32):
        self.store = store
        self.hot = EmbeddingCache(capacity=capacity)
        self.disk_hits = 0
        self.disk_misses = 0

    @staticmethod
    def _fingerprint(key: str) -> str:
        return hashlib.sha256(b"prompt-embedding:"
                              + key.encode()).hexdigest()

    def get(self, key: str) -> np.ndarray | None:
        value = self.hot.get(key)
        if value is not None:
            return value
        payload = self.store.artifacts.get(self._fingerprint(key))
        if payload is None:
            self.disk_misses += 1
            return None
        try:
            _ids, mat = decode_segment(payload)
        except RetrievalStoreError:
            self.disk_misses += 1
            return None
        self.disk_hits += 1
        mat = np.array(mat, np.float32)
        self.hot.put(key, mat)
        return mat

    def put(self, key: str, value: np.ndarray) -> None:
        mat = np.asarray(value, np.float32)
        self.hot.put(key, mat)
        payload = encode_segment([str(i) for i in range(mat.shape[0])],
                                 mat, "float32")
        self.store.artifacts.put(self._fingerprint(key), payload,
                                 meta={"kind": "prompt_embedding",
                                       "rows": int(mat.shape[0]),
                                       "retrieval_format":
                                           RETRIEVAL_FORMAT_VERSION})

    def get_or_build(self, key: str,
                     builder: Callable[[], np.ndarray]) -> np.ndarray:
        value = self.get(key)
        if value is not None:
            return value
        value = np.asarray(builder(), np.float32)
        self.put(key, value)
        return value

    @property
    def hit_rate(self) -> float:
        return self.hot.hit_rate

    def stats(self) -> dict:
        return {**self.hot.stats(), "disk_hits": self.disk_hits,
                "disk_misses": self.disk_misses}
