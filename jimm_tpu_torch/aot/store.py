"""Content-addressed on-disk store for AOT artifacts; the counterpart of
``jimm_tpu/aot/store.py``, with the same on-disk layout and ``meta.json``
fields, so that either package's store reads the other's entries (a cascade
calibration written by one is found by the other's ``load_calibration``).

Layout (one directory per fingerprint, two-level fan-out)::

    <root>/
      objects/<fp[:2]>/<fp>/artifact.bin   # the serialized program
      objects/<fp[:2]>/<fp>/meta.json      # integrity hash + provenance
      quarantine/<fp>-<n>/                 # entries that failed validation

Durability and safety rules:

- **Atomic writes**: payload and meta land in a temp directory that is
  ``os.replace``d into place, so a crashed writer can never leave a
  half-entry a reader would trust.
- **Integrity**: ``meta.json`` records the payload's SHA-256; ``get``
  re-hashes on every read. A mismatch (bit rot, truncation, concurrent
  clobber) quarantines the entry and returns ``None``: the caller falls
  back to the model's own forward, never to a corrupt program.
- **Version discipline**: entries whose recorded torch/CUDA/format version
  disagrees with the running process are quarantined the same way. (The
  fingerprint already folds versions in, so this only triggers on doctored
  or hand-copied stores; but a wrong program is the one failure mode this
  subsystem must never have.)
- **LRU eviction**: ``artifact.bin``'s mtime is touched on every hit;
  ``gc`` (also run after every ``put``) drops least-recently-used entries
  until the store fits ``max_bytes``.

No torch import anywhere: ``aot ls``/``gc``/``verify`` stay pure-host
tools.
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

from jimm_tpu_torch.aot.keys import AOT_FORMAT_VERSION

__all__ = ["ArtifactStore", "StoreEntry", "DEFAULT_MAX_BYTES"]

#: default size cap; override per-store or with JIMM_AOT_MAX_BYTES
DEFAULT_MAX_BYTES = 2 * 1024 ** 3

_ARTIFACT = "artifact.bin"
_META = "meta.json"


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


@dataclasses.dataclass(frozen=True)
class StoreEntry:
    """One validated (or at least readable) store entry, for ``ls``."""

    fingerprint: str
    path: Path
    size: int
    created: float
    last_used: float
    meta: dict

    def to_row(self) -> dict:
        return {"fingerprint": self.fingerprint, "size": self.size,
                "created": self.created, "last_used": self.last_used,
                **{k: self.meta.get(k) for k in
                   ("label", "bucket", "method", "backend", "torch")}}


class ArtifactStore:
    """See module docstring. All methods are safe to call concurrently from
    multiple processes sharing one root: writes are atomic renames, reads
    re-validate, and losers of a put race simply overwrite with identical
    content (same fingerprint => same bytes)."""

    def __init__(self, root: str | os.PathLike,
                 max_bytes: int | None = None):
        self.root = Path(root).expanduser()
        env_cap = os.environ.get("JIMM_AOT_MAX_BYTES")
        self.max_bytes = (int(max_bytes) if max_bytes is not None
                          else int(env_cap) if env_cap
                          else DEFAULT_MAX_BYTES)
        (self.root / "objects").mkdir(parents=True, exist_ok=True)

    # -- paths ------------------------------------------------------------

    def entry_dir(self, fingerprint: str) -> Path:
        return self.root / "objects" / fingerprint[:2] / fingerprint

    @property
    def quarantine_dir(self) -> Path:
        return self.root / "quarantine"

    # -- write ------------------------------------------------------------

    def put(self, fingerprint: str, payload: bytes,
            meta: dict | None = None) -> Path:
        """Atomically install ``payload`` under ``fingerprint``; returns the
        entry directory. Runs LRU gc afterwards so the store never stays
        over its cap for longer than one put."""
        entry = self.entry_dir(fingerprint)
        entry.parent.mkdir(parents=True, exist_ok=True)
        record = {
            "fingerprint": fingerprint,
            "sha256": _sha256(payload),
            "size": len(payload),
            "created": time.time(),
            "format_version": AOT_FORMAT_VERSION,
            **(meta or {}),
        }
        tmp = Path(tempfile.mkdtemp(prefix=".put-", dir=entry.parent))
        try:
            (tmp / _ARTIFACT).write_bytes(payload)
            (tmp / _META).write_text(json.dumps(record, indent=1,
                                                sort_keys=True))
            if entry.exists():
                # same fingerprint => same content; replace wholesale so a
                # reader never sees a mixed old/new pair
                old = entry.with_name(entry.name + ".old")
                if old.exists():
                    shutil.rmtree(old, ignore_errors=True)
                os.replace(entry, old)
                os.replace(tmp, entry)
                shutil.rmtree(old, ignore_errors=True)
            else:
                os.replace(tmp, entry)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self.gc()
        return entry

    # -- read -------------------------------------------------------------

    def get(self, fingerprint: str, *,
            expect_versions: dict | None = None) -> bytes | None:
        """Validated payload for ``fingerprint``, or ``None``.

        ``None`` means either a clean miss (no entry) or a failed entry --
        failed entries (unreadable meta, hash mismatch, format/version
        mismatch against ``expect_versions``) are moved to quarantine so
        the next lookup is a clean miss. Hits touch the artifact mtime for
        LRU ordering. Use :meth:`contains` to distinguish miss from hit
        without paying the hash."""
        entry = self.entry_dir(fingerprint)
        if not (entry / _ARTIFACT).is_file():
            return None
        reason = None
        payload = None
        try:
            meta = json.loads((entry / _META).read_text())
            payload = (entry / _ARTIFACT).read_bytes()
        except (OSError, ValueError) as e:
            reason = f"unreadable entry: {e}"
        else:
            if meta.get("format_version") != AOT_FORMAT_VERSION:
                reason = (f"format_version {meta.get('format_version')!r} "
                          f"!= {AOT_FORMAT_VERSION}")
            elif _sha256(payload) != meta.get("sha256"):
                reason = "payload sha256 mismatch (corrupt artifact)"
            elif expect_versions:
                for field, expected in expect_versions.items():
                    got = meta.get(field)
                    if got is not None and got != expected:
                        reason = (f"{field} mismatch: entry has {got!r}, "
                                  f"runtime is {expected!r}")
                        break
        if reason is not None:
            self.quarantine(fingerprint, reason)
            return None
        try:
            os.utime(entry / _ARTIFACT)  # LRU touch
        except OSError:
            pass
        return payload

    def contains(self, fingerprint: str) -> bool:
        return (self.entry_dir(fingerprint) / _ARTIFACT).is_file()

    def entries(self) -> list[StoreEntry]:
        out = []
        objects = self.root / "objects"
        for meta_path in sorted(objects.glob(f"??/*/{_META}")):
            entry = meta_path.parent
            try:
                meta = json.loads(meta_path.read_text())
                st = (entry / _ARTIFACT).stat()
            except (OSError, ValueError):
                continue  # half-entry mid-replace or foreign junk; skip
            out.append(StoreEntry(
                fingerprint=entry.name, path=entry, size=st.st_size,
                created=float(meta.get("created", st.st_mtime)),
                last_used=st.st_mtime, meta=meta))
        return out

    @property
    def total_bytes(self) -> int:
        return sum(e.size for e in self.entries())

    # -- maintenance ------------------------------------------------------

    def quarantine(self, fingerprint: str, reason: str) -> Path | None:
        """Move a bad entry aside (never delete -- a human may want the
        evidence) and record why. Idempotent under races."""
        entry = self.entry_dir(fingerprint)
        if not entry.exists():
            return None
        self.quarantine_dir.mkdir(parents=True, exist_ok=True)
        for n in range(1000):
            dest = self.quarantine_dir / (f"{fingerprint}-{n}" if n
                                          else fingerprint)
            if not dest.exists():
                break
        try:
            os.replace(entry, dest)
        except OSError:
            return None  # another process got there first
        try:
            (dest / "reason.txt").write_text(reason + "\n")
        except OSError:
            pass
        return dest

    def gc(self, max_bytes: int | None = None) -> list[str]:
        """Evict least-recently-used entries until the store fits the cap.
        Returns evicted fingerprints (oldest first)."""
        cap = self.max_bytes if max_bytes is None else int(max_bytes)
        entries = sorted(self.entries(), key=lambda e: e.last_used)
        total = sum(e.size for e in entries)
        evicted: list[str] = []
        for e in entries:
            if total <= cap:
                break
            shutil.rmtree(e.path, ignore_errors=True)
            total -= e.size
            evicted.append(e.fingerprint)
        return evicted

    def verify(self) -> list[dict]:
        """Re-hash every entry; quarantine failures. Returns one problem
        record per bad entry (empty list == healthy store)."""
        problems = []
        for e in self.entries():
            reason = None
            try:
                payload = (e.path / _ARTIFACT).read_bytes()
            except OSError as exc:
                reason = f"unreadable artifact: {exc}"
            else:
                if e.meta.get("format_version") != AOT_FORMAT_VERSION:
                    reason = (f"format_version "
                              f"{e.meta.get('format_version')!r} != "
                              f"{AOT_FORMAT_VERSION}")
                elif _sha256(payload) != e.meta.get("sha256"):
                    reason = "payload sha256 mismatch"
            if reason is not None:
                self.quarantine(e.fingerprint, reason)
                problems.append({"fingerprint": e.fingerprint,
                                 "reason": reason})
        return problems
