"""Flight-recorder event journal: append-only, rotating, crash-safe JSONL;
the counterpart of ``jimm_tpu/obs/journal.py``.

The resilience and checkpoint layers record their structured events
through one process-wide :class:`EventJournal`. Each record carries:

- ``seq``   -- monotonically increasing per-process sequence number
- ``ts``    -- wall-clock ISO-8601 UTC timestamp
- ``mono``  -- ``time.monotonic()`` at emission (ordering)
- ``event`` -- short snake_case event name (``preempt_detected``, ...)
- ``cid``   -- correlation id threading an incident's causal chain (the
              preempt -> grace-save -> restart -> restore chain on the train
              side); ``None`` for standalone events
- plus arbitrary JSON-safe payload fields.

Correlation contract: the component that *detects* an incident mints the
cid (:func:`new_correlation_id`) and every downstream consequence inherits
it, explicitly (``emit(..., cid=...)``, exceptions carrying a ``.cid``) or
ambiently (:func:`correlate` installs a context-local current cid that
:meth:`EventJournal.emit` picks up when no explicit cid is given).

Durability: records are written line-at-a-time and flushed; a crash can at
worst truncate the final line, which :func:`read_events` skips. Rotation is
size-based (``journal.jsonl`` -> ``journal.1.jsonl`` -> ... up to
``max_segments``) and happens between records. An in-memory ring (always
on, even with no file path) serves tests without touching disk.
"""

from __future__ import annotations

import contextvars
import itertools
import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from pathlib import Path

__all__ = [
    "EventJournal", "chain", "configure_journal", "correlate", "current_cid",
    "get_journal", "new_correlation_id", "read_events", "reset_journal",
]

_cid_counter = itertools.count(1)
_cid_lock = threading.Lock()
_ambient_cid: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "jimm_journal_cid", default=None)


def new_correlation_id() -> str:
    """Mint a process-unique correlation id (``c<pid>-<n>``)."""
    with _cid_lock:
        n = next(_cid_counter)
    return f"c{os.getpid():x}-{n:04d}"


def current_cid() -> str | None:
    """The ambient correlation id installed by :func:`correlate`, if any."""
    return _ambient_cid.get()


@contextmanager
def correlate(cid: str | None):
    """Install ``cid`` as the ambient correlation id for the block; events
    emitted without an explicit ``cid`` inherit it. ``correlate(None)`` is
    a no-op block."""
    if cid is None:
        yield None
        return
    token = _ambient_cid.set(cid)
    try:
        yield cid
    finally:
        _ambient_cid.reset(token)


class EventJournal:
    """Append-only structured event log with rotation and an in-memory ring.

    ``path=None`` keeps the journal memory-only (the ring still records
    every event). Give it a path (``configure_journal`` / ``--journal`` /
    ``JIMM_JOURNAL``) to persist.
    """

    def __init__(self, path: str | os.PathLike | None = None, *,
                 max_bytes: int = 4 << 20, max_segments: int = 4,
                 ring: int = 1024, echo: bool = False):
        self.path = Path(path) if path is not None else None
        self.max_bytes = int(max_bytes)
        self.max_segments = int(max_segments)
        self.echo = bool(echo)
        self._ring: deque[dict] = deque(maxlen=ring)
        self._seq = itertools.count(0)
        self._lock = threading.Lock()
        self._fh = None
        if self.path is not None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(self.path, "a", encoding="utf-8")
            # a crash can leave a truncated, newline-less tail: start the
            # first record on a fresh line
            if self._fh.tell() > 0:
                with open(self.path, "rb") as probe:
                    probe.seek(-1, os.SEEK_END)
                    if probe.read(1) != b"\n":
                        self._fh.write("\n")
                        self._fh.flush()

    def emit(self, event: str, *, cid: str | None = None,
             echo: bool | None = None, **fields) -> dict:
        """Record one event; returns the full record (with seq/ts/mono/cid).

        ``cid=None`` falls back to the ambient id from :func:`correlate`.
        ``echo=True`` also prints one operator-facing line; the default
        follows the journal-wide ``echo`` flag.
        """
        rec = {
            "seq": -1,  # minted under the lock below
            "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "mono": round(time.monotonic(), 6),
            "event": str(event),
            "cid": cid if cid is not None else current_cid(),
        }
        for k, v in fields.items():
            if k not in rec:
                rec[k] = v
        with self._lock:
            # seq is minted inside the critical section so the numbering
            # matches ring and file order
            rec["seq"] = next(self._seq)
            line = json.dumps(rec, sort_keys=False, default=str)
            self._ring.append(rec)
            if self._fh is not None:
                self._maybe_rotate(len(line) + 1)
                self._fh.write(line + "\n")
                self._fh.flush()
        if echo if echo is not None else self.echo:
            extras = " ".join(
                f"{k}={json.dumps(v, default=str)}"
                for k, v in rec.items()
                if k not in ("seq", "ts", "mono", "event", "cid"))
            tag = f" cid={rec['cid']}" if rec["cid"] else ""
            print(f"[journal] {rec['event']}{tag} {extras}".rstrip(),
                  flush=True)
        return rec

    def _maybe_rotate(self, incoming: int) -> None:
        """Shift ``journal.jsonl`` -> ``.1`` -> ... when the next write would
        cross ``max_bytes``. Called under the lock, between records."""
        assert self._fh is not None
        if self._fh.tell() + incoming <= self.max_bytes:
            return
        self._fh.close()
        stem, suffix = self.path.stem, self.path.suffix
        oldest = self.path.with_name(f"{stem}.{self.max_segments}{suffix}")
        if oldest.exists():
            oldest.unlink()
        for i in range(self.max_segments - 1, 0, -1):
            seg = self.path.with_name(f"{stem}.{i}{suffix}")
            if seg.exists():
                seg.rename(self.path.with_name(f"{stem}.{i + 1}{suffix}"))
        if self.path.exists():
            self.path.rename(self.path.with_name(f"{stem}.1{suffix}"))
        self._fh = open(self.path, "a", encoding="utf-8")

    def tail(self, n: int = 50) -> list[dict]:
        """Last ``n`` events from the in-memory ring (newest last)."""
        with self._lock:
            items = list(self._ring)
        return items[-n:]

    def events(self) -> list[dict]:
        """All events still held: the on-disk segments when persisted,
        else the ring."""
        if self.path is not None:
            with self._lock:
                if self._fh is not None:
                    self._fh.flush()
            return read_events(self.path)
        return self.tail(self._ring.maxlen or 0)

    def chain(self, cid: str) -> list[dict]:
        """The causal chain for one correlation id, in seq order."""
        return chain(self.events(), cid)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


def read_events(path: str | os.PathLike) -> list[dict]:
    """Read a journal (rotated segments merged, oldest first), skipping
    blank, truncated or corrupt lines; a missing file reads as empty."""
    path = Path(path)
    segments: list[Path] = []
    stem, suffix = path.stem, path.suffix
    for i in range(99, 0, -1):
        seg = path.with_name(f"{stem}.{i}{suffix}")
        if seg.exists():
            segments.append(seg)
    if path.exists():
        segments.append(path)
    out: list[dict] = []
    for seg in segments:
        try:
            text = seg.read_text(encoding="utf-8", errors="replace")
        except OSError:
            continue
        for line in text.splitlines():
            line = line.strip()
            if not line.startswith("{"):
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue  # the truncated tail of a crashed segment
            if isinstance(rec, dict) and "event" in rec:
                out.append(rec)
    out.sort(key=lambda r: (r.get("mono", 0.0), r.get("seq", 0)))
    return out


def chain(events: list[dict], cid: str) -> list[dict]:
    """Filter ``events`` down to one incident's causal chain, seq-ordered."""
    got = [e for e in events if e.get("cid") == cid]
    got.sort(key=lambda r: (r.get("mono", 0.0), r.get("seq", 0)))
    return got


_journal: EventJournal | None = None
_journal_lock = threading.Lock()


def get_journal() -> EventJournal:
    """The process-wide journal, created on first use. Honors
    ``JIMM_JOURNAL=<path>`` (persist there) and ``JIMM_JOURNAL_ECHO=1``
    (narrate every event to stdout); otherwise memory-only and silent."""
    global _journal
    with _journal_lock:
        if _journal is None:
            _journal = EventJournal(
                os.environ.get("JIMM_JOURNAL") or None,
                echo=os.environ.get("JIMM_JOURNAL_ECHO", "") == "1")
        return _journal


def configure_journal(path: str | os.PathLike | None = None,
                      **kwargs) -> EventJournal:
    """Replace the process-wide journal (e.g. from ``--journal PATH``)."""
    global _journal
    with _journal_lock:
        if _journal is not None:
            _journal.close()
        _journal = EventJournal(path, **kwargs)
        return _journal


def reset_journal() -> None:
    """Drop the global journal (tests); the next ``get_journal`` recreates
    it."""
    global _journal
    with _journal_lock:
        if _journal is not None:
            _journal.close()
        _journal = None
