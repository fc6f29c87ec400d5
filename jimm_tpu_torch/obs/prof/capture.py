"""Windowed ``torch.profiler`` capture manager: continuous ring + deep
capture; the counterpart of ``jimm_tpu/obs/prof/capture.py``.

Two capture kinds, one on-disk ring:

- **window** -- the always-on continuous profiler. ``on_step(step)`` (train)
  opens a short capture every ``every_steps`` steps and commits it after
  ``window_steps``; between captures the hook is one integer compare.
- **deep** -- incident-triggered. ``trigger(cid=...)`` opens a longer
  capture tagged with the incident's flight-recorder correlation id and
  commits it on a timer (a server has no step boundary), emitting
  ``prof_capture_started`` / ``prof_capture_committed`` journal events on
  that cid.

Ring discipline (journal-style rotation):

- a capture records into ``cap-NNNNNN-<kind>.tmp/``; commit writes
  ``meta.json`` (tmp file + ``os.replace``) then renames the whole dir to
  ``cap-NNNNNN-<kind>/``: readers only ever see complete captures;
- committed captures are evicted oldest-first once the ring exceeds its
  byte budget;
- a capture that fails to stop, or a leftover ``.tmp`` dir from a crash,
  is moved under ``quarantine/`` with a reason file, never deleted.

The torch backend (:class:`TorchProfiler`) records CPU and, with a card,
CUDA activity. Its stop synchronizes the card (a stop without it drops the
window's last kernels, which are still in flight), then exports kineto's
Chrome trace (``*.pt.trace.json.gz``) into the capture's directory, and
reports what the trace holds: ``meta.json`` gains ``device_events`` (0 for
a capture without a card, or whose CUPTI recorded nothing),
``kernels``, ``cpu_op_threads``, ``runtime_threads`` and
``profiler_thread``, and the seconds of the stop (with the sync), the
export and this reading (``stop_s``, ``export_s``, ``summary_s``).

torch.profiler keeps its host state per thread: it must be stopped on the
thread that started it (a stop from another thread finds no session and
the export then crashes the process), and it records operators (``cpu_op``)
only on that thread and the threads that inherit its state (autograd's).
CUPTI records every thread's runtime calls and every kernel. So a window
capture runs on the caller's thread (the training loop's: its operators
are in the trace), and a deep capture, started by a request handler and
committed by a timer, runs on a thread of its own that starts and stops
the session: it holds the card's side and the runtime calls, but no
operator of the threads that did the work (``cpu_op_threads`` says which).
Kineto initializes itself at a process's first session, and only on the
thread that imported torch: :class:`TorchProfiler` opens and closes one
empty session when it is built (on the thread that configures profiling,
the main one in the CLI), so a deep capture's thread finds it ready.

Only this module may open a ``torch.profiler`` session
(``tests/test_torch_import_wall.py`` holds the rule): every session takes
the process-wide lock, so a one-shot ``--profile-dir`` capture, the ring
and a timing readout never overlap (a second kineto session raises).
"""

from __future__ import annotations

import json
import os
import shutil
import socket
import threading
import time
from contextlib import contextmanager
from pathlib import Path

from jimm_tpu_torch.obs.journal import get_journal, new_correlation_id
from jimm_tpu_torch.obs.prof.opstats import capture_summary, load_trace_events
from jimm_tpu_torch.obs.registry import get_registry

__all__ = [
    "CaptureManager", "TorchProfiler", "configure_capture",
    "get_capture_manager", "list_captures", "maybe_trigger",
    "profiler_session", "reset_capture",
]

META_NAME = "meta.json"
_PREFIX = "cap-"
_TMP_SUFFIX = ".tmp"

#: process-wide profiler session lock: kineto allows one active session,
#: so every sanctioned entry point serializes on this
_SESSION_LOCK = threading.Lock()


def _activities(cuda_only: bool = False) -> list:
    import torch
    acts = [] if cuda_only else [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _finish(prof, log_dir: str | None, summarize: bool = True
            ) -> dict | None:
    """Stop ``prof`` after the card has run everything queued, and export
    its trace into ``log_dir``; returns what the trace holds (with
    ``summarize``)."""
    import torch
    t0 = time.perf_counter()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    if log_dir is None:
        return None
    t1 = time.perf_counter()
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    path = Path(log_dir) / (f"{socket.gethostname()}_{os.getpid()}."
                            f"{time.time_ns() // 1_000_000}.pt.trace.json.gz")
    prof.export_chrome_trace(str(path))
    if not summarize:
        return None
    t2 = time.perf_counter()
    s = capture_summary(load_trace_events(path))
    return {**{k: s[k] for k in ("device_events", "kernels",
                                 "cpu_op_threads", "runtime_threads")},
            "stop_s": round(t1 - t0, 6), "export_s": round(t2 - t1, 6),
            "summary_s": round(time.perf_counter() - t2, 6)}


_primed = False


def _prime() -> None:
    """Open and close one empty session on this thread, once a process, so
    that kineto is initialized before a session starts on another thread."""
    global _primed
    if _primed or not _SESSION_LOCK.acquire(blocking=False):
        return
    try:
        import torch
        prof = torch.profiler.profile(activities=_activities())
        prof.start()
        prof.stop()
        _primed = True
    finally:
        _SESSION_LOCK.release()


class TorchProfiler:
    """The manager's default backend: one ``torch.profiler.profile``
    session a capture (CPU and, with a card, CUDA activity).

    ``start(log_dir)`` opens it on the calling thread, and ``stop()`` must
    come from the same thread. ``start(log_dir, dedicated=True)`` opens it
    on a thread of its own, which also stops it, so any thread may call
    ``stop()``. ``stop()`` returns what the exported trace holds."""

    def __init__(self):
        _prime()
        self._prof = None
        self._dir: str | None = None
        self._thread: int | None = None
        self._owner: threading.Thread | None = None
        self._stop_evt = threading.Event()
        self._result: dict = {}

    def start(self, log_dir: str, *, dedicated: bool = False) -> None:
        import torch
        if dedicated:
            self._start_owner(log_dir)
            return
        self._prof = torch.profiler.profile(activities=_activities())
        self._prof.start()
        self._dir = log_dir
        self._thread = threading.get_ident()

    def _start_owner(self, log_dir: str) -> None:
        import torch
        started = threading.Event()
        self._stop_evt.clear()
        self._result = {}

        def own() -> None:
            try:
                prof = torch.profiler.profile(activities=_activities())
                prof.start()
            except Exception as e:  # noqa: BLE001 -- handed to start()
                self._result["error"] = e
                started.set()
                return
            started.set()
            self._stop_evt.wait()
            try:
                self._result["info"] = _finish(prof, log_dir)
            except Exception as e:  # noqa: BLE001 -- handed to stop()
                self._result["error"] = e

        self._owner = threading.Thread(target=own, daemon=True,
                                       name="jimm-profiler")
        self._owner.start()
        started.wait()
        if "error" in self._result:
            self._owner.join()
            self._owner = None
            raise self._result["error"]

    def stop(self) -> dict | None:
        if self._owner is not None:
            owner, self._owner = self._owner, None
            self._stop_evt.set()
            owner.join(timeout=300.0)
            if owner.is_alive():
                raise RuntimeError("the profiler thread did not finish its "
                                   "stop and export in 300 s")
            if "error" in self._result:
                raise self._result["error"]
            return dict(self._result.get("info") or {},
                        profiler_thread="dedicated")
        if self._prof is None:
            raise RuntimeError("stop without start")
        if threading.get_ident() != self._thread:
            raise RuntimeError("torch.profiler keeps its session per thread: "
                               "stop it on the thread that started it (or "
                               "start it with dedicated=True)")
        prof, self._prof = self._prof, None
        return dict(_finish(prof, self._dir) or {}, profiler_thread="caller")


@contextmanager
def profiler_session(log_dir: str | Path | None = None, *,
                     cuda_only: bool = False):
    """The one raw profiler primitive outside :class:`CaptureManager`:
    profile the enclosed region on this thread, holding the process-wide
    session lock, and yield the ``torch.profiler.profile`` object (for
    ``key_averages()``). On exit the card is synchronized and, with a
    ``log_dir``, the Chrome trace exported there. ``cuda_only`` records the
    card's side alone (kernel timing readouts)."""
    import torch
    if log_dir is not None:
        Path(log_dir).mkdir(parents=True, exist_ok=True)
    with _SESSION_LOCK:
        prof = torch.profiler.profile(activities=_activities(cuda_only))
        prof.start()
        try:
            yield prof
        finally:
            _finish(prof, None if log_dir is None else str(log_dir),
                    summarize=False)


def _dir_bytes(root: Path) -> int:
    total = 0
    for base, _dirs, files in os.walk(root):
        for name in files:
            try:
                total += os.path.getsize(os.path.join(base, name))
            except OSError:
                pass
    return total


def _read_meta(cap_dir: Path) -> dict | None:
    try:
        with open(cap_dir / META_NAME) as f:
            meta = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    return meta if isinstance(meta, dict) else None


def list_captures(root: str | Path) -> list[dict]:
    """Committed capture metas under ``root``, oldest first (what ``obs
    prof ls`` and the timeline exporter read)."""
    root = Path(root)
    out = []
    if not root.is_dir():
        return out
    for entry in sorted(root.iterdir()):
        if not entry.name.startswith(_PREFIX) \
                or entry.name.endswith(_TMP_SUFFIX) or not entry.is_dir():
            continue
        meta = _read_meta(entry)
        if meta is not None:
            meta = dict(meta, path=str(entry))
            out.append(meta)
    out.sort(key=lambda m: m.get("seq", 0))
    return out


class CaptureManager:
    """Owns one capture ring rooted at ``root``.

    Args:
        root: ring directory (created; ``quarantine/`` lives under it).
        max_ring_bytes: byte budget for committed captures; commit evicts
            oldest-first past it.
        every_steps: continuous mode -- open a window capture every N steps
            (0 disables the ring; ``trigger`` still works).
        window_steps: steps per window capture.
        deep_window_s: wall-clock length of a triggered deep capture
            (committed by a timer thread).
        min_trigger_interval_s: deep-capture rate limit; triggers inside
            the interval are counted as suppressed, not captured.
        journal: explicit :class:`EventJournal` (default: process global).
        profiler: injectable backend with ``start(log_dir, dedicated=)``
            and ``stop()`` (tests); default :class:`TorchProfiler`. A dict
            that ``stop()`` returns is merged into the capture's meta.
    """

    def __init__(self, root: str | Path, *, max_ring_bytes: int = 64 << 20,
                 every_steps: int = 200, window_steps: int = 2,
                 deep_window_s: float = 1.5,
                 min_trigger_interval_s: float = 10.0,
                 journal=None, profiler=None):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.quarantine_dir = self.root / "quarantine"
        self.max_ring_bytes = int(max_ring_bytes)
        self.every_steps = int(every_steps)
        self.window_steps = max(1, int(window_steps))
        self.deep_window_s = float(deep_window_s)
        self.min_trigger_interval_s = float(min_trigger_interval_s)
        self._journal = journal
        self._profiler = profiler or TorchProfiler()
        self._lock = threading.RLock()
        self._active: dict | None = None
        self._timer: threading.Timer | None = None
        self._last_trigger_mono: float | None = None
        self._triggered_cids: set[str] = set()
        reg = get_registry("jimm_prof")
        self._captures_total = reg.counter("captures_total")
        self._deep_total = reg.counter("deep_captures_total")
        self._evicted_total = reg.counter("evicted_total")
        self._quarantined_total = reg.counter("quarantined_total")
        self._suppressed_total = reg.counter("trigger_suppressed_total")
        self._failed_total = reg.counter("capture_failures_total")
        self._overhead = reg.counter("overhead_seconds_total")
        reg.gauge("ring_bytes", self.ring_bytes)
        reg.gauge("capture_active",
                  lambda: 1.0 if self._active is not None else 0.0)
        # crash recovery: count what already committed, quarantine
        # leftover .tmp dirs (a crash mid-capture), never delete them
        self._entries: list[dict] = [
            {"seq": m.get("seq", 0), "path": Path(m["path"]),
             "bytes": int(m.get("bytes", 0))}
            for m in list_captures(self.root)]
        self._seq = max([e["seq"] for e in self._entries], default=0)
        for entry in sorted(self.root.iterdir()):
            if entry.name.startswith(_PREFIX) \
                    and entry.name.endswith(_TMP_SUFFIX):
                self._quarantine(entry, "incomplete capture (crash?)")

    # -- journal/metrics helpers ------------------------------------------

    def _emit(self, event: str, *, cid: str | None = None, **fields):
        journal = self._journal if self._journal is not None \
            else get_journal()
        return journal.emit(event, cid=cid, **fields)

    def ring_bytes(self) -> float:
        """Committed bytes currently in the ring (quarantine excluded)."""
        with self._lock:
            return float(sum(e["bytes"] for e in self._entries))

    # -- capture lifecycle ------------------------------------------------

    def start(self, kind: str, *, cid: str | None = None,
              reason: str | None = None, step: int | None = None,
              window_s: float | None = None) -> dict | None:
        """Open a capture. Returns its (in-progress) meta, or None when a
        capture is already active or the profiler session is held
        elsewhere (a one-shot ``profiler_session`` in flight). A deep
        capture runs its session on a thread of its own (its commit comes
        from a timer); a window capture on the calling thread."""
        t0 = time.perf_counter()
        with self._lock:
            if self._active is not None:
                return None
            if not _SESSION_LOCK.acquire(blocking=False):
                return None
            self._seq += 1
            name = f"{_PREFIX}{self._seq:06d}-{kind}"
            tmp = self.root / (name + _TMP_SUFFIX)
            try:
                tmp.mkdir(parents=True, exist_ok=True)
                self._profiler.start(str(tmp), dedicated=kind == "deep")
            except Exception as e:  # noqa: BLE001 -- a broken profiler must not take the process down: counted, journaled, quarantined
                _SESSION_LOCK.release()
                self._failed_total.inc()
                self._emit("prof_capture_failed", cid=cid, kind=kind,
                           error=f"{type(e).__name__}: {e}")
                if tmp.exists():
                    self._quarantine(tmp, f"start failed: {e}")
                return None
            meta = {"seq": self._seq, "name": name, "kind": kind,
                    "cid": cid, "reason": reason, "step": step,
                    "ts": time.strftime("%Y-%m-%dT%H:%M:%S"),
                    "start_mono": round(time.monotonic(), 6)}
            if window_s is not None:
                meta["window_s"] = window_s
            self._active = dict(meta, _dir=tmp)
            self._emit("prof_capture_started", cid=cid, kind=kind,
                       capture=name, reason=reason, step=step)
            if kind == "deep":
                self._deep_total.inc()
                self._timer = threading.Timer(
                    window_s if window_s is not None else self.deep_window_s,
                    self.commit)
                self._timer.daemon = True
                self._timer.start()
        self._overhead.inc(time.perf_counter() - t0)
        return meta

    def commit(self) -> dict | None:
        """Stop the active capture (the card synchronized, the trace
        exported), finalize it atomically into the ring, journal
        ``prof_capture_committed`` (with ``dur_s``), and enforce the byte
        budget. The stop, sync and export count in
        ``jimm_prof_overhead_seconds_total``."""
        t0 = time.perf_counter()
        with self._lock:
            act = self._active
            if act is None:
                return None
            self._active = None
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
            tmp = act.pop("_dir")
            try:
                info = self._profiler.stop()
            except Exception as e:  # noqa: BLE001 -- see start(): a failed stop quarantines the evidence instead of crashing the process
                _SESSION_LOCK.release()
                self._failed_total.inc()
                self._emit("prof_capture_failed", cid=act.get("cid"),
                           kind=act["kind"], capture=act["name"],
                           error=f"{type(e).__name__}: {e}")
                self._quarantine(tmp, f"stop failed: {e}")
                return None
            _SESSION_LOCK.release()
            end = time.monotonic()
            meta = {k: v for k, v in act.items()}
            if isinstance(info, dict):
                meta.update(info)
            meta["end_mono"] = round(end, 6)
            meta["dur_s"] = round(end - meta["start_mono"], 6)
            meta["bytes"] = _dir_bytes(tmp)
            final = self.root / meta["name"]
            try:
                tmp_meta = tmp / (META_NAME + _TMP_SUFFIX)
                with open(tmp_meta, "w") as f:
                    json.dump(meta, f, indent=2, sort_keys=True)
                    f.write("\n")
                os.replace(tmp_meta, tmp / META_NAME)
                os.replace(tmp, final)
            except OSError as e:
                self._failed_total.inc()
                self._quarantine(tmp, f"commit failed: {e}")
                return None
            self._entries.append({"seq": meta["seq"], "path": final,
                                  "bytes": meta["bytes"]})
            self._captures_total.inc()
            self._emit("prof_capture_committed", cid=meta.get("cid"),
                       kind=meta["kind"], capture=meta["name"],
                       bytes=meta["bytes"], dur_s=meta["dur_s"],
                       step=meta.get("step"))
            self._enforce_budget()
        self._overhead.inc(time.perf_counter() - t0)
        return meta

    def _enforce_budget(self) -> None:
        # oldest-first eviction, always keeping the newest capture even
        # when it alone exceeds the budget (the budget bounds accumulation,
        # not one artifact)
        total = sum(e["bytes"] for e in self._entries)
        while total > self.max_ring_bytes and len(self._entries) > 1:
            old = self._entries.pop(0)
            shutil.rmtree(old["path"], ignore_errors=True)
            total -= old["bytes"]
            self._evicted_total.inc()

    def _quarantine(self, path: Path, reason: str) -> None:
        """Corrupt/incomplete capture: move aside, never delete."""
        self.quarantine_dir.mkdir(parents=True, exist_ok=True)
        dest = self.quarantine_dir / path.name
        i = 0
        while dest.exists():
            i += 1
            dest = self.quarantine_dir / f"{path.name}.{i}"
        try:
            os.replace(path, dest)
            with open(dest / "QUARANTINE_REASON.txt", "w") as f:
                f.write(reason + "\n")
        except OSError:
            return
        self._quarantined_total.inc()

    # -- continuous mode (train step hook) --------------------------------

    def on_step(self, step: int) -> None:
        """Per-step hook for the continuous ring. The fast path (no capture
        active, not a capture step) is one modulo and compares."""
        act = self._active
        if act is not None:
            if act["kind"] == "window" \
                    and step - (act.get("step") or 0) >= self.window_steps:
                self.commit()
            return
        if self.every_steps <= 0:
            return
        # offset 2 into each period: past the first (warm-up) step and the
        # first step after a restore, as the --profile-dir window
        if step % self.every_steps == 2 % self.every_steps and step > 0:
            self.start("window", step=step)

    def flush(self) -> dict | None:
        """Commit whatever is active (end of run, server shutdown)."""
        return self.commit()

    # -- incident trigger -------------------------------------------------

    def trigger(self, cid: str | None = None, reason: str | None = None,
                *, window_s: float | None = None) -> dict | None:
        """Deep capture on an incident. Rate-limited (one per
        ``min_trigger_interval_s``) and deduped per cid. An active *window*
        capture is committed first; an active *deep* capture suppresses
        the trigger."""
        with self._lock:
            now = time.monotonic()
            if cid is not None and cid in self._triggered_cids:
                self._suppressed_total.inc()
                return None
            if self._last_trigger_mono is not None and \
                    now - self._last_trigger_mono \
                    < self.min_trigger_interval_s:
                self._suppressed_total.inc()
                return None
            if self._active is not None:
                if self._active["kind"] == "deep":
                    self._suppressed_total.inc()
                    return None
                self.commit()
            cid = cid or new_correlation_id()
            meta = self.start("deep", cid=cid, reason=reason,
                              window_s=window_s)
            if meta is not None:
                self._last_trigger_mono = now
                self._triggered_cids.add(cid)
                if len(self._triggered_cids) > 1024:
                    # cid dedup is per recent incident, not forever
                    self._triggered_cids = set(list(
                        self._triggered_cids)[-256:])
            return meta

    def ls(self) -> list[dict]:
        return list_captures(self.root)

    def close(self) -> None:
        self.flush()


# -- the process-global manager (env: JIMM_PROF_DIR) -------------------------

_global_manager: CaptureManager | None = None
_env_checked = False


def configure_capture(root: str | Path, **kwargs) -> CaptureManager:
    """Install the process-global capture manager (``--prof-dir`` /
    ``--prof-ring`` call this; ``JIMM_PROF_DIR`` configures it
    implicitly)."""
    global _global_manager, _env_checked
    _global_manager = CaptureManager(root, **kwargs)
    _env_checked = True
    return _global_manager


def get_capture_manager() -> CaptureManager | None:
    """The global manager, configured from ``JIMM_PROF_DIR`` on first call;
    None when profiling is not enabled (every trigger site tolerates it)."""
    global _env_checked, _global_manager
    if _global_manager is None and not _env_checked:
        _env_checked = True
        root = os.environ.get("JIMM_PROF_DIR")
        if root:
            _global_manager = CaptureManager(root)
    return _global_manager


def maybe_trigger(cid: str | None = None, reason: str | None = None,
                  *, window_s: float | None = None) -> dict | None:
    """Trigger a deep capture iff a global manager is configured: the
    no-op-by-default hook incident paths call unconditionally."""
    mgr = get_capture_manager()
    if mgr is None:
        return None
    try:
        return mgr.trigger(cid, reason, window_s=window_s)
    except Exception:  # noqa: BLE001 -- profiling must never turn an incident into a crash
        return None


def reset_capture() -> None:
    """Drop the global manager (tests)."""
    global _global_manager, _env_checked
    if _global_manager is not None:
        try:
            _global_manager.flush()
        except Exception:  # noqa: BLE001 -- teardown best-effort
            pass
    _global_manager = None
    _env_checked = False
