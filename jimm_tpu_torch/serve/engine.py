"""Async micro-batching inference engine over one or more replicas; the
counterpart of ``jimm_tpu/serve/engine.py``.

Single requests arrive on an asyncio loop; a batcher task coalesces them,
pads each micro-batch up to a :mod:`~jimm_tpu_torch.serve.buckets` size and
dispatches it to a replica. The coalescing policy:

1. take the first queued request, open a ``max_delay_ms`` window;
2. drain whatever else is already queued (no await, no added latency);
3. wait out the rest of the window for stragglers, unless the queue depth
   is past the admission policy's shed watermark, in which case dispatch
   at once;
4. stop early the moment the largest bucket fills.

Each replica owns a single-thread executor that does all of its device
work and ends each batch with the host readback, so the loop keeps
coalescing while batches compute. With one replica that is the classic
single-device engine; with several (``forward`` given as a list, normally
built by :func:`~jimm_tpu_torch.serve.topology.build_replica_forwards`) a
capacity semaphore lets one batch per replica run at a time and each batch
goes to the least-loaded live replica (round-robin on ties).

A watchdog gives a replica whose forward raised one fresh executor, then
fences it off (never the last live lane). ``revive`` un-fences a lane;
with a heal factory installed (:meth:`InferenceEngine.set_heal`) a fence
escalates to a probe (revive in place) or a rebuild and a live
:meth:`InferenceEngine.replan`, during which queued requests wait and are
then answered by the new replicas.

With a QoS scheduler (``qos=``, `serve/qos/`) a submission carries its
tenant through token-bucket and quota admission, the FIFO queue becomes
the per-class weighted-fair queue, and overload sheds class-ordered.
Without one the engine keeps its single FIFO.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable

import numpy as np
import torch

from jimm_tpu_torch.obs.journal import get_journal, new_correlation_id
from jimm_tpu_torch.obs.prof.capture import maybe_trigger
from jimm_tpu_torch.obs.spans import new_trace_id, span
from jimm_tpu_torch.serve.admission import (AdmissionController,
                                            AdmissionPolicy,
                                            DeadlineExceededError,
                                            EngineClosedError, RequestError,
                                            ServeMetrics, ShedError)
from jimm_tpu_torch.serve.buckets import BucketTable, default_buckets, pad_batch

_STOP = object()


def image_forward(model: torch.nn.Module, method: str = "encode_image"
                  ) -> Callable[[np.ndarray], torch.Tensor]:
    """``model.<method>`` (``"forward"``: the model itself) over a numpy
    batch: the batch moves to the model's device and dtype, and the forward
    runs under inference mode."""
    param = next(model.parameters())
    fn = model if method == "forward" else getattr(model, method)

    @torch.inference_mode()
    def forward(batch: np.ndarray) -> torch.Tensor:
        return fn(torch.from_numpy(batch).to(param.device, param.dtype))

    return forward


def _prof_trigger(cid: str | None, reason: str) -> None:
    """Deep profiler capture on an incident cid: a no-op unless a global
    capture manager is configured (``--prof-dir`` / ``JIMM_PROF_DIR``),
    deduplicated per cid inside the manager."""
    maybe_trigger(cid, reason)


def _wait_device(forward, out) -> None:
    """Block until ``out`` is computed: on the forward's own stream when it
    has one, else on the current stream of a CUDA result."""
    sync = getattr(forward, "synchronize", None)
    if sync is not None:
        sync()
    elif isinstance(out, torch.Tensor) and out.is_cuda:
        torch.cuda.current_stream(out.device).synchronize()


def _to_host(forward, out) -> np.ndarray:
    to_host = getattr(forward, "to_host", None)
    if to_host is not None:
        return to_host(out)
    if isinstance(out, torch.Tensor):
        return out.float().cpu().numpy()
    return np.asarray(out)


class _Request:
    # tenant/klass are QoS annotations (the scheduler's tenant state and
    # the priority-class name); both stay None without a policy
    __slots__ = ("item", "future", "deadline", "t0", "rid", "tenant",
                 "klass")

    def __init__(self, item: np.ndarray, future: asyncio.Future,
                 deadline: float, t0: float, rid: str, tenant=None,
                 klass: str | None = None):
        self.item = item
        self.future = future
        self.deadline = deadline
        self.t0 = t0
        self.rid = rid
        self.tenant = tenant
        self.klass = klass


class _Replica:
    """One compute lane: a forward, its single-thread executor, and its
    load counters. ``inflight`` is the replica's queue depth (batches
    assigned but not finished). ``restarts``/``dead`` belong to the
    watchdog; ``revived`` counts un-fencings (each re-arms the restart)."""

    __slots__ = ("index", "forward", "name", "pool", "inflight",
                 "dispatched", "device_s", "restarts", "dead", "revived",
                 "incident_cid")

    def __init__(self, index: int, forward: Callable, name: str):
        self.index = index
        self.forward = forward
        self.name = name
        self.pool = ThreadPoolExecutor(max_workers=1,
                                       thread_name_prefix=name)
        self.inflight = 0
        self.dispatched = 0
        self.device_s = 0.0
        self.restarts = 0
        self.dead = False
        self.revived = 0
        # the journal correlation id of the incident this replica is the
        # subject of (minted at the first fault, cleared on revive)
        self.incident_cid: str | None = None


def _replicas_of(forwards: list, multi: bool) -> list[_Replica]:
    return [_Replica(i, f, name=(f"jimm-serve-fwd-r{i}" if multi
                                 else "jimm-serve-fwd"))
            for i, f in enumerate(forwards)]


class InferenceEngine:
    """Coalesces single-item requests into bucketed micro-batches.

    Args:
        forward: callable over a ``(B, *item_shape)`` numpy array returning
            a tensor (or array) whose row ``i`` answers input row ``i``
            (e.g. :func:`image_forward`), or a *list* of such callables,
            one per replica (see :func:`~jimm_tpu_torch.serve.topology
            .build_replica_forwards`). A bare callable is the
            single-replica engine, without per-replica series.
        item_shape: per-request input shape (no batch axis); anything else
            is rejected with :class:`RequestError`.
        buckets: allowed batch sizes (default: the platform's table).
        max_delay_ms: coalescing window.
        policy: admission policy (queue bound, default deadline, shed
            watermark).
        metrics: shared :class:`ServeMetrics` (one per server).
        qos: optional :class:`~jimm_tpu_torch.serve.qos.QosScheduler`:
            tenant admission, the weighted-fair queue and class-ordered
            shedding. None keeps the single FIFO.
        recent_traces_entries, recent_traces_max_bytes: the bounds of the
            per-request trace ring (``/debug/traces``).
        trace_count: optional getter exported as the ``compile_count``
            gauge: the buckets a store-backed forward
            (:class:`~jimm_tpu_torch.aot.warmup.AotForward`) ran through the
            model's own Python instead of a loaded program (JAX's name).
    """

    #: batches are assembled in f32 (requests are cast); the forward casts
    #: to the model's dtype on the device
    dtype = np.dtype(np.float32)

    def __init__(self, forward, *, item_shape: tuple[int, ...],
                 buckets: BucketTable | None = None,
                 max_delay_ms: float = 5.0,
                 policy: AdmissionPolicy | None = None,
                 metrics: ServeMetrics | None = None, qos=None,
                 recent_traces_entries: int = 64,
                 recent_traces_max_bytes: int = 64 << 10,
                 trace_count: Callable[[], int] | None = None):
        self._multi = isinstance(forward, (list, tuple))
        forwards = list(forward) if self._multi else [forward]
        if not forwards:
            raise ValueError("forward list must name at least one replica")
        self._replicas = _replicas_of(forwards, self._multi)
        self.item_shape = tuple(item_shape)
        self.buckets = (buckets if buckets is not None else default_buckets(
            "cuda" if torch.cuda.is_available() else "cpu"))
        self.max_delay_s = max_delay_ms / 1e3
        self.metrics = metrics or ServeMetrics()
        self.admission = AdmissionController(policy, self.metrics)
        self.qos = qos
        if qos is not None:
            qos.bind_metrics(self.metrics)
        self.metrics.bind_gauge("queue_depth_now",
                                lambda: float(self._queue.qsize())
                                if self._queue is not None else 0.0)
        if self._multi:
            # "n_replicas", not "replica_count": the exporter renders
            # *_count names as counters
            self._bind_replica_set_metrics()
            # pre-created at zero so "never replanned" shows in scrapes
            self.metrics.inc("replans_total", 0)
        # an asyncio.Queue, or with a policy a qos.WeightedFairQueue (the
        # same surface)
        self._queue = None
        self._task: asyncio.Task | None = None
        self._capacity: asyncio.Semaphore | None = None
        self._dispatch_tasks: set[asyncio.Task] = set()
        self._rr = 0
        self._running = False
        # the submission gate, apart from _running: a replan pauses the
        # batcher while submit() keeps enqueueing
        self._accepting = False
        self._heal: Callable | None = None
        self._heal_task: asyncio.Task | None = None
        self._replan_lock = asyncio.Lock()
        #: the last failed self-heal attempt (healthz)
        self.last_heal_error: str | None = None
        #: SLO burn-rate engine (attach_slo), one observation a request
        self.slo = None
        self._slo_burning: set = set()
        # per-request phase decomposition, newest last, bounded by entries
        # and by serialized bytes (an eviction counts a drop)
        self.recent_traces: deque[dict] = deque()
        self._trace_sizes: deque[int] = deque()
        self._traces_bytes = 0
        self.recent_traces_entries = int(recent_traces_entries)
        self.recent_traces_max_bytes = int(recent_traces_max_bytes)
        self.metrics.inc("traces_dropped_total", 0)
        self.metrics.bind_gauge("recent_traces_bytes",
                                lambda: float(self._traces_bytes))
        # bucket -> {"seconds", "source"} filled by warmup_blocking; with
        # replicas a per-replica breakdown under "replicas"
        self.warmup_report: dict = {}
        self.trace_count = trace_count
        if trace_count is not None:
            self.metrics.bind_gauge("compile_count", trace_count)

    # -- replicas ---------------------------------------------------------

    @property
    def n_replicas(self) -> int:
        return len(self._replicas)

    @property
    def forwards(self) -> list:
        """The live replica set's forwards, in replica order."""
        return [r.forward for r in self._replicas]

    @property
    def traces_bytes(self) -> int:
        """Serialized bytes held by the trace ring."""
        return self._traces_bytes

    def _bind_replica_set_metrics(self) -> None:
        self.metrics.bind_gauge("n_replicas",
                                lambda: float(len(self._replicas)))
        self.metrics.bind_gauge(
            "replicas_alive",
            lambda: float(sum(1 for r in self._replicas if not r.dead)))
        for replica in self._replicas:
            self._bind_replica_metrics(replica)

    def _bind_replica_metrics(self, replica: _Replica) -> None:
        """This replica's jimm_serve_replica_* series: inflight batches,
        dispatch count (pre-created at zero) and device seconds."""
        i = replica.index
        self.metrics.inc(f"replica_{i}_dispatched_total", 0)
        self.metrics.bind_gauge(f"replica_{i}_inflight",
                                lambda r=replica: float(r.inflight))
        self.metrics.bind_gauge(f"replica_{i}_device_seconds",
                                lambda r=replica: round(r.device_s, 6))

    def _record_trace(self, row: dict) -> None:
        """Append to the trace ring under both bounds, counting evictions
        in ``jimm_serve_traces_dropped_total``. Loop-confined."""
        try:
            size = len(json.dumps(row, default=str))
        except (TypeError, ValueError):
            size = 256
        self.recent_traces.append(row)
        self._trace_sizes.append(size)
        self._traces_bytes += size
        while len(self.recent_traces) > 1 and (
                len(self.recent_traces) > self.recent_traces_entries
                or self._traces_bytes > self.recent_traces_max_bytes):
            self.recent_traces.popleft()
            self._traces_bytes -= self._trace_sizes.popleft()
            self.metrics.inc("traces_dropped_total")

    def replica_stats(self) -> list[dict]:
        """Per-replica load snapshot (healthz)."""
        return [{"replica": r.index, "dispatched": r.dispatched,
                 "inflight": r.inflight,
                 "device_seconds": round(r.device_s, 6),
                 "restarts": r.restarts, "dead": r.dead,
                 "revived": r.revived}
                for r in self._replicas]

    def dead_replicas(self) -> list[int]:
        """Indices of replicas the watchdog fenced off."""
        return [r.index for r in self._replicas if r.dead]

    def _fresh_pool(self, replica: _Replica) -> None:
        replica.pool.shutdown(wait=False)
        replica.pool = ThreadPoolExecutor(max_workers=1,
                                          thread_name_prefix=replica.name)

    def _note_replica_failure(self, replica: _Replica) -> None:
        """Watchdog: a replica whose forward raised gets ONE fresh
        executor; one that fails again after it is fenced off, unless it is
        the last live lane, which keeps serving (and erroring)."""
        if replica.incident_cid is None:
            replica.incident_cid = new_correlation_id()
        if replica.restarts == 0:
            self._fresh_pool(replica)
            replica.restarts += 1
            if self._multi:
                self.metrics.inc(f"replica_{replica.index}_restarts_total")
            get_journal().emit("replica_fault", cid=replica.incident_cid,
                               replica=replica.index, action="restart")
            return
        live = [r for r in self._replicas if not r.dead]
        if len(live) > 1:
            replica.dead = True
            if self._multi:
                self.metrics.inc(f"replica_{replica.index}_dead_total")
            get_journal().emit("replica_fenced", cid=replica.incident_cid,
                               replica=replica.index, live=len(live) - 1)
            self._maybe_heal(replica)
        else:
            get_journal().emit("replica_fault", cid=replica.incident_cid,
                               replica=replica.index, action="last_lane",
                               live=len(live))

    def revive(self, index: int) -> dict:
        """Un-fence a watchdog-dead replica: a fresh executor, its restart
        re-armed. Raises ValueError for an unknown index or a replica that
        is not fenced. Returns the replica's new stats row."""
        if not isinstance(index, int) or not 0 <= index < len(self._replicas):
            raise ValueError(f"no replica {index!r} "
                             f"(engine has {len(self._replicas)})")
        replica = self._replicas[index]
        if not replica.dead:
            raise ValueError(f"replica {index} is not fenced; "
                             "nothing to revive")
        self._fresh_pool(replica)
        replica.restarts = 0
        replica.dead = False
        replica.revived += 1
        if self._multi:
            self.metrics.inc(f"replica_{index}_revived_total")
            self.metrics.inc("revives_total")
        get_journal().emit("replica_revived", cid=replica.incident_cid,
                           replica=index, revived=replica.revived)
        replica.incident_cid = None
        return self.replica_stats()[index]

    # -- self-heal / live replan ------------------------------------------

    def attach_slo(self, slo) -> None:
        """Install an :class:`~jimm_tpu_torch.obs.slo.SloEngine`: every
        finished request (success, forward error, deadline) is one
        observation; entering fast burn escalates into the self-heal path
        and triggers a deep capture on the incident's cid."""
        self.slo = slo
        slo.add_listener(self._on_burn_transition_capture)

    def _on_burn_transition_capture(self, tenant, entered: bool,
                                    fast: float, slow: float) -> None:
        if not entered:
            return
        dead = [r for r in self._replicas if r.dead]
        _prof_trigger(dead[0].incident_cid if dead else None,
                      "slo_fast_burn")

    def _observe_slo(self, req: _Request, ok: bool,
                     latency_s: float | None) -> None:
        if self.slo is None:
            return
        tenant = req.tenant.spec.name if req.tenant is not None else None
        self.slo.observe(tenant, ok, latency_s)

    def _slo_check_escalate(self) -> None:
        """After bad observations: when a tenant enters fast burn, journal
        it and kick the self-heal path at the first fenced replica."""
        if self.slo is None:
            return
        burning = set(self.slo.fast_burning())
        newly = burning - self._slo_burning
        self._slo_burning = burning
        if not newly:
            return
        dead = [r for r in self._replicas if r.dead]
        cid = dead[0].incident_cid if dead else None
        get_journal().emit("slo_fast_burn", cid=cid, tenants=sorted(newly),
                           dead_replicas=[r.index for r in dead])
        self.metrics.inc("slo_fast_burn_total")
        if dead:
            self._maybe_heal(dead[0])

    def set_heal(self, factory: Callable) -> None:
        """Install the self-heal hook: a *blocking* zero-arg factory that
        rebuilds the full replica forward set (a list, or a ``(list, x)``
        pair). After a fence the watchdog probes the fenced lane off-loop
        (it computes: revive in place), else rebuilds and replans."""
        self._heal = factory
        self.metrics.inc("heal_failures_total", 0)

    def _maybe_heal(self, replica: _Replica) -> None:
        if self._heal is None:
            return
        if self._heal_task is not None and not self._heal_task.done():
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return  # fenced outside a loop: nothing to schedule
        self._heal_task = loop.create_task(self._heal_around(replica),
                                           name="jimm-serve-heal")

    async def _heal_around(self, replica: _Replica) -> None:
        loop = asyncio.get_running_loop()
        cid = replica.incident_cid
        t_heal = time.perf_counter()
        ok = await loop.run_in_executor(None, self._probe_blocking, replica)
        get_journal().emit("heal_probe", cid=cid, replica=replica.index,
                           ok=ok)
        _prof_trigger(cid, "heal")
        if ok:
            self.revive(replica.index)
            self.metrics.inc("goodput_heal_seconds_total",
                             time.perf_counter() - t_heal)
            return
        try:
            built = await loop.run_in_executor(None, self._heal)
        except Exception as e:  # noqa: BLE001 -- a failed heal is counted; the engine keeps serving degraded
            self.metrics.inc("heal_failures_total")
            self.last_heal_error = f"{type(e).__name__}: {e}"
            self.metrics.inc("goodput_heal_seconds_total",
                             time.perf_counter() - t_heal)
            get_journal().emit("heal_failed", cid=cid,
                               replica=replica.index,
                               error=self.last_heal_error)
            return
        forwards, trace_count = self._normalize_built(built)
        heal_s = time.perf_counter() - t_heal
        self.metrics.inc("goodput_heal_seconds_total", heal_s)
        get_journal().emit("heal_rebuilt", cid=cid, replica=replica.index,
                           replicas=len(forwards), dur_s=round(heal_s, 6))
        await self.replan(forwards, trace_count=trace_count, cid=cid)

    @staticmethod
    def _normalize_built(built) -> tuple[list, Callable[[], int] | None]:
        """``(forwards, trace_count)`` from ``(forwards, trace_count)`` or a
        bare list (trace_count None)."""
        if (isinstance(built, tuple) and len(built) == 2
                and isinstance(built[0], (list, tuple))):
            return list(built[0]), built[1]
        return list(built), None

    def _probe_blocking(self, replica: _Replica) -> bool:
        """One smallest-bucket forward on a fenced replica, off its
        (possibly wedged) executor. True means the lane still computes."""
        size = min(self.buckets.sizes)
        zeros = np.zeros((size,) + self.item_shape, self.dtype)
        try:
            self._forward_blocking(zeros, replica)
        except Exception:  # noqa: BLE001 -- a failure is the probe's answer
            return False
        return True

    async def replan(self, forward, *,
                     trace_count: Callable[[], int] | None = None,
                     warm: bool = True, cid: str | None = None) -> dict:
        """Swap the live replica set for a new one (grow, shrink, or heal)
        without dropping queued work: (1) warm every bucket of every new
        forward off-loop while the old replicas serve; (2) pause the
        batcher with ``_STOP`` and await the in-flight dispatches; (3) swap
        replicas, semaphore and gauges (``compile_count`` rebinds to
        ``trace_count`` when one is given); (4) restart the batcher.
        ``submit()`` keeps accepting throughout. ``cid`` threads the
        triggering incident's correlation id (a fresh one otherwise)."""
        new_multi = isinstance(forward, (list, tuple))
        forwards = list(forward) if new_multi else [forward]
        if not forwards:
            raise ValueError("replan needs at least one replica forward")
        cid = cid or new_correlation_id()
        t_replan = time.perf_counter()
        get_journal().emit("replan_started", cid=cid,
                           replicas_to=len(forwards),
                           replicas_from=len(self._replicas))
        _prof_trigger(cid, "replan")
        async with self._replan_lock:
            loop = asyncio.get_running_loop()
            if warm:
                await loop.run_in_executor(
                    None, self._warm_forwards_blocking, forwards)
            was_running = self._running and self._task is not None
            if was_running:
                assert self._queue is not None
                self._queue.put_nowait(_STOP)
                await self._task
                self._task = None
                if self._dispatch_tasks:
                    await asyncio.gather(*tuple(self._dispatch_tasks),
                                         return_exceptions=True)
            old = self._replicas
            for replica in old:
                replica.pool.shutdown(wait=True)
            self._multi = new_multi
            self._replicas = _replicas_of(forwards, new_multi)
            self._rr = 0
            if new_multi:
                self._bind_replica_set_metrics()
            if trace_count is not None:
                self.trace_count = trace_count
                self.metrics.bind_gauge("compile_count", trace_count)
            # a shrink leaves higher-index gauges bound to dropped lanes:
            # freeze them at zero
            for i in range(len(forwards), len(old)):
                self.metrics.bind_gauge(f"replica_{i}_inflight", lambda: 0.0)
                self.metrics.bind_gauge(f"replica_{i}_device_seconds",
                                        lambda: 0.0)
            if was_running:
                self._capacity = asyncio.Semaphore(len(self._replicas))
                self._dispatch_tasks = set()
                self._task = loop.create_task(self._batcher(),
                                              name="jimm-serve-batcher")
            self.metrics.inc("replans_total")
            replan_s = time.perf_counter() - t_replan
            self.metrics.inc("goodput_replan_seconds_total", replan_s)
            get_journal().emit("replan_done", cid=cid,
                               replicas=len(self._replicas),
                               was_running=was_running,
                               dur_s=round(replan_s, 6))
            return {"replicas": len(self._replicas),
                    "was_running": was_running,
                    "replans": self.metrics.count("replans_total")}

    def _warm_forwards_blocking(self, forwards) -> None:
        """Every bucket of every new forward prepared and run once
        (blocking; off-loop)."""
        for size in self.buckets.sizes:
            zeros = np.zeros((size,) + self.item_shape, self.dtype)
            for fwd in forwards:
                prepare = getattr(fwd, "prepare_bucket", None)
                if prepare is not None:
                    prepare(size)
                _wait_device(fwd, fwd(zeros))

    def _pick_replica(self) -> _Replica:
        """Least-loaded live replica by inflight batches; ties break
        round-robin from the cursor. Fenced replicas are skipped (one is
        always live: the watchdog never fences the last)."""
        n = len(self._replicas)
        best = None
        for off in range(n):
            r = self._replicas[(self._rr + off) % n]
            if r.dead:
                continue
            if best is None or r.inflight < best.inflight:
                best = r
        self._rr = (best.index + 1) % n
        return best

    # -- lifecycle --------------------------------------------------------

    def warmup_blocking(self) -> dict[int, float]:
        """Run every bucket once on every replica before traffic (call off
        the event loop). Returns {bucket: seconds}; fills
        ``warmup_report``."""
        times = {}
        self.warmup_report = {}
        for size in self.buckets.sizes:
            zeros = np.zeros((size,) + self.item_shape, self.dtype)
            per_replica = []
            for replica in self._replicas:
                prepare = getattr(replica.forward, "prepare_bucket", None)
                source = prepare(size) if prepare is not None else "compile"
                t0 = time.monotonic()
                with span("serve_warmup_aot" if source == "aot"
                          else "serve_warmup_compile"):
                    self._forward_blocking(zeros, replica)
                per_replica.append(
                    {"seconds": round(time.monotonic() - t0, 4),
                     "source": source})
            times[size] = round(sum(e["seconds"] for e in per_replica), 4)
            sources = {e["source"] for e in per_replica}
            report = {"seconds": times[size],
                      "source": (per_replica[0]["source"]
                                 if len(sources) == 1 else "mixed")}
            if self._multi:
                report["replicas"] = per_replica
            self.warmup_report[size] = report
        return times

    async def start(self) -> None:
        if self._running:
            return
        if self.qos is not None:
            # per-class deques drained by deficit round robin, with the
            # asyncio.Queue surface the batcher uses
            from jimm_tpu_torch.serve.qos.scheduler import WeightedFairQueue
            self._queue = WeightedFairQueue(self.qos)
        else:
            self._queue = asyncio.Queue()
        # one permit per replica: the next batch forms only when a replica
        # can take it, so waiting requests stay visible to the queue bound
        self._capacity = asyncio.Semaphore(len(self._replicas))
        self._dispatch_tasks = set()
        self._running = True
        self._accepting = True
        self._task = asyncio.get_running_loop().create_task(
            self._batcher(), name="jimm-serve-batcher")

    async def stop(self) -> None:
        if not self._running:
            return
        self._running = False
        self._accepting = False
        if self._heal_task is not None:
            self._heal_task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._heal_task
            self._heal_task = None
        assert self._queue is not None
        self._queue.put_nowait(_STOP)
        if self._task is not None:
            await self._task
            self._task = None
        if self._dispatch_tasks:
            await asyncio.gather(*tuple(self._dispatch_tasks),
                                 return_exceptions=True)
        for replica in self._replicas:
            replica.pool.shutdown(wait=True)

    # -- submission -------------------------------------------------------

    async def submit(self, item: np.ndarray, timeout_s: float | None = None,
                     trace_id: str | None = None,
                     tenant: str | None = None,
                     escalated: bool = False) -> np.ndarray:
        """One request in, one output row out. Raises
        :class:`~jimm_tpu_torch.serve.admission.QueueFullError`,
        :class:`RequestError` or :class:`DeadlineExceededError`.
        ``trace_id`` (the client's, or minted here) keys the request's
        phase decomposition in ``recent_traces``.

        With a QoS scheduler ``tenant`` selects the policy: its token
        bucket and quota may raise
        :class:`~jimm_tpu_torch.serve.admission.ThrottledError` (429), its
        deadline applies when ``timeout_s`` is None, and on a full queue a
        queued request of a lower class is shed
        (:class:`~jimm_tpu_torch.serve.admission.ShedError`, 503) to admit
        it. Without one ``tenant`` is ignored.

        ``escalated=True`` marks a cascade re-submit
        (`serve/cascade/router.py`): the request counter and the tenant's
        token bucket were charged at the cheap stage, so the escalation
        skips both and counts under ``escalated_submits_total``; it still
        honors the queue bound (capacity is physical)."""
        if not self._accepting or self._queue is None:
            raise EngineClosedError("engine is not running; call start()")
        arr = np.asarray(item, self.dtype)
        if arr.shape != self.item_shape:
            self.metrics.inc("errors_total")
            raise RequestError(f"item shape {arr.shape} != engine shape "
                               f"{self.item_shape}")
        self.metrics.inc("escalated_submits_total" if escalated
                         else "requests_total")
        tenant_state = klass = None
        if self.qos is not None:
            tenant_state = self.qos.resolve(tenant)
            klass = tenant_state.spec.klass
            if not escalated:
                self.qos.admit(tenant_state)
            timeout_s = self.qos.timeout_for(tenant_state, timeout_s)
            if self._queue.qsize() >= self.admission.policy.max_queue:
                self._shed_for(klass)
        self.admission.admit(self._queue.qsize())
        now = time.monotonic()
        deadline = self.admission.deadline_for(timeout_s, now)
        future = asyncio.get_running_loop().create_future()
        self._queue.put_nowait(_Request(arr, future, deadline, now,
                                        trace_id or new_trace_id(),
                                        tenant_state, klass))
        if tenant_state is not None:
            self.qos.on_enqueue(tenant_state)
        self.metrics.set_queue_depth(self._queue.qsize())
        try:
            return await asyncio.wait_for(future, timeout=deadline - now)
        except asyncio.TimeoutError:
            self.metrics.inc("timeouts_total")
            if self.slo is not None:
                self.slo.observe(tenant_state.spec.name
                                 if tenant_state is not None else None,
                                 False, deadline - now)
                self._slo_check_escalate()
            raise DeadlineExceededError(
                f"request deadline ({deadline - now:.3f}s) exceeded") from None

    def _shed_for(self, klass: str) -> None:
        """Class-ordered shedding: evict the newest queued request of the
        lowest class strictly below ``klass``; when every lower class is
        empty nothing is evicted and the arrival takes the queue-full
        refusal, so a class never preempts its peers or its betters."""
        victim = self._queue.shed_lower(self.qos.rank_of(klass))
        if victim is not None and not victim.future.done():
            victim.future.set_exception(ShedError(
                f"shed under overload to admit class {klass!r} traffic; "
                "retry with backoff",
                retry_after_s=round(self.max_delay_s * 4, 4)))

    # -- batching loop ----------------------------------------------------

    async def _batcher(self) -> None:
        assert self._queue is not None and self._capacity is not None
        queue = self._queue
        loop = asyncio.get_running_loop()
        while True:
            # capacity before work: while every replica is busy, requests
            # wait in the bounded admission queue
            await self._capacity.acquire()
            first = await queue.get()
            if first is _STOP:
                self._capacity.release()
                break
            batch = [first]
            window_end = time.monotonic() + self.max_delay_s
            max_size = self.buckets.max_size
            stop = shed = False
            while len(batch) < max_size:
                try:
                    nxt = queue.get_nowait()
                except asyncio.QueueEmpty:
                    nxt = None
                if nxt is None:
                    if self.admission.under_pressure(len(batch)
                                                     + queue.qsize()):
                        shed = True
                        break
                    remaining = window_end - time.monotonic()
                    if remaining <= 0:
                        break
                    try:
                        nxt = await asyncio.wait_for(queue.get(),
                                                     timeout=remaining)
                    except asyncio.TimeoutError:
                        break
                if nxt is _STOP:
                    stop = True
                    break
                batch.append(nxt)
            self.metrics.set_queue_depth(queue.qsize())
            replica = self._pick_replica()
            replica.inflight += 1
            task = loop.create_task(
                self._dispatch_tracked(replica, batch, shed),
                name=f"jimm-serve-dispatch-r{replica.index}")
            self._dispatch_tasks.add(task)
            task.add_done_callback(self._dispatch_tasks.discard)
            if stop:
                break

    async def _dispatch_tracked(self, replica: _Replica,
                                batch: list[_Request], shed: bool) -> None:
        """Run one batch on one replica, then return its capacity permit."""
        try:
            await self._dispatch(batch, replica=replica, shed=shed)
        finally:
            replica.inflight -= 1
            if self._capacity is not None:
                self._capacity.release()

    async def _dispatch(self, batch: list[_Request], *,
                        replica: _Replica | None = None,
                        shed: bool = False) -> None:
        now = time.monotonic()
        live = []
        for req in batch:
            if req.future.done():
                # submit()'s wait_for already answered the client
                self.metrics.inc("cancelled_total")
            elif req.deadline <= now:
                self.metrics.inc("cancelled_total")
                req.future.set_exception(DeadlineExceededError(
                    "deadline expired before dispatch"))
            else:
                live.append(req)
        if not live:
            return
        n = len(live)
        for req in live:
            self.metrics.observe_phase("queue", now - req.t0)
        bucket = self.buckets.select(n) or self.buckets.max_size
        t_pad = time.perf_counter()
        with span("serve_pad"):
            padded = pad_batch([req.item for req in live], bucket)
        pad_s = time.perf_counter() - t_pad
        self.metrics.observe_phase("pad", pad_s)
        replica = replica if replica is not None else self._replicas[0]
        loop = asyncio.get_running_loop()
        try:
            out, device_s, readback_s = await loop.run_in_executor(
                replica.pool, self._forward_blocking_timed, padded, replica)
        except Exception as e:  # noqa: BLE001 -- every waiter gets the error
            self.metrics.inc("errors_total")
            self._note_replica_failure(replica)
            t_err = time.monotonic()
            for req in live:
                if not req.future.done():
                    req.future.set_exception(e)
                self._observe_slo(req, False, t_err - req.t0)
            self._slo_check_escalate()
            return
        replica.dispatched += 1
        replica.device_s += device_s
        if self._multi:
            self.metrics.inc(f"replica_{replica.index}_dispatched_total")
        self.metrics.observe_phase("device", device_s)
        self.metrics.observe_phase("readback", readback_s)
        self.metrics.observe_batch(n, bucket, shed=shed)
        done = time.monotonic()
        for i, req in enumerate(live):
            if not req.future.done():
                req.future.set_result(out[i])
                self.metrics.inc("responses_total")
                self.metrics.observe_latency(done - req.t0)
                self._observe_slo(req, True, done - req.t0)
                self._record_trace({
                    "trace_id": req.rid, "replica": replica.index,
                    "bucket": bucket,
                    "queue_s": round(now - req.t0, 6),
                    "pad_s": round(pad_s, 6),
                    "device_s": round(device_s, 6),
                    "readback_s": round(readback_s, 6),
                    "total_s": round(done - req.t0, 6),
                    # the journal's "mono" clock: the timeline exporter
                    # places the request among incident events
                    "done_mono": round(done, 6)})

    # -- device side (executor threads, never the event loop) -------------

    def _forward_blocking(self, padded: np.ndarray,
                          replica: _Replica | None = None) -> np.ndarray:
        """Run the forward and bring the result to the host: the only place
        the engine waits on the device."""
        return self._forward_blocking_timed(padded, replica)[0]

    def _forward_blocking_timed(
            self, padded: np.ndarray, replica: _Replica | None = None
    ) -> tuple[np.ndarray, float, float]:
        """``_forward_blocking`` plus the seconds spent computing (the
        forward and the wait on its stream) and reading back. With
        replicas, a replica-tagged span nests inside ``serve_device``."""
        replica = replica if replica is not None else self._replicas[0]
        fwd = replica.forward
        tagged = (span(f"serve_device_r{replica.index}") if self._multi
                  else contextlib.nullcontext())
        t0 = time.perf_counter()
        with span("serve_device"), tagged:
            out = fwd(padded)
            _wait_device(fwd, out)
        t1 = time.perf_counter()
        with span("serve_readback"):
            host = _to_host(fwd, out)
        return host, t1 - t0, time.perf_counter() - t1
