"""Async micro-batching inference engine (one replica); the counterpart of
``jimm_tpu/serve/engine.py``.

Single requests arrive on an asyncio loop; a batcher task coalesces them,
pads each micro-batch up to a :mod:`~jimm_tpu_torch.serve.buckets` size and
runs it on one single-thread executor, which does all device work and ends
each batch with ``.cpu()``. The coalescing policy:

1. take the first queued request, open a ``max_delay_ms`` window;
2. drain whatever else is already queued (no await, no added latency);
3. wait out the rest of the window for stragglers, unless the queue depth
   is past the admission policy's shed watermark, in which case dispatch at
   once;
4. stop early the moment the largest bucket fills.

The batcher takes the next request only when the executor is free, so
queued requests stay visible to the queue bound while a batch computes.
"""

from __future__ import annotations

import asyncio
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable

import numpy as np
import torch

from jimm_tpu_torch.serve.admission import (AdmissionController,
                                            AdmissionPolicy,
                                            DeadlineExceededError,
                                            EngineClosedError, RequestError,
                                            ServeMetrics)
from jimm_tpu_torch.serve.buckets import BucketTable, pad_batch

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


class _Request:
    __slots__ = ("item", "future", "deadline", "t0")

    def __init__(self, item: np.ndarray, future: asyncio.Future,
                 deadline: float, t0: float):
        self.item = item
        self.future = future
        self.deadline = deadline
        self.t0 = t0


class InferenceEngine:
    """Coalesces single-item requests into bucketed micro-batches.

    Args:
        forward: callable over a ``(B, *item_shape)`` numpy array returning
            a tensor whose row ``i`` answers input row ``i`` (e.g.
            :func:`image_forward`).
        item_shape: per-request input shape (no batch axis); anything else
            is rejected with :class:`RequestError`.
        buckets: allowed batch sizes.
        max_delay_ms: coalescing window.
        policy: admission policy (queue bound, default deadline).
    """

    #: batches are assembled in f32 (requests are cast); the forward casts
    #: to the model's dtype on the device
    dtype = np.dtype(np.float32)

    def __init__(self, forward: Callable[[np.ndarray], torch.Tensor], *,
                 item_shape: tuple[int, ...], buckets: BucketTable,
                 max_delay_ms: float = 5.0,
                 policy: AdmissionPolicy | None = None):
        self.forward = forward
        self.item_shape = tuple(item_shape)
        self.buckets = buckets
        self.max_delay_s = max_delay_ms / 1e3
        self.metrics = ServeMetrics()
        self.admission = AdmissionController(policy, self.metrics)
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="jimm-serve-fwd")
        self._queue: asyncio.Queue | None = None
        self._task: asyncio.Task | None = None
        self._idle: asyncio.Event | None = None
        self._dispatch: asyncio.Task | None = None
        self._running = False

    # -- lifecycle --------------------------------------------------------

    def warmup_blocking(self) -> dict[int, float]:
        """Run every bucket once before traffic (call off the event loop).
        Returns {bucket: seconds}."""
        times = {}
        for size in self.buckets.sizes:
            t0 = time.monotonic()
            self._forward_blocking(
                np.zeros((size,) + self.item_shape, self.dtype))
            times[size] = round(time.monotonic() - t0, 4)
        return times

    async def start(self) -> None:
        if self._running:
            return
        self._queue = asyncio.Queue()
        self._idle = asyncio.Event()
        self._idle.set()
        self._running = True
        self._task = asyncio.get_running_loop().create_task(
            self._batcher(), name="jimm-serve-batcher")

    async def stop(self) -> None:
        if not self._running:
            return
        self._running = False
        assert self._queue is not None
        self._queue.put_nowait(_STOP)
        if self._task is not None:
            await self._task
            self._task = None
        if self._dispatch is not None:
            await self._dispatch
            self._dispatch = None
        self._pool.shutdown(wait=True)

    # -- submission -------------------------------------------------------

    async def submit(self, item: np.ndarray,
                     timeout_s: float | None = None) -> np.ndarray:
        """One request in, one output row out. Raises
        :class:`~jimm_tpu_torch.serve.admission.QueueFullError`,
        :class:`RequestError` or :class:`DeadlineExceededError`."""
        if not self._running or self._queue is None:
            raise EngineClosedError("engine is not running; call start()")
        arr = np.asarray(item, self.dtype)
        if arr.shape != self.item_shape:
            self.metrics.inc("errors_total")
            raise RequestError(f"item shape {arr.shape} != engine shape "
                               f"{self.item_shape}")
        self.metrics.inc("requests_total")
        self.admission.admit(self._queue.qsize())
        now = time.monotonic()
        deadline = self.admission.deadline_for(timeout_s, now)
        future = asyncio.get_running_loop().create_future()
        self._queue.put_nowait(_Request(arr, future, deadline, now))
        try:
            return await asyncio.wait_for(future, timeout=deadline - now)
        except asyncio.TimeoutError:
            self.metrics.inc("timeouts_total")
            raise DeadlineExceededError(
                f"request deadline ({deadline - now:.3f}s) exceeded") from None

    # -- batching loop ----------------------------------------------------

    async def _batcher(self) -> None:
        assert self._queue is not None and self._idle is not None
        queue = self._queue
        max_size = self.buckets.max_size
        while True:
            # the executor must be free before the next batch is taken, so
            # waiting requests count against the queue bound meanwhile
            await self._idle.wait()
            first = await queue.get()
            if first is _STOP:
                break
            batch = [first]
            window_end = time.monotonic() + self.max_delay_s
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
            self._idle.clear()
            self._dispatch = asyncio.get_running_loop().create_task(
                self._run(batch, shed), name="jimm-serve-dispatch")
            if stop:
                break

    async def _run(self, batch: list[_Request], shed: bool) -> None:
        assert self._idle is not None
        try:
            await self._dispatch_batch(batch, shed)
        finally:
            self._idle.set()

    async def _dispatch_batch(self, batch: list[_Request], shed: bool) -> None:
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
        bucket = self.buckets.select(len(live)) or self.buckets.max_size
        padded = pad_batch([req.item for req in live], bucket)
        loop = asyncio.get_running_loop()
        try:
            out = await loop.run_in_executor(self._pool,
                                             self._forward_blocking, padded)
        except Exception as e:  # noqa: BLE001 — every waiter gets the error
            self.metrics.inc("errors_total")
            for req in live:
                if not req.future.done():
                    req.future.set_exception(e)
            return
        self.metrics.observe_batch(len(live), bucket, shed=shed)
        done = time.monotonic()
        for i, req in enumerate(live):
            if not req.future.done():
                req.future.set_result(out[i])
                self.metrics.inc("responses_total")
                self.metrics.observe_latency(done - req.t0)

    # -- device side (executor thread, never the event loop) --------------

    def _forward_blocking(self, padded: np.ndarray) -> np.ndarray:
        """Run the forward and bring the result to the host: the only place
        the engine waits on the device."""
        return self.forward(padded).float().cpu().numpy()
