"""Stdlib HTTP front end for the inference engine; the counterpart of
``jimm_tpu/serve/server.py``.

``ThreadingHTTPServer`` handler threads bridge into the engine's asyncio
loop with ``run_coroutine_threadsafe``: the loop does all coalescing and
dispatch; handler threads only parse and serialize JSON and block on their
own request's future.

Endpoints::

    GET  /healthz    liveness, counters, warm-up, replicas (and
                     ``"degraded"`` with the fenced ones), the SLO block
    GET  /metrics    Prometheus text: the jimm_serve_* series and every
                     other namespace of the obs hub
    GET  /debug/traces  the engine's per-request trace ring (queue / pad /
                     device / readback), read by ``obs tail --traces`` and
                     ``obs timeline --traces``
    POST /v1/embed   {"image": [[...]]} -> {"features": [...]}; bulk form
                     {"images": [img, ...]} -> {"features": [[...], ...]}
                     (each image submits on its own, so the engine coalesces
                     the burst into its buckets)
    POST /v1/classify  {"image": ..., "tokens": {label: [ids] | [[ids], ...]}}
                     -> {"scores": {label: score}, "cached": bool}: zero-shot
                     scores against the label set's class weights, built by
                     the text tower on a cache miss (a CLIP or SigLIP server
                     only: :class:`ZeroShotService`)
    POST /v1/search  {"vector": [...]} or {"image": ...} (embedded through
                     the engine first), optional "k" -> {"index", "k",
                     "ids", "scores"} from the server's retrieval index
                     (``serve --index``: :class:`~jimm_tpu_torch.retrieval
                     .RetrievalService`); a bulk ``/v1/embed`` counts its
                     rows in ``jimm_retrieval_embed_total``
    POST /admin/revive  {"replica": N} un-fences a watchdog-fenced replica
    POST /admin/prof/trigger  {"cid"?, "reason"?, "window_s"?} -> a deep
                     profiler capture on the caller's cid
                     ({"triggered": bool, ...}); 400 without a capture
                     manager (``serve --prof-dir`` or ``JIMM_PROF_DIR``)

A client's ``X-Jimm-Trace-Id`` header names the request in the
trace ring; ``X-Jimm-Tenant`` and ``X-Jimm-Model`` (or the payload's
``tenant`` and ``model`` fields, which win) name the QoS tenant and the
pool model (`serve/qos/`). With a QoS scheduler or a model pool,
``/healthz`` carries a ``qos`` or ``models`` block; without, neither.
Images ride as nested JSON lists or as ``{"image_b64":
base64(raw float32), "shape": [H, W, C]}``. Typed
:class:`~jimm_tpu_torch.serve.admission.ServeError`\\ s map to their HTTP
status with a machine-readable ``error`` code in the JSON body (and a
``Retry-After`` header where the error carries one).
"""

from __future__ import annotations

import asyncio
import base64
import binascii
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from jimm_tpu_torch.obs.exporters import render_prometheus_text
from jimm_tpu_torch.obs.prof.capture import (CaptureManager,
                                             get_capture_manager)
from jimm_tpu_torch.obs.prof.memory import MemoryMonitor
from jimm_tpu_torch.obs.registry import registries as _obs_registries
from jimm_tpu_torch.obs.spans import new_trace_id
from jimm_tpu_torch.serve.admission import RequestError, ServeError
from jimm_tpu_torch.serve.cache import (EmbeddingCache, class_embedding_cache,
                                        prompt_set_key)
from jimm_tpu_torch.serve.engine import InferenceEngine
from jimm_tpu_torch.utils.zero_shot import token_table_rows, weights_from_rows


def request_trace_id(payload: dict) -> str:
    """The request's trace id: the client's ``X-Jimm-Trace-Id`` (folded
    into the payload by the handler) when it looks sane (a string of 1-64
    characters), else a fresh one."""
    tid = payload.get("trace_id")
    if isinstance(tid, str) and 0 < len(tid) <= 64:
        return tid
    return new_trace_id()


def decode_image_payload(payload: dict, *, dtype=np.float32) -> np.ndarray:
    """Pull the image array out of a request body (list or b64 form)."""
    if "image" in payload:
        try:
            return np.asarray(payload["image"], dtype)
        except (TypeError, ValueError) as e:
            raise RequestError(f"bad 'image' payload: {e}") from None
    if "image_b64" in payload:
        if "shape" not in payload:
            raise RequestError("'image_b64' needs 'shape'")
        try:
            raw = base64.b64decode(payload["image_b64"], validate=True)
            wire = np.dtype(payload.get("dtype", "float32"))
            arr = np.frombuffer(raw, wire).reshape(payload["shape"])
        except (binascii.Error, TypeError, ValueError) as e:
            raise RequestError(f"bad 'image_b64' payload: {e}") from None
        return arr.astype(dtype, copy=False)
    raise RequestError("request needs 'image' or 'image_b64'")


class ZeroShotService:
    """Zero-shot classification over the engine's image features.

    Class weights come from the embedding cache keyed by (model, token
    rows); on repeat label sets the text tower never runs. The per-request
    work after the engine returns features is one small host matmul.
    """

    def __init__(self, model, *, model_key: str,
                 cache: EmbeddingCache | None = None):
        self.model = model
        self.model_key = model_key
        self.cache = cache if cache is not None else class_embedding_cache()
        self.context_length = model.config.text.context_length
        # host f32 calibration, read once: a bf16 model's scalars widened
        self._scale = float(np.exp(np.float32(model.logit_scale.item())))
        bias = getattr(model, "logit_bias", None)
        self._bias = None if bias is None else float(np.float32(bias.item()))

    def class_weights_blocking(self, table: dict
                               ) -> tuple[list[str], np.ndarray, bool]:
        """(labels, (C, D) unit-norm weights, was_cached). Runs the text
        tower only on a cache miss; call from a handler thread, not the
        event loop."""
        try:
            labels, rows, owner = token_table_rows(table, self.context_length)
        except (ValueError, TypeError) as e:
            raise RequestError(str(e)) from None
        key = prompt_set_key(self.model_key, rows.numpy())
        cached = self.cache.get(key)
        if cached is not None:
            return labels, cached, True
        weights = weights_from_rows(self.model, rows, owner,
                                    len(labels)).numpy()
        self.cache.put(key, weights)
        return labels, weights, False

    def scores(self, features: np.ndarray, weights: np.ndarray) -> np.ndarray:
        """Calibrated per-class scores from one feature row: softmax over
        labels (CLIP) or per-class sigmoid (SigLIP, has logit_bias)."""
        feat = features.astype(np.float32)
        feat /= np.linalg.norm(feat)
        logits = self._scale * feat @ weights.T
        if self._bias is not None:
            return 1.0 / (1.0 + np.exp(-(logits + self._bias)))
        e = np.exp(logits - logits.max())
        return e / e.sum()


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # noqa: A003 — silence per-request log
        pass

    def _send(self, status: int, body: bytes,
              content_type: str = "application/json",
              extra_headers: dict | None = None) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for name, value in (extra_headers or {}).items():
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, status: int, obj,
                   extra_headers: dict | None = None) -> None:
        self._send(status, json.dumps(obj).encode(),
                   extra_headers=extra_headers)

    def _send_error_obj(self, e: Exception) -> None:
        if isinstance(e, ServeError):
            body = {"error": e.code, "message": str(e)}
            headers = None
            # throttled (429) and shed (503) answers say when to come back
            retry_after = getattr(e, "retry_after_s", None)
            if retry_after is not None:
                body["retry_after_s"] = retry_after
                headers = {"Retry-After": f"{max(retry_after, 0.0):.3f}"}
            self._send_json(e.http_status, body, extra_headers=headers)
        else:
            self.server.app.metrics.inc("errors_total")
            self._send_json(500, {"error": "internal", "message": str(e)})

    def _read_body(self) -> dict:
        length = int(self.headers.get("Content-Length") or 0)
        if length <= 0:
            raise RequestError("empty request body")
        try:
            payload = json.loads(self.rfile.read(length))
        except ValueError as e:
            raise RequestError(f"bad JSON body: {e}") from None
        if not isinstance(payload, dict):
            raise RequestError("request body must be a JSON object")
        return payload

    def do_GET(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler API
        app = self.server.app
        if self.path == "/healthz":
            self._send_json(200, app.healthz())
        elif self.path == "/metrics":
            self._send(200, app.metrics_text().encode(),
                       "text/plain; version=0.0.4")
        elif self.path == "/debug/traces":
            self._send_json(200, app.debug_traces())
        else:
            self._send_json(404, {"error": "not_found", "message": self.path})

    def do_POST(self) -> None:  # noqa: N802
        app = self.server.app
        try:
            payload = self._read_body()
            # identity and routing headers fold into the payload (an
            # explicit payload field wins); the client's trace id follows
            # the request into the trace ring
            for header, field in (("X-Jimm-Tenant", "tenant"),
                                  ("X-Jimm-Model", "model"),
                                  ("X-Jimm-Trace-Id", "trace_id")):
                value = self.headers.get(header)
                if value is not None:
                    payload.setdefault(field, value)
            if self.path == "/v1/embed":
                out = app.embed(payload)
                # cascade routing metadata travels as response headers, so
                # the body keeps its shape
                cascade_headers = out.pop("_cascade", None)
                self._send_json(200, out, extra_headers=cascade_headers)
            elif self.path == "/v1/classify":
                self._send_json(200, app.classify(payload))
            elif self.path == "/admin/revive":
                self._send_json(200, app.revive(payload))
            elif self.path == "/admin/prof/trigger":
                self._send_json(200, app.prof_trigger(payload))
            elif self.path == "/v1/search":
                self._send_json(200, app.search(payload))
            else:
                self._send_json(404, {"error": "not_found",
                                      "message": self.path})
        except Exception as e:  # noqa: BLE001 — every error gets a response
            self._send_error_obj(e)


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    app: "ServingServer"


class ServingServer:
    """Owns the engine loop thread and the HTTP server thread.

    ``start()`` warms every bucket on every replica (unless
    ``warmup=False``), starts the asyncio loop and the engine on it, then
    opens the listening socket, so the first request already finds warm
    buckets. ``zero_shot`` (a CLIP or SigLIP server) answers
    ``/v1/classify``. A ``metrics_logger`` (anything with ``.log(step,
    **metrics)``, e.g. :class:`~jimm_tpu_torch.train.metrics
    .MetricsLogger`) gets a metrics snapshot every ``metrics_log_every_s``.
    ``stop()`` also stops a device-memory ``monitor`` and commits the open
    capture of a ``capture`` manager. ``pool`` (a
    :class:`~jimm_tpu_torch.serve.qos.ModelPool` whose default entry is
    ``engine``) routes each request's ``model`` to its engine; every pool
    engine shares this server's loop, warm-up and metrics. ``cascade`` (a
    :class:`~jimm_tpu_torch.serve.cascade.CascadeRouter`, which needs a
    pool) routes every single-image embed that names no ``model`` through
    its stages, cheapest first, and answers with the ``X-Jimm-Cascade-*``
    headers; it and an ``autoscaler``
    (:class:`~jimm_tpu_torch.serve.cascade.CascadeAutoscaler`, whose
    control loop its caller drives) show in ``/healthz``. ``retrieval`` (a
    :class:`~jimm_tpu_torch.retrieval.RetrievalService`) answers
    ``/v1/search``, is warmed with the engines and shows in
    ``/healthz``."""

    def __init__(self, engine: InferenceEngine, *, host: str = "127.0.0.1",
                 port: int = 0, request_timeout_s: float = 30.0,
                 zero_shot: ZeroShotService | None = None, pool=None,
                 cascade=None, autoscaler=None, retrieval=None,
                 capture: CaptureManager | None = None,
                 monitor: MemoryMonitor | None = None, warmup: bool = True,
                 metrics_logger=None, metrics_log_every_s: float = 10.0):
        if pool is not None and engine is not pool.default:
            raise ValueError("engine must be the pool's default entry")
        if cascade is not None and pool is None:
            raise ValueError("cascade routing requires a model pool")
        self.pool = pool
        self.cascade = cascade
        self.autoscaler = autoscaler
        self.engine = engine
        self.zero_shot = zero_shot
        self.retrieval = retrieval
        self.capture = capture
        self.monitor = monitor
        self.metrics = engine.metrics
        if zero_shot is not None:
            self.metrics.bind_gauge("cache_hit_rate",
                                    lambda: zero_shot.cache.hit_rate)
        self.host = host
        self._requested_port = port
        self.request_timeout_s = request_timeout_s
        self._warmup = warmup
        self.warmup_s: dict[int, float] = {}
        self.metrics_logger = metrics_logger
        self.metrics_log_every_s = metrics_log_every_s
        self._log_thread: threading.Thread | None = None
        self._log_stop = threading.Event()
        self._loop: asyncio.AbstractEventLoop | None = None
        self._loop_thread: threading.Thread | None = None
        self._httpd: _Server | None = None
        self._http_thread: threading.Thread | None = None

    # -- lifecycle --------------------------------------------------------

    def _engines(self) -> list[InferenceEngine]:
        return self.pool.engines() if self.pool is not None else [self.engine]

    def start(self) -> None:
        if self._loop is not None:
            return
        if self._warmup:
            for engine in self._engines():
                warmed = engine.warmup_blocking()
                if engine is self.engine:
                    self.warmup_s = warmed
            if self.retrieval is not None:
                self.retrieval.warmup()
        loop = asyncio.new_event_loop()
        started = threading.Event()

        def run() -> None:
            asyncio.set_event_loop(loop)
            loop.call_soon(started.set)
            loop.run_forever()

        self._loop_thread = threading.Thread(target=run, daemon=True,
                                             name="jimm-serve-loop")
        self._loop_thread.start()
        started.wait()
        self._loop = loop
        for engine in self._engines():
            asyncio.run_coroutine_threadsafe(engine.start(), loop).result(10)
        self._httpd = _Server((self.host, self._requested_port), _Handler)
        self._httpd.app = self
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="jimm-serve-http")
        self._http_thread.start()
        if self.metrics_logger is not None:
            self._log_stop.clear()
            self._log_thread = threading.Thread(
                target=self._metrics_log_loop, daemon=True,
                name="jimm-serve-metrics")
            self._log_thread.start()

    def _metrics_log_loop(self) -> None:
        step = 0
        while not self._log_stop.wait(self.metrics_log_every_s):
            self.metrics_logger.log(step, **self.metrics.snapshot())
            step += 1

    @property
    def port(self) -> int:
        if self._httpd is None:
            raise RuntimeError("server not started")
        return self._httpd.server_address[1]

    def stop(self) -> None:
        if self._log_thread is not None:
            self._log_stop.set()
            self._log_thread.join(timeout=10)
            self._log_thread = None
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._http_thread is not None:
            self._http_thread.join(timeout=10)
            self._http_thread = None
        if self._loop is not None:
            for engine in self._engines():
                asyncio.run_coroutine_threadsafe(engine.stop(),
                                                 self._loop).result(30)
            self._loop.call_soon_threadsafe(self._loop.stop)
            if self._loop_thread is not None:
                self._loop_thread.join(timeout=10)
                self._loop_thread = None
            self._loop.close()
            self._loop = None
        if self.metrics_logger is not None:
            close = getattr(self.metrics_logger, "close", None)
            if close is not None:
                close()
        if self.monitor is not None:
            self.monitor.stop()
        if self.capture is not None:
            self.capture.flush()

    def serve_forever(self) -> None:
        """Block until KeyboardInterrupt (the CLI foreground mode)."""
        assert self._http_thread is not None
        try:
            while self._http_thread.is_alive():
                self._http_thread.join(timeout=1.0)
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()

    # -- request handling (called from HTTP handler threads) --------------

    def _engine_for(self, model: str | None) -> InferenceEngine:
        """The engine serving a request's ``model`` field (without a pool
        the field is ignored)."""
        if self.pool is None:
            return self.engine
        return self.pool.get(model)

    def _submit_many(self, images: list[np.ndarray], timeout_s: float | None,
                     trace_id: str, *, engine: InferenceEngine,
                     tenant: str | None) -> list[np.ndarray]:
        """Submit every image at once, so the engine's batcher coalesces
        them; a burst's requests are ``{trace_id}.{i}``."""
        assert self._loop is not None
        ids = ([trace_id] if len(images) == 1
               else [f"{trace_id}.{i}" for i in range(len(images))])
        futures = [asyncio.run_coroutine_threadsafe(
            engine.submit(image, timeout_s=timeout_s, trace_id=tid,
                          tenant=tenant),
            self._loop) for image, tid in zip(images, ids)]
        return [f.result(timeout=self.request_timeout_s) for f in futures]

    def embed(self, payload: dict) -> dict:
        rid = request_trace_id(payload)
        timeout_s = payload.get("timeout_s")
        engine = self._engine_for(payload.get("model"))
        route = {"engine": engine, "tenant": payload.get("tenant")}
        if "images" in payload:
            raw = payload["images"]
            if not isinstance(raw, list) or not raw:
                raise RequestError("'images' must be a non-empty list")
            images = [decode_image_payload(
                item if isinstance(item, dict) else {"image": item},
                dtype=engine.dtype) for item in raw]
            features = self._submit_many(images, timeout_s, rid, **route)
            from jimm_tpu_torch.retrieval.api import retrieval_metrics
            retrieval_metrics()[1].inc(len(images))
            return {"features": [f.tolist() for f in features],
                    "count": len(features), "trace_id": rid}
        image = decode_image_payload(payload, dtype=engine.dtype)
        if self.cascade is not None and payload.get("model") is None:
            result = self._submit_cascade(image, timeout_s, rid,
                                          payload.get("tenant"))
            return {"features": np.asarray(result.output,
                                           np.float32).tolist(),
                    "trace_id": rid,
                    # popped into the response headers by the handler
                    "_cascade": result.headers()}
        return {"features": self._submit_many([image], timeout_s, rid,
                                              **route)[0].tolist(),
                "trace_id": rid}

    def _submit_cascade(self, image: np.ndarray, timeout_s: float | None,
                        trace_id: str, tenant: str | None):
        """One request through the cascade router on the serving loop: the
        router's ``CascadeResult`` (output and routing metadata)."""
        assert self._loop is not None and self.cascade is not None
        future = asyncio.run_coroutine_threadsafe(
            self.cascade.submit(image, timeout_s=timeout_s,
                                trace_id=trace_id, tenant=tenant),
            self._loop)
        return future.result(timeout=self.request_timeout_s)

    def search(self, payload: dict) -> dict:
        """Top-k over the retrieval index: a raw query ``vector`` searches
        directly; an image embeds through the engine first (the same
        buckets, admission and replica dispatch as ``/v1/embed``)."""
        if self.retrieval is None:
            raise RequestError("this server has no retrieval index "
                               "(start with serve --index)")
        rid = request_trace_id(payload)
        if "vector" in payload:
            try:
                query = np.asarray(payload["vector"], np.float32)
            except (TypeError, ValueError) as e:
                raise RequestError(f"bad 'vector' payload: {e}") from None
        else:
            engine = self._engine_for(payload.get("model"))
            image = decode_image_payload(payload, dtype=engine.dtype)
            query = np.asarray(self._submit_many(
                [image], payload.get("timeout_s"), rid, engine=engine,
                tenant=payload.get("tenant"))[0], np.float32)
        nprobe = payload.get("nprobe")
        if nprobe is not None:
            try:
                nprobe = int(nprobe)
            except (TypeError, ValueError):
                raise RequestError(
                    f"'nprobe' must be an integer; got {nprobe!r}") \
                    from None
        values, ids = self.retrieval.search_blocking(
            query, k=payload.get("k"), nprobe=nprobe)
        return {"index": self.retrieval.index.name, "k": len(ids[0]),
                "ids": ids[0],
                "scores": [round(float(v), 6)
                           for v in values[0][:len(ids[0])]],
                "trace_id": rid}

    def classify(self, payload: dict) -> dict:
        if self.zero_shot is None:
            raise RequestError("this server has no zero-shot service "
                               "(started without a text tower)")
        rid = request_trace_id(payload)
        tokens = payload.get("tokens")
        if not isinstance(tokens, dict) or not tokens:
            raise RequestError("classify needs 'tokens': {label: [ids]}")
        labels, weights, cached = \
            self.zero_shot.class_weights_blocking(tokens)
        engine = self._engine_for(payload.get("model"))
        image = decode_image_payload(payload, dtype=engine.dtype)
        features = self._submit_many([image], payload.get("timeout_s"), rid,
                                     engine=engine,
                                     tenant=payload.get("tenant"))[0]
        scores = self.zero_shot.scores(np.asarray(features), weights)
        return {"scores": {label: round(float(s), 6)
                           for label, s in zip(labels, scores)},
                "cached": cached}

    def revive(self, payload: dict) -> dict:
        """``POST /admin/revive {"replica": N}`` (and ``"model"`` in a
        pool): un-fence lane N with a fresh executor and a re-armed
        restart. A bad index or a replica that is not fenced is a 400. The
        engine's replica state belongs to its loop, so the revive runs
        there (on a short-lived loop when the server was never started)."""
        index = payload.get("replica")
        if not isinstance(index, int) or isinstance(index, bool):
            raise RequestError("revive needs 'replica': <int index>")
        engine = self._engine_for(payload.get("model"))
        try:
            if self._loop is None:
                stats = self._revive_on_disposable_loop(engine, index)
            else:
                stats = asyncio.run_coroutine_threadsafe(
                    self._revive_on_loop(engine, index),
                    self._loop).result(30.0)
        except ValueError as e:
            raise RequestError(str(e)) from None
        return {"revived": index, "replica_stats": stats,
                "dead_replicas": engine.dead_replicas()}

    async def _revive_on_loop(self, engine: InferenceEngine,
                              index: int) -> dict:
        return engine.revive(index)

    def _revive_on_disposable_loop(self, engine: InferenceEngine,
                                   index: int) -> dict:
        loop = asyncio.new_event_loop()
        thread = threading.Thread(target=loop.run_forever,
                                  name="jimm-serve-loop", daemon=True)
        thread.start()
        try:
            return asyncio.run_coroutine_threadsafe(
                self._revive_on_loop(engine, index), loop).result(30.0)
        finally:
            loop.call_soon_threadsafe(loop.stop)
            thread.join(timeout=5.0)
            loop.close()

    def prof_trigger(self, payload: dict) -> dict:
        """``POST /admin/prof/trigger``: a deep profiler capture on a
        caller-supplied incident cid (``obs prof trigger``). The capture
        manager is process-global (``serve --prof-dir`` or
        ``JIMM_PROF_DIR``); a server without one answers 400, not a silent
        no-op."""
        mgr = get_capture_manager()
        if mgr is None:
            raise RequestError("this server has no capture manager "
                               "(start with serve --prof-dir, or set "
                               "JIMM_PROF_DIR)")
        cid = payload.get("cid")
        if cid is not None and not isinstance(cid, str):
            raise RequestError("'cid' must be a string")
        reason = payload.get("reason", "admin")
        if not isinstance(reason, str):
            raise RequestError("'reason' must be a string")
        window_s = payload.get("window_s")
        if window_s is not None and not isinstance(window_s, (int, float)):
            raise RequestError("'window_s' must be a number")
        meta = mgr.trigger(cid, reason,
                           window_s=float(window_s) if window_s else None)
        if meta is None:
            return {"triggered": False, "suppressed": True}
        return {"triggered": True, "capture": meta}

    def metrics_text(self) -> str:
        """The ``/metrics`` dump: this server's ``jimm_serve_*`` series (the
        :class:`ServeMetrics` snapshot) merged with every other namespace
        published to the obs hub."""
        series: dict = {}
        for prefix, reg in _obs_registries().items():
            if prefix == "jimm_serve":
                continue  # ours comes from self.metrics below
            for name, value in reg.snapshot().items():
                series[f"{prefix}_{name}"] = value
        for name, value in self.metrics.snapshot().items():
            series[f"jimm_serve_{name}"] = value
        return render_prometheus_text(series)

    def debug_traces(self) -> dict:
        """The engine's ``recent_traces`` ring (newest last)."""
        traces = list(self.engine.recent_traces)
        return {"traces": traces, "count": len(traces)}

    def healthz(self) -> dict:
        snap = self.metrics.snapshot()
        out = {"status": "ok", "buckets": list(self.engine.buckets.sizes),
               "warmup_s": {str(k): v for k, v in self.warmup_s.items()},
               **snap}
        report = self.engine.warmup_report
        if report:
            out["warmup"] = {str(k): v for k, v in sorted(report.items())}
        if self.engine._multi:
            out["replicas"] = self.engine.replica_stats()
            out["replans"] = int(self.metrics.count("replans_total"))
            if self.engine.last_heal_error:
                out["last_heal_error"] = self.engine.last_heal_error
        # a fenced replica downgrades the probe: the server answers, with
        # less capacity
        dead = self.engine.dead_replicas()
        if dead:
            out["status"] = "degraded"
            out["dead_replicas"] = dead
        if self.retrieval is not None:
            out["retrieval"] = self.retrieval.describe()
        # the qos and models blocks exist only with a policy or a pool
        if self.engine.qos is not None:
            out["qos"] = self.engine.qos.snapshot()
        if self.pool is not None:
            out["models"] = self.pool.describe()
        # as are the cascade and autoscale blocks, with a router or a loop
        if self.cascade is not None:
            out["cascade"] = self.cascade.describe()
        if self.autoscaler is not None:
            out["autoscale"] = self.autoscaler.describe()
        slo = self.engine.slo
        if slo is not None:
            out["slo"] = slo.snapshot()
            if out["slo"]["fast_burning"] and out["status"] == "ok":
                out["status"] = "degraded"
        return out
