"""Stdlib HTTP front end for the inference engine; the counterpart of
``jimm_tpu/serve/server.py``.

``ThreadingHTTPServer`` handler threads bridge into the engine's asyncio
loop with ``run_coroutine_threadsafe``: the loop does all coalescing and
dispatch; handler threads only parse and serialize JSON and block on their
own request's future.

Endpoints::

    GET  /healthz    liveness + counters snapshot
    POST /v1/embed   {"image": [[...]]} -> {"features": [...]}; bulk form
                     {"images": [img, ...]} -> {"features": [[...], ...]}
                     (each image submits on its own, so the engine coalesces
                     the burst into its buckets)
    POST /v1/classify  {"image": ..., "tokens": {label: [ids] | [[ids], ...]}}
                     -> {"scores": {label: score}, "cached": bool}: zero-shot
                     scores against the label set's class weights, built by
                     the text tower on a cache miss (a CLIP or SigLIP server
                     only: :class:`ZeroShotService`)
    POST /admin/prof/trigger  {"cid"?, "reason"?, "window_s"?} -> a deep
                     profiler capture on the caller's cid
                     ({"triggered": bool, ...}); 400 without a capture
                     manager (``serve --prof-dir`` or ``JIMM_PROF_DIR``)

Images ride as nested JSON lists or as ``{"image_b64": base64(raw float32),
"shape": [H, W, C]}``. Typed :class:`~jimm_tpu_torch.serve.admission
.ServeError`\\ s map to their HTTP status with a machine-readable ``error``
code in the JSON body.
"""

from __future__ import annotations

import asyncio
import base64
import binascii
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from jimm_tpu_torch.obs.prof.capture import (CaptureManager,
                                             get_capture_manager)
from jimm_tpu_torch.obs.prof.memory import MemoryMonitor
from jimm_tpu_torch.serve.admission import RequestError, ServeError
from jimm_tpu_torch.serve.cache import (EmbeddingCache, class_embedding_cache,
                                        prompt_set_key)
from jimm_tpu_torch.serve.engine import InferenceEngine
from jimm_tpu_torch.utils.zero_shot import token_table_rows, weights_from_rows


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

    def _send_json(self, status: int, obj) -> None:
        body = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

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
        if self.path == "/healthz":
            self._send_json(200, self.server.app.healthz())
        else:
            self._send_json(404, {"error": "not_found", "message": self.path})

    def do_POST(self) -> None:  # noqa: N802
        app = self.server.app
        try:
            if self.path == "/v1/embed":
                self._send_json(200, app.embed(self._read_body()))
            elif self.path == "/v1/classify":
                self._send_json(200, app.classify(self._read_body()))
            elif self.path == "/admin/prof/trigger":
                self._send_json(200, app.prof_trigger(self._read_body()))
            else:
                self._send_json(404, {"error": "not_found",
                                      "message": self.path})
        except ServeError as e:
            self._send_json(e.http_status, {"error": e.code,
                                            "message": str(e)})
        except Exception as e:  # noqa: BLE001 — every error gets a response
            app.metrics.inc("errors_total")
            self._send_json(500, {"error": "internal", "message": str(e)})


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    app: "ServingServer"


class ServingServer:
    """Owns the engine loop thread and the HTTP server thread.

    ``start()`` warms every bucket, starts the asyncio loop and the engine
    on it, then opens the listening socket, so the first request already
    finds warm buckets. ``zero_shot`` (a CLIP or SigLIP server) answers
    ``/v1/classify``. ``stop()`` also stops a device-memory ``monitor``
    and commits the open capture of a ``capture`` manager."""

    def __init__(self, engine: InferenceEngine, *, host: str = "127.0.0.1",
                 port: int = 0, request_timeout_s: float = 30.0,
                 zero_shot: ZeroShotService | None = None,
                 capture: CaptureManager | None = None,
                 monitor: MemoryMonitor | None = None):
        self.engine = engine
        self.zero_shot = zero_shot
        self.capture = capture
        self.monitor = monitor
        self.metrics = engine.metrics
        self.host = host
        self._requested_port = port
        self.request_timeout_s = request_timeout_s
        self.warmup_s: dict[int, float] = {}
        self._loop: asyncio.AbstractEventLoop | None = None
        self._loop_thread: threading.Thread | None = None
        self._httpd: _Server | None = None
        self._http_thread: threading.Thread | None = None

    def start(self) -> None:
        if self._loop is not None:
            return
        self.warmup_s = self.engine.warmup_blocking()
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
        asyncio.run_coroutine_threadsafe(self.engine.start(), loop).result(10)
        self._httpd = _Server((self.host, self._requested_port), _Handler)
        self._httpd.app = self
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="jimm-serve-http")
        self._http_thread.start()

    @property
    def port(self) -> int:
        if self._httpd is None:
            raise RuntimeError("server not started")
        return self._httpd.server_address[1]

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._http_thread is not None:
            self._http_thread.join(timeout=10)
            self._http_thread = None
        if self._loop is not None:
            asyncio.run_coroutine_threadsafe(self.engine.stop(),
                                             self._loop).result(30)
            self._loop.call_soon_threadsafe(self._loop.stop)
            if self._loop_thread is not None:
                self._loop_thread.join(timeout=10)
                self._loop_thread = None
            self._loop.close()
            self._loop = None
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

    def _submit_many(self, images: list[np.ndarray],
                     timeout_s: float | None) -> list[np.ndarray]:
        assert self._loop is not None
        futures = [asyncio.run_coroutine_threadsafe(
            self.engine.submit(image, timeout_s=timeout_s), self._loop)
            for image in images]
        return [f.result(timeout=self.request_timeout_s) for f in futures]

    def embed(self, payload: dict) -> dict:
        timeout_s = payload.get("timeout_s")
        if "images" in payload:
            raw = payload["images"]
            if not isinstance(raw, list) or not raw:
                raise RequestError("'images' must be a non-empty list")
            images = [decode_image_payload(
                item if isinstance(item, dict) else {"image": item},
                dtype=self.engine.dtype) for item in raw]
            features = self._submit_many(images, timeout_s)
            return {"features": [f.tolist() for f in features],
                    "count": len(features)}
        image = decode_image_payload(payload, dtype=self.engine.dtype)
        return {"features": self._submit_many([image], timeout_s)[0].tolist()}

    def classify(self, payload: dict) -> dict:
        if self.zero_shot is None:
            raise RequestError("this server has no zero-shot service "
                               "(started without a text tower)")
        tokens = payload.get("tokens")
        if not isinstance(tokens, dict) or not tokens:
            raise RequestError("classify needs 'tokens': {label: [ids]}")
        labels, weights, cached = \
            self.zero_shot.class_weights_blocking(tokens)
        image = decode_image_payload(payload, dtype=self.engine.dtype)
        features = self._submit_many([image], payload.get("timeout_s"))[0]
        scores = self.zero_shot.scores(np.asarray(features), weights)
        return {"scores": {label: round(float(s), 6)
                           for label, s in zip(labels, scores)},
                "cached": cached}

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

    def healthz(self) -> dict:
        snap = self.metrics.snapshot()
        return {"status": "ok" if self._loop is not None else "stopped",
                "buckets": list(self.engine.buckets.sizes),
                "warmup_s": {str(k): v for k, v in self.warmup_s.items()},
                **snap}
