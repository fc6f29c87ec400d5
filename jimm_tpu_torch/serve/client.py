"""Pure-Python client for the serving endpoint; the counterpart of
``jimm_tpu/serve/client.py``.

Stdlib only (``http.client`` + ``json`` + ``base64``) besides the port's
stdlib-only backoff policy. Arrays go over the
wire as base64 raw float32 when the input quacks like a numpy array
(``astype``/``tobytes``), else as nested JSON lists — matching what
``serve.server`` accepts.
"""

from __future__ import annotations

import base64
import dataclasses
import http.client
import itertools
import json
import os
import threading
import time

from jimm_tpu_torch.resilience.backoff import BackoffPolicy  # stdlib-only module

_trace_counter = itertools.count(1)
_trace_lock = threading.Lock()


def client_trace_id() -> str:
    """Client-minted end-to-end trace id, sent as ``X-Jimm-Trace-Id``. The
    server inherits it into its journal records and trace ring, so one id
    threads client retry → admission → replica dispatch → capture. Prefixed
    with the client pid so ids from a client herd never collide."""
    with _trace_lock:
        n = next(_trace_counter)
    return f"tc{os.getpid():x}-{n:06x}"

#: cascade response headers (`serve/cascade/router.py`'s; spelled out here
#: so this module stays stdlib-only)
CASCADE_HEADER_MODELS = "X-Jimm-Cascade-Models"
CASCADE_HEADER_MODEL = "X-Jimm-Cascade-Model"
CASCADE_HEADER_CONFIDENCE = "X-Jimm-Cascade-Confidence"


@dataclasses.dataclass(frozen=True)
class CascadeInfo:
    """Escalation metadata a cascade-routed response carried: which models
    the request tried (cheapest first), which one answered, and the
    calibrated confidence the final decision rode on (None when the
    terminal stage accepted by fiat)."""

    models_tried: tuple[str, ...]
    model: str
    confidence: float | None

    @property
    def escalations(self) -> int:
        return len(self.models_tried) - 1


def parse_cascade_headers(headers) -> CascadeInfo | None:
    """Parse the ``X-Jimm-Cascade-*`` response headers (a mapping or a
    ``(name, value)`` iterable, matched case-insensitively) into a
    :class:`CascadeInfo`; None when the response was not cascade-routed."""
    items = headers.items() if hasattr(headers, "items") else headers
    lower = {str(k).lower(): v for k, v in items}
    model = lower.get(CASCADE_HEADER_MODEL.lower())
    if model is None:
        return None
    raw = lower.get(CASCADE_HEADER_MODELS.lower()) or ""
    models = tuple(m for m in raw.split(",") if m) or (model,)
    confidence = None
    conf_raw = lower.get(CASCADE_HEADER_CONFIDENCE.lower())
    if conf_raw is not None:
        try:
            confidence = float(conf_raw)
        except ValueError:
            confidence = None
    return CascadeInfo(models_tried=models, model=str(model),
                       confidence=confidence)


class EmbedResult(list):
    """``embed()``'s return value: still the plain features list every
    existing caller indexes into, plus the response's routing metadata
    (:attr:`cascade` is None on non-cascade servers) and trace id."""

    def __init__(self, features, *, cascade: CascadeInfo | None = None,
                 trace_id: str | None = None):
        super().__init__(features)
        self.cascade = cascade
        self.trace_id = trace_id


class ServeClientError(Exception):
    """Server-reported error: carries the HTTP status and the typed code
    (``queue_full``, ``deadline_exceeded``, ``bad_request``, ...), plus
    the server's ``Retry-After`` hint (seconds) when it sent one."""

    def __init__(self, status: int, code: str, message: str,
                 retry_after_s: float | None = None):
        super().__init__(f"{code} (HTTP {status}): {message}")
        self.status = status
        self.code = code
        self.retry_after_s = retry_after_s


class ThrottledClientError(ServeClientError):
    """429: the QoS policy rate-limited this tenant — the request was
    never admitted. Waiting ``retry_after_s`` (the token bucket's refill
    time) before retrying is sufficient, not just polite."""


class ShedClientError(ServeClientError):
    """503 with code ``shed``: the request WAS queued but got evicted
    under overload in favor of a higher-priority class. The server is
    saturated; back off harder than for a throttle."""


def _typed_error(status: int, code: str, message: str,
                 retry_after_s: float | None) -> ServeClientError:
    if status == 429:
        return ThrottledClientError(status, code, message, retry_after_s)
    if status == 503 and code == "shed":
        return ShedClientError(status, code, message, retry_after_s)
    return ServeClientError(status, code, message, retry_after_s)


def encode_image_payload(image) -> dict:
    """The wire form of one image: b64 float32 for array-likes, nested
    lists otherwise."""
    if hasattr(image, "astype") and hasattr(image, "tobytes"):
        arr = image.astype("float32")
        return {"image_b64": base64.b64encode(arr.tobytes()).decode("ascii"),
                "shape": list(arr.shape), "dtype": "float32"}
    return {"image": image}


class ServeClient:
    """One server endpoint with keep-alive transport.

    Each thread reuses one persistent HTTP/1.1 connection across calls
    (``serve.server`` always answers with ``Content-Length``, so the socket
    stays open) instead of paying TCP setup + slow-start per request — the
    dominant client-side cost at micro-batch latencies. Connections live in
    thread-local storage, so a client instance is still safe to share
    across threads: a 64-thread load generator holds 64 sockets, same as
    64 clients, but makes thousands of requests on them. A dead or stale
    socket (server restart, idle timeout) is dropped and the request
    retried immediately on a fresh connection; a fresh connection failing
    (server restarting, briefly unreachable) is retried up to ``retries``
    times with bounded jittered backoff — the same
    :class:`~jimm_tpu_torch.resilience.backoff.BackoffPolicy` the hub-download
    and training-supervisor retry loops use. A request deadline
    (``timeout_s=`` on the call) bounds the whole retry budget: the client
    never sleeps past it.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 8000,
                 timeout_s: float = 30.0, retries: int = 2,
                 backoff_base_s: float = 0.05,
                 backoff_seed: int | None = None,
                 tenant: str | None = None, model: str | None = None,
                 retry_throttled: int = 0):
        self.host = host
        self.port = port
        self.timeout_s = timeout_s
        #: tenant id / model name sent as X-Jimm-Tenant / X-Jimm-Model on
        #: every request (None sends nothing — the anonymous default path)
        self.tenant = tenant
        self.model = model
        #: how many 429-throttled / 503-shed responses to retry before
        #: surfacing the typed error. 0 (default) never retries: batch
        #: jobs opt in, latency-sensitive callers see the error at once.
        self.retry_throttled = retry_throttled
        self._backoff = BackoffPolicy(retries=retries, base_s=backoff_base_s,
                                      max_s=2.0, jitter=0.5,
                                      seed=backoff_seed)
        self._sleep = time.sleep  # injectable for tests
        self._local = threading.local()

    # -- transport --------------------------------------------------------

    def _connection(self) -> http.client.HTTPConnection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = http.client.HTTPConnection(self.host, self.port,
                                              timeout=self.timeout_s)
            self._local.conn = conn
        return conn

    def _drop_connection(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass
            self._local.conn = None

    def close(self) -> None:
        """Close this thread's persistent connection (other threads'
        sockets close when their threads exit or on their own next error).
        """
        self._drop_connection()

    def _request(self, method: str, path: str, payload: dict | None = None,
                 *, deadline_s: float | None = None,
                 with_headers: bool = False):
        body = None if payload is None else json.dumps(payload).encode()
        headers = {"Content-Type": "application/json"} if body else {}
        if self.tenant is not None:
            headers["X-Jimm-Tenant"] = self.tenant
        if self.model is not None:
            headers["X-Jimm-Model"] = self.model
        if body:
            # one id for the whole logical request, retries included — the
            # server inherits it (see server.request_trace_id) so every
            # attempt journals under the same identity
            headers["X-Jimm-Trace-Id"] = client_trace_id()
        deadline = (time.monotonic() + deadline_s
                    if deadline_s is not None else None)
        fresh_failures = 0
        throttle_retries = 0
        while True:
            reused = getattr(self._local, "conn", None) is not None
            conn = self._connection()
            try:
                conn.request(method, path, body=body, headers=headers)
                resp = conn.getresponse()
                raw = resp.read()
            except TimeoutError:
                # a slow server is not a stale socket — surface it
                self._drop_connection()
                raise
            except (http.client.HTTPException, OSError):
                self._drop_connection()
                if reused:
                    # reused socket went stale (server restart, idle close)
                    # before the response started: retry at once, fresh —
                    # this costs nothing and is almost always the fix
                    continue
                # a FRESH connection failing means the server is down or
                # restarting: back off (jittered, so a client herd doesn't
                # reconnect in lockstep), bounded by retries and by the
                # request's own deadline
                if fresh_failures >= self._backoff.retries:
                    raise
                delay = self._backoff.delay(fresh_failures)
                fresh_failures += 1
                if (deadline is not None
                        and time.monotonic() + delay >= deadline):
                    raise  # honoring the deadline beats one more attempt
                self._sleep(delay)
                continue
            if resp.getheader("Connection", "").lower() == "close":
                self._drop_connection()
            content_type = resp.getheader("Content-Type") or ""
            if not content_type.startswith("application/json"):
                if resp.status >= 400:
                    raise ServeClientError(resp.status, "http_error",
                                           raw.decode(errors="replace")[:200])
                return raw.decode(errors="replace")
            obj = json.loads(raw)
            if resp.status < 400:
                if with_headers:
                    return obj, dict(resp.getheaders())
                return obj
            try:
                retry_after = float(resp.getheader("Retry-After"))
            except (TypeError, ValueError):
                retry_after = None
            err = _typed_error(resp.status, obj.get("error", "http_error"),
                               obj.get("message", ""), retry_after)
            if (isinstance(err, (ThrottledClientError, ShedClientError))
                    and throttle_retries < self.retry_throttled):
                # honor Retry-After: sleep at least the server's hint,
                # escalated by the shared jittered BackoffPolicy so a
                # throttled herd doesn't return in lockstep — still
                # bounded by the request deadline
                delay = max(self._backoff.delay(throttle_retries),
                            retry_after or 0.0)
                throttle_retries += 1
                if (deadline is None
                        or time.monotonic() + delay < deadline):
                    self._sleep(delay)
                    continue
            raise err

    # -- API --------------------------------------------------------------

    def healthz(self) -> dict:
        return self._request("GET", "/healthz")

    def metrics_text(self) -> str:
        return self._request("GET", "/metrics")

    def embed(self, image, timeout_s: float | None = None) -> EmbedResult:
        """One image in, its features out — as an :class:`EmbedResult`
        (a plain list, plus ``.cascade`` escalation metadata when the
        server routed through a confidence cascade)."""
        payload = encode_image_payload(image)
        if timeout_s is not None:
            payload["timeout_s"] = timeout_s
        obj, headers = self._request("POST", "/v1/embed", payload,
                                     deadline_s=timeout_s,
                                     with_headers=True)
        return EmbedResult(obj["features"],
                           cascade=parse_cascade_headers(headers),
                           trace_id=obj.get("trace_id"))

    def embed_many(self, images, timeout_s: float | None = None) -> list:
        """Bulk embed: one request, one ``features`` row per image. The
        server submits each image individually so the engine coalesces the
        burst into its warm buckets."""
        payload = {"images": [encode_image_payload(img) for img in images]}
        if timeout_s is not None:
            payload["timeout_s"] = timeout_s
        return self._request("POST", "/v1/embed", payload,
                             deadline_s=timeout_s)["features"]

    def classify(self, image, tokens: dict,
                 timeout_s: float | None = None) -> dict:
        """``tokens``: ``{label: [ids]}`` (or ``{label: [[ids], ...]}`` for
        prompt ensembles). Returns ``{"scores": {label: p}, "cached": b}``.
        """
        payload = encode_image_payload(image)
        payload["tokens"] = tokens
        if timeout_s is not None:
            payload["timeout_s"] = timeout_s
        return self._request("POST", "/v1/classify", payload,
                             deadline_s=timeout_s)

    def search(self, *, vector=None, image=None, k: int | None = None,
               nprobe: int | None = None,
               timeout_s: float | None = None) -> dict:
        """Top-k over the server's retrieval index. Pass a raw ``vector``
        (searched directly) or an ``image`` (embedded through the engine
        first). ``nprobe`` widens/narrows the probe per request when the
        server runs ``--index-mode ivf`` (rejected in exact mode).
        Returns ``{"ids", "scores", "index", "k", "trace_id"}``."""
        if (vector is None) == (image is None):
            raise ValueError("search needs exactly one of vector= or "
                             "image=")
        if vector is not None:
            payload: dict = {"vector": (vector.astype("float32").tolist()
                                        if hasattr(vector, "astype")
                                        else list(vector))}
        else:
            payload = encode_image_payload(image)
        if k is not None:
            payload["k"] = int(k)
        if nprobe is not None:
            payload["nprobe"] = int(nprobe)
        if timeout_s is not None:
            payload["timeout_s"] = timeout_s
        return self._request("POST", "/v1/search", payload,
                             deadline_s=timeout_s)
