"""Multi-model residency: several warm engines behind one server; the
counterpart of ``jimm_tpu/serve/qos/pool.py``.

A :class:`ModelPool` keeps N models (e.g. the f32 and int8 twins, or B/16
next to So400m) resident on one topology, each wrapped in its own
:class:`~jimm_tpu_torch.serve.engine.InferenceEngine` with its own buckets
and forwards. Requests pick a model with the ``model=`` field (or
``X-Jimm-Model`` header); absent means the default model, so single-model
deployments are unchanged.

Weight hot-swap is :meth:`swap`: stage a fresh warmed engine under an
existing name and the pool atomically re-routes new requests to it,
returning the old engine for the caller to drain and stop. The pool's
table is operator-configured and every entry is removable
(:meth:`remove` is the eviction path) — request traffic can route to
models but never create them.
"""

from __future__ import annotations

import threading

from jimm_tpu_torch.serve.admission import RequestError

__all__ = ["ModelPool", "param_nbytes"]


def param_nbytes(tree) -> int:
    """Total parameter bytes of a torch module (its parameters and
    buffers, each storage once), a tensor or array, or a (possibly nested)
    dict/list/tuple of them. Duck-typed, so this module imports no
    torch."""
    if callable(getattr(tree, "parameters", None)):  # a torch module
        from jimm_tpu_torch.obs.prof.memory import module_bytes
        return module_bytes(tree)
    if callable(getattr(tree, "element_size", None)):  # a torch tensor
        return int(tree.numel()) * int(tree.element_size())
    if isinstance(tree, (list, tuple)):
        return sum(param_nbytes(v) for v in tree)
    size = getattr(tree, "size", None)
    itemsize = getattr(getattr(tree, "dtype", None), "itemsize", None)
    if size is not None and itemsize is not None:  # a numpy array
        return int(size) * int(itemsize)
    items = getattr(tree, "items", None)
    if callable(items):
        return sum(param_nbytes(v) for _, v in items())
    return 0


class ModelPool:
    """Named engines sharing one server, one metrics surface, one loop.

    Args:
        engines: ``{name: InferenceEngine}`` — all resident models. Build
            them with a **shared** :class:`ServeMetrics` so the pool reads
            as one ``jimm_serve`` namespace; the pool adds per-model
            dispatch counters on top.
        default: name routed when a request names no model.
    """

    def __init__(self, engines: dict, *, default: str):
        if default not in engines:
            raise ValueError(f"default model {default!r} not in pool "
                             f"({sorted(engines)})")
        self._lock = threading.Lock()
        self._engines = dict(engines)
        self.default_name = default
        self._resident_bytes: dict[str, int] = {}
        metrics = engines[default].metrics
        for name, engine in engines.items():
            metrics.inc(f"model_{name}_requests_total", 0)
            self._track_bytes(name, engine)
        metrics.bind_gauge(
            "pool_resident_bytes",
            lambda: float(sum(self._resident_bytes.values())))

    def _track_bytes(self, name: str, engine) -> None:
        """Record a model's resident parameter bytes (from the engine's
        ``resident_param_bytes`` attribute, stamped at build time or via
        :meth:`set_resident_bytes`) and expose the
        ``pool_resident_bytes_{model}`` gauge. The gauge closure reads the
        dict, so swap/remove update the scrape without rebinding."""
        self._resident_bytes[name] = int(
            getattr(engine, "resident_param_bytes", 0) or 0)
        self.metrics.bind_gauge(
            f"pool_resident_bytes_{name}",
            lambda n=name: float(self._resident_bytes.get(n, 0)))

    # -- routing ----------------------------------------------------------

    @property
    def metrics(self):
        """The pool's shared metrics surface (the default engine's)."""
        return self._engines[self.default_name].metrics

    @property
    def default(self):
        return self._engines[self.default_name]

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._engines)

    def engines(self) -> list:
        with self._lock:
            return list(self._engines.values())

    def get(self, model: str | None):
        """The engine serving ``model`` (None -> default). Unknown names
        are a client error, not a server fault."""
        with self._lock:
            if model is None:
                engine = self._engines[self.default_name]
                name = self.default_name
            else:
                engine = self._engines.get(model)
                name = model
            if engine is None:
                raise RequestError(
                    f"unknown model {model!r} (resident: "
                    f"{sorted(self._engines)})")
        engine.metrics.inc(f"model_{name}_requests_total")
        return engine

    # -- residency management (operator plane) ----------------------------

    def add(self, name: str, engine) -> None:
        """Make a warmed, started engine resident under a new name."""
        with self._lock:
            if name in self._engines:
                raise ValueError(f"model {name!r} already resident; "
                                 "use swap()")
            self._engines[name] = engine
        engine.metrics.inc(f"model_{name}_requests_total", 0)
        self._track_bytes(name, engine)

    def swap(self, name: str, engine):
        """Weight hot-swap: atomically route ``name`` to ``engine`` and
        return the previous engine (caller drains/stops it). The new
        engine must already be warm — the swap itself never compiles."""
        with self._lock:
            if name not in self._engines:
                raise ValueError(f"model {name!r} not resident; use add()")
            old = self._engines[name]
            self._engines[name] = engine
        self._track_bytes(name, engine)
        return old

    def remove(self, name: str):
        """Evict a resident model (the default cannot be evicted) and
        return its engine for the caller to stop."""
        with self._lock:
            if name == self.default_name:
                raise ValueError("cannot remove the default model")
            if name not in self._engines:
                raise ValueError(f"model {name!r} not resident")
            self._resident_bytes.pop(name, None)
            return self._engines.pop(name)

    def set_resident_bytes(self, name: str, nbytes: int) -> None:
        """Operator override for a model's resident parameter bytes (for
        engines built before byte stamping, or quantized twins whose
        packed layout the model's construction cannot see)."""
        with self._lock:
            if name not in self._engines:
                raise ValueError(f"model {name!r} not resident")
            self._resident_bytes[name] = int(nbytes)

    def resident_bytes(self) -> dict[str, int]:
        """Per-model resident parameter bytes (autoscaler residency input)."""
        with self._lock:
            return dict(self._resident_bytes)

    # -- surfaces ---------------------------------------------------------

    def describe(self) -> dict:
        """healthz ``models`` block: per-model buckets/dtype/warm-start
        provenance and dispatch counts."""
        with self._lock:
            items = sorted(self._engines.items())
        out = {}
        for name, engine in items:
            row = {"default": name == self.default_name,
                   "buckets": list(engine.buckets.sizes),
                   # serving precision rides the bucket table, not the
                   # engine (whose dtype is batch assembly, always f32)
                   "dtype": engine.buckets.dtype,
                   "resident_param_bytes": self._resident_bytes.get(name, 0),
                   "requests": engine.metrics.count(
                       f"model_{name}_requests_total")}
            report = getattr(engine, "warmup_report", None)
            if report:
                row["warmup"] = {str(k): v["source"]
                                 for k, v in sorted(report.items())}
            out[name] = row
        return out
