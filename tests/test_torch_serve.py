"""The port's served slice on the CPU: the tiny SigLIP (JAX weights carried
across) behind `jimm_tpu_torch.serve`, answered over HTTP and held against
the JAX model's ``encode_image``; plus the bucket and admission rules."""

import base64
import json
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from jimm_tpu import configs as jax_configs
from jimm_tpu.models.siglip import SigLIP as JaxSigLIP
from jimm_tpu_torch import configs
from jimm_tpu_torch.models.siglip import SigLIP, load_jax_params
from jimm_tpu_torch.serve.admission import (AdmissionController,
                                            AdmissionPolicy,
                                            DeadlineExceededError,
                                            EngineClosedError,
                                            QueueFullError, RequestError,
                                            ShedError)
from jimm_tpu_torch.serve.buckets import (BucketTable, default_buckets,
                                          pad_batch)
from jimm_tpu_torch.serve.engine import InferenceEngine, image_forward
from jimm_tpu_torch.serve.server import ServingServer
from test_torch_siglip import jax_params, tiny_config


def _post(port: int, payload: dict, path: str = "/v1/embed"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _b64(img: np.ndarray) -> dict:
    return {"image_b64": base64.b64encode(img.tobytes()).decode(),
            "shape": list(img.shape)}


@pytest.fixture(scope="module")
def served():
    jmodel = JaxSigLIP(tiny_config(jax_configs), rngs=nnx.Rngs(0))
    tmodel = SigLIP(tiny_config(configs), device="cpu")
    load_jax_params(tmodel, jax_params(jmodel))
    engine = InferenceEngine(image_forward(tmodel), item_shape=(64, 64, 3),
                             buckets=default_buckets("cpu"), max_delay_ms=20)
    server = ServingServer(engine, port=0)
    server.start()
    try:
        yield jmodel, server
    finally:
        server.stop()


def test_embed_matches_jax(served):
    jmodel, server = served
    rng = np.random.default_rng(1)
    images = rng.standard_normal((6 + 5, 64, 64, 3), np.float32)
    want = np.asarray(nnx.jit(lambda m, x: m.encode_image(x))(
        jmodel, jnp.asarray(images)))
    singles = [{"image": img.tolist()} if i % 2 else _b64(img)
               for i, img in enumerate(images[:6])]
    with ThreadPoolExecutor(6) as pool:
        answers = list(pool.map(lambda p: _post(server.port, p), singles))
    for i, (status, body) in enumerate(answers):
        assert status == 200, body
        np.testing.assert_allclose(body["features"], want[i], atol=1e-4,
                                   rtol=1e-4)
    bulk = [_b64(img) if i % 2 else img.tolist()
            for i, img in enumerate(images[6:])]
    status, body = _post(server.port, {"images": bulk})
    assert status == 200 and body["count"] == 5
    np.testing.assert_allclose(body["features"], want[6:], atol=1e-4,
                               rtol=1e-4)
    snap = server.metrics.snapshot()
    assert snap["responses_total"] >= 11
    assert snap["batches_total"] < snap["responses_total"]  # coalesced


def test_healthz_and_errors(served):
    _, server = served
    with urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/healthz", timeout=30) as resp:
        health = json.loads(resp.read())
    assert health["status"] == "ok" and health["buckets"] == [1, 2, 4, 8]
    assert set(health["warmup_s"]) == {"1", "2", "4", "8"}
    status, body = _post(server.port, {"image": [[1.0]]})
    assert status == 400 and body["error"] == "bad_request"
    status, body = _post(server.port, {"nope": 1})
    assert status == 400
    status, body = _post(server.port, {"image": [[1.0]]},
                         path="/v1/classify")
    assert status == 400 and body["message"] == (
        "this server has no zero-shot service (started without a text "
        "tower)")
    status, _ = _post(server.port, {"image": [[1.0]]}, path="/v1/nope")
    assert status == 404


def test_bucket_rules():
    table = BucketTable((8, 1, 4, 4, 2))
    assert table.sizes == (1, 2, 4, 8) and table.max_size == 8
    assert [table.select(n) for n in (1, 2, 3, 5, 8, 9)] == [1, 2, 4, 8, 8,
                                                             None]
    assert [table.shed(n) for n in (1, 3, 7, 8, 100)] == [1, 2, 4, 8, 8]
    with pytest.raises(ValueError):
        table.select(0)
    with pytest.raises(ValueError):
        BucketTable((0, 1))
    assert default_buckets("cuda:0").sizes == (1, 8, 32)
    assert default_buckets("cpu").sizes == (1, 2, 4, 8)


def test_pad_batch():
    rows = [np.full((2, 3), i, np.float32) for i in range(3)]
    out = pad_batch(rows, 4)
    assert out.shape == (4, 2, 3) and out.dtype == np.float32
    assert (out[:3, 0, 0] == [0, 1, 2]).all() and (out[3] == 0).all()
    assert pad_batch(rows, 3).shape == (3, 2, 3)
    with pytest.raises(ValueError):
        pad_batch(rows, 2)
    with pytest.raises(ValueError):
        pad_batch([], 2)


def test_error_statuses():
    assert QueueFullError.http_status == 503
    assert ShedError.http_status == 503
    assert EngineClosedError.http_status == 503
    assert DeadlineExceededError.http_status == 504
    assert RequestError.http_status == 400
    half = AdmissionController(AdmissionPolicy(max_queue=10))
    assert [half.under_pressure(d) for d in (0, 4, 5, 9)] == [False, False,
                                                              True, True]
    one = AdmissionController(AdmissionPolicy(max_queue=1))
    assert [one.under_pressure(d) for d in (0, 1)] == [False, True]


def _wait_for(pred, timeout_s: float = 30.0) -> None:
    end = time.monotonic() + timeout_s
    while not pred():
        assert time.monotonic() < end, "condition not reached in time"
        time.sleep(0.01)


def test_queue_full_is_503_and_deadline_is_504():
    """A forward held on a gate keeps one batch in flight; the next request
    waits in the queue until its deadline (504), and with the one-slot
    queue occupied a third is refused (503)."""
    gate, entered = threading.Event(), threading.Event()

    def gated(batch: np.ndarray) -> torch.Tensor:
        entered.set()
        gate.wait(timeout=60)
        return torch.from_numpy(batch.reshape(batch.shape[0], -1)[:, :4])

    engine = InferenceEngine(
        gated, item_shape=(2, 2), buckets=BucketTable((1,)), max_delay_ms=0,
        policy=AdmissionPolicy(max_queue=1, default_timeout_s=30.0))
    server = ServingServer(engine, port=0)
    gate.set()  # the warmup forward passes the gate
    server.start()
    gate.clear()
    entered.clear()
    pool = ThreadPoolExecutor(2)
    try:
        image = np.ones((2, 2), np.float32).tolist()
        first = pool.submit(_post, server.port, {"image": image})
        assert entered.wait(timeout=30)
        second = pool.submit(_post, server.port,
                             {"image": image, "timeout_s": 0.3})
        _wait_for(lambda: engine.metrics.count("requests_total") == 2)
        status, body = second.result(timeout=30)
        assert status == 504 and body["error"] == "deadline_exceeded"
        # the expired request still holds the one queue slot
        status, body = _post(server.port, {"image": image})
        assert status == 503 and body["error"] == "queue_full"
        gate.set()
        status, body = first.result(timeout=30)
        assert status == 200 and body["features"] == [1.0, 1.0, 1.0, 1.0]
        _wait_for(lambda: engine.metrics.count("cancelled_total") == 1)
    finally:
        gate.set()
        pool.shutdown(wait=True)
        server.stop()
    assert engine.metrics.count("rejected_total") == 1
    assert engine.metrics.count("timeouts_total") == 1
