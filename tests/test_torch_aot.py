"""The AOT artifact store of the port (`jimm_tpu_torch/aot/`), held to the
JAX package's: JAX's ``TestKeys`` and ``TestStore`` on the port's copies
(with the port's own golden digest), either package's store read by the
other, and JAX's ``TestWarmStartE2E`` on tiny SigLIP, CLIP and ViT models
whose exported programs are loaded against live models with JAX's weights
and held to JAX's forwards (1e-5; 1e-4 for wide plans, JAX's own), the
exported graphs' call targets, and the ``aot`` command against JAX's."""

import asyncio
import io
import json
import re
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from flax import nnx

from jimm_tpu import cli as jax_cli
from jimm_tpu import preset as jax_preset
from jimm_tpu.aot import ArtifactStore as JaxStore
from jimm_tpu.aot.cli import main as jax_aot_main
from jimm_tpu.models.clip import CLIP as JaxCLIP
from jimm_tpu.models.siglip import SigLIP as JaxSigLIP
from jimm_tpu.models.vit import VisionTransformer as JaxViT
from jimm_tpu.serve import build_replica_forwards as jax_build_forwards
from jimm_tpu.serve import plan_topology as jax_plan
from jimm_tpu_torch import cli
from jimm_tpu_torch.__main__ import main as port_main
from jimm_tpu_torch.aot import (AOT_FORMAT_VERSION, ArtifactStore,
                                canonical_json, config_hash,
                                donation_signature, serve_forward_key)
from jimm_tpu_torch.aot.export import export_program, serialize_serve_forward
from jimm_tpu_torch.aot.warmup import (AotForward, aot_metrics,
                                       warmup_naflex, warmup_store)
from jimm_tpu_torch.models.common import load_jax_params
from jimm_tpu_torch.ops import layer_norm as ln_ops
from jimm_tpu_torch.serve import (BucketTable, InferenceEngine,
                                  build_replica_forwards, plan_topology,
                                  replica_trace_count)
from test_torch_siglip import jax_params

REPO_ROOT = str(__import__("pathlib").Path(__file__).resolve().parent.parent)
CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-5)
WIDE_TOL = dict(rtol=1e-4, atol=1e-4)
BUCKETS = (1, 2)
ITEM = (32, 32, 3)

# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------

#: one fully pinned key, shared by the golden and the subprocess tests
GOLDEN_KEY_KWARGS = dict(
    method="encode_image", bucket=4, item_shape=(32, 32, 3),
    in_dtype="float32", param_dtype="float32", mesh={"data": 8},
    position=0, backend="cpu", torch_version="0.0-test",
    cuda_version="cpu", op_schemas="0" * 64)
GOLDEN_CONFIG = {"family": "clip",
                 "vision": {"width": 64, "depth": 2, "image_size": 32}}
GOLDEN_FP = "d2209f873932cf25fcc92d0c5e0f645baa58088723e26b3e74b7df8be0b04dad"


def golden_key():
    return serve_forward_key(GOLDEN_CONFIG, donation=donation_signature(),
                             **GOLDEN_KEY_KWARGS)


class TestKeys:
    def test_canonical_json_is_order_insensitive(self):
        a = canonical_json({"b": 1, "a": {"y": 2, "x": (3, 4)}})
        b = canonical_json({"a": {"x": [3, 4], "y": 2}, "b": 1})
        assert a == b == '{"a":{"x":[3,4],"y":2},"b":1}'

    def test_config_hash_ignores_key_order_not_values(self):
        assert config_hash({"w": 64, "d": 2}) == config_hash({"d": 2, "w": 64})
        assert config_hash({"w": 64}) != config_hash({"w": 65})
        # the two packages hash one config alike
        from jimm_tpu.aot import config_hash as jax_config_hash
        assert config_hash(GOLDEN_CONFIG) == jax_config_hash(GOLDEN_CONFIG)

    def test_golden_fingerprint(self):
        # byte stability: this digest may change only with a deliberate
        # AOT_FORMAT_VERSION bump (which invalidates stores)
        assert golden_key().fingerprint() == GOLDEN_FP

    def test_fingerprint_stable_across_processes_without_torch(self):
        code = (
            "import sys\n"
            "from jimm_tpu_torch.aot import serve_forward_key, "
            "donation_signature\n"
            f"key = serve_forward_key({GOLDEN_CONFIG!r}, "
            f"donation=donation_signature(), **{GOLDEN_KEY_KWARGS!r})\n"
            "print(key.fingerprint())\n"
            "print('torch' in sys.modules)\n")
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                             capture_output=True, text=True, check=True)
        assert out.stdout.split() == [GOLDEN_FP, "False"]

    def test_every_field_changes_the_fingerprint(self):
        base = golden_key().fingerprint()
        for change in (dict(bucket=8), dict(method="forward"),
                       dict(item_shape=(64, 64, 3)), dict(in_dtype="bfloat16"),
                       dict(param_dtype="bfloat16"), dict(mesh={"data": 4}),
                       dict(position=1), dict(backend="cuda:sm_90"),
                       dict(torch_version="9.9"), dict(cuda_version="12.8"),
                       dict(op_schemas="1" * 64)):
            kw = {**GOLDEN_KEY_KWARGS, **change}
            other = serve_forward_key(GOLDEN_CONFIG,
                                      donation=donation_signature(), **kw)
            assert other.fingerprint() != base, change
        assert serve_forward_key(
            GOLDEN_CONFIG, donation=donation_signature(donate_argnums=(0,)),
            **GOLDEN_KEY_KWARGS).fingerprint() != base

    def test_mesh_object_and_dict_agree(self):
        class FakeMesh:
            shape = {"data": 8}

        class LocalLike:  # the port's in-process meshes
            mesh_dim_names = ("data",)
            mesh = torch.zeros(8)

        rest = {k: v for k, v in GOLDEN_KEY_KWARGS.items() if k != "mesh"}
        for mesh in (FakeMesh(), LocalLike()):
            key = serve_forward_key(GOLDEN_CONFIG, mesh=mesh,
                                    donation=donation_signature(), **rest)
            assert key.fingerprint() == GOLDEN_FP


# ---------------------------------------------------------------------------
# store (JAX's TestStore on the port's copy), and either package's store
# read by the other
# ---------------------------------------------------------------------------

class TestStore:
    def test_put_get_roundtrip(self, tmp_path):
        store = ArtifactStore(tmp_path / "s")
        fp = "ab" + "0" * 62
        store.put(fp, b"payload-bytes", meta={"label": "t", "bucket": 1})
        assert store.contains(fp)
        assert store.get(fp) == b"payload-bytes"
        [entry] = store.entries()
        assert entry.fingerprint == fp
        assert entry.meta["label"] == "t"
        assert entry.meta["format_version"] == AOT_FORMAT_VERSION

    def test_get_miss_returns_none(self, tmp_path):
        store = ArtifactStore(tmp_path / "s")
        assert store.get("cd" + "0" * 62) is None

    def test_corrupt_payload_quarantined(self, tmp_path):
        store = ArtifactStore(tmp_path / "s")
        fp = "ab" + "1" * 62
        store.put(fp, b"good-bytes")
        (store.entry_dir(fp) / "artifact.bin").write_bytes(b"bit-rotted!")
        assert store.get(fp) is None
        assert not store.contains(fp)
        [q] = list(store.quarantine_dir.iterdir())
        assert "sha256 mismatch" in (q / "reason.txt").read_text()

    def test_format_version_mismatch_quarantined(self, tmp_path):
        store = ArtifactStore(tmp_path / "s")
        fp = "ab" + "2" * 62
        store.put(fp, b"old-format")
        meta_path = store.entry_dir(fp) / "meta.json"
        meta = json.loads(meta_path.read_text())
        meta["format_version"] = AOT_FORMAT_VERSION + 1
        meta_path.write_text(json.dumps(meta))
        assert store.get(fp) is None
        assert not store.contains(fp)

    def test_torch_version_mismatch_quarantined(self, tmp_path):
        store = ArtifactStore(tmp_path / "s")
        fp = "ab" + "3" * 62
        store.put(fp, b"other-torch", meta={"torch": "0.1-old"})
        assert store.get(fp, expect_versions={"torch": "2.9-new"}) is None
        assert not store.contains(fp)
        [q] = list(store.quarantine_dir.iterdir())
        assert "torch mismatch" in (q / "reason.txt").read_text()
        store.put(fp, b"re-exported", meta={"torch": "2.9-new"})
        assert store.get(fp, expect_versions={"torch": "2.9-new"}) \
            == b"re-exported"

    def test_lru_eviction_by_size_cap(self, tmp_path):
        import os
        import time
        store = ArtifactStore(tmp_path / "s", max_bytes=250)
        fps = [f"{i:02x}" + str(i) * 62 for i in range(3)]
        now = time.time()
        for i, fp in enumerate(fps):
            store.put(fp, bytes(100))
            os.utime(store.entry_dir(fp) / "artifact.bin",
                     (now - 100 + i, now - 100 + i))
        assert not store.contains(fps[0])
        assert store.contains(fps[1]) and store.contains(fps[2])
        store.get(fps[1])
        fp3 = "ff" + "9" * 62
        store.put(fp3, bytes(100))
        assert store.contains(fps[1])
        assert not store.contains(fps[2])

    def test_verify_quarantines_bad_entries(self, tmp_path):
        store = ArtifactStore(tmp_path / "s")
        good, bad = "aa" + "0" * 62, "bb" + "0" * 62
        store.put(good, b"fine")
        store.put(bad, b"fine-too")
        (store.entry_dir(bad) / "artifact.bin").write_bytes(b"flipped")
        problems = store.verify()
        assert [p["fingerprint"] for p in problems] == [bad]
        assert store.contains(good) and not store.contains(bad)
        assert store.verify() == []


@pytest.mark.parametrize("writer,reader", [(JaxStore, ArtifactStore),
                                           (ArtifactStore, JaxStore)],
                         ids=["jax-to-port", "port-to-jax"])
def test_each_package_reads_the_others_store(tmp_path, writer, reader):
    fp = "cd" + "5" * 62
    writer(tmp_path).put(fp, b"shared-bytes", meta={"label": "x",
                                                    "bucket": 2})
    store = reader(tmp_path)
    assert store.get(fp) == b"shared-bytes"
    [entry] = store.entries()
    assert entry.meta["label"] == "x" and entry.meta["bucket"] == 2
    assert entry.meta["format_version"] == AOT_FORMAT_VERSION
    assert store.verify() == []


# ---------------------------------------------------------------------------
# warm start end to end: tiny models with JAX's weights
# ---------------------------------------------------------------------------

FAMILIES = {"siglip": ("siglip-base-patch16-256", JaxSigLIP, "encode_image"),
            "clip": ("clip-vit-base-patch16", JaxCLIP, "encode_image"),
            "vit": ("vit-base-patch16-224", JaxViT, "__call__")}


def port_model(name: str, dtype: str = "f32", **tiny) -> torch.nn.Module:
    """A tiny model of the preset ``name`` through the kernels' ops (the
    fused LayerNorm and flash attention)."""
    cfg = cli.tiny_override(cli.preset(name))
    if tiny:
        cfg = cli.dataclasses.replace(
            cfg, vision=cli.dataclasses.replace(cfg.vision, **tiny))
    cfg = cli.with_runtime(cfg, ln_impl="fused", attn_impl="flash")
    return cli.serving_model(cfg, dtype, CPU,
                             generator=torch.Generator().manual_seed(0))[0]


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request, tmp_path_factory):
    """One tiny model per family in both packages with the same weights,
    and a store warmed with its buckets."""
    name, jax_cls, jax_method = FAMILIES[request.param]
    jmodel = jax_cls(jax_cli._tiny_override(jax_preset(name)),
                     rngs=nnx.Rngs(0))
    model = port_model(name)
    load_jax_params(model, jax_params(jmodel))
    store = ArtifactStore(tmp_path_factory.mktemp(f"aot-{request.param}"))
    method = cli.SERVED_METHOD[request.param]
    report = warmup_store(model, method=method, buckets=BUCKETS,
                          item_shape=ITEM, store=store, label="test")
    assert {b: r["action"] for b, r in report.items()} == \
        {1: "compiled", 2: "compiled"}
    images = np.random.default_rng(0).standard_normal(
        (2, *ITEM)).astype(np.float32)
    return {"name": request.param, "jax": jmodel, "jax_method": jax_method,
            "model": model, "method": method, "store": store,
            "images": images}


def make_forward(fam, store=None):
    return AotForward(fam["model"], method=fam["method"], item_shape=ITEM,
                      store=store or fam["store"], label="test")


def jax_forward(fam, images):
    out = getattr(fam["jax"], fam["jax_method"])(images)
    return np.asarray(out)


def counter_values():
    return {name: c.value for name, c in
            zip(("hit", "miss", "fallback"), aot_metrics())}


def _engine(forward):
    return InferenceEngine(forward, item_shape=ITEM,
                           buckets=BucketTable(BUCKETS),
                           trace_count=forward.trace_count)


def copied_store(fam, tmp_path) -> ArtifactStore:
    store = ArtifactStore(tmp_path / "copy")
    shutil.copytree(fam["store"].root / "objects", store.root / "objects",
                    dirs_exist_ok=True)
    return store


class TestWarmStartE2E:
    def test_populated_store_serves_every_bucket_from_aot(self, family):
        before = counter_values()
        forward = make_forward(family)
        engine = _engine(forward)
        engine.warmup_blocking()
        assert forward.trace_count() == 0
        assert engine.metrics.snapshot()["compile_count"] == 0
        assert {b: r["source"] for b, r in engine.warmup_report.items()} \
            == {1: "aot", 2: "aot"}
        after = counter_values()
        assert after["hit"] - before["hit"] == len(BUCKETS)
        assert after["fallback"] == before["fallback"]

    def test_loaded_forward_matches_jax(self, family):
        forward = make_forward(family)
        for b in BUCKETS:
            assert forward.prepare_bucket(b) == "aot"
        images = family["images"]
        got = forward(images).numpy()
        np.testing.assert_allclose(got, jax_forward(family, images), **TOL)
        assert forward.trace_count() == 0

    def test_corrupt_store_falls_back_and_still_serves(self, family,
                                                       tmp_path):
        store = copied_store(family, tmp_path)
        for entry in store.entries():
            (entry.path / "artifact.bin").write_bytes(b"garbage")
        before = counter_values()
        forward = make_forward(family, store)
        engine = _engine(forward)
        engine.warmup_blocking()
        assert {v["source"] for v in engine.warmup_report.values()} \
            == {"fallback"}
        assert counter_values()["fallback"] - before["fallback"] \
            == len(BUCKETS)
        assert forward.trace_count() == len(BUCKETS)
        assert len(list(store.quarantine_dir.iterdir())) == len(BUCKETS)

        async def roundtrip():
            await engine.start()
            try:
                return await engine.submit(family["images"][0])
            finally:
                await engine.stop()

        got = asyncio.run(roundtrip())
        np.testing.assert_allclose(
            got, jax_forward(family, family["images"][:1])[0], **TOL)

    def test_version_drift_falls_back_without_error(self, family, tmp_path):
        store = copied_store(family, tmp_path)
        for entry in store.entries():
            meta = dict(entry.meta, torch="0.0.1-ancient")
            (entry.path / "meta.json").write_text(json.dumps(meta))
        before = counter_values()
        forward = make_forward(family, store)
        assert forward.prepare_bucket(1) == "fallback"
        assert counter_values()["fallback"] - before["fallback"] == 1
        assert not store.contains(forward.key_for(1).fingerprint())
        assert any(store.quarantine_dir.iterdir())
        images = family["images"][:1]
        np.testing.assert_allclose(forward(images).numpy(),
                                   jax_forward(family, images), **TOL)
        assert forward.trace_count() == 1

    def test_a_program_that_raises_is_quarantined_and_served_fresh(
            self, family, tmp_path):
        store = copied_store(family, tmp_path)
        forward = make_forward(family, store)
        assert forward.prepare_bucket(1) == "aot"

        def broken(x):
            raise RuntimeError("bad program")

        forward._loaded[1] = broken
        before = counter_values()
        images = family["images"][:1]
        np.testing.assert_allclose(forward(images).numpy(),
                                   jax_forward(family, images), **TOL)
        assert forward.sources[1] == "fallback"
        assert counter_values()["fallback"] - before["fallback"] == 1
        assert not store.contains(forward.key_for(1).fingerprint())


def test_write_through_warms_a_second_process(tmp_path):
    """A miss exports and writes through; another process, over the same
    store, then loads every bucket."""
    store = ArtifactStore(tmp_path / "wt")
    model = port_model("clip-vit-base-patch16")
    forward = AotForward(model, method="encode_image", item_shape=ITEM,
                         store=store)
    assert forward.prepare_bucket(1) == "miss"
    assert len(store.entries()) == 1
    code = (
        "import torch\n"
        "from test_torch_aot import port_model, ITEM\n"
        "from jimm_tpu_torch.aot import ArtifactStore\n"
        "from jimm_tpu_torch.aot.warmup import AotForward\n"
        "m = port_model('clip-vit-base-patch16')\n"
        f"f = AotForward(m, method='encode_image', item_shape=ITEM, "
        f"store=ArtifactStore({str(store.root)!r}))\n"
        "print(f.prepare_bucket(1), f.trace_count())\n")
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True,
        text=True, timeout=300,
        env={**__import__("os").environ,
             "PYTHONPATH": f"{REPO_ROOT}/tests:{REPO_ROOT}"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[-2:] == ["aot", "0"]


# ---------------------------------------------------------------------------
# the exported graph
# ---------------------------------------------------------------------------

def _graph(payload: bytes):
    return torch.export.load(io.BytesIO(payload)).graph


def _targets(graph) -> set[str]:
    return {str(n.target) for n in graph.nodes if n.op == "call_function"}


@pytest.mark.parametrize("dtype,ops", [
    ("f32", {"jimm.layer_norm_fwd.default", "jimm.flash_fwd.default"}),
    ("int8", {"jimm.layer_norm_fwd.default", "jimm.flash_fwd.default",
              "jimm.int8_matmul.default"})])
def test_the_graph_names_the_kernels_ops_and_no_device(dtype, ops):
    model = port_model("siglip-base-patch16-256", dtype)
    graph = _graph(serialize_serve_forward(model, "encode_image", 2, ITEM))
    targets = _targets(graph)
    assert ops <= targets, targets
    jimm = {t for t in targets if t.startswith("jimm.")}
    assert jimm == ops
    for node in graph.nodes:
        assert "device" not in node.kwargs, node.format_node()
        assert not any(isinstance(a, torch.device) for a in node.args)


def test_the_payload_holds_no_weights():
    """A program's size does not follow the width of the weights: they are
    call arguments."""
    sizes, weights = [], []
    for width in (64, 256):
        model = port_model("siglip-base-patch16-256", width=width,
                           mlp_dim=2 * width)
        sizes.append(len(serialize_serve_forward(model, "encode_image", 1,
                                                 ITEM)))
        weights.append(sum(p.numel() * p.element_size()
                           for p in model.parameters()))
    assert weights[1] > 8 * weights[0]
    assert sizes[1] < 1.05 * sizes[0], sizes
    assert sizes[1] < weights[1] / 4


def test_export_runs_the_fakes_and_never_the_kernels(monkeypatch):
    """The exporter traces each op through its fake: the wrapper (which
    would launch the kernel on a card) is never called on a fake tensor."""
    calls = []

    def refuse(*args, **kwargs):
        calls.append(args)
        raise AssertionError("the wrapper ran under the exporter")

    monkeypatch.setattr(ln_ops, "_fwd", refuse)
    model = port_model("siglip-base-patch16-256")
    x = torch.zeros((1, *ITEM))
    ep = export_program(model, "encode_image", (x,))
    assert "jimm.layer_norm_fwd.default" in _targets(ep.graph)
    assert calls == []


# ---------------------------------------------------------------------------
# NaFlex: one program per (batch, seq) bucket pair
# ---------------------------------------------------------------------------

def test_warmup_naflex_exports_one_program_per_bucket_pair():
    from jimm_tpu_torch.configs import SigLIPConfig, TextConfig, VisionConfig
    cfg = SigLIPConfig(
        vision=VisionConfig(image_size=16, patch_size=8, width=32, depth=2,
                            num_heads=2, mlp_dim=64, act="gelu_tanh",
                            pooling="map", attn_impl="flash",
                            ln_impl="fused"),
        text=TextConfig(vocab_size=64, context_length=8, width=32, depth=2,
                        num_heads=2, mlp_dim=64, act="gelu_tanh",
                        causal=False, pooling="last", proj_bias=True),
        projection_dim=32)
    model = cli.MODELS["siglip"](cfg, device=CPU,
                                 generator=torch.Generator().manual_seed(0))
    report = warmup_naflex(model, batch_buckets=(1, 2), seq_buckets=(8,))
    assert set(report) == {(1, 8), (2, 8)}
    assert all(r["traces"] == 1 and r["seconds"] >= 0
               for r in report.values())
    # a mask of other contents reuses the pair's program
    g = torch.Generator().manual_seed(1)
    patches = torch.randn(2, 8, 8 * 8 * 3, generator=g)
    shapes = torch.tensor([[2, 2], [1, 3]], dtype=torch.int32)
    mask = torch.zeros(2, 8, dtype=torch.bool)
    mask[0, :4] = True
    mask[1, :3] = True
    program = report[(2, 8)]["program"]
    with torch.inference_mode():
        got = program(patches, shapes, mask)
        want = model.encode_image_naflex(patches, shapes, mask)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert "jimm.flash_fwd.default" in _targets(
        _graph(_naflex_payload(model)))


def _naflex_payload(model) -> bytes:
    from jimm_tpu_torch.aot.export import save_program
    patches = torch.zeros(1, 8, 8 * 8 * 3)
    shapes = torch.full((1, 2), 2, dtype=torch.int32)
    mask = torch.ones(1, 8, dtype=torch.bool)
    return save_program(export_program(model, "encode_image_naflex",
                                       (patches, shapes, mask)))


# ---------------------------------------------------------------------------
# wide replicas: one program per position, collectives as ops
# ---------------------------------------------------------------------------

WIDE_PLANS = [(1, 2, 1), (1, 1, 2)]


@pytest.fixture(scope="module")
def wide():
    """The tiny SigLIP in both packages (attention "auto": a sharded
    sequence takes the ring), the same weights, and JAX's forward."""
    name = "siglip-base-patch16-256"
    jmodel = JaxSigLIP(jax_cli._tiny_override(jax_preset(name)),
                       rngs=nnx.Rngs(0))
    cfg = cli.with_runtime(cli.tiny_override(cli.preset(name)),
                           ln_impl="fused")
    model, _ = cli.serving_model(cfg, "f32", CPU)
    load_jax_params(model, jax_params(jmodel))
    images = np.random.default_rng(1).standard_normal(
        (2, *ITEM)).astype(np.float32)
    return {"jax": jmodel, "model": model, "images": images}


def _jax_wide(wide, split):
    n = split[0] * split[1] * split[2]
    jforwards, _ = jax_build_forwards(
        wide["jax"], jax_plan(*split, devices=jax.devices()[:n]),
        method="encode_image", item_shape=ITEM)
    return np.asarray(jforwards[0](wide["images"]))


def _wide_engine(wide, split, store):
    n = split[0] * split[1] * split[2]
    forwards = build_replica_forwards(
        wide["model"], plan_topology(*split, devices=[CPU] * n),
        method="encode_image", store=store, label="wide")
    engine = InferenceEngine(forwards, item_shape=ITEM,
                             buckets=BucketTable((2,)),
                             trace_count=replica_trace_count(forwards))
    engine.warmup_blocking()
    return forwards, engine


@pytest.mark.parametrize("split", WIDE_PLANS,
                         ids=lambda s: "x".join(map(str, s)))
def test_wide_plan_programs_match_jax(wide, split, tmp_path):
    store = ArtifactStore(tmp_path / "wide")
    _wide_engine(wide, split, store)  # writes every position's program
    n = split[1] * split[2]
    assert len(store.entries()) == n
    assert sorted(e.meta["position"] for e in store.entries()) == \
        list(range(n))
    forwards, engine = _wide_engine(wide, split, store)
    assert engine.warmup_report[2]["source"] == "aot"
    assert engine.metrics.snapshot()["compile_count"] == 0
    fwd = forwards[0]
    got = fwd.to_host(fwd(wide["images"]))
    np.testing.assert_allclose(got, _jax_wide(wide, split), **WIDE_TOL)
    local = {t for e in store.entries()
             for t in _targets(_graph((e.path / "artifact.bin").read_bytes()))
             if t.startswith("jimm.local_")}
    assert local, "no collective in the position programs"


def test_dropping_the_collectives_from_the_graph_breaks_the_match(
        wide, tmp_path):
    """Every exchange between positions is a node of the program: a
    program with its ``jimm::local_sum`` nodes replaced by their input no
    longer matches JAX."""
    from jimm_tpu_torch.aot.export import save_program
    store = ArtifactStore(tmp_path / "cut")
    _wide_engine(wide, (1, 2, 1), store)
    for entry in store.entries():
        ep = torch.export.load(io.BytesIO(
            (entry.path / "artifact.bin").read_bytes()))
        graph = ep.graph_module.graph
        cut = 0
        for node in list(graph.nodes):
            if str(node.target) == "jimm.local_sum.default":
                node.replace_all_uses_with(node.args[0])
                graph.erase_node(node)
                cut += 1
        assert cut > 0
        ep.graph_module.recompile()
        meta = {k: v for k, v in entry.meta.items()
                if k not in ("sha256", "size", "created", "fingerprint")}
        store.put(entry.fingerprint, save_program(ep), meta=meta)
    forwards, engine = _wide_engine(wide, (1, 2, 1), store)
    assert engine.warmup_report[2]["source"] == "aot"
    got = forwards[0].to_host(forwards[0](wide["images"]))
    assert not np.allclose(got, _jax_wide(wide, (1, 2, 1)), **WIDE_TOL)


# ---------------------------------------------------------------------------
# the aot command against JAX's
# ---------------------------------------------------------------------------

def _strip_versions(text: str) -> str:
    return re.sub(r"\s+(jax|torch)=\S+", "", text)


def _rows(text: str) -> list[dict]:
    rows = json.loads(text)
    for row in rows:
        row.pop("jax", None)
        row.pop("torch", None)
    return rows


def test_aot_commands_print_what_jax_prints(tmp_path, capsys):
    root = str(tmp_path / "s")
    store = ArtifactStore(root)
    for i in range(3):
        store.put(f"{i:02x}" + "e" * 62, bytes(100 * (i + 1)),
                  meta={"label": f"m{i}", "bucket": i + 1})
    for verb in (["ls"], ["ls", "--json"]):
        assert port_main(["aot", *verb, "--store", root]) == 0
        ours = capsys.readouterr().out
        assert jax_aot_main(["aot", *verb, "--store", root]) == 0
        theirs = capsys.readouterr().out
        if "--json" in verb:
            assert _rows(ours) == _rows(theirs)
        else:
            assert _strip_versions(ours) == _strip_versions(theirs)
    (store.entry_dir("00" + "e" * 62) / "artifact.bin").write_bytes(b"x")
    assert port_main(["aot", "verify", "--store", root]) == 1
    ours = json.loads(capsys.readouterr().out)
    assert ours["entries"] == 2 and len(ours["problems"]) == 1
    assert jax_aot_main(["aot", "verify", "--store", root]) == 0
    assert json.loads(capsys.readouterr().out) == {"entries": 2,
                                                  "problems": []}
    for main in (port_main, jax_aot_main):
        assert main(["aot", "gc", "--store", root, "--max-bytes",
                     "350"]) == 0
    ours, theirs = [json.loads(line) for line in
                    capsys.readouterr().out.splitlines()]
    assert ours["cap_bytes"] == theirs["cap_bytes"] == 350
    assert ours["remaining_bytes"] == 300
    assert theirs == {"evicted": [], "remaining_bytes": 300,
                      "cap_bytes": 350}


def test_aot_warmup_prints_what_jax_prints(tmp_path, capsys):
    args = ["warmup", "--preset", "clip-vit-base-patch16", "--tiny",
            "--buckets", "1"]
    assert port_main(["aot", *args, "--store", str(tmp_path / "port"),
                      "--device", "cpu"]) == 0
    ours = json.loads(capsys.readouterr().out)
    assert jax_aot_main(["aot", *args,
                         "--store", str(tmp_path / "jax")]) == 0
    theirs = json.loads(capsys.readouterr().out)
    for report in (ours, theirs):
        report.pop("store")
        for row in report["buckets"].values():
            assert row.pop("seconds") >= 0
            assert row.pop("bytes") > 0
            assert len(row.pop("fingerprint")) == 64
    assert ours == theirs
    assert ours["buckets"] == {"1": {"action": "compiled"}}
    # again: the entry is kept, as JAX keeps it
    assert port_main(["aot", *args, "--store", str(tmp_path / "port"),
                      "--device", "cpu"]) == 0
    again = json.loads(capsys.readouterr().out)
    assert again["buckets"]["1"]["action"] == "kept"
