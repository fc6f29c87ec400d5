"""Serving replicas wider than one device, on the CPU, held to the JAX
package: the planner's ``seq`` axis against JAX's ``TestTopologySeqAxis``
and its meshes, the in-process collectives against their definitions
(bit-equal across positions), tiny SigLIP, CLIP and ViT replicas over
``(R, k, s)`` plans against JAX's ``build_replica_forwards`` on its
virtual CPU devices with the same weights (JAX's own 1e-4), int8 under
``--seq-parallel``, the CLI's refusals against the JAX CLI's, a failing
position that never hangs the server, and a live replan between a wide and
a narrow plan with requests in flight."""

import asyncio
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch
from flax import nnx

from jimm_tpu import cli as jax_cli
from jimm_tpu import preset as jax_preset
from jimm_tpu.models.clip import CLIP as JaxCLIP
from jimm_tpu.models.siglip import SigLIP as JaxSigLIP
from jimm_tpu.models.vit import VisionTransformer as JaxViT
from jimm_tpu.quant import quantize_model as jax_quantize_model
from jimm_tpu.serve import build_replica_forwards as jax_build_forwards
from jimm_tpu.serve import plan_topology as jax_plan
from jimm_tpu_torch import cli
from jimm_tpu_torch.models.common import load_jax_params
from jimm_tpu_torch.parallel import comm
from jimm_tpu_torch.parallel.local import LocalMesh, RendezvousError
from jimm_tpu_torch.parallel.sharding import use_sharding
from jimm_tpu_torch.quant import quantize_model
from jimm_tpu_torch.serve import (AdmissionPolicy, BucketTable,
                                  InferenceEngine, ServeClient,
                                  ServeClientError, ServingServer,
                                  ShardedReplicaForward,
                                  build_replica_forwards, plan_topology)
from jimm_tpu_torch.serve import topology
from test_torch_siglip import jax_params

TOL = dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")
#: the plans of the JAX parity cases: (replicas, model, seq)
PLANS = [(2, 2, 1), (1, 1, 2), (1, 2, 2), (2, 1, 2)]
FAMILIES = {"siglip": ("siglip-base-patch16-256", JaxSigLIP, "encode_image"),
            "clip": ("clip-vit-base-patch16", JaxCLIP, "encode_image"),
            "vit": ("vit-base-patch16-224", JaxViT, "__call__")}


def _jax_devices(n):
    devs = jax.devices()
    assert len(devs) >= n, "tests/conftest.py forces 8 CPU devices"
    return devs[:n]


# -- the planner's seq axis (JAX's TestTopologySeqAxis) -----------------------

def _mesh_shape(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


@pytest.mark.parametrize("split", [(2, 1, 4), (2, 2, 1), (2, 2, 2),
                                   (1, 1, 2), (1, 2, 2), (1, 1, 1)])
def test_meshes_match_jax(split):
    want = jax_plan(*split, devices=_jax_devices(8))
    got = plan_topology(*split, devices=[CPU] * 8)
    assert got.describe() == want.describe()
    assert [_mesh_shape(m) for m in got.meshes()] == \
        [dict(m.shape) for m in want.meshes()]
    assert all(m.devices == (CPU,) * (split[1] * split[2])
               for m in got.meshes())


def test_seq1_collapses_to_the_two_axis_plan():
    legacy = plan_topology(2, 2, devices=[CPU] * 8)
    degenerate = plan_topology(2, 2, 1, devices=[CPU] * 8)
    assert degenerate == legacy
    assert all("seq" not in m.mesh_dim_names for m in degenerate.meshes())
    assert not plan_topology(1, 1, 2, devices=[CPU] * 2).is_trivial
    assert plan_topology(devices=[CPU]).seq_parallel == 1


def test_infeasible_seq_plan_enumerates_splits():
    with pytest.raises(ValueError) as e:
        plan_topology(3, 3, 1, devices=[CPU] * 8)
    msg = str(e.value)
    for split in ("data=2 model=2 seq=2", "data=1 model=1 seq=8",
                  "data=8 model=1 seq=1"):
        assert split in msg


# -- the in-process collectives -----------------------------------------------

def _positions(mesh: LocalMesh, fn):
    """``fn(view)`` on one thread per position of ``mesh``, each under its
    ``use_sharding``; the results in position order."""
    def run(p):
        with use_sharding(mesh.shard(p), "tp"):
            return fn(mesh.shard(p))

    with ThreadPoolExecutor(mesh.size) as pool:
        return [f.result(timeout=60) for f in
                [pool.submit(run, p) for p in range(mesh.size)]]


def _inputs(n, *shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(*shape, generator=g) for _ in range(n)]


@pytest.mark.parametrize("n", [2, 4])
def test_collectives_match_their_definitions(n):
    mesh = LocalMesh({"data": 1, "model": n}, [CPU] * n, timeout_s=30)
    xs = _inputs(n, 3, 2 * n, 5)

    def each(view):
        me = view.position
        grp = comm.axis_group("model")
        x = xs[me]
        return {"psum": comm.psum(x, "model"),
                "gather": comm.all_gather(x, "model", dim=1),
                "a2a": comm.all_to_all(x, "model", 1, 0),
                "ring": comm.ppermute(x, "model", comm.ring_perm(n)),
                "partial": comm.ppermute(x, "model", [(0, 1)]),
                "index": grp.index, "ranks": grp.ranks}

    outs = _positions(mesh, each)
    total = xs[0].clone()
    for x in xs[1:]:
        total += x
    for p, out in enumerate(outs):
        assert out["index"] == p and out["ranks"] == tuple(range(n))
        assert torch.equal(out["psum"], total)
        assert torch.equal(out["gather"], torch.cat(xs, 1))
        assert torch.equal(out["a2a"], torch.cat(
            [x.chunk(n, 1)[p] for x in xs], 0))
        assert torch.equal(out["ring"], xs[(p - 1) % n])
        assert torch.equal(out["partial"],
                           xs[0] if p == 1 else torch.zeros_like(xs[0]))
    # every position holds the same bits
    for key in ("psum", "gather"):
        assert all(torch.equal(o[key], outs[0][key]) for o in outs)


@pytest.mark.parametrize("n", [2, 4])
def test_row_parallel_sum_is_one_rounding_on_every_position(n):
    mesh = LocalMesh({"data": 1, "model": n}, [CPU] * n, timeout_s=30)
    x = torch.randn(4, 8 * n, dtype=torch.bfloat16)
    w = torch.randn(6, 8 * n, dtype=torch.bfloat16)
    b = torch.randn(6, dtype=torch.bfloat16)

    def each(view):
        grp = comm.axis_group("model")
        p = view.position
        return comm.tp_row_linear(x.chunk(n, 1)[p], w.chunk(n, 1)[p], b, grp)

    outs = _positions(mesh, each)
    parts = [x.chunk(n, 1)[p].float() @ w.chunk(n, 1)[p].float().t()
             for p in range(n)]
    total = parts[0].clone()
    for part in parts[1:]:
        total += part
    want = (total + b.float()).to(torch.bfloat16)
    assert all(torch.equal(o, want) for o in outs)


def test_product_axes_and_a_two_axis_mesh():
    """(model=2, seq=2): the rows of each axis, in the mesh's order."""
    mesh = LocalMesh({"data": 1, "model": 2, "seq": 2}, [CPU] * 4,
                     timeout_s=30)

    def each(view):
        return (comm.axis_group("model").ranks, comm.axis_group("seq").ranks,
                comm.axis_group(("model", "seq")).ranks,
                comm.psum(torch.tensor([float(view.position)]), "seq"))

    outs = _positions(mesh, each)
    assert [o[0] for o in outs] == [(0, 2), (1, 3), (0, 2), (1, 3)]
    assert [o[1] for o in outs] == [(0, 1), (0, 1), (2, 3), (2, 3)]
    assert all(o[2] == (0, 1, 2, 3) for o in outs)
    assert [o[3].item() for o in outs] == [1.0, 1.0, 5.0, 5.0]


def test_a_failing_position_aborts_its_peers_at_once():
    mesh = LocalMesh({"data": 1, "model": 2}, [CPU] * 2, timeout_s=60)

    def each(view):
        if view.position == 1:
            mesh.abort()
            raise ValueError("position 1 broke")
        return comm.psum(torch.ones(2), "model")

    t0 = time.monotonic()
    with pytest.raises(RendezvousError, match="a peer failed"):
        _positions(mesh, each)
    assert time.monotonic() - t0 < 10
    mesh.reset()
    outs = _positions(mesh, lambda view: comm.psum(torch.ones(2), "model"))
    assert all(torch.equal(o, torch.full((2,), 2.0)) for o in outs)


def test_a_replica_mixes_no_device_kinds():
    mesh = LocalMesh({"data": 1, "model": 2},
                     [CPU, torch.device("cuda", 0)], timeout_s=1)
    with pytest.raises(ValueError, match="one kind of device"):
        ShardedReplicaForward(torch.nn.Linear(2, 2), mesh, "tp",
                              method="forward")


# -- tiny models against JAX's replicas ---------------------------------------

@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    """One tiny model per family in both packages, the same weights, and
    a batch of images."""
    name, jax_cls, method = FAMILIES[request.param]
    jmodel = jax_cls(jax_cli._tiny_override(jax_preset(name)),
                     rngs=nnx.Rngs(0))
    model, _ = cli.serving_model(cli.tiny_override(cli.preset(name)), "f32",
                                 CPU)
    load_jax_params(model, jax_params(jmodel))
    images = np.random.default_rng(0).standard_normal(
        (3, 32, 32, 3)).astype(np.float32)
    return {"name": request.param, "jax": jmodel, "model": model,
            "jax_method": method,
            "method": cli.SERVED_METHOD[request.param], "images": images}


@pytest.mark.parametrize("split", PLANS, ids=lambda s: "x".join(map(str, s)))
def test_replicas_match_jax(family, split):
    n = split[0] * split[1] * split[2]
    jforwards, _ = jax_build_forwards(
        family["jax"], jax_plan(*split, devices=_jax_devices(n)),
        method=family["jax_method"], item_shape=(32, 32, 3))
    forwards = build_replica_forwards(
        family["model"], plan_topology(*split, devices=[CPU] * n),
        method=family["method"])
    assert len(forwards) == split[0]
    images = family["images"]
    for jfwd, fwd in zip(jforwards, forwards):
        assert isinstance(fwd, ShardedReplicaForward)
        assert len(fwd.models) == split[1] * split[2]
        want = np.asarray(jfwd(images))
        np.testing.assert_allclose(fwd.to_host(fwd(images)), want, **TOL)


def test_sequence_shards_only_where_it_divides(family, monkeypatch):
    """Under seq=2 the tiny SigLIP's 4 patch tokens run on the ring; CLIP's
    and ViT's 5 (with the class token) stay whole, as in JAX."""
    from jimm_tpu_torch.parallel import seqpar
    calls = []
    real = seqpar.seq_parallel_attention

    def spy(*args, **kwargs):
        calls.append(threading.current_thread().name)
        return real(*args, **kwargs)

    monkeypatch.setattr(seqpar, "seq_parallel_attention", spy)
    fwd, = build_replica_forwards(
        family["model"], plan_topology(1, 1, 2, devices=[CPU] * 2),
        method=family["method"])
    fwd(family["images"])
    depth = family["model"].config.vision.depth
    assert len(calls) == (2 * depth if family["name"] == "siglip" else 0)


def test_positions_hold_the_model_sliced(family):
    fwd, = build_replica_forwards(
        family["model"], plan_topology(1, 2, 1, devices=[CPU] * 2),
        method=family["method"])
    whole = dict(family["model"].named_parameters())
    for p, piece in enumerate(fwd.models):
        params = dict(piece.named_parameters())
        q = "vision.encoder.blocks.0.attn.q.weight"
        assert torch.equal(params[q], whole[q].chunk(2, 0)[p])
        fc2 = "vision.encoder.blocks.0.mlp.fc2.weight"
        assert torch.equal(params[fc2], whole[fc2].chunk(2, 1)[p])
        ln = "vision.encoder.blocks.0.ln1.weight"
        assert torch.equal(params[ln], whole[ln])


# -- int8 under --seq-parallel ------------------------------------------------

def _cosines(got, want):
    return (got * want).sum(1) / (np.linalg.norm(got, axis=1)
                                  * np.linalg.norm(want, axis=1))


def test_int8_seq_parallel_matches_jax():
    """``--dtype int8 --seq-parallel 2``: the port's quantized copies on the
    ring, held to JAX's quantized replica at the int8 tolerance (cosine >=
    0.9999, norms within 1%)."""
    name = "siglip-base-patch16-256"
    jmodel = JaxSigLIP(jax_cli._tiny_override(jax_preset(name)),
                       rngs=nnx.Rngs(0))
    model, _ = cli.serving_model(cli.tiny_override(cli.preset(name)), "f32",
                                 CPU)
    load_jax_params(model, jax_params(jmodel))
    # JAX counts a stacked layer of the blocks once, the port each block's
    assert quantize_model(model) == 55 and jax_quantize_model(jmodel) == 19
    images = np.random.default_rng(1).standard_normal(
        (4, 32, 32, 3)).astype(np.float32)
    (jfwd,), _ = jax_build_forwards(jmodel,
                               jax_plan(1, 1, 2, devices=_jax_devices(2)),
                               method="encode_image", item_shape=(32, 32, 3))
    fwd, = build_replica_forwards(model,
                                  plan_topology(1, 1, 2, devices=[CPU] * 2),
                                  method="encode_image")
    want = np.asarray(jfwd(images))
    got = fwd.to_host(fwd(images))
    assert _cosines(got, want).min() >= 0.9999
    norms = np.linalg.norm(got, axis=1) / np.linalg.norm(want, axis=1)
    assert np.abs(norms - 1).max() <= 0.01


def test_serve_int8_seq_parallel():
    """``serve --dtype int8 --seq-parallel 2`` serves (the reference
    refuses int8 only under ``--model-parallel``): the quantized copies on
    the ring answer as the quantized model does on one device."""
    server, model, ready = cli.build_server(cli.build_parser().parse_args(
        ["serve", "--tiny", "--port", "0", "--device", "cpu,cpu",
         "--dtype", "int8", "--seq-parallel", "2", "--buckets", "1"]))
    image = np.random.default_rng(4).standard_normal(
        (32, 32, 3)).astype(np.float32)
    try:
        got = np.asarray(ServeClient(port=server.port).embed(image))
    finally:
        server.stop()
    assert ready["dtype"] == "int8" and ready["quantized_layers"] == 55
    assert ready["topology"]["seq_parallel"] == 2
    with torch.inference_mode():
        want = model.encode_image(torch.from_numpy(image[None]))[0].numpy()
    assert _cosines(got[None], want[None]).min() >= 0.9999


# -- the CLI ------------------------------------------------------------------

def _jax_exit(argv) -> str:
    with pytest.raises(SystemExit) as e:
        jax_cli.main(argv)
    return str(e.value)


def _port_exit(argv) -> str:
    with pytest.raises(SystemExit) as e:
        cli.build_server(cli.build_parser().parse_args(argv))
    return str(e.value)


TINY = ["serve", "--tiny", "--port", "0"]
JAX_TINY = TINY + ["--preset", "siglip-base-patch16-256"]


@pytest.mark.parametrize("extra", [
    ["--dtype", "int8", "--model-parallel", "2"],
    ["--model-parallel", "2", "--pool-model",
     "twin=siglip-base-patch16-256@int8"],
    ["--pool-model", "twin"],
    ["--pool-model", "default=siglip-base-patch16-256"],
    ["--pool-model", "twin=siglip-base-patch16-256@fp8"],
    ["--pool-model", "twin=siglip-base-patch16-256", "--pool-model",
     "twin=siglip-base-patch16-256@bf16"],
], ids=["int8-model", "pool-int8-model", "pool-spec", "pool-default",
        "pool-dtype", "pool-duplicate"])
def test_refusals_are_the_jax_clis(extra):
    devices = ["--device", "cpu,cpu"]
    assert _port_exit(TINY + devices + extra) == _jax_exit(JAX_TINY + extra)


def test_self_heal_takes_a_wide_replica_as_jax_does():
    """JAX refuses ``--self-heal`` on the trivial plan only: one replica
    two devices wide heals."""
    assert _port_exit(TINY + ["--device", "cpu", "--self-heal"]) == \
        _jax_exit(JAX_TINY + ["--self-heal"])
    server, _, ready = cli.build_server(cli.build_parser().parse_args(
        TINY + ["--device", "cpu,cpu", "--model-parallel", "2",
                "--self-heal", "--buckets", "1"]))
    server.stop()
    assert ready["topology"]["model_parallel"] == 2
    assert server.engine._heal is not None


@pytest.fixture(scope="module")
def jax_siglip_2x2():
    """JAX's tiny SigLIP and its (1, 2, 2) replica's answers."""
    jmodel = JaxSigLIP(jax_cli._tiny_override(
        jax_preset("siglip-base-patch16-256")), rngs=nnx.Rngs(0))
    images = np.random.default_rng(2).standard_normal(
        (3, 32, 32, 3)).astype(np.float32)
    out = {"params": jax_params(jmodel), "images": images}
    for split in ((1, 2, 2), (1, 1, 2), (2, 2, 1)):
        n = split[0] * split[1] * split[2]
        forwards, _ = jax_build_forwards(
            jmodel, jax_plan(*split, devices=_jax_devices(n)),
            method="encode_image", item_shape=(32, 32, 3))
        out[split] = np.asarray(forwards[0](images))
    return out


@pytest.mark.parametrize("split", [(1, 2, 2), (1, 1, 2), (2, 2, 1)],
                         ids=lambda s: "x".join(map(str, s)))
def test_serve_answers_as_jax_replicas(jax_siglip_2x2, split, monkeypatch):
    """``python -m jimm_tpu_torch serve --device cpu,cpu,cpu,cpu
    --replicas R --model-parallel k --seq-parallel s`` answers /v1/embed
    within 1e-4 of JAX's ``build_replica_forwards`` on the same weights."""
    original = cli.serving_model

    def with_jax_weights(*args, **kwargs):
        model, n = original(*args, **kwargs)
        load_jax_params(model, jax_siglip_2x2["params"])
        return model, n

    monkeypatch.setattr(cli, "serving_model", with_jax_weights)
    r, k, s = split
    server, _, ready = cli.build_server(cli.build_parser().parse_args(
        TINY + ["--device", ",".join(["cpu"] * (r * k * s)),
                "--replicas", str(r), "--model-parallel", str(k),
                "--seq-parallel", str(s), "--buckets", "1,4",
                "--max-delay-ms", "20", "--timeout-s", "60"]))
    try:
        client = ServeClient(port=server.port, timeout_s=60)
        got = np.asarray(client.embed_many(jax_siglip_2x2["images"]),
                         np.float32)
        single = np.asarray(client.embed(jax_siglip_2x2["images"][0]))
    finally:
        server.stop()
    assert ready["topology"] == {"n_devices": r * k * s, "replicas": r,
                                 "model_parallel": k, "seq_parallel": s,
                                 "devices_used": r * k * s,
                                 "devices_unused": 0}
    np.testing.assert_allclose(got, jax_siglip_2x2[split], **TOL)
    np.testing.assert_allclose(single, jax_siglip_2x2[split][0], **TOL)


# -- a failing position, the watchdog, revive and heal ------------------------

@pytest.fixture()
def tiny_siglip():
    model, _ = cli.serving_model(
        cli.tiny_override(cli.preset("siglip-base-patch16-256")), "f32", CPU)
    return model


class _Raise:
    """A forward pre-hook that raises while ``on``."""

    def __init__(self):
        self.on = True

    def __call__(self, module, args):
        if self.on:
            raise RuntimeError("injected position fault")


def test_a_failing_position_never_hangs_the_server(tiny_siglip):
    """Position 1 of a (1, 2, 2) replica raises: the call raises its error
    within the stated timeout (its peers' collectives abort), the
    watchdog restarts then fences the lane; revive serves again. A lasting
    fault escalates to the heal factory, whose fresh forward the engine
    replans onto."""
    plan = plan_topology(2, 2, 2, devices=[CPU] * 8)
    forwards = build_replica_forwards(tiny_siglip, plan,
                                      method="encode_image", timeout_s=5.0)
    fault = _Raise()
    fault.on = False
    forwards[1].models[1].vision.encoder.blocks[1].register_forward_pre_hook(
        fault)
    engine = InferenceEngine(
        forwards, item_shape=(32, 32, 3), buckets=BucketTable((1,)),
        max_delay_ms=1.0,
        policy=AdmissionPolicy(max_queue=64, default_timeout_s=30.0))
    server = ServingServer(engine, port=0, request_timeout_s=30.0)
    server.start()
    client = ServeClient(port=server.port, timeout_s=30)
    image = np.zeros((32, 32, 3), np.float32)

    def status() -> int:
        try:
            client.embed(image)
        except ServeClientError as e:
            return e.status
        return 200

    try:
        fault.on = True
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="injected position fault"):
            forwards[1](image[None])
        assert time.monotonic() - t0 < 5.0
        statuses = sorted(status() for _ in range(6))
        health = client.healthz()
        assert statuses.count(500) == 2 and statuses.count(200) == 4
        assert health["status"] == "degraded"
        assert health["dead_replicas"] == [1]
        fault.on = False
        revived = client._request("POST", "/admin/revive", {"replica": 1})
        assert revived["dead_replicas"] == []
        before = engine.replica_stats()[1]["dispatched"]
        for _ in range(6):
            assert status() == 200
        assert engine.replica_stats()[1]["dispatched"] > before

        # a lasting fault: the probe fails, the factory rebuilds the
        # replica set over the same plan, and the replan serves on it
        engine.set_heal(lambda: build_replica_forwards(
            tiny_siglip, plan, method="encode_image", timeout_s=5.0))
        fault.on = True
        end = time.monotonic() + 60
        while engine.metrics.count("replans_total") < 1:
            assert time.monotonic() < end, "no replan in 60 s"
            status()
        health = client.healthz()
        assert health["status"] == "ok" and health["replans"] == 1
        assert forwards[1] not in engine.forwards
        assert all(status() == 200 for _ in range(4))
    finally:
        server.stop()


def test_a_position_that_never_returns_breaks_its_forward(tiny_siglip):
    """A position stuck outside every collective: the call gives up after
    the timeout, and the forward refuses later calls (only a rebuilt one
    serves)."""
    fwd, = build_replica_forwards(
        tiny_siglip, plan_topology(1, 2, 1, devices=[CPU] * 2),
        method="encode_image", timeout_s=0.5)
    release = threading.Event()

    def stall(module, args):
        release.wait(30)

    handle = fwd.models[1].vision.patch_embed.register_forward_pre_hook(stall)
    image = np.zeros((1, 32, 32, 3), np.float32)
    try:
        t0 = time.monotonic()
        with pytest.raises(RendezvousError, match="did not return"):
            fwd(image)
        assert time.monotonic() - t0 < 5.0
        with pytest.raises(RendezvousError, match="did not return"):
            fwd(image)
    finally:
        release.set()
        handle.remove()


def test_replan_between_wide_and_narrow_plans_in_flight(tiny_siglip):
    """(1, 2, 1) -> (2, 1, 1) -> (1, 2, 1) with requests in flight: every
    request is answered, and by the model's own answer."""
    wide = plan_topology(1, 2, 1, devices=[CPU] * 2)
    narrow = wide.revise(replicas=2, model_parallel=1)
    assert narrow.describe()["replicas"] == 2

    def build(plan):
        return build_replica_forwards(tiny_siglip, plan,
                                      method="encode_image")

    images = np.random.default_rng(3).standard_normal(
        (24, 32, 32, 3)).astype(np.float32)
    with torch.inference_mode():
        want = tiny_siglip.encode_image(torch.from_numpy(images)).numpy()

    async def go():
        engine = InferenceEngine(
            build(wide), item_shape=(32, 32, 3), buckets=BucketTable((1, 4)),
            max_delay_ms=2.0,
            policy=AdmissionPolicy(max_queue=64, default_timeout_s=60.0))
        engine.warmup_blocking()
        await engine.start()
        answers = [asyncio.create_task(engine.submit(img))
                   for img in images[:8]]
        first = await engine.replan(build(narrow))
        answers += [asyncio.create_task(engine.submit(img))
                    for img in images[8:16]]
        second = await engine.replan(build(wide))
        answers += [asyncio.create_task(engine.submit(img))
                    for img in images[16:]]
        out = await asyncio.gather(*answers)
        kinds = [type(f).__name__ for f in engine.forwards]
        await engine.stop()
        return np.stack(out), first, second, kinds

    got, first, second, kinds = asyncio.run(go())
    assert first["replicas"] == 2 and second["replicas"] == 1
    assert kinds == ["ShardedReplicaForward"]
    np.testing.assert_allclose(got, want, **TOL)


def test_prof_dir_counts_every_position_copy(tmp_path, monkeypatch):
    from jimm_tpu_torch.obs.prof.capture import reset_capture
    from jimm_tpu_torch.obs.prof.memory import module_bytes
    monkeypatch.delenv("JIMM_PROF_DIR", raising=False)
    server, model, _ = cli.build_server(cli.build_parser().parse_args(
        TINY + ["--device", "cpu,cpu", "--model-parallel", "2",
                "--buckets", "1", "--prof-dir", str(tmp_path / "prof")]))
    try:
        fwd, = server.engine.forwards
        report = server.monitor.sample()["subsystems"]
        assert report["model_pool"] == module_bytes(model, *fwd.models)
        assert module_bytes(*fwd.models) < 2 * module_bytes(model)
    finally:
        server.stop()
        reset_capture()


def test_ready_line_of_a_wide_replica(capsys):
    args = cli.build_parser().parse_args(
        TINY + ["--device", "cpu,cpu,cpu,cpu", "--model-parallel", "2",
                "--seq-parallel", "2", "--buckets", "1",
                "--max-seconds", "0.01"])
    assert cli.cmd_serve(args) == 0
    ready = json.loads(capsys.readouterr().out.splitlines()[0])
    assert ready["status"] == "serving"
    assert ready["topology"]["model_parallel"] == 2
    assert ready["topology"]["seq_parallel"] == 2
    assert "qos" not in ready and "models" not in ready
    assert topology.SHARD_TIMEOUT_S > 0
