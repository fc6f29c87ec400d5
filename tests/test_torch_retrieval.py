"""``jimm_tpu_torch.retrieval`` on the CPU, held against ``jimm_tpu.retrieval``
(JAX running its own jit on the CPU) and a NumPy oracle: the vector store's
segment bytes, fingerprints and loads across the two packages both ways
(an IVF store of JAX's included), the streaming top-k at the shapes where a
blocked merge goes wrong (a corpus off the block, k past the block, k past
the corpus, exact ties), ``merge_partials``, a two-replica plan and a wide
one against one device, ``search_blocking``'s validation, ``/v1/search``
(a vector and an image through a tiny SigLIP server) with the
``jimm_retrieval`` series, the ``index`` command, and ``classify --index``
keeping its class weights across two processes."""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from jimm_tpu import retrieval as jr
from jimm_tpu.retrieval import cli as jax_index_cli
from jimm_tpu.retrieval import store as jax_store
from jimm_tpu_torch import cli, obs
from jimm_tpu_torch.retrieval import (IndexSearcher, ModeNotPorted,
                                      RetrievalService, Searcher,
                                      VectorStore, merge_partials,
                                      normalize_rows, streaming_topk)
from jimm_tpu_torch.retrieval import cli as index_cli
from jimm_tpu_torch.retrieval import store as port_store
from jimm_tpu_torch.serve.admission import RequestError
from jimm_tpu_torch.serve.client import ServeClient, ServeClientError
from jimm_tpu_torch.serve.topology import plan_topology
from jimm_tpu_torch.tune import space

CPU = torch.device("cpu")
REPO = pathlib.Path(__file__).resolve().parent.parent


def oracle_topk(queries, corpus, k):
    """The reference ranking: f64 scores rounded to f32, then a stable
    argsort (ties: lowest global index first)."""
    scores = (np.asarray(queries, np.float64)
              @ np.asarray(corpus, np.float64).T).astype(np.float32)
    order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(scores, order, axis=1), order


def unit_rows(n, d, seed=0):
    rng = np.random.RandomState(seed)
    return normalize_rows(rng.randn(n, d).astype(np.float32))


def _fill(store, name, dim, dtype, seed=0):
    """Two segments and a tombstone: the same calls in either package."""
    store.create(name, dim, dtype=dtype)
    store.add(name, [f"a{i}" for i in range(40)], unit_rows(40, dim, seed))
    store.add(name, [f"b{i}" for i in range(25)],
              unit_rows(25, dim, seed + 1) * 3.0)
    store.delete(name, ["a3", "b7", "missing"])


def _manifest_core(man: dict) -> dict:
    return {k: v for k, v in man.items() if k not in ("created", "updated")}


# -- the store -------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_bytes_match_jax(dtype):
    ids = [f"r{i}" for i in range(9)]
    rows = unit_rows(9, 12, seed=2)
    ours = port_store.encode_segment(ids, rows, dtype)
    theirs = jax_store.encode_segment(ids, rows, dtype)
    assert ours == theirs
    got_ids, got = port_store.decode_segment(theirs)
    want_ids, want = jax_store.decode_segment(ours)
    assert got_ids == want_ids == ids
    assert got.tobytes() == np.ascontiguousarray(want).tobytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_store_loads_in_the_other_package(tmp_path, dtype, writer):
    make = VectorStore if writer == "port" else jr.VectorStore
    _fill(make(tmp_path), "idx", 16, dtype)
    ours = VectorStore(tmp_path).load("idx")
    theirs = jr.VectorStore(tmp_path).load("idx")
    assert ours.ids == theirs.ids and len(ours) == 63
    assert ours.state == theirs.state
    assert ours.vectors.tobytes() == np.ascontiguousarray(
        theirs.vectors).tobytes()
    assert np.array_equal(ours.matrix_f32(), theirs.matrix_f32())
    assert VectorStore(tmp_path).verify() == jr.VectorStore(tmp_path).verify()
    want = jr.VectorStore(tmp_path).stats("idx")
    got = VectorStore(tmp_path).stats("idx")
    assert {k: v for k, v in got.items() if k != "updated"} == {
        k: v for k, v in want.items() if k != "updated"}


def test_both_packages_write_the_same_store(tmp_path):
    for root, make in (("port", VectorStore), ("jax", jr.VectorStore)):
        store = make(tmp_path / root)
        _fill(store, "idx", 16, "bfloat16", seed=4)
        store.compact("idx")
    ours = json.loads((tmp_path / "port/indexes/idx.json").read_text())
    theirs = json.loads((tmp_path / "jax/indexes/idx.json").read_text())
    assert _manifest_core(ours) == _manifest_core(theirs)
    fp = ours["segments"][0]["fingerprint"]
    art = f"objects/{fp[:2]}/{fp}/artifact.bin"
    assert (tmp_path / "port" / art).read_bytes() == \
        (tmp_path / "jax" / art).read_bytes()


def test_a_jax_ivf_store_loads_for_exact_search_and_keeps_its_codebook(
        tmp_path):
    from jimm_tpu.retrieval.ann.kmeans import assign_clusters
    theirs = jr.VectorStore(tmp_path)
    _fill(theirs, "idx", 16, "float32", seed=6)
    cents = unit_rows(4, 16, seed=9)
    theirs.set_codebook("idx", cents, trained_rows=63, seed=0)
    theirs.build_ivf("idx")
    before = theirs.manifest("idx")
    assert before["ann"] and all("clusters" in s for s in before["segments"])
    ours = VectorStore(tmp_path)
    assert ours.load("idx").ids == theirs.load("idx").ids
    assert ours.verify() == []
    # an add keeps the codebook and the old runs; JAX sees the new rows as
    # unassigned (its build-ivf assigns them)
    new = unit_rows(5, 16, seed=10)
    ours.add("idx", [f"c{i}" for i in range(5)], new)
    after = ours.manifest("idx")
    assert after["ann"] == before["ann"]
    assert after["segments"][:-1] == before["segments"]
    status = jr.VectorStore(tmp_path).ann_status("idx")
    assert status["unassigned_rows"] == 5 and status["advice"] == "build-ivf"
    assert jr.VectorStore(tmp_path).load("idx").ids == ours.load("idx").ids
    # exact search over the IVF-laid-out rows is the oracle's
    index = ours.load("idx")
    queries = unit_rows(3, 16, seed=11)
    searcher = IndexSearcher(index, k=7, block_n=32, device=CPU)
    _, idx, _ = searcher.search(queries)
    assert np.array_equal(idx, oracle_topk(queries, index.matrix_f32(), 7)[1])
    assert assign_clusters(new, cents).shape == (5,)
    with pytest.raises(port_store.RetrievalStoreError, match="item 9"):
        ours.compact("idx")


def test_prompt_cache_entries_are_shared_with_jax(tmp_path):
    w = np.arange(12, dtype=np.float32).reshape(3, 4)
    jr.VectorStore(tmp_path).prompt_cache().put("clip:x:rows", w)
    cache = VectorStore(tmp_path).prompt_cache()
    assert np.array_equal(cache.get("clip:x:rows"), w)
    assert cache.disk_hits == 1 and cache.get("never") is None
    cache.put("siglip:y", w * 2)
    assert np.array_equal(
        jr.VectorStore(tmp_path).prompt_cache().get("siglip:y"), w * 2)


def test_index_cli_rows_and_outputs_match_jax(tmp_path, capsys):
    for name, main in (("port", index_cli.main), ("jax", jax_index_cli.main)):
        store = str(tmp_path / name)
        prefix = ["index"] if name == "port" else []
        assert main([*prefix, "build", "--store", store, "c", "--dim", "24",
                     "--random", "300", "--seed", "3"]) == 0
        assert main([*prefix, "add", "--store", store, "c", "--random",
                     "20", "--seed", "5"]) == 0
    outs = capsys.readouterr().out.splitlines()
    assert outs[0] == outs[2]  # build: the same segment fingerprint
    assert json.loads(outs[1])["segment"] == json.loads(outs[3])["segment"]
    for verb in (["stats", "c", "--json"], ["ls", "--json"]):
        docs = []
        for name, main in (("port", index_cli.main),
                           ("jax", jax_index_cli.main)):
            prefix = ["index"] if name == "port" else []
            assert main([*prefix, verb[0], "--store",
                         str(tmp_path / name), *verb[1:]]) == 0
            doc = json.loads(capsys.readouterr().out)
            for d in doc if isinstance(doc, list) else [doc]:
                d.pop("updated")
            docs.append(doc)
        assert docs[0] == docs[1]
    store = str(tmp_path / "port")
    assert index_cli.main(["index", "verify", "--store", store]) == 0
    assert index_cli.main(["index", "compact", "--store", store, "c"]) == 0
    capsys.readouterr()
    # a corrupted segment: verify quarantines it and exits 1
    seg = VectorStore(store).manifest("c")["segments"][0]["fingerprint"]
    art = tmp_path / "port" / "objects" / seg[:2] / seg / "artifact.bin"
    art.write_bytes(art.read_bytes()[:-8])
    assert index_cli.main(["index", "verify", "--store", store]) == 1
    assert json.loads(capsys.readouterr().out.splitlines()[-1])[
        "problems"] == 1
    for verb in (["train-centroids", "--store", store, "c", "--clusters",
                  "4"], ["build-ivf", "--store", store, "c"]):
        with pytest.raises(SystemExit, match="queue 1 item 9 part 2"):
            index_cli.main(["index", *verb])


# -- top-k -----------------------------------------------------------------

#: (rows, dim, queries, k, block): a corpus off the block, k past the
#: block, k past the corpus
TOPK_CASES = {"ragged": (1000, 24, 4, 10, 128),
              "k_past_block": (100, 16, 3, 16, 8),
              "k_past_corpus": (5, 8, 2, 9, 4)}


@pytest.mark.parametrize("case", list(TOPK_CASES))
def test_topk_matches_jax_and_the_oracle(case):
    n, d, b, k, bn = TOPK_CASES[case]
    corpus, queries = unit_rows(n, d, 1), unit_rows(b, d, 2)
    vals, idx = streaming_topk(queries, corpus, k, block_n=bn, device=CPU)
    jv, ji = jr.streaming_topk(queries, corpus, k, block_n=bn)
    assert np.array_equal(idx, ji)
    assert np.allclose(vals, jv, atol=1e-6)
    live = min(k, n)
    want_v, want_i = oracle_topk(queries, corpus, live)
    assert np.array_equal(idx[:, :live], want_i)
    assert np.abs(vals[:, :live] - want_v).max() <= 1e-6
    assert np.all(idx[:, live:] == -1) and np.all(np.isneginf(vals[:, live:]))


@pytest.mark.parametrize("block_n", [5, 7, 21])
def test_exact_ties_follow_the_stable_order(block_n):
    base = unit_rows(7, 12, seed=4)
    corpus = np.concatenate([base, base, base])  # every score three times
    queries = unit_rows(2, 12, seed=5)
    vals, idx = streaming_topk(queries, corpus, 9, block_n=block_n,
                               device=CPU)
    want_v, want_i = oracle_topk(queries, corpus, 9)
    assert np.array_equal(idx, want_i)  # the lowest global index first
    assert np.array_equal(vals, want_v)
    _, ji = jr.streaming_topk(queries, corpus, 9, block_n=block_n)
    assert np.array_equal(idx, ji)


def test_signed_zero_scores_tie():
    """A zero row scores 0.0 (or -0.0) against anything: ties broken by the
    index alone, as the oracle's."""
    corpus = np.zeros((6, 4), np.float32)
    corpus[2] = [0.0, 1.0, 0.0, 0.0]
    queries = np.array([[-1.0, 0.0, 0.0, 0.0], [0.0, -1.0, 0.0, 0.0]],
                       np.float32)
    vals, idx = streaming_topk(queries, corpus, 6, block_n=4, device=CPU)
    assert idx.tolist() == [[0, 1, 2, 3, 4, 5], [0, 1, 3, 4, 5, 2]]
    assert vals.tolist()[1] == [0.0] * 5 + [-1.0]


@pytest.mark.parametrize("seed", [0, 1])
def test_merge_partials_matches_jax(seed):
    rng = np.random.RandomState(seed)
    vals = np.round(rng.randn(3, 2, 4), 1).astype(np.float32)  # ties
    idx = rng.permutation(100)[:24].reshape(3, 2, 4).astype(np.int64)
    vals[1, 0, 2], idx[1, 0, 2] = -np.inf, -1
    for k in (5, 12, 20):
        got = merge_partials(vals, idx, k)
        want = jr.merge_partials(vals, idx, k)
        assert np.array_equal(got[1], want[1])
        assert np.array_equal(got[0], want[0])


@pytest.fixture(scope="module")
def loaded(tmp_path_factory):
    root = tmp_path_factory.mktemp("idx")
    store = VectorStore(root)
    store.create("c", 16)
    base = unit_rows(150, 16, seed=20)
    store.add("c", [f"v{i}" for i in range(300)],
              np.concatenate([base, base]))  # ties across partitions
    return root, store.load("c")


def test_index_searcher_matches_jax(loaded):
    root, index = loaded
    queries = unit_rows(5, 16, seed=21) * 2.0
    ours = IndexSearcher(index, k=12, buckets=(1, 8), block_n=64, device=CPU)
    theirs = jr.IndexSearcher(jr.VectorStore(root).load("c"), k=12,
                              buckets=(1, 8), block_n=64)
    assert ours.warmup() == {1: "eager", 8: "eager"}
    assert ours.trace_count() == 0
    ov, oi, oids = ours.search(queries)
    tv, ti, tids = theirs.search(queries)
    assert np.array_equal(oi, ti) and oids == tids
    assert np.abs(ov - tv).max() <= 1e-6
    want_v, want_i = oracle_topk(normalize_rows(queries),
                                 index.matrix_f32(), 12)
    assert np.array_equal(oi, want_i)


@pytest.mark.parametrize("plan", [(2, 1, 1), (1, 2, 1), (2, 2, 1)],
                         ids=["two_replicas", "one_wide", "two_wide"])
def test_a_replica_plan_equals_one_device(loaded, plan):
    """Two replicas take a contiguous half each, a wide replica shards its
    partition over its positions; the host merge gives one device's
    answer, ties across partitions included."""
    _, index = loaded
    r, m, s = plan
    topo = plan_topology(r, m, s, devices=[CPU] * (r * m * s))
    queries = unit_rows(9, 16, seed=22)
    single = IndexSearcher(index, k=10, buckets=(4,), block_n=32,
                           device=CPU)
    split = IndexSearcher(index, k=10, buckets=(4,), block_n=32, plan=topo)
    assert len(split.searchers) == r
    assert all(p.shards == m * s for p in split.searchers)
    sv, si, sids = single.search(queries)
    pv, pi, pids = split.search(queries)
    assert np.array_equal(pi, si) and pids == sids
    assert np.array_equal(pv, sv)


@pytest.mark.parametrize("shards", [1, 2, 3])
def test_devices_hold_the_live_rows_in_f64(loaded, shards):
    """A shard's device holds its live rows, widened once to f64 (no block
    padding: 300 rows in blocks of 64 or 256), and an untuned searcher
    scans at the default rule's block; the answer is the oracle's either
    way."""
    _, index = loaded
    corpus = index.vectors
    searcher = Searcher(corpus, k=10, buckets=(4,), devices=[CPU] * shards)
    assert searcher.block_n == space.retrieval_default(
        [(4, 16), (300, 16)])["block_n"] == 256
    blocked = Searcher(corpus, k=10, buckets=(4,), block_n=64,
                       devices=[CPU] * shards)
    for s in (searcher, blocked):
        assert s.resident_bytes() == 300 * 16 * 8
        assert all(r.dtype == torch.float64 for r in s._rows)
    queries = normalize_rows(unit_rows(4, 16, seed=23))
    want_v, want_i = oracle_topk(queries, index.matrix_f32(), 10)
    for s in (searcher, blocked):
        vals, idx = s.search_partial(queries)
        mv, mi = merge_partials(vals, idx, 10)
        assert np.array_equal(mi, want_i) and np.array_equal(mv, want_v)


# -- the service -----------------------------------------------------------

@pytest.fixture()
def service(tmp_path):
    store = VectorStore(tmp_path)
    store.create("idx", 16)
    store.add("idx", [f"v{i}" for i in range(50)],
              unit_rows(50, 16, seed=30))
    return RetrievalService.from_store(store, "idx", k=5, block_n=64,
                                       device=CPU)


def test_search_blocking_validates_as_jax(service, tmp_path):
    from jimm_tpu.serve.admission import RequestError as JaxRequestError
    theirs = jr.RetrievalService.from_store(jr.VectorStore(tmp_path), "idx",
                                            k=5, block_n=64)
    bad = [(np.zeros((1, 7), np.float32), {}),
           (np.full((1, 16), np.inf, np.float32), {}),
           (np.zeros((1, 16), np.float32), {"k": 9}),
           (np.zeros((1, 16), np.float32), {"k": 0}),
           (np.zeros((1, 16), np.float32), {"nprobe": 2})]
    for queries, kw in bad:
        with pytest.raises(RequestError) as ours:
            service.search_blocking(queries, **kw)
        with pytest.raises(JaxRequestError) as want:
            theirs.search_blocking(queries, **kw)
        assert str(ours.value) == str(want.value)
    queries = np.random.RandomState(31).randn(2, 16)
    values, ids = service.search_blocking(queries, k=3)
    want_v, want_ids = theirs.search_blocking(queries, k=3)
    assert ids == want_ids and np.abs(values - want_v).max() <= 1e-6
    one_v, one_ids = service.search_blocking(queries[0])  # the (D,) form
    assert one_v.shape == (1, 5) and len(one_ids[0]) == 5
    d = service.describe()
    assert {k: d[k] for k in ("index", "rows", "dim", "k", "block_n",
                              "partitions", "mode")} == {
        "index": "idx", "rows": 50, "dim": 16, "k": 5, "block_n": 64,
        "partitions": 1, "mode": "exact"}


def test_metrics_and_gauges(service):
    before = obs.get_registry("jimm_retrieval").counter("search_total").value
    service.search_blocking(np.zeros((3, 16), np.float32))
    snap = obs.snapshot()
    assert snap["jimm_retrieval_search_total"] == before + 3
    assert snap["jimm_retrieval_index_size"] == 50.0
    assert snap["jimm_retrieval_index_segments"] == 1.0
    assert snap["jimm_retrieval_index_staleness_seconds"] >= 0.0
    assert "jimm_spans_retrieval_topk_seconds_count" in snap


def test_the_approximate_modes_wait_for_item_9(service, tmp_path):
    for mode in ("ivf", "tiered"):
        with pytest.raises(ModeNotPorted, match="queue 1 item 9"):
            RetrievalService.from_store(VectorStore(tmp_path), "idx",
                                        mode=mode, device=CPU)
        with pytest.raises(SystemExit, match="queue 1 item 9"):
            cli.build_server(cli.build_parser().parse_args(
                ["serve", "--tiny", "--device", "cpu", "--index-store",
                 str(tmp_path), "--index", "idx", "--index-mode", mode]))
    for argv, msg in ((["--index", "idx"], "needs --index-store"),
                      (["--index-store", str(tmp_path)], "needs --index")):
        with pytest.raises(SystemExit, match=msg):
            cli.build_server(cli.build_parser().parse_args(
                ["serve", "--tiny", "--device", "cpu", *argv]))


# -- /v1/search and classify --index -----------------------------------------

@pytest.fixture(scope="module")
def search_store(tmp_path_factory):
    root = tmp_path_factory.mktemp("served")
    store = VectorStore(root)
    store.create("corpus", 64)  # the tiny SigLIP's embedding width
    base = unit_rows(100, 64, seed=40)
    store.add("corpus", [f"doc{i}" for i in range(200)],
              np.concatenate([base, base]))
    return root, store.load("corpus")


@pytest.mark.parametrize("extra", [[], ["--replicas", "2", "--device",
                                        "cpu,cpu"]],
                         ids=["one_replica", "two_replicas"])
def test_v1_search_vector_and_image(search_store, tmp_path, extra):
    root, index = search_store
    args = cli.build_parser().parse_args(
        ["serve", "--tiny", "--device", "cpu", "--port", "0", "--buckets",
         "1,4", "--index-store", str(root), "--index", "corpus",
         "--search-k", "8", "--aot-store", str(tmp_path / "aot"),
         "--prof-dir", str(tmp_path / "prof"), *extra])
    server, _, ready = cli.build_server(args)
    try:
        info = ready["retrieval"]
        assert info["rows"] == 200 and info["k"] == 8
        assert info["partitions"] == (2 if extra else 1)
        assert info["aot"] == {"1": "eager"}
        client = ServeClient(port=server.port, timeout_s=60.0)
        corpus = index.matrix_f32()
        q = np.random.RandomState(41).randn(64).astype(np.float32)
        out = client.search(vector=q, k=5)
        want_v, want_i = oracle_topk(normalize_rows(q[None]), corpus, 5)
        assert out["ids"] == [f"doc{i}" for i in want_i[0]]
        assert np.abs(np.array(out["scores"]) - want_v[0]).max() <= 1e-5
        img = np.random.RandomState(42).rand(32, 32, 3).astype(np.float32)
        out = client.search(image=img)
        feat = normalize_rows(np.asarray(client.embed(img), np.float32)[None])
        want_v, want_i = oracle_topk(feat, corpus, 8)
        assert out["ids"] == [f"doc{i}" for i in want_i[0]]
        assert np.abs(np.array(out["scores"]) - want_v[0]).max() <= 1e-5
        before = obs.get_registry("jimm_retrieval").counter(
            "embed_total").value
        assert len(client.embed_many([img] * 3)) == 3
        text = client.metrics_text()
        assert obs.get_registry("jimm_retrieval").counter(
            "embed_total").value == before + 3
        assert "jimm_retrieval_index_size 200" in text
        assert "jimm_retrieval_search_total" in text
        assert client.healthz()["retrieval"]["rows"] == 200
        mem = server.monitor.sample()
        assert mem["subsystems"]["retrieval_index"] >= 200 * 64 * 4
        for payload in ({"vector": [1.0, 2.0]}, {"vector": [0.0] * 64,
                                                 "k": 99}):
            with pytest.raises(ServeClientError) as e:
                client._request("POST", "/v1/search", payload)
            assert e.value.status == 400
    finally:
        server.stop()


def test_classify_index_keeps_weights_across_processes(tmp_path,
                                                       monkeypatch):
    """A first ``classify --index`` process stores the class weights; a
    second finds them there and runs no text tower (it would raise)."""
    from PIL import Image
    from jimm_tpu_torch import configs
    cfg = cli.tiny_override(configs.preset("siglip-base-patch16-256"))
    model = cli.MODELS["siglip"](cfg, device="cpu",
                                 generator=torch.Generator().manual_seed(5))
    ckpt = tmp_path / "ckpt"
    model.save_pretrained(ckpt)
    image = tmp_path / "img.png"
    Image.fromarray(np.random.default_rng(6).integers(
        0, 256, (24, 40, 3), dtype=np.uint8)).save(image)
    tokens = tmp_path / "tokens.json"
    tokens.write_text(json.dumps({"a": [3, 4], "b": [5, 6, 7]}))
    argv = ["classify", str(image), "--ckpt", str(ckpt), "--model",
            "siglip", "--tokens-file", str(tokens), "--index",
            str(tmp_path / "store"), "--device", "cpu"]
    first = subprocess.run([sys.executable, "-m", "jimm_tpu_torch", *argv],
                           capture_output=True, text=True, timeout=300,
                           cwd=REPO)
    assert first.returncode == 0, first.stderr
    assert VectorStore(tmp_path / "store").artifacts.entries()

    def no_text_tower(*a, **k):
        raise AssertionError("the text tower ran on a stored label set")
    monkeypatch.setattr(cli, "weights_from_rows", no_text_tower)
    from jimm_tpu_torch.data import records
    out = cli.classify_image(cli.build_parser().parse_args(argv),
                             records.decode_image(image.read_bytes()))
    assert out["cached"]
    printed = {line.split()[1]: float(line.split()[0])
               for line in first.stdout.splitlines() if line.strip()}
    got = dict(zip(out["labels"], out["scores"]))
    assert printed.keys() == got.keys()
    assert all(abs(got[k] - printed[k]) <= 1e-4 for k in printed)
