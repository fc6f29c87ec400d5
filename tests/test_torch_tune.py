"""``jimm_tpu_torch.tune`` on the CPU, held against ``jimm_tpu.tune``: the
measurement's trimmed median and counter names, the cache's put/get and
quarantine, ``tune run|ls``, ``JIMM_TUNE=1``, the port's fingerprint
goldens (and their stability across processes), the hot path's one store
probe a shape, and the knobs' defaults: an empty cache resolves every knob
to the heuristic that picks it today (``k_range``, ``dbias_batch_range``
and the LayerNorm backward's grid rule), so it changes no launch.

On the CPU the wrappers run their plain versions, which take no knob, and
``measure`` takes one rep: the path is tested, the numbers are not (the
card's are ``chip_smoke.py`` phase 24's)."""

import dataclasses
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from jimm_tpu import tune as jax_tune
from jimm_tpu.tune import api as jax_api
from jimm_tpu_torch import obs, tune
from jimm_tpu_torch.ops import flash_attention as fa
from jimm_tpu_torch.ops import fp8_matmul as fp8
from jimm_tpu_torch.ops import layer_norm as ln
from jimm_tpu_torch.tune import api, cli as tune_cli, space

H100_SMS = 132
KEY_FIELDS = dict(kernel_version=1, device="cuda:sm_90",
                  torch_version="2.7.0", kernels="0123456789abcdef")
#: (kernel, shapes, dtypes) -> fingerprint, pinned: a drift here orphans
#: every tuned record on disk
GOLDENS = [
    ("layer_norm", ((32768, 768),), ("bfloat16",),
     "b53ddc911ef78cc75be9fe492250bac71ecc25411c5efa2389b7ca22238fc7ec"),
    ("fp8_matmul", ((32768, 768), (3072, 768)), ("bfloat16", "bfloat16"),
     "70556195339193db635577764bd2b7330affea5b45bac8e9693cb72499eb2d06"),
]


def counters() -> dict:
    return obs.snapshot()


def delta(before: dict, after: dict, name: str) -> float:
    return after.get(name, 0) - before.get(name, 0)


@pytest.fixture()
def cache(tmp_path):
    return tune.TuneCache(tmp_path / "tune")


@pytest.fixture()
def fresh_global(monkeypatch, tmp_path):
    """The process-wide cache pointed at an empty store for one test."""
    monkeypatch.setattr(api, "_cache", None)
    return tune.configure(tmp_path / "global")


# -- measure ---------------------------------------------------------------

@pytest.mark.parametrize("samples", [[3.0], [1.0, 3.0], [2.0, 1.0, 9.0],
                                     [100.0, 1.0, 2.0, 3.0, 0.1],
                                     [5.0, 1.0, 4.0, 2.0, 3.0, 7.0, 6.0]])
def test_trimmed_median_matches_jax(samples):
    assert tune.trimmed_median(samples) == jax_tune.trimmed_median(samples)


def test_measure_counts_under_jax_names_and_one_cpu_rep():
    calls = []
    before = counters()
    t = tune.measure(lambda: calls.append(1), kernel="layer_norm",
                     device="cpu")
    after = counters()
    assert t >= 0 and len(calls) == 2  # the warmup and one rep
    assert delta(before, after, "jimm_tune_measure_total") == 1
    spans = obs.snapshot()
    assert "jimm_spans_tune_measure_seconds_count" in spans
    assert "jimm_spans_tune_measure_layer_norm_seconds_count" in spans


# -- keys ------------------------------------------------------------------

@pytest.mark.parametrize("kernel,shapes,dtypes,want", GOLDENS,
                         ids=[g[0] for g in GOLDENS])
def test_fingerprint_goldens(kernel, shapes, dtypes, want):
    key = tune.tune_key(kernel, shapes=shapes, dtypes=dtypes, **KEY_FIELDS)
    assert key.fingerprint() == want
    # every spelling of a dtype is one key
    spelled = tune.tune_key(kernel, shapes=[list(s) for s in shapes],
                            dtypes=[getattr(torch, d) for d in dtypes],
                            **KEY_FIELDS)
    assert spelled.fingerprint() == want


def test_fingerprint_stable_across_processes():
    code = ("from jimm_tpu_torch.tune import tune_key\n"
            f"for kernel, shapes, dtypes, _ in {GOLDENS!r}:\n"
            "    print(tune_key(kernel, shapes=shapes, dtypes=dtypes,\n"
            f"                   **{KEY_FIELDS!r}).fingerprint())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.split() == [g[3] for g in GOLDENS]


def test_key_holds_device_torch_and_kernel_sources():
    base = tune.tune_key("layer_norm", shapes=((8, 16),), dtypes=("float32",),
                         **KEY_FIELDS)
    for field, other in (("device", "cpu"), ("torch_version", "2.8.0"),
                         ("kernels", "fedcba9876543210"),
                         ("kernel_version", 2)):
        changed = tune.tune_key("layer_norm", shapes=((8, 16),),
                                dtypes=("float32",),
                                **{**KEY_FIELDS, field: other})
        assert changed.fingerprint() != base.fingerprint(), field
    # by default the key takes this process's torch and the CUDA sources'
    # digest, so a rebuilt csrc/ misses
    from jimm_tpu_torch import _build
    live = tune.tune_key("layer_norm", shapes=((8, 16),),
                         dtypes=("float32",), kernel_version=1,
                         device=torch.device("cpu"))
    assert (live.device, live.torch_version, live.kernels) == (
        "cpu", torch.__version__, _build._digest())


# -- cache -----------------------------------------------------------------

def _key(**over):
    kw = dict(shapes=((64, 32),), dtypes=("float32",), **KEY_FIELDS)
    kw.update(over)
    return tune.tune_key("layer_norm", **kw)


def test_put_get_round_trip_and_a_second_instance_sees_it(cache, tmp_path):
    fp = cache.put(_key(), {"ctas": 16}, metrics={"time_s": 1e-3})
    assert fp == _key().fingerprint()
    rec = cache.get(_key())
    assert rec["config"] == {"ctas": 16}
    assert rec["metrics"]["time_s"] == 1e-3
    again = tune.TuneCache(tmp_path / "tune")
    assert again.get(_key())["config"] == {"ctas": 16}
    assert again.get(_key(shapes=((128, 32),))) is None


def test_miss_creates_nothing(tmp_path):
    cache = tune.TuneCache(tmp_path / "never")
    assert cache.get(_key()) is None and cache.entries() == []
    assert not (tmp_path / "never").exists()


@pytest.mark.parametrize("payload", [b"\xff\xfe not json",
                                     b'{"metrics": {}}', b"[1, 2]"],
                         ids=["undecodable", "no-config", "not-a-mapping"])
def test_bad_record_quarantined_as_a_miss_like_jax(cache, tmp_path,
                                                   payload):
    fp = _key().fingerprint()
    cache.store.put(fp, payload)
    assert cache.get(_key()) is None
    assert not cache.store.contains(fp)
    assert any(p.name.startswith(fp) for p in
               (tmp_path / "tune" / "quarantine").iterdir())
    # JAX's cache does the same with the same record
    jax_cache = jax_tune.TuneCache(tmp_path / "jax")
    jkey = jax_tune.tune_key("layer_norm", shapes=((64, 32),),
                             dtypes=("float32",), kernel_version=1,
                             backend="cpu", jax_version="x")
    jax_cache.store.put(jkey.fingerprint(), payload)
    assert jax_cache.get(jkey) is None
    assert not jax_cache.store.contains(jkey.fingerprint())


# -- best_config: memo, counters, JIMM_TUNE, explicit knobs -----------------

def test_one_store_probe_for_a_thousand_lookups(cache):
    before = counters()
    for _ in range(1000):
        cfg = tune.best_config("layer_norm", (torch.Size((64, 32)),),
                               (torch.float32,), device=torch.device("cpu"),
                               default={"ctas": 3}, cache=cache)
        assert cfg == {"ctas": 3}
    after = counters()
    assert cache.probes == 1
    assert delta(before, after, "jimm_tune_miss_total") == 1
    assert delta(before, after, "jimm_tune_fallback_total") == 1
    # a put (tune run in this process) is seen by the next lookup
    cache.put(api._key_for("layer_norm", ((64, 32),), (torch.float32,),
                           "cpu"), {"ctas": 9})
    for _ in range(1000):
        cfg = tune.best_config("layer_norm", (torch.Size((64, 32)),),
                               (torch.float32,), device=torch.device("cpu"),
                               default={"ctas": 3}, cache=cache)
    # the put's own record answers: no second probe
    assert cfg == {"ctas": 9} and cache.probes == 1
    assert delta(after, counters(), "jimm_tune_hit_total") == 1


def test_configure_starts_an_empty_memo(fresh_global, tmp_path):
    args = ("layer_norm", ((64, 32),), (torch.float32,))
    assert tune.best_config(*args, default={"ctas": 2}) == {"ctas": 2}
    other = tune.TuneCache(tmp_path / "other")
    other.put(api._key_for(*args, "cpu"), {"ctas": 7})
    # the memoized miss of the old cache does not outlive configure()
    tune.configure(tmp_path / "other")
    assert tune.best_config(*args, default={"ctas": 2}) == {"ctas": 7}


def test_default_is_evaluated_only_on_a_miss(cache):
    args = ("fp8_matmul", ((64, 32), (48, 32)), ("float32", "float32"))
    cache.put(api._key_for(*args, "cpu"), {"k_range_fwd": 128})

    def boom():
        raise AssertionError("default evaluated on a hit")
    assert tune.best_config(*args, default=boom, cache=cache) == {
        "k_range_fwd": 128}


def test_jimm_tune_env_measures_on_a_miss(cache, monkeypatch):
    monkeypatch.setenv("JIMM_TUNE", "1")
    before = counters()
    cfg = tune.best_config("layer_norm", ((64, 32),), ("float32",),
                           cache=cache)
    after = counters()
    cands = space.ln_space(((64, 32),), (), default={"ctas": 1}, sms=1)
    assert delta(before, after, "jimm_tune_measure_total") == len(cands)
    assert delta(before, after, "jimm_tune_fallback_total") == 0
    rec = cache.get(api._key_for("layer_norm", ((64, 32),), ("float32",),
                                 "cpu"))
    assert rec["config"] == cfg
    assert rec["metrics"]["default"] == {"ctas": 1}


#: a point of each kernel a main-path wrapper looks up, and one whose tile
#: is compiled in (its bench differentiates), at CPU sizes
GRAD_OFF_POINTS = [
    ("layer_norm", ((64, 32),), ("float32",)),
    ("flash_attention_bias", ((2, 16, 2, 8),) * 3, ("float32",) * 3),
    ("fp8_matmul", ((64, 32), (48, 32)), ("float32", "float32")),
    ("flash_attention", ((2, 16, 2, 8),) * 3, ("float32",) * 3),
]


class _LookupInBackward(torch.autograd.Function):
    """Runs ``lookup`` where the wrappers look up on the card: inside a
    Function's backward, which the engine runs with grad mode off."""

    @staticmethod
    def forward(ctx, x, lookup):
        ctx.lookup = lookup
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        ctx.lookup()
        return g, None


@pytest.mark.parametrize("where", ["no_grad", "backward"])
@pytest.mark.parametrize("point", GRAD_OFF_POINTS,
                         ids=[p[0] for p in GRAD_OFF_POINTS])
def test_jimm_tune_measures_where_grad_mode_is_off(cache, monkeypatch,
                                                    point, where):
    """``JIMM_TUNE=1`` measures on a miss where the lookups happen:
    ``Fp8MatmulFn.forward`` runs under no_grad, the LayerNorm and bias
    backwards in the engine's backward; every candidate is measured and
    the record stored."""
    monkeypatch.setenv("JIMM_TUNE", "1")
    kernel, shapes, dtypes = point
    got = []

    def lookup():
        assert not torch.is_grad_enabled()
        got.append(tune.best_config(kernel, shapes, dtypes, cache=cache))
    before = counters()
    if where == "no_grad":
        with torch.no_grad():
            lookup()
    else:
        x = torch.ones(3, requires_grad=True)
        _LookupInBackward.apply(x, lookup).sum().backward()
    rec = cache.get(api._key_for(kernel, shapes, dtypes, "cpu"))
    assert rec["config"] == got[0]
    assert delta(before, counters(), "jimm_tune_measure_total") == len(
        rec["metrics"]["trials"])
    assert all("spread_s" in t for t in rec["metrics"]["trials"])


def test_trimmed_spread():
    assert tune.trimmed_spread([5.0, 1.0, 3.0, 2.0, 4.0]) == 2.0
    assert tune.trimmed_spread([3.0, 1.0]) == 2.0
    assert tune.trimmed_spread([7.0]) == 0.0


def test_a_candidate_must_beat_the_default_beyond_the_spread(cache,
                                                             monkeypatch):
    """The default (1 CTA on the CPU) keeps its place against a candidate
    faster by less than the larger trimmed spread, and loses to one faster
    by more; every trial is stored with its spread."""
    reps = {1: [10.0, 10.1, 10.2, 10.3, 10.4, 10.5, 10.6],   # 10.3 +- 0.4
            2: [9.85, 9.9, 9.95, 10.0, 10.05, 10.1, 10.2],   # 10.0, 0.2
            4: [9.0, 9.4, 9.4, 9.5, 9.5, 9.6, 9.9]}          # 9.5, 0.2
    spec = dataclasses.replace(
        api.KERNELS["layer_norm"],
        bench=lambda shapes, dtypes, config, device: lambda: config["ctas"])
    monkeypatch.setitem(api.KERNELS, "layer_norm", spec)
    monkeypatch.setattr(api, "measure_samples",
                        lambda fn, **kw: list(reps[fn()]))
    point = ("layer_norm", ((64, 32),), ("float32",))
    near = tune.tune_kernel(*point, cache=cache, candidates=[{"ctas": 2}])
    assert near["config"] == {"ctas": 1} == near["default"]
    assert near["time_s"] == near["default_time_s"] == pytest.approx(10.3)
    assert [t["spread_s"] for t in near["trials"]] == [
        pytest.approx(0.4), pytest.approx(0.2)]
    far = tune.tune_kernel(*point, cache=cache,
                           candidates=[{"ctas": 2}, {"ctas": 4}])
    assert far["config"] == {"ctas": 4}
    assert far["time_s"] == pytest.approx(9.5)
    rec = cache.get(api._key_for(*point, "cpu"))
    assert rec["config"] == {"ctas": 4}
    assert rec["metrics"]["default_spread_s"] == pytest.approx(0.4)


def test_explicit_block_bypasses_the_lookup(monkeypatch):
    from jimm_tpu_torch.retrieval.topk import Searcher

    def no_lookup(*a, **k):
        raise AssertionError("looked up despite an explicit block")
    monkeypatch.setattr(api, "best_config", no_lookup)
    corpus = np.eye(8, dtype=np.float32)
    assert Searcher(corpus, k=2, block_n=4, devices=("cpu",)).block_n == 4
    with pytest.raises(AssertionError, match="explicit"):
        Searcher(corpus, k=2, devices=("cpu",))


def test_unknown_and_waiting_kernels_refuse():
    with pytest.raises(ValueError, match="unknown kernel"):
        tune.best_config("nope", ((1,),), ("float32",))
    for kernel in ("retrieval_ivf", "retrieval_tier"):
        with pytest.raises(ValueError, match="queue 1 item 9"):
            tune.best_config(kernel, ((1, 8), (64, 8)), ("float32",))


# -- the knobs: an empty cache is today's heuristic --------------------------

FP8_SHAPES = [(32768, 768, 3072), (32768, 3072, 768), (8192, 768, 768),
              (128, 768, 768), (100, 33, 5), (4097, 1020, 17)]


@pytest.mark.parametrize("m,k,n", FP8_SHAPES)
def test_empty_cache_gives_todays_k_ranges(fresh_global, m, k, n):
    x = torch.empty((m, k))
    w = torch.empty((n, k))
    got = fp8.tuned_k_ranges(x, w, H100_SMS)

    def picked(a_rows, b_rows, k_sum):
        # what fp8_gemm picks with no k_split: k_range at K padded to 16
        return fp8.k_range(a_rows, b_rows, -(-k_sum // 16) * 16, H100_SMS)
    assert got == {"k_range_fwd": picked(m, n, k),
                   "k_range_dx": picked(m, k, n),
                   "k_range_dw": picked(n, k, m)}


BIAS_SHAPES = [(128, 256, 12, 64, 256), (32, 257, 12, 64, 257),
               (128, 77, 8, 64, 77), (3, 50, 2, 256, 70), (1, 16, 1, 8, 16)]


@pytest.mark.parametrize("b,sq,n,d,sk", BIAS_SHAPES)
def test_empty_cache_gives_todays_dbias_batch_range(fresh_global, b, sq, n,
                                                    d, sk):
    q = torch.empty((b, sq, n, d), dtype=torch.bfloat16)
    kv = torch.empty((b, sk, n, d), dtype=torch.bfloat16)
    assert fa.tuned_batch_range(q, kv, kv, H100_SMS) == \
        fa.dbias_batch_range(b, n, sq, sk, d, H100_SMS)


#: (rows, F, dtype, register body) at the train, text and odd shapes
LN_CASES = [(32768, 768, torch.bfloat16, True),
            (8192, 768, torch.float32, True),
            (8192, 3000, torch.bfloat16, False),
            (100, 33, torch.float32, False),
            (7, 768, torch.bfloat16, True)]


@pytest.mark.parametrize("rows,f,dtype,register", LN_CASES)
def test_empty_cache_gives_the_ln_grid_rule(fresh_global, rows, f, dtype,
                                            register):
    """The rule the C entry applies (`csrc/layer_norm_bwd.cu` ``grid``),
    stated in Python: the register body one CTA for every eight rows up to
    the card's resident CTAs, the CTA body eight CTAs an SM up to one a
    row; an empty cache resolves the backward's CTAs to it."""
    resident = 8 * H100_SMS
    x = torch.empty((rows, f), dtype=dtype)
    assert (ln.backward_body(x, x[0], x) == "register") == register
    rule = ln.bwd_grid_rule(rows, f, dtype, register=register, sms=H100_SMS,
                            resident=resident)
    want = (min(-(-rows // 8), resident) if register
            else min(rows, 8 * H100_SMS))
    assert rule == want
    assert ln.tuned_bwd_ctas(x, lambda: rule) == rule
    if not register:
        with pytest.raises(ValueError, match="register body"):
            ln.bwd_grid_rule(rows, f, dtype, register=True, sms=H100_SMS,
                             resident=resident)


def test_a_record_wins_over_the_heuristics(fresh_global):
    x, w = torch.empty((64, 256)), torch.empty((48, 256))
    q = torch.empty((8, 16, 2, 8))
    rec = {"k_range_fwd": 128, "k_range_dx": 128, "k_range_dw": 128}
    fresh_global.put(api._key_for("fp8_matmul", (x.shape, w.shape),
                                  (x.dtype, w.dtype), x.device), rec)
    fresh_global.put(api._key_for("flash_attention_bias",
                                  (q.shape,) * 3, (q.dtype,) * 3, q.device),
                     {"batch_range": 3})
    fresh_global.put(api._key_for("layer_norm", (x.shape,), (x.dtype,),
                                  x.device), {"ctas": 5})
    assert fp8.tuned_k_ranges(x, w, H100_SMS) == rec
    assert fa.tuned_batch_range(q, q, q, H100_SMS) == 3
    assert ln.tuned_bwd_ctas(x, lambda: 1) == 5


# -- spaces ----------------------------------------------------------------

def test_spaces_stay_inside_the_kernels_limits():
    lns = space.ln_space(((100, 768),), (), default={"ctas": 13},
                         sms=H100_SMS)
    assert lns[0] == {"ctas": 13}
    assert all(1 <= c["ctas"] <= 100 for c in lns)
    bias = space.bias_space(((12, 256, 12, 64),) * 3, (),
                            default={"batch_range": 3}, sms=H100_SMS)
    assert bias[0] == {"batch_range": 3}
    # 12 samples cut into 1, 2, 4 and 8 ranges
    assert {c["batch_range"] for c in bias} == {3, 12, 6, 2}
    default = fp8.default_k_ranges(32768, 3072, 768, H100_SMS)
    cands = space.fp8_space(((32768, 768), (3072, 768)), (), default=default,
                            sms=H100_SMS)
    assert cands[0] == default
    extents = {"k_range_fwd": 768, "k_range_dx": 3072, "k_range_dw": 32768}
    for c in cands:
        assert sum(c[key] != default[key] for key in c) <= 1
        for key, length in c.items():
            assert length % 128 == 0
            assert 128 <= length <= -(-extents[key] // 128) * 128
    assert [c["block_n"] for c in space.retrieval_space(
        ((64, 768), (1000, 768)))] == [128, 256, 512, 1024]
    assert [c["block_n"] for c in space.retrieval_space(
        ((1, 8), (5, 8)))] == [128]


@pytest.mark.parametrize("n_rows", [5, 200, 1000, 4096])
def test_retrieval_default_is_jaxs_rule(n_rows):
    """The port's rule (the largest feasible block under the temporaries'
    cap) is JAX's ``_retrieval_default`` wherever the corpus fits in JAX's
    1024-row block; past it, a batch of 64 scans the corpus in one block
    (JAX's rule stays at 1024, a compiled ``lax.scan``'s size)."""
    shapes = [(64, 16), (n_rows, 16)]
    ours = api._retrieval_default(shapes, ["float32"], "cpu")
    if n_rows <= 1024:
        assert ours == jax_api._retrieval_default(shapes, [np.float32])
    else:
        assert ours == {"block_n": n_rows}


def test_retrieval_default_keeps_the_temporaries_under_the_cap():
    cap, per = space.RETRIEVAL_TEMP_BYTES, space.RETRIEVAL_BYTES_A_SCORE
    for batch, want in ((64, 65536), (8, 262144), (1, 262144),
                        (4096, 1024), (10 ** 6, 128)):
        shapes = [(batch, 768), (262240, 768)]
        got = api._retrieval_default(shapes, ["float32"], "cpu")["block_n"]
        assert got == want, batch
        assert got in [c["block_n"] for c in space.retrieval_space(shapes)]
        assert batch * got * per <= cap or got == 128


def test_compiled_tile_kernels_have_one_candidate():
    for kernel in ("flash_attention", "flash_attention_masked",
                   "sigmoid_attention", "ring_attention",
                   "flash_attention_int8"):
        spec = api.KERNELS[kernel]
        shapes = ((2, 256, 12, 64),) * 3
        default = spec.default(shapes, ("bfloat16",) * 3, "cpu")
        assert default == {"block_q": 64, "block_k": 64}
        assert spec.space(shapes, (), default=default, sms=H100_SMS) == [
            default]
    assert space.compiled_tile("int8_matmul", ((8192, 768),)) == {
        "block_m": 128, "block_n": 128}
    assert space.compiled_tile("int8_matmul", ((32, 768),))["block_m"] == 64


# -- the CLI ---------------------------------------------------------------

def _run(argv, capsys) -> dict:
    assert tune_cli.main(argv) == 0
    return json.loads(capsys.readouterr().out)


def test_tune_run_then_hits_and_ls_fields(tmp_path, capsys):
    store = str(tmp_path / "store")
    argv = ["tune", "run", "--store", store, "--device", "cpu"]
    points = [("layer_norm", "64x32"), ("flash_attention_bias",
                                        "2x16x2x8,2x16x2x8,2x16x2x8"),
              ("fp8_matmul", "64x32,48x32"), ("retrieval_topk",
                                              "4x16,1000x16"),
              ("flash_attention", "2x16x2x8,2x16x2x8,2x16x2x8")]
    first = []
    before = counters()
    for kernel, shapes in points:
        out = _run(argv + ["--kernel", kernel, "--shapes", shapes], capsys)
        row = out["tuned"][0]
        assert row["source"] == "measured" and row["kernel"] == kernel
        assert row["time_s"] <= row["default_time_s"]
        first.append(row)
    measured = delta(before, counters(), "jimm_tune_measure_total")
    assert measured == sum(r["candidates"] for r in first)
    # the same commands again: hits only, nothing measured
    before = counters()
    for (kernel, shapes), row in zip(points, first):
        again = _run(argv + ["--kernel", kernel, "--shapes", shapes],
                     capsys)["tuned"][0]
        assert again["source"] == "hit"
        assert again["config"] == row["config"]
        assert again["default_time_s"] == row["default_time_s"]
    assert delta(before, counters(), "jimm_tune_measure_total") == 0
    rows = _run(["tune", "ls", "--store", store, "--json"], capsys)
    assert len(rows) == len(points)
    assert set(rows[0]) == {"fingerprint", "kernel", "shapes", "dtypes",
                            "device", "torch", "kernels", "last_used"}
    assert {r["kernel"] for r in rows} == {p[0] for p in points}
    assert all(r["device"] == "cpu" and r["torch"] == torch.__version__
               for r in rows)
    assert tune_cli.main(["tune", "ls", "--store", store]) == 0
    assert f"total: {len(points)} entries" in capsys.readouterr().out


def test_tune_run_refuses_the_waiting_kernels(tmp_path):
    for kernel in ("retrieval_ivf", "retrieval_tier"):
        with pytest.raises(SystemExit, match="ROADMAP.md queue 1 item 9"):
            tune_cli.main(["tune", "run", "--store", str(tmp_path),
                           "--device", "cpu", "--kernel", kernel,
                           "--shapes", "1x8,64x8"])


def test_preset_points_key_like_the_hot_path():
    pts = tune_cli._preset_points("siglip-base-patch16-256", 128, "bfloat16")
    ln_pts = [p for p in pts if p["kernel"] == "layer_norm"]
    fp8_pts = [p for p in pts if p["kernel"] == "fp8_matmul"]
    # the vision tower (256 tokens) and the text tower (64): LN and the
    # q/k/v/out, fc1 and fc2 GEMMs of each
    assert [p["shapes"] for p in ln_pts] == [[(32768, 768)], [(8192, 768)]]
    assert [(32768, 768), (3072, 768)] in [p["shapes"] for p in fp8_pts]
    assert [(32768, 3072), (768, 3072)] in [p["shapes"] for p in fp8_pts]
    assert len(fp8_pts) == 6
    # one dtype an operand, as the wrappers key them
    x, w = torch.empty((32768, 768)), torch.empty((3072, 768))
    cli_key = api._key_for("fp8_matmul", fp8_pts[1]["shapes"],
                           fp8_pts[1]["dtypes"], "cpu")
    hot_key = api._key_for("fp8_matmul", (x.shape, w.shape),
                           (torch.bfloat16, torch.bfloat16), x.device)
    assert cli_key.fingerprint() == hot_key.fingerprint()


def test_serve_tune_cache_points_the_process_cache(monkeypatch, tmp_path):
    from jimm_tpu_torch import cli
    monkeypatch.setattr(api, "_cache", None)
    args = cli.build_parser().parse_args(
        ["serve", "--tiny", "--device", "cpu", "--port", "0", "--buckets",
         "1", "--tune-cache", str(tmp_path / "tc")])
    server, _, _ = cli.build_server(args)
    try:
        assert tune.get_cache().root == tmp_path / "tc"
    finally:
        server.stop()
