"""The port's hub downloads (``jimm_tpu_torch.weights.resolve``) against
the JAX package's, through download doubles only (nothing here reaches a
network): ``_hub_download_with_retry`` makes the same calls and sleeps in
every scenario of ``tests/test_hub_retry.py``, and ``_from_hub`` asks for
the same files in the same order (the sharded index, then the single
file, then the other format) and returns the same tensors, exactly."""

import json
import sys
import types

import numpy as np
import pytest
import torch

from jimm_tpu.weights import resolve as jax_resolve
from jimm_tpu_torch import cli, configs
from jimm_tpu_torch.models.vit import VisionTransformer
from jimm_tpu_torch.weights import resolve
from jimm_tpu_torch.weights.safetensors_io import save_file
from test_hub_retry import EntryNotFoundError, FlakyHub


class CachedHub(FlakyHub):
    """Network down, a cached copy on disk."""

    def __call__(self, repo_id, filename, local_files_only=False):
        self.calls.append({"filename": filename,
                           "local_files_only": local_files_only})
        if local_files_only:
            return f"/cache/{filename}"
        raise ConnectionError("network down")


class GatedRepoError(Exception):
    """Name-matched stand-in for huggingface_hub's class."""


SCENARIOS = {
    "two_transient_then_ok": (lambda: FlakyHub(fail_times=2),
                              dict(retries=3, backoff_s=0.5)),
    "transient_past_the_budget": (lambda: FlakyHub(fail_times=5),
                                  dict(retries=3, backoff_s=0.25)),
    "not_found_never_retries": (
        lambda: FlakyHub(exc=EntryNotFoundError("no such file")),
        dict(retries=5, backoff_s=1.0)),
    "gated_never_retries": (lambda: FlakyHub(exc=GatedRepoError("gated")),
                            dict(retries=5, backoff_s=1.0)),
    "file_not_found_never_retries": (
        lambda: FlakyHub(exc=FileNotFoundError("gone")),
        dict(retries=2, backoff_s=1.0)),
    "offline_uncached": (lambda: FlakyHub(exc=ConnectionError("down")),
                         dict(retries=2, backoff_s=0.0)),
    "timeouts": (lambda: FlakyHub(exc=TimeoutError("slow")),
                 dict(retries=4, backoff_s=0.1)),
    "offline_cached": (CachedHub, dict(retries=2, backoff_s=0.0)),
    "zero_retries_is_one_try": (lambda: FlakyHub(fail_times=1),
                                dict(retries=0, backoff_s=0.5)),
}


def _run(module, make_hub, kwargs):
    hub, slept = make_hub(), []
    try:
        out = module._hub_download_with_retry(
            hub, "org/repo", "model.safetensors", sleep=slept.append,
            **kwargs)
        error = None
    except Exception as e:  # noqa: BLE001 -- compared below
        out, error = None, (type(e).__name__, str(e))
    return out, error, hub.calls, slept


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_retry_makes_the_same_calls_and_sleeps(name):
    make_hub, kwargs = SCENARIOS[name]
    assert _run(resolve, make_hub, kwargs) == \
        _run(jax_resolve, make_hub, kwargs)


@pytest.mark.parametrize("retries,backoff", [("1", "0"), ("4", "0.125"),
                                             (None, None)])
def test_retry_env_defaults_match(monkeypatch, retries, backoff):
    for var, value in (("JIMM_HUB_RETRIES", retries),
                       ("JIMM_HUB_BACKOFF_S", backoff)):
        if value is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, value)
    got = _run(resolve, lambda: FlakyHub(fail_times=9), {})
    assert got == _run(jax_resolve, lambda: FlakyHub(fail_times=9), {})
    if retries is None:  # 3 tries at 0.5 s doubling, then the cache
        assert got[3] == [0.5, 1.0] and len(got[2]) == 4


@pytest.mark.parametrize("exc,want", [
    (EntryNotFoundError("x"), False), (GatedRepoError("x"), False),
    (FileNotFoundError("x"), False), (ConnectionError("x"), True),
    (TimeoutError("x"), True), (OSError("x"), True)])
def test_retryable_matches(exc, want):
    assert resolve._retryable(exc) == jax_resolve._retryable(exc) == want


class ServingHub:
    """``hf_hub_download`` over a directory: a file that is there is served
    (its path), any other is the hub's EntryNotFoundError. Records the
    filenames asked for."""

    def __init__(self, root):
        self.root = root
        self.asked = []

    def __call__(self, repo_id, filename, local_files_only=False):
        self.asked.append((repo_id, filename, local_files_only))
        path = self.root / filename
        if not path.is_file():
            raise EntryNotFoundError(f"{repo_id}/{filename}")
        return str(path)


def _tensors():
    rng = np.random.default_rng(0)
    return {"a.weight": rng.standard_normal((3, 4)).astype(np.float32),
            "b.bias": rng.standard_normal(4).astype(np.float32),
            "c.weight": rng.standard_normal((2, 2)).astype(np.float32)}


def _write(root, layout):
    root.mkdir(parents=True, exist_ok=True)
    tensors = {k: torch.from_numpy(v) for k, v in _tensors().items()}
    if "sharded" in layout:
        shards = {"model-00001-of-00002.safetensors": ["a.weight"],
                  "model-00002-of-00002.safetensors": ["b.bias",
                                                       "c.weight"]}
        for shard, keys in shards.items():
            save_file({k: tensors[k] for k in keys}, root / shard)
        (root / "model.safetensors.index.json").write_text(json.dumps(
            {"weight_map": {k: s for s, keys in shards.items()
                            for k in keys}}))
    if "single" in layout:
        save_file(tensors, root / "model.safetensors")
    if "bin" in layout:
        torch.save(tensors, root / "pytorch_model.bin")
    if "config" in layout:
        (root / "config.json").write_text(json.dumps({"model_type": "toy"}))


def _fake_hub(monkeypatch, hub):
    fake = types.ModuleType("huggingface_hub")
    fake.hf_hub_download = hub
    monkeypatch.setitem(sys.modules, "huggingface_hub", fake)


@pytest.mark.parametrize("layout,use_pytorch", [
    (("sharded", "config"), False), (("single", "config"), False),
    (("single",), False), (("bin", "config"), False),
    (("single", "bin", "config"), True), (("sharded", "bin"), True),
    (("bin",), True), ((), False)])
def test_from_hub_fetches_what_jax_fetches(tmp_path, monkeypatch, layout,
                                           use_pytorch):
    _write(tmp_path / "repo", layout)
    monkeypatch.setenv("JIMM_HUB_RETRIES", "1")
    results = []
    for module in (resolve, jax_resolve):
        hub = ServingHub(tmp_path / "repo")
        _fake_hub(monkeypatch, hub)
        try:
            weights, config = module.resolve_checkpoint(
                "org/repo", use_pytorch=use_pytorch)
            out = ({k: np.asarray(v) for k, v in weights.items()}, config)
        except FileNotFoundError as e:
            out = str(e).split(": ")[0]
        results.append((out, hub.asked))
    (got, got_asked), (want, want_asked) = results
    assert got_asked == want_asked
    if isinstance(want, str):
        assert got == want == ("could not fetch 'org/repo' from the HF hub "
                               "(offline, or repo has neither format?)")
        return
    assert got[1] == want[1] == ({"model_type": "toy"} if "config" in layout
                                 else None)
    assert sorted(got[0]) == sorted(want[0]) == sorted(_tensors())
    for key, arr in _tensors().items():
        np.testing.assert_array_equal(got[0][key], arr)
        np.testing.assert_array_equal(want[0][key], arr)


def test_without_huggingface_hub_the_error_matches(monkeypatch):
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    errors = []
    for module in (resolve, jax_resolve):
        with pytest.raises(FileNotFoundError) as e:
            module.resolve_checkpoint("org/model")
        errors.append(str(e.value))
    assert errors[0] == errors[1] == ("'org/model' is not a local path and "
                                      "huggingface_hub is unavailable")


def test_train_fine_tunes_from_a_hub_name(tmp_path, monkeypatch, capsys):
    """``train --from-pretrained org/name`` reaches the hub path (served by
    the double from a checkpoint written under tmp_path)."""
    cfg = cli.tiny_override(configs.preset("vit-base-patch16-224"))
    VisionTransformer(cfg, device="cpu").save_pretrained(tmp_path / "repo")
    hub = ServingHub(tmp_path / "repo")
    _fake_hub(monkeypatch, hub)
    rc = cli.main(["train", "--device", "cpu", "--preset",
                   "vit-base-patch16-224", "--from-pretrained",
                   "org/tiny-vit", "--steps", "1", "--batch-size", "2",
                   "--num-classes", "3"])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert summary["model"] == "vit:org/tiny-vit"
    assert summary["fresh_head"] is True
    assert [f for _, f, _ in hub.asked] == [
        "model.safetensors.index.json", "model.safetensors", "config.json"]
