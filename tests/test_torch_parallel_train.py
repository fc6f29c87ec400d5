"""``train --mesh`` over two gloo ranks against the JAX CLI at the same
mesh: ``--mesh data=2 --rules dp`` (the ``siglip_ring`` loss by default)
and ``--rules fsdp`` (FSDP2) give the JAX command's losses for a tiny
SigLIP-B/16-256 started from its weights, at ``tests/test_torch_train.py``'s
rtol 1e-5 for a contrastive step. A two-rank ``fsdp`` run saving every
step, cut back to its step 1 (as if it had stopped there), resumed as
``data=1`` (one rank, in this process) gives the run's own steps 2-3
(rtol 1e-5: the two layouts sum the batch's gradients in another order)
and counts one topology change. Under ``dp`` and ``fsdp`` each parameter
is laid out by its spec in the table of logical names. Without dropout: the ranks' dropout
streams differ."""

import json
import shutil

import numpy as np
import pytest

from jimm_tpu import cli as jax_cli
from jimm_tpu_torch import cli, obs
import torch_parallel_cases as cases
from test_torch_data_train import jax_start, port_cli_from, read_metrics
from torch_rank_pool import RankPool

PRESET = "siglip-base-patch16-256"
SEED = 3
LOSS_RTOL = 1e-5


def _argv(*extra) -> list[str]:
    return ["train", "--preset", PRESET, "--tiny", "--batch-size", "4",
            "--log-every", "0", "--seed", str(SEED), *extra]


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    # every call has the pool's timeout (60 s)
    p = RankPool(2, tmp_path_factory.mktemp("ranks"), timeout=60)
    yield p
    p.close()


@pytest.fixture(scope="module")
def weights():
    return jax_start(PRESET, SEED)


@pytest.fixture(scope="module")
def jax_losses(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax") / "jax.jsonl"
    assert jax_cli.main(_argv("--steps", "2", "--mesh", "data=2",
                              "--max-devices", "2", "--rules", "dp",
                              "--metrics-file", str(path))) == 0
    return [read_metrics(path)[s]["loss"] for s in range(2)]


@pytest.mark.parametrize("preset_name", [PRESET, "vit-base-patch16-224"])
@pytest.mark.parametrize("rules", ["dp", "fsdp"])
def test_parameters_are_laid_out_by_their_specs(pool, preset_name, rules):
    # the table of logical names is the layout: FSDP2 shards a parameter
    # on the dimension its spec puts on 'data', and every other parameter
    # stays whole, its gradient averaged by finish_gradients
    for got in pool.run(cases.fsdp_layout, preset_name, rules):
        want = {n: next((d for d, a in enumerate(spec) if a == "data"),
                        None) for n, spec in got["specs"].items()}
        assert got["dims"] == want
        assert got["averaged"] == [n for n, d in want.items() if d is None]
        if rules == "fsdp":
            assert {1, 2} <= set(want.values())  # not FSDP2's default dim 0
        # the foreach AdamW on the card refuses a group that mixes shards
        # with whole parameters of more than 0 dimensions
        assert all(0 in g for g in got["groups"])
        assert sum(map(sum, got["groups"])) == len(want)


def _port(pool, tmp_path, weights, name, *extra) -> list[float]:
    path = tmp_path / f"{name}.jsonl"
    res = pool.run(cases.train_cli, _argv(
        "--device", "cpu", "--metrics-file", str(path), *extra), weights)
    assert [r["rc"] for r in res] == [0, 0]
    rows = read_metrics(path)
    return [rows[s]["loss"] for s in sorted(rows)]


@pytest.mark.parametrize("rules", ["dp", "fsdp"])
def test_mesh_losses_match_the_jax_cli(pool, tmp_path, weights, jax_losses,
                                       rules):
    got = _port(pool, tmp_path, weights, rules, "--steps", "2", "--mesh",
                "data=2", "--rules", rules)
    np.testing.assert_allclose(got, jax_losses, rtol=LOSS_RTOL)


def test_fsdp_checkpoint_resumes_on_one_rank(pool, tmp_path, weights,
                                             monkeypatch):
    ckpt = tmp_path / "ckpt"
    whole = _port(pool, tmp_path, weights, "whole", "--steps", "4",
                  "--mesh", "data=2", "--rules", "fsdp", "--ckpt-dir",
                  str(ckpt), "--save-every", "1")
    run = json.loads((ckpt / "1" / "checkpoint.json").read_text())
    assert run["mesh"] == {"axes": {"data": 2}, "n_devices": 2}
    # as if the run had stopped after step 1's save
    for step in ("2", "3"):
        shutil.rmtree(ckpt / step)
        (ckpt / ".jimm_markers" / step).unlink()
    topology = obs.get_registry("jimm_train").counter(
        "checkpoint_topology_changes_total")
    before = topology.value
    port_cli = port_cli_from(monkeypatch, weights, PRESET)
    path = tmp_path / "resumed.jsonl"
    assert port_cli(_argv("--device", "cpu", "--steps", "4", "--mesh",
                          "data=1", "--rules", "fsdp", "--ckpt-dir",
                          str(ckpt), "--save-every", "1", "--resume",
                          "--metrics-file",
                          str(path))) == 0
    resumed = read_metrics(path)
    assert sorted(resumed) == [2, 3]
    np.testing.assert_allclose([resumed[2]["loss"], resumed[3]["loss"]],
                               whole[2:], rtol=LOSS_RTOL)
    assert topology.value - before == 1
    assert not cli.torch.distributed.is_initialized()


def test_a_preemption_of_rank_0_saves_every_rank_at_one_step(pool, tmp_path,
                                                             weights):
    # the signal reaches rank 0 alone; the step-end agreement takes it to
    # rank 1, and both save step 2 and stop
    ckpt = tmp_path / "ckpt"
    base = ["--steps", "5", "--device", "cpu", "--mesh", "data=2",
            "--ckpt-dir", str(ckpt), "--save-every", "100"]
    res = pool.run(cases.cli_outcome, _argv(
        *base, "--preemption-save", "--grace-steps", "0", "--inject-faults",
        "preempt@2", "--metrics-file", str(tmp_path / "cut.jsonl")), weights)
    assert [(r["error"], r["step"]) for r in res] == \
        [("PreemptedError", 2)] * 2
    assert sorted(int(p.name) for p in (ckpt / ".jimm_markers").iterdir()) \
        == [0, 2]
    res = pool.run(cases.cli_outcome, _argv(
        *base, "--resume", "--metrics-file",
        str(tmp_path / "resumed.jsonl")), weights)
    assert [r["error"] for r in res] == [None, None]
    control = _port(pool, tmp_path, weights, "control", "--steps", "5",
                    "--mesh", "data=2")
    resumed = read_metrics(tmp_path / "resumed.jsonl")
    assert sorted(resumed) == [3, 4]
    assert [resumed[3]["loss"], resumed[4]["loss"]] == control[3:]


def test_profilers_record_every_rank(pool, tmp_path, weights, capsys):
    prof, ring = tmp_path / "prof", tmp_path / "ring"
    _port(pool, tmp_path, weights, "profiled", "--steps", "5", "--mesh",
          "data=2", "--profile-dir", str(prof), "--prof-ring", str(ring),
          "--prof-every", "2", "--prof-window", "1")
    for rank in ("rank0", "rank1"):
        assert list((prof / rank).glob("**/*.trace.json.gz")), rank
        assert list((ring / rank).glob("**/*.trace.json.gz")), rank
    assert cli.main(["profile-analyze", str(prof)]) == 0
    out = capsys.readouterr().out
    assert out.index("rank0:") < out.index("rank1:")
    # each rank's trace holds its three profiled steps
    assert out.count("inside its 3 train_step ranges") == 2
