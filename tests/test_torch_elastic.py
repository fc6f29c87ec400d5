"""Elastic training: the port's ``resilience/elastic.py`` against the JAX
package's, ``train --max-devices`` and ``supervise --elastic
--shrink-plan --adapt`` over two gloo ranks.

``plan_data_axis`` and ``GoodputAdvisor`` are fed JAX's own cases
(``tests/test_elastic.py``) in both packages: the same widths and errors,
the same decisions, audit lines, journal events and counts. The shrink
drill of ``tests/test_failure_recovery.py``: a tiny ViT saved every step
at ``data=2`` and crashed at step 2 resumes as ``--mesh data=1
--max-devices 1`` (rank 1 takes no step and waits for the outcome); its
steps 3-5 give the JAX control's losses at ``data=2`` (rtol 1e-5) and
its batch fingerprints, and the restore counts one topology change. The
supervisor drill replans from two ranks to one after the crash on both
ranks alike (the same restarts, replans and advisor decisions on each),
and its ``resilience:`` line carries the JAX command's keys."""

import json

import numpy as np
import pytest

from jimm_tpu import cli as jax_cli
from jimm_tpu import obs as jax_obs
from jimm_tpu.resilience import elastic as jax_elastic
from jimm_tpu_torch import cli, obs
from jimm_tpu_torch.resilience import elastic
import torch_parallel_cases as cases
from test_torch_data_train import jax_start, read_metrics
from torch_rank_pool import RankPool

PRESET = "vit-base-patch16-224"
SEED = 7
COMMON = ["train", "--preset", PRESET, "--tiny", "--batch-size", "4",
          "--steps", "6", "--save-every", "1", "--log-every", "0", "--seed",
          str(SEED)]
LOSS_RTOL = 1e-5


# -- the planner and the advisor, as JAX's -----------------------------------------

@pytest.mark.parametrize("n_devices,batch", [
    (8, 8), (4, 8), (8, 4), (6, 8), (3, 8), (1, 8), (5, 7), (0, 8), (4, 0)])
def test_plan_data_axis_is_jaxs(n_devices, batch):
    def plan(mod):
        try:
            return mod.plan_data_axis(n_devices, batch)
        except ValueError as e:
            return str(e)
    assert plan(elastic) == plan(jax_elastic)


#: tests/test_elastic.py's advisor cases: the advisor's settings, its
#: knobs, and the observations it is fed
ADVISOR_CASES = {
    "healthy": ({"window": 2, "cooldown": 0}, None,
                [{"step": 9.0, "checkpoint": 0.2}] * 4),
    "lost_work": ({"window": 2, "cooldown": 0}, None,
                  [{"lost_work": 3.0, "step": 6.0}]),
    "grace_steps": ({"window": 1, "cooldown": 0},
                    {"save_every": 1, "grace_steps": 1},
                    [{"lost_work": 3.0}]),
    "cooldown": ({"window": 1, "cooldown": 1}, None,
                 [{"lost_work": 3.0}] * 3),
    "dead_band": ({"window": 1, "cooldown": 0, "lost_work_high": 0.08,
                   "checkpoint_high": 0.25}, None,
                  [{"checkpoint": 4.0, "lost_work": 0.5},
                   {"checkpoint": 4.0, "lost_work": 0.0}]),
    "compile": ({"window": 2, "cooldown": 0}, None, [{"compile": 6.0}] * 2),
    "bounds": ({"window": 1, "cooldown": 0},
               {"save_every": 2, "grace_steps": 7}, [{"lost_work": 5.0}] * 41),
}


def _advise(mod, obs_mod, kw, knobs, observations):
    lines = []
    knobs = knobs or {"save_every": 8, "grace_steps": 1, "scan_unroll": 4}
    obs_mod.reset_journal()
    counter = obs_mod.get_registry("jimm_train").counter(
        "goodput_advisor_decisions_total")
    before = counter.value
    adv = mod.GoodputAdvisor(emit=lines.append, knobs=knobs, **kw)
    decisions = [adv.observe(i, 10.0, o) for i, o in enumerate(observations)]
    events = [{k: v for k, v in e.items()
               if k not in ("seq", "ts", "mono", "cid", "pid", "host")}
              for e in obs_mod.get_journal().events()
              if e["event"] == "advisor_decision"]
    return {"decisions": decisions, "lines": lines, "knobs": adv.knobs,
            "argv": adv.argv_overrides(), "events": events,
            "counted": counter.value - before}


@pytest.mark.parametrize("case", sorted(ADVISOR_CASES))
def test_goodput_advisor_is_jaxs(case):
    kw, knobs, observations = ADVISOR_CASES[case]
    got = _advise(elastic, obs, kw, knobs, observations)
    want = _advise(jax_elastic, jax_obs, kw, knobs, observations)
    assert got == want
    if case != "healthy":
        assert got["counted"] >= 1


def test_knob_tables_are_jaxs():
    assert elastic.KNOB_BOUNDS == jax_elastic.KNOB_BOUNDS
    assert elastic.KNOB_FLAGS == jax_elastic.KNOB_FLAGS


# -- the drills over two ranks ---------------------------------------------------------

@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(2, tmp_path_factory.mktemp("ranks"), timeout=90)
    yield p
    p.close()


@pytest.fixture(scope="module")
def weights():
    return jax_start(PRESET, SEED, num_classes=4)


@pytest.fixture(scope="module")
def jax_control(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax") / "control.jsonl"
    assert jax_cli.main(COMMON + ["--batch-fingerprint", "--rules", "dp",
                                  "--mesh", "data=2", "--max-devices", "2",
                                  "--metrics-file", str(path)]) == 0
    return read_metrics(path)


def test_shrink_drill_resumes_on_one_rank(pool, tmp_path, weights,
                                          jax_control):
    ckpt = tmp_path / "ckpt"
    port = COMMON + ["--device", "cpu", "--batch-fingerprint", "--rules",
                     "dp", "--ckpt-dir", str(ckpt)]
    res = pool.run(cases.cli_outcome, port + [
        "--mesh", "data=2", "--inject-faults", "crash@2", "--metrics-file",
        str(tmp_path / "crashed.jsonl")], weights)
    assert [r["error"] for r in res] == ["RuntimeError"] * 2
    assert all("injected failure at step 2" in r["message"] for r in res)
    path = tmp_path / "resumed.jsonl"
    res = pool.run(cases.cli_outcome, port + [
        "--mesh", "data=1", "--max-devices", "1", "--resume",
        "--metrics-file", str(path)], weights)
    assert [(r["error"], r["topology_changes"]) for r in res] == \
        [(None, 1), (None, 0)]
    resumed = read_metrics(path)
    assert sorted(resumed) == [3, 4, 5]
    for step in (3, 4, 5):
        np.testing.assert_allclose(resumed[step]["loss"],
                                   jax_control[step]["loss"],
                                   rtol=LOSS_RTOL, err_msg=f"step {step}")
        assert resumed[step]["batch_fingerprint"] == \
            jax_control[step]["batch_fingerprint"], step
    # the resumed run saves on its own mesh
    saved = json.loads((ckpt / "5" / "checkpoint.json").read_text())
    assert saved["mesh"] == {"axes": {"data": 1}, "n_devices": 1}


def test_max_devices_is_checked_as_jax_checks_it(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    for n in ("0", "3"):
        with pytest.raises(SystemExit, match=rf"--max-devices {n} out of "
                           r"range \(1\.\.2 visible\)"):
            cli.main(COMMON + ["--device", "cpu", "--mesh", "data=1",
                               "--max-devices", n])
    assert not cli.torch.distributed.is_initialized()


def test_idle_ranks_outwait_the_collective_timeout(tmp_path):
    """Rank 0 trains an attempt longer than the group's collective timeout
    (a stall of 8 s against 4 s) while rank 1, left out by --max-devices,
    waits for its outcome: the wait is on the outcome group, and both
    ranks return."""
    p = RankPool(2, tmp_path, timeout=90, dist_timeout_s=4)
    try:
        res = p.run(cases.cli_outcome, [
            "train", "--preset", PRESET, "--tiny", "--batch-size", "4",
            "--steps", "2", "--log-every", "0", "--device", "cpu",
            "--mesh", "data=1", "--max-devices", "1", "--inject-faults",
            "stall@0:8"])
    finally:
        p.close()
    assert [(r["error"], r["rc"]) for r in res] == [(None, 0), (None, 0)]


def _resilience(out: str) -> dict:
    line = [ln for ln in out.splitlines() if ln.startswith("resilience: ")]
    return json.loads(line[-1].split("resilience: ")[1])


DRILL = ["--max-restarts", "2", "--backoff-base-s", "0.01", "--seed", "0",
         "--elastic", "--shrink-plan", "2,1", "--adapt", "--"]


def test_elastic_supervise_replans_every_rank_alike(pool, tmp_path, weights,
                                                    capsys):
    jax_out = tmp_path / "jax"
    assert jax_cli.main(["supervise", *DRILL, *COMMON, "--ckpt-dir",
                         str(jax_out), "--inject-faults", "crash@2"]) == 0
    want = capsys.readouterr().out
    res = pool.run(cases.supervise, DRILL + COMMON + [
        "--device", "cpu", "--ckpt-dir", str(tmp_path / "ckpt"),
        "--inject-faults", "crash@2", "--metrics-file",
        str(tmp_path / "m.jsonl")], weights)
    assert [r["rc"] for r in res] == [0, 0]
    got = _resilience(res[0]["stdout"])
    assert list(got) == list(_resilience(want))
    assert "resilience: " not in res[1]["stdout"]  # rank 0 reports
    for key in ("jimm_train_restarts_total",
                "jimm_train_topology_changes_total"):
        assert [r["counted"].get(key) for r in res] == [1.0, 1.0], key
    assert got["jimm_train_checkpoint_topology_changes_total"] >= 1
    decisions = "jimm_train_goodput_advisor_decisions_total"
    assert res[0]["counted"].get(decisions, 0) == \
        res[1]["counted"].get(decisions, 0)
    for line in ("[supervise] attempt 1 failed (RuntimeError: injected "
                 "failure at step 2",
                 "[supervise] attempt 2: replanned mesh data=2 -> data=1 "
                 "(1 devices available)"):
        assert line in want and line in res[0]["stdout"], line
    assert sorted(read_metrics(tmp_path / "m.jsonl")) == list(range(6))
