"""The port's ``train --ckpt-dir/--resume``, fault drills, ``supervise``,
``evaluate --preset --ckpt-dir`` and ``export-run`` on the CPU: the three
drills of ``tests/test_resilience.py`` with its ``COMMON`` (a tiny
ViT-B/16, batch 4, 6 steps, a save every step, seed 7), each resumed run
bit for bit equal to the port's uninterrupted control run (losses and
batch fingerprints), and that control run held to one JAX control run of
the same ``COMMON`` from the same initial weights: losses at rtol 1e-5
(``tests/test_torch_train_rest.py``'s tolerance for the classifier step),
batch fingerprints exactly. A run's directory records its architecture,
which ``evaluate`` and ``export-run`` read, and a checkpoint that does not
fit is refused without touching a step."""

import hashlib
import json
import threading
import time
import warnings

import numpy as np
import pytest
import torch
from flax import nnx

from jimm_tpu import cli as jax_cli
from jimm_tpu import preset as jax_preset
from jimm_tpu_torch import cli, obs
from jimm_tpu_torch.data import records
from jimm_tpu_torch.models.common import load_jax_params
from jimm_tpu_torch.models.siglip import SigLIP
from jimm_tpu_torch.models.vit import VisionTransformer
from jimm_tpu_torch.weights.safetensors_io import load_file
from jimm_tpu_torch.train import checkpoint
from jimm_tpu_torch.train.checkpoint import CheckpointManager
from test_torch_siglip import jax_params

COMMON = ["train", "--preset", "vit-base-patch16-224", "--tiny",
          "--batch-size", "4", "--steps", "6", "--save-every", "1",
          "--log-every", "0", "--seed", "7"]
PORT = COMMON + ["--device", "cpu"]
#: the loss tolerance of the port's classifier step against JAX's
LOSS_RTOL = 1e-5


def read_metrics(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def by_step(records_):
    return {r["step"]: r for r in records_}


@pytest.fixture(scope="module")
def jax_weights():
    """The tiny ViT the JAX ``train`` command of ``COMMON`` starts from:
    its preset shrunk by ``--tiny``, 4 classes, ``nnx.Rngs(7)``."""
    import dataclasses
    cfg = dataclasses.replace(
        jax_cli._tiny_override(jax_preset("vit-base-patch16-224")),
        num_classes=4)
    return jax_params(jax_cli._model_cls("vit")(cfg, rngs=nnx.Rngs(7)))


@pytest.fixture()
def port_cli(monkeypatch, jax_weights):
    """The port's CLI with ``COMMON``'s model started from the JAX
    command's initial weights (the two packages seed differently)."""
    real = cli.build_run_model

    def from_jax_weights(spec, *a, **kw):
        model, fresh = real(spec, *a, **kw)
        if (spec["tiny"], spec["preset"], spec["num_classes"]) == \
                (True, "vit-base-patch16-224", 4):
            load_jax_params(model, jax_weights)
        return model, fresh

    monkeypatch.setattr(cli, "build_run_model", from_jax_weights)
    monkeypatch.delenv("JIMM_JOURNAL", raising=False)
    obs.reset_journal()
    yield cli.main
    obs.reset_journal()


@pytest.fixture(scope="module")
def jax_control(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax") / "control.jsonl"
    assert jax_cli.main(COMMON + ["--metrics-file", str(path),
                                  "--batch-fingerprint"]) == 0
    return by_step(read_metrics(path))


@pytest.fixture()
def control(port_cli, tmp_path):
    """The port's uninterrupted run, with checkpoints (its newest
    parameters are compared too)."""
    path = tmp_path / "control.jsonl"
    assert port_cli(PORT + ["--metrics-file", str(path),
                            "--batch-fingerprint",
                            "--ckpt-dir", str(tmp_path / "control")]) == 0
    return by_step(read_metrics(path))


def _sha(path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def _same_as_control(got: dict, control: dict, steps) -> None:
    assert sorted(got) == list(steps)
    for step in steps:
        assert got[step]["loss"] == control[step]["loss"], step
        assert got[step]["batch_fingerprint"] == \
            control[step]["batch_fingerprint"], step


def test_control_matches_jax(control, jax_control):
    assert sorted(control) == sorted(jax_control) == list(range(6))
    for step in range(6):
        np.testing.assert_allclose(control[step]["loss"],
                                   jax_control[step]["loss"],
                                   rtol=LOSS_RTOL, err_msg=f"step {step}")
        assert control[step]["batch_fingerprint"] == \
            jax_control[step]["batch_fingerprint"], step


def test_corrupt_checkpoint_quarantined_and_resume_falls_back(
        port_cli, control, tmp_path):
    ckpt = tmp_path / "ckpt"
    crashed = tmp_path / "crashed.jsonl"
    with pytest.raises(RuntimeError, match="injected failure at step 2"):
        port_cli(PORT + ["--ckpt-dir", str(ckpt), "--batch-fingerprint",
                         "--metrics-file", str(crashed),
                         "--inject-faults", "corrupt@2,crash@2"])
    assert sorted(by_step(read_metrics(crashed))) == [0, 1, 2]
    resumed = tmp_path / "resumed.jsonl"
    with pytest.warns(RuntimeWarning, match="quarantined"):
        assert port_cli(PORT + ["--ckpt-dir", str(ckpt), "--resume",
                                "--batch-fingerprint",
                                "--metrics-file", str(resumed)]) == 0
    # step 2's checkpoint was corrupted: the run falls back to step 1 and
    # trains steps 2-5 again
    _same_as_control(by_step(read_metrics(resumed)), control, range(2, 6))
    qdir = ckpt / ".quarantine" / "2"
    assert qdir.is_dir()
    assert (qdir / ".jimm_quarantine_reason.txt").read_text().startswith(
        "restore failed: JSONDecodeError")
    assert _sha(ckpt / "5" / "model.safetensors") == \
        _sha(tmp_path / "control" / "5" / "model.safetensors")
    assert _sha(ckpt / "5" / "opt.safetensors") == \
        _sha(tmp_path / "control" / "5" / "opt.safetensors")


def test_crash_then_resume_replays_nothing(port_cli, control, tmp_path):
    ckpt = tmp_path / "ckpt"
    with pytest.raises(RuntimeError, match="injected failure at step 2"):
        port_cli(PORT + ["--ckpt-dir", str(ckpt),
                         "--fake-failure-at-step", "2"])
    resumed = tmp_path / "resumed.jsonl"
    assert port_cli(PORT + ["--ckpt-dir", str(ckpt), "--resume",
                            "--batch-fingerprint",
                            "--metrics-file", str(resumed)]) == 0
    _same_as_control(by_step(read_metrics(resumed)), control, range(3, 6))


def test_partial_step_dir_is_skipped_and_quarantined(port_cli, control,
                                                      tmp_path):
    """A 3-step run, a torso dir ``7/`` with no marker, then a 6-step
    resume: steps 3-5 as the same resume without the torso, bit for bit
    (a 3-step run decays its learning rate over 3 steps, so its weights
    are not the 6-step control's), and the control's batches."""
    short = list(PORT)
    short[short.index("--steps") + 1] = "3"
    resumed = {}
    for name in ("clean", "torso"):
        ckpt = tmp_path / name
        assert port_cli(short + ["--ckpt-dir", str(ckpt)]) == 0
        if name == "torso":
            (ckpt / "7" / "model").mkdir(parents=True)
        path = tmp_path / f"{name}.jsonl"
        assert port_cli(PORT + ["--ckpt-dir", str(ckpt), "--resume",
                                "--batch-fingerprint",
                                "--metrics-file", str(path)]) == 0
        resumed[name] = by_step(read_metrics(path))
    _same_as_control(resumed["torso"], resumed["clean"], range(3, 6))
    for step in range(3, 6):
        assert resumed["torso"][step]["batch_fingerprint"] == \
            control[step]["batch_fingerprint"]
    ckpt = tmp_path / "torso"
    assert not (ckpt / "7").exists()
    reason = (ckpt / ".quarantine" / "7"
              / ".jimm_quarantine_reason.txt").read_text()
    assert reason == "partial write (no completion marker)\n"


def test_supervised_preemption_grace_save_and_zero_replay(
        port_cli, control, tmp_path, capsys):
    # SIGTERM must reach the guard: it installs on the main thread only
    assert threading.current_thread() is threading.main_thread()
    ckpt = tmp_path / "ckpt"
    drilled = tmp_path / "drilled.jsonl"
    journal = tmp_path / "journal.jsonl"
    before = obs.snapshot()
    rc = port_cli(["supervise", "--max-restarts", "2", "--backoff-base-s",
                   "0.01", "--seed", "0", "--journal", str(journal), "--"]
                  + PORT + ["--ckpt-dir", str(ckpt),
                            "--metrics-file", str(drilled),
                            "--batch-fingerprint",
                            "--inject-faults", "preempt@2"])
    assert rc == 0
    rows = read_metrics(drilled)
    # attempt 1 trains 0-3 (step 3 is the grace-window step whose result is
    # discarded); attempt 2 resumes at 3
    assert [r["step"] for r in rows] == [0, 1, 2, 3, 3, 4, 5]
    _same_as_control(by_step(rows), control, range(6))
    assert rows[3]["loss"] == rows[4]["loss"]
    out = capsys.readouterr().out
    line = [ln for ln in out.splitlines() if ln.startswith("resilience: ")]
    resilience = json.loads(line[-1].split("resilience: ")[1])
    assert list(resilience) == list(cli.RESILIENCE_KEYS)
    for key in ("jimm_train_restarts_total", "jimm_train_preemptions_total"):
        assert resilience[key] - before.get(key, 0) == 1
    assert resilience["jimm_train_goodput_lost_work_seconds_total"] > 0
    assert resilience["jimm_train_goodput_preemption_save_seconds_total"] > 0
    assert "[supervise] attempt 1 failed (preempted: state saved at step 2" \
        in out
    events = obs.read_events(journal)
    cids = {e["cid"] for e in events}
    assert len(cids) == 1 and None not in cids
    assert [e["event"] for e in events] == [
        "preempt_detected", "grace_save_started", "grace_save_committed",
        "attempt_failed", "restart", "checkpoint_restored",
        "supervise_recovered"]
    assert events[0]["step"] == 2 and events[5]["step"] == 2


def test_supervise_restart_waits_out_the_failed_attempts_save(
        port_cli, control, tmp_path, monkeypatch):
    """A failure mid-step while step 2's write is still running (the writes
    slowed): the failed attempt finishes and marks that write before the
    restart opens the directory, so the restart resumes at step 3 with
    nothing quarantined, and its steps equal the control run's."""
    real_save = checkpoint.save_file

    def slow_save(*a, **kw):
        time.sleep(0.3)
        return real_save(*a, **kw)

    real_step = cli.make_classifier_train_step
    calls = []

    def failing_step_fn():
        step_fn = real_step()

        def step(*a, **kw):
            calls.append(None)
            if len(calls) == 4:  # step 3 of the first attempt
                raise RuntimeError("worker died")
            return step_fn(*a, **kw)
        return step

    monkeypatch.setattr(checkpoint, "save_file", slow_save)
    monkeypatch.setattr(cli, "make_classifier_train_step", failing_step_fn)
    ckpt = tmp_path / "ckpt"
    logged = tmp_path / "logged.jsonl"
    assert port_cli(["supervise", "--max-restarts", "1", "--backoff-base-s",
                     "0.01", "--seed", "0", "--"]
                    + PORT + ["--ckpt-dir", str(ckpt), "--batch-fingerprint",
                              "--metrics-file", str(logged)]) == 0
    rows = read_metrics(logged)
    assert [r["step"] for r in rows] == list(range(6))
    _same_as_control(by_step(rows), control, range(6))
    assert not (ckpt / ".quarantine").exists()
    assert CheckpointManager(ckpt).completed_steps() == [3, 4, 5]


def test_resume_refuses_when_no_step_restores(port_cli, tmp_path):
    """Every step garbled: the resume quarantines each and then refuses,
    rather than train again from step 0."""
    ckpt = tmp_path / "ckpt"
    short = list(PORT)
    short[short.index("--steps") + 1] = "2"
    assert port_cli(short + ["--ckpt-dir", str(ckpt)]) == 0
    for step in (0, 1):
        (ckpt / str(step) / checkpoint.METADATA_FILE).write_text("{garbage")
    with pytest.warns(RuntimeWarning, match="quarantined"):
        with pytest.raises(SystemExit, match="refusing to train from step "
                                             "0"):
            port_cli(PORT + ["--ckpt-dir", str(ckpt), "--resume"])
    assert sorted(p.name for p in (ckpt / ".quarantine").iterdir()) == \
        ["0", "1"]
    assert not (ckpt / "0").exists()


def test_supervise_gives_up_and_reports(port_cli, tmp_path, capsys):
    short = list(PORT)
    short[short.index("--steps") + 1] = "3"
    rc = port_cli(["supervise", "--max-restarts", "1", "--backoff-base-s",
                   "0.01", "--seed", "0", "--"]
                  + short + ["--ckpt-dir", str(tmp_path / "ckpt"),
                             "--inject-faults", "crash@0,crash@1"])
    assert rc == 1
    err = capsys.readouterr().err
    assert "supervise: giving up after 1 restarts (2 attempts); last " \
           "failure: RuntimeError: injected failure at step 1" in err


# -- evaluate and export-run over a run ---------------------------------------

@pytest.fixture()
def run(port_cli, tmp_path):
    """A finished 3-step run of ``COMMON`` and a 4-class dataset."""
    ckpt = tmp_path / "run"
    short = list(PORT)
    short[short.index("--steps") + 1] = "3"
    assert port_cli(short + ["--ckpt-dir", str(ckpt)]) == 0
    data = tmp_path / "data"
    data.mkdir()
    rng = np.random.default_rng(3)
    records.write_classification_records(
        data / "part-00000.tfrecord",
        [(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8), i % 4)
         for i in range(10)], encoding="raw")
    return ckpt, data


def _last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.splitlines()[-1])


RUN = ["--preset", "vit-base-patch16-224", "--tiny", "--num-classes", "4",
       "--device", "cpu"]


def test_evaluate_a_run_equals_evaluate_its_export(run, tmp_path, capsys):
    ckpt, data = run
    assert cli.main(["evaluate", "--data", str(data), "--batch-size", "4",
                     "--ckpt-dir", str(ckpt), *RUN]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"restored step 2 from {ckpt}"
    from_run = json.loads(out[-1])
    exported = tmp_path / "exported"
    assert cli.main(["export-run", str(exported), "--ckpt-dir", str(ckpt),
                     *RUN]) == 0
    assert capsys.readouterr().out.splitlines()[-1] == \
        f"exported {ckpt} -> {exported}"
    assert cli.main(["evaluate", "--data", str(data), "--batch-size", "4",
                     "--ckpt", str(exported), "--model", "vit",
                     "--device", "cpu"]) == 0
    assert _last_json(capsys) == from_run
    assert from_run["examples"] == 10


def test_export_run_loads_back_through_from_pretrained(run, tmp_path):
    ckpt, _ = run
    exported = tmp_path / "exported"
    assert cli.main(["export-run", str(exported), "--ckpt-dir", str(ckpt),
                     *RUN]) == 0
    loaded = VisionTransformer.from_pretrained(exported, device="cpu")
    args = cli.build_parser().parse_args(
        ["export-run", "x", "--ckpt-dir", str(ckpt), *RUN])
    _, restored = cli.restore_run(args)
    want = dict(restored.named_parameters())
    got = dict(loaded.named_parameters())
    assert sorted(got) == sorted(want)
    for name, p in want.items():
        assert np.array_equal(got[name].detach().numpy(),
                              p.detach().numpy()), name


def test_export_run_siglip_flavors(tmp_path):
    ckpt = tmp_path / "run"
    assert cli.main(["train", "--preset", "siglip-base-patch16-256",
                     "--tiny", "--device", "cpu", "--steps", "1",
                     "--batch-size", "2", "--log-every", "0",
                     "--ckpt-dir", str(ckpt)]) == 0
    for flavor in ("siglip", "siglip2"):
        out = tmp_path / flavor
        assert cli.main(["export-run", str(out), "--ckpt-dir", str(ckpt),
                         "--preset", "siglip-base-patch16-256", "--tiny",
                         "--device", "cpu", "--flavor", flavor]) == 0
        loaded = SigLIP.from_pretrained(out, device="cpu")
        assert loaded._hf_source_flavor == flavor


@pytest.mark.parametrize("record", [True, False])
def test_restore_run_is_strict_about_the_architecture(run, record):
    """Another head width than the run's is refused: by the run's record
    before any step is read, or without one by the strict restore. Either
    way no step is quarantined and every step stays."""
    ckpt, _ = run
    if not record:
        (ckpt / checkpoint.RUN_FILE).unlink()
    argv = ["export-run", "x", "--ckpt-dir", str(ckpt), *RUN,
            "--num-classes", "5"]
    match = ("num_classes 5 \\(the run's: 4\\)" if record
             else "classifier.weight: saved torch.float32 \\(4, 64\\), "
                  "expected torch.float32 \\(5, 64\\)")
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no quarantine warning
        with pytest.raises(SystemExit, match=match):
            cli.main(argv)
    assert not (ckpt / ".quarantine").exists()
    assert CheckpointManager(ckpt).completed_steps() == [0, 1, 2]


def test_a_bf16_run_evaluated_in_f32_keeps_its_steps(port_cli, tmp_path,
                                                     capsys):
    """A bf16 run read in f32 by ``evaluate`` and ``export-run`` (the
    architecture from the run's record, the parameters cast as orbax casts)
    keeps every step; ``train --resume`` in f32 is refused before any step
    is read."""
    ckpt = tmp_path / "run"
    short = list(PORT)
    short[short.index("--steps") + 1] = "2"
    assert port_cli(short + ["--bf16", "--ckpt-dir", str(ckpt)]) == 0
    data = tmp_path / "data.tfrecord"
    rng = np.random.default_rng(3)
    records.write_classification_records(
        data, [(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8), i % 4)
               for i in range(4)], encoding="raw")
    assert cli.main(["evaluate", "--data", str(data), "--batch-size", "4",
                     "--ckpt-dir", str(ckpt), "--preset",
                     "vit-base-patch16-224", "--device", "cpu"]) == 0
    assert _last_json(capsys)["examples"] == 4
    exported = tmp_path / "exported"
    assert cli.main(["export-run", str(exported), "--ckpt-dir", str(ckpt),
                     "--preset", "vit-base-patch16-224",
                     "--device", "cpu"]) == 0
    saved = load_file(ckpt / "1" / "model.safetensors")
    loaded = dict(VisionTransformer.from_pretrained(
        exported, device="cpu").named_parameters())
    for name, p in saved.items():
        assert loaded[name].dtype == torch.float32
        assert torch.equal(loaded[name], p.float()), name
    with pytest.raises(SystemExit, match="dtype 'bfloat16' \\(given "
                                         "'float32'\\)"):
        port_cli(PORT + ["--ckpt-dir", str(ckpt), "--resume"])
    assert CheckpointManager(ckpt).completed_steps() == [0, 1]
    assert not (ckpt / ".quarantine").exists()


def test_export_run_flavor_needs_siglip(run):
    ckpt, _ = run
    with pytest.raises(SystemExit, match="--flavor applies to SigLIP "
                                         "models only"):
        cli.main(["export-run", "x", "--ckpt-dir", str(ckpt), *RUN,
                  "--flavor", "siglip"])


# -- refusals, as the reference's ---------------------------------------------

@pytest.mark.parametrize("argv", [
    ["--preemption-save"], ["--inject-faults", "corrupt@1"],
    ["--inject-faults", "boom@2"], ["--inject-faults", "stall@2"],
    ["--inject-faults", "crash@1:5"]])
def test_train_refusals_match_jax(argv):
    base = ["train", "--preset", "vit-base-patch16-224", "--tiny"]
    with pytest.raises(SystemExit) as want:
        jax_cli.main(base + argv)
    with pytest.raises(SystemExit) as got:
        cli.main(base + ["--device", "cpu"] + argv)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("argv", [
    ["--", "evaluate", "--data", "x"], ["--", "train", "--preset", "x"],
    []])
def test_supervise_refusals_match_jax(argv):
    with pytest.raises(SystemExit) as want:
        jax_cli.main(["supervise"] + argv)
    with pytest.raises(SystemExit) as got:
        cli.main(["supervise"] + argv)
    assert str(got.value).replace("python -m jimm_tpu_torch", "jimm-tpu") \
        == str(want.value)


@pytest.mark.parametrize("flag", [["--elastic", "--shrink-plan", "8,x"],
                                  ["--shrink-plan", "8,4"],
                                  ["--elastic", "--adapt", "--shrink-plan",
                                   "2,0"]])
def test_supervise_names_item_6_for_the_mesh_options(flag):
    # the options are ported (tests/test_torch_elastic.py): their refusals
    # are the JAX CLI's
    argv = ["supervise", *flag, "--", "train", "--ckpt-dir", "x"]
    with pytest.raises(SystemExit) as want:
        jax_cli.main(argv)
    with pytest.raises(SystemExit) as got:
        cli.main(argv)
    assert str(got.value) == str(want.value)
    assert "--shrink-plan" in str(got.value)


@pytest.mark.parametrize("argv", [[], ["--ckpt-dir", "run"],
                                  ["--preset", "vit-base-patch16-224"]])
def test_evaluate_needs_a_checkpoint_as_jax_does(tmp_path, argv):
    data = tmp_path / "d.tfrecord"
    records.write_classification_records(data, [], encoding="raw")
    base = ["evaluate", "--data", str(data)]
    with pytest.raises(SystemExit) as want:
        jax_cli.main(base + argv)
    with pytest.raises(SystemExit) as got:
        cli.main(base + argv + ["--device", "cpu"])
    assert str(got.value) == str(want.value) == \
        "need --ckpt, or --preset with --ckpt-dir"


def test_resume_without_a_checkpoint_starts_at_zero(tmp_path, capsys):
    assert cli.main(PORT[:PORT.index("--steps")] + [
        "--steps", "1", "--log-every", "0", "--device", "cpu",
        "--ckpt-dir", str(tmp_path / "empty"), "--resume"]) == 0
    summary = _last_json(capsys)
    assert summary["start_step"] == 0
    assert summary["goodput"]["compile_s"] > 0
    assert summary["goodput"]["checkpoint_s"] > 0
    assert CheckpointManager(tmp_path / "empty").completed_steps() == [0]
