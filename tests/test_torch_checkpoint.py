"""The port's training-run checkpoints (``jimm_tpu_torch.train.checkpoint``)
against the JAX package's orbax-backed ``CheckpointManager`` on the CPU:
the same saves give the same return values and completed steps (orbax's
interval and keep rules), and the partial-directory sweep and the
corrupt-then-fall-back restore give the same quarantine layout, reasons,
counters, events and restored step. Then, port only: bit-exact round trips
of parameters and optimizer state (f32 and bf16 moments, bf16
parameters), strict restores that quarantine nothing, the run record, a
writer-thread failure that surfaces, and a resumed step equal bit for bit
to the uninterrupted one."""

import json
import warnings

import numpy as np
import pytest
import torch
from flax import nnx

from jimm_tpu.obs import journal as jax_journal
from jimm_tpu.obs import registry as jax_registry
from jimm_tpu.resilience import corrupt_latest_checkpoint as jax_corrupt
from jimm_tpu.train.checkpoint import CheckpointManager as JaxManager
from jimm_tpu_torch.obs import journal, registry
from jimm_tpu_torch.resilience import corrupt_latest_checkpoint
from jimm_tpu_torch.train import checkpoint
from jimm_tpu_torch.train.checkpoint import (CheckpointManager,
                                              CheckpointMismatchError)
from jimm_tpu_torch.train.trainer import OptimizerConfig, make_optimizer

COUNTERS = ("checkpoint_saves_total", "checkpoint_restores_total",
            "checkpoint_quarantined_total")


@pytest.fixture(autouse=True)
def _fresh_journals(monkeypatch):
    monkeypatch.delenv("JIMM_JOURNAL", raising=False)
    for mod in (journal, jax_journal):
        mod.reset_journal()
    yield
    for mod in (journal, jax_journal):
        mod.reset_journal()


class Tiny(torch.nn.Module):
    """A Linear, a LayerNorm and a scalar: matrices, vectors and a 0-d
    parameter."""

    def __init__(self, seed: int = 0, dtype=torch.float32):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.lin = torch.nn.Linear(6, 5, dtype=dtype)
        self.norm = torch.nn.LayerNorm(5, dtype=dtype)
        self.scale = torch.nn.Parameter(torch.tensor(1.5, dtype=dtype))
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=g))
        self.register_buffer("history", torch.zeros(3))  # not saved

    def forward(self, x):
        return self.scale * self.norm(self.lin(x))


def _step(model, opt, seed: int) -> float:
    g = torch.Generator().manual_seed(100 + seed)
    param = next(model.parameters())
    x = torch.randn(4, 6, generator=g).to(param.dtype)
    opt.zero_grad()
    loss = model(x).float().pow(2).mean()
    loss.backward()
    opt.step()
    return loss.item()


def _pair(moment_dtype=None, dtype=torch.float32, seed=0):
    model = Tiny(seed, dtype)
    opt = make_optimizer(model, OptimizerConfig(
        learning_rate=1e-2, weight_decay=0.1, total_steps=10,
        moment_dtype=moment_dtype))
    return model, opt


def _counters(reg_mod) -> dict:
    snap = reg_mod.get_registry("jimm_train").snapshot()
    return {k: snap.get(k, 0) for k in COUNTERS}


def _delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in COUNTERS}


def _jax_model():
    return nnx.Linear(3, 4, rngs=nnx.Rngs(0))


@pytest.mark.parametrize("interval,keep", [(2, 2), (1, 3), (3, None)])
def test_save_grid_and_keep_match_orbax(tmp_path, interval, keep):
    """Steps 0-7, then a forced off-grid save and a duplicate: equal
    ``save`` results and ``completed_steps()`` after each save's write."""
    jmgr = JaxManager(tmp_path / "jax", max_to_keep=keep,
                      save_interval_steps=interval)
    pmgr = CheckpointManager(tmp_path / "port", max_to_keep=keep,
                             save_interval_steps=interval)
    jmodel = _jax_model()
    model, opt = _pair()
    try:
        for step in range(8):
            _step(model, opt, step)
            want = jmgr.save(step, jmodel)
            got = pmgr.save(step, model, opt)
            assert got == want, step
            jmgr.wait()
            pmgr.wait()
            assert pmgr.completed_steps() == jmgr.completed_steps(), step
            assert pmgr.latest_step() == jmgr.latest_step()
        assert pmgr.save(11, model, opt, force=True) \
            == jmgr.save(11, jmodel, force=True) is True
        with pytest.raises(ValueError) as want:
            jmgr.save(11, jmodel, force=True)
        with pytest.raises(ValueError) as got:
            pmgr.save(11, model, opt, force=True)
        assert str(got.value) == str(want.value)
        jmgr.wait()
        pmgr.wait()
        assert pmgr.completed_steps() == jmgr.completed_steps()
    finally:
        jmgr.close()
        pmgr.close()


def _events(mod) -> list[tuple]:
    return [(e["event"], e.get("step"),
             e.get("reason", "").split(":")[0])
            for e in mod.get_journal().events()]


def _quarantine(root) -> dict[str, str]:
    q = root / ".quarantine"
    return {d.name: (d / ".jimm_quarantine_reason.txt").read_text()
            for d in sorted(q.iterdir())}


def _sweep_and_fall_back(mgr, save, restore, corrupt, root, reg_mod,
                         jmod) -> dict:
    for step in range(4):
        assert save(step)
    mgr.wait()
    # what a kill mid-write leaves: a step directory with no marker
    (root / "7" / "model").mkdir(parents=True)
    corrupt(mgr)
    before = _counters(reg_mod)
    with pytest.warns(RuntimeWarning, match="quarantined") as caught:
        restored = restore()
    after = _counters(reg_mod)
    quarantine = _quarantine(root)
    out = {"restored": restored, "completed": mgr.completed_steps(),
           "quarantine": sorted(quarantine),
           "reasons": {k: v.split(":")[0] for k, v in quarantine.items()},
           "partial_reason": quarantine["7"],
           "counters": _delta(before, after), "events": _events(jmod),
           "warnings": [str(w.message).split(" (")[0] for w in caught],
           "resave": save(3)}
    mgr.wait()
    out["after_resave"] = mgr.completed_steps()
    return out


def test_sweep_and_corrupt_fallback_match_orbax(tmp_path):
    jroot, proot = tmp_path / "jax", tmp_path / "port"
    jmgr = JaxManager(jroot, max_to_keep=3)
    pmgr = CheckpointManager(proot, max_to_keep=3)
    jmodel = _jax_model()
    model, opt = _pair()
    try:
        want = _sweep_and_fall_back(
            jmgr, lambda s: jmgr.save(s, jmodel),
            lambda: jmgr.restore(jmodel), jax_corrupt, jroot, jax_registry,
            jax_journal)
        got = _sweep_and_fall_back(
            pmgr, lambda s: pmgr.save(s, model, opt),
            lambda: pmgr.restore(model, opt), corrupt_latest_checkpoint,
            proot, registry, journal)
    finally:
        jmgr.close()
        pmgr.close()
    assert got == want
    assert got["restored"] == 2 and got["quarantine"] == ["3", "7"]
    assert got["partial_reason"] == "partial write (no completion marker)\n"
    assert got["reasons"]["3"] == "restore failed"
    assert got["counters"] == {"checkpoint_saves_total": 0,
                               "checkpoint_restores_total": 2,
                               "checkpoint_quarantined_total": 2}


@pytest.mark.parametrize("which", ["jax", "port"])
def test_no_checkpoint_errors_match(tmp_path, which):
    if which == "jax":
        mgr, model = JaxManager(tmp_path / "c"), _jax_model()
        save = lambda s: mgr.save(s, model)  # noqa: E731
        corrupt = jax_corrupt
    else:
        mgr, (model, opt) = CheckpointManager(tmp_path / "c"), _pair()
        save = lambda s: mgr.save(s, model, opt)  # noqa: E731
        corrupt = corrupt_latest_checkpoint
    try:
        with pytest.raises(FileNotFoundError, match="^no checkpoint found$"):
            mgr.restore(model)
        with pytest.raises(FileNotFoundError,
                           match="no committed checkpoint to corrupt"):
            corrupt(mgr)
        save(0)
        mgr.wait()
        corrupt(mgr)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            with pytest.raises(FileNotFoundError) as e:
                mgr.restore(model)
        assert str(e.value) == ("no restorable checkpoint: all 1 candidate "
                                "step(s) failed and were quarantined")
    finally:
        mgr.close()


# -- port only ----------------------------------------------------------------

def _state(model, opt) -> dict[str, torch.Tensor]:
    names = {id(p): n for n, p in model.named_parameters()}
    out = {f"param:{n}": p.detach().clone()
           for n, p in model.named_parameters()}
    for p in opt.params:
        for k, v in opt.opt.state[p].items():
            out[f"{names[id(p)]}.{k}"] = v.clone()
    return out


def _assert_equal(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].device == want[k].device, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("moment,dtype", [
    (None, torch.float32), ("bfloat16", torch.float32),
    (None, torch.bfloat16), ("float32", torch.bfloat16)])
def test_round_trip_is_bit_exact(tmp_path, moment, dtype):
    """Parameters, every optimizer tensor (torch's ``step`` included) and
    the update count come back bit for bit in a fresh model and optimizer;
    the buffers are not saved; ``extra`` comes back."""
    model, opt = _pair(moment, dtype)
    for step in range(3):
        _step(model, opt, step)
    model.history.fill_(7.0)
    mgr = CheckpointManager(tmp_path / "c")
    try:
        assert mgr.save(2, model, opt, extra={"grain_state": "abc"})
        mgr.wait()
    finally:
        mgr.close()
    fresh, fresh_opt = _pair(moment, dtype, seed=1)
    restorer = CheckpointManager(tmp_path / "c")
    assert restorer.restore(fresh, fresh_opt) == 2
    _assert_equal(_state(fresh, fresh_opt), _state(model, opt))
    assert fresh_opt.count == opt.count == 3
    assert torch.equal(fresh.history, torch.zeros(3))
    assert restorer.last_restored_extra == {"grain_state": "abc"}
    mu = fresh_opt.opt.state[fresh.lin.weight]["exp_avg"]
    assert mu.dtype == (getattr(torch, moment) if moment else dtype)
    meta = json.loads((tmp_path / "c" / "2" / checkpoint.METADATA_FILE)
                      .read_text())
    assert meta["optimizer"]["count"] == 3 and meta["step"] == 2


def test_resumed_step_equals_the_uninterrupted_step(tmp_path):
    """Three steps, a save, two more steps; against a fresh model and
    optimizer restored from the save that take the same two steps: equal
    losses and state, bit for bit on the CPU."""
    model, opt = _pair()
    for step in range(3):
        _step(model, opt, step)
    with_ckpt = CheckpointManager(tmp_path / "c")
    with_ckpt.save(2, model, opt)
    with_ckpt.close()
    want = [_step(model, opt, step) for step in (3, 4)]
    fresh, fresh_opt = _pair(seed=5)
    CheckpointManager(tmp_path / "c").restore(fresh, fresh_opt)
    got = [_step(fresh, fresh_opt, step) for step in (3, 4)]
    assert got == want
    _assert_equal(_state(fresh, fresh_opt), _state(model, opt))


def test_host_copy_is_taken_before_save_returns(tmp_path, monkeypatch):
    """The next step may update the parameters while the files are being
    written: what lands on disk is the state at ``save``."""
    import threading
    gate = threading.Event()
    real = checkpoint.save_file

    def slow(tensors, path, metadata=None):
        assert gate.wait(timeout=30)
        return real(tensors, path, metadata)

    monkeypatch.setattr(checkpoint, "save_file", slow)
    model, opt = _pair()
    _step(model, opt, 0)
    want = _state(model, opt)
    mgr = CheckpointManager(tmp_path / "c")
    try:
        mgr.save(0, model, opt)
        _step(model, opt, 1)  # in place, while the write waits
        gate.set()
        mgr.wait()
    finally:
        gate.set()
        mgr.close()
    fresh, fresh_opt = _pair(seed=3)
    CheckpointManager(tmp_path / "c").restore(fresh, fresh_opt)
    _assert_equal(_state(fresh, fresh_opt), want)


def test_writer_failure_surfaces_and_never_marks(tmp_path, monkeypatch):
    def broken(tensors, path, metadata=None):
        raise OSError("disk full")

    model, opt = _pair()
    _step(model, opt, 0)
    mgr = CheckpointManager(tmp_path / "c")
    try:
        mgr.save(0, model, opt)
        mgr.wait()
        monkeypatch.setattr(checkpoint, "save_file", broken)
        assert mgr.save(1, model, opt)  # the write fails in the background
        with pytest.raises(OSError, match="disk full"):
            mgr.wait()
        assert mgr.completed_steps() == [0]
        mgr.wait()  # surfaced once; nothing pending
        assert mgr.save(2, model, opt)
        with pytest.raises(OSError, match="disk full"):
            mgr.save(3, model, opt)  # the next save surfaces it too
        with pytest.raises(OSError, match="disk full"):
            assert mgr.save(4, model, opt)
            mgr.close()
    finally:
        monkeypatch.undo()
        mgr.close()
    assert mgr.completed_steps() == [0]


@pytest.mark.parametrize("change", ["shape", "dtype", "missing", "extra",
                                    "moments"])
def test_restore_is_strict(tmp_path, change):
    """A checkpoint that does not fit the model or optimizer raises, on an
    explicit step and on the newest one alike, and leaves both as they
    were; the sound step is not quarantined."""
    model, opt = _pair()
    _step(model, opt, 0)
    mgr = CheckpointManager(tmp_path / "c")
    mgr.save(0, model, opt)
    mgr.save(1, model, opt)
    mgr.close()
    if change == "shape":
        target, topt = Tiny(), None
        target.lin = torch.nn.Linear(6, 4)
        target.norm = torch.nn.LayerNorm(4)
    elif change == "dtype":
        target, topt = Tiny(dtype=torch.bfloat16), None
    elif change == "missing":
        target, topt = Tiny(), None
        target.more = torch.nn.Parameter(torch.zeros(2))
    elif change == "extra":
        target, topt = Tiny(), None
        del target.scale
        target.scale = 1.0
    else:  # bf16 moments where the run kept them in f32
        target, topt = _pair("bfloat16", seed=2)
    before = {n: p.detach().clone() for n, p in target.named_parameters()}
    with pytest.raises(CheckpointMismatchError):
        CheckpointManager(tmp_path / "c").restore(target, topt, step=0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no quarantine warning either
        with pytest.raises(CheckpointMismatchError):
            CheckpointManager(tmp_path / "c").restore(target, topt)
    for n, p in target.named_parameters():
        assert torch.equal(p, before[n]), n
    assert CheckpointManager(tmp_path / "c").completed_steps() == [0, 1]
    assert not (tmp_path / "c" / ".quarantine").exists()
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "c").restore(model, opt, step=5)


def test_restore_casts_parameters_when_asked(tmp_path):
    """``cast=True`` converts each saved parameter to its target's dtype,
    as orbax does: a bf16 run restores into an f32 model exactly."""
    model = Tiny(dtype=torch.bfloat16)
    mgr = CheckpointManager(tmp_path / "c")
    mgr.save(0, model)
    mgr.close()
    target = Tiny(seed=3)
    CheckpointManager(tmp_path / "c").restore(target, cast=True)
    for name, p in model.named_parameters():
        got = dict(target.named_parameters())[name]
        assert got.dtype == torch.float32
        assert torch.equal(got, p.float()), name


def test_run_record_refuses_another_run(tmp_path):
    """The first manager given a run records it; another run is refused
    before any step is read, and the record stays."""
    run = {"preset": "vit-base-patch16-224", "tiny": True,
           "num_classes": 4, "dtype": "bfloat16"}
    assert CheckpointManager(tmp_path / "c").run is None
    assert CheckpointManager(tmp_path / "c", run=run).run == run
    assert CheckpointManager(tmp_path / "c", run=dict(run)).run == run
    with pytest.raises(CheckpointMismatchError,
                       match="dtype 'bfloat16' \\(given 'float32'\\)"):
        CheckpointManager(tmp_path / "c", run={**run, "dtype": "float32"})
    assert CheckpointManager(tmp_path / "c").run == run


def test_restores_onto_the_current_device_in_place(tmp_path):
    model, opt = _pair()
    _step(model, opt, 0)
    mgr = CheckpointManager(tmp_path / "c")
    mgr.save(0, model, opt)
    mgr.close()
    fresh, fresh_opt = _pair(seed=4)
    ids = [id(p) for p in fresh.parameters()]
    CheckpointManager(tmp_path / "c").restore(fresh, fresh_opt)
    assert [id(p) for p in fresh.parameters()] == ids
    assert fresh_opt.opt.state[fresh.lin.weight]["step"].device.type == "cpu"
    np.testing.assert_array_equal(fresh.lin.weight.detach().numpy(),
                                  model.lin.weight.detach().numpy())
