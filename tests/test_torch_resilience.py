"""The port's resilience modules (``jimm_tpu_torch.resilience``: backoff,
fault plans, the supervisor, the preemption guard and handler) against the
JAX package's, which import no JAX: the same inputs give equal delays,
plans, errors, histories, counters and journal chains. Exact equality
throughout; wall-clock fields (``lost_s``, ``dur_s``, timestamps) are
checked for sign only."""

import signal
import threading

import pytest

from jimm_tpu.obs import journal as jax_journal
from jimm_tpu.obs import registry as jax_registry
from jimm_tpu.resilience import backoff as jax_backoff
from jimm_tpu.resilience import faults as jax_faults
from jimm_tpu.resilience import preemption as jax_preemption
from jimm_tpu.resilience import supervisor as jax_supervisor
from jimm_tpu_torch.obs import journal, registry
from jimm_tpu_torch.resilience import (backoff, faults, preemption,
                                       supervisor)

PORT = {"journal": journal, "registry": registry, "backoff": backoff,
        "faults": faults, "preemption": preemption, "supervisor": supervisor}
JAX = {"journal": jax_journal, "registry": jax_registry,
       "backoff": jax_backoff, "faults": jax_faults,
       "preemption": jax_preemption, "supervisor": jax_supervisor}
#: tests/test_resilience.py's specs, and the CLI drills'
GOOD_SPECS = ["crash@5,preempt@2,stall@5:0.25,corrupt@5",
              "stall@1:0.5,crash@2", "corrupt@0", "preempt@2",
              "corrupt@2,crash@2", "crash@0,crash@1", " crash@3 , ", ""]
BAD_SPECS = ["boom@2", "preempt@-1", "stall@3", "crash@2:5", "preempt@x",
             "@2", "crash"]
CLOCK = ("ts", "mono", "lost_s", "dur_s")


@pytest.fixture(autouse=True)
def _fresh_journals(monkeypatch):
    monkeypatch.delenv("JIMM_JOURNAL", raising=False)
    monkeypatch.delenv("JIMM_JOURNAL_ECHO", raising=False)
    for pkg in (PORT, JAX):
        pkg["journal"].reset_journal()
    yield
    for pkg in (PORT, JAX):
        pkg["journal"].reset_journal()


def _events(pkg) -> list[dict]:
    """The global journal's events without clock fields, cids renamed by
    first appearance (each package mints from its own counter)."""
    names: dict[str, str] = {}
    out = []
    for e in pkg["journal"].get_journal().events():
        for k in ("lost_s", "dur_s"):
            if k in e:
                assert e[k] >= 0, e
        e = {k: v for k, v in e.items() if k not in CLOCK}
        if e["cid"] is not None:
            e["cid"] = names.setdefault(e["cid"], f"cid{len(names)}")
        out.append(e)
    return out


@pytest.mark.parametrize("seed", [None, 0, 3, 12345])
@pytest.mark.parametrize("jitter,base_s,max_s", [
    (0.0, 0.5, float("inf")), (0.5, 1.0, 30.0), (1.0, 0.25, 2.0),
    (0.1, 0.0, 5.0)])
def test_backoff_delays_match(seed, jitter, base_s, max_s):
    args = dict(base_s=base_s, max_s=max_s, jitter=jitter, seed=seed)
    got = backoff.BackoffPolicy(**args)
    want = jax_backoff.BackoffPolicy(**args)
    attempts = [0, 1, 2, 3, 7, -1, 12]
    if seed is None and jitter:
        # unseeded jitter draws from the system's entropy: bounds only
        for a in attempts:
            d = got.delay(a)
            assert 0.0 <= d <= min(max_s, base_s * 2 ** max(0, a)) * \
                (1 + jitter)
        return
    assert [got.delay(a) for a in attempts] == \
        [want.delay(a) for a in attempts]


@pytest.mark.parametrize("kwargs", [{"retries": -1}, {"base_s": -0.5},
                                    {"jitter": 1.5}, {"jitter": -0.1}])
def test_backoff_validation_matches(kwargs):
    with pytest.raises(ValueError) as want:
        jax_backoff.BackoffPolicy(**kwargs)
    with pytest.raises(ValueError) as got:
        backoff.BackoffPolicy(**kwargs)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("spec", GOOD_SPECS)
def test_fault_plans_match(spec):
    got = faults.FaultPlan.parse(spec)
    want = jax_faults.FaultPlan.parse(spec)
    assert [str(f) for f in got.faults] == [str(f) for f in want.faults]
    assert [(f.kind, f.step, f.arg) for f in got.faults] == \
        [(f.kind, f.step, f.arg) for f in want.faults]
    for kind in ("stall", "corrupt", "preempt", "crash", "nope"):
        assert got.needs(kind) == want.needs(kind)
    for step in range(7):
        assert [str(f) for f in got.events_at(step)] == \
            [str(f) for f in want.events_at(step)]


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_fault_specs_fail_alike(spec):
    with pytest.raises(ValueError) as want:
        jax_faults.FaultPlan.parse(spec)
    with pytest.raises(ValueError) as got:
        faults.FaultPlan.parse(spec)
    assert str(got.value) == str(want.value)
    assert "bad fault spec entry" in str(got.value)


@pytest.mark.parametrize("pkg", [PORT, JAX], ids=["port", "jax"])
def test_fault_plan_fires_in_order(pkg):
    slept = []
    plan = pkg["faults"].FaultPlan.parse("stall@1:0.5,crash@2",
                                         sleep=slept.append)
    plan.fire(0)
    assert slept == [] and plan.fired == []
    plan.fire(1)
    assert slept == [0.5]
    with pytest.raises(RuntimeError) as e:
        plan.fire(2)
    assert str(e.value) == ("injected failure at step 2 (fault drill; "
                            "rerun with --resume)")
    assert [str(f) for f in plan.fired] == ["stall@1:0.5", "crash@2"]
    with pytest.raises(ValueError, match="corrupt@STEP faults need a "
                                         "checkpoint directory"):
        pkg["faults"].FaultPlan.parse("corrupt@0").fire(0, ckpt=None)


class _Manager:
    """A duck-typed checkpoint manager: records the calls it gets."""

    def __init__(self):
        self.calls = []

    def save(self, step, model, optimizer=None, *, extra=None, force=False):
        self.calls.append(("save", step, force))
        return True

    def wait(self):
        self.calls.append(("wait",))

    def close(self):
        self.calls.append(("close",))


def _attempts(script):
    """An attempt_fn from a script of outcomes: an int exit code, or an
    exception to raise (built per package)."""
    def make(pkg):
        calls = []

        def attempt(i, resume):
            calls.append((i, resume))
            outcome = script[i](pkg)
            if isinstance(outcome, BaseException):
                raise outcome
            return outcome
        return attempt, calls
    return make


SCRIPTS = {
    "first_try": [lambda pkg: 0],
    "two_crashes": [lambda pkg: RuntimeError("worker died"),
                    lambda pkg: RuntimeError("worker died again"),
                    lambda pkg: 0],
    "preempted": [lambda pkg: pkg["preemption"].PreemptedError(
                      4, grace_steps=1, lost_seconds=1.5),
                  lambda pkg: 0],
    "exit_code": [lambda pkg: 3, lambda pkg: 0],
    "gives_up": [lambda pkg: RuntimeError(f"death #{i}")
                 for i in range(3)],
}


def _supervise(pkg, name):
    reg = pkg["registry"].MetricRegistry("t_supervise")
    slept = []
    sup = pkg["supervisor"].Supervisor(
        max_restarts=2, backoff=pkg["backoff"].BackoffPolicy(
            base_s=0.5, jitter=0.5, seed=0),
        sleep=slept.append, registry=reg)
    attempt, calls = _attempts(SCRIPTS[name])(pkg)
    try:
        rc, error = sup.run(attempt), None
    except pkg["supervisor"].GiveUpError as e:
        rc, error = None, str(e)
    snap = reg.snapshot()
    lost = snap.pop("goodput_lost_work_seconds_total", 0)
    return {"rc": rc, "error": error, "calls": calls, "slept": slept,
            "history": sup.history, "restarts": sup.restarts,
            "counters": snap, "lost": lost > 0, "events": _events(pkg)}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_supervisor_matches(name, capsys):
    got = _supervise(PORT, name)
    port_out = capsys.readouterr().out
    want = _supervise(JAX, name)
    assert got == want
    assert port_out == capsys.readouterr().out  # the [supervise] lines
    if name == "gives_up":
        assert got["error"] == ("giving up after 2 restarts (3 attempts); "
                                "last failure: RuntimeError: death #2")
        assert [e["event"] for e in got["events"]] == [
            "attempt_failed", "restart", "attempt_failed", "restart",
            "attempt_failed", "supervise_gave_up"]
    if name == "two_crashes":
        assert [e["event"] for e in got["events"]][-1] == \
            "supervise_recovered"
        assert {e["cid"] for e in got["events"]} == {"cid0"}
        assert got["calls"] == [(0, False), (1, True), (2, True)]


def test_supervisor_threads_the_preemption_cid():
    """A PreemptedError's cid becomes the incident: the restarted attempt
    runs under it, so its events join the chain."""
    for pkg in (PORT, JAX):
        j = pkg["journal"]
        seen = []

        def attempt(i, resume, pkg=pkg, j=j, seen=seen):
            if i == 0:
                raise pkg["preemption"].PreemptedError(2, cid="c-given")
            seen.append(j.current_cid())
            j.get_journal().emit("checkpoint_restored", step=2)
            return 0

        sup = pkg["supervisor"].Supervisor(
            max_restarts=1, sleep=lambda s: None,
            registry=pkg["registry"].MetricRegistry("t_cid"))
        assert sup.run(attempt) == 0
        assert seen == ["c-given"]
        assert [e["event"] for e in j.get_journal().chain("c-given")] == [
            "attempt_failed", "restart", "checkpoint_restored",
            "supervise_recovered"]


@pytest.mark.parametrize("grace_steps,adopt", [(1, False), (1, True),
                                               (0, False), (2, True)])
def test_preemption_handler_matches(grace_steps, adopt):
    results = []
    for pkg in (PORT, JAX):
        pre = pkg["preemption"]
        reg = pkg["registry"].MetricRegistry("t_preempt")
        guard = pre.PreemptionGuard()
        mgr = _Manager()
        handler = pre.PreemptionHandler(guard, mgr, grace_steps=grace_steps,
                                        registry=reg)
        steps_run, error = [], None
        try:
            for step in range(8):
                steps_run.append(step)
                if step == 2:
                    guard.trigger()
                assert handler.draining == (step > 2)
                handler.after_step(step, model=None,
                                   already_saved=adopt and step == 2)
        except pre.PreemptedError as e:
            error = (str(e), e.step, e.grace_steps, e.lost_seconds > 0,
                     e.cid == handler.cid)
        results.append((steps_run, error, mgr.calls, reg.snapshot(),
                        _events(pkg)))
    assert results[0] == results[1]
    steps_run, error, calls, snap, events = results[0]
    assert steps_run == list(range(3 + grace_steps))
    assert error == ("preempted: state saved at step 2; resume with "
                     "--resume", 2, grace_steps, True, True)
    assert calls == ([] if adopt else [("save", 2, True)]) + [("wait",),
                                                              ("close",)]
    assert snap == {"preemptions_total": 1}
    assert [e["event"] for e in events] == [
        "preempt_detected", "grace_save_started", "grace_save_committed"]


def test_preemption_handler_needs_a_manager():
    for pkg in (PORT, JAX):
        with pytest.raises(ValueError, match="preemption saves need a "
                                             "CheckpointManager"):
            pkg["preemption"].PreemptionHandler(
                pkg["preemption"].PreemptionGuard(), None)


def test_guard_catches_a_real_sigterm_and_restores_the_handler():
    previous = signal.getsignal(signal.SIGTERM)
    guard = preemption.PreemptionGuard().install()
    try:
        assert not guard.preempted
        signal.raise_signal(signal.SIGTERM)
        assert guard.preempted
    finally:
        guard.uninstall()
    assert signal.getsignal(signal.SIGTERM) is previous


def test_guard_off_the_main_thread_is_trigger_only():
    previous = signal.getsignal(signal.SIGTERM)
    out = {}

    def body():
        guard = preemption.PreemptionGuard().install()
        out["handlers"] = dict(guard._previous)
        guard.trigger()
        out["preempted"] = guard.preempted
        guard.uninstall()

    t = threading.Thread(target=body)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    assert out == {"handlers": {}, "preempted": True}
    assert signal.getsignal(signal.SIGTERM) is previous


def test_note_checkpoint_completed_bounds_lost_work():
    """A crash after a committed checkpoint loses only the time since it."""
    import time
    reg = registry.MetricRegistry("t_lost")
    flag = []

    def attempt(i, resume):
        if not flag:
            flag.append(1)
            time.sleep(0.05)
            supervisor.note_checkpoint_completed()
            raise RuntimeError("boom")
        return 0

    sup = supervisor.Supervisor(max_restarts=1, sleep=lambda s: None,
                                registry=reg)
    assert sup.run(attempt) == 0
    lost = reg.snapshot()["goodput_lost_work_seconds_total"]
    assert 0 < lost < 0.05
