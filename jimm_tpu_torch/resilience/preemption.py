"""Preemption-aware checkpointing: a signal guard and the grace-window
save; the counterpart of ``jimm_tpu/resilience/preemption.py``.

A maintenance event delivers SIGTERM and then gives the process a short
grace window before the hard kill. The guard turns the signal into a flag
the train loop polls; the handler turns the flag into a checkpoint save
whose file writes run in the background while the next ``grace_steps``
training steps run (the device-to-host copy happens up front), then
flushes the checkpoint's completion marker and exits resumable via
:class:`PreemptedError`. The supervisor catches that error, backs off and
restarts with ``--resume``.
"""

from __future__ import annotations

import signal
import threading
import time

from jimm_tpu_torch.obs.journal import get_journal, new_correlation_id

__all__ = ["PreemptedError", "PreemptionGuard", "PreemptionHandler"]


class PreemptedError(RuntimeError):
    """The run was preempted and its state committed at ``step``; a
    ``--resume`` rerun continues at ``step + 1``. ``lost_seconds`` is the
    wall time spent on grace-window steps whose results the restart
    discards (plus the final save flush), as in the goodput ``lost_work``
    bucket. ``cid`` is the journal correlation id minted at detection."""

    def __init__(self, step: int, *, grace_steps: int = 0,
                 lost_seconds: float = 0.0, cid: str | None = None):
        super().__init__(f"preempted: state saved at step {step}; "
                         f"resume with --resume")
        self.step = step
        self.grace_steps = grace_steps
        self.lost_seconds = lost_seconds
        self.cid = cid


class PreemptionGuard:
    """Installs handlers for maintenance signals (default SIGTERM) that
    only set a flag: the train loop decides when to act on it, so the
    signal never interrupts a step or a checkpoint write mid-way.

    ``install`` snapshots and ``uninstall`` restores the previous handlers.
    Off the main thread (where ``signal.signal`` is unavailable) the guard
    works by :meth:`trigger` only."""

    def __init__(self, signals: tuple[int, ...] = (signal.SIGTERM,)):
        self.signals = tuple(signals)
        self._event = threading.Event()
        self._previous: dict[int, object] = {}

    def install(self) -> "PreemptionGuard":
        try:
            for sig in self.signals:
                self._previous[sig] = signal.signal(sig, self._on_signal)
        except ValueError:  # not the main thread: trigger()-only mode
            self._previous.clear()
        return self

    def uninstall(self) -> None:
        for sig, previous in self._previous.items():
            signal.signal(sig, previous)
        self._previous.clear()

    def _on_signal(self, signum, frame) -> None:
        self.trigger()

    def trigger(self) -> None:
        """Mark the process preempted (signal handler / fault drill)."""
        self._event.set()

    @property
    def preempted(self) -> bool:
        return self._event.is_set()


class PreemptionHandler:
    """Drives the grace-window save from the train loop.

    Call :meth:`after_step` once per step, after the normal checkpoint
    block. On the first preempted step it starts a forced save (or adopts
    the step's normal save when one just ran), keeps the loop training for
    ``grace_steps`` more steps while the write drains, then waits the save
    out, closes the manager (flushing the completion marker) and raises
    :class:`PreemptedError`. While draining, :attr:`draining` is True: the
    loop skips its normal per-step saves, since nothing after the grace
    save is kept. On a mesh ``agree`` makes the flag the ranks' (see
    ``__init__``).
    """

    def __init__(self, guard: PreemptionGuard, ckpt, *, grace_steps: int = 1,
                 accounter=None, registry=None, agree=None):
        if ckpt is None:
            raise ValueError("preemption saves need a CheckpointManager")
        self.guard = guard
        self.ckpt = ckpt
        self.grace_steps = max(0, grace_steps)
        self.accounter = accounter
        #: on a mesh, ``agree(flag) -> bool``: whether any rank's guard
        #: fired (a collective every rank calls at each step's end), so
        #: that every rank saves the same step and raises together
        self.agree = agree
        if registry is None:
            from jimm_tpu_torch.obs import get_registry
            registry = get_registry("jimm_train")
        self.registry = registry
        self.save_step: int | None = None
        self._steps_after = 0
        self._t_detected: float | None = None
        #: incident correlation id, minted at detection
        self.cid: str | None = None

    @property
    def draining(self) -> bool:
        """True once the grace save started."""
        return self.save_step is not None

    def after_step(self, step: int, model, optimizer=None, *,
                   extra: dict | None = None,
                   already_saved: bool = False) -> None:
        """React to a pending preemption at the end of step ``step``.

        ``already_saved``: the loop's normal checkpoint block saved this
        exact step; its write is the grace save (a second save of the same
        step is refused)."""
        preempted = self.guard.preempted
        if self.agree is not None:
            preempted = self.agree(preempted)
            if preempted and not self.guard.preempted:
                self.guard.trigger()
        if not preempted:
            return
        if self.save_step is None:
            self._t_detected = time.monotonic()
            self.save_step = step
            self.cid = new_correlation_id()
            self.registry.counter("preemptions_total").inc()
            get_journal().emit("preempt_detected", cid=self.cid, step=step,
                               grace_steps=self.grace_steps)
            self._timed_save(step, model, optimizer, extra, already_saved)
            if self.grace_steps > 0:
                return  # overlap the background write with the next steps
        else:
            self._steps_after += 1
            if self._steps_after < self.grace_steps:
                return
        self._finish()

    def _timed_save(self, step, model, optimizer, extra,
                    already_saved) -> None:
        from jimm_tpu_torch.obs import span
        t0 = time.perf_counter()
        with span("preemption_save"):
            if not already_saved:
                self.ckpt.save(step, model, optimizer, extra=extra,
                               force=True)
        dt = time.perf_counter() - t0
        if self.accounter is not None:
            self.accounter.add("preemption_save", dt)
        get_journal().emit("grace_save_started", cid=self.cid, step=step,
                           adopted=bool(already_saved), dur_s=round(dt, 6))

    def _finish(self) -> None:
        from jimm_tpu_torch.obs import span
        t0 = time.perf_counter()
        with span("preemption_save"):
            self.ckpt.wait()
        dt = time.perf_counter() - t0
        if self.accounter is not None:
            self.accounter.add("preemption_save", dt)
        self.ckpt.close()  # flushes the completion marker
        lost = time.monotonic() - self._t_detected
        if self.accounter is not None:
            self.accounter.add("lost_work", lost)
        get_journal().emit("grace_save_committed", cid=self.cid,
                           step=self.save_step,
                           grace_steps=self._steps_after,
                           lost_s=round(lost, 4), dur_s=round(dt, 6))
        raise PreemptedError(self.save_step, grace_steps=self._steps_after,
                             lost_seconds=lost, cid=self.cid)
