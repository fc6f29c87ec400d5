"""The restartable-attempt supervisor; the counterpart of
``jimm_tpu/resilience/supervisor.py``.

Runs training as a sequence of attempts: a preemption
(:class:`~jimm_tpu_torch.resilience.preemption.PreemptedError`), a crash or
a nonzero exit restarts the attempt with ``--resume`` after a bounded
jittered backoff, up to ``max_restarts`` times; then it gives up with a
:class:`GiveUpError`. ``python -m jimm_tpu_torch supervise`` applies it
in-process around the ``train`` command.

Every restart increments ``jimm_train_restarts_total`` and adds the lost
wall time (work since the last committed checkpoint, or the grace-window
loss a :class:`PreemptedError` reports) to the goodput ``lost_work``
counter.
"""

from __future__ import annotations

import time
from typing import Callable

from jimm_tpu_torch.obs.journal import (correlate, get_journal,
                                        new_correlation_id)
from jimm_tpu_torch.resilience.backoff import BackoffPolicy
from jimm_tpu_torch.resilience.preemption import PreemptedError

__all__ = ["GiveUpError", "Supervisor", "note_checkpoint_completed"]

#: monotonic time of the last committed checkpoint in this process:
#: ``train/checkpoint.py`` calls note_checkpoint_completed() when a step's
#: completion marker lands, so the supervisor can bound the work a crash
#: lost
_last_checkpoint_t: float | None = None


def note_checkpoint_completed() -> None:
    global _last_checkpoint_t
    _last_checkpoint_t = time.monotonic()


class GiveUpError(RuntimeError):
    """The supervisor exhausted its restart budget."""


class Supervisor:
    """Run ``attempt_fn(attempt, resume)`` until it returns 0 or the
    restart budget runs out.

    ``attempt_fn`` is called with the 0-based attempt index and a resume
    flag (False on the first attempt, True on every restart) and returns a
    process-style exit code; raising is treated like a crash. ``sleep`` is
    injectable so tests and drills replay instantly.
    """

    def __init__(self, *, max_restarts: int = 3,
                 backoff: BackoffPolicy | None = None,
                 sleep: Callable[[float], None] = time.sleep,
                 registry=None):
        if max_restarts < 0:
            raise ValueError(f"max_restarts must be >= 0, got {max_restarts}")
        self.max_restarts = max_restarts
        self.backoff = backoff if backoff is not None \
            else BackoffPolicy(base_s=1.0, max_s=30.0, jitter=0.5)
        self._sleep = sleep
        if registry is None:
            from jimm_tpu_torch.obs import get_registry
            registry = get_registry("jimm_train")
        self.registry = registry
        self.restarts = 0
        #: one entry per failed attempt, oldest first
        self.history: list[str] = []

    def run(self, attempt_fn: Callable[[int, bool], int]) -> int:
        journal = get_journal()
        # the incident being recovered from: minted when an attempt fails,
        # inherited by everything the restarted attempt does (its restore
        # included) through the ambient correlate() context
        incident: str | None = None
        for attempt in range(self.max_restarts + 1):
            t0 = time.monotonic()
            lost: float | None = None
            cid: str | None = None
            try:
                with correlate(incident):
                    rc = attempt_fn(attempt, attempt > 0)
            except PreemptedError as e:
                failure = str(e)
                lost = 0.0  # the grace window already booked its lost work
                cid = getattr(e, "cid", None)
            except KeyboardInterrupt:
                raise  # an operator stop is not a failure to retry
            except Exception as e:  # worker death: restartable by design
                failure = f"{type(e).__name__}: {e}"
            else:
                if rc == 0:
                    if incident is not None:
                        journal.emit("supervise_recovered", cid=incident,
                                     attempt=attempt)
                    return 0
                failure = f"exit code {rc}"
            if lost is None:
                # a crash: everything since the last committed checkpoint
                # (or the attempt's start) is gone
                since = _last_checkpoint_t
                base = since if since is not None and since >= t0 else t0
                lost = time.monotonic() - base
            self.history.append(failure)
            incident = cid or incident or new_correlation_id()
            journal.emit("attempt_failed", cid=incident, attempt=attempt,
                         failure=failure, lost_s=round(lost, 4))
            if attempt >= self.max_restarts:
                journal.emit("supervise_gave_up", cid=incident,
                             attempts=attempt + 1, failure=failure)
                raise GiveUpError(
                    f"giving up after {self.max_restarts} restarts "
                    f"({attempt + 1} attempts); last failure: {failure}")
            self.restarts += 1
            self.registry.counter("restarts_total").inc()
            if lost > 0:
                self.registry.counter(
                    "goodput_lost_work_seconds_total").inc(lost)
            delay = self.backoff.delay(attempt)
            journal.emit("restart", cid=incident, attempt=attempt + 1,
                         backoff_s=round(delay, 4), failure=failure)
            print(f"[supervise] attempt {attempt + 1} failed ({failure}); "
                  f"restarting in {delay:.2f}s", flush=True)
            self._sleep(delay)
        raise AssertionError("unreachable")
