"""Goodput-driven elastic adaptation: mesh replanning and a bounded
advisor; the counterpart of ``jimm_tpu/resilience/elastic.py``, a copy on
the port's ``obs`` registry, journal and capture ring.

Two host-only pieces (no torch import, as the rest of this package):

- :func:`plan_data_axis` picks the data-parallel mesh width for an attempt
  from the ranks still available. ``supervise --elastic`` calls it between
  attempts and appends ``--mesh data=K --rules dp --max-devices K`` to the
  train command, so a restart after losing ranks restores the checkpoint
  onto a smaller mesh (whole tensors cut on restore, ``train/
  checkpoint.py``) instead of failing on the old shape. In the port a
  device is a rank: ``--max-devices K`` trains on ranks ``0..K-1`` while
  the rest wait for the attempt's outcome.
- :class:`GoodputAdvisor` watches the per-attempt goodput breakdown
  (``obs.goodput`` bucket deltas, ``preemption_save`` and ``lost_work``
  included) over a sliding window and adjusts the knobs the next attempt
  launches with: checkpoint cadence, preemption grace steps, scan unroll
  (a JAX execution strategy; the port's blocks run in a Python loop, so
  the flag changes nothing there but the record).

Every advisor decision is bounded (per-knob clamps), hysteretic (windowed
means, a cooldown between decisions and a dead band between the opposing
checkpoint-cadence rules, so it cannot oscillate) and audited: journaled
as ``advisor_decision``, counted in
``jimm_train_goodput_advisor_decisions_total`` and, for an injected sink,
echoed as a ``goodput_advisor_decision: {...}`` line. With no faults and
healthy goodput the advisor makes no decision, and nothing here runs
unless ``supervise --adapt`` / ``--elastic`` is passed.
"""

from __future__ import annotations

import json
from collections import deque
from typing import Callable

__all__ = ["GoodputAdvisor", "plan_data_axis"]

#: per-knob hard clamps — a runaway rule can never push a knob outside these
KNOB_BOUNDS = {
    "save_every": (1, 512),
    "grace_steps": (0, 8),
    "scan_unroll": (1, 64),
}

#: knob name -> the train-command flag supervise rewrites between attempts
KNOB_FLAGS = {
    "save_every": "--save-every",
    "grace_steps": "--grace-steps",
    "scan_unroll": "--scan-unroll",
}


def plan_data_axis(n_devices: int, batch_size: int) -> int:
    """Widest data-parallel mesh axis that fits ``n_devices`` and divides
    ``batch_size`` evenly (``shard_batch`` and the pipeline validators both
    require divisibility). Always >= 1, so a single surviving device still
    yields a runnable (degenerate) plan."""
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    k = min(n_devices, batch_size)
    while k > 1 and batch_size % k:
        k -= 1
    return k


class GoodputAdvisor:
    """Sliding-window goodput feedback over restart attempts.

    Feed :meth:`observe` one goodput breakdown per finished attempt (the
    per-attempt *delta* of the ``goodput_{bucket}_seconds_total`` counters,
    plus that attempt's wall seconds). When a fraction stays bad across the
    window, the advisor moves exactly ONE knob by one bounded notch:

    - ``lost_work`` high -> checkpoint more often (halve ``save_every``,
      floor 1); once already at every step, widen the preemption grace
      window instead (``grace_steps`` + 1, cap 8) so the SIGTERM save
      overlaps more surviving steps.
    - ``checkpoint`` overhead high *and* lost work comfortably low (a dead
      band below the lost-work threshold, so this rule and the one above
      can never ping-pong) -> checkpoint less often (double ``save_every``,
      cap 512).
    - ``compile`` dominating across >= 2 attempts (every restart repays the
      trace) -> ``scan_unroll`` 1, the cheapest-retrace layer scan.

    A decision starts a ``cooldown`` (observations, not seconds) during
    which the advisor only watches — the next attempt must actually run
    with the new knob before its effect is judged.
    """

    def __init__(self, *, window: int = 3, cooldown: int = 1,
                 lost_work_high: float = 0.08,
                 checkpoint_high: float = 0.25,
                 compile_high: float = 0.35,
                 knobs: dict[str, int] | None = None,
                 registry=None,
                 emit: Callable[[str], None] | None = None):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.window = window
        self.cooldown = max(0, cooldown)
        self.lost_work_high = lost_work_high
        self.checkpoint_high = checkpoint_high
        self.compile_high = compile_high
        #: current knob values the next attempt should launch with; seeded
        #: by the caller from the train command's flags, revised in place
        #: by decisions
        self.knobs: dict[str, int] = dict(knobs or {})
        #: every decision made, oldest first (the JSONL audit trail mirrors
        #: this list line for line)
        self.decisions: list[dict] = []
        self._fracs: deque[dict[str, float]] = deque(maxlen=window)
        self._since_decision = self.cooldown  # first window may decide
        if registry is None:
            from jimm_tpu_torch.obs import get_registry
            registry = get_registry("jimm_train")
        self.registry = registry
        # pre-created at 0 so "the advisor ran and did nothing" is visible
        # in every snapshot, distinct from "the advisor never ran"
        self._counter = registry.counter("goodput_advisor_decisions_total")
        self._emit = emit

    # -- feedback ---------------------------------------------------------

    def observe(self, attempt: int, wall_s: float,
                buckets: dict[str, float]) -> dict | None:
        """Record one attempt's goodput breakdown; returns the decision it
        triggered (already applied to :attr:`knobs`, logged, and counted)
        or None."""
        wall = max(float(wall_s), 1e-9)
        self._fracs.append({
            name: max(0.0, float(buckets.get(name, 0.0))) / wall
            for name in ("lost_work", "checkpoint", "preemption_save",
                         "compile", "step")})
        if self._since_decision < self.cooldown:
            self._since_decision += 1
            return None
        decision = self._decide(attempt)
        if decision is None:
            self._since_decision += 1
            return None
        self._apply(decision)
        return decision

    def _mean(self, name: str) -> float:
        return sum(f[name] for f in self._fracs) / len(self._fracs)

    def _decide(self, attempt: int) -> dict | None:
        lost = self._mean("lost_work")
        ckpt = self._mean("checkpoint")
        comp = self._mean("compile")
        fracs = {"lost_work": round(lost, 4), "checkpoint": round(ckpt, 4),
                 "compile": round(comp, 4),
                 "preemption_save": round(self._mean("preemption_save"), 4)}

        def notch(knob: str, value: int, reason: str) -> dict | None:
            lo, hi = KNOB_BOUNDS[knob]
            value = max(lo, min(hi, int(value)))
            if value == self.knobs.get(knob):
                return None
            return {"attempt": attempt, "knob": knob,
                    "from": self.knobs.get(knob), "to": value,
                    "reason": reason, "window_fracs": fracs,
                    "window": len(self._fracs)}

        if lost > self.lost_work_high:
            save_every = self.knobs.get("save_every")
            if save_every is not None and save_every > 1:
                return notch("save_every", save_every // 2,
                             "lost_work fraction high: checkpoint more "
                             "often so restarts replay less")
            grace = self.knobs.get("grace_steps")
            if grace is not None:
                return notch("grace_steps", grace + 1,
                             "lost_work fraction high at save_every=1: "
                             "overlap more steps with the grace-window "
                             "save")
        # dead band: only relax the cadence when lost work sits well below
        # the tightening threshold, so the two rules cannot alternate
        elif (ckpt > self.checkpoint_high
              and lost < self.lost_work_high / 2
              and self.knobs.get("save_every") is not None):
            return notch("save_every", self.knobs["save_every"] * 2,
                         "checkpoint overhead high with lost_work low: "
                         "checkpoint less often")
        if (comp > self.compile_high and len(self._fracs) >= 2
                and self.knobs.get("scan_unroll") != 1):
            return notch("scan_unroll", 1,
                         "compile dominating across restarts: cheapest-"
                         "retrace layer scan")
        return None

    def _apply(self, decision: dict) -> None:
        from jimm_tpu_torch.obs.journal import get_journal
        self.knobs[decision["knob"]] = decision["to"]
        self.decisions.append(decision)
        self._counter.inc()
        self._since_decision = 0
        # the audit trail: journaled (joining the active incident's chain
        # when one is ambient), echoed as the legacy parseable line only
        # for injected sinks (tests, supervise transcripts)
        rec = get_journal().emit("advisor_decision", **decision)
        # an advisor notch means goodput is measurably degrading — worth a
        # deep profiler capture on the same incident chain (no-op unless a
        # capture ring is configured)
        from jimm_tpu_torch.obs.prof.capture import maybe_trigger
        maybe_trigger(rec.get("cid"), "advisor_" + str(decision["knob"]))
        if self._emit is not None:
            self._emit("goodput_advisor_decision: " + json.dumps(decision))

    # -- handoff ----------------------------------------------------------

    def argv_overrides(self) -> list[str]:
        """The knob state as train-command flags, appended after the user's
        own argv so argparse's last-wins makes them effective."""
        out: list[str] = []
        for knob, value in self.knobs.items():
            flag = KNOB_FLAGS.get(knob)
            if flag is not None and value is not None:
                out += [flag, str(value)]
        return out
