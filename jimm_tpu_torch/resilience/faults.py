"""Deterministic fault injection for resilience drills; the counterpart of
``jimm_tpu/resilience/faults.py``. A plan of typed events fired at
configured steps::

    preempt@STEP          os.kill(SIGTERM) -- exercises the grace-window save
    crash@STEP            hard RuntimeError after STEP's checkpoint commits
    stall@STEP:SECONDS    slow-host stall (sleep) before the next step
    corrupt@STEP          garbage the newest committed checkpoint's metadata

Events at the same step fire in a fixed order (stall, corrupt, preempt,
crash): a stall happens while the step is still "running", corruption must
precede the failure that exposes it, and a preemption signal precedes a
hard crash. The plan is pure data: the same spec replays the same drill,
so resumed losses can be held bit for bit against an uninterrupted run.
"""

from __future__ import annotations

import os
import signal
import time
from dataclasses import dataclass

__all__ = ["Fault", "FaultPlan", "corrupt_latest_checkpoint"]

#: intra-step firing order (see the module docstring)
_ORDER = {"stall": 0, "corrupt": 1, "preempt": 2, "crash": 3}


@dataclass(frozen=True)
class Fault:
    kind: str
    step: int
    arg: float | None = None  # stall duration; unused otherwise

    def __str__(self) -> str:
        suffix = f":{self.arg:g}" if self.arg is not None else ""
        return f"{self.kind}@{self.step}{suffix}"


class FaultPlan:
    """A parsed ``--inject-faults`` spec: the train loop calls :meth:`fire`
    once per step and the plan does the rest."""

    def __init__(self, faults: list[Fault], *, sleep=time.sleep):
        self.faults = sorted(faults, key=lambda f: (f.step, _ORDER[f.kind]))
        self._sleep = sleep
        self.fired: list[Fault] = []

    @classmethod
    def parse(cls, spec: str, *, sleep=time.sleep) -> "FaultPlan":
        """``"preempt@2,stall@4:0.5,corrupt@5,crash@5"`` -> plan."""
        faults: list[Fault] = []
        for item in (spec or "").split(","):
            item = item.strip()
            if not item:
                continue
            try:
                kind, at, rest = item.partition("@")
                kind = kind.strip()
                if not at or kind not in _ORDER:
                    raise ValueError(f"expected one of {sorted(_ORDER)} "
                                     f"before '@'")
                step_s, _, arg_s = rest.partition(":")
                step = int(step_s)
                if step < 0:
                    raise ValueError("step must be >= 0")
                if kind == "stall":
                    if not arg_s:
                        raise ValueError("stall needs a duration: "
                                         "stall@STEP:SECONDS")
                    arg = float(arg_s)
                elif arg_s:
                    raise ValueError(f"{kind} takes no ':' argument")
                else:
                    arg = None
            except ValueError as e:
                raise ValueError(
                    f"bad fault spec entry {item!r}: {e}") from None
            faults.append(Fault(kind, step, arg))
        return cls(faults, sleep=sleep)

    def events_at(self, step: int) -> list[Fault]:
        return [f for f in self.faults if f.step == step]

    def needs(self, kind: str) -> bool:
        return any(f.kind == kind for f in self.faults)

    def fire(self, step: int, *, ckpt=None, rank: int = 0) -> None:
        """Fire every event configured for ``step`` (called at the end of
        the step, after its checkpoint save started). ``ckpt`` is the run's
        CheckpointManager: corrupt and crash events flush it first, so the
        injected failure lands on a committed checkpoint. On a mesh every
        rank fires the plan alike but for two events that act on ``rank``
        0 alone: ``corrupt`` (rank 0 writes the checkpoints) and
        ``preempt`` (the signal reaches one rank; the preemption handler's
        agreement takes it to the others)."""
        for fault in self.events_at(step):
            self.fired.append(fault)
            if fault.kind == "stall":
                self._sleep(fault.arg)
            elif fault.kind in ("corrupt", "preempt") and rank != 0:
                continue
            elif fault.kind == "corrupt":
                if ckpt is None:
                    raise ValueError("corrupt@STEP faults need a "
                                     "checkpoint directory")
                ckpt.wait()  # commit + marker, then corrupt the bytes
                corrupt_latest_checkpoint(ckpt)
            elif fault.kind == "preempt":
                os.kill(os.getpid(), signal.SIGTERM)
            elif fault.kind == "crash":
                if ckpt is not None:
                    ckpt.wait()
                    ckpt.close()
                raise RuntimeError(
                    f"injected failure at step {step} "
                    "(fault drill; rerun with --resume)")


def corrupt_latest_checkpoint(ckpt) -> str:
    """Overwrite the newest committed step's metadata file
    (``checkpoint.json``, parsed on every restore) with garbage, so the
    next restore of that step fails deterministically. The tensor files
    carry no checksum: flipping their bytes may load "successfully".
    Returns the corrupted step directory."""
    from jimm_tpu_torch.train.checkpoint import METADATA_FILE
    step = ckpt.latest_step()
    if step is None:
        raise FileNotFoundError("no committed checkpoint to corrupt")
    step_dir = ckpt.directory / str(step)
    (step_dir / METADATA_FILE).write_text(
        "jimm fault drill: deliberately corrupted\n")
    return str(step_dir)
