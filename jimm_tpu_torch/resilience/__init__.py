"""Preemption-tolerant training; the counterpart of ``jimm_tpu.resilience``
(its ``elastic`` module, the mesh replanning and the goodput advisor, waits
for ROADMAP.md queue 1, item 6).

- :class:`Supervisor` runs training as restartable attempts: it catches
  worker death and preemption and restarts with bounded jittered backoff
  (:class:`BackoffPolicy`), resuming through ``train/checkpoint.py``.
- :class:`PreemptionGuard` / :class:`PreemptionHandler` turn the SIGTERM
  grace window into a checkpoint save whose writes overlap the next
  training steps, then exit resumable (:class:`PreemptedError`).
- :class:`FaultPlan` is the seeded fault-injection plan behind
  ``--inject-faults`` (preemption signals, crashes, stalls, checkpoint
  corruption at configured steps).

Everything here is host-only: no torch import. Restarts, lost work and
grace saves land in ``jimm_tpu_torch.obs``.
"""

from jimm_tpu_torch.resilience.backoff import BackoffPolicy
from jimm_tpu_torch.resilience.faults import (Fault, FaultPlan,
                                              corrupt_latest_checkpoint)
from jimm_tpu_torch.resilience.preemption import (PreemptedError,
                                                  PreemptionGuard,
                                                  PreemptionHandler)
from jimm_tpu_torch.resilience.supervisor import (GiveUpError, Supervisor,
                                                  note_checkpoint_completed)

__all__ = [
    "BackoffPolicy",
    "Fault",
    "FaultPlan",
    "GiveUpError",
    "PreemptedError",
    "PreemptionGuard",
    "PreemptionHandler",
    "Supervisor",
    "corrupt_latest_checkpoint",
    "note_checkpoint_completed",
]
