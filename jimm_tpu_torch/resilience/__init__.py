"""Preemption-tolerant training; the counterpart of ``jimm_tpu.resilience``.

- :class:`Supervisor` runs training as restartable attempts: it catches
  worker death and preemption and restarts with bounded jittered backoff
  (:class:`BackoffPolicy`), resuming through ``train/checkpoint.py``.
- :class:`PreemptionGuard` / :class:`PreemptionHandler` turn the SIGTERM
  grace window into a checkpoint save whose writes overlap the next
  training steps, then exit resumable (:class:`PreemptedError`).
- :class:`FaultPlan` is the seeded fault-injection plan behind
  ``--inject-faults`` (preemption signals, crashes, stalls, checkpoint
  corruption at configured steps).
- :func:`plan_data_axis` and :class:`GoodputAdvisor` (``elastic``) replan
  the data axis between attempts and tune the next attempt's knobs from
  its goodput (``supervise --elastic`` / ``--adapt``).

Everything here is host-only: no torch import. Restarts, lost work and
grace saves land in ``jimm_tpu_torch.obs``.
"""

from jimm_tpu_torch.resilience.backoff import BackoffPolicy
from jimm_tpu_torch.resilience.elastic import GoodputAdvisor, plan_data_axis
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
    "GoodputAdvisor",
    "PreemptedError",
    "PreemptionGuard",
    "PreemptionHandler",
    "Supervisor",
    "corrupt_latest_checkpoint",
    "note_checkpoint_completed",
    "plan_data_axis",
]
