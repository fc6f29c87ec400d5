"""Bounded, optionally-jittered exponential backoff; the counterpart of
``jimm_tpu/resilience/backoff.py``. One policy for every retry loop: the
hub download retry (``weights/resolve.py``) and the training supervisor
(``supervisor.py``). Jitter is drawn from a seeded ``random.Random``, so
drills and tests replay the same delays (the reference's, for the same
seed)."""

from __future__ import annotations

import random

__all__ = ["BackoffPolicy"]


class BackoffPolicy:
    """Delays of ``base_s * 2**attempt``, capped at ``max_s``.

    ``jitter`` is a fraction in [0, 1]: each delay is scaled by a uniform
    factor in ``[1 - jitter, 1 + jitter]`` drawn from a ``seed``-determined
    stream. ``jitter=0`` (the default) gives the exact exponential
    sequence. ``retries`` is carried for callers that bound their loop by
    the policy; :meth:`delay` accepts any attempt index.
    """

    def __init__(self, *, retries: int = 3, base_s: float = 0.5,
                 max_s: float = float("inf"), jitter: float = 0.0,
                 seed: int | None = None):
        if retries < 0:
            raise ValueError(f"retries must be >= 0, got {retries}")
        if base_s < 0:
            raise ValueError(f"base_s must be >= 0, got {base_s}")
        if not 0.0 <= jitter <= 1.0:
            raise ValueError(f"jitter must be in [0, 1], got {jitter}")
        self.retries = retries
        self.base_s = base_s
        self.max_s = max_s
        self.jitter = jitter
        self._rng = random.Random(seed)

    def delay(self, attempt: int) -> float:
        """Seconds to wait after failed attempt ``attempt`` (0-based)."""
        d = min(self.max_s, self.base_s * (2 ** max(0, attempt)))
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return max(0.0, d)
