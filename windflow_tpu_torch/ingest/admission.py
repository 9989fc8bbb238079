"""Admission control: what happens when ingestion outruns the graph.

Without a policy, an overloaded ingest source simply stops reading its
transport (credit exhaustion + a full staging buffer) -- correct, but
it pushes the problem to the peer.  A service that must stay live
under overload instead *sheds*: it admits what the pipeline can absorb
and quarantines the rest, visibly.

Policies (selected via ``SourceBuilder.with_admission``):

* ``drop_newest`` -- arriving tuples are shed while the stage is full;
  the backlog keeps its arrival order (protects the oldest data).
* ``drop_oldest`` -- the oldest staged tuples are evicted to admit the
  arrival (protects freshness: the steady state tracks the stream
  head, the right policy for monitoring/alerting feeds).
* ``sample`` -- a seeded-uniform subset of the arrival sized to the
  free stage space is admitted; under sustained overload the admitted
  stream is an unbiased sample of the input.

Every shed tuple is counted and quarantined (a bounded sample of the
shed batches, with exact counts) in the graph's ``DeadLetterStore``
under a :class:`ShedTuples` marker error, so overload is a measurable
event, never silent loss.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

POLICY_DROP_NEWEST = "drop_newest"
POLICY_DROP_OLDEST = "drop_oldest"
POLICY_SAMPLE = "sample"
ADMISSION_POLICIES = (POLICY_DROP_NEWEST, POLICY_DROP_OLDEST, POLICY_SAMPLE)


class ShedTuples(RuntimeError):
    """Marker error attached to dead-letter entries for shed tuples."""

    def __init__(self, policy: str, count: int):
        super().__init__(f"admission policy {policy!r} shed {count} tuples")
        self.policy = policy
        self.count = count


class AdmissionConfig:
    """Overload behaviour of one ingest source replica."""

    __slots__ = ("policy", "max_wait_ms", "seed", "_rng")

    def __init__(self, policy: str, max_wait_ms: float = 0.0,
                 seed: int = 0):
        if policy not in ADMISSION_POLICIES:
            raise ValueError(
                f"unknown admission policy {policy!r}; expected one of "
                f"{ADMISSION_POLICIES}")
        self.policy = policy
        # grace period: how long an arrival may wait for stage space
        # before the policy sheds (0 = shed immediately on overload)
        self.max_wait_ms = max_wait_ms
        self.seed = seed
        self._rng = np.random.default_rng(seed)

    def sample_take(self, n_incoming: int, n_free: int) -> Optional[np.ndarray]:
        """``sample`` policy: seeded-uniform row indices (sorted, so
        the admitted subset keeps arrival order) sized to the free
        stage space; None admits everything."""
        if n_free >= n_incoming:
            return None
        if n_free <= 0:
            return np.empty(0, np.intp)
        idx = self._rng.choice(n_incoming, size=n_free, replace=False)
        idx.sort()
        return idx
