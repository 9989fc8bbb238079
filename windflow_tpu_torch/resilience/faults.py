"""Deterministic seeded fault-injection harness.

Recovery paths that only fire under failure are untestable without a
way to *cause* failure on demand.  A :class:`FaultPlan` describes, up
front and reproducibly, which faults fire where:

* ``crash_replica(node_substr, at_tuple)`` -- the matching replica
  raises :class:`InjectedFailure` when it takes its Nth tuple (1-based),
  simulating a mid-stream replica death;
* ``delay_puts(node_substr, delay_s, every_n)`` -- the matching
  replica sleeps before every Nth downstream put (seeded jitter),
  simulating a slow consumer / full-channel backpressure window;
* ``fail_native_build()`` -- the native toolchain probe is forced to
  fail, exercising the pure-Python fallback (and its warning);
* ``drop_put(node_substr, at_put)`` / ``dup_put(node_substr, at_put)``
  -- the matching replica's Nth channel delivery (1-based, counted at
  the Outlet layer across all destinations) is silently lost "on the
  wire" / delivered twice.  These simulate transport-plane conservation
  bugs: the emitted item is counted as intent but never (or doubly)
  reaches the channel, which the audit plane's flow ledger
  (audit/ledger.py) must flag as a conservation violation.

Attach a plan via ``RuntimeConfig.fault_plan``; ``PipeGraph.start``
binds per-node fault state (each node's counters are independent, so a
plan is deterministic regardless of thread interleaving).  Use as a
context manager to guarantee global faults (native build) are undone::

    with FaultPlan(seed=7).crash_replica("map", at_tuple=50) as plan:
        cfg = RuntimeConfig(fault_plan=plan)
        ...
"""
from __future__ import annotations

import random
import threading
import time
from typing import List, Optional


class InjectedFailure(RuntimeError):
    """Raised by a FaultPlan crash rule inside the replica loop."""


# -- forced native-build failure (module-global: the native module probes
# this from _build(), which can run before any graph exists) --------------
_native_fail_lock = threading.Lock()
_native_fail_count = 0


def native_build_forced_to_fail() -> bool:
    return _native_fail_count > 0


def _reset_native_cache() -> None:
    """Drop the cached native lib so the next probe re-runs _build()."""
    from ..runtime import native as _native
    with _native._lib_lock:
        _native._lib = None


def _arm_native_failure() -> None:
    global _native_fail_count
    with _native_fail_lock:
        _native_fail_count += 1
    _reset_native_cache()


def _disarm_native_failure() -> None:
    global _native_fail_count
    with _native_fail_lock:
        _native_fail_count = max(0, _native_fail_count - 1)
    _reset_native_cache()


class _CrashRule:
    __slots__ = ("node_substr", "at_tuple", "message")

    def __init__(self, node_substr: str, at_tuple: int, message: str):
        self.node_substr = node_substr
        self.at_tuple = at_tuple
        self.message = message


class _DelayRule:
    __slots__ = ("node_substr", "delay_s", "every_n", "jitter_s")

    def __init__(self, node_substr: str, delay_s: float, every_n: int,
                 jitter_s: float):
        self.node_substr = node_substr
        self.delay_s = delay_s
        self.every_n = every_n
        self.jitter_s = jitter_s


class _PutRule:
    """Nth-channel-delivery fault: action in {'drop', 'dup'}."""

    __slots__ = ("node_substr", "at_put", "action")

    def __init__(self, node_substr: str, at_put: int, action: str):
        self.node_substr = node_substr
        self.at_put = at_put
        self.action = action


class _LinkDropRule:
    """Nth-frame wire loss on a shuffle edge (distributed/transport.py):
    the frame is counted as sent intent but never hits the socket --
    the cross-process conservation surfaces must flag it."""

    __slots__ = ("edge_substr", "at_frame")

    def __init__(self, edge_substr: str, at_frame: int):
        self.edge_substr = edge_substr
        self.at_frame = at_frame


class _LinkDelayRule:
    """Per-frame send delay on a shuffle edge (a slow / congested
    link), seeded jitter like delay_puts."""

    __slots__ = ("edge_substr", "delay_s", "every_n")

    def __init__(self, edge_substr: str, delay_s: float, every_n: int):
        self.edge_substr = edge_substr
        self.delay_s = delay_s
        self.every_n = every_n


class LinkFaults:
    """Per-sender link fault state (bound by the distributed wiring;
    own counters, so injection is deterministic per edge)."""

    __slots__ = ("edge", "drops", "delays")

    def __init__(self, edge: str, drops: List[_LinkDropRule],
                 delays: List[_LinkDelayRule]):
        self.edge = edge
        self.drops = drops
        self.delays = delays

    def drop_frame(self, frame_no: int) -> bool:
        """True when the sender's ``frame_no``-th frame (1-based, per
        edge) must be lost on the wire."""
        return any(frame_no == r.at_frame for r in self.drops)

    def maybe_delay(self, frame_no: int) -> None:
        for r in self.delays:
            if frame_no % r.every_n == 0:
                time.sleep(r.delay_s)


class _EpochCrashRule:
    """Barrier-window crash (durability/): the replica dies while
    taking its epoch cut for ``epoch`` -- deterministic on the epoch
    id, so it cannot drift with stream timing like a tuple clock."""

    __slots__ = ("node_substr", "epoch", "message")

    def __init__(self, node_substr: str, epoch: int, message: str):
        self.node_substr = node_substr
        self.epoch = epoch
        self.message = message


class NodeFaults:
    """Per-replica fault state bound at graph start (own counters +
    own seeded RNG, so injection is deterministic per node)."""

    __slots__ = ("node_name", "crash", "delays", "put_rules",
                 "epoch_crashes", "_rng", "_emits", "_puts")

    def __init__(self, node_name: str, crash: Optional[_CrashRule],
                 delays: List[_DelayRule], seed: int,
                 put_rules: Optional[List[_PutRule]] = None,
                 epoch_crashes: Optional[List[_EpochCrashRule]] = None):
        self.node_name = node_name
        self.crash = crash
        self.delays = delays
        self.put_rules = put_rules or []
        self.epoch_crashes = epoch_crashes or []
        self._rng = random.Random((seed, node_name).__repr__())
        self._emits = 0
        self._puts = 0

    def on_tuple(self, taken: int) -> None:
        """Called by the replica loop with its 1-based take counter."""
        c = self.crash
        if c is not None and taken == c.at_tuple:
            raise InjectedFailure(
                f"{c.message} (node {self.node_name}, tuple {taken})")

    def on_epoch(self, epoch: int) -> None:
        """Called by the durability plane's epoch cut (barrier aligned,
        before the snapshot) with the epoch id."""
        for r in self.epoch_crashes:
            if epoch == r.epoch:
                raise InjectedFailure(
                    f"{r.message} (node {self.node_name}, "
                    f"epoch {epoch})")

    def before_put(self) -> None:
        """Called before each downstream emission."""
        self._emits += 1
        for d in self.delays:
            if self._emits % d.every_n == 0:
                time.sleep(d.delay_s
                           + (self._rng.random() * d.jitter_s
                              if d.jitter_s else 0.0))

    def put_action(self) -> Optional[str]:
        """Called by the Outlet layer per channel delivery (after the
        ledger counted the intent, before the actual ``put``): 'drop'
        loses the delivery on the wire, 'dup' delivers it twice, None
        delivers normally.  The counter is per node across all
        destinations, 1-based like the crash clock."""
        if not self.put_rules:
            return None
        self._puts += 1
        for r in self.put_rules:
            if self._puts == r.at_put:
                return r.action
        return None


class FaultPlan:
    """Seeded, declarative fault schedule for one (test) run."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._crashes: List[_CrashRule] = []
        self._delays: List[_DelayRule] = []
        self._put_rules: List[_PutRule] = []
        self._epoch_crashes: List[_EpochCrashRule] = []
        # network actions (distributed/; docs/DISTRIBUTED.md), consumed
        # at the shuffle-transport layer
        self._link_drops: List[_LinkDropRule] = []
        self._link_delays: List[_LinkDelayRule] = []
        self._kills: dict = {}          # worker id -> at_tuple
        # epochs whose manifest commit is torn (read by the
        # EpochCoordinator; graph-global, no node binding)
        self.torn_commit_epochs: set = set()
        # injected full-filesystem windows per durable-write kind
        # ("manifest" | "blob" | "spill"): kind -> list of (first,
        # last) 1-based write indices that raise ENOSPC.  Graph-global
        # with its own clock per kind, like torn_commit_epochs.
        self._fail_writes: dict = {}
        self._write_clock: dict = {}
        self._write_lock = threading.Lock()
        self._native_armed = False

    # -- declaration (chainable) --------------------------------------
    def crash_replica(self, node_substr: str, at_tuple: int,
                      message: str = "injected replica crash") -> "FaultPlan":
        if at_tuple < 1:
            raise ValueError("at_tuple is 1-based")
        self._crashes.append(_CrashRule(node_substr, at_tuple, message))
        return self

    def delay_puts(self, node_substr: str, delay_s: float,
                   every_n: int = 1, jitter_s: float = 0.0) -> "FaultPlan":
        if every_n < 1:
            raise ValueError("every_n must be >= 1")
        self._delays.append(_DelayRule(node_substr, delay_s, every_n,
                                       jitter_s))
        return self

    def drop_put(self, node_substr: str, at_put: int) -> "FaultPlan":
        """The matching replica's Nth channel delivery is silently lost
        between the ledger's intent book and the channel (a simulated
        transport drop the conservation auditor must flag)."""
        if at_put < 1:
            raise ValueError("at_put is 1-based")
        self._put_rules.append(_PutRule(node_substr, at_put, "drop"))
        return self

    def dup_put(self, node_substr: str, at_put: int) -> "FaultPlan":
        """The matching replica's Nth channel delivery is delivered
        twice (a simulated transport duplication the conservation
        auditor must flag)."""
        if at_put < 1:
            raise ValueError("at_put is 1-based")
        self._put_rules.append(_PutRule(node_substr, at_put, "dup"))
        return self

    def crash_at_epoch(self, node_substr: str, epoch: int,
                       message: str = "injected barrier-window crash"
                       ) -> "FaultPlan":
        """The matching replica dies INSIDE the barrier window of
        ``epoch`` (durability/: after alignment, before the snapshot)
        -- deterministic and seeded like ``crash_replica``, but keyed
        to the epoch id so barrier-window crashes cannot drift with
        stream timing.  Fires on fused-away operators too (the cut
        walks every segment's fault state)."""
        if epoch < 1:
            raise ValueError("epoch ids are 1-based")
        self._epoch_crashes.append(
            _EpochCrashRule(node_substr, epoch, message))
        return self

    def torn_commit(self, epoch: int) -> "FaultPlan":
        """The manifest commit of ``epoch`` is torn: a truncated
        payload lands at the FINAL manifest path (simulating a
        non-atomic writer dying mid-commit) and the graph dies with an
        injected failure -- the restarted run's tolerant manifest
        reader must skip the damage and fall back to the previous
        committed epoch."""
        if epoch < 1:
            raise ValueError("epoch ids are 1-based")
        self.torn_commit_epochs.add(int(epoch))
        return self

    # -- network actions (distributed/; docs/DISTRIBUTED.md) ----------
    def drop_link(self, edge_substr: str, at_frame: int) -> "FaultPlan":
        """The matching shuffle edge's Nth frame (1-based, counted at
        the sender across reconnects) is silently lost on the wire:
        sent intent counted, never delivered.  The receiver must flag
        the sequence gap and the STATS-trailer shortfall with the
        exact edge and tuple count, and the cross-process merge must
        fail the conservation identity by exactly that much."""
        if at_frame < 1:
            raise ValueError("at_frame is 1-based")
        self._link_drops.append(_LinkDropRule(edge_substr, at_frame))
        return self

    def delay_link(self, edge_substr: str, delay_ms: float,
                   every_n: int = 1) -> "FaultPlan":
        """Sleep ``delay_ms`` before every ``every_n``-th frame send on
        matching shuffle edges -- a slow link whose backpressure must
        throttle the remote producer through the credit window."""
        if every_n < 1:
            raise ValueError("every_n must be >= 1")
        self._link_delays.append(
            _LinkDelayRule(edge_substr, delay_ms / 1e3, every_n))
        return self

    def kill_worker(self, worker: int, at_tuple: int) -> "FaultPlan":
        """Hard-kill worker ``worker`` (``os._exit``, no teardown) when
        its transport tuple clock -- tuples sent plus received over its
        shuffle edges -- reaches ``at_tuple``.  Deterministic per
        worker; the run_distributed restart loop must recover from the
        newest globally-committed epoch."""
        if at_tuple < 1:
            raise ValueError("at_tuple is 1-based")
        self._kills[int(worker)] = int(at_tuple)
        return self

    def for_link(self, edge_name: str):
        """Link fault state for one shuffle edge (bound per sender by
        the distributed wiring); None when no rule matches."""
        drops = [r for r in self._link_drops
                 if r.edge_substr in edge_name]
        delays = [r for r in self._link_delays
                  if r.edge_substr in edge_name]
        if not drops and not delays:
            return None
        return LinkFaults(edge_name, drops, delays)

    def kill_tuple_for(self, worker: int):
        """The kill threshold of ``worker``'s transport clock, or None."""
        return self._kills.get(int(worker))

    def fail_write(self, path_kind: str, at_write: int = 1,
                   count: int = 1) -> "FaultPlan":
        """The filesystem "fills up" for durable writes of
        ``path_kind`` -- ``"manifest"`` (epoch manifests),
        ``"blob"`` (delta blobs) or ``"spill"`` (cold-tier segments):
        writes ``at_write .. at_write+count-1`` (1-based, counted per
        kind across the graph) raise ``OSError(ENOSPC)`` at the write
        layer.  The durability/state planes must degrade -- abort the
        epoch / keep the batch warm with a flight event -- never die.
        A large ``count`` models a disk that stays full."""
        if path_kind not in ("manifest", "blob", "spill"):
            raise ValueError(
                "path_kind must be 'manifest', 'blob' or 'spill', "
                f"not {path_kind!r}")
        if at_write < 1:
            raise ValueError("at_write is 1-based")
        if count < 1:
            raise ValueError("count must be >= 1")
        self._fail_writes.setdefault(path_kind, []).append(
            (at_write, at_write + count - 1))
        return self

    def write_should_fail(self, path_kind: str) -> bool:
        """Called by the write layer (EpochStore manifests, BlobStore
        delta blobs, SpillStore segments) before each durable write of
        ``path_kind``; advances that kind's clock and reports whether
        this write lands in an injected full-filesystem window."""
        rules = self._fail_writes.get(path_kind)
        if not rules:
            return False
        with self._write_lock:
            self._write_clock[path_kind] = n = \
                self._write_clock.get(path_kind, 0) + 1
        return any(first <= n <= last for first, last in rules)

    def fail_native_build(self) -> "FaultPlan":
        """Force the native toolchain probe to fail from now until
        ``deactivate()`` (or context-manager exit)."""
        if not self._native_armed:
            self._native_armed = True
            _arm_native_failure()
        return self

    def deactivate(self) -> None:
        if self._native_armed:
            self._native_armed = False
            _disarm_native_failure()

    # -- binding (called by PipeGraph.start per node) ------------------
    def for_node(self, node_name: str) -> Optional[NodeFaults]:
        # collector nodes ("<stage>.coll<i>" / ".collector" / ".coll.g<g>",
        # multipipe wiring) share their stage's name but are runtime
        # plumbing, not operator replicas: rules never bind to them
        if ".coll" in node_name.rsplit("/", 1)[-1]:
            return None
        crash = next((c for c in self._crashes
                      if c.node_substr in node_name), None)
        delays = [d for d in self._delays if d.node_substr in node_name]
        puts = [p for p in self._put_rules if p.node_substr in node_name]
        epochs = [e for e in self._epoch_crashes
                  if e.node_substr in node_name]
        if crash is None and not delays and not puts and not epochs:
            return None
        return NodeFaults(node_name, crash, delays, self.seed,
                          put_rules=puts, epoch_crashes=epochs)

    # -- context manager ----------------------------------------------
    def __enter__(self) -> "FaultPlan":
        return self

    def __exit__(self, *exc) -> None:
        self.deactivate()
