"""Core enums, constants and configuration for windflow_tpu_torch.

TPU-native re-design of the reference's ``wf/basic.hpp`` (enums at
basic.hpp:86-135, WinOperatorConfig at basic.hpp:154-184, GPU batching
defaults at basic.hpp:77-80).  Everything the reference spreads over
compile-time macros + builder parameters is folded into one runtime
config surface here (SURVEY.md §5 "Config / flag system").
"""
from __future__ import annotations

import enum
import os
import time
from dataclasses import dataclass, field
from typing import Any, Optional


class Mode(enum.Enum):
    """Execution modes of a PipeGraph (reference basic.hpp:86).

    DEFAULT        -- streams assumed ordered per source; no reordering plane.
    DETERMINISTIC  -- ordering collectors (watermark-by-min priority queues)
                      inserted before every operator (ref ordering_node.hpp).
    PROBABILISTIC  -- K-slack collectors; late tuples may be dropped
                      (ref kslack_node.hpp).
    """

    DEFAULT = 0
    DETERMINISTIC = 1
    PROBABILISTIC = 2


class WinType(enum.Enum):
    """Window model (reference basic.hpp:89): count-based or time-based."""

    CB = 0
    TB = 1


class OptLevel(enum.IntEnum):
    """Optimization levels (basic.hpp:92).

    Composite window operators take an ``opt_level`` per builder
    (LEVEL1 strips internal collectors, LEVEL2 thread-fuses their
    stages).  The same enum also grades the **graph compile pass**
    (:mod:`windflow_tpu_torch.graph.fuse`, ``RuntimeConfig.opt_level``):
    at LEVEL2 -- the default -- ``PipeGraph.start`` fuses maximal runs
    of adjacent single-producer FORWARD stages into single replicas
    (the ``ff_comb`` fusion of multipipe.hpp:345-390, applied
    automatically graph-wide)."""

    LEVEL0 = 0  # no optimization
    LEVEL1 = 1  # strip internal collectors where ordering is not required
    LEVEL2 = 2  # fuse distribution via tree emitters / stage fusion


class RoutingMode(enum.Enum):
    """How an operator receives its inputs (basic.hpp:95)."""

    NONE = 0
    FORWARD = 1
    KEYBY = 2
    COMPLEX = 3


class Pattern(enum.Enum):
    """Operator kinds (basic.hpp:98-123); used for diagnostics/diagrams."""

    SOURCE = 0
    FILTER = 1
    MAP = 2
    FLATMAP = 3
    ACCUMULATOR = 4
    SINK = 5
    WIN_SEQ = 6
    WIN_FARM = 7
    KEY_FARM = 8
    PANE_FARM = 9
    WIN_MAPREDUCE = 10
    WIN_SEQFFAT = 11
    KEY_FFAT = 12
    WIN_SEQ_TPU = 13
    WIN_FARM_TPU = 14
    KEY_FARM_TPU = 15
    PANE_FARM_TPU = 16
    WIN_MAPREDUCE_TPU = 17
    WIN_SEQFFAT_TPU = 18
    KEY_FFAT_TPU = 19


class WinEvent(enum.Enum):
    """Events raised by a window on a new tuple (basic.hpp:126)."""

    OLD = 0       # tuple precedes the window extent
    IN = 1        # tuple belongs to the window
    DELAYED = 2   # TB only: past the extent but within the triggering delay
    FIRED = 3     # tuple proves the window complete
    BATCHED = 4   # window already handed to a device batch


class OrderingMode(enum.Enum):
    """What field the ordering collector sorts on (basic.hpp:129)."""

    ID = 0
    TS = 1
    TS_RENUMBERING = 2


class Role(enum.Enum):
    """Role of a windowed engine inside a composite operator (basic.hpp:132)."""

    SEQ = 0
    PLQ = 1
    WLQ = 2
    MAP = 3
    REDUCE = 4


# Defaults mirroring reference basic.hpp:74-83, re-targeted at TPU batching.
DEFAULT_BATCH_SIZE_TB = 1000      # initial device batch for TB windows
DEFAULT_UPDATE_INTERVAL_USEC = 100_000
DEFAULT_QUEUE_CAPACITY = 2048     # bounded SPSC queue capacity (backpressure)
DEFAULT_MICROBATCH = 256          # host-plane micro-batch (tuples per queue item)


def current_time_usecs() -> int:
    """Monotonic microseconds (reference basic.hpp:51-71 clock helpers)."""
    return time.monotonic_ns() // 1000


def current_time_nsecs() -> int:
    return time.monotonic_ns()


@dataclass
class WinOperatorConfig:
    """Distributed window-id assignment parameters (basic.hpp:154-184).

    A windowed engine replica inside a composite operator learns which
    global windows it owns from (id, n, slide) pairs at two nesting
    levels ("outer" = the enclosing farm, "inner" = the stage inside).
    The gwid/initial-id arithmetic consuming these lives in
    ``core.win_assign`` (reference win_seq.hpp:348-357).
    """

    id_outer: int = 0
    n_outer: int = 1
    slide_outer: int = 0
    id_inner: int = 0
    n_inner: int = 1
    slide_inner: int = 0


@dataclass(frozen=True)
class ElasticSpec:
    """Per-operator elasticity declaration (builders
    ``.with_elasticity(min, max, target_util)``; docs/ELASTIC.md).

    The elastic controller keeps the operator's replica count inside
    ``[min_replicas, max_replicas]``, steering toward ``target_util``
    busy fraction per replica.  Manual ``PipeGraph.rescale`` calls are
    bounded by the same interval."""

    min_replicas: int
    max_replicas: int
    target_util: float = 0.75


@dataclass(frozen=True)
class DurabilityConfig:
    """Exactly-once epoch configuration (durability/;
    docs/RESILIENCE.md "Exactly-once epochs").

    ``RuntimeConfig.durability = DurabilityConfig(...)`` turns on the
    epoch coordinator: aligned barrier markers are injected at every
    source replica each ``epoch_interval_s``, ride the channel planes
    as control items, and snapshot each replica's state as they pass --
    WITHOUT stopping the graph.  Each epoch atomically commits
    {per-replica state, per-source offsets, epoch id} as a manifest
    under ``path`` (write-temp + fsync + atomic rename), keeping the
    newest ``retained`` manifests.  An epoch older than
    ``stall_factor x epoch_interval_s`` without a commit flags the
    ``Stalled`` gauge (and the doctor verdict)."""

    epoch_interval_s: float = 1.0
    path: str = "epochs"
    retained: int = 3
    stall_factor: float = 5.0
    # incremental (delta) snapshots: keyed replica state is serialized
    # as content-addressed blobs beside the manifest and manifests
    # reference unchanged blobs from prior epochs instead of
    # re-pickling them -- commit cost becomes O(changed keys).  Each
    # replica's manifest entry is a blob CHAIN (base + per-epoch
    # deltas); after ``delta_chain_max`` links the encoder compacts the
    # chain back to a fresh base.  Unreferenced blobs are GCed with the
    # manifests that referenced them (honoring ``retained``).  Off by
    # default: full re-pickle per epoch, the schema-1 manifest shape.
    delta: bool = False
    delta_chain_max: int = 8
    # strict exactly-once: a source without a state_dict (offset not
    # checkpointable) is a hard RuntimeError at attach instead of a
    # RuntimeWarning, so exactly-once cannot silently degrade to
    # replay-from-start (docs/RESILIENCE.md)
    strict: bool = False


@dataclass(frozen=True)
class StateTierConfig:
    """Tiered keyed-state tuning (state/; docs/RESILIENCE.md "Tiered
    state & memory pressure").  Only consulted when
    ``RuntimeConfig.state_budget_bytes`` is set; the defaults are the
    tested operating point, so most graphs never touch this."""

    # budget fractions where demotion (hot -> warm pickles) and disk
    # spill (warm -> cold segments) start; past the budget itself the
    # store SHEDS coldest keys into dead_letters (state_pressure)
    demote_frac: float = 0.7
    spill_frac: float = 0.85
    # optional hard cap on live hot objects per replica (None = bytes
    # budget only)
    hot_max_keys: Optional[int] = None
    # store operations between maintenance passes on the replica thread
    maintain_every: int = 64
    # cold keys per spill segment file
    spill_batch: int = 256


@dataclass(frozen=True)
class SupervisionConfig:
    """Replica self-healing policy (durability/supervision.py;
    docs/RESILIENCE.md "Supervised replica restart").

    ``RuntimeConfig.supervision = SupervisionConfig(...)`` arms the
    replica supervisor for operators marked ``.with_restartable()``: a
    replica crash there no longer cancels the graph -- the supervisor
    quiesces through the rescale machinery, rebuilds the replica from
    the last committed epoch's state slice and resumes, with bounded
    jittered exponential backoff between attempts.  Only when
    ``max_restarts`` attempts are exhausted does the failure escalate
    to the graph-level ``NodeFailureError`` path.  Requires the
    durability plane (``RuntimeConfig.durability``): without committed
    epochs there is no consistent state slice to rebuild from."""

    max_restarts: int = 3
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 2.0
    jitter: float = 0.5
    # deterministic backoff jitter for tests; None seeds from the OS
    seed: Optional[int] = None


@dataclass
class RuntimeConfig:
    """Global runtime knobs (folds the reference's macro set: README
    "Macros" -- TRACE_WINDFLOW, FF_BOUNDED_BUFFER, DEFAULT_BUFFER_CAPACITY,
    BLOCKING_MODE, NO_DEFAULT_MAPPING, DASHBOARD_MACHINE/PORT, LOG_DIR)."""

    mode: Mode = Mode.DEFAULT
    tracing: bool = False
    # second tracing level: raw channel stats (puts/gets/high-watermark)
    # dumped at wait_end -- the -DTRACE_FASTFLOW analogue
    # (pipegraph.hpp:711-733)
    trace_runtime: bool = False
    bounded_queues: bool = True
    queue_capacity: int = DEFAULT_QUEUE_CAPACITY
    microbatch: int = DEFAULT_MICROBATCH
    dashboard_machine: str = "localhost"
    dashboard_port: int = 20207
    log_dir: str = "log"
    # prefer the C++ host runtime when built; WINDFLOW_NATIVE=0 forces
    # the pure-Python plane (the CI matrix's second job)
    use_native_runtime: bool = field(default_factory=lambda: os.environ.get(
        "WINDFLOW_NATIVE", "1") != "0")
    # lower fully-declared record chains (Expr filters/maps + builtin
    # window + sink) onto the native C++ record pipeline at run()
    native_record_lowering: bool = True
    # -- failure containment (resilience/; docs/RESILIENCE.md) ----------
    # stall watchdog: cancel/dump when no channel makes progress for
    # this many seconds (None/0 = disabled)
    watchdog_timeout_s: Optional[float] = None
    # True: the watchdog cancels the graph (wait_end raises StallError);
    # False: it only dumps the channel/thread report and re-arms
    watchdog_cancel: bool = True
    # after a cancellation, how long wait_end waits for each replica
    # thread still stuck in user code before abandoning it
    cancel_grace_s: float = 5.0
    # resilience.faults.FaultPlan bound to the graph at start() (tests)
    fault_plan: Any = None
    # -- ingestion plane (ingest/; docs/INGEST.md) ----------------------
    # end-to-end latency budget for ingest-fed runs: the adaptive
    # microbatch controller AIMDs coalesced batch size / flush interval
    # against it and rewrites directly-fed device engines' launch
    # delay, replacing the static microbatch knobs (None = keep the
    # static operating point)
    latency_target_ms: Optional[float] = None
    # default per-source-replica credit budget (tuples outstanding in
    # outlet channels before the transport stops reading)
    ingest_credits: int = 1 << 16
    # -- graph compile pass (graph/fuse.py; docs/RUNTIME.md) ------------
    # LEVEL2 (default): PipeGraph.start fuses maximal runs of adjacent
    # single-producer FORWARD stages into one replica thread each,
    # preserving per-segment error policies / stats / faults /
    # checkpoint state.  Set LEVEL0 (or LEVEL1) to opt out.
    opt_level: "OptLevel" = OptLevel.LEVEL2
    # whole-partition device step (graph/device_step.py; ROADMAP item
    # 3): at LEVEL2, device-placed segments additionally lower to
    # chunk-granular launch control -- forward edges merge into
    # device-eligible consumers (source heads included) and every
    # device-lane window engine launches ONCE per ingest chunk instead
    # of per trigger site.  WINDFLOW_DEVICE_STEP=0 (or False here)
    # opts out; a LEVEL0/LEVEL1 opt_level disables it implicitly.
    device_step: bool = field(
        default_factory=lambda: os.environ.get(
            "WINDFLOW_DEVICE_STEP", "1") != "0")
    # per-graph column-buffer pool (core/tuples.ColumnPool): partition
    # sub-batches, SynthChunk materialization and ingest staging reuse
    # arena buffers instead of allocating per batch.  False = every
    # batch allocates fresh numpy columns (the pre-pool behaviour).
    buffer_pool: bool = True
    # -- telemetry plane (telemetry/; docs/OBSERVABILITY.md) ------------
    # deterministic 1-in-N source sampling period for end-to-end
    # latency tracing (trace contexts + residency/e2e histograms).
    # Active only under ``tracing``; 0 keeps the counter surface but
    # disables every per-item trace stamp (the bitwise-identical
    # operating point).  Sources can override per operator via
    # ``SourceBuilder.with_tracing(sample_rate)``.
    trace_sample: int = 128
    # bounded structured-event ring (telemetry/recorder.py): rescales,
    # placements, batch resizes, credit stalls, sheds, svc failures,
    # checkpoint epochs, conservation violations, frontier stalls.
    # Dumped as JSONL on watchdog stalls, node failures and failed
    # final conservation checks.  0 disables recording.
    flight_recorder_events: int = 512
    # -- audit plane (audit/; docs/OBSERVABILITY.md) --------------------
    # online flow-conservation ledger + progress/frontier tracking +
    # keyed-state census: a GraphAuditor thread proves per-edge
    # transport conservation while the graph runs (and exactly at
    # wait_end), publishes per-operator frontiers/lag, and reports key
    # skew.  False disables the auditor and all per-delivery ledger
    # accounting (the pre-audit hot path).
    audit: bool = True
    # seconds between online audit passes (ledger check + frontier
    # propagation + census refresh)
    audit_interval_s: float = 0.25
    # a pending operator whose frontier does not advance for this long
    # while upstream frontiers moved is reported as a stalled frontier
    # (flight-recorder `frontier_stall` + stats flag)
    frontier_stall_s: float = 5.0
    # hot-key sketch capacity per KEYBY emitter (space-saving top-K)
    audit_topk: int = 16
    # -- diagnosis plane (diagnosis/; docs/OBSERVABILITY.md) ------------
    # critical-path latency attribution + backpressure root-cause walk
    # + rolling gauge history + EWMA/MAD regression detection, ticking
    # on the monitor/auditor cadences and published as the Diagnosis /
    # History stats-JSON blocks (PipeGraph.explain(), the dashboard
    # /explain endpoint read them).
    # Purely observational: off restores the pre-diagnosis report shape
    # with bitwise-identical results either way.
    diagnosis: bool = True
    # minimum seconds between diagnosis ticks (stacked callers --
    # monitor, auditor, explain() -- are rate-limited to this)
    diagnosis_interval_s: float = 1.0
    # rolling gauge-history ring length (snapshot rows kept per graph)
    history_len: int = 120
    # regression band half-width in (MAD-derived) sigmas, and the
    # samples a fresh series feeds its baseline before the band arms
    anomaly_band_k: float = 4.0
    anomaly_warmup: int = 12
    # dashboard-less snapshot fallback (monitoring/monitor.py): keep at
    # most this many *_stats.json snapshot files in log_dir (rotation
    # deletes the oldest); <= 0 keeps every file (the pre-rotation
    # behaviour)
    snapshot_keep: int = 16
    # -- online re-planning (graph/replanner.py; docs/PLANNER.md
    # "Resident state & online re-planning") ----------------------------
    # The start-time placement decision becomes a running hypothesis:
    # a re-planner riding the diagnosis tick compares each auto-placed
    # window engine's MEASURED per-launch wall (and its attribution
    # split into device transport vs compute) against the cost model's
    # projection, and when they contradict it for ``replan_ticks``
    # consecutive ticks, swaps that engine's lane device<->host mid-run
    # through the quiesce/migrate path with zero lost tuples -- a
    # ``replacement`` flight event doctor explains.  Off by default:
    # flipping lanes mid-run trades determinism of the operating point
    # for adaptivity, which is an operator's call.
    replan: bool = False
    # consecutive contradicting diagnosis ticks before a lane flip
    replan_ticks: int = 3
    # -- elastic scaling plane (elastic/; docs/ELASTIC.md) --------------
    # elastic.controller.ElasticityConfig tuning the load-driven
    # controller (sample period, EWMA alpha, cooldown, hysteresis,
    # backlog trigger), or None for the defaults.  The controller only
    # starts when some operator declared .with_elasticity(...); setting
    # ``ElasticityConfig(enabled=False)`` keeps it off while manual
    # PipeGraph.rescale(...) calls stay available.
    elasticity: Any = None
    # -- durability plane (durability/; docs/RESILIENCE.md) -------------
    # DurabilityConfig turning on exactly-once epoch barriers: aligned
    # snapshot markers injected at sources each epoch_interval_s,
    # per-replica state captured as they pass (no graph-wide quiesce),
    # atomically-committed epoch manifests, and the transactional /
    # idempotent sink contract (SinkBuilder.with_exactly_once).  None
    # (the default) keeps the pre-durability hot path untouched.
    durability: Any = None
    # -- tiered keyed state (state/; docs/RESILIENCE.md "Tiered state
    # & memory pressure") -----------------------------------------------
    # hard per-graph budget for in-memory keyed state, split evenly
    # across the replicas whose logics expose enable_tiered_state
    # (AccumulatorLogic today).  Approaching a replica's share demotes
    # LRU keys to pickled host bytes, then spills the oldest to
    # crash-safe disk segments under <log_dir>/state_spill/; past the
    # hard ceiling the coldest keys are SHED into dead_letters with a
    # state_pressure flight event -- degraded and loud, never an
    # allocator crash.  None (the default) keeps every keyed store a
    # plain in-memory dict (the pre-tiering hot path).
    state_budget_bytes: Optional[int] = None
    # StateTierConfig tuning the watermarks/batching, or None for the
    # defaults
    state_tiers: Any = None
    # SupervisionConfig arming supervised replica self-healing for
    # operators marked .with_restartable(): replica crashes there are
    # healed in place from the last committed epoch instead of failing
    # the graph (durability/supervision.py; docs/RESILIENCE.md).
    # Requires ``durability``.  None (the default) keeps today's
    # fail-fast path for every replica.
    supervision: Any = None
    # -- SLO plane (slo/; docs/OBSERVABILITY.md "SLO plane") ------------
    # slo.SloConfig declaring this graph's objectives (e2e p99 budget,
    # throughput floor, frontier-lag ceiling).  Evaluated continuously
    # on the diagnosis tick with multi-window error-budget burn-rate
    # accounting: breaches open slo_breach/slo_recovered flight
    # episodes, surface as the Slo stats block, windflow_slo_* metrics
    # and a worst-news-first doctor verdict line.  None (the default)
    # keeps the plane off; PipeGraph.with_slo(...) is the builder-style
    # way to set it.
    slo: Any = None
    # -- distributed runtime plane (distributed/; docs/DISTRIBUTED.md) --
    # distributed.DistributedSpec partitioning this graph across worker
    # processes: PipeGraph.start prunes to the worker's own partition
    # and carries every cross-worker edge over the credit-backpressured
    # shuffle transport.  None (the default) = single-process graph;
    # normally set by the worker entry point, not by hand.
    distributed: Any = None
    # -- global-scheduler plane (scheduler/; docs/SERVING.md) -----------
    # a scheduler.leases.FairShareLease gating this graph's consume
    # loops so co-resident tenants in one worker share cores by
    # weighted credit instead of the OS scheduler.  Bound to every
    # runtime node at start; a lease-less graph (the default) pays
    # nothing.  Normally set by a fair-share Server, not by hand.
    sched_lease: Any = None
    # -- device (the torch port) ----------------------------------------
    # torch device of every device-lane window engine in the graph,
    # applied by the planner at PipeGraph.start to engines built
    # without an explicit ``device``.  "cuda" (the default) raises at
    # start when no CUDA device is present -- the port never quietly
    # runs on the CPU; "cpu" runs the kernels' plain versions (tests).
    device: str = "cuda"
