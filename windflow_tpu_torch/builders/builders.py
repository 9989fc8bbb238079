"""Fluent builders: the user-facing construction API.

Re-design of reference ``wf/builders.hpp`` (13 CPU builders, :49-2357).
Method surface kept: withName / withParallelism / withCBWindows /
withTBWindows(len, slide[, delay]) / withClosingFunction /
withInitialValue / withOptLevel / build.  Both snake_case and the
reference's camelCase spellings are provided so users of the reference
can port code mechanically.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

from ..core.basic import OptLevel, WinType
from ..core.tuples import BasicRecord
from ..operators.basic_ops import (Accumulator, Filter, FlatMap, Map, Sink,
                                   Source)
from ..operators.win_seq import WinSeq


def _alias_camel(cls):
    """Attach camelCase aliases for every with_/build method, including
    ones inherited from mixins (the window-parameter surface lives on a
    shared base, so walk the MRO, nearest definition winning).  Also
    wraps ``build`` so builder-level operator attributes shared by every
    operator kind (the error policy) land on the built descriptor
    without each build() re-implementing the copy."""
    build = cls.__dict__.get("build")
    if build is not None and not getattr(build, "_wf_wrapped", False):
        import functools

        @functools.wraps(build)
        def build_wrapper(self, *a, **kw):
            op = build(self, *a, **kw)
            policy = getattr(self, "error_policy", "fail")
            if policy != "fail":
                op.error_policy = policy
            pin = getattr(self, "worker_pin", None)
            if pin is not None:
                op.worker = pin
            spec = getattr(self, "elasticity", None)
            if spec is not None:
                if op.parallelism > spec.max_replicas:
                    raise ValueError(
                        f"operator {op.name!r}: with_parallelism"
                        f"({op.parallelism}) exceeds with_elasticity "
                        f"max_replicas={spec.max_replicas}")
                # starting parallelism is the declared one raised into
                # the elastic interval (with_parallelism left at 1 under
                # with_elasticity(2, 8) means "start at the minimum")
                op.elasticity = spec
                op.parallelism = max(op.parallelism, spec.min_replicas)
            if getattr(self, "restartable", False):
                op.restartable = True
            return op

        build_wrapper._wf_wrapped = True
        cls.build = build_wrapper
    targets = {}
    for klass in cls.__mro__:
        for name, fn in vars(klass).items():
            if name not in targets and (name.startswith("with_")
                                        or name in ("build_ptr",)):
                targets[name] = fn
    for name, fn in targets.items():
        parts = name.split("_")
        camel = parts[0] + "".join(p.upper() if p in ("cb", "tb", "tpu")
                                   else p.capitalize()
                                   for p in parts[1:])
        setattr(cls, camel, fn)
    return cls


class _BuilderBase:
    _default_name = "op"

    def __init__(self, fn):
        self.fn = fn
        self.name = self._default_name
        self.parallelism = 1
        self.closing_func = None
        self.error_policy = "fail"
        self.elasticity = None
        self.worker_pin = None
        self.restartable = False

    def with_name(self, name: str):
        self.name = name
        return self

    def with_parallelism(self, n: int):
        self.parallelism = n
        return self

    def with_closing_function(self, fn: Callable):
        self.closing_func = fn
        return self

    def with_error_policy(self, policy: str):
        """Per-tuple svc failure handling for this operator:
        ``'fail'`` (default -- the replica dies and the graph cancels),
        ``'skip'`` (drop the offending tuple, count it) or
        ``'dead_letter'`` (skip + quarantine the tuple with node name
        and traceback in ``graph.dead_letters``).  See
        docs/RESILIENCE.md."""
        from ..resilience.policies import validate_policy
        self.error_policy = validate_policy(policy)
        return self

    def with_worker(self, worker: int):
        """Pin this operator to worker ``worker`` of a distributed run
        (docs/DISTRIBUTED.md): the partition planner places its whole
        co-located group there, and an edge between two differently-
        pinned operators becomes a cut (carried by the shuffle
        transport) even when it is a FORWARD edge.  Ignored outside
        ``RuntimeConfig.distributed`` runs."""
        worker = int(worker)
        if worker < 0:
            raise ValueError("with_worker: worker ids are >= 0")
        self.worker_pin = worker
        return self

    def with_elasticity(self, min_replicas: int, max_replicas: int,
                        target_util: float = 0.75):
        """Declare this operator elastically scalable at runtime
        (docs/ELASTIC.md): the elastic controller (or manual
        ``PipeGraph.rescale``) adjusts its replica count inside
        ``[min_replicas, max_replicas]``, steering toward
        ``target_util`` busy fraction per replica.  Keys repartition by
        the same ``hash % parallelism`` contract the KEYBY emitter
        uses; per-key state (Accumulator) migrates across the rescale.
        Supported for single-stage Filter/Map/FlatMap/Accumulator
        operators in Mode.DEFAULT graphs."""
        from ..core.basic import ElasticSpec
        if min_replicas < 1 or max_replicas < min_replicas:
            raise ValueError(
                "with_elasticity: need 1 <= min_replicas <= max_replicas")
        if not 0.0 < target_util <= 1.0:
            raise ValueError(
                "with_elasticity: target_util must be in (0, 1]")
        self.elasticity = ElasticSpec(min_replicas, max_replicas,
                                      target_util)
        return self

    def with_restartable(self):
        """Mark this operator's replicas individually restartable under
        supervision (docs/RESILIENCE.md "Supervised replica restart"):
        with ``RuntimeConfig.supervision`` set (which requires the
        durability plane), a crash in one of its replicas is healed in
        place -- the supervisor quiesces, rebuilds the replica from
        the last committed epoch's state slice and resumes -- instead
        of failing the whole graph.  Needs a fresh-replica factory
        (the same contract as elasticity: single-stage Filter / Map /
        FlatMap / Accumulator operators); without supervision
        configured the mark is inert."""
        self.restartable = True
        return self

    def build_ptr(self):
        return self.build()


class _WinBuilderBase(_BuilderBase):
    """Shared window-spec surface (builders.hpp:851-858 and peers)."""

    def __init__(self, fn):
        super().__init__(fn)
        self.win_len = None
        self.slide_len = None
        self.win_type = None
        self.triggering_delay = 0
        self.opt_level = OptLevel.LEVEL0
        self.result_factory = BasicRecord
        self.incremental = False

    def with_cb_windows(self, win_len: int, slide_len: int):
        self.win_type = WinType.CB
        self.win_len = win_len
        self.slide_len = slide_len
        return self

    def with_tb_windows(self, win_len_us: int, slide_len_us: int,
                        triggering_delay_us: int = 0):
        self.win_type = WinType.TB
        self.win_len = win_len_us
        self.slide_len = slide_len_us
        self.triggering_delay = triggering_delay_us
        return self

    def with_opt_level(self, level: OptLevel):
        self.opt_level = OptLevel(level)
        return self

    def with_result_type(self, factory: Callable[[], Any]):
        self.result_factory = factory
        return self

    def with_incremental(self, incremental: bool = True):
        """Select the incremental (winupdate) query style; the reference
        dispatches on the callable's C++ signature (meta.hpp), Python
        cannot, so it is explicit here."""
        self.incremental = incremental
        return self

    def _check_windows(self):
        if self.win_type is None:
            raise ValueError(
                f"{type(self).__name__}: call with_cb_windows or "
                "with_tb_windows before build()")


@_alias_camel
class SourceBuilder(_BuilderBase):
    """Builds the classic shipper-style :class:`Source` from a callable,
    or -- via the ``from_socket`` / ``from_replay`` / ``from_async``
    constructors -- an ingest-plane source (docs/INGEST.md) with
    credit-based backpressure, an adaptive microbatch controller and
    optional admission control."""

    _default_name = "source"

    def __init__(self, fn=None):
        super().__init__(fn)
        self._ingest_kind = None
        self._ingest_args: dict = {}
        self.credits = None           # None = RuntimeConfig.ingest_credits
        self.admission = None
        self.latency_target_ms = None
        self.initial_batch = None
        self.trace_sample = None      # None = RuntimeConfig.trace_sample

    # -- ingest-plane constructors (windflow_tpu/ingest/) ---------------
    @classmethod
    def from_socket(cls, host: str, port: int,
                    connect_timeout_s: float = 10.0) -> "SourceBuilder":
        """Non-blocking framed-TCP source (ingest.codec protocol); each
        replica opens one client connection."""
        b = cls(None)
        b._ingest_kind = "socket"
        b._ingest_args = dict(host=host, port=port,
                              connect_timeout_s=connect_timeout_s)
        b.name = "socket_source"
        return b

    @classmethod
    def from_replay(cls, trace, speedup: Optional[float] = 1.0,
                    ts_unit_s: float = 1e-6, chunk: Optional[int] = 65536,
                    seed: int = 0) -> "SourceBuilder":
        """Timestamp-faithful replay of a recorded trace (TupleBatch,
        dict of columns, or .npz path) at ``speedup`` x real time
        (None = as fast as possible); deterministic under ``seed``."""
        b = cls(None)
        b._ingest_kind = "replay"
        b._ingest_args = dict(trace=trace, speedup=speedup,
                              ts_unit_s=ts_unit_s, chunk=chunk, seed=seed)
        b.name = "replay"
        return b

    @classmethod
    def from_async(cls, factory) -> "SourceBuilder":
        """Async-generator source: ``factory()`` is called per replica
        and must return an async generator yielding TupleBatch items or
        records."""
        b = cls(None)
        b._ingest_kind = "async"
        b._ingest_args = dict(factory=factory)
        b.name = "async_source"
        return b

    # -- ingest-plane knobs ---------------------------------------------
    def with_credits(self, budget: int) -> "SourceBuilder":
        """Per-replica credit budget: tuples outstanding in outlet
        channels before the transport stops reading."""
        self.credits = budget
        return self

    def with_admission(self, policy: str, max_wait_ms: float = 0.0,
                       seed: int = 0) -> "SourceBuilder":
        """Overload policy ('drop_newest' | 'drop_oldest' | 'sample'):
        shed instead of blocking once an arrival has waited
        ``max_wait_ms`` for stage space; shed tuples are quarantined in
        ``graph.dead_letters`` (docs/INGEST.md)."""
        from ..ingest.admission import AdmissionConfig
        self.admission = AdmissionConfig(policy, max_wait_ms, seed)
        return self

    def with_latency_target(self, target_ms: float) -> "SourceBuilder":
        """Per-source latency budget override for the microbatch
        controller (defaults to RuntimeConfig.latency_target_ms)."""
        self.latency_target_ms = target_ms
        return self

    def with_microbatch(self, initial_batch: int) -> "SourceBuilder":
        """Initial coalesced batch size; the AIMD controller adapts
        from here (this replaces the static RuntimeConfig.microbatch
        knob for ingest-fed runs)."""
        self.initial_batch = initial_batch
        return self

    def with_tracing(self, sample_rate: int) -> "SourceBuilder":
        """Per-source end-to-end latency-tracing period
        (docs/OBSERVABILITY.md): every ``sample_rate``-th emitted item
        starts a trace context that rides to the sinks and lands in the
        per-operator residency and graph e2e histograms.  Overrides
        ``RuntimeConfig.trace_sample`` for this source; 0 opts this
        source out of sampling.  Active only under
        ``RuntimeConfig.tracing``."""
        sample_rate = int(sample_rate)
        if sample_rate < 0:
            raise ValueError("with_tracing: sample_rate must be >= 0")
        self.trace_sample = sample_rate
        return self

    def with_error_policy(self, policy: str):
        """Sources reject non-default policies loudly: a generation
        loop has no per-tuple svc boundary, so 'skip'/'dead_letter'
        would validate here and then be silently ignored at runtime."""
        from ..resilience.policies import validate_policy
        if validate_policy(policy) != "fail":
            raise ValueError(
                "sources always fail hard: error policies apply to "
                "per-tuple svc processing (docs/RESILIENCE.md)")
        return self

    def with_elasticity(self, *a, **kw):
        """Sources cannot rescale at runtime: rescaling a generation
        loop would need offset repartitioning across replicas, which
        only the source callable could define (docs/ELASTIC.md)."""
        raise ValueError("sources are not elastically scalable")

    def build(self):
        if self._ingest_kind is None:
            if self.fn is None:
                raise ValueError(
                    "SourceBuilder needs a generation function, or use "
                    "from_socket/from_replay/from_async (docs/INGEST.md)")
            op = Source(self.fn, self.parallelism, self.name,
                        self.closing_func)
            op.trace_sample = self.trace_sample
            return op
        from ..ingest.sources import (AsyncGeneratorSource, ReplaySource,
                                      SocketSource)
        kw = dict(parallelism=self.parallelism, name=self.name,
                  credits=self.credits, admission=self.admission,
                  latency_target_ms=self.latency_target_ms,
                  initial_batch=self.initial_batch,
                  closing_func=self.closing_func)
        if self._ingest_kind == "socket":
            op = SocketSource(**self._ingest_args, **kw)
        elif self._ingest_kind == "replay":
            op = ReplaySource(**self._ingest_args, **kw)
        else:
            op = AsyncGeneratorSource(**self._ingest_args, **kw)
        op.trace_sample = self.trace_sample
        return op


@_alias_camel
class FilterBuilder(_BuilderBase):
    _default_name = "filter"

    def __init__(self, fn):
        super().__init__(fn)
        self.keyed = False

    def with_key_by(self):
        self.keyed = True
        return self

    def build(self) -> Filter:
        return Filter(self.fn, self.parallelism, self.name,
                      self.closing_func, self.keyed)


@_alias_camel
class MapBuilder(_BuilderBase):
    _default_name = "map"

    def __init__(self, fn):
        super().__init__(fn)
        self.keyed = False

    def with_key_by(self):
        self.keyed = True
        return self

    def build(self) -> Map:
        return Map(self.fn, self.parallelism, self.name, self.closing_func,
                   self.keyed)


@_alias_camel
class FlatMapBuilder(_BuilderBase):
    _default_name = "flatmap"

    def __init__(self, fn):
        super().__init__(fn)
        self.keyed = False

    def with_key_by(self):
        self.keyed = True
        return self

    def build(self) -> FlatMap:
        return FlatMap(self.fn, self.parallelism, self.name,
                       self.closing_func, self.keyed)


@_alias_camel
class AccumulatorBuilder(_BuilderBase):
    _default_name = "accumulator"

    def __init__(self, fn):
        super().__init__(fn)
        self.init_value = None

    def with_initial_value(self, value: Any):
        self.init_value = value
        return self

    def build(self) -> Accumulator:
        if self.init_value is None:
            self.init_value = BasicRecord()
        return Accumulator(self.fn, self.init_value, self.parallelism,
                           self.name, self.closing_func)


@_alias_camel
class SinkBuilder(_BuilderBase):
    _default_name = "sink"

    def __init__(self, fn):
        super().__init__(fn)
        self.exactly_once = None

    def with_exactly_once(self, mode: str = "transactional"):
        """Exactly-once sink contract under the durability plane
        (``RuntimeConfig.durability``; docs/RESILIENCE.md):

        * ``'transactional'`` -- effects buffer per epoch; the aligned
          barrier seals the buffer and the coordinator releases it only
          after the epoch's manifest committed durably.  A crash
          discards unreleased effects; the restart regenerates exactly
          them.
        * ``'idempotent'`` -- effects apply immediately through an
          epoch-keyed writer (``write(epoch, item)``, e.g.
          ``windflow_tpu.durability.EpochTaggedStore``); recovery
          truncates the writer above the restored epoch.  The contract
          for side channels keyed by epoch id (the stats / dead-letter
          surfaces)."""
        if mode not in ("transactional", "idempotent"):
            raise ValueError(
                "with_exactly_once: mode must be 'transactional' or "
                f"'idempotent', not {mode!r}")
        self.exactly_once = mode
        return self

    def build(self) -> Sink:
        return Sink(self.fn, self.parallelism, self.name,
                    self.closing_func, exactly_once=self.exactly_once)


@_alias_camel
class WinSeqBuilder(_WinBuilderBase):
    _default_name = "win_seq"

    def build(self) -> WinSeq:
        self._check_windows()
        return WinSeq(self.fn, self.win_len, self.slide_len, self.win_type,
                      self.triggering_delay, self.incremental, self.name,
                      self.result_factory, self.closing_func)


from ..operators.win_farm import WinFarm
from ..operators.key_farm import KeyFarm
from ..operators.pane_farm import PaneFarm
from ..operators.win_mapreduce import WinMapReduce
from ..operators.win_seqffat import KeyFFAT, WinSeqFFAT


@_alias_camel
class WinFarmBuilder(_WinBuilderBase):
    """builders.hpp:1127 -- window-parallel farm."""

    _default_name = "win_farm"

    def __init__(self, fn):
        super().__init__(fn)
        self.ordered = True

    def with_ordered(self, ordered: bool = True):
        self.ordered = ordered
        return self

    def build(self):
        from ..operators.nesting import NestedWinFarm
        from ..operators.pane_farm import PaneFarm
        from ..operators.win_mapreduce import WinMapReduce
        if isinstance(self.fn, (PaneFarm, WinMapReduce)):
            # nesting constructor (win_farm.hpp:259-378): replicate the
            # inner complex operator; windowing comes from the inner op
            return NestedWinFarm(self.fn, self.parallelism, self.name,
                                 self.ordered, self.opt_level)
        self._check_windows()
        return WinFarm(self.fn, self.win_len, self.slide_len, self.win_type,
                       self.parallelism, self.triggering_delay,
                       self.incremental, self.name, self.result_factory,
                       self.closing_func, self.ordered, self.opt_level)


@_alias_camel
class KeyFarmBuilder(_WinBuilderBase):
    """builders.hpp:1350 -- key-partitioned farm."""

    _default_name = "key_farm"

    def build(self):
        from ..operators.nesting import NestedKeyFarm
        from ..operators.pane_farm import PaneFarm
        from ..operators.win_mapreduce import WinMapReduce
        if isinstance(self.fn, (PaneFarm, WinMapReduce)):
            # nesting constructor (key_farm.hpp:254-...)
            return NestedKeyFarm(self.fn, self.parallelism, self.name,
                                 self.opt_level)
        self._check_windows()
        return KeyFarm(self.fn, self.win_len, self.slide_len, self.win_type,
                       self.parallelism, self.triggering_delay,
                       self.incremental, self.name, self.result_factory,
                       self.closing_func, self.opt_level)


class _TwoStageWinBuilder(_WinBuilderBase):
    """Shared by PaneFarm (PLQ/WLQ) and WinMapReduce (MAP/REDUCE)."""

    def __init__(self, fn1, fn2):
        super().__init__(fn1)
        self.fn2 = fn2
        self.par1 = 1
        self.par2 = 1
        self.incremental2 = False
        self.ordered = True

    def with_ordered(self, ordered: bool = True):
        self.ordered = ordered
        return self


@_alias_camel
class PaneFarmBuilder(_TwoStageWinBuilder):
    """builders.hpp:1762 -- pane decomposition (PLQ + WLQ)."""

    _default_name = "pane_farm"

    def with_parallelism(self, plq: int, wlq: int = None):
        self.par1 = plq
        self.par2 = wlq if wlq is not None else plq
        return self

    withParallelism = with_parallelism

    def with_plq_incremental(self, inc: bool = True):
        self.incremental = inc
        return self

    def with_wlq_incremental(self, inc: bool = True):
        self.incremental2 = inc
        return self

    def build(self) -> PaneFarm:
        self._check_windows()
        return PaneFarm(self.fn, self.fn2, self.win_len, self.slide_len,
                        self.win_type, self.par1, self.par2,
                        self.triggering_delay, self.incremental,
                        self.incremental2, self.name, self.result_factory,
                        self.closing_func, self.ordered, self.opt_level)


@_alias_camel
class WinMapReduceBuilder(_TwoStageWinBuilder):
    """builders.hpp:1982 -- intra-window map + reduce."""

    _default_name = "win_mr"

    def __init__(self, map_fn, reduce_fn):
        super().__init__(map_fn, reduce_fn)
        self.par1 = 2

    def with_parallelism(self, map_par: int, reduce_par: int = 1):
        self.par1 = map_par
        self.par2 = reduce_par
        return self

    withParallelism = with_parallelism

    def with_map_incremental(self, inc: bool = True):
        self.incremental = inc
        return self

    def with_reduce_incremental(self, inc: bool = True):
        self.incremental2 = inc
        return self

    def build(self) -> WinMapReduce:
        self._check_windows()
        return WinMapReduce(self.fn, self.fn2, self.win_len, self.slide_len,
                            self.win_type, self.par1, self.par2,
                            self.triggering_delay, self.incremental,
                            self.incremental2, self.name,
                            self.result_factory, self.closing_func,
                            self.ordered, self.opt_level)


class _FFATBuilderBase(_WinBuilderBase):
    def __init__(self, lift_fn, combine_fn):
        super().__init__(lift_fn)
        self.combine_fn = combine_fn


@_alias_camel
class WinSeqFFATBuilder(_FFATBuilderBase):
    """builders.hpp:957 -- sequential FlatFAT engine (lift + combine)."""

    _default_name = "win_seqffat"

    def build(self) -> WinSeqFFAT:
        self._check_windows()
        return WinSeqFFAT(self.fn, self.combine_fn, self.win_len,
                          self.slide_len, self.win_type,
                          self.triggering_delay, self.name,
                          self.result_factory, self.closing_func)


@_alias_camel
class KeyFFATBuilder(_FFATBuilderBase):
    """builders.hpp:1576 -- key-parallel FlatFAT farm (lift + combine)."""

    _default_name = "key_ffat"

    def build(self) -> KeyFFAT:
        self._check_windows()
        return KeyFFAT(self.fn, self.combine_fn, self.win_len,
                       self.slide_len, self.win_type, self.parallelism,
                       self.triggering_delay, self.name,
                       self.result_factory, self.closing_func)
