"""Operator descriptor framework.

Reference analogue: ``wf/basic_operator.hpp`` (:49-89) plus the
structural role the ff_farm/ff_pipeline nests play.  A windflow_tpu_torch
operator is a passive descriptor that yields one or more **stages**;
each stage contributes replica logics, the emitter the upstream uses to
route into it, its ordering requirement, and an optional farm-level
collector.  MultiPipe consumes stages to wire channels/threads -- the
flat, explicit substitute for the reference's "matrioska" ff_a2a
nesting (multipipe.hpp:236-341).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from ..core.basic import OrderingMode, Pattern, RoutingMode
from ..runtime.emitters import Emitter
from ..runtime.node import NodeLogic


@dataclass
class StageSpec:
    """One farm stage inside an operator."""

    name: str
    replicas: List[NodeLogic]
    emitter_proto: Emitter              # cloned per upstream producer
    routing: RoutingMode
    # field the DETERMINISTIC/PROBABILISTIC collector must order on when
    # one is inserted in front of each replica (None = operator does not
    # care; graph mode decides)
    ordering_mode: Optional[OrderingMode] = None
    # farm-level collector merging replica outputs (e.g. ordered WF)
    collector: Optional[NodeLogic] = None
    # complex nesting (WF/KF over PF/WMR, multipipe.hpp:1014-1099):
    # group id per replica; a grouped stage receives only from upstream
    # tails of the same group (the per-worker sub-pipelines of the
    # reference's replicated inner operators)
    groups: Optional[List[int]] = None
    # per-group inbound emitter prototypes (used instead of
    # emitter_proto when the PREVIOUS stage was grouped)
    group_emitters: Optional[List[Emitter]] = None
    # per-group farm collectors (e.g. each inner PLQ's ordered collector)
    group_collectors: Optional[List[NodeLogic]] = None
    # per-operator error policy ('fail'|'skip'|'dead_letter'), filled
    # from the operator descriptor at wiring (resilience/policies.py);
    # applies to the stage's replica nodes, never to collectors
    error_policy: Optional[str] = None
    # distributed-runtime worker pin, filled from the operator
    # descriptor at wiring (distributed/; docs/DISTRIBUTED.md)
    worker: Optional[int] = None
    # elastic scaling (elastic/; docs/ELASTIC.md): the operator's
    # ElasticSpec plus a ``(replica_index, parallelism) -> NodeLogic``
    # factory, filled by MultiPipe.add for single-stage operators that
    # declared .with_elasticity(...).  _append_stage registers the
    # wired stage with the graph's elastic registry.
    elastic: Optional[object] = None
    elastic_factory: Optional[object] = None
    # supervised replica restart (durability/supervision.py;
    # docs/RESILIENCE.md): True + a non-None elastic_factory makes the
    # stage's replicas individually rebuildable after a crash.  Filled
    # from the operator's .with_restartable() mark by MultiPipe.add.
    restartable: bool = False


class Operator:
    """Base descriptor: name, parallelism, routing, pattern."""

    # (class-level default so pre-existing Operator subclasses that
    # override __init__ without chaining still read as unpinned)
    worker: Optional[int] = None

    def __init__(self, name: str, parallelism: int, routing: RoutingMode,
                 pattern: Pattern):
        if parallelism < 1:
            raise ValueError(f"operator {name}: parallelism must be >= 1")
        self.name = name
        self.parallelism = parallelism
        self.routing = routing
        self.pattern = pattern
        self.used = False  # one operator object per graph position (ref basic_operator)
        # per-tuple svc failure handling (resilience/policies.py);
        # builders set it via .with_error_policy(...)
        self.error_policy = "fail"
        # ElasticSpec when the builder declared .with_elasticity(...)
        # (elastic/; docs/ELASTIC.md); None = fixed parallelism
        self.elasticity = None
        # distributed-runtime worker pin (.with_worker(i)); None =
        # placed by the partition planner (docs/DISTRIBUTED.md)
        self.worker = None
        # .with_restartable(): replicas individually healable under
        # RuntimeConfig.supervision (durability/supervision.py)
        self.restartable = False

    # -- to be provided by subclasses --------------------------------------
    def stages(self) -> List[StageSpec]:
        raise NotImplementedError

    # chainable operators (Filter/Map/FlatMap/Sink) additionally expose
    # fresh per-replica logics for thread fusion (multipipe.hpp:345-390)
    def chain_logics(self) -> Optional[List[NodeLogic]]:
        return None

    # elastically scalable operators expose a fresh-replica factory for
    # runtime rescaling: ``factory(replica_index, parallelism) ->
    # NodeLogic`` (elastic/rescale.py).  None = this operator kind
    # cannot be rescaled at runtime.
    def elastic_logic_factory(self):
        return None

    def is_window_operator(self) -> bool:
        return self.pattern in (
            Pattern.WIN_SEQ, Pattern.WIN_FARM, Pattern.KEY_FARM,
            Pattern.PANE_FARM, Pattern.WIN_MAPREDUCE, Pattern.WIN_SEQFFAT,
            Pattern.KEY_FFAT, Pattern.WIN_SEQ_TPU, Pattern.WIN_FARM_TPU,
            Pattern.KEY_FARM_TPU, Pattern.PANE_FARM_TPU,
            Pattern.WIN_MAPREDUCE_TPU, Pattern.WIN_SEQFFAT_TPU,
            Pattern.KEY_FFAT_TPU)

    def __repr__(self):
        return (f"{type(self).__name__}(name={self.name!r}, "
                f"parallelism={self.parallelism})")
