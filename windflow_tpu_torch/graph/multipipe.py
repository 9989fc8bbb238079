"""MultiPipe: a linear (then split/merged) pipeline of operators.

Re-design of reference ``wf/multipipe.hpp`` (2587 LoC).  Where the
reference nests ff_a2a "matrioska" structures (multipipe.hpp:236-341),
windflow_tpu_torch wires an explicit flat graph of RtNode threads and
channels: per-replica inbound collectors in DETERMINISTIC/PROBABILISTIC
modes (multipipe.hpp:697-705), emitter clones per upstream producer,
farm-level collectors after ordered window farms, and thread-fusion
``chain`` for FORWARD operators (multipipe.hpp:345-390).
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional

from ..core.basic import Mode, OrderingMode, RoutingMode, WinType
from ..operators.base import Operator, StageSpec
from ..runtime.emitters import StandardEmitter
from ..runtime.node import Outlet, RtNode
from ..runtime.ordering import KSlackLogic, OrderingLogic
from ..runtime.queues import Channel, make_channel


# re-export: ChainedLogic moved to runtime.node so operators (PaneFarm
# LEVEL2 fusion) can use it without importing the graph layer
from ..runtime.node import ChainedLogic  # noqa: F401


class MultiPipe:
    def __init__(self, graph, name: str):
        self.graph = graph
        self.name = name
        self.nodes: List[RtNode] = []   # every thread of this pipe
        self.tails: List[RtNode] = []   # nodes whose outputs are unbound
        self.has_source = False
        self.has_sink = False
        self.children: List["MultiPipe"] = []  # after split
        self.merged_into: Optional[MultiPipe] = None
        self._op_names: List[str] = []
        self._ops: List[Operator] = []  # descriptors, for native lowering

    # -- internal wiring ---------------------------------------------------
    def _check_open(self):
        if self.has_sink:
            raise RuntimeError(f"MultiPipe {self.name}: already terminated "
                               "by a sink")
        if self.children:
            raise RuntimeError(f"MultiPipe {self.name}: already split; use "
                               "select()")
        if self.merged_into is not None:
            raise RuntimeError(f"MultiPipe {self.name}: already merged")
        if not self.has_source:
            raise RuntimeError(f"MultiPipe {self.name}: add a source first")

    def _mark_used(self, op: Operator):
        if op.used:
            raise RuntimeError(f"operator {op.name} already used in a graph")
        op.used = True
        self._ops.append(op)

    def _collector_for(self, ordering_mode: Optional[OrderingMode],
                       n_channels: int, win_type: Optional[WinType] = None):
        """Mode-dependent inbound collector (multipipe.hpp:697-705)."""
        mode = self.graph.mode
        if mode == Mode.DEFAULT or ordering_mode is None:
            return None
        if mode == Mode.DETERMINISTIC:
            return OrderingLogic(ordering_mode, n_channels)
        # PROBABILISTIC: K-slack; CB windows additionally need dense ids
        km = (OrderingMode.TS_RENUMBERING
              if ordering_mode in (OrderingMode.ID,
                                   OrderingMode.TS_RENUMBERING)
              else OrderingMode.TS)
        return KSlackLogic(km, on_drop=self.graph._count_dropped)
    def _append_stage(self, stage: StageSpec,
                      win_type: Optional[WinType] = None):
        n = len(stage.replicas)
        cfg = self.graph.config
        grouped = (stage.group_emitters is not None
                   and all(getattr(t, "group", None) is not None
                           for t in self.tails) and len(self.tails) > 0)
        if grouped:
            n_producers = max(1, len([t for t in self.tails
                                      if t.group == self.tails[0].group]))
        else:
            n_producers = len(self.tails)
        # per-replica inbound channel (collector front-end when required)
        collector_logics = [
            self._collector_for(stage.ordering_mode, n_producers, win_type)
            for _ in range(n)]
        entry_channels: List[Channel] = [make_channel(cfg) for _ in range(n)]
        # emitter clone per upstream producer (reference: emitter combined
        # into each tail node, multipipe.hpp:302-338)
        if stage.elastic is not None and grouped:
            raise ValueError(
                f"stage {stage.name!r} cannot be elastic behind grouped "
                "(complex-nesting) tails (docs/ELASTIC.md)")
        elastic_outlets = []
        if grouped:
            # complex nesting: tails of group g feed only the replicas of
            # group g, through that group's emitter prototype
            group_members = {}
            for i, g in enumerate(stage.groups):
                group_members.setdefault(g, []).append(i)
            for tail in self.tails:
                members = group_members[tail.group]
                em = stage.group_emitters[tail.group].clone()
                em.set_n_destinations(len(members))
                dests = [(entry_channels[i],
                          entry_channels[i].register_producer())
                         for i in members]
                tail.outlets.append(Outlet(em, dests))
        else:
            for tail in self.tails:
                em = stage.emitter_proto.clone()
                em.set_n_destinations(n)
                from ..runtime.emitters import TreeEmitter
                if isinstance(em, TreeEmitter) and stage.groups is not None:
                    sizes: List[int] = []
                    for g in stage.groups:
                        while g >= len(sizes):
                            sizes.append(0)
                        sizes[g] += 1
                    em.set_child_widths(sizes)
                dests = [(ch, ch.register_producer())
                         for ch in entry_channels]
                outlet = Outlet(em, dests)
                tail.outlets.append(outlet)
                elastic_outlets.append(outlet)
        new_nodes: List[RtNode] = []
        replica_nodes: List[RtNode] = []
        for i, logic in enumerate(stage.replicas):
            if collector_logics[i] is not None:
                rep_ch = make_channel(cfg)
                coll_node = RtNode(
                    f"{self.name}/{stage.name}.coll{i}", collector_logics[i],
                    entry_channels[i], [])
                coll_node.is_collector = True
                fwd = StandardEmitter()
                fwd.set_n_destinations(1)
                coll_node.outlets.append(
                    Outlet(fwd, [(rep_ch, rep_ch.register_producer())]))
                new_nodes.append(coll_node)
                in_ch = rep_ch
            else:
                in_ch = entry_channels[i]
            node = RtNode(f"{self.name}/{stage.name}.{i}", logic, in_ch, [])
            if stage.error_policy is not None:
                node.error_policy = stage.error_policy
            node.worker_pin = stage.worker
            node.group = stage.groups[i] if stage.groups is not None else None
            if self.graph.config.tracing:
                node.stats = self.graph.stats.register(
                    f"{self.name}/{stage.name}", str(i))
            new_nodes.append(node)
            replica_nodes.append(node)
        if stage.group_collectors is not None:
            # complex nesting: one collector per inner-copy group (e.g.
            # each replicated PLQ's ordered collector); the next grouped
            # stage consumes from its group's collector
            coll_nodes = []
            for g, coll in enumerate(stage.group_collectors):
                members = [rn for rn, gg in zip(replica_nodes, stage.groups)
                           if gg == g]
                if coll is None:
                    coll_nodes.extend(members)
                    continue
                cch = make_channel(cfg)
                cnode = RtNode(f"{self.name}/{stage.name}.coll.g{g}", coll,
                               cch, [])
                cnode.is_collector = True
                cnode.group = g
                if hasattr(coll, "set_n_channels"):
                    coll.set_n_channels(len(members))
                for rn in members:
                    fwd = StandardEmitter()
                    fwd.set_n_destinations(1)
                    rn.outlets.append(
                        Outlet(fwd, [(cch, cch.register_producer())]))
                new_nodes.append(cnode)
                coll_nodes.append(cnode)
            self.tails = coll_nodes
        elif stage.collector is not None:
            cch = make_channel(cfg)
            cnode = RtNode(f"{self.name}/{stage.name}.collector",
                           stage.collector, cch, [])
            cnode.is_collector = True
            if hasattr(stage.collector, "set_n_channels"):
                stage.collector.set_n_channels(len(replica_nodes))
            for rn in replica_nodes:
                fwd = StandardEmitter()
                fwd.set_n_destinations(1)
                rn.outlets.append(Outlet(fwd, [(cch, cch.register_producer())]))
            new_nodes.append(cnode)
            self.tails = [cnode]
        else:
            self.tails = replica_nodes
        self.nodes.extend(new_nodes)
        self._op_names.append(stage.name)
        if stage.elastic is not None:
            self._register_elastic(stage, replica_nodes, elastic_outlets)
        if stage.restartable:
            self._register_restartable(stage, replica_nodes)

    def _register_restartable(self, stage: StageSpec,
                              replica_nodes) -> None:
        """Register a wired restartable stage with the graph's
        supervised registry (durability/supervision.py): the replica
        supervisor rebuilds crashed replicas of these groups from the
        last committed epoch instead of failing the graph."""
        from ..durability.supervision import SupervisedGroup
        key = f"{self.name}/{stage.name}"
        if key in self.graph.supervised:
            raise RuntimeError(f"restartable operator {key!r} already "
                               "registered")
        for node in replica_nodes:
            node.supervised_group = key
        self.graph.supervised[key] = SupervisedGroup(
            key, self, stage.elastic_factory, list(replica_nodes))

    def _register_elastic(self, stage: StageSpec, replica_nodes,
                          outlets) -> None:
        """Register a wired elastic stage with the graph (rescale
        registry + always-on stats records for the load signals)."""
        from ..elastic.rescale import ElasticHandle
        key = f"{self.name}/{stage.name}"
        if key in self.graph.elastic:
            raise RuntimeError(f"elastic operator {key!r} already "
                               "registered")
        for i, node in enumerate(replica_nodes):
            node.elastic_group = key
            # load signals need service-time samples even when tracing
            # is off; records registered here keep monitoring
            # attribution consistent with the traced path
            if node.stats is None:
                node.stats = self.graph.stats.register(key, str(i))
        self.graph.elastic[key] = ElasticHandle(
            key, stage.elastic, self, stage.elastic_factory,
            replica_nodes, outlets,
            error_policy=stage.error_policy or "fail")

    # -- public API (multipipe.hpp add/chain surface) ----------------------
    def add_source(self, source: Operator) -> "MultiPipe":
        if self.has_source:
            raise RuntimeError("source already present")
        self._mark_used(source)
        stage = source.stages()[0]
        if stage.worker is None:
            stage.worker = getattr(source, "worker", None)
        for i, logic in enumerate(stage.replicas):
            node = RtNode(f"{self.name}/{stage.name}", logic, None, [])
            node.worker_pin = stage.worker
            # per-source trace-sampling override (telemetry/;
            # SourceBuilder.with_tracing): None defers to
            # RuntimeConfig.trace_sample, 0 opts out
            node.trace_sample = getattr(source, "trace_sample", None)
            if self.graph.config.tracing:
                node.stats = self.graph.stats.register(
                    f"{self.name}/{stage.name}", str(i))
            self.nodes.append(node)
            self.tails.append(node)
        self.has_source = True
        self._op_names.append(stage.name)
        return self

    def add(self, op: Operator) -> "MultiPipe":
        self._check_open()
        self._mark_used(op)
        win_type = getattr(op, "win_type", None)
        # Win_Farm with CB windows is rejected in DEFAULT mode: window
        # multicast cannot renumber consistently (multipipe.hpp:1002-1006)
        from ..core.basic import Pattern, Role
        if (self.graph.mode == Mode.DEFAULT and win_type == WinType.CB
                and op.pattern in (Pattern.WIN_FARM, Pattern.WIN_FARM_TPU)
                and getattr(op, "role", Role.SEQ) == Role.SEQ):
            raise RuntimeError(
                "Win_Farm with count-based windows cannot be used in "
                "DEFAULT mode; use DETERMINISTIC mode")
        # CB windows in DEFAULT mode: renumber ids on arrival
        # (win_seq.hpp:342-347 via multipipe wiring)
        if (self.graph.mode == Mode.DEFAULT and win_type == WinType.CB
                and hasattr(op, "enable_renumbering")):
            op.enable_renumbering()
        stages = op.stages()
        self._prepare_elastic(op, stages)
        self._prepare_restartable(op, stages)
        for i, stage in enumerate(stages):
            if stage.error_policy is None:
                stage.error_policy = getattr(op, "error_policy", "fail")
            if stage.worker is None:
                stage.worker = getattr(op, "worker", None)
            if i == 0:
                self._swap_cb_broadcast(stage, win_type)
            self._append_stage(stage, win_type)
        return self

    def _prepare_elastic(self, op: Operator, stages: List[StageSpec]) -> None:
        """Validate and mark an elastic declaration (docs/ELASTIC.md):
        runtime rescaling needs a single collector-less stage whose
        operator kind exposes a fresh-replica factory, in DEFAULT mode
        (ordering collectors would pin per-channel identity the rescale
        cannot preserve).  _append_stage registers the wired stage."""
        spec = getattr(op, "elasticity", None)
        if spec is None:
            return
        factory = op.elastic_logic_factory()
        if (factory is None or len(stages) != 1
                or stages[0].collector is not None
                or stages[0].groups is not None
                or stages[0].group_emitters is not None):
            raise ValueError(
                f"operator {op.name!r} cannot be elastic: runtime "
                "rescaling supports single-stage Filter/Map/FlatMap/"
                "Accumulator operators (docs/ELASTIC.md)")
        if self.graph.mode != Mode.DEFAULT:
            raise ValueError(
                "elastic operators require Mode.DEFAULT: ordering/"
                "K-slack collectors bind per-channel state the rescale "
                "protocol does not migrate (docs/ELASTIC.md)")
        stages[0].elastic = spec
        stages[0].elastic_factory = factory

    def _prepare_restartable(self, op: Operator,
                             stages: List[StageSpec]) -> None:
        """Validate and mark a .with_restartable() declaration
        (docs/RESILIENCE.md "Supervised replica restart").  The replica
        rebuild reuses the elastic-plane recipe, so the structural
        requirements are the elastic ones: a single collector-less
        stage whose operator kind exposes a fresh-replica factory, in
        DEFAULT mode."""
        if not getattr(op, "restartable", False):
            return
        factory = op.elastic_logic_factory()
        if (factory is None or len(stages) != 1
                or stages[0].collector is not None
                or stages[0].groups is not None
                or stages[0].group_emitters is not None):
            raise ValueError(
                f"operator {op.name!r} cannot be restartable: replica "
                "supervision supports single-stage Filter/Map/FlatMap/"
                "Accumulator operators with a fresh-replica factory "
                "(docs/RESILIENCE.md)")
        if self.graph.mode != Mode.DEFAULT:
            raise ValueError(
                "restartable operators require Mode.DEFAULT: ordering/"
                "K-slack collectors bind per-channel state the replica "
                "rebuild does not migrate (docs/RESILIENCE.md)")
        stages[0].restartable = True
        if stages[0].elastic_factory is None:
            stages[0].elastic_factory = factory

    def _swap_cb_broadcast(self, stage: StageSpec, win_type) -> None:
        """CB windows entering a window-multicast (WF-rooted) stage in
        DETERMINISTIC/PROBABILISTIC mode: the upstream ids need not be
        per-key dense (filters upstream drop tuples), so id-based
        multicast membership is wrong.  The reference swaps the emitter
        for a Broadcast_Emitter and renumbers densely in per-replica
        TS-ordering collectors (multipipe.hpp:1039-1051); each replica
        then keeps only the windows its config owns."""
        from ..core.basic import Role
        from ..runtime.emitters import BroadcastEmitter, TreeEmitter
        from ..runtime.win_routing import WFEmitter
        if (self.graph.mode == Mode.DEFAULT or win_type != WinType.CB
                or stage.routing != RoutingMode.COMPLEX):
            return
        em = stage.emitter_proto
        root = em.root if isinstance(em, TreeEmitter) else em
        if not isinstance(root, WFEmitter):
            return
        # MAP stages distribute by per-key round-robin STRIPING, not by
        # window membership: workers do not self-select stripes, so the
        # broadcast plane does not apply (Win_MapReduce keeps its
        # emitter tree)
        if any(getattr(r, "role", None) == Role.MAP
               for r in stage.replicas):
            return
        stage.emitter_proto = BroadcastEmitter()
        stage.group_emitters = None
        stage.ordering_mode = OrderingMode.TS_RENUMBERING

    def chain(self, op: Operator) -> "MultiPipe":
        """Thread-fuse a FORWARD operator into the current tail nodes when
        parallelism matches; falls back to add() otherwise
        (multipipe.hpp:345-390; chain exists only for Filter/Map/
        FlatMap/Sink)."""
        self._check_open()
        pin = getattr(op, "worker", None)
        if pin is not None and any(t.worker_pin is not None
                                   and t.worker_pin != pin
                                   for t in self.tails):
            # thread fusion would co-locate by construction: a pin that
            # differs from the tail's must keep its own node so the
            # partition planner can cut the edge (docs/DISTRIBUTED.md)
            return self.add(op)
        if getattr(op, "elasticity", None) is not None \
                or any(t.elastic_group is not None for t in self.tails):
            # thread fusion and runtime rescaling are mutually
            # exclusive: a fused replica cannot be rebuilt/rewired per
            # operator (docs/ELASTIC.md); wire through a channel instead
            return self.add(op)
        if getattr(op, "error_policy", "fail") != "fail" \
                or any(t.error_policy != "fail" for t in self.tails):
            # thread fusion would merge error-policy scopes: a fused
            # node has ONE policy, so a skip/dead-letter operator would
            # swallow its upstream half's errors -- and a 'fail'
            # operator fused into a policied tail would inherit that
            # tail's policy.  Keep policy scope per-operator instead
            return self.add(op)
        logics = op.chain_logics()
        if logics is None and self.graph.mode == Mode.DEFAULT \
                and len(self.tails) == 1:
            # single-replica fusion: any single-stage operator with one
            # replica and no collector can run inline in the tail thread
            stages = op.stages()
            if (len(stages) == 1 and len(stages[0].replicas) == 1
                    and stages[0].collector is None):
                self._mark_used(op)
                self.tails[0].logic = ChainedLogic(self.tails[0].logic,
                                                   stages[0].replicas[0])
                if pin is not None:
                    # the pin survives chaining by pinning the merged
                    # node (a chained operator shares its tail's thread
                    # by construction, so the whole node moves)
                    self.tails[0].worker_pin = pin
                self._op_names.append(f"{op.name}(chained)")
                return self
        if (logics is None or len(logics) != len(self.tails)
                or self.graph.mode != Mode.DEFAULT):
            return self.add(op)
        self._mark_used(op)
        for tail, logic in zip(self.tails, logics):
            tail.logic = ChainedLogic(tail.logic, logic)
            if pin is not None:
                tail.worker_pin = pin
        self._op_names.append(f"{op.name}(chained)")
        return self

    def add_sink(self, sink: Operator) -> "MultiPipe":
        self.add(sink)
        self.has_sink = True
        return self

    def chain_sink(self, sink: Operator) -> "MultiPipe":
        self.chain(sink)
        self.has_sink = True
        return self

    # -- split / merge (pipegraph executes; multipipe.hpp:2478-2583) -------
    def split(self, split_fn: Callable[[Any], Any],
              n_branches: int) -> "MultiPipe":
        self._check_open()
        return self.graph._execute_split(self, split_fn, n_branches)

    def select(self, i: int) -> "MultiPipe":
        if not self.children:
            raise RuntimeError("select() on a non-split MultiPipe")
        if not 0 <= i < len(self.children):
            raise IndexError(i)
        return self.children[i]

    def merge(self, *others: "MultiPipe") -> "MultiPipe":
        self._check_open()
        return self.graph._execute_merge(self, others)

    # -- execution ---------------------------------------------------------
    def all_nodes(self) -> List[RtNode]:
        out = list(self.nodes)
        for c in self.children:
            out.extend(c.all_nodes())
        return out

    def thread_count(self) -> int:
        return len(self.all_nodes())
