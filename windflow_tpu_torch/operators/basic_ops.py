"""Basic streaming operators: Source, Filter, Map, FlatMap, Accumulator, Sink.

Re-designs of reference ``wf/source.hpp`` (439 LoC), ``filter.hpp``
(574), ``map.hpp`` (471), ``flatmap.hpp`` (427), ``accumulator.hpp``
(402), ``sink.hpp`` (498).  All follow the reference template
(SURVEY.md §2.3): a farm of N replica logics, Standard emitter, plain +
rich callable variants, closing function called at svc_end.

Python signature conventions (replacing the C++ overload sets, API:11-43):
* Source:      fn(shipper[, ctx]) -> bool     (loop/shipper style) or an
               iterable/generator factory via SourceBuilder.
* Filter:      fn(t[, ctx]) -> bool | None | record   (False/None drops;
               a record transforms -- the optional<result_t> variant).
* Map:         fn(t[, ctx]) -> None (in-place) | record (transform).
* FlatMap:     fn(t, shipper[, ctx]) -> None.
* Accumulator: fn(t, acc[, ctx]) -> None|acc  (keyed rolling fold,
               acc seeded from init_value; result emitted per input).
* Sink:        fn(t_or_None[, ctx]) -> None   (None signals stream end).
"""
from __future__ import annotations

import copy

from ..core.basic import Pattern, RoutingMode, OrderingMode
from ..core.context import RuntimeContext
from ..core.expr import Expr
from ..core.meta import with_context
from ..core.shipper import Shipper
from ..runtime.emitters import StandardEmitter
from ..runtime.node import EOSMarker, NodeLogic, SourceLoopLogic
from .base import Operator, StageSpec


def _noop_closing(ctx):
    return None


class _ReplicaLogic(NodeLogic):
    """Common skeleton: context binding + closing function."""

    def __init__(self, fn, base_arity, parallelism, replica_index,
                 closing_func):
        self.context = RuntimeContext(parallelism, replica_index)
        self.fn = with_context(fn, base_arity, self.context)
        self.closing_func = closing_func or _noop_closing

    def svc_end(self):
        self.closing_func(self.context)


class SourceLogic(SourceLoopLogic):
    """Shipper-style source: user fn pushes 0..N records, returns False
    at end of stream (source.hpp:228-249)."""

    def __init__(self, fn, parallelism, replica_index, closing_func):
        self.context = RuntimeContext(parallelism, replica_index)
        self.user_fn = with_context(fn, 1, self.context)
        self.closing_func = closing_func or _noop_closing

        def step(emit):
            return self.user_fn(Shipper(emit))
        super().__init__(step)

    def svc_end(self):
        self.closing_func(self.context)


class FilterLogic(_ReplicaLogic):
    def svc(self, item, channel_id, emit):
        if isinstance(item, EOSMarker):
            emit(item)
            return
        out = self.fn(item)
        if out is None or out is False:
            return  # dropped (empty optional, filter.hpp:260-296)
        emit(item if out is True else out)


class MapLogic(_ReplicaLogic):
    def svc(self, item, channel_id, emit):
        if isinstance(item, EOSMarker):
            emit(item)
            return
        out = self.fn(item)
        emit(item if out is None else out)


class FlatMapLogic(_ReplicaLogic):
    def __init__(self, fn, base_arity, parallelism, replica_index,
                 closing_func):
        super().__init__(fn, base_arity, parallelism, replica_index,
                         closing_func)

    def svc(self, item, channel_id, emit):
        if isinstance(item, EOSMarker):
            emit(item)
            return
        self.fn(item, Shipper(emit))


class AccumulatorLogic(_ReplicaLogic):
    """Keyed rolling fold (accumulator.hpp:98-177): per-key accumulator
    seeded from ``init_value``; emits a snapshot after every input with
    the input's control fields carried over."""

    def __init__(self, fn, parallelism, replica_index, closing_func,
                 init_value):
        super().__init__(fn, 2, parallelism, replica_index, closing_func)
        self.init_value = init_value
        self.state = {}

    def svc(self, item, channel_id, emit):
        if isinstance(item, EOSMarker):
            return
        key, tid, ts = item.get_control_fields()
        acc = self.state.get(key)
        if acc is None:
            acc = copy.deepcopy(self.init_value)
            acc.set_control_fields(key, 0, 0)
            self.state[key] = acc
        ret = self.fn(item, acc)
        if ret is not None:
            acc = self.state[key] = ret
        out = copy.copy(acc)
        out.set_control_fields(key, tid, ts)
        emit(out)

    def state_dict(self):
        st = self.state
        if hasattr(st, "materialize"):     # tiered store: inline copy
            st = st.materialize()
        return {"state": st}

    def load_state(self, st):
        if hasattr(self.state, "replace_all"):
            self.state.replace_all(st["state"])
        else:
            self.state = st["state"]

    # -- tiered keyed state (state/; docs/RESILIENCE.md "Tiered state
    # & memory pressure"): under RuntimeConfig.state_budget_bytes the
    # plain dict is swapped for a TieredKeyedStore -- svc() is
    # untouched (the store is dict-like and self-maintains its budget
    # on this thread), every contract below routes through it ---------
    def enable_tiered_state(self, store):
        store.replace_all(self.state)
        self.state = store

    def bind_hot_sketch(self, hot_keys_fn):
        """Audit plane handoff: pin the sketch's current top keys hot."""
        if hasattr(self.state, "bind_hot_sketch"):
            self.state.bind_hot_sketch(hot_keys_fn)

    def state_tier_of(self, key):
        """Tier name of ``key`` for census/doctor, or None."""
        if hasattr(self.state, "tier_of"):
            return self.state.tier_of(key)
        return "hot" if key in self.state else None

    def keyed_state_pickled(self):
        """Delta-capture fast path: warm/cold keys serve their stored
        pickled bytes (durability/delta.KeyedCapture)."""
        if hasattr(self.state, "keyed_state_pickled"):
            return self.state.keyed_state_pickled()
        return None

    # -- keyed-state hooks (elastic/rescale.py): the per-key fold store
    # repartitions over a new replica count at runtime rescale --------
    def keyed_state_dict(self):
        st = self.state
        if hasattr(st, "materialize"):
            return st.materialize()
        return dict(st)

    def load_keyed_state(self, kv):
        if hasattr(self.state, "replace_all"):
            self.state.replace_all(kv)
        else:
            self.state = dict(kv)

    # -- audit-plane census (audit/census.py): gauge-grade read from
    # the auditor thread against the LIVE store -- len() is GIL-atomic,
    # the byte estimate samples one entry (guarded against a racing
    # resize) ---------------------------------------------------------
    def keyed_state_census(self):
        state = self.state
        if hasattr(state, "census"):       # tiered: per-tier gauges
            return state.census()
        n = len(state)
        if n == 0:
            return (0, 0)
        import sys
        try:
            per = sys.getsizeof(next(iter(state.values()))) + 64
        except (RuntimeError, StopIteration):
            per = 64  # resized under us: count-only estimate
        return (n, n * per)


class SinkLogic(_ReplicaLogic):
    def __init__(self, fn, parallelism, replica_index, closing_func):
        super().__init__(fn, 1, parallelism, replica_index, closing_func)

    def svc(self, item, channel_id, emit):
        if isinstance(item, EOSMarker):
            return
        self.fn(item)

    def eos_flush(self, emit):
        self.fn(None)  # empty optional = end of stream (sink.hpp:73-77)


# ---------------------------------------------------------------------------
# Operator descriptors
# ---------------------------------------------------------------------------

class Source(Operator):
    def __init__(self, fn, parallelism=1, name="source", closing_func=None):
        super().__init__(name, parallelism, RoutingMode.NONE, Pattern.SOURCE)
        self.fn = fn
        self.closing_func = closing_func

    def stages(self):
        reps = [SourceLogic(self.fn, self.parallelism, i, self.closing_func)
                for i in range(self.parallelism)]
        return [StageSpec(self.name, reps, StandardEmitter(), self.routing)]


class _BasicOp(Operator):
    logic_cls: type = None
    base_arity: int = 1

    def __init__(self, fn, parallelism, name, closing_func=None,
                 keyed=False, pattern=None):
        super().__init__(name, parallelism,
                         RoutingMode.KEYBY if keyed else RoutingMode.FORWARD,
                         pattern)
        self.fn = fn
        self.closing_func = closing_func
        self.keyed = keyed

    def _make_logic(self, i, n=None):
        return self.logic_cls(self.fn, self.base_arity,
                              n or self.parallelism, i, self.closing_func)

    def stages(self):
        reps = [self._make_logic(i) for i in range(self.parallelism)]
        return [StageSpec(self.name, reps,
                          StandardEmitter(keyed=self.keyed), self.routing,
                          ordering_mode=OrderingMode.TS)]

    def chain_logics(self):
        if self.keyed:
            return None  # KEYBY ops cannot be thread-fused (multipipe chain)
        return [self._make_logic(i) for i in range(self.parallelism)]

    def elastic_logic_factory(self):
        """Fresh replica logics for runtime rescaling (elastic/): the
        basic ops are stateless per replica (their emissions depend only
        on the tuple), so any replica count is semantically equivalent;
        keyed variants repartition by ``hash % n`` like the emitter."""
        return self._make_logic


class Filter(_BasicOp):
    """Predicate may be a Python callable or a declarative ``Expr``
    (e.g. ``Filter(F.value % 4 == 0)``) -- expressions additionally let
    the whole chain lower onto the native C++ record pipeline
    (graph/native_lowering.py)."""

    logic_cls = FilterLogic
    base_arity = 1

    def __init__(self, fn, parallelism=1, name="filter", closing_func=None,
                 keyed=False):
        self.expr = fn if isinstance(fn, Expr) else None
        if self.expr is not None:
            # plane-agnostic: records evaluate scalar, TupleBatch
            # evaluates vectorized over columns
            import numpy as np

            from ..core.tuples import TupleBatch
            pred = self.expr.eval_record
            pred_cols = self.expr.eval_columns

            def fn(t):
                if isinstance(t, TupleBatch):
                    out = t.take(np.asarray(pred_cols(t), bool))
                    return out if len(out) else None
                return bool(pred(t))
        super().__init__(fn, parallelism, name, closing_func, keyed,
                         Pattern.FILTER)


class Map(_BasicOp):
    """Transform may be a Python callable or a value ``Expr``
    (``Map(F.value * 2 + 1)`` assigns the expression to ``value``)."""

    logic_cls = MapLogic
    base_arity = 1

    def __init__(self, fn, parallelism=1, name="map", closing_func=None,
                 keyed=False):
        self.expr = fn if isinstance(fn, Expr) else None
        if self.expr is not None:
            from ..core.tuples import TupleBatch
            ev = self.expr.eval_record
            ev_cols = self.expr.eval_columns

            def fn(t):
                if isinstance(t, TupleBatch):
                    return t.with_cols(value=ev_cols(t))
                t.value = ev(t)  # in-place value assignment
        super().__init__(fn, parallelism, name, closing_func, keyed,
                         Pattern.MAP)


class FlatMap(_BasicOp):
    logic_cls = FlatMapLogic
    base_arity = 2

    def __init__(self, fn, parallelism=1, name="flatmap", closing_func=None,
                 keyed=False):
        super().__init__(fn, parallelism, name, closing_func, keyed,
                         Pattern.FLATMAP)


class Accumulator(Operator):
    """Always KEYBY (multipipe.hpp:967-973)."""

    def __init__(self, fn, init_value, parallelism=1, name="accumulator",
                 closing_func=None):
        super().__init__(name, parallelism, RoutingMode.KEYBY,
                         Pattern.ACCUMULATOR)
        self.fn = fn
        self.init_value = init_value
        self.closing_func = closing_func

    def stages(self):
        reps = [AccumulatorLogic(self.fn, self.parallelism, i,
                                 self.closing_func, self.init_value)
                for i in range(self.parallelism)]
        return [StageSpec(self.name, reps, StandardEmitter(keyed=True),
                          self.routing, ordering_mode=OrderingMode.TS)]

    def elastic_logic_factory(self):
        """Rescalable: per-key fold state migrates through the
        keyed-state hooks (elastic/rescale.py)."""
        return lambda i, n: AccumulatorLogic(
            self.fn, n, i, self.closing_func, self.init_value)


class Sink(_BasicOp):
    logic_cls = SinkLogic
    base_arity = 1

    def __init__(self, fn, parallelism=1, name="sink", closing_func=None,
                 keyed=False, exactly_once=None):
        super().__init__(fn, parallelism, name, closing_func, keyed,
                         Pattern.SINK)
        # exactly-once sink contract (durability/transaction.py;
        # docs/RESILIENCE.md): 'transactional' buffers effects per
        # epoch and releases on durable commit; 'idempotent' applies
        # immediately through an epoch-keyed writer
        if exactly_once not in (None, "transactional", "idempotent"):
            raise ValueError(
                "exactly_once must be None, 'transactional' or "
                f"'idempotent', not {exactly_once!r}")
        self.exactly_once = exactly_once

    def _make_logic(self, i, n=None):
        if self.exactly_once == "transactional":
            from ..durability.transaction import TransactionalSinkLogic
            return TransactionalSinkLogic(self.fn, n or self.parallelism,
                                          i, self.closing_func)
        if self.exactly_once == "idempotent":
            from ..durability.transaction import IdempotentSinkLogic
            return IdempotentSinkLogic(self.fn, n or self.parallelism,
                                       i, self.closing_func)
        return SinkLogic(self.fn, n or self.parallelism, i,
                         self.closing_func)

    def elastic_logic_factory(self):
        # a sink's eos_flush IS the end-of-stream signal (fn(None),
        # sink.hpp:73-77); retiring a replica mid-stream would fire it
        # early, so sinks keep their build-time parallelism
        return None
