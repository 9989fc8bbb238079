"""Columnar-plane operators: sources and transforms over TupleBatch.

This plane has no reference counterpart -- it is the TPU-first design
choice (SURVEY.md §7 "Architecture stance"): the hot path moves columnar
micro-batches, not records, so host work is vectorized numpy and device
work is batched launches.  The record-plane operators remain for API parity;
both planes share queues, emitters, windows and graphs.

* BatchSource:  fn(ctx) -> TupleBatch | None    (None = end of stream)
* BatchMap:     fn(batch) -> TupleBatch         (vectorized transform)
* BatchFilter:  fn(batch) -> bool ndarray       (vectorized predicate)
* Batch-aware sinks just receive TupleBatch items.
"""
from __future__ import annotations


from ..core.basic import OrderingMode, Pattern, RoutingMode
from ..core.context import RuntimeContext
from ..core.meta import with_context
from ..runtime.emitters import StandardEmitter
from ..runtime.node import EOSMarker, NodeLogic, SourceLoopLogic
from .base import Operator, StageSpec


class BatchSourceLogic(SourceLoopLogic):
    def __init__(self, fn, parallelism, replica_index, closing_func=None):
        self.context = RuntimeContext(parallelism, replica_index)
        self.user_fn = with_context(fn, 0, self.context)
        self.closing_func = closing_func

        def step(emit):
            batch = self.user_fn()
            if batch is None:
                return False
            emit(batch)
            return True

        super().__init__(step)

    def svc_end(self):
        if self.closing_func is not None:
            self.closing_func(self.context)


class BatchSource(Operator):
    def __init__(self, fn, parallelism=1, name="batch_source",
                 closing_func=None):
        super().__init__(name, parallelism, RoutingMode.NONE, Pattern.SOURCE)
        self.fn = fn
        self.closing_func = closing_func

    def stages(self):
        reps = [BatchSourceLogic(self.fn, self.parallelism, i,
                                 self.closing_func)
                for i in range(self.parallelism)]
        return [StageSpec(self.name, reps, StandardEmitter(), self.routing)]


class _BatchTransformLogic(NodeLogic):
    def __init__(self, fn):
        self.fn = fn

    def svc(self, item, channel_id, emit):
        if isinstance(item, EOSMarker):
            emit(item)
            return
        out = self.fn(item)
        if out is not None and len(out):
            emit(out)


class _BatchFilterLogic(NodeLogic):
    def __init__(self, fn):
        self.fn = fn

    def svc(self, item, channel_id, emit):
        if isinstance(item, EOSMarker):
            emit(item)
            return
        mask = self.fn(item)
        out = item.take(mask)
        if len(out):
            emit(out)


class BatchMap(Operator):
    """Vectorized transform; also accepts a value ``Expr`` which is
    evaluated over the batch columns (``BatchMap(F.value * 2)``)."""

    def __init__(self, fn, parallelism=1, name="batch_map", keyed=False):
        super().__init__(name, parallelism,
                         RoutingMode.KEYBY if keyed else RoutingMode.FORWARD,
                         Pattern.MAP)
        from ..core.expr import Expr
        self.expr = fn if isinstance(fn, Expr) else None
        if self.expr is not None:
            ev = self.expr.eval_columns
            fn = lambda b: b.with_cols(value=ev(b))  # noqa: E731
        self.fn = fn
        self.keyed = keyed

    def stages(self):
        reps = [_BatchTransformLogic(self.fn)
                for _ in range(self.parallelism)]
        return [StageSpec(self.name, reps,
                          StandardEmitter(keyed=self.keyed), self.routing,
                          ordering_mode=OrderingMode.TS)]

    def chain_logics(self):
        if self.keyed:
            return None
        return [_BatchTransformLogic(self.fn)
                for _ in range(self.parallelism)]


class BatchFilter(Operator):
    """Vectorized predicate; also accepts a boolean ``Expr``
    (``BatchFilter(F.value % 4 == 0)``)."""

    def __init__(self, fn, parallelism=1, name="batch_filter", keyed=False):
        super().__init__(name, parallelism,
                         RoutingMode.KEYBY if keyed else RoutingMode.FORWARD,
                         Pattern.FILTER)
        from ..core.expr import Expr
        self.expr = fn if isinstance(fn, Expr) else None
        if self.expr is not None:
            fn = self.expr.eval_columns
        self.fn = fn
        self.keyed = keyed

    def stages(self):
        reps = [_BatchFilterLogic(self.fn) for _ in range(self.parallelism)]
        return [StageSpec(self.name, reps,
                          StandardEmitter(keyed=self.keyed), self.routing,
                          ordering_mode=OrderingMode.TS)]

    def chain_logics(self):
        if self.keyed:
            return None
        return [_BatchFilterLogic(self.fn) for _ in range(self.parallelism)]
