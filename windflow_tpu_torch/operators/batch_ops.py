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
from ..core.tuples import DeferredBatch
from ..runtime.emitters import StandardEmitter
from ..runtime.node import EOSMarker, NodeLogic, SourceLoopLogic
from .base import Operator, StageSpec


class _EmitShipper:
    """The shipper a watermarked source body pushes into: the step's
    emit."""

    __slots__ = ("push",)

    def __init__(self, emit):
        self.push = emit


class BatchSourceLogic(SourceLoopLogic):
    def __init__(self, fn, parallelism, replica_index, closing_func=None,
                 watermark_lag=None):
        self.context = RuntimeContext(parallelism, replica_index)
        self.user_fn = with_context(fn, 0, self.context)
        self.closing_func = closing_func

        def ship(emit):
            batch = self.user_fn()
            if batch is None:
                return False
            emit(batch)
            return True

        step = ship
        if watermark_lag is not None:
            from ..eventtime.watermarks import WatermarkedSource
            wms = WatermarkedSource(lambda shipper: ship(shipper.push),
                                    every=1, skew=watermark_lag)

            def step(emit):
                return wms(_EmitShipper(emit))

        super().__init__(step)

    def svc_end(self):
        if self.closing_func is not None:
            self.closing_func(self.context)


class BatchSource(Operator):
    """``fn(ctx) -> TupleBatch | None`` (None ends the stream).  With
    ``watermark_lag`` (event-time units) the source also promises event
    time: after each batch it emits ``Watermark(max ts shipped -
    watermark_lag)`` when that advances, and ``Watermark(inf)`` at the
    end of the stream (``eventtime.watermarks.WatermarkedSource``)."""

    def __init__(self, fn, parallelism=1, name="batch_source",
                 closing_func=None, watermark_lag=None):
        super().__init__(name, parallelism, RoutingMode.NONE, Pattern.SOURCE)
        self.fn = fn
        self.closing_func = closing_func
        self.watermark_lag = watermark_lag

    def stages(self):
        reps = [BatchSourceLogic(self.fn, self.parallelism, i,
                                 self.closing_func, self.watermark_lag)
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
    """The filter's row selection.  An empty selection emits nothing, a
    contiguous run the zero-copy slice of its rows, and a scattered one
    a :class:`DeferredBatch`: the next logic on this thread gathers
    only the columns it reads, and an outlet gathers every column
    before the selection enters a channel (``runtime.node.Outlet``)."""

    def __init__(self, fn):
        self.fn = fn

    def svc(self, item, channel_id, emit):
        if isinstance(item, EOSMarker):
            emit(item)
            return
        rows = item._rows(self.fn(item))
        if isinstance(rows, slice):
            out = item.take(rows)
            if len(out):
                emit(out)
            return
        if len(rows) == 0:
            return
        st = self.stats
        out = DeferredBatch(item, rows, st)
        if st is not None:
            st.bytes_selected += out.selected_nbytes
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
    (``BatchFilter(F.value % 4 == 0)``).

    The output may hold a deferred selection over the input's columns
    (``core.tuples.DeferredBatch``): a chained or fused successor on the
    filter's thread gathers each column when it first reads it, and the
    outlet gathers every column before the output enters a channel.
    The values are those of an eager ``take`` of the kept rows, and the
    input's columns must stay unchanged while the output lives, as for
    the zero-copy slice a contiguous run already is.  Under tracing the replica's record
    counts the bytes of the scattered selections (``Bytes_selected``)
    and of the columns gathered (``Bytes_gathered``)."""

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
