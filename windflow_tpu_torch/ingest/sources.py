"""Ingest source operators: socket, async-generator and replay feeds.

Each source replica runs a non-blocking transport poll loop on its
node thread and ships through a :class:`~.coalesce.ChunkCoalescer`
(credit-gated, admission-controlled, controller-batched -- see the
package docstring).  All transports poll with short timeouts and check
the graph CancelToken between polls, so cancellation unblocks a source
mid-recv (the PR-1 containment contract extended to the network edge).
"""
from __future__ import annotations

import os
import socket
import time as _time
from typing import Any, Callable, List, Optional, Sequence, Union

import numpy as np

from ..core.basic import Pattern, RoutingMode
from ..core.context import RuntimeContext
from ..core.tuples import TupleBatch
from ..distributed.wire import StreamDecoder
from ..operators.base import Operator, StageSpec
from ..resilience.cancel import GraphCancelled
from ..runtime.emitters import StandardEmitter
from ..runtime.node import SourceLoopLogic
from .admission import AdmissionConfig, ShedTuples
from .coalesce import ChunkCoalescer
from .controller import MicrobatchController
from .credits import CreditGate

DEFAULT_CREDITS = 1 << 16
_POLL_S = 0.05

# transport poll outcomes
_EOS = object()


class IngestSourceLogic(SourceLoopLogic):
    """One ingest source replica: transport poll loop + coalescer.

    ``transport`` must provide ``open(cancelled_fn)``,
    ``poll(n_hint) -> list[TupleBatch] | _EOS`` (an empty list means
    "nothing yet") and ``close()``.
    """

    def __init__(self, name: str, transport, *,
                 credits: Optional[int] = None,
                 admission: Optional[AdmissionConfig] = None,
                 latency_target_ms: Optional[float] = None,
                 initial_batch: Optional[int] = None,
                 max_batch: Optional[int] = None,
                 coalesce: bool = True,
                 pre_reduce: Union[str, bool] = "auto",
                 closing_func: Optional[Callable] = None,
                 parallelism: int = 1, replica_index: int = 0):
        self.context = RuntimeContext(parallelism, replica_index)
        self.transport = transport
        self.closing_func = closing_func
        self.credits_explicit = credits is not None
        credits = credits or DEFAULT_CREDITS
        self.gate = CreditGate(credits)
        self.controller = MicrobatchController(
            latency_target_ms=latency_target_ms,
            initial_batch=initial_batch,
            max_batch=max_batch or max(credits, 1 << 10))
        self.gate.bind_observer(self.controller.observe)
        self.coalescer = ChunkCoalescer(
            self.gate, self.controller, admission=admission,
            shed_cb=self._on_shed, on_emit=self._on_emit,
            coalesce=coalesce)
        self.pre_reduce_mode = pre_reduce
        # wired by ingest.wiring at PipeGraph.start
        self.node_name = name
        self.cancel_token = None
        self.dead_letters = None
        self.tuples_shed = 0
        self.emit_stamps: List = []   # (raw tuples emitted, perf_counter)
        self._opened = False
        super().__init__(self._step)

    # -- coalescer callbacks (flusher / transport threads) --------------
    def _on_shed(self, batch, n: int, policy: str) -> None:
        self.tuples_shed += n
        if self.dead_letters is not None:
            self.dead_letters.add(self.node_name, batch,
                                  ShedTuples(policy, n), count=n)
        if self.flight is not None:  # telemetry flight recorder
            self.flight.record("shed", node=self.node_name, n=n,
                               policy=policy,
                               total=self.tuples_shed)
        if self.stats is not None:
            self.stats.tuples_shed = self.tuples_shed

    def _on_emit(self, raw_cum: int, batch_len: int, t: float) -> None:
        if len(self.emit_stamps) < 1_000_000:
            self.emit_stamps.append((raw_cum, t))
        stats = self.stats
        if stats is not None:
            stats.ingest_batch_size = self.controller.batch_size
            stats.ingest_queue_depth = self.gate.outstanding()
            stats.credits_available = self.gate.available
            stats.controller_trace = self.controller.trace_tail()

    def _cancelled(self) -> bool:
        tok = self.cancel_token
        return tok is not None and tok.cancelled

    # -- generation loop -------------------------------------------------
    def _step(self, emit) -> bool:
        self.coalescer.ensure_started(emit)
        self.coalescer.check_error()
        if self._cancelled():
            raise GraphCancelled(f"ingest source {self.node_name} cancelled")
        if not self._opened:
            self.transport.open(self._cancelled)
            self._opened = True
        got = self.transport.poll(self.controller.target_batch())
        if got is _EOS:
            self.coalescer.close()
            return False
        for batch in got:
            self.coalescer.put(batch)
        return True

    def svc_end(self) -> None:
        # error-path teardown (close() already stopped the flusher on
        # the normal path): drop the staged backlog, free the transport
        self.coalescer.abort()
        try:
            self.transport.close()
        except OSError:
            pass
        if self.closing_func is not None:
            self.closing_func(self.context)

    def quiesce(self, emit) -> bool:
        """Live-checkpoint barrier hook: wait for the flusher to drain
        the stage (the barrier pauses the poll loop, not the flusher)."""
        return self.coalescer.wait_idle()

    # -- checkpoint: transports with a position resume from it ----------
    def state_dict(self):
        # always a real dict: _is_stateful() sees the override, so a
        # None here would omit the node from the snapshot while
        # restore_graph still requires it (structure-mismatch error).
        # Position-less transports (socket/async) snapshot as None and
        # restore as a no-op (the stream resumes wherever the peer is).
        sd = getattr(self.transport, "state_dict", None)
        return {"transport": sd() if sd is not None else None}

    def load_state(self, state) -> None:
        ts = state.get("transport")
        if ts is not None:
            self.transport.load_state(ts)

    # -- audit plane (audit/progress.py): monotone source position ------
    def progress_frontier(self):
        """Transport position when the transport keeps one (replay
        offset, socket bytes decoded into tuples), else the coalescer's
        cumulative raw-emitted counter -- both monotone, both updated
        by the replica's own threads (gauge-grade read)."""
        tp = getattr(self.transport, "position", None)
        if tp is not None:
            try:
                v = tp()
            except (RuntimeError, TypeError):
                v = None
            if v is not None:
                return v
        return self.coalescer.raw_emitted

    # -- observability ---------------------------------------------------
    def metrics(self) -> dict:
        return {
            "credits_budget": self.gate.budget,
            "credits_available": self.gate.available,
            "credits_peak_outstanding": self.gate.peak_outstanding,
            "credit_waits": self.gate.credit_waits,
            "credit_wait_time_s": round(self.gate.wait_time_s, 4),
            "tuples_shed": self.tuples_shed,
            "tuples_staged": self.coalescer.tuples_staged,
            "tuples_emitted": self.coalescer.tuples_emitted,
            "raw_emitted": self.coalescer.raw_emitted,
            "batches_emitted": self.coalescer.batches_emitted,
            "peak_staged": self.coalescer.peak_staged,
            "batch_size": self.controller.batch_size,
            "flush_interval_ms": round(self.controller.flush_interval_ms, 3),
            "controller_trace": self.controller.trace_tail(),
            "pre_reduce": self.coalescer.pre_reduce is not None,
        }


# ---------------------------------------------------------------------------
# Transports
# ---------------------------------------------------------------------------

class _SocketTransport:
    """Non-blocking TCP client speaking the `codec` frame protocol."""

    def __init__(self, host: str, port: int, connect_timeout_s: float = 10.0,
                 recv_bytes: int = 1 << 20):
        self.host = host
        self.port = port
        self.connect_timeout_s = connect_timeout_s
        self.recv_bytes = recv_bytes
        self.sock: Optional[socket.socket] = None
        self.decoder = StreamDecoder()
        self.bytes_received = 0

    def open(self, cancelled_fn: Callable[[], bool]) -> None:
        deadline = _time.monotonic() + self.connect_timeout_s
        last_err: Optional[Exception] = None
        while True:
            if cancelled_fn():
                raise GraphCancelled("socket source cancelled while "
                                     "connecting")
            try:
                s = socket.create_connection((self.host, self.port),
                                             timeout=0.25)
                s.settimeout(_POLL_S)
                self.sock = s
                return
            except OSError as e:
                last_err = e
                if _time.monotonic() > deadline:
                    raise ConnectionError(
                        f"socket source: cannot connect to "
                        f"{self.host}:{self.port}") from last_err
                _time.sleep(0.05)

    def poll(self, n_hint: int):
        try:
            data = self.sock.recv(self.recv_bytes)
        except socket.timeout:
            return []
        except OSError as e:
            # a reset/abort mid-stream is a transport FAILURE, not end
            # of stream: fail the replica (graph cancels, the error is
            # reported) instead of completing on a truncated prefix.
            # Clean EOS is recv() returning b"" below.
            raise ConnectionError(
                f"socket source: connection to {self.host}:{self.port} "
                f"failed mid-stream after {self.bytes_received} bytes: "
                f"{e}") from e
        if not data:
            return _EOS
        self.bytes_received += len(data)
        return self.decoder.feed(data)

    def close(self) -> None:
        if self.sock is not None:
            self.sock.close()
            self.sock = None

    def position(self):
        """Audit frontier: the socket chunk sequence -- frames decoded
        so far (monotone; decoder counters are single-writer)."""
        return self.decoder.frames_decoded \
            if hasattr(self.decoder, "frames_decoded") \
            else self.bytes_received


class _ReplayTransport:
    """Timestamp-faithful trace replay with rate control.

    ``trace`` is a TupleBatch, a dict of columns, or a path to an
    ``.npz`` with key/id/ts/value arrays.  ``speedup`` scales the
    recorded inter-arrival gaps (None = as fast as possible);
    ``ts_unit_s`` converts the ts column to seconds.  With ``chunk``
    set, chunk sizes are drawn (in [chunk//2, chunk]) from a
    seed-keyed RNG: boundaries are a pure function of (trace, chunk,
    seed, shard), never of wall clock, so a seeded replay is
    deterministic and composes with the resilience FaultPlan harness
    while different seeds exercise different batching.  ``chunk=None``
    instead lets the adaptive controller size chunks (max-throughput
    mode).
    """

    def __init__(self, trace, *, speedup: Optional[float] = 1.0,
                 ts_unit_s: float = 1e-6, chunk: Optional[int] = 65536,
                 seed: int = 0, shard: tuple = (0, 1)):
        self.trace_spec = trace
        self.speedup = speedup
        self.ts_unit_s = ts_unit_s
        self.chunk = chunk
        self.seed = seed
        self.shard = shard
        self.cols = None
        self.off = 0
        self.hi = 0
        self._t0 = 0.0
        self._ts0 = 0
        self._rng = np.random.default_rng(seed)

    def open(self, cancelled_fn) -> None:
        spec = self.trace_spec
        if isinstance(spec, (str, os.PathLike)):
            with np.load(spec) as z:
                cols = {k: z[k] for k in z.files}
        elif isinstance(spec, TupleBatch):
            cols = spec.cols
        else:
            cols = dict(spec)
        n = len(cols["ts"])
        ridx, nrep = self.shard
        lo = n * ridx // nrep
        self.hi = n * (ridx + 1) // nrep
        self.off = lo
        self.cols = cols
        self._t0 = _time.monotonic()
        self._ts0 = int(cols["ts"][lo]) if self.hi > lo else 0

    def poll(self, n_hint: int):
        if self.off >= self.hi:
            return _EOS
        if self.chunk is not None:
            # seeded chunk-size jitter: boundaries are a pure function
            # of (trace, chunk, seed, shard) -- reproducible for the
            # FaultPlan harness, varied across seeds
            n = int(self._rng.integers(max(1, self.chunk // 2),
                                       self.chunk + 1))
        else:
            n = max(1, n_hint)
        end = min(self.off + n, self.hi)
        if self.speedup:
            # pace on the chunk's first timestamp; sleep in short,
            # cancel-checkable slices (the caller re-polls)
            due = (self._t0 + (int(self.cols["ts"][self.off]) - self._ts0)
                   * self.ts_unit_s / self.speedup)
            delay = due - _time.monotonic()
            if delay > 0:
                _time.sleep(min(delay, _POLL_S))
                if delay > _POLL_S:
                    return []
        batch = TupleBatch({k: v[self.off:end]
                            for k, v in self.cols.items()})
        self.off = end
        return [batch]

    def close(self) -> None:
        self.cols = None

    # -- checkpoint: replay resumes from its offset ---------------------
    def state_dict(self):
        return {"off": self.off}

    def load_state(self, state) -> None:
        self.off = state["off"]

    def position(self):
        """Audit frontier: the replay offset (same monotone position
        the checkpoint plane snapshots)."""
        return self.off


class _AsyncGenTransport:
    """Drives an async generator on a private event loop.

    The generator may yield ``TupleBatch`` items (passed through) or
    record objects / ``(key, id, ts, value)`` tuples (accumulated and
    converted columnar per poll).
    """

    def __init__(self, factory: Callable[[], Any], record_batch: int = 4096):
        self.factory = factory
        self.record_batch = record_batch
        self.loop = None
        self.agen = None
        self._pending = None
        self._records: List = []
        self._done = False

    def open(self, cancelled_fn) -> None:
        import asyncio
        self.loop = asyncio.new_event_loop()
        self.agen = self.factory()
        if not hasattr(self.agen, "__anext__"):
            raise TypeError("AsyncGeneratorSource needs a factory "
                            "returning an async generator")

    def _flush_records(self) -> List[TupleBatch]:
        if not self._records:
            return []
        recs, self._records = self._records, []
        if isinstance(recs[0], tuple):
            arr = np.asarray(recs)
            out = TupleBatch({
                "key": arr[:, 0].astype(np.int64),
                "id": arr[:, 1].astype(np.int64),
                "ts": arr[:, 2].astype(np.int64),
                "value": arr[:, 3].astype(np.float64)})
        else:
            out = TupleBatch.from_records(recs)
        return [out]

    def poll(self, n_hint: int):
        import asyncio
        if self._done:
            return self._flush_records() or _EOS
        out: List[TupleBatch] = []
        deadline = _time.monotonic() + _POLL_S
        budget = max(n_hint, self.record_batch)
        while True:
            if self._pending is None:
                self._pending = self.loop.create_task(
                    self.agen.__anext__())
            timeout = deadline - _time.monotonic()
            done, _ = self.loop.run_until_complete(asyncio.wait(
                {self._pending}, timeout=max(0.0, timeout)))
            if not done:
                break
            task, self._pending = self._pending, None
            try:
                item = task.result()
            except StopAsyncIteration:
                self._done = True
                break
            if isinstance(item, TupleBatch):
                out.extend(self._flush_records())
                out.append(item)
            else:
                self._records.append(item)
            got = sum(len(b) for b in out) + len(self._records)
            if got >= budget or _time.monotonic() >= deadline:
                break
        if self._done or sum(len(b) for b in out) + len(self._records) \
                >= self.record_batch:
            out.extend(self._flush_records())
        if self._done and not out:
            return self._flush_records() or _EOS
        return out

    def close(self) -> None:
        if self.loop is not None:
            if self._pending is not None:
                self._pending.cancel()
                try:
                    self.loop.run_until_complete(self._pending)
                except BaseException:
                    pass
                self._pending = None
            if self.agen is not None:
                try:
                    self.loop.run_until_complete(self.agen.aclose())
                except BaseException:
                    pass
            self.loop.close()
            self.loop = None


# ---------------------------------------------------------------------------
# Operator descriptors
# ---------------------------------------------------------------------------

class _IngestOperator(Operator):
    """Shared descriptor: N replica logics, standard emitter."""

    def __init__(self, name: str, parallelism: int = 1, *,
                 credits: Optional[int] = None,
                 admission: Optional[AdmissionConfig] = None,
                 latency_target_ms: Optional[float] = None,
                 initial_batch: Optional[int] = None,
                 max_batch: Optional[int] = None,
                 coalesce: bool = True,
                 pre_reduce: Union[str, bool] = "auto",
                 closing_func: Optional[Callable] = None):
        super().__init__(name, parallelism, RoutingMode.NONE, Pattern.SOURCE)
        self.credits = credits
        self.admission = admission
        self.latency_target_ms = latency_target_ms
        self.initial_batch = initial_batch
        self.max_batch = max_batch
        self.coalesce = coalesce
        self.pre_reduce = pre_reduce
        self.closing_func = closing_func
        self.logics: List[IngestSourceLogic] = []  # filled by stages()

    def _transport(self, replica_index: int):
        raise NotImplementedError

    def _logic_kwargs(self) -> dict:
        return dict(credits=self.credits, admission=self.admission,
                    latency_target_ms=self.latency_target_ms,
                    initial_batch=self.initial_batch,
                    max_batch=self.max_batch, coalesce=self.coalesce,
                    pre_reduce=self.pre_reduce,
                    closing_func=self.closing_func)

    def stages(self) -> List[StageSpec]:
        self.logics = [
            IngestSourceLogic(self.name, self._transport(i),
                              parallelism=self.parallelism, replica_index=i,
                              **self._logic_kwargs())
            for i in range(self.parallelism)]
        return [StageSpec(self.name, self.logics, StandardEmitter(),
                          self.routing)]

    def metrics(self) -> List[dict]:
        return [lg.metrics() for lg in self.logics]

    def shed_count(self) -> int:
        return sum(lg.tuples_shed for lg in self.logics)


class SocketSource(_IngestOperator):
    """Framed-TCP ingest: each replica opens one client connection to
    ``host:port`` and decodes `codec` frames into the batch plane."""

    def __init__(self, host: str, port: int, parallelism: int = 1,
                 name: str = "socket_source",
                 connect_timeout_s: float = 10.0, **kw):
        super().__init__(name, parallelism, **kw)
        self.host = host
        self.port = port
        self.connect_timeout_s = connect_timeout_s

    def _transport(self, replica_index: int):
        return _SocketTransport(self.host, self.port,
                                self.connect_timeout_s)


class ReplaySource(_IngestOperator):
    """Timestamp-faithful trace replay (see :class:`_ReplayTransport`).
    Replicas replay contiguous shards of the trace."""

    def __init__(self, trace, parallelism: int = 1, name: str = "replay",
                 speedup: Optional[float] = 1.0, ts_unit_s: float = 1e-6,
                 chunk: Optional[int] = 65536, seed: int = 0, **kw):
        super().__init__(name, parallelism, **kw)
        self.trace = trace
        self.speedup = speedup
        self.ts_unit_s = ts_unit_s
        self.chunk = chunk
        self.seed = seed

    def _transport(self, replica_index: int):
        return _ReplayTransport(
            self.trace, speedup=self.speedup, ts_unit_s=self.ts_unit_s,
            chunk=self.chunk, seed=self.seed,
            shard=(replica_index, self.parallelism))


class AsyncGeneratorSource(_IngestOperator):
    """Async-generator ingest: ``factory()`` is called once per replica
    and must return an async generator yielding batches or records."""

    def __init__(self, factory: Callable[[], Any], parallelism: int = 1,
                 name: str = "async_source", **kw):
        super().__init__(name, parallelism, **kw)
        self.factory = factory

    def _transport(self, replica_index: int):
        return _AsyncGenTransport(self.factory)


def serve_batches(sock: socket.socket,
                  batches: Sequence[TupleBatch]) -> int:
    """Test/bench helper: send ``batches`` as codec frames over an
    accepted connection; returns bytes sent."""
    from ..distributed.wire import encode_batch
    total = 0
    for b in batches:
        data = encode_batch(b)
        sock.sendall(data)
        total += len(data)
    return total
