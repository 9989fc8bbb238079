"""Credit-backpressured shuffle transport: cross-worker PipeGraph edges
over non-blocking TCP (docs/DISTRIBUTED.md "Shuffle transport").

One **edge** = one consumer replica's inbound channel.  When the
partition plan puts a producer and that consumer in different workers,
the producer's outlet destination is swapped for a
:class:`RemoteEdgeSender` (same channel duck type the runtime already
speaks: ``put``/``put_many``/``close``/``poison`` plus the counter
surface the audit ledger reads), and the consumer's worker runs a
:class:`ShuffleServer` whose receiver threads decode frames back into
the real channel.  Everything an in-process edge carries rides the
frames: data batches, scalar records, ``EpochBarrier`` control items,
per-producer EOS -- so fusion, alignment, audit books and EOS
propagation behave identically on both sides of the wire.

Backpressure is the ingest plane's credit protocol extended across the
socket: the sender spends a
:class:`~windflow_tpu_torch.ingest.credits.CreditGate` budget per tuple
and the receiver grants credits back only AFTER the item landed in the
consumer's bounded channel -- a slow remote consumer therefore
throttles the remote producer exactly like an in-process
``CreditedChannel`` (and the kernel's flow control never needs to
buffer more than the credit window).

Reliability: data-plane frames are sequenced per (edge, producer
worker); the sender keeps a replay buffer of unacked frames (bounded
by the credit window) and, on a transport error, reconnects with a
resume HELLO -- the receiver replies with its acked sequence, the
sender retransmits the rest, and the receiver drops duplicates below
its high-water mark: no loss, no duplication across reconnects.  An
*injected* wire drop (``FaultPlan.drop_link``) skips the socket write
while still counting intent, which is exactly the divergence the
conservation surfaces must flag: the receiver sees the sequence gap
immediately and the producer's STATS trailer at edge close pins the
exact edge and tuple count.
"""
from __future__ import annotations

import random
import socket
import struct
import threading
import time as _time
import zlib
from collections import deque
from typing import Dict, Optional

from ..audit.ledger import _op_of
from ..ingest.credits import CreditGate
from ..resilience.cancel import GraphCancelled
from . import wire

# socket pacing: short timeouts keep every blocking call cancellable
_POLL_S = 0.1
_SEND_TIMEOUT_S = 5.0

# reconnect backoff envelope (RemoteEdgeSender._send_frame): base
# doubles per attempt up to the cap, then a multiplicative jitter of up
# to +50% spreads simultaneous retries apart
_BACKOFF_BASE_S = 0.05
_BACKOFF_CAP_S = 0.8
_BACKOFF_JITTER = 0.5


def backoff_delay(attempt: int, rng: random.Random) -> float:
    """Delay in seconds before reconnect ``attempt`` (0-based):
    capped exponential with multiplicative jitter."""
    d = min(_BACKOFF_CAP_S, _BACKOFF_BASE_S * (2 ** max(0, attempt)))
    return d * (1.0 + _BACKOFF_JITTER * rng.random())


class WireError(ConnectionError):
    """A shuffle edge broke beyond the reconnect budget."""


def _recv_some(sock) -> Optional[bytes]:
    """One poll-bounded recv; None on timeout, b'' on clean EOF."""
    try:
        return sock.recv(1 << 20)
    except socket.timeout:
        return None


class _PartialTraceView:
    """A live producer-side view of a trace that left this worker over
    a wire edge.  Serializes like a closed trace record but flagged
    ``partial``: attribution skips it (its span never reached a sink
    here), while the cross-worker merge
    (distributed/observe.stitch_traces) joins it by trace id into the
    consumer-side record that closed the same trace.  The view wraps
    the LIVE context, so hops stamped moments after the frame header
    was snapshotted -- fused upstream segments unwind outward through
    the send -- still make the producer's record and therefore the
    stitched cluster-wide one."""

    __slots__ = ("ctx", "edge")

    is_partial = True

    def __init__(self, ctx, edge: str):
        self.ctx = ctx
        self.edge = edge

    def to_dict(self, t_end: float) -> dict:
        d = self.ctx.to_dict(t_end)
        d["partial"] = True
        d["wire_edge"] = self.edge
        return d


class RemoteEdgeSender:
    """Producer-side half of one shuffle edge: a channel-duck-typed
    object the owning worker's outlets deliver into.

    Counter contract (audit/ledger.py): ``puts`` counts accepted items,
    ``gets`` acked ones, ``depth``/``qsize`` the unacked replay buffer
    -- so the per-edge books close locally at ``wait_end`` exactly like
    a bounded channel's (everything accepted was either acked or is
    demonstrably in the replay buffer).
    """

    is_wire_sender = True

    def __init__(self, edge: str, host: str, port: int, graph,
                 pids, spec, runtime=None):
        self.edge = edge                      # consumer node name
        self.edge_name = f"wire:{edge}"       # ledger / flight label
        self.consumer_op = _op_of(edge)       # diagnosis topology hint
        self.host = host
        self.port = port
        self.graph = graph
        self.spec = spec
        self.runtime = runtime
        self.gate = CreditGate(int(getattr(spec, "wire_credits", 1 << 15)))
        self._lock = threading.RLock()
        self._sock: Optional[socket.socket] = None
        self._seq = 0                         # next data-plane sequence
        self._unacked: deque = deque()        # (seq, frame, credits)
        self._acked_seq = 0
        self._pids = set(int(p) for p in pids)
        self._closed = set()
        self._finals = 0              # final barriers shipped (one/pid)
        self._barrier_seen: Dict[int, int] = {}
        self._barrier_acked = set()
        self._cancelled = False
        self._reader: Optional[threading.Thread] = None
        # link fault state (FaultPlan.drop_link / delay_link)
        self.faults = None
        # durability plane (set by EpochCoordinator.rewire)
        self.epoch_coord = None
        # -- counters (ledger surface + cross-process conservation) ----
        self.puts = 0
        self.gets = 0
        self.high_watermark = 0
        # running tuple sum of the replay buffer (gauge-grade read by
        # block(); maintained under the lock by _ship/_apply_ack so
        # the stats path never takes the send lock -- a reconnecting
        # producer may hold it for seconds)
        self.unacked_tuples = 0
        self.tuples_sent = 0
        self.frames_sent = 0
        self.barriers_sent = 0
        self.frames_dropped = 0
        self.reconnects = 0
        self.capacity = None
        # reconnect backoff (jittered exponential, _send_frame): seeded
        # per edge so a cluster of senders losing one consumer does not
        # retry in lockstep, yet each run's delay sequence is
        # reproducible from the edge name
        self._backoff_rng = random.Random(
            zlib.crc32(self.edge_name.encode("utf-8")))

    # -- channel duck type ---------------------------------------------
    @property
    def n_producers(self) -> int:
        return len(self._pids)

    @property
    def depth(self) -> int:
        return len(self._unacked)

    def qsize(self) -> int:
        return len(self._unacked)

    @property
    def poisoned(self) -> bool:
        return self._cancelled

    def put(self, producer_id: int, item) -> None:
        # credits are the cross-process backpressure: block here until
        # the remote consumer's grants catch up (cancel-aware).  The
        # cost is known before encoding, so a traced item's send stamp
        # is taken after any credit wait, not before it.  It must
        # mirror decode_item's grant exactly: batches cost their
        # length, everything else (records -- even ones with __len__ --
        # barriers, markers) costs 1, or the asymmetry would leak the
        # gate dry.
        from ..core.tuples import SynthChunk, TupleBatch
        if isinstance(item, (TupleBatch, SynthChunk)):
            cost = max(1, len(item))
        else:
            cost = 1
        self.gate.acquire(cost)
        ctx = getattr(item, "trace", None)
        kind, payload, cost = wire.encode_item(
            item, getattr(self.graph, "buffer_pool", None))
        self._ship(kind, producer_id, payload, cost,
                   barrier=item if kind == wire.MSG_BARRIER else None)
        if ctx is not None and getattr(ctx, "trace_id", None) \
                and kind in (wire.MSG_DATA, wire.MSG_RECORD):
            # producer-side PARTIAL trace record: the trace continues
            # on the consumer worker, but this worker's share of it --
            # including hops that land after the frame header snapshot
            # -- must survive into the merged cluster view (separate
            # bounded ring: never evicts locally-closed records)
            self.graph.stats.add_trace_partial(
                (_PartialTraceView(ctx, self.edge),
                 _time.perf_counter()))
        if self.runtime is not None and kind != wire.MSG_BARRIER:
            self.runtime.count_transport(cost)

    def put_many(self, producer_id: int, items) -> None:
        for item in items:
            self.put(producer_id, item)

    def close(self, producer_id: int) -> None:
        """Per-producer EOS.  Bypasses the credit gate (like a bounded
        channel's close): a producer must always be able to announce
        its end of stream."""
        with self._lock:
            if self._cancelled:
                return
            self._closed.add(int(producer_id))
            last = self._closed >= self._pids
        self._ship(wire.MSG_EOS, producer_id, b"", 0)
        if last:
            import json
            trailer = json.dumps({
                "tuples": self.tuples_sent, "frames": self.frames_sent,
                "barriers": self.barriers_sent}).encode("utf-8")
            self._ship(wire.MSG_STATS, 0, struct.pack("<H", 0) + trailer,
                       0)

    def poison(self) -> None:
        """Graph cancellation: unblock the gate, tell the peer, drop
        the socket.  Deliberately LOCK-FREE: a producer thread may be
        holding ``self._lock`` inside a reconnect loop for many
        seconds, and ``CancelToken.cancel`` poisons its registrants
        serially -- blocking here would stall the whole graph's
        teardown.  The flag write is atomic; the in-flight thread's
        cancel checks trip on it, and closing the socket snapshot
        (without nulling the field -- the owner handles that) unwedges
        a blocked sendall."""
        if self._cancelled:
            return
        self._cancelled = True
        self.gate.poison()
        s = self._sock
        if s is not None:
            try:
                s.sendall(wire.encode_msg(
                    wire.MSG_CANCEL, 0, 0, b"producer graph cancelled"))
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass

    # -- shipping ------------------------------------------------------
    def _ship(self, kind: int, pid: int, payload: bytes, cost: int,
              barrier=None) -> None:
        with self._lock:
            if self._cancelled:
                raise GraphCancelled(f"{self.edge_name} poisoned")
            self._seq += 1
            seq = self._seq
            frame = wire.encode_msg(kind, int(pid), seq, payload)
            # EOS/STATS are control traffic: the bounded channels they
            # mirror count neither (close() is not a put), so the
            # ledger's channel book must not see them either
            counted = kind not in (wire.MSG_STATS, wire.MSG_EOS)
            # data_cost: TUPLES in this frame (what tuples_sent counts)
            # -- the live merge bounds a delivery shortfall by the
            # replay buffer's tuple sum, so the unit must match
            data_cost = cost if kind in (wire.MSG_DATA,
                                         wire.MSG_RECORD) else 0
            self._unacked.append((seq, frame, counted, cost, data_cost))
            self.unacked_tuples += data_cost
            if len(self._unacked) > self.high_watermark:
                self.high_watermark = len(self._unacked)
            if counted:
                self.puts += 1
            self.frames_sent += 1
            if kind in (wire.MSG_DATA, wire.MSG_RECORD):
                self.tuples_sent += cost
            dropped = False
            f = self.faults
            if f is not None:
                if f.drop_frame(self.frames_sent):
                    dropped = True
                    self.frames_dropped += 1
                    self.graph.flight.record(
                        "wire_drop_injected", edge=self.edge,
                        frame=self.frames_sent)
                f.maybe_delay(self.frames_sent)
            if dropped:
                # the frame is gone for good: hand its credits back so
                # the loss surfaces in the conservation books, not as a
                # wedged credit window (a dropped batch >= the budget
                # would otherwise block the producer forever)
                if cost:
                    self.gate.release(cost)
            else:
                self._send_frame(frame)
            if barrier is not None:
                self.barriers_sent += 1
                self._track_barrier(barrier)

    def _track_barrier(self, b) -> None:
        """Ack epoch ``e`` to the local coordinator once every live
        local producer forwarded its barrier -- this edge then acts as
        the epoch's sink on this worker (the real alignment happens on
        the consumer's side of the wire)."""
        coord = self.epoch_coord
        if b.final:
            # callers ship exactly one final barrier per (outlet dest)
            # = per pid (RtNode.run broadcast_final)
            self._finals += 1
        else:
            self._barrier_seen[b.epoch] = \
                self._barrier_seen.get(b.epoch, 0) + 1
        if coord is None:
            return
        live = max(1, len(self._pids) - self._finals)
        for e, n in list(self._barrier_seen.items()):
            if n >= live and e not in self._barrier_acked:
                self._barrier_acked.add(e)
                coord.sink_ack(e, self.edge_name)
        if self._finals >= len(self._pids):
            coord.node_finished(self.edge_name, {})

    def _send_frame(self, frame: bytes) -> None:
        attempts = int(getattr(self.spec, "wire_reconnects", 2))
        attempt = 0
        while True:
            try:
                self._ensure_open()
                self._sock.sendall(frame)
                return
            except OSError as e:
                if self._cancelled:
                    raise GraphCancelled(f"{self.edge_name} poisoned")
                self._close_sock()
                if attempts <= 0:
                    raise WireError(
                        f"shuffle edge {self.edge!r} to "
                        f"{self.host}:{self.port} failed after "
                        f"{self.frames_sent} frames: {e}") from e
                attempts -= 1
                self.reconnects += 1
                # jittered exponential backoff before the reconnect: a
                # consumer worker restarting must not be hammered at a
                # fixed 50 ms cadence by every surviving sender at once
                # (the jitter de-synchronizes them; the per-edge seeded
                # RNG keeps each run's delay sequence reproducible).
                # _ensure_open resumes + retransmits; the loop then
                # re-sends THIS frame (it is the newest unacked one,
                # so the resume already retransmitted it -- dedup by
                # sequence makes the extra copy harmless)
                delay = backoff_delay(attempt, self._backoff_rng)
                attempt += 1
                self.graph.flight.record(
                    "wire_reconnect_backoff", edge=self.edge_name,
                    attempt=attempt, delay_s=round(delay, 4),
                    error=repr(e))
                _time.sleep(delay)

    def _ensure_open(self) -> None:
        if self._sock is not None:
            return
        import json
        deadline = _time.monotonic() + float(
            getattr(self.spec, "connect_timeout_s", 10.0))
        last: Optional[Exception] = None
        while True:
            if self._cancelled:
                raise GraphCancelled(f"{self.edge_name} poisoned")
            try:
                s = socket.create_connection((self.host, self.port),
                                             timeout=0.25)
                break
            except OSError as e:
                last = e
                if _time.monotonic() > deadline:
                    raise WireError(
                        f"shuffle edge {self.edge!r}: cannot connect "
                        f"to {self.host}:{self.port}") from last
                _time.sleep(0.05)
        s.settimeout(_SEND_TIMEOUT_S)
        resume = self._acked_seq > 0 or self._seq > 0
        hello = json.dumps({
            "edge": self.edge,
            "worker": int(getattr(self.spec, "worker_id", -1)),
            "pids": sorted(self._pids),
            "resume": bool(resume),
            "graph": self.graph.name,
        }).encode("utf-8")
        s.sendall(wire.encode_msg(wire.MSG_HELLO, 0, 0, hello))
        if resume:
            self._resync(s)
        self._sock = s
        self._start_reader()

    def _resync(self, s: socket.socket) -> None:
        """Resume handshake: the receiver replies with its acked
        sequence; retransmit every newer unacked frame in order."""
        dec = wire.MsgDecoder()
        deadline = _time.monotonic() + float(
            getattr(self.spec, "connect_timeout_s", 10.0))
        acked = None
        while acked is None:
            if _time.monotonic() > deadline:
                raise WireError(
                    f"shuffle edge {self.edge!r}: no resume ack")
            data = _recv_some(s)
            if data == b"":
                raise WireError(
                    f"shuffle edge {self.edge!r}: peer closed during "
                    "resume")
            if not data:
                continue
            for kind, _pid, _seq, payload in dec.feed(data):
                if kind == wire.MSG_CREDIT:
                    _tuples, acked = wire.decode_credit(payload)
                    break
                if kind == wire.MSG_CANCEL:
                    raise GraphCancelled(
                        f"{self.edge_name}: peer cancelled")
        # the acked prefix was delivered on the DEAD connection, so its
        # credit grants are gone with it -- release those costs here
        # (release is clamped at the budget, so a grant that DID land
        # before the drop can at worst over-credit harmlessly, never
        # leak the window smaller on every reconnect)
        self._apply_ack(0, acked, release_popped=True)
        for _seq, frame, _counted, _cost, _dc in list(self._unacked):
            s.sendall(frame)

    def _start_reader(self) -> None:
        t = threading.Thread(target=self._reader_loop, daemon=True,
                             name=f"windflow-wire-tx-{self.edge}")
        self._reader = t
        t.start()

    def _reader_loop(self) -> None:
        """Credit/cancel pump for the current connection; exits when
        the socket dies (the next put reconnects) or the edge is done."""
        sock = self._sock
        if sock is None:
            return
        sock.settimeout(_POLL_S)
        dec = wire.MsgDecoder()
        while not self._cancelled:
            if sock is not self._sock:
                return  # superseded by a reconnect
            try:
                data = _recv_some(sock)
            except OSError:
                return
            if data is None:
                if self._done():
                    self._close_sock(sock)
                    return
                continue
            if data == b"":
                return  # peer closed; next put reconnects if needed
            try:
                msgs = dec.feed(data)
            except ValueError:
                return
            for kind, _pid, _seq, payload in msgs:
                if kind == wire.MSG_CREDIT:
                    tuples, acked = wire.decode_credit(payload)
                    self._apply_ack(tuples, acked)
                elif kind == wire.MSG_CANCEL:
                    reason = payload.decode("utf-8", "replace")
                    self._cancelled = True
                    self.gate.poison()
                    self.graph._cancel.cancel(
                        WireError(f"{self.edge_name}: consumer worker "
                                  f"cancelled ({reason})"),
                        origin=self.edge_name)
                    return
            if self._done():
                self._close_sock(sock)
                return

    def _apply_ack(self, tuples: int, acked_seq: int,
                   release_popped: bool = False) -> None:
        with self._lock:
            if acked_seq > self._acked_seq:
                self._acked_seq = acked_seq
            popped = 0
            popped_cost = 0
            while self._unacked and self._unacked[0][0] <= acked_seq:
                _seq, _frame, counted, cost, data_cost = \
                    self._unacked.popleft()
                if counted:
                    popped += 1
                popped_cost += cost
                self.unacked_tuples -= data_cost
            self.gets += popped
        if release_popped and popped_cost:
            self.gate.release(popped_cost)
        if tuples:
            self.gate.release(tuples)

    def _done(self) -> bool:
        with self._lock:
            return self._closed >= self._pids and not self._unacked

    def _close_sock(self, only=None) -> None:
        with self._lock:
            s = self._sock
            if s is None or (only is not None and s is not only):
                return
            self._sock = None
        try:
            s.close()
        except OSError:
            pass

    def flush(self, timeout: float = 10.0) -> bool:
        """Wait for the peer to ack every shipped frame (the replay
        buffer drains), so the local ledger closes over this edge."""
        deadline = _time.monotonic() + timeout
        while self._unacked and not self._cancelled:
            if _time.monotonic() > deadline:
                return False
            _time.sleep(0.005)
        return True

    def block(self) -> dict:
        """One row of the stats-JSON ``Wire.out`` table.  Deliberately
        LOCK-FREE (gauge-grade reads): a producer thread may hold the
        send lock for seconds inside a reconnect loop, and the stats /
        live-push path must keep reporting exactly then."""
        return {
            "edge": self.edge, "to": (self.host, self.port),
            "tuples": self.tuples_sent, "frames": self.frames_sent,
            "barriers": self.barriers_sent,
            "dropped_frames": self.frames_dropped,
            "unacked": len(self._unacked),
            # tuple sum of the replay buffer: the live merge's
            # in-flight bound (frames != tuples on the batch plane)
            "unacked_tuples": max(0, self.unacked_tuples),
            "reconnects": self.reconnects,
            "credit_waits": self.gate.credit_waits,
            "credit_wait_s": round(self.gate.wait_time_s, 4),
        }


class _WireStream:
    """Per (edge, producer-worker) receive state: sequence high-water,
    gap accounting, the producer's trailer."""

    __slots__ = ("worker", "pids", "next_seq", "gaps", "frames",
                 "tuples", "barriers", "trailer", "resumed")

    def __init__(self, worker: int, pids):
        self.worker = worker
        self.pids = set(pids)
        self.next_seq = 1
        self.gaps = 0
        self.frames = 0
        self.tuples = 0
        self.barriers = 0
        self.trailer: Optional[dict] = None
        self.resumed = threading.Event()


class EdgeState:
    """Consumer-side registry entry for one inbound shuffle edge."""

    def __init__(self, edge: str, channel, expected: Dict[int, set]):
        self.edge = edge
        self.channel = channel               # the consumer's raw channel
        self.expected = expected             # worker -> pid set
        self.streams: Dict[int, _WireStream] = {}
        self.closed_pids = set()
        self.completed = False
        self.finished_reported = False
        self.lock = threading.Lock()

    def stream_for(self, worker: int, pids) -> _WireStream:
        with self.lock:
            st = self.streams.get(worker)
            if st is None:
                st = self.streams[worker] = _WireStream(worker, pids)
            else:
                st.resumed.set()
            return st

    @property
    def all_pids(self):
        return {p for pids in self.expected.values() for p in pids}

    def blocks(self):
        """Rows of the stats-JSON ``Wire.in`` table."""
        with self.lock:
            return [{
                "edge": self.edge, "from_worker": st.worker,
                "tuples": st.tuples, "frames": st.frames,
                "barriers": st.barriers, "gaps": st.gaps,
                "sender_tuples": (st.trailer or {}).get("tuples"),
                "sender_frames": (st.trailer or {}).get("frames"),
            } for st in self.streams.values()]


class ShuffleServer:
    """Per-worker listener: accepts producer connections, routes each
    (after its HELLO) to the edge it feeds, and pumps frames into the
    consumer channel with per-frame credit grants."""

    def __init__(self, graph, spec, edges: Dict[str, EdgeState],
                 runtime=None):
        self.graph = graph
        self.spec = spec
        self.edges = edges
        self.runtime = runtime
        self.grace_s = float(getattr(spec, "reconnect_grace_s", 2.0))
        host, port = spec.endpoints[spec.worker_id]
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((host, int(port)))
        self._lsock.listen(16)
        self._lsock.settimeout(_POLL_S)
        self.port = self._lsock.getsockname()[1]
        self._stop = threading.Event()
        self._threads = []
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"windflow-shuffle-accept-w{spec.worker_id}")

    def start(self) -> None:
        self._accept_thread.start()

    def stop(self) -> None:
        self._stop.set()
        try:
            self._lsock.close()
        except OSError:
            pass
        for t in list(self._threads):
            t.join(timeout=1.0)

    @property
    def _cancelled(self) -> bool:
        return self.graph._cancel.cancelled

    def _accept_loop(self) -> None:
        while not self._stop.is_set() and not self._cancelled:
            try:
                conn, _addr = self._lsock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            t = threading.Thread(target=self._serve, args=(conn,),
                                 daemon=True,
                                 name="windflow-shuffle-rx")
            # prune finished connections (a flapping link would
            # otherwise grow this list one dead thread per reconnect)
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)
            t.start()

    # -- one connection ------------------------------------------------
    def _serve(self, conn: socket.socket) -> None:
        import json
        conn.settimeout(_POLL_S)
        dec = wire.MsgDecoder()
        hello = None
        backlog = []   # frames decoded in the same chunk as the HELLO
        edge: Optional[EdgeState] = None
        st: Optional[_WireStream] = None
        try:
            while hello is None:
                if self._stop.is_set() or self._cancelled:
                    conn.close()
                    return
                data = _recv_some(conn)
                if data == b"":
                    conn.close()
                    return
                if not data:
                    continue
                msgs = dec.feed(data)
                for i, (kind, _pid, _seq, payload) in enumerate(msgs):
                    if kind == wire.MSG_HELLO:
                        hello = json.loads(payload.decode("utf-8"))
                        # the sender pipelines data right behind its
                        # HELLO: frames TCP coalesced into this chunk
                        # are already consumed from the decoder and
                        # must reach the pump, not the floor
                        backlog = msgs[i + 1:]
                        break
                    if kind == wire.MSG_CANCEL:
                        conn.close()
                        return
            edge = self.edges.get(hello.get("edge"))
            if edge is None:
                raise WireError(
                    f"HELLO for unknown shuffle edge "
                    f"{hello.get('edge')!r} (partition plans disagree?)")
            st = edge.stream_for(int(hello.get("worker", -1)),
                                 hello.get("pids") or ())
            if hello.get("resume"):
                conn.sendall(wire.encode_credit(0, st.next_seq - 1))
            self._pump(conn, dec, edge, st, backlog)
        except GraphCancelled:
            try:
                conn.sendall(wire.encode_msg(wire.MSG_CANCEL, 0, 0,
                                             b"consumer graph cancelled"))
            except OSError:
                pass
        except (OSError, ValueError, WireError) as e:
            self._broken(edge, st, e)
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _coordinator(self):
        """The consumer graph's EpochCoordinator, waiting out the start
        window: the server accepts early in ``PipeGraph.start`` while
        the durability plane is built near its end, and a barrier
        observed with no coordinator would silently break the
        follower's epoch plane.  Only blocks when the config PROMISES a
        coordinator; bounded and cancel-aware."""
        coord = getattr(self.graph, "durability", None)
        if coord is not None \
                or self.graph.config.durability is None:
            return coord
        deadline = _time.monotonic() + 30.0
        while coord is None:
            if self._stop.is_set() or self._cancelled \
                    or _time.monotonic() > deadline:
                return None
            _time.sleep(0.005)
            coord = getattr(self.graph, "durability", None)
        return coord

    def _pump(self, conn, dec, edge: EdgeState, st: _WireStream,
              backlog=None) -> None:
        while True:
            if backlog:
                msgs, backlog = backlog, None
            else:
                backlog = None
                if self._stop.is_set() or self._cancelled:
                    return
                data = _recv_some(conn)
                if data is None:
                    continue
                if data == b"":
                    # clean EOF: complete iff every pid of this stream
                    # closed; else treat as a drop (reconnect window)
                    with edge.lock:
                        done = st.pids <= edge.closed_pids
                    if not done:
                        raise WireError(
                            f"shuffle edge {edge.edge!r} from worker "
                            f"{st.worker} closed mid-stream after "
                            f"{st.frames} frames")
                    return
                msgs = dec.feed(data)
            grant = 0
            processed = False
            for kind, pid, seq, payload in msgs:
                if kind == wire.MSG_CANCEL:
                    reason = payload.decode("utf-8", "replace")
                    self.graph._cancel.cancel(
                        WireError(f"wire:{edge.edge}: producer worker "
                                  f"cancelled ({reason})"),
                        origin=f"wire:{edge.edge}")
                    raise GraphCancelled("peer cancelled")
                if kind not in wire.DATA_KINDS:
                    continue
                if seq < st.next_seq:
                    continue  # duplicate after a resume
                if seq > st.next_seq:
                    gap = seq - st.next_seq
                    st.gaps += gap
                    self.graph.flight.record(
                        "wire_gap", edge=edge.edge, worker=st.worker,
                        frames=gap, at_seq=seq)
                st.next_seq = seq + 1
                processed = True
                grant += self._deliver(edge, st, kind, pid, payload)
            if processed:
                try:
                    conn.sendall(wire.encode_credit(grant,
                                                    st.next_seq - 1))
                except OSError:
                    return

    def _deliver(self, edge: EdgeState, st: _WireStream, kind: int,
                 pid: int, payload: bytes) -> int:
        """One data-plane frame into the consumer channel; returns the
        credits to grant back."""
        import json
        st.frames += 1
        if kind == wire.MSG_EOS:
            with edge.lock:
                edge.closed_pids.add(pid)
                complete = edge.closed_pids >= edge.all_pids
            edge.channel.close(pid)
            if complete:
                self._edge_complete(edge, self._coordinator())
            return 0
        if kind == wire.MSG_STATS:
            _doc, body = wire._split_trace(payload)
            try:
                st.trailer = json.loads(body.decode("utf-8"))
            except ValueError:
                st.trailer = None
            self._check_trailer(edge, st)
            return 0
        item, cost = wire.decode_item(kind, payload, edge.edge)
        if kind == wire.MSG_BARRIER:
            st.barriers += 1
            coord = self._coordinator()
            if coord is not None and item.epoch >= 1 and not item.final:
                # BEFORE the put: the aligner's cut must find the
                # pending epoch registered
                coord.remote_epoch(item.epoch, f"wire:{edge.edge}",
                                   frontier=st.frames)
        else:
            st.tuples += cost
            if self.runtime is not None:
                self.runtime.count_transport(cost)
        edge.channel.put(pid, item)
        return cost

    def _edge_complete(self, edge: EdgeState, coord) -> None:
        with edge.lock:
            if edge.completed:
                return
            edge.completed = True
        if coord is not None and not edge.finished_reported:
            edge.finished_reported = True
            coord.node_finished(f"wire:{edge.edge}", {})

    def _check_trailer(self, edge: EdgeState, st: _WireStream) -> None:
        """The producer's delivery book against ours: any shortfall is
        a wire loss, flagged with the exact edge and tuple count (the
        cross-process twin of the ledger's lost_delivery rule)."""
        t = st.trailer
        if not t:
            return
        missing_t = int(t.get("tuples", 0) or 0) - st.tuples
        if missing_t <= 0 and st.gaps == 0:
            return
        v = {"kind": "lost_wire_delivery", "edge": edge.edge,
             "from_worker": st.worker, "count": max(missing_t, 0),
             "frames": st.gaps, "at": round(_time.time(), 6)}
        self.graph.flight.record(
            "conservation_violation",
            violation=v["kind"], edge=v["edge"], count=v["count"],
            frames=v["frames"], from_worker=st.worker)
        auditor = getattr(self.graph, "auditor", None)
        if auditor is not None:
            auditor.violations.append(v)

    def _broken(self, edge: Optional[EdgeState],
                st: Optional[_WireStream], err: Exception) -> None:
        """A connection died mid-stream: give the producer a reconnect
        window, then declare the edge lost (graph cancels, the failure
        propagates like a replica death)."""
        if edge is None or st is None:
            return
        if self._stop.is_set() or self._cancelled or edge.completed:
            return
        st.resumed.clear()
        if st.resumed.wait(self.grace_s):
            return  # the producer came back; its new thread took over
        if self._stop.is_set() or self._cancelled or edge.completed:
            return
        self.graph.flight.record("wire_broken", edge=edge.edge,
                                 worker=st.worker, error=str(err))
        self.graph._cancel.cancel(
            WireError(f"shuffle edge {edge.edge!r} from worker "
                      f"{st.worker} lost: {err}"),
            origin=f"wire:{edge.edge}")
