"""ctypes bindings to the native C++ host runtime (native/windflow_native.cpp).

Builds the shared library on first use with g++ (no pip/pybind11
dependency) from the repository's ``native/*.cpp`` sources, which it
only reads: the library goes to the port's own build directory
(``windflow_tpu_torch/_build/``, see ``runtime/build.py`` for the
atomic, lock-guarded build).  Degrades gracefully to the pure-Python
plane when a toolchain is unavailable (RuntimeConfig.use_native_runtime
gates usage).

Object hand-off across the native channel: the producer increfs the
Python object and passes its address; the consumer rebuilds the object
reference and decrefs.  Blocking waits happen in C++ with the GIL
released (ctypes drops it around foreign calls).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Any, Optional

from .build import OUT, build_shared
from .queues import CHANNEL_TIMEOUT

_lib = None
_lib_lock = threading.Lock()
_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_SRCS = [os.path.join(_NATIVE_DIR, f)
         for f in ("windflow_native.cpp", "window_engine.cpp",
                   "record_pipeline.cpp")]
_SO_NAME = "libwindflow_native.so"


# -ffp-contract=off: the declared Python/numpy plane rounds mul and
# add separately; FMA contraction in the lowered planes would differ
# by 1 ULP at exact filter thresholds (lowering must never change
# results)
_CMD = ["g++", "-O3", "-march=native", "-ffp-contract=off",
        "-std=c++17", "-shared", "-fPIC", "-pthread", *_SRCS,
        "-o", OUT]


def _build() -> Optional[str]:
    # fault-injection hook (resilience/faults.py): tests force the
    # toolchain probe to fail to exercise the pure-Python fallback
    from ..resilience.faults import native_build_forced_to_fail
    if native_build_forced_to_fail():
        return None
    if os.environ.get("WINDFLOW_NATIVE", "1") == "0":
        return None  # CI pure-Python job: skip the toolchain entirely
    try:
        return build_shared(_SO_NAME, _CMD, _SRCS, timeout=180)
    except (OSError, subprocess.SubprocessError):
        return None


def get_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib if _lib is not False else None
        so = _build()
        if so is None:
            _lib = False
            return None
        lib = ctypes.CDLL(so)
        lib.wfn_channel_new.restype = ctypes.c_void_p
        lib.wfn_channel_new.argtypes = [ctypes.c_size_t]
        lib.wfn_channel_free.argtypes = [ctypes.c_void_p]
        lib.wfn_channel_register_producer.restype = ctypes.c_int
        lib.wfn_channel_register_producer.argtypes = [ctypes.c_void_p]
        lib.wfn_channel_put.restype = ctypes.c_int
        lib.wfn_channel_put.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_size_t]
        lib.wfn_channel_close.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.wfn_channel_poison.argtypes = [ctypes.c_void_p]
        lib.wfn_channel_drain.restype = ctypes.c_int
        lib.wfn_channel_drain.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)]
        lib.wfn_channel_get_timed.restype = ctypes.c_int
        lib.wfn_channel_get_timed.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t),
            ctypes.POINTER(ctypes.c_int), ctypes.c_longlong]
        lib.wfn_channel_get.restype = ctypes.c_int
        lib.wfn_channel_get.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t),
            ctypes.POINTER(ctypes.c_int)]
        lib.wfn_channel_size.restype = ctypes.c_size_t
        lib.wfn_channel_size.argtypes = [ctypes.c_void_p]
        lib.wfn_pane_sum.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_longlong),
            ctypes.c_longlong, ctypes.POINTER(ctypes.c_double)]
        for name in ("wfn_pane_max", "wfn_pane_min"):
            fn = getattr(lib, name)
            fn.argtypes = [
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_longlong), ctypes.c_longlong,
                ctypes.c_double, ctypes.POINTER(ctypes.c_double)]
        lib.wfn_partition_mod.argtypes = [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_longlong,
            ctypes.c_longlong, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_longlong)]
        _PLL = ctypes.POINTER(ctypes.c_longlong)
        lib.wfn_pane_prereduce.restype = ctypes.c_longlong
        lib.wfn_pane_prereduce.argtypes = [
            _PLL, _PLL, ctypes.POINTER(ctypes.c_double),
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            _PLL, _PLL, ctypes.POINTER(ctypes.c_double)]
        lib.wfn_pane_prereduce_f32.restype = ctypes.c_longlong
        lib.wfn_pane_prereduce_f32.argtypes = [
            _PLL, _PLL, ctypes.POINTER(ctypes.c_float),
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            _PLL, _PLL, ctypes.POINTER(ctypes.c_double)]
        LL = ctypes.c_longlong
        PLL = ctypes.POINTER(LL)
        PD = ctypes.POINTER(ctypes.c_double)
        lib.wfn_engine_new.restype = ctypes.c_void_p
        lib.wfn_engine_new.argtypes = [LL, LL, ctypes.c_int, LL,
                                       ctypes.c_int, ctypes.c_int]
        lib.wfn_engine_free.argtypes = [ctypes.c_void_p]
        lib.wfn_engine_ingest.restype = LL
        lib.wfn_engine_ingest.argtypes = [ctypes.c_void_p, PLL, PLL, PLL,
                                          PD, LL]
        lib.wfn_engine_ingest_f32.restype = LL
        lib.wfn_engine_ingest_f32.argtypes = [
            ctypes.c_void_p, PLL, PLL, PLL,
            ctypes.POINTER(ctypes.c_float), LL]
        lib.wfn_engine_synth_ingest.restype = LL
        lib.wfn_engine_synth_ingest.argtypes = [
            ctypes.c_void_p, LL, LL, LL, LL,
            ctypes.c_double, ctypes.c_double]
        lib.wfn_engine_synth_ingest_masked.restype = LL
        lib.wfn_engine_synth_ingest_masked.argtypes = [
            ctypes.c_void_p, LL, LL, LL, LL,
            ctypes.c_double, ctypes.c_double,
            ctypes.POINTER(ctypes.c_ubyte), PD]
        lib.wfn_engine_ready.restype = LL
        lib.wfn_engine_ready.argtypes = [ctypes.c_void_p]
        lib.wfn_engine_ignored.restype = LL
        lib.wfn_engine_ignored.argtypes = [ctypes.c_void_p]
        lib.wfn_engine_eos.argtypes = [ctypes.c_void_p]
        lib.wfn_engine_watermark.restype = LL
        lib.wfn_engine_watermark.argtypes = [ctypes.c_void_p, LL]
        lib.wfn_engine_counters.argtypes = [ctypes.c_void_p, PLL]
        lib.wfn_engine_flush.restype = LL
        lib.wfn_engine_flush.argtypes = [
            ctypes.c_void_p, LL, ctypes.POINTER(PD), PLL,
            ctypes.POINTER(PD), PLL,
            ctypes.POINTER(PLL), ctypes.POINTER(PLL), ctypes.POINTER(PLL),
            ctypes.POINTER(PLL), ctypes.POINTER(PLL)]
        lib.wfn_engine_serialize.restype = LL
        lib.wfn_engine_serialize.argtypes = [ctypes.c_void_p,
                                             ctypes.c_char_p, LL]
        lib.wfn_engine_deserialize.restype = ctypes.c_int
        lib.wfn_engine_deserialize.argtypes = [ctypes.c_void_p,
                                               ctypes.c_char_p, LL]
        lib.wfn_rp_new.restype = ctypes.c_void_p
        lib.wfn_rp_new.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.wfn_rp_free.argtypes = [ctypes.c_void_p]
        lib.wfn_rp_add_stage.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            LL, LL, LL, LL, ctypes.c_double, ctypes.c_double]
        lib.wfn_rp_set_synth.argtypes = [ctypes.c_void_p, LL, LL, LL,
                                         ctypes.c_double, ctypes.c_double]
        lib.wfn_rp_set_feed.argtypes = [ctypes.c_void_p]
        lib.wfn_rp_start.argtypes = [ctypes.c_void_p]
        lib.wfn_rp_feed.argtypes = [ctypes.c_void_p, PLL, PLL, PLL, PD, LL]
        lib.wfn_rp_feed_eos.argtypes = [ctypes.c_void_p]
        lib.wfn_rp_poll.restype = LL
        lib.wfn_rp_poll.argtypes = [ctypes.c_void_p, LL, PLL, PLL, PLL, PD,
                                    ctypes.POINTER(ctypes.c_int)]
        lib.wfn_rp_wait.argtypes = [ctypes.c_void_p, PLL, PD, PLL]
        _lib = lib
        return lib


def native_available() -> bool:
    return get_lib() is not None


class NativeChannel:
    """Drop-in for runtime.queues.Channel backed by the C++ channel."""

    __slots__ = ("lib", "ptr", "n_producers", "capacity", "poisoned",
                 "puts", "gets", "high_watermark", "_all_closed")

    def __init__(self, capacity: int = 2048):
        self.lib = get_lib()
        if self.lib is None:
            raise RuntimeError("native runtime unavailable")
        self.ptr = self.lib.wfn_channel_new(capacity)
        self.n_producers = 0
        self.capacity = capacity
        self.poisoned = False
        # raw queue counters (TRACE_FASTFLOW analogue), consumed by
        # the audit plane's conservation ledger (audit/ledger.py) and
        # the Queue_high_watermark gauge.  Unlike the pure-Python
        # channel they are incremented OUTSIDE the C++ ring's lock
        # (one GIL-held += per successful call): exact under the
        # single-consumer contract and at quiescent points (the
        # wait_end closure check), gauge-grade between concurrent
        # producers mid-stream -- which is why the online dup rule in
        # the ledger only fires on an inflight-clean snapshot.
        self.puts = 0
        self.gets = 0
        self.high_watermark = 0
        self._all_closed = False  # sticky once every producer closed

    def register_producer(self) -> int:
        self.n_producers += 1
        return self.lib.wfn_channel_register_producer(self.ptr)

    def put(self, producer_id: int, item: Any) -> None:
        ctypes.pythonapi.Py_IncRef(ctypes.py_object(item))
        rc = self.lib.wfn_channel_put(self.ptr, producer_id, id(item))
        if rc < 0:  # poisoned: the channel did not take ownership
            ctypes.pythonapi.Py_DecRef(ctypes.py_object(item))
            from ..resilience.cancel import GraphCancelled
            raise GraphCancelled(f"native channel poisoned (producer "
                                 f"{producer_id})")
        self.puts += 1
        d = self.lib.wfn_channel_size(self.ptr)
        if d > self.high_watermark:
            self.high_watermark = d

    def put_many(self, producer_id: int, items) -> None:
        """Bulk put.  The C++ ring blocks with the GIL released per
        item already; the win here is one Python-level call per batch
        from the outlet plane (and API parity with the pure-Python
        channel)."""
        for item in items:
            self.put(producer_id, item)

    def close(self, producer_id: int) -> None:
        self.lib.wfn_channel_close(self.ptr, producer_id)

    def get_many(self, max_n: int = 128, timeout: Optional[float] = None):
        """Bulk get: one blocking get, then opportunistic non-blocking
        pops while the ring is non-empty.  Same return contract as
        ``Channel.get_many`` (list / sticky None / CHANNEL_TIMEOUT)."""
        if self._all_closed:
            return None
        got = self.get(timeout)
        if got is CHANNEL_TIMEOUT:
            return CHANNEL_TIMEOUT
        if got is None:
            self._all_closed = True
            return None
        out = [got]
        while len(out) < max_n and self.qsize() > 0:
            nxt = self.get(timeout=0.001)
            if nxt is CHANNEL_TIMEOUT:
                break  # the visible entry was an unresolved EOS token
            if nxt is None:
                self._all_closed = True
                break
            out.append(nxt)
        return out

    def get(self, timeout: Optional[float] = None):
        handle = ctypes.c_size_t()
        cid = ctypes.c_int()
        if timeout is None:
            rc = self.lib.wfn_channel_get(self.ptr, ctypes.byref(handle),
                                          ctypes.byref(cid))
        else:
            rc = self.lib.wfn_channel_get_timed(
                self.ptr, ctypes.byref(handle), ctypes.byref(cid),
                max(1, int(timeout * 1000)))
        if rc < 0:
            from ..resilience.cancel import GraphCancelled
            raise GraphCancelled("native channel poisoned")
        if rc == 2:
            return CHANNEL_TIMEOUT
        if not rc:
            return None
        obj = ctypes.cast(handle.value, ctypes.py_object).value
        ctypes.pythonapi.Py_DecRef(ctypes.py_object(obj))
        self.gets += 1
        return cid.value, obj

    def poison(self) -> None:
        """Graph-cancellation sentinel: wake and fail all blocked ends."""
        self.poisoned = True
        self.lib.wfn_channel_poison(self.ptr)

    def qsize(self) -> int:
        return self.lib.wfn_channel_size(self.ptr)

    @property
    def depth(self) -> int:
        """Depth gauge (monitoring/elastic samplers): the C++ size read
        is already lock-cheap, so this just mirrors the pure-Python
        channel's surface."""
        return self.lib.wfn_channel_size(self.ptr)

    def __del__(self):
        try:
            lib, ptr = getattr(self, "lib", None), getattr(self, "ptr", None)
            if lib is not None and ptr:
                # drain remaining handles to avoid leaking references
                # (drain works on poisoned channels too, unlike get)
                handle = ctypes.c_size_t()
                while lib.wfn_channel_drain(ptr, ctypes.byref(handle)):
                    obj = ctypes.cast(handle.value, ctypes.py_object).value
                    ctypes.pythonapi.Py_DecRef(ctypes.py_object(obj))
                lib.wfn_channel_free(ptr)
        except (TypeError, AttributeError):
            pass  # interpreter shutdown: ctypes globals already torn down


def pane_prereduce(keys, tss, values, pane: int):
    """Fused ingest-plane pane pre-reduction (ingest/coalesce.py):
    collapse a columnar chunk to per-(key, pane) sum partials in one
    native pass.  Returns (keys, pane_starts, sums) arrays or None when
    the library is unavailable / the domain is too sparse for the
    dense-grid kernel (callers fall back to numpy or pass-through)."""
    import numpy as np
    lib = get_lib()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, np.int64)
    tss = np.ascontiguousarray(tss, np.int64)
    if values.dtype == np.float32:
        values = np.ascontiguousarray(values)
        fn = lib.wfn_pane_prereduce_f32
        vp = values.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    else:
        values = np.ascontiguousarray(values, np.float64)
        fn = lib.wfn_pane_prereduce
        vp = values.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    n = len(keys)
    cap = min(n, 1 << 16)
    while True:
        out_k = np.empty(cap, np.int64)
        out_p = np.empty(cap, np.int64)
        out_s = np.empty(cap, np.float64)
        m = fn(keys.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
               tss.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
               vp, n, pane, cap,
               out_k.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
               out_p.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
               out_s.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        if m == -1:
            return None  # sparse domain: dense grid refused
        if m == -2:
            cap = n      # partials cannot outnumber tuples
            continue
        return out_k[:m], out_p[:m], out_s[:m]


def pane_reduce(values, pos, kind: str):
    """Native pane partial reduction; returns None if lib unavailable."""
    import numpy as np
    lib = get_lib()
    if lib is None:
        return None
    values = np.ascontiguousarray(values, np.float64)
    pos = np.ascontiguousarray(pos, np.int64)
    n = len(pos) - 1
    out = np.empty(n, np.float64)
    vp = values.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    pp = pos.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong))
    op = out.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    if kind == "sum":
        lib.wfn_pane_sum(vp, pp, n, op)
    elif kind == "max":
        lib.wfn_pane_max(vp, pp, n, float("-inf"), op)
    elif kind == "min":
        lib.wfn_pane_min(vp, pp, n, float("inf"), op)
    else:
        return None
    return out


class NativeRecordPipeline:
    """ctypes wrapper over the native record-at-a-time pipeline engine
    (native/record_pipeline.cpp).

    ``mode="threaded"`` is the reference-architecture baseline (one
    thread per operator stage over SPSC rings -- the FastFlow design,
    SURVEY.md L0); ``mode="fused"`` is the chain-fused fast host path
    (multipipe.hpp:345-390 applied end-to-end) with ``shards``
    key-sharded workers.

    Stages are added in pipeline order with the expression-descriptor
    helpers; the source is either native-synthetic (``set_synth``) or
    Python-fed columnar batches (``set_feed`` + ``feed``/``feed_eos``).
    """

    __slots__ = ("lib", "ptr", "_started", "_waited", "_store")

    FIELDS = {"key": 0, "id": 1, "ts": 2, "value": 3}
    WKINDS = {"sum": 0, "count": 1, "max": 2, "min": 3, "mean": 4}
    _FILTER_OPS = {"mod_eq": 0, "lt": 1, "gt": 2, "le": 3, "ge": 4, "eq": 5}

    def __init__(self, mode: str = "fused", shards: int = 1,
                 store_results: bool = False):
        self.lib = get_lib()
        if self.lib is None:
            raise RuntimeError("native runtime unavailable")
        self.ptr = self.lib.wfn_rp_new(
            {"threaded": 0, "fused": 1}[mode], shards,
            1 if store_results else 0)
        self._started = False
        self._waited = False
        self._store = store_results

    # -- stage construction -------------------------------------------
    def add_filter(self, field: str, op: str, *, m: int = 0, r: int = 0,
                   const: float = 0.0) -> "NativeRecordPipeline":
        """op in mod_eq (keep when field % m == r) | lt|gt|le|ge|eq
        (compare field against const)."""
        self.lib.wfn_rp_add_stage(self.ptr, 1, self.FIELDS[field],
                                  self._FILTER_OPS[op], m, r, 0, 0,
                                  const, 0.0)
        return self

    def add_map_affine(self, scale: float, offset: float = 0.0,
                       square: bool = False) -> "NativeRecordPipeline":
        """value = value*scale + offset (or value^2*scale + offset)."""
        self.lib.wfn_rp_add_stage(self.ptr, 2, 3, 2 if square else 0,
                                  0, 0, 0, 0, scale, offset)
        return self

    def add_map_load(self, field: str, scale: float = 1.0,
                     offset: float = 0.0) -> "NativeRecordPipeline":
        """value = field*scale + offset."""
        self.lib.wfn_rp_add_stage(self.ptr, 2, self.FIELDS[field], 1,
                                  0, 0, 0, 0, scale, offset)
        return self

    def add_accumulator(self) -> "NativeRecordPipeline":
        """Keyed rolling sum (the reference Accumulator)."""
        self.lib.wfn_rp_add_stage(self.ptr, 3, 3, 0, 0, 0, 0, 0, 0.0, 0.0)
        return self

    def add_window(self, win_len: int, slide_len: int, is_tb: bool,
                   kind: str = "sum",
                   renumber: bool = False) -> "NativeRecordPipeline":
        self.lib.wfn_rp_add_stage(self.ptr, 4, 3, 1 if renumber else 0,
                                  win_len, slide_len,
                                  1 if is_tb else 0, self.WKINDS[kind],
                                  0.0, 0.0)
        return self

    # -- source -------------------------------------------------------
    def set_synth(self, n_events: int, n_keys: int, vmod: int = 97,
                  vscale: float = 1.0, voff: float = 0.0) -> None:
        """Native synthetic source: key=i%K, id=ts=i//K,
        value=(i%vmod)*vscale+voff (the bench/test fixture shape)."""
        self.lib.wfn_rp_set_synth(self.ptr, n_events, n_keys, vmod,
                                  vscale, voff)

    def set_feed(self) -> None:
        self.lib.wfn_rp_set_feed(self.ptr)

    def feed(self, keys, ids, ts, vals) -> None:
        import numpy as np
        LL = ctypes.c_longlong
        keys = np.ascontiguousarray(keys, np.int64)
        ids = np.ascontiguousarray(ids, np.int64)
        ts = np.ascontiguousarray(ts, np.int64)
        vals = np.ascontiguousarray(vals, np.float64)
        self.lib.wfn_rp_feed(
            self.ptr, keys.ctypes.data_as(ctypes.POINTER(LL)),
            ids.ctypes.data_as(ctypes.POINTER(LL)),
            ts.ctypes.data_as(ctypes.POINTER(LL)),
            vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            len(keys))

    def feed_eos(self) -> None:
        self.lib.wfn_rp_feed_eos(self.ptr)

    # -- execution ----------------------------------------------------
    def start(self) -> None:
        self._started = True
        self.lib.wfn_rp_start(self.ptr)

    def poll(self, max_n: int = 65536):
        """Blocking poll of stored results; returns (keys, wids, ts,
        vals, done). Requires store_results=True."""
        import numpy as np
        LL = ctypes.c_longlong
        keys = np.empty(max_n, np.int64)
        wids = np.empty(max_n, np.int64)
        ts = np.empty(max_n, np.int64)
        vals = np.empty(max_n, np.float64)
        done = ctypes.c_int()
        n = self.lib.wfn_rp_poll(
            self.ptr, max_n, keys.ctypes.data_as(ctypes.POINTER(LL)),
            wids.ctypes.data_as(ctypes.POINTER(LL)),
            ts.ctypes.data_as(ctypes.POINTER(LL)),
            vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            ctypes.byref(done))
        return (keys[:n], wids[:n], ts[:n], vals[:n], bool(done.value))

    def wait(self):
        """Join all pipeline threads; returns (n_results, result_sum,
        dropped)."""
        LL = ctypes.c_longlong
        count, dropped = LL(), LL()
        total = ctypes.c_double()
        self.lib.wfn_rp_wait(self.ptr, ctypes.byref(count),
                             ctypes.byref(total), ctypes.byref(dropped))
        self._waited = True
        return count.value, total.value, dropped.value

    def __del__(self):
        lib, ptr = getattr(self, "lib", None), getattr(self, "ptr", None)
        if lib is not None and ptr:
            if self._started and not self._waited:
                # joining requires the feed to be closed; best effort
                try:
                    self.feed_eos()
                except Exception:
                    pass
            lib.wfn_rp_free(ptr)


class NativeWindowEngine:
    """ctypes wrapper over the C++ columnar window engine
    (native/window_engine.cpp)."""

    __slots__ = ("lib", "ptr")

    KINDS = {"sum": 0, "count": 1, "max": 2, "min": 3, "mean": 4}

    def __init__(self, win_len: int, slide_len: int, is_tb: bool,
                 delay: int = 0, renumber: bool = False, kind: str = "sum"):
        self.lib = get_lib()
        if self.lib is None:
            raise RuntimeError("native runtime unavailable")
        self.ptr = self.lib.wfn_engine_new(win_len, slide_len,
                                           1 if is_tb else 0, delay,
                                           1 if renumber else 0,
                                           self.KINDS[kind])

    def ingest(self, keys, ids, ts, vals) -> int:
        import numpy as np
        keys = np.ascontiguousarray(keys, np.int64)
        ids = np.ascontiguousarray(ids, np.int64)
        ts = np.ascontiguousarray(ts, np.int64)
        LL = ctypes.c_longlong
        vals = np.asarray(vals)
        if vals.dtype == np.float32 and vals.flags.c_contiguous:
            # f32 lane: no widening copy; the engine widens per element
            return self.lib.wfn_engine_ingest_f32(
                self.ptr,
                keys.ctypes.data_as(ctypes.POINTER(LL)),
                ids.ctypes.data_as(ctypes.POINTER(LL)),
                ts.ctypes.data_as(ctypes.POINTER(LL)),
                vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                len(keys))
        vals = np.ascontiguousarray(vals, np.float64)
        return self.lib.wfn_engine_ingest(
            self.ptr,
            keys.ctypes.data_as(ctypes.POINTER(LL)),
            ids.ctypes.data_as(ctypes.POINTER(LL)),
            ts.ctypes.data_as(ctypes.POINTER(LL)),
            vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            len(keys))

    def synth_ingest(self, start: int, n: int, n_keys: int,
                     vmod: int = 97, vscale: float = 1.0,
                     voff: float = 0.0, mask=None, vtab=None) -> int:
        """Fused generate+fold of the declared synthetic law
        (operators/synth.py): events [start, start+n) never materialize
        as host arrays.  ``mask`` (uint8[vmod], optional) drops events
        whose mask[e % vmod] entry is 0 -- the folded form of a
        declared value-predicate Filter; a dropped event neither folds
        nor advances triggering.  ``vtab`` (float64[vmod], optional)
        overrides the affine law with a per-residue value table (the
        sequentially-applied declared map chain).  Returns the
        ready-window count."""
        if mask is None and vtab is None:
            return self.lib.wfn_engine_synth_ingest(
                self.ptr, start, n, n_keys, vmod, vscale, voff)
        import numpy as np
        PD = ctypes.POINTER(ctypes.c_double)
        mp = None
        if mask is not None:
            mask = np.ascontiguousarray(mask, np.uint8)
            assert len(mask) == vmod
            mp = mask.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))
        vp = None
        if vtab is not None:
            vtab = np.ascontiguousarray(vtab, np.float64)
            assert len(vtab) == vmod
            vp = vtab.ctypes.data_as(PD)
        return self.lib.wfn_engine_synth_ingest_masked(
            self.ptr, start, n, n_keys, vmod, vscale, voff, mp, vp)

    def ready(self) -> int:
        return self.lib.wfn_engine_ready(self.ptr)

    def ignored(self) -> int:
        """Tuples dropped behind the fired frontier (the acceptance
        rule of win_seq.hpp:417-428)."""
        return self.lib.wfn_engine_ignored(self.ptr)

    def eos(self) -> None:
        self.lib.wfn_engine_eos(self.ptr)

    # event-time units a watermark may name: beyond them it is +-inf
    _WM_CLAMP = 1 << 62

    def watermark(self, ts: float) -> int:
        """Fire every window whose end is at or below the watermark
        ``ts`` (event-time units; +inf fires everything), in order of
        (window, key).  The first call switches the engine to firing by
        event time: a key's own later tuples fire nothing from then on,
        and a key whose windows have all fired and been staged is
        freed.  Returns the ready-window count."""
        import math
        c = self._WM_CLAMP
        wm = c if ts >= c else -c if ts <= -c else math.floor(ts)
        return self.lib.wfn_engine_watermark(self.ptr, wm)

    def counters(self) -> dict:
        """The event-time counters: watermarks seen, windows they
        fired, keys evicted, and keys live now."""
        out = (ctypes.c_longlong * 4)()
        self.lib.wfn_engine_counters(self.ptr, out)
        return {"watermarks": out[0], "windows_fired_watermark": out[1],
                "keys_evicted": out[2], "keys_live": out[3]}

    def flush(self, max_windows: int):
        """Returns (vals[f64], starts, ends, keys, gwids, rts[, cnts])
        numpy copies, or None when nothing is ready.  ``cnts`` (per-pane
        tuple counts, same layout as vals) is appended only for the
        'mean' kind."""
        import numpy as np
        LL = ctypes.c_longlong
        PD = ctypes.POINTER(ctypes.c_double)
        PLL = ctypes.POINTER(LL)
        vals_p, n_vals = PD(), LL()
        cnts_p, n_cnts = PD(), LL()
        sp, ep, kp, gp, rp = PLL(), PLL(), PLL(), PLL(), PLL()
        b = self.lib.wfn_engine_flush(
            self.ptr, max_windows, ctypes.byref(vals_p),
            ctypes.byref(n_vals), ctypes.byref(cnts_p),
            ctypes.byref(n_cnts), ctypes.byref(sp), ctypes.byref(ep),
            ctypes.byref(kp), ctypes.byref(gp), ctypes.byref(rp))
        if b == 0:
            return None
        nv = n_vals.value

        def arr(p, n, dt):
            return np.ctypeslib.as_array(p, shape=(n,)).astype(dt, copy=True)

        out = (arr(vals_p, nv, np.float64), arr(sp, b, np.int64),
               arr(ep, b, np.int64), arr(kp, b, np.int64),
               arr(gp, b, np.int64), arr(rp, b, np.int64))
        if n_cnts.value:
            out = out + (arr(cnts_p, n_cnts.value, np.float64),)
        return out

    def serialize(self) -> bytes:
        """Versioned binary snapshot of all mutable engine state."""
        n = self.lib.wfn_engine_serialize(self.ptr, None, 0)
        buf = ctypes.create_string_buffer(n)
        got = self.lib.wfn_engine_serialize(self.ptr, buf, n)
        if got != n:
            raise RuntimeError("engine snapshot size changed mid-call")
        return buf.raw[:n]

    def deserialize(self, blob: bytes) -> None:
        """Restore a snapshot into an identically-configured engine."""
        ok = self.lib.wfn_engine_deserialize(self.ptr, blob, len(blob))
        if not ok:
            raise ValueError("malformed or mismatched engine snapshot")

    def __del__(self):
        lib, ptr = getattr(self, "lib", None), getattr(self, "ptr", None)
        if lib is not None and ptr:
            lib.wfn_engine_free(ptr)
