"""The five BASELINE benchmark configurations as library pipelines (the
port of ``windflow_tpu/models/configs.py``; device stages run on the
graph's ``RuntimeConfig.device``).

BASELINE.json "configs" (see BASELINE.md): each function wires the
corresponding workload into a PipeGraph and returns the collector used
as its oracle.  These are the canonical "models" of the framework --
streaming applications exercising each parallelization strategy.

1. config_cpu_multipipe      -- map -> filter -> tumbling CB window sum
                                (mp_tests_cpu style, host engines)
2. config_win_seq_tpu        -- keyed sliding TB incremental sum,
                                device-batched (Win_Seq_GPU analogue)
3. config_pane_farm_tpu      -- pane partial agg + window combine,
                                PLQ on device
4. config_key_farm_tpu       -- key-sharded windows, device-batched
5. config_yahoo              -- Yahoo-style ad-campaign windowed count
                                (models/yahoo.build_pipeline)
"""
from __future__ import annotations

import threading


class ResultCollector:
    def __init__(self):
        self.lock = threading.Lock()
        self.count = 0
        self.total = 0.0

    def __call__(self, item):
        if item is None:
            return
        from ..core.tuples import TupleBatch
        with self.lock:
            if isinstance(item, TupleBatch):
                self.count += len(item)
                self.total += float(item["value"].sum())
            else:
                self.count += 1
                self.total += item.value


def config_cpu_multipipe(graph, n_events=100_000, n_keys=16, win=1000):
    """Config #1: host-engine MultiPipe map->filter->tumbling CB sum."""
    import windflow_tpu_torch as wf
    from ..utils.synthetic import ordered_keyed_stream

    coll = ResultCollector()

    def double(t):
        t.value *= 2.0

    def keep(t):
        return True

    def sum_win(gwid, it, result):
        result.value = sum(t.value for t in it)

    graph.add_source(wf.SourceBuilder(
        ordered_keyed_stream(n_keys, n_events // n_keys)).build()) \
        .chain(wf.MapBuilder(double).build()) \
        .chain(wf.FilterBuilder(keep).build()) \
        .add(wf.KeyFarmBuilder(sum_win).with_parallelism(2)
             .with_cb_windows(win, win).build()) \
        .add_sink(wf.SinkBuilder(coll).build())
    return coll


def config_win_seq_tpu(graph, n_events=1_000_000, n_keys=32,
                       win=4096, slide=2048, batch=4096):
    """Config #2: keyed sliding TB sum on the device engine."""
    from ..operators.basic_ops import Sink
    from ..operators.batch_ops import BatchSource
    from ..operators.tpu.win_seq_tpu import WinSeqTPU
    from ..core.basic import WinType
    from ..utils.synthetic import batch_stream

    coll = ResultCollector()
    op = WinSeqTPU("sum", win, slide, WinType.TB, batch_len=batch,
                   emit_batches=True)
    graph.add_source(BatchSource(batch_stream(n_events, n_keys))) \
        .add(op).add_sink(Sink(coll))
    return coll


def config_pane_farm_tpu(graph, n_events=1_000_000, n_keys=32,
                         win=4096, slide=2048, batch=4096):
    """Config #3: pane partial aggregation (device) + window combine."""
    from ..operators.basic_ops import Sink
    from ..operators.batch_ops import BatchSource
    from ..operators.tpu.farms_tpu import PaneFarmTPU
    from ..core.basic import WinType
    from ..utils.synthetic import batch_stream

    coll = ResultCollector()

    def host_comb(gwid, it, result):
        result.value = sum(t.value for t in it)

    op = PaneFarmTPU("sum", host_comb, win, slide, WinType.TB,
                     plq_parallelism=2, wlq_parallelism=1, plq_on_tpu=True,
                     batch_len=batch)
    graph.add_source(BatchSource(batch_stream(n_events, n_keys))) \
        .add(op).add_sink(Sink(coll))
    return coll


def config_key_farm_tpu(graph, n_events=1_000_000, n_keys=64,
                        win=4096, slide=2048, batch=4096, parallelism=4):
    """Config #4 (single-host form): key-sharded device windows (the
    across-chips form is the mesh plane, ROADMAP.md A11)."""
    from ..operators.basic_ops import Sink
    from ..operators.batch_ops import BatchSource
    from ..operators.tpu.farms_tpu import KeyFarmTPU
    from ..core.basic import WinType
    from ..utils.synthetic import batch_stream

    coll = ResultCollector()
    op = KeyFarmTPU("sum", win, slide, WinType.TB, parallelism=parallelism,
                    batch_len=batch, emit_batches=True)
    graph.add_source(BatchSource(batch_stream(n_events, n_keys))) \
        .add(op).add_sink(Sink(coll))
    return coll


def config_yahoo(graph, n_events=1_000_000, **kw):
    """Config #5: Yahoo Streaming Benchmark (see models/yahoo.py)."""
    from .yahoo import build_pipeline

    coll = ResultCollector()
    build_pipeline(graph, n_events, sink=coll, **kw)
    return coll


ALL_CONFIGS = {
    "cpu_multipipe": config_cpu_multipipe,
    "win_seq_tpu": config_win_seq_tpu,
    "pane_farm_tpu": config_pane_farm_tpu,
    "key_farm_tpu": config_key_farm_tpu,
    "yahoo": config_yahoo,
}
