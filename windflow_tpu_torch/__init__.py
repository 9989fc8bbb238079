"""windflow_tpu_torch: the PyTorch/CUDA port of windflow_tpu.

The same PipeGraph/MultiPipe surface as ``windflow_tpu``, with the
device lane running on an NVIDIA GPU: batched window sums launch a
hand-written Hopper kernel (``ops/cuda/window_sum.cu``), FlatFAT range
queries (the FFAT kinds, the resident FFAT forest and the resident pane
lane) another (``ops/cuda/flatfat_query.cu``), and the engine's other
programs (max/min, custom window functions) are torch code on CUDA
tensors.  The port goes slice by slice (ROADMAP.md queue A); this
umbrella exports the names the ported slices provide, and a name of the
reference package that is not ported yet raises an ``AttributeError``
naming its ROADMAP item.

    import windflow_tpu_torch as wf
    g = wf.PipeGraph("app", wf.Mode.DEFAULT)
    op = (wf.KeyFarmTPUBuilder("sum").with_parallelism(2)
          .with_tb_windows(4096, 2048).build())
    g.add_source(wf.SourceBuilder(gen).build()).add(op).add_sink(
        wf.SinkBuilder(sink_fn).build())
    g.run()     # on the CUDA device; RuntimeConfig(device="cpu") asks
                # for the CPU

A device window function is a builtin name or a torch callable
``fn(gwid, cols, mask) -> 0-d tensor``, vmapped over the windows.
"""
from ._unported import ROADMAP_ITEMS
from .core import (Mode, WinType, OptLevel, RoutingMode, Pattern, WinEvent,
                   OrderingMode, Role, WinOperatorConfig, RuntimeConfig,
                   DurabilityConfig, ElasticSpec, BasicRecord, TupleBatch,
                   EOS, TriggererCB,
                   TriggererTB, Window, StreamArchive, FlatFAT, Iterable,
                   Shipper, RuntimeContext, LocalStorage, Expr, F)

__version__ = "0.1.0"

# ported names, imported lazily (no torch/CUDA work at package import)
_LAZY = {
    "PipeGraph": "windflow_tpu_torch.graph.pipegraph",
    "NodeFailureError": "windflow_tpu_torch.graph.pipegraph",
    "MultiPipe": "windflow_tpu_torch.graph.multipipe",
    # failure containment (resilience/; docs/RESILIENCE.md)
    "StallError": "windflow_tpu_torch.resilience",
    "GraphCancelled": "windflow_tpu_torch.resilience",
    "FaultPlan": "windflow_tpu_torch.resilience",
    "InjectedFailure": "windflow_tpu_torch.resilience",
    "DeadLetterStore": "windflow_tpu_torch.resilience",
    "DeadLetterEntry": "windflow_tpu_torch.resilience",
    # adaptive ingestion plane (ingest/; docs/INGEST.md)
    "SocketSource": "windflow_tpu_torch.ingest",
    "ReplaySource": "windflow_tpu_torch.ingest",
    "AsyncGeneratorSource": "windflow_tpu_torch.ingest",
    "CreditGate": "windflow_tpu_torch.ingest",
    "MicrobatchController": "windflow_tpu_torch.ingest",
    "AdmissionConfig": "windflow_tpu_torch.ingest",
    "ShedTuples": "windflow_tpu_torch.ingest",
    "encode_batch": "windflow_tpu_torch.ingest",
    "decode_batch": "windflow_tpu_torch.ingest",
    "StreamDecoder": "windflow_tpu_torch.ingest",
    # audit plane (audit/; docs/OBSERVABILITY.md "Audit plane")
    "GraphAuditor": "windflow_tpu_torch.audit",
    "SpaceSavingSketch": "windflow_tpu_torch.audit",
    "watermark_of": "windflow_tpu_torch.audit.progress",
    # diagnosis plane (diagnosis/; docs/OBSERVABILITY.md)
    "DiagnosisPlane": "windflow_tpu_torch.diagnosis",
    "build_report": "windflow_tpu_torch.diagnosis",
    "render_text": "windflow_tpu_torch.diagnosis",
    # the merged cluster view (distributed/observe.py; docs/DISTRIBUTED.md
    # "One graph view")
    "merge_stats": "windflow_tpu_torch.distributed.observe",
    "wire_table": "windflow_tpu_torch.distributed.observe",
    "check_wire_conservation": "windflow_tpu_torch.distributed.observe",
    # distributed runtime plane (distributed/; docs/DISTRIBUTED.md)
    "DistributedSpec": "windflow_tpu_torch.distributed",
    "run_distributed": "windflow_tpu_torch.distributed",
    "WorkerFailure": "windflow_tpu_torch.distributed",
    "plan_partition": "windflow_tpu_torch.distributed",
    "MsgDecoder": "windflow_tpu_torch.distributed",
    # durability plane (durability/; docs/RESILIENCE.md
    # "Exactly-once epochs")
    "EpochCoordinator": "windflow_tpu_torch.durability",
    "EpochStore": "windflow_tpu_torch.durability",
    "EpochBarrier": "windflow_tpu_torch.durability",
    "EpochTaggedStore": "windflow_tpu_torch.durability",
    "run_with_epochs": "windflow_tpu_torch.durability",
    "restore_epoch": "windflow_tpu_torch.durability",
    # elastic scaling plane (elastic/; docs/ELASTIC.md)
    "ElasticityConfig": "windflow_tpu_torch.elastic",
    "ElasticController": "windflow_tpu_torch.elastic",
    "RescaleEvent": "windflow_tpu_torch.elastic",
    "RescaleError": "windflow_tpu_torch.elastic",
    "LoadReport": "windflow_tpu_torch.elastic",
    # event-time relational plane (eventtime/; docs/EVENTTIME.md)
    "Watermark": "windflow_tpu_torch.runtime.queues",
    "watermarked": "windflow_tpu_torch.eventtime",
    "WatermarkedSource": "windflow_tpu_torch.eventtime",
    "EventTimeWindow": "windflow_tpu_torch.eventtime",
    "SessionWindow": "windflow_tpu_torch.eventtime",
    "IntervalJoin": "windflow_tpu_torch.eventtime",
    "WindowJoin": "windflow_tpu_torch.eventtime",
    "Sided": "windflow_tpu_torch.eventtime",
    "side_tagger": "windflow_tpu_torch.eventtime",
    "tag_side": "windflow_tpu_torch.eventtime",
    "LEFT": "windflow_tpu_torch.eventtime",
    "RIGHT": "windflow_tpu_torch.eventtime",
    "StreamQuery": "windflow_tpu_torch.eventtime",
    "query": "windflow_tpu_torch.eventtime",
    # resident FFAT lane (operators/tpu/ffat_resident.py)
    "WinSeqFFATResident": "windflow_tpu_torch.operators.tpu.ffat_resident",
}
# the fluent builders (builders/): host operators, then device operators
_LAZY.update({name: "windflow_tpu_torch.builders.builders" for name in (
    "SourceBuilder", "FilterBuilder", "MapBuilder", "FlatMapBuilder",
    "AccumulatorBuilder", "SinkBuilder", "WinSeqBuilder",
    "WinFarmBuilder", "KeyFarmBuilder", "PaneFarmBuilder",
    "WinMapReduceBuilder", "WinSeqFFATBuilder", "KeyFFATBuilder")})
_LAZY.update({name: "windflow_tpu_torch.builders.builders_tpu" for name in (
    "WinSeqTPUBuilder", "WinFarmTPUBuilder", "KeyFarmTPUBuilder",
    "PaneFarmTPUBuilder", "WinMapReduceTPUBuilder",
    "WinSeqFFATTPUBuilder", "KeyFFATTPUBuilder")})

# names of the reference umbrella that later slices port, by ROADMAP item
_NOT_YET = {
    "serving": (
        "Server", "TenantSpec", "TenantHandle", "TenantState",
        "AdmissionError", "ArbiterConfig", "CrossTenantArbiter"),
    "mesh": ("KeyFarmMesh", "PaneFarmMesh", "WinMapReduceMesh",
             "make_mesh", "make_multihost_mesh"),
}


def __getattr__(name):
    from importlib import import_module
    if name in _LAZY:
        return getattr(import_module(_LAZY[name]), name)
    for item, names in _NOT_YET.items():
        if name in names:
            raise AttributeError(
                f"windflow_tpu_torch.{name} is not ported yet: "
                f"{ROADMAP_ITEMS[item]}")
    raise AttributeError(f"module 'windflow_tpu_torch' has no attribute "
                         f"{name!r}")
