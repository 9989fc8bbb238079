"""Adaptive ingestion plane: the boundary between the outside world and
the graph's source nodes (docs/INGEST.md).

The reference treats sources as first-class operators whose only flow
control is blocking on a full bounded queue (source.hpp:175-252 over
FastFlow's FF_BOUNDED_BUFFER).  windflow_tpu_torch's ingest plane makes
admission an explicit, measurable subsystem:

* **sources** (`sources.py`): a non-blocking TCP :class:`SocketSource`
  speaking the framed `codec` protocol, an :class:`AsyncGeneratorSource`
  driving an ``async`` generator, and a timestamp-faithful
  :class:`ReplaySource` with rate control (``speedup``), deterministic
  under a seed so it composes with the resilience ``FaultPlan`` harness;
* **credit-based backpressure** (`credits.py`): each source replica
  holds a :class:`CreditGate` budget replenished as the downstream
  channel drains -- replacing silent blocking with measurable flow
  control (the Flink credit-based flow-control analogue);
* an **adaptive microbatch controller** (`controller.py`): AIMD on
  coalesced batch size / flush interval against
  ``RuntimeConfig.latency_target_ms``, replacing the static
  ``microbatch`` / launch-delay knobs for ingest-fed runs;
* **admission control** (`admission.py`): overload policies
  (``drop_newest`` / ``drop_oldest`` / ``sample``) that quarantine shed
  tuples into the graph ``DeadLetterStore`` instead of buffering
  without bound.

Wiring happens at ``PipeGraph.start`` (`wiring.py`): outlet channels
are wrapped so consumer ``get``s return credits, gates and stages are
registered with the graph CancelToken (cancellation unblocks a source
mid-recv), and the controller binds to downstream device window
engines.
"""
from .admission import (ADMISSION_POLICIES, AdmissionConfig, ShedTuples)
# codec promoted to the shared wire module (distributed/wire.py); the
# names stay re-exported here for the historical surface
from ..distributed.wire import StreamDecoder, decode_batch, encode_batch
from .controller import MicrobatchController
from .credits import CreditGate, CreditedChannel
from .feed import FeedSource, ParallelColumnFeeder
from .sources import (AsyncGeneratorSource, IngestSourceLogic, ReplaySource,
                      SocketSource)

__all__ = [
    "ADMISSION_POLICIES", "AdmissionConfig", "ShedTuples",
    "StreamDecoder", "decode_batch", "encode_batch",
    "MicrobatchController", "CreditGate", "CreditedChannel",
    "FeedSource", "ParallelColumnFeeder",
    "AsyncGeneratorSource", "IngestSourceLogic", "ReplaySource",
    "SocketSource",
]
