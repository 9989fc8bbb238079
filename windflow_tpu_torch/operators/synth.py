"""SyntheticSource: a declared-parameter benchmark/test source.

The reference's tests all use synthetic sources built inline in each
binary (e.g. mp_common.hpp:125-163); windflow_tpu_torch additionally makes
the standard fixture shape a *descriptor* so the whole pipeline can
lower onto the native C++ record plane (graph/native_lowering.py) and
run source->...->sink entirely off the Python interpreter.

Stream shape: ``n_events`` records, ``key = i % n_keys``,
``id = ts = i // n_keys`` (dense in-order per key),
``value = (i % vmod) * vscale + voff``.

The Python fallback (when the chain cannot lower) emits columnar
``TupleBatch`` chunks on the batch plane or per-record ``BasicRecord``
on the scalar plane, identical content either way.
"""
from __future__ import annotations


from ..core.basic import Pattern, RoutingMode
from ..core.context import RuntimeContext
from ..core.tuples import BasicRecord, SynthChunk
from ..runtime.emitters import StandardEmitter
from ..runtime.node import SourceLoopLogic
from .base import Operator, StageSpec


class _SynthLogic(SourceLoopLogic):
    def __init__(self, desc, batch: int, emit_batches: bool,
                 chunked: bool = False):
        self.desc = desc
        self.batch = batch
        self.emit_batches = emit_batches
        self.chunked = chunked
        self.sent = 0
        self.context = RuntimeContext(1, 0)

        def step(emit):
            d = self.desc
            i = self.sent
            if i >= d.n_events:
                return False
            n = min(self.batch, d.n_events - i)
            chunk = SynthChunk(i, n, d.n_keys, d.vmod, d.vscale, d.voff)
            self.sent = i + n
            if self.chunked:
                emit(chunk)
            elif self.emit_batches:
                emit(chunk.materialize())  # single source of the law
            else:
                b = chunk.materialize()
                for j in range(n):
                    emit(BasicRecord(int(b.key[j]), int(b.id[j]),
                                     int(b.ts[j]), float(b["value"][j])))
            return True

        super().__init__(step)

    # -- checkpoint: a declared source resumes from its offset ---------
    def state_dict(self):
        return {"sent": self.sent}

    def load_state(self, state) -> None:
        self.sent = state["sent"]


class SyntheticSource(Operator):
    """Descriptor source: key=i%K, id=ts=i//K, value=(i%vmod)*vscale+voff.

    ``emit_batches=True`` (default) emits TupleBatch chunks (columnar
    plane); False emits BasicRecords (scalar plane).  Either way the
    native lowering replaces it with the C++ synthetic generator when
    the rest of the chain lowers.
    """

    def __init__(self, n_events: int, n_keys: int = 1, vmod: int = 97,
                 vscale: float = 1.0, voff: float = 0.0,
                 batch: int = 65536, emit_batches: bool = True,
                 chunked: bool = False, name: str = "synthetic_source"):
        super().__init__(name, 1, RoutingMode.NONE, Pattern.SOURCE)
        self.n_events = n_events
        self.n_keys = max(1, n_keys)
        self.vmod = max(1, vmod)
        self.vscale = vscale
        self.voff = voff
        self.batch = batch
        self.emit_batches = emit_batches
        # chunked=True ships SynthChunk descriptors instead of columns;
        # device window stages fold them natively (win_seq_tpu), other
        # consumers materialize transparently
        self.chunked = chunked

    def stages(self):
        return [StageSpec(self.name,
                          [_SynthLogic(self, self.batch, self.emit_batches,
                                       self.chunked)],
                          StandardEmitter(), self.routing)]
