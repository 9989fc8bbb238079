"""Critical-path latency attribution (docs/OBSERVABILITY.md
"Diagnosis plane").

The telemetry plane closes sampled end-to-end traces with one
``(operator, t_arrive, t_done)`` hop stamp per operator crossed plus a
``@device``-suffixed hop spanning each device submit -> result-on-host
crossing (operators/tpu/win_seq_tpu.py).  This module folds those
records into an *attribution*: every microsecond of a traced e2e
interval is assigned to exactly one hop class --

* ``service``          -- host time inside some operator's ``svc``;
* ``queueing``         -- time covered by no hop: parked in a channel
                          (plus the upstream batch-flush skew) before
                          the next operator's arrival;
* ``device_transport`` -- the per-launch transport floor slice of a
                          device hop (``rtt_floor_ms`` from the
                          placement planner);
* ``device_compute``   -- the rest of the device hop.

Attribution is an interval sweep: the trace's ``[0, e2e]`` span is cut
at every hop boundary and each elementary slice goes to the *innermost*
covering hop (the one with the latest arrival -- under LEVEL2 fusion an
upstream segment's hop interval contains its downstream segments'
inline work, so innermost == the segment actually executing).  Slices
covered by no hop are queueing, charged to the operator whose hop
starts next.  By construction the per-class totals sum to exactly the
traced e2e time, which is what makes the breakdown table's shares sum
to ~100%.

Aggregation keeps a bounded ring of per-trace breakdowns and reports
two cohorts: *all* traces (the p50-ish view) and the *tail* cohort
(traces at or above the p90 e2e -- what the p99 is made of).
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional

from ..audit.ledger import _op_of

# hop classes, in display order
CLASSES = ("service", "queueing", "wire", "device_transport",
           "device_compute")
# suffix the device engines stamp on their dispatcher hops
DEVICE_HOP_SUFFIX = "@device"
# suffix the shuffle transport stamps on cross-worker crossings
# (distributed/wire.rebuild_trace): the whole hop is wire residency
WIRE_HOP_SUFFIX = "@wire"
# per-trace breakdowns kept for aggregation
MAX_TRACES = 256
# operator rows kept in the breakdown table
MAX_OPERATOR_ROWS = 16


def trace_breakdown(rec: dict,
                    rtt_floor_ms: Optional[float] = None) -> Optional[dict]:
    """Attribute one serialized trace record (``Trace_records`` row:
    ``{"e2e_ms", "hops": [[name, arrive_ms, done_ms], ...]}``) into
    per-class / per-operator milliseconds.  Returns None for records
    with no usable span."""
    try:
        if rec.get("partial"):
            # producer-side fragment of a trace that crossed a wire
            # edge: its span never closed at a sink HERE, so folding
            # it would double-charge the hops the consumer-side record
            # (same trace id) already accounts for.  The merge stitches
            # fragments back into the closed record instead.
            return None
        e2e = float(rec.get("e2e_ms") or 0.0)
        raw_hops = rec.get("hops") or []
    except AttributeError:
        return None
    if e2e <= 0.0:
        return None
    ivs = []  # (arrive, done, operator, kind: ""|"device"|"wire")
    for hop in raw_hops:
        try:
            name, a, d = hop[0], float(hop[1]), float(hop[2])
        except (TypeError, ValueError, IndexError):
            continue
        name = str(name)
        if name.endswith(DEVICE_HOP_SUFFIX):
            kind = "device"
            op = _op_of(name[:-len(DEVICE_HOP_SUFFIX)])
        elif name.endswith(WIRE_HOP_SUFFIX):
            kind = "wire"
            op = _op_of(name[:-len(WIRE_HOP_SUFFIX)])
        else:
            kind = ""
            op = _op_of(name)
        # clamp into the traced span: fused upstream segments stamp
        # their hops moments AFTER the sink closes (entries unwind
        # outward), so done can exceed e2e by scheduler noise
        a = min(max(0.0, a), e2e)
        d = min(max(a, d), e2e)
        ivs.append((a, d, op, kind))
    per_class: Dict[str, float] = dict.fromkeys(CLASSES, 0.0)
    per_op: Dict[str, Dict[str, float]] = {}

    def charge(op: str, cls: str, ms: float) -> None:
        per_class[cls] += ms
        row = per_op.get(op)
        if row is None:
            row = per_op[op] = dict.fromkeys(CLASSES, 0.0)
        row[cls] += ms

    starts = sorted((a, op) for a, _d, op, _dev in ivs)
    bounds = sorted({0.0, e2e,
                     *(a for a, _d, _o, _v in ivs),
                     *(d for _a, d, _o, _v in ivs)})
    for t1, t2 in zip(bounds, bounds[1:]):
        dur = t2 - t1
        if dur <= 0.0:
            continue
        covering = [iv for iv in ivs if iv[0] <= t1 and iv[1] >= t2]
        if covering:
            # innermost: latest arrival (a device/wire hop wins a tie
            # -- it is the more specific statement about the time)
            a, d, op, kind = max(covering,
                                 key=lambda iv: (iv[0], bool(iv[3])))
            if kind == "device":
                hop_ms = max(d - a, 1e-9)
                tfrac = min(1.0, (rtt_floor_ms or 0.0) / hop_ms)
                charge(op, "device_transport", dur * tfrac)
                charge(op, "device_compute", dur * (1.0 - tfrac))
            elif kind == "wire":
                charge(op, "wire", dur)
            else:
                charge(op, "service", dur)
        else:
            # gap: queueing before the next hop to start (every arrival
            # is a sweep boundary, so none lies strictly inside the
            # slice); a trailing gap belongs to the close path
            nxt = next((op for a, op in starts if a >= t2 - 1e-9), None)
            charge(nxt if nxt is not None else "(close)", "queueing", dur)
    return {"e2e_ms": e2e, "classes": per_class, "operators": per_op}


def _shares(rows: List[dict]) -> dict:
    total = sum(r["e2e_ms"] for r in rows)
    if total <= 0.0:
        return {c: 0.0 for c in CLASSES}
    return {c: round(sum(r["classes"][c] for r in rows) / total, 4)
            for c in CLASSES}


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[i]


class AttributionAccumulator:
    """Bounded ring of per-trace breakdowns + the report-time fold."""

    def __init__(self, maxlen: int = MAX_TRACES):
        self._rows: deque = deque(maxlen=max(1, maxlen))

    def add(self, breakdown: Optional[dict]) -> None:
        if breakdown is not None:
            self._rows.append(breakdown)

    def __len__(self) -> int:
        return len(self._rows)

    def block(self) -> Optional[dict]:
        """The stats-JSON ``Attribution`` block: e2e percentiles of the
        folded traces, per-class shares for the all-traces and tail
        cohorts, and the per-operator breakdown table (share of total
        traced time, split by class).  Shares are fractions of traced
        e2e time and sum to ~1.0 per cohort."""
        rows = list(self._rows)
        if not rows:
            return None
        e2es = sorted(r["e2e_ms"] for r in rows)
        p90 = _percentile(e2es, 0.90)
        tail = [r for r in rows if r["e2e_ms"] >= p90] or rows
        total = sum(r["e2e_ms"] for r in rows)
        ops: Dict[str, Dict[str, float]] = {}
        for r in rows:
            for op, cls_ms in r["operators"].items():
                agg = ops.setdefault(op, dict.fromkeys(CLASSES, 0.0))
                for c in CLASSES:
                    agg[c] += cls_ms[c]
        op_rows = []
        for op, cls_ms in ops.items():
            ms = sum(cls_ms.values())
            op_rows.append({
                "operator": op,
                "share": round(ms / total, 4) if total else 0.0,
                "classes": {c: round(cls_ms[c] / total, 4) if total
                            else 0.0 for c in CLASSES},
            })
        op_rows.sort(key=lambda r: -r["share"])
        classes = _shares(rows)
        return {
            "Traces": len(rows),
            "E2e_p50_ms": round(_percentile(e2es, 0.50), 3),
            "E2e_p99_ms": round(_percentile(e2es, 0.99), 3),
            "Classes": classes,
            "Classes_tail": _shares(tail),
            "Operators": op_rows[:MAX_OPERATOR_ROWS],
            "Share_sum": round(sum(classes.values()), 4),
        }


def attribution_from_stats(stats: dict) -> Optional[dict]:
    """Offline fallback: rebuild the Attribution block straight from a
    stats-JSON dump's ``Trace_records`` (older dumps carry no
    precomputed ``Diagnosis.Attribution``).  The rtt floor comes from
    the recorded placement decisions when any carry one."""
    recs = stats.get("Trace_records") or []
    rtt = None
    for p in stats.get("Placements") or []:
        if isinstance(p, dict) and p.get("rtt_floor_ms") is not None:
            rtt = float(p["rtt_floor_ms"])
            break
    acc = AttributionAccumulator()
    for rec in recs:
        acc.add(trace_breakdown(rec, rtt))
    return acc.block()
