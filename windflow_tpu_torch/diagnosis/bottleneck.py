"""Backpressure root-cause walk: name the single dominant bottleneck
operator per sink (docs/OBSERVABILITY.md "Diagnosis plane").

Bounded queues make backpressure *cascade*: once the true bottleneck's
inbound queue fills, its producers block on put, their queues fill, and
within seconds every edge upstream of the slow operator reads
pressured.  The walk therefore does not pick the *most* pressured
operator -- it picks the most **downstream** pressured ancestor of each
sink: the operator whose inbound edge is backed up while everything
below it is starved is where the time is actually going.

Evidence per operator (aggregated over replicas, all of it already in
the stats JSON -- the walk is a pure function usable live, on a
dashboard report, or on an offline dump):

* ``depth_frac``     -- inbound channel depth / bounded capacity (the
                        live signal);
* ``sustained_depth``-- the diagnosis plane's EWMA of depth_frac over
                        its ticks (survives the end-of-run drain, so a
                        post-run dump still names the operator);
* ``lag_norm``       -- frontier lag normalized against 1 s (the audit
                        plane's "held back while work was pending").

``score = max(depth, 0.9*sustained, 0.7*lag)``; an operator is
*pressured* at score >= PRESSURE_MIN.  The peak-depth high-watermark
is reported as evidence but deliberately kept OUT of the score: every
upstream microbatch flush legitimately spikes a healthy consumer's
inbound queue to capacity, so a cumulative peak would name fast sinks
over the operator that is actually slow.  No pressured ancestor means
the pipeline is keeping up -- the verdict is ``input_bound`` and the
sink's source is named instead (the stream is the limit, not the
graph), unless the critical-path attribution shows one operator
holding the traced time (``service_bound``).
"""
from __future__ import annotations

from typing import Dict, List, Optional

from .topology import ancestors_of, depth_ranks, sinks_of, sources_of

# score at/above which an operator counts as pressured
PRESSURE_MIN = 0.15
# score from which the verdict upgrades from "mild" to "backpressure"
PRESSURE_HIGH = 0.5
# frontier lag that saturates the lag evidence term (ms)
LAG_REF_MS = 1000.0
# attributed service share from which an operator is service-bound
# (the no-queue evidence: a fully-fused chain has no channels to back
# up, but the critical-path attribution still names where time goes)
SERVICE_BOUND_SHARE = 0.4


def operator_evidence(op: dict, capacity: int,
                      sustained: Optional[float] = None) -> dict:
    """Fold one stats-JSON operator row into the evidence dict."""
    reps = op.get("Replicas") or []
    cap = max(1, int(capacity or 1)) * max(1, len(reps))
    depth = sum(int(r.get("Queue_depth", 0) or 0) for r in reps)
    hwm = max((int(r.get("Queue_high_watermark", 0) or 0)
               for r in reps), default=0)
    lag = max((float(r.get("Frontier_lag_ms", 0) or 0.0)
               for r in reps), default=0.0)
    wait = sum(float(r.get("Credit_wait_s", 0) or 0.0) for r in reps)
    svc = [float(r.get("Service_time_usec", 0) or 0.0) for r in reps]
    lat = (op.get("Latency") or {}).get("service") or {}
    return {
        "depth": depth,
        "depth_frac": round(min(1.0, depth / cap), 4),
        "hwm_frac": round(min(1.0, hwm / max(1, int(capacity or 1))), 4),
        "sustained_depth": round(float(sustained or 0.0), 4),
        "frontier_lag_ms": round(lag, 1),
        "credit_wait_s": round(wait, 3),
        "service_time_us": round(sum(svc) / len(svc), 1) if svc else 0.0,
        "service_p99_us": lat.get("p99_us", 0.0),
    }


def pressure_score(ev: dict) -> float:
    lag_norm = min(1.0, ev["frontier_lag_ms"] / LAG_REF_MS)
    return round(max(ev["depth_frac"],
                     0.9 * ev["sustained_depth"],
                     0.7 * lag_norm), 4)


def find_bottlenecks(operators: List[dict], edges: List[List[str]],
                     capacity: int,
                     sustained: Optional[Dict[str, float]] = None,
                     attribution: Optional[dict] = None) -> dict:
    """The ``Diagnosis.Bottleneck`` block: one row per sink (most
    downstream pressured ancestor, or input_bound) plus the dominant
    row overall.  When no queue evidence exists (nothing pressured --
    e.g. the whole chain fused into one replica) the critical-path
    ``attribution`` breaks the tie: an operator holding >=
    ``SERVICE_BOUND_SHARE`` of the traced time is named
    ``service_bound``."""
    sustained = sustained or {}
    by_name = {op.get("Operator_name", ""): op for op in operators}
    evidence = {name: operator_evidence(op, capacity, sustained.get(name))
                for name, op in by_name.items()}
    scores = {name: pressure_score(ev) for name, ev in evidence.items()}
    ranks = depth_ranks(edges)
    rows = []
    for sink in sinks_of(edges, by_name):
        cands = [n for n in ancestors_of(edges, sink) if n in scores]
        pressured = [n for n in cands if scores[n] >= PRESSURE_MIN]
        if pressured:
            # most downstream pressured ancestor; score breaks rank ties
            best = max(pressured,
                       key=lambda n: (ranks.get(n, 0), scores[n]))
            verdict = ("backpressure" if scores[best] >= PRESSURE_HIGH
                       else "mild_pressure")
            rows.append({"sink": sink, "operator": best,
                         "score": scores[best], "verdict": verdict,
                         "evidence": evidence[best]})
        else:
            srcs = [s for s in sources_of(edges, by_name) if s in cands]
            src = max(srcs, key=lambda n: scores.get(n, 0.0), default=None)
            rows.append({"sink": sink, "operator": src,
                         "score": scores.get(src, 0.0) if src else 0.0,
                         "verdict": "input_bound",
                         "evidence": evidence.get(src) if src else None})
    top = max((r for r in rows if r["verdict"] != "input_bound"),
              key=lambda r: r["score"], default=None)
    if top is None and attribution:
        # no queue evidence anywhere: fall back to where the traced
        # time actually went (excluding pure queueing rows)
        cand = next((r for r in attribution.get("Operators") or []
                     if (r.get("classes") or {}).get("queueing", 0.0)
                     < r.get("share", 0.0)), None)
        if cand and cand.get("share", 0.0) >= SERVICE_BOUND_SHARE:
            top = {"sink": None, "operator": cand["operator"],
                   "score": round(cand["share"], 4),
                   "verdict": "service_bound",
                   "evidence": {"attributed_share": cand["share"],
                                "classes": cand.get("classes")}}
            rows = rows + [top]
    if top is None:
        top = max(rows, key=lambda r: r["score"], default=None)
    return {
        "Sinks": rows,
        "Operator": top["operator"] if top else None,
        "Score": top["score"] if top else 0.0,
        "Verdict": top["verdict"] if top else "no_data",
        "Evidence": top["evidence"] if top else None,
    }


def bottleneck_from_stats(stats: dict) -> Optional[dict]:
    """Offline fallback: rebuild the Bottleneck block from a stats-JSON
    dump (uses the dump's own Topology and Queue_capacity when present;
    tolerates their absence in older dumps)."""
    operators = stats.get("Operators")
    if not operators:
        return None
    diag = stats.get("Diagnosis") or {}
    topo = stats.get("Topology") or {}
    from ..core.basic import DEFAULT_QUEUE_CAPACITY
    cap = int(diag.get("Queue_capacity") or DEFAULT_QUEUE_CAPACITY)
    sustained = diag.get("Sustained_depth") or {}
    from .attribution import attribution_from_stats
    attribution = diag.get("Attribution") or attribution_from_stats(stats)
    return find_bottlenecks(operators, topo.get("Edges") or [],
                            cap, sustained, attribution)
