"""Stall watchdog: liveness monitoring for a running PipeGraph.

A graph can hang without any replica raising: a dead-but-undetected
consumer, a livelocked user function, an exhausted external resource.
The watchdog samples a graph-wide progress counter (channel ``gets``
plus per-node completed items); when it does not advance for
``deadline_s`` while replica threads are still alive, it dumps a
diagnostic report (per-node channel depth / high-watermark / put-get
counters plus every Python thread's stack) under ``log_dir`` and --
when ``cancel`` is set -- cancels the graph through its CancelToken
with a :class:`StallError`, so ``wait_end`` returns instead of joining
forever.

Enable per graph via ``RuntimeConfig.watchdog_timeout_s`` (None =
disabled; ``watchdog_cancel`` picks dump-only vs dump-and-cancel).
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback
from typing import Optional

from .errors import StallError


def _thread_stacks() -> str:
    """Formatted stacks of every live Python thread (the py-spy-style
    dump that makes a deadlock diagnosable post mortem)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for ident, frame in sys._current_frames().items():
        out.append(f"--- thread {names.get(ident, '?')} (ident {ident}) ---")
        out.append("".join(traceback.format_stack(frame)))
    return "\n".join(out)


def stall_report(graph) -> dict:
    """Channel-depth snapshot of every consumer node plus thread
    stacks.  When the audit plane is on (audit/), each row also
    carries the node's frontier watermark and lag -- the stalled node
    is usually the one whose frontier froze first."""
    channels = []
    auditor = getattr(graph, "auditor", None)
    frontiers = auditor.tracker.frontiers if auditor is not None else {}
    for n in graph._all_nodes():
        ch = n.channel
        row = {
            "node": n.name,
            "alive": n.is_alive(),
            "taken": n.taken,
            "done": n.done,
        }
        fr = frontiers.get(n.name)
        if fr is not None:
            row["frontier"] = round(fr["frontier"], 1)
            row["frontier_lag_ms"] = round(fr["lag_ms"], 1)
            row["frontier_stalled"] = fr["stalled"]
        if ch is not None:
            row.update({
                "channel_impl": type(ch).__name__,
                "depth": ch.qsize(),
                "capacity": getattr(ch, "capacity", None),
                "puts": getattr(ch, "puts", 0),
                "gets": getattr(ch, "gets", 0),
                "high_watermark": getattr(ch, "high_watermark", 0),
            })
        channels.append(row)
    return {
        "graph": graph.name,
        "time": time.time(),
        "nodes": channels,
        "thread_stacks": _thread_stacks(),
    }


def dump_stall_report(graph, log_dir: str) -> str:
    """Write the stall report JSON; returns the file path."""
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir,
                        f"{os.getpid()}_{graph.name}_stall.json")
    with open(path, "w") as f:
        json.dump(stall_report(graph), f, indent=1)
    return path


class StallWatchdog(threading.Thread):
    """Monitor thread owned by a PipeGraph (started/stopped with it)."""

    def __init__(self, graph, deadline_s: float, poll_s: float = None,
                 cancel: bool = True):
        super().__init__(name=f"windflow-watchdog-{graph.name}",
                         daemon=True)
        self.graph = graph
        self.deadline_s = deadline_s
        self.poll_s = poll_s if poll_s is not None \
            else max(0.05, min(1.0, deadline_s / 4))
        self.cancel = cancel
        self._stop_evt = threading.Event()
        self.fired = False
        self.report_path: Optional[str] = None

    def _progress(self) -> int:
        from ..runtime.node import FusedLogic
        total = 0
        for n in self.graph._all_nodes():
            total += n.done
            if isinstance(n.logic, FusedLogic):
                # fused stages process inline (no channel hop): their
                # per-segment take counters are the progress signal --
                # without them a fully fused source-headed pipeline
                # would look stalled forever
                for seg in n.logic.segments:
                    total += seg.taken
            ch = n.channel
            if ch is not None:
                total += getattr(ch, "gets", 0)
        return total

    def run(self) -> None:
        last = self._progress()
        last_change = time.monotonic()
        while not self._stop_evt.wait(self.poll_s):
            nodes = self.graph._all_nodes()
            if not any(n.is_alive() for n in nodes):
                return  # graph finished between polls
            pause = self.graph._pause_ctl
            if pause is not None and pause.pausing:
                last_change = time.monotonic()  # checkpoint barrier
                continue
            cur = self._progress()
            if cur != last:
                last, last_change = cur, time.monotonic()
                continue
            if time.monotonic() - last_change < self.deadline_s:
                continue
            self.fired = True
            try:
                self.report_path = dump_stall_report(
                    self.graph, self.graph.config.log_dir)
            except OSError:
                self.report_path = None
            # flight recorder (telemetry/recorder.py): the stall event
            # plus the last-N-events history next to the channel dump,
            # so the post-mortem sees what led up to the stall
            flight = getattr(self.graph, "flight", None)
            if flight is not None:
                flight.record("stall", deadline_s=self.deadline_s,
                              report=self.report_path,
                              cancelling=self.cancel)
                flight.dump(self.graph.config.log_dir, self.graph.name)
            if self.cancel:
                err = StallError(
                    f"graph {self.graph.name!r} made no progress for "
                    f"{self.deadline_s:.1f}s; channel/thread dump at "
                    f"{self.report_path}")
                self.graph._cancel.cancel(err, origin="watchdog")
                return
            last_change = time.monotonic()  # dump-only: re-arm

    def stop(self) -> None:
        self._stop_evt.set()
        self.join(timeout=5.0)
