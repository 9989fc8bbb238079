"""NEXMark Q5 (hot items) on windflow_tpu_torch, as the Nexmark suite
for Flink runs it: its generator and its pipeline.

``nexmark-flink`` q5.sql counts the bids of each auction in
``HOP(dateTime, 2 s, 10 s)`` windows under ``WATERMARK FOR dateTime AS
dateTime - 4 s``, takes each window's largest count and returns every
auction that reaches it.  The events follow Beam's Nexmark generator at
its defaults (``windflow_tpu_torch.models.nexmark.NexmarkGenerator``);
the pipeline is ``BatchSource (watermarked) -> BatchFilter (bids) ->
KeyFarmTPU("count", 10 s, 2 s, TB) -> HotItems -> sink``, the port's
``models/nexmark.build_q5_nexmark``.  Event n is at event time n, in
units of 1/event_rate s.

The hot rows are a few of a window's counts, so each window reaches the
harness's sink with three rows more, under keys no auction takes, that
sum the window's whole count table as the engine emitted it: its bids
(``TOTAL``), its auctions (``AUCTIONS``) and its counts weighted by a
16-bit hash of each auction (``CHECKSUM``).  The reference adds the
same rows, so a count miscounted, lost, doubled or given to another
auction anywhere in a window fails the comparison, not only one at the
window's maximum.
"""
from __future__ import annotations

import threading

import numpy as np

TOTAL, AUCTIONS, CHECKSUM = -1, -2, -3


def weight(key: np.ndarray) -> np.ndarray:
    """A 16-bit multiplicative hash of each auction id (int64)."""
    return ((key * 0x9E3779B1) & 0xFFFFFFFF) >> 16


class WindowTotals:
    """The three sums of every window's counts.  ``record`` sees each
    batch of counts (``key`` auction, ``id`` window, ``value`` count)
    before the hot-items step; called with a batch of hot rows, which
    holds whole windows, it hands them to ``sink`` with each window's
    sums appended (the hot-items step emits a window only after every
    count of it has passed ``record``)."""

    def __init__(self, sink, span, win_len: int, slide_len: int):
        self.sink = sink
        self.span = span
        self.win_len = win_len
        self.slide_len = slide_len
        self.lock = threading.Lock()
        self.open = {}          # window -> [bids, auctions, checksum]

    def record(self, batch) -> None:
        with self.span("wfbench/record"):
            wid = np.asarray(batch.id, np.int64)
            if not len(wid):
                return
            val = np.asarray(batch["value"], np.float64)
            key = np.asarray(batch.key, np.int64)
            # runs of one window (rows come in order of window and key)
            starts = np.concatenate([[0], np.flatnonzero(np.diff(wid)) + 1])
            sums = np.stack([
                np.add.reduceat(val, starts),
                np.diff(np.append(starts, len(wid))).astype(np.float64),
                np.add.reduceat(val * weight(key), starts)], axis=1)
            with self.lock:
                for w, row in zip(wid[starts].tolist(), sums):
                    acc = self.open.get(w)
                    if acc is None:
                        self.open[w] = row
                    else:
                        acc += row

    def __call__(self, item) -> None:
        if item is None or not len(item):
            self.sink(item)
            return
        from windflow_tpu_torch.core.tuples import TupleBatch
        wins = np.unique(np.asarray(item.id, np.int64)).tolist()
        with self.lock:
            sums = [(w, self.open.pop(w)) for w in wins if w in self.open]
        if sums:
            wid = np.repeat(np.array([w for w, _ in sums], np.int64), 3)
            item = TupleBatch({
                "key": np.concatenate([np.asarray(item.key, np.int64),
                                       np.tile([TOTAL, AUCTIONS, CHECKSUM],
                                               len(sums))]),
                "id": np.concatenate([np.asarray(item.id, np.int64), wid]),
                "ts": np.concatenate([
                    np.asarray(item.ts, np.int64),
                    wid * self.slide_len + self.win_len - 1]),
                "value": np.concatenate([
                    np.asarray(item["value"], np.float64),
                    np.concatenate([s for _, s in sums])])})
        self.sink(item)


def make_stream(config: dict, cell: dict, seed: int):
    from windflow_tpu_torch.models.nexmark import NexmarkGenerator
    widths = config["field_bytes"]
    return NexmarkGenerator(
        seed, proportions=config["proportions"],
        in_flight_auctions=config["in_flight_auctions"],
        auction_id_lead=config["auction_id_lead"],
        hot_auction_ratio=config["hot_auction_ratio"],
        hot_auction_stride=config["hot_auction_stride"],
        first_auction_id=config["first_auction_id"],
        first_person_id=config["first_person_id"],
        active_people=config["active_people"],
        text_bytes=[widths[k] for k in NexmarkGenerator.TEXT])


def window_units(config: dict) -> tuple:
    """(window, slide, watermark lag) in event-time units."""
    rate = int(config["event_rate"])
    return (int(config["window_s"] * rate), int(config["slide_s"] * rate),
            int(config["watermark_lag_s"] * rate))


def build(graph, config: dict, cell: dict, source, sink, span) -> None:
    """Wire Q5 into ``graph``: ``source`` and ``sink`` are the
    harness's; the sink gets each window's sums beside its hot rows."""
    from windflow_tpu_torch.models.nexmark import build_q5_nexmark
    win, slide, lag = window_units(config)
    totals = WindowTotals(sink, span, win, slide)
    build_q5_nexmark(graph, source, totals, win_len=win, slide_len=slide,
                     watermark_lag=lag,
                     device_batch=int(cell["device_batch"]),
                     inflight_depth=int(cell["inflight"]),
                     record=totals.record)
