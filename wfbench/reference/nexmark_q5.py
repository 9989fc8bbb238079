"""Plain NumPy reference of the NEXMark Q5 cells: per window, every
auction whose bid count equals the window's largest, as exact integers.

It regenerates the bids from the generator's law (Beam's Nexmark
generator at the configuration's settings, each draw a 32-bit hash of
the event index and the seed), counts the bids of each auction in each
pane (one slide of event time) with ``np.bincount`` -- an auction's ids
in a pane form a contiguous range -- and sums five panes to a window.
A window ``w >= 0`` spans event time ``[w * slide, w * slide + win)``;
event ``n`` lies at time ``n``.  Every window holding a bid is counted,
the tail's too (the stream's end closes them).  Beside its hot rows,
each window has three rows under keys no auction takes: its bids
(``TOTAL``), its auctions (``AUCTIONS``) and its counts weighted by a
16-bit hash of each auction (``CHECKSUM``), the sums of its whole count
table.  Imports nothing of the program.
"""
from __future__ import annotations

import numpy as np

M32 = 0xFFFFFFFF
C1, C2 = 0x7FEB352D, 0x1B873593
BLOCK = 1 << 22
TOTAL, AUCTIONS, CHECKSUM = -1, -2, -3


def _mix(x):
    x = x ^ (x >> 16)
    x = (x * C1) & M32
    x = x ^ (x >> 15)
    x = (x * C2) & M32
    return x ^ (x >> 16)


def _words(seed: int, stream: int) -> tuple:
    seed &= (1 << 64) - 1
    s1 = _mix((seed & M32) ^ ((0x9E3779B9 * (stream + 1)) & M32))
    return s1, _mix(((seed >> 32) & M32) ^ s1)


def _draw(idx, words):
    h = _mix((idx & M32) ^ words[0])
    return _mix(h ^ ((idx >> 32) & M32) ^ words[1])


def _units(config: dict) -> tuple:
    rate = int(config["event_rate"])
    return int(config["window_s"] * rate), int(config["slide_s"] * rate)


def _auctions(config: dict, seed: int, lo: int, hi: int) -> np.ndarray:
    """The auction of every bid among events [lo, hi)."""
    person, auction, bid = config["proportions"]
    total = person + auction + bid
    idx = np.arange(lo, hi, dtype=np.int64)
    idx = idx[idx % total >= person + auction]
    coin = _draw(idx, _words(seed, 0))
    choice = _draw(idx, _words(seed, 1))
    last = (idx // total) * auction + auction - 1
    low = np.maximum(last - int(config["in_flight_auctions"]), 0)
    span = last - low + 1 + int(config["auction_id_lead"])
    stride = int(config["hot_auction_stride"])
    hot = (coin * int(config["hot_auction_ratio"])) >> 32 > 0
    return int(config["first_auction_id"]) + np.where(
        hot, last // stride * stride, low + ((choice * span) >> 32))


def _pane(config: dict, seed: int, lo: int, hi: int):
    """(first auction id, bids of each auction from it) over [lo, hi)."""
    parts = [_auctions(config, seed, a, min(a + BLOCK, hi))
             for a in range(lo, hi, BLOCK)]
    ids = np.concatenate(parts) if parts else np.zeros(0, np.int64)
    if len(ids) == 0:
        return 0, np.zeros(0, np.int64)
    base = int(ids.min())
    return base, np.bincount(ids - base).astype(np.int64)


def counts(config: dict, cell: dict, stream, n_events: int):
    """{key, wid, value} of every (auction, window) holding a bid over
    events [0, n_events), window by window."""
    win, slide = _units(config)
    if win % slide:
        raise ValueError("a window must be a whole number of slides")
    k = win // slide
    seed = stream.seed
    n_panes = -(-n_events // slide)
    panes = [_pane(config, seed, p * slide, min((p + 1) * slide, n_events))
             for p in range(n_panes)]
    keys, wids, vals = [], [], []
    for w in range(n_panes):    # window w: panes w .. w + k - 1
        live = [(b, c) for b, c in panes[w:w + k] if len(c)]
        if not live:
            continue
        lo = min(b for b, _ in live)
        hi = max(b + len(c) for b, c in live)
        total = np.zeros(hi - lo, np.int64)
        for b, c in live:
            total[b - lo:b - lo + len(c)] += c
        nz = np.flatnonzero(total)
        keys.append(nz + lo)
        wids.append(np.full(len(nz), w, np.int64))
        vals.append(total[nz])
    if not keys:
        z = np.zeros(0, np.int64)
        return {"key": z, "wid": z, "value": z}
    return {"key": np.concatenate(keys), "wid": np.concatenate(wids),
            "value": np.concatenate(vals)}


def totals(table: dict) -> dict:
    """{key, wid, value} of each window's sums over a count table in
    order of window: keys TOTAL (its bids), AUCTIONS (its rows) and
    CHECKSUM (its counts times a 16-bit hash of each auction)."""
    wid, key, val = table["wid"], table["key"], table["value"]
    if len(wid) == 0:
        z = np.zeros(0, np.int64)
        return {"key": z, "wid": z, "value": z.astype(np.float64)}
    starts = np.concatenate([[0], np.flatnonzero(np.diff(wid)) + 1])
    weight = ((key * 0x9E3779B1) & M32) >> 16
    sums = np.stack([np.add.reduceat(val, starts),
                     np.diff(np.append(starts, len(wid))),
                     np.add.reduceat(val * weight, starts)], axis=1)
    return {"key": np.tile(np.array([TOTAL, AUCTIONS, CHECKSUM], np.int64),
                           len(starts)),
            "wid": np.repeat(wid[starts], 3),
            "value": sums.ravel().astype(np.float64)}


def windows(config: dict, cell: dict, stream, n_events: int) -> dict:
    """{key, wid, value} over events [0, n_events): every window's hot
    auctions (those whose count equals the window's largest), then every
    window's sums (``totals``)."""
    t = counts(config, cell, stream, n_events)
    sums = totals(t)
    if len(t["key"]) == 0:
        return sums
    starts = np.concatenate([[0], np.flatnonzero(np.diff(t["wid"])) + 1])
    top = np.maximum.reduceat(t["value"], starts)
    lens = np.diff(np.append(starts, len(t["wid"])))
    hot = t["value"] == np.repeat(top, lens)
    return {"key": np.concatenate([t["key"][hot], sums["key"]]),
            "wid": np.concatenate([t["wid"][hot], sums["wid"]]),
            "value": np.concatenate([t["value"][hot].astype(np.float64),
                                     sums["value"]])}
