"""Plain torch reference of NEXMark Q5 (hot items) at the Nexmark
suite's settings, on the CPU: per window, every auction whose bid count
equals the window's largest, as exact int64 counts.

It regenerates the bids from the generator's law (Beam's Nexmark
generator: ``proportions`` persons, auctions and bids in every period;
a bid goes to the hot auction -- the newest auction id rounded down to
a multiple of ``hot_auction_stride`` -- when its coin says so, else
uniformly to one of the ``in_flight_auctions`` newest auctions or the
``auction_id_lead`` ids after them; each draw a 32-bit hash of the event
index and the seed), counts the bids of each auction in each pane (one
slide of event time) with ``torch.bincount`` -- an auction's ids in a
pane form a contiguous range -- and sums ``window / slide`` panes to a
window.  Window ``w >= 0`` spans event time ``[w * slide, w * slide +
window)``; event ``n`` lies at time ``n``.  Every window holding a bid
is counted, the stream's tail too.  ``totals`` sums each window's whole
count table as the benchmark's comparison does: its bids, its auctions
and its counts weighted by a 16-bit hash of each auction.  Imports
neither JAX nor the port.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
C1, C2 = 0x7FEB352D, 0x1B873593
BLOCK = 1 << 22
TOTAL, AUCTIONS, CHECKSUM = -1, -2, -3


def _mix(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = (x * C1) & M32
    x = x ^ (x >> 15)
    x = (x * C2) & M32
    return x ^ (x >> 16)


def _mix_int(x: int) -> int:
    return int(_mix(torch.tensor([x], dtype=torch.int64))[0])


def _words(seed: int, stream: int) -> tuple:
    seed &= (1 << 64) - 1
    s1 = _mix_int((seed & M32) ^ ((0x9E3779B9 * (stream + 1)) & M32))
    return s1, _mix_int(((seed >> 32) & M32) ^ s1)


def _draw(idx: torch.Tensor, words: tuple) -> torch.Tensor:
    h = _mix((idx & M32) ^ words[0])
    return _mix(h ^ ((idx >> 32) & M32) ^ words[1])


def _units(config: dict) -> tuple:
    rate = int(config["event_rate"])
    return int(config["window_s"] * rate), int(config["slide_s"] * rate)


def auctions(config: dict, seed: int, lo: int, hi: int) -> tuple:
    """(index, auction) of every bid among events [lo, hi)."""
    person, auction, bid = config["proportions"]
    total = person + auction + bid
    idx = torch.arange(lo, hi, dtype=torch.int64)
    idx = idx[idx % total >= person + auction]
    coin = _draw(idx, _words(seed, 0))
    choice = _draw(idx, _words(seed, 1))
    last = torch.div(idx, total, rounding_mode="floor") * auction \
        + auction - 1
    low = torch.clamp(last - int(config["in_flight_auctions"]), min=0)
    span = last - low + 1 + int(config["auction_id_lead"])
    stride = int(config["hot_auction_stride"])
    hot = ((coin * int(config["hot_auction_ratio"])) >> 32) > 0
    hot_id = torch.div(last, stride, rounding_mode="floor") * stride
    pick = low + ((choice * span) >> 32)
    return idx, int(config["first_auction_id"]) + torch.where(hot, hot_id,
                                                              pick)


def _pane(config: dict, seed: int, lo: int, hi: int) -> tuple:
    """(first auction id, bids of each auction from it) over [lo, hi)."""
    parts = [auctions(config, seed, a, min(a + BLOCK, hi))[1]
             for a in range(lo, hi, BLOCK)]
    ids = torch.cat(parts) if parts else torch.zeros(0, dtype=torch.int64)
    if len(ids) == 0:
        return 0, torch.zeros(0, dtype=torch.int64)
    base = int(ids.min())
    return base, torch.bincount(ids - base)


def counts(config: dict, cell: dict, stream, n_events: int) -> dict:
    """{key, wid, value} of every (auction, window) holding a bid over
    events [0, n_events), in order of (window, auction)."""
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
        total = torch.zeros(hi - lo, dtype=torch.int64)
        for b, c in live:
            total[b - lo:b - lo + len(c)] += c
        nz = torch.nonzero(total).flatten()
        keys.append(nz + lo)
        wids.append(torch.full((len(nz),), w, dtype=torch.int64))
        vals.append(total[nz])
    if not keys:
        z = torch.zeros(0, dtype=torch.int64)
        return {"key": z, "wid": z, "value": z}
    return {"key": torch.cat(keys), "wid": torch.cat(wids),
            "value": torch.cat(vals)}


def windows(config: dict, cell: dict, stream, n_events: int) -> dict:
    """{key, wid, value} of every window's hot auctions over events
    [0, n_events): those whose count equals the window's largest."""
    t = counts(config, cell, stream, n_events)
    if len(t["key"]) == 0:
        return t
    wid = t["wid"]
    top = torch.zeros(int(wid.max()) + 1, dtype=torch.int64)
    top = top.scatter_reduce(0, wid, t["value"], reduce="amax")
    hot = t["value"] == top[wid]
    return {k: v[hot] for k, v in t.items()}


def totals(table: dict) -> dict:
    """{key, wid, value} of each window's sums over a count table in
    order of window: keys TOTAL (its bids), AUCTIONS (its rows) and
    CHECKSUM (its counts times a 16-bit hash of each auction)."""
    wid, key, val = table["wid"], table["key"], table["value"]
    wins, idx = torch.unique_consecutive(wid, return_inverse=True)
    weight = ((key * 0x9E3779B1) & M32) >> 16
    sums = torch.zeros(len(wins), 3, dtype=torch.int64)
    sums[:, 0].index_add_(0, idx, val)
    sums[:, 1].index_add_(0, idx, torch.ones_like(val))
    sums[:, 2].index_add_(0, idx, val * weight)
    return {"key": torch.tensor([TOTAL, AUCTIONS, CHECKSUM]).repeat(
                len(wins)),
            "wid": wins.repeat_interleave(3), "value": sums.flatten()}
