"""Plain NumPy reference of the YSB cells: the view count of every
(campaign, 10 s window) from the generator's events, as exact integers.

It follows the keyed tumbling windows of event time that the program
states: a campaign's windows run from the one holding its first view to
the one holding its last, and each counts the campaign's views whose
time lies in it.  It compares the event type and looks up each ad id
in the campaigns' table as strings, and takes event n's time as
n + t0, the generator's law.  Imports nothing of the program.
"""
from __future__ import annotations

import numpy as np

BLOCK = 1 << 16


def _prefix_counts(campaign_seq: np.ndarray, n_campaigns: int):
    """A function x -> views of each campaign among pool rows [0, x)."""
    p = len(campaign_seq)
    blocks = np.zeros((p // BLOCK + 2, n_campaigns + 1), np.int64)
    for j in range(0, p, BLOCK):
        blocks[j // BLOCK + 1] = blocks[j // BLOCK] + np.bincount(
            campaign_seq[j:j + BLOCK], minlength=n_campaigns + 1)

    def upto(x: int) -> np.ndarray:
        b = x // BLOCK
        return (blocks[b] + np.bincount(campaign_seq[b * BLOCK:x],
                                        minlength=n_campaigns + 1)
                )[:n_campaigns]

    return upto


def windows(config: dict, cell: dict, stream, n_events: int) -> dict:
    """{key, wid, value} of every window over events [0, n_events)."""
    n_c = config["campaigns"]
    rate = int(cell["rate"])
    win = int(config["window_s"] * rate)
    if int(config["slide_s"] * rate) != win:
        raise ValueError("YSB's windows are tumbling")
    p = stream.pool_events
    # the join, worked out again: each pool row's ad id looked up in the
    # campaigns' table by a binary search over the sorted ids
    order = np.argsort(stream.ad_ids)
    ids = stream.ad_ids[order]
    pool = stream.pool
    pos = np.minimum(np.searchsorted(ids, pool["ad_id"]), len(ids) - 1)
    if not (ids[pos] == pool["ad_id"]).all():
        raise KeyError("an ad id not in the campaigns' table")
    campaign = stream.campaign_of_ad[order][pos]
    is_view = pool["event_type"] == config["filter_event_type"].encode()
    # the campaign of each pool row, n_c (no campaign) where not a view
    seq = np.where(is_view, campaign, n_c)
    upto_pool = _prefix_counts(seq, n_c)
    per_pass = upto_pool(p)

    def upto(x: int) -> np.ndarray:
        return (x // p) * per_pass + upto_pool(x % p)

    # views of each campaign in each window: counts[w - w_first, c];
    # event n lies at time n + t0
    t0 = stream.t0
    w_first, w_last = t0 // win, (n_events - 1 + t0) // win
    counts = np.diff(np.stack([
        upto(min(max(w * win - t0, 0), n_events))
        for w in range(w_first, w_last + 2)]), axis=0)
    full, rest = divmod(n_events, p)
    keys, wids, vals = [], [], []
    for c in range(n_c):
        pos = np.nonzero(seq == c)[0]          # views of c in a pass
        if len(pos) == 0 or pos[0] >= n_events:
            continue
        k = np.searchsorted(pos, rest) - 1     # last view in the rest
        last = full * p + pos[k] if k >= 0 else (full - 1) * p + pos[-1]
        w = np.arange((pos[0] + t0) // win, (last + t0) // win + 1)
        keys.append(np.full(len(w), c, np.int64))
        wids.append(w)
        vals.append(counts[w - w_first, c].astype(np.float64))
    if not keys:
        z = np.zeros(0, np.int64)
        return {"key": z, "wid": z, "value": z.astype(np.float64)}
    return {"key": np.concatenate(keys), "wid": np.concatenate(wids),
            "value": np.concatenate(vals)}
