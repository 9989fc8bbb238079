"""The Yahoo Streaming Benchmark on windflow_tpu_torch: its generator
and its pipeline.

YSB (github.com/yahoo/streaming-benchmarks) streams ad events of seven
string fields (user, page and ad ids as UUID text, ad type, event type,
event time, IP), keeps the views, joins each ad to its campaign and
counts the views of each campaign in 10 s tumbling windows of event
time.  Here every field is a fixed-width byte column of its widest
value, and the pipeline is ``BatchSource -> BatchFilter (views) ->
BatchMap (ad id -> campaign through a hash table keyed by the whole
id, event time parsed, projected to the windowed columns as YSB's job
projects) -> KeyFarmTPU("count") -> sink``, the port's
``models/yahoo.build_pipeline`` wiring on this generator.

Event n carries id n and the event time n + t0, in units of 1/rate
seconds (t0 the configuration's ``first_event_time_s``), so a window of
``window_s`` is ``window_s * rate`` units.
"""
from __future__ import annotations

import numpy as np

_HEX = np.frombuffer(b"0123456789abcdef", np.uint8)
_DASHES = (8, 13, 18, 23)
_POW10 = 10.0 ** np.arange(12, -1, -1)
TIME_DIGITS = 13
LOW = 100_000                      # event times cycle their last 5 digits


def uuid_text(rng, k: int) -> np.ndarray:
    """``k`` random version-4 UUIDs as 36-character text (S36)."""
    nib = rng.integers(0, 16, (k, 32), dtype=np.uint8)
    nib[:, 12] = 4
    nib[:, 16] = 8 + (nib[:, 16] & 3)
    out = np.full((k, 36), ord("-"), np.uint8)
    out[:, [i for i in range(36) if i not in _DASHES]] = _HEX[nib]
    return out.view("S36").ravel()


def fixed(values, width: int) -> np.ndarray:
    """Strings as a fixed-width byte column of ``width``."""
    return np.array([v.encode() for v in values], dtype=f"S{width}")


def parse_time(col: np.ndarray) -> np.ndarray:
    """13 ASCII digits a row -> int64 (in float64, exact below 2^53)."""
    d = np.ascontiguousarray(col).view(np.uint8).reshape(-1, TIME_DIGITS)
    return (d @ _POW10 - 48.0 * _POW10.sum()).astype(np.int64)


def _words(col: np.ndarray) -> np.ndarray:
    """A 36-byte id column as rows of nine 32-bit words."""
    return np.ascontiguousarray(col).view(np.uint32).reshape(-1, 9)


class AdCampaigns:
    """YSB's join: ad id -> campaign, a hash table keyed by the whole
    36-character id.  Three of the id's words hash to a slot of a table
    in which no two ids share one; every looked-up id is compared whole
    with its slot's, and an id not in the table raises ``KeyError``."""

    BITS = 20

    def __init__(self, ad_ids: np.ndarray, campaign_of_ad: np.ndarray):
        self.words = _words(ad_ids)
        self.campaign = np.asarray(campaign_of_ad, np.int64)
        h = self._hash(self.words)
        self.shift = np.uint64(64 - self.BITS)
        for i in range(64):
            self.mult = np.uint64(0x9E3779B97F4A7C15 + 2 * i)
            slots = (h * self.mult) >> self.shift
            if len(np.unique(slots)) == len(h):
                break
        else:
            raise ValueError("no collision-free table for these ad ids")
        self.table = np.full(1 << self.BITS, -1, np.int64)
        self.table[slots] = np.arange(len(h))

    @staticmethod
    def _hash(w: np.ndarray) -> np.ndarray:
        u = w.astype(np.uint64)
        return ((u[:, 0] << np.uint64(32)) | u[:, 8]) ^ \
            (u[:, 4] * np.uint64(0xC2B2AE3D27D4EB4F))

    def __call__(self, ad_id: np.ndarray) -> np.ndarray:
        w = _words(ad_id)
        row = self.table[(self._hash(w) * self.mult) >> self.shift]
        if not np.array_equal(self.words[row], w):
            raise KeyError("an ad id not in the campaigns' table")
        return self.campaign[row]


class Stream:
    """YSB's events, drawn from ``seed`` as YSB's generator draws them:
    user and page ids uniform over 100 UUIDs each, the ad uniform over
    the campaigns' 1,000 ads, ad and event types uniform, the IP
    1.2.3.4.  A pool of ``pool_events`` draws is cycled; event n is
    pool row n % pool_events with its own id n and event time n + t0."""

    def __init__(self, config: dict, cell: dict, seed: int):
        rng = np.random.default_rng(seed)
        widths = config["field_bytes"]
        per = config["ads_per_campaign"]
        n_ads = config["campaigns"] * per
        p = int(config["assumed"]["pool_events"])
        self.pool_events = p
        self.t0 = int(config["assumed"]["first_event_time_s"]
                      * int(cell["rate"]))
        # the campaigns' table (YSB's Redis content)
        self.ad_ids = uuid_text(rng, n_ads)
        self.campaign_of_ad = (rng.permutation(n_ads) // per).astype(
            np.int64)
        users = uuid_text(rng, config["user_ids"])
        pages = uuid_text(rng, config["page_ids"])
        events = fixed(config["event_types"], widths["event_type"])
        ads = fixed(config["ad_types"], widths["ad_type"])
        self.pool = {
            "user_id": users[rng.integers(0, len(users), p)],
            "page_id": pages[rng.integers(0, len(pages), p)],
            "ad_id": self.ad_ids[rng.integers(0, n_ads, p)],
            "ad_type": ads[rng.integers(0, len(ads), p)],
            "event_type": events[rng.integers(0, len(events), p)],
            "ip_address": np.full(p, config["ip_address"].encode(),
                                  f"S{widths['ip_address']}"),
        }
        self.view = np.bytes_(config["filter_event_type"].encode())
        # every event time's last five digits, cycled, with room for a
        # batch past the cycle's end, as 13-byte rows
        low = np.arange(LOW + (1 << 17)) % LOW
        self._times = np.zeros((len(low), TIME_DIGITS), np.uint8)
        self._times[:, 8:] = (low[:, None] // 10 ** np.arange(4, -1, -1)
                              ) % 10 + 48

    def event_time(self, first: int, n: int) -> np.ndarray:
        """The text of the event times [first, first + n)."""
        j = first % LOW
        if n <= len(self._times) - j:
            out = self._times[j:j + n].copy()
        else:
            out = self._times[np.arange(first, first + n) % LOW]
        # the first eight digits, one 8-byte word a row
        head = np.ndarray((n,), "<u8", out, strides=(TIME_DIGITS,))
        a = 0
        while a < n:
            hi = (first + a) // LOW
            b = min(n, (hi + 1) * LOW - first)
            head[a:b] = np.frombuffer(b"%08d" % hi, "<u8")[0]
            a = b
        return out.view(f"S{TIME_DIGITS}").ravel()

    def columns(self, first: int, n: int) -> dict:
        p = self.pool_events
        j = first % p
        idx = np.arange(first, first + n, dtype=np.int64)
        rows = slice(j, j + n) if j + n <= p else idx % p
        cols = {"key": np.zeros(n, np.int64), "id": idx,
                "ts": idx + self.t0,
                "event_time": self.event_time(first + self.t0, n)}
        for name, col in self.pool.items():
            cols[name] = col[rows]
        return cols


def make_stream(config: dict, cell: dict, seed: int) -> Stream:
    return Stream(config, cell, seed)


def window_units(config: dict, cell: dict) -> tuple:
    """(window, slide) in event-time units (1/rate s)."""
    rate = int(cell["rate"])
    return int(config["window_s"] * rate), int(config["slide_s"] * rate)


def build(graph, config: dict, cell: dict, source, sink, span) -> None:
    """Wire YSB into ``graph``: ``source`` and ``sink`` are the
    harness's; ``span(label)`` names a host range in traced runs."""
    from windflow_tpu_torch.core.basic import WinType
    from windflow_tpu_torch.core.tuples import TupleBatch
    from windflow_tpu_torch.operators.basic_ops import Sink
    from windflow_tpu_torch.operators.batch_ops import (BatchFilter,
                                                        BatchMap,
                                                        BatchSource)
    from windflow_tpu_torch.operators.tpu.farms_tpu import KeyFarmTPU

    stream = source.stream
    campaigns = AdCampaigns(stream.ad_ids, stream.campaign_of_ad)
    # the event type is compared whole, as one 8-byte word
    width = config["field_bytes"]["event_type"]
    view = np.array([stream.view], f"S{width}").view(np.uint64)[0]

    def views(batch):
        with span("wfbench/filter"):
            return batch["event_type"].view(np.uint64) == view

    def join_campaign(batch):
        with span("wfbench/join"):
            return TupleBatch({"key": campaigns(batch["ad_id"]),
                               "id": batch.id,
                               "ts": parse_time(batch["event_time"]),
                               "value": np.ones(len(batch))})

    win, slide = window_units(config, cell)
    counter = KeyFarmTPU(
        config["aggregate"], win, slide, WinType.TB,
        batch_len=int(cell["device_batch"]), name="campaign_count",
        emit_batches=True, inflight_depth=int(cell["inflight"]))
    graph.add_source(BatchSource(source, name="ysb_source")) \
        .chain(BatchFilter(views, name="ysb_views")) \
        .chain(BatchMap(join_campaign, name="ysb_join")) \
        .add(counter) \
        .add_sink(Sink(sink, name="ysb_sink"))
