"""NEXMark-style query set: the second benchmark application family
(the port of ``windflow_tpu/models/nexmark.py``).

The reference ships its workloads as self-checking test pipelines
(tests/mp_tests_*); the NEXMark auction queries are the streaming
community's standard benchmark shapes, expressed here on the columnar
plane with the device window operators:

* Q1 currency conversion -- stateless BatchMap (price * rate)
* Q2 selection           -- stateless BatchFilter (auction id set)
* Q5 hot items           -- per-auction sliding-window bid counts,
                            KeyFarmTPU 'count' (key_farm_gpu.hpp shape)
* Q7 highest bid         -- global per-window maximum price,
                            WinSeqTPU 'max' (win_seq_gpu.hpp shape)

With the event-time relational plane (eventtime/; docs/EVENTTIME.md)
the remaining relational queries complete the set, each with a numpy
oracle (``qN_oracle``) that doubles as the eager baseline twin for the
bench gate:

* Q3 local item suggestion -- persons |><| auctions on seller
                              (incremental full-history IntervalJoin)
* Q4 average price per category -- auctions |><| bids per window,
                              closing price = per-auction max, averaged
                              per category (WindowJoin + window agg)
* Q6 average selling price per seller -- same join, averaged per seller
* Q8 monitor new users -- persons |><| auctions-by-seller per window
                              (who registered AND sold in the window)

Synthetic bid stream: (auction, bidder, price, ts), ts dense; persons
and auctions streams carry dense event times over the same axis.
"""
from __future__ import annotations

import numpy as np

DOL_TO_EUR = 0.9


def synth_bids(n_bids: int, n_auctions: int = 1000, seed: int = 7,
               ts_start: int = 0):
    """Columnar synthetic bid stream (NEXMark generator analogue)."""
    rng = np.random.default_rng(seed)
    return {
        "auction": rng.integers(0, n_auctions, n_bids, dtype=np.int64),
        "bidder": rng.integers(0, 10_000, n_bids, dtype=np.int64),
        "price": rng.integers(1, 10_000, n_bids).astype(np.float64),
        "ts": ts_start + np.arange(n_bids, dtype=np.int64),
    }


def bid_batches(n_bids: int, batch_size: int = 65_536,
                n_auctions: int = 1000, seed: int = 7):
    """BatchSource body emitting the synthetic bid stream as
    TupleBatches keyed by auction (price in the value column)."""
    from ..core.tuples import TupleBatch

    pool = synth_bids(batch_size, n_auctions, seed)
    state = {"sent": 0}

    def source(ctx):
        i = state["sent"]
        if i >= n_bids:
            return None
        n = min(batch_size, n_bids - i)
        ts = i + pool["ts"][:n]
        state["sent"] = i + n
        return TupleBatch({
            "key": pool["auction"][:n], "id": ts, "ts": ts,
            "value": pool["price"][:n],
            "bidder": pool["bidder"][:n],
        })

    return source


def q1_currency(batch):
    """Q1: dollar -> euro conversion (BatchMap body)."""
    return batch.with_cols(value=batch["value"] * DOL_TO_EUR)


def make_q2_selection(auction_ids):
    """Q2: keep only bids on the given auctions (BatchFilter body)."""
    wanted = np.asarray(sorted(auction_ids), dtype=np.int64)

    def q2(batch):
        return np.isin(batch.key, wanted)

    return q2


def build_q5_hot_items(graph, n_bids: int, win_len: int, slide_len: int,
                       sink, n_auctions: int = 1000,
                       batch_size: int = 65_536, device_batch: int = 4096,
                       parallelism: int = 1, inflight_depth: int = None,
                       placement: str = "device"):
    """Q5: per-auction bid counts over sliding time windows.  The
    'hottest item' reduction is the sink's fold (max over each window
    epoch); the windowed counts are the device-parallel part.
    ``placement`` feeds the cost-based planner (docs/PLANNER.md):
    'auto' lets it pick the device or host lane per measured costs."""
    from ..core.basic import WinType
    from ..operators.basic_ops import Sink
    from ..operators.batch_ops import BatchSource
    from ..operators.tpu.farms_tpu import KeyFarmTPU

    from ..operators.tpu.win_seq_tpu import DEFAULT_INFLIGHT_DEPTH
    counter = KeyFarmTPU("count", win_len, slide_len, WinType.TB,
                         parallelism=parallelism, batch_len=device_batch,
                         name="q5_counts", emit_batches=True,
                         inflight_depth=(inflight_depth
                                         or DEFAULT_INFLIGHT_DEPTH),
                         placement=placement)
    graph.add_source(BatchSource(
        bid_batches(n_bids, batch_size, n_auctions))) \
        .add(counter).add_sink(Sink(sink, name="q5_sink"))
    return graph


# -- NEXMark's own generator law and Q5 as the Nexmark suite runs it -------

PERSON, AUCTION, BID = 0, 1, 2
_M32 = 0xFFFFFFFF
# multipliers below 2^31: a 32-bit value times one stays below 2^63, so
# the law holds alike in any int64 implementation of it
_C1, _C2 = 0x7FEB352D, 0x1B873593


def mix32(x):
    """A 32-bit integer hash (xor-shift-multiply) of an integer in
    [0, 2^32)."""
    x ^= x >> 16
    x = (x * _C1) & _M32
    x ^= x >> 15
    x = (x * _C2) & _M32
    return x ^ (x >> 16)


def _mix32_u32(x: np.ndarray) -> np.ndarray:
    """``mix32`` of a uint32 array, in place (uint32 products wrap
    modulo 2^32, which is the mask)."""
    x ^= x >> 16
    x *= np.uint32(_C1)
    x ^= x >> 15
    x *= np.uint32(_C2)
    x ^= x >> 16
    return x


def seed_words(seed: int, stream: int) -> tuple:
    """The two 32-bit words that key draw stream ``stream`` of
    ``seed``."""
    seed &= (1 << 64) - 1
    s1 = mix32((seed & _M32) ^ ((0x9E3779B9 * (stream + 1)) & _M32))
    return s1, mix32(((seed >> 32) & _M32) ^ s1)


class NexmarkGenerator:
    """NEXMark's events by the law of Beam's Nexmark generator
    (``NexmarkConfiguration`` defaults, ``BidGenerator``,
    ``AuctionGenerator``), each event a function of its index and the
    seed.  Event ``n`` is at event time ``n`` (units of 1/rate s);
    events come as ``proportions`` persons, auctions and bids in every
    period of ``sum(proportions)``.  A bid goes to the hot auction (the
    newest auction id rounded down to a multiple of
    ``hot_auction_stride``) when its coin falls so, with probability
    1 - 1/``hot_auction_ratio``, else uniformly to one of the
    ``in_flight_auctions`` newest auctions or the ``auction_id_lead`` ids
    after them.  The coin and the choice are 32-bit hashes of the event
    index keyed by the seed (draw streams 0 and 1).  The rest of a bid
    comes from seeded tables indexed by the event index modulo
    ``ROWS`` (a whole number of periods): its bidder, uniform over the
    ``active_people`` newest persons; its price, Beam's
    ``round(10^(6u) * 100)`` cents; its text fields (channel, url,
    extra) at the widths ``text_bytes``.

    ``columns(first, n)`` gives events [first, first + n) as columns:
    ``event_type``, ``key`` (a bid's auction), ``id`` (the index),
    ``ts`` (dateTime), ``bidder``, ``price`` and the text columns;
    persons and auctions carry only ``event_type``, ``id`` and ``ts``
    (zeros and empty text elsewhere)."""

    TEXT = ("channel", "url", "extra")
    PERIODS = 8192              # the tables' rows: PERIODS periods

    def __init__(self, seed: int, proportions=(1, 3, 46),
                 in_flight_auctions: int = 100, auction_id_lead: int = 10,
                 hot_auction_ratio: int = 2, hot_auction_stride: int = 100,
                 first_auction_id: int = 1000, first_person_id: int = 1000,
                 active_people: int = 1000, text_bytes=(12, 40, 16)):
        self.seed = seed
        self.persons, self.auctions, self.bids = map(int, proportions)
        self.total = self.persons + self.auctions + self.bids
        self.in_flight = int(in_flight_auctions)
        self.lead = int(auction_id_lead)
        self.hot_ratio = int(hot_auction_ratio)
        self.stride = int(hot_auction_stride)
        self.first_auction = int(first_auction_id)
        self.first_person = int(first_person_id)
        self.active_people = int(active_people)
        self.words = [seed_words(seed, k) for k in range(2)]
        # the tables: row r holds the bid fields of every event whose
        # index is r modulo rows; non-bid rows hold zeros
        rows = self.PERIODS * self.total
        self.rows = rows
        self.types = np.tile(np.repeat(
            np.array([PERSON, AUCTION, BID], np.uint8),
            [self.persons, self.auctions, self.bids]), self.PERIODS)
        not_bid = self.types != BID
        rng = np.random.default_rng(seed & ((1 << 64) - 1))
        letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
        self.text = {}
        for name, w in zip(self.TEXT, text_bytes):
            t = letters[rng.integers(0, 26, (rows, w))]
            t[not_bid] = 0
            self.text[name] = t.view(f"S{w}").ravel()
        u = rng.integers(0, 1 << 16, rows) / float(1 << 16)
        self.price = np.where(not_bid, 0, np.round(
            10.0 ** (u * 6.0) * 100.0).astype(np.int64))
        self.bidder_draw = rng.integers(0, 1 << 16, rows).astype(np.int64)
        self._n = -1            # batch length the step tables fit

    def _steps(self, n: int) -> None:
        """Tables over j in [0, n + period): the period of j, and j as
        uint32."""
        if n <= self._n:
            return
        self._q = np.arange(n + self.total, dtype=np.int64) // self.total
        self._j32 = np.arange(n, dtype=np.uint32)
        self._n = n

    def _draw(self, first: int, n: int, words: tuple) -> np.ndarray:
        """The 32-bit draws of events [first, first + n) in the stream
        keyed by ``words``: mix32(mix32(lo ^ w0) ^ hi ^ w1) of each
        index's low and high 32 bits."""
        x = self._j32[:n] + np.uint32(first & _M32)    # wraps: the low bits
        x ^= np.uint32(words[0])
        _mix32_u32(x)
        if (first >> 32) == ((first + n - 1) >> 32):
            x ^= np.uint32(((first >> 32) & _M32) ^ words[1])
        else:
            hi = np.arange(first, first + n, dtype=np.int64) >> 32
            x ^= (hi & _M32).astype(np.uint32) ^ np.uint32(words[1])
        return _mix32_u32(x)

    def columns(self, first: int, n: int) -> dict:
        self._steps(n)
        total = self.total
        off = first % total
        # the period of each event, as an index into per-period tables
        q = self._q[off:off + n]
        period = first // total + np.arange(q[-1] + 1 if n else 0,
                                            dtype=np.int64)
        last = period * self.auctions + self.auctions - 1
        lo = np.maximum(last - self.in_flight, 0)
        span = last - lo + 1 + self.lead
        hot_id = last // self.stride * self.stride
        coin = self._draw(first, n, self.words[0])
        choice = self._draw(first, n, self.words[1])
        hot = (coin.astype(np.int64) * self.hot_ratio) >> 32 > 0
        auction = np.where(hot, hot_id[q],
                           lo[q] + ((choice * span[q]) >> 32))
        r0 = first % self.rows
        sl = slice(r0, r0 + n) if r0 + n <= self.rows else \
            np.arange(first, first + n, dtype=np.int64) % self.rows
        etype = self.types[sl]
        is_bid = etype == BID
        auction += self.first_auction
        auction[~is_bid] = 0
        p_lo = np.maximum(period - self.active_people + 1, 0)
        bidder = self.first_person + p_lo[q] + (
            (self.bidder_draw[sl] * (period - p_lo + 1)[q]) >> 16)
        bidder[~is_bid] = 0
        ids = np.arange(first, first + n, dtype=np.int64)
        cols = {"event_type": etype, "key": auction, "id": ids, "ts": ids,
                "bidder": bidder, "price": self.price[sl]}
        for name, t in self.text.items():
            cols[name] = t[sl]
        return cols


def build_q5_nexmark(graph, source, sink, *, win_len: int, slide_len: int,
                     watermark_lag: int, device_batch: int,
                     inflight_depth: int, record=None):
    """NEXMark Q5 as the Nexmark suite runs it (nexmark-flink q5.sql):
    bids counted per auction in ``HOP(dateTime, slide, win)`` windows
    fired by the watermark ``dateTime - watermark_lag``, then per
    window every auction whose count reaches the window's largest.
    ``source`` gives batches of ``NexmarkGenerator.columns``; ``sink``
    takes the hot rows (``key`` auction, ``id`` window, ``value``
    count).  ``record(batch)``, when given, sees every count batch
    before the hot-items step.  Times are event-time units."""
    from ..core.basic import WinType
    from ..operators.basic_ops import Sink
    from ..operators.batch_ops import BatchFilter, BatchMap, BatchSource
    from ..operators.hot_items import HotItems
    from ..operators.tpu.farms_tpu import KeyFarmTPU

    counts = KeyFarmTPU("count", win_len, slide_len, WinType.TB,
                        batch_len=device_batch, name="q5_counts",
                        emit_batches=True, inflight_depth=inflight_depth)
    pipe = graph.add_source(BatchSource(source, name="q5_source",
                                        watermark_lag=watermark_lag)) \
        .chain(BatchFilter(lambda b: b["event_type"] == BID,
                           name="q5_bids")) \
        .add(counts)
    if record is not None:
        def seen(batch):
            record(batch)
            return batch
        pipe = pipe.add(BatchMap(seen, name="q5_record"))
    pipe.add(HotItems(win_len, slide_len, name="q5_hot_items")) \
        .add_sink(Sink(sink, name="q5_sink"))
    return graph


def build_q7_highest_bid(graph, n_bids: int, win_len: int, sink,
                         n_auctions: int = 1000,
                         batch_size: int = 65_536,
                         device_batch: int = 4096,
                         inflight_depth: int = None,
                         placement: str = "device"):
    """Q7: highest price per tumbling window across ALL bids.  Bids are
    funneled onto one key (the reference expresses global windows the
    same way: a single keyed substream), Q1-converted first."""
    from ..core.tuples import TupleBatch
    from ..operators.basic_ops import Sink
    from ..operators.batch_ops import BatchMap, BatchSource
    from ..operators.tpu.win_seq_tpu import WinSeqTPU
    from ..core.basic import WinType

    def to_global_key(batch):
        return TupleBatch({
            "key": np.zeros(len(batch), np.int64),
            "id": batch.id, "ts": batch.ts,
            "value": batch["value"] * DOL_TO_EUR,
        })

    from ..operators.tpu.win_seq_tpu import DEFAULT_INFLIGHT_DEPTH
    op = WinSeqTPU("max", win_len, win_len, WinType.TB,
                   batch_len=device_batch, name="q7_max",
                   inflight_depth=inflight_depth or DEFAULT_INFLIGHT_DEPTH,
                   placement=placement)
    graph.add_source(BatchSource(
        bid_batches(n_bids, batch_size, n_auctions))) \
        .chain(BatchMap(to_global_key)) \
        .add(op).add_sink(Sink(sink, name="q7_sink"))
    return graph


# ---------------------------------------------------------------------------
# Relational queries on the event-time plane (eventtime/;
# docs/EVENTTIME.md): Q3 / Q4 / Q6 / Q8
# ---------------------------------------------------------------------------

def synth_persons(n: int, n_cities: int = 10, seed: int = 11,
                  ts_stride: int = 3):
    """Synthetic person registrations: person ids dense (= join key for
    Q3/Q8), a city attribute, event time ``i * ts_stride``."""
    rng = np.random.default_rng(seed)
    return {
        "person": np.arange(n, dtype=np.int64),
        "city": rng.integers(0, n_cities, n, dtype=np.int64),
        "ts": np.arange(n, dtype=np.int64) * ts_stride,
    }


def synth_auctions(n: int, n_sellers: int = 100, n_categories: int = 8,
                   seed: int = 13, ts_stride: int = 2):
    """Synthetic auction openings: auction ids dense, a seller drawn
    from the person id space, a category, event time ``i * ts_stride``."""
    rng = np.random.default_rng(seed)
    return {
        "auction": np.arange(n, dtype=np.int64),
        "seller": rng.integers(0, n_sellers, n, dtype=np.int64),
        "category": rng.integers(0, n_categories, n, dtype=np.int64),
        "ts": np.arange(n, dtype=np.int64) * ts_stride,
    }


def _record_source(keys, tss, values, every: int = 32,
                   skew: float = None):
    """Watermarked shipper-style source over parallel arrays (one
    record per step; the event-time queries are record-plane)."""
    from ..core.tuples import BasicRecord
    from ..eventtime import watermarked

    n = len(keys)
    state = {"i": 0}

    def body(shipper):
        i = state["i"]
        if i >= n:
            return False
        shipper.push(BasicRecord(int(keys[i]), i, int(tss[i]), values[i]))
        state["i"] = i + 1
        return True

    if skew is None:
        skew = 0.0
    return watermarked(body, every=every, skew=skew)


def build_q3_local_items(graph, persons, auctions, sink,
                         cities=(0, 1), category: int = 2,
                         parallelism: int = 1):
    """Q3: for persons in ``cities``, the auctions of category
    ``category`` they sell -- an incremental full-history join
    (persons |><| auctions on seller; unbounded IntervalJoin, so
    neither side is ever evicted).  Sinked records: key = person id,
    value = (city, auction id)."""
    from ..builders.builders import SourceBuilder
    from ..eventtime import LEFT, RIGHT, IntervalJoin, tag_side
    from ..operators.basic_ops import Sink

    p_keep = np.isin(persons["city"], np.asarray(cities, dtype=np.int64))
    a_keep = auctions["category"] == category
    pp = graph.add_source(SourceBuilder(_record_source(
        persons["person"][p_keep], persons["ts"][p_keep],
        persons["city"][p_keep])).build())
    pa = graph.add_source(SourceBuilder(_record_source(
        auctions["seller"][a_keep], auctions["ts"][a_keep],
        auctions["auction"][a_keep])).build())
    pp.chain(tag_side(LEFT))
    pa.chain(tag_side(RIGHT))
    merged = pp.merge(pa)
    merged.add(IntervalJoin(float("-inf"), float("inf"),
                            join_fn=lambda city, auc: (int(city),
                                                       int(auc)),
                            parallelism=parallelism, name="q3_join"))
    merged.add_sink(Sink(sink, name="q3_sink"))
    return graph


def q3_oracle(persons, auctions, cities=(0, 1), category: int = 2):
    """Numpy oracle / eager baseline twin for Q3: the sorted multiset
    of (person, city, auction) matches."""
    p_keep = np.isin(persons["city"], np.asarray(cities, dtype=np.int64))
    a_keep = auctions["category"] == category
    by_seller = {}
    for pid, city in zip(persons["person"][p_keep],
                         persons["city"][p_keep]):
        by_seller.setdefault(int(pid), []).append(int(city))
    out = []
    for seller, auc in zip(auctions["seller"][a_keep],
                           auctions["auction"][a_keep]):
        for city in by_seller.get(int(seller), ()):
            out.append((int(seller), city, int(auc)))
    return sorted(out)


def _closing_price_agg(pairs):
    """Q4/Q6 window aggregate over (auction, price) pairs: closing
    price = max bid per auction, averaged over the auctions seen."""
    best = {}
    for auc, price in pairs:
        if auc not in best or price > best[auc]:
            best[auc] = price
    return sum(best.values()) / len(best)


def _build_auction_bid_join(graph, auctions, bids, win_len,
                            out_key, parallelism):
    """Shared Q4/Q6 front: auctions |><| bids on auction id per
    tumbling window; the joined record carries ((re-key attr),
    (auction, price)) so the downstream window can re-key."""
    from ..builders.builders import SourceBuilder
    from ..eventtime import LEFT, RIGHT, WindowJoin, tag_side

    # left value = the re-key attribute (category or seller)
    pa = graph.add_source(SourceBuilder(_record_source(
        auctions["auction"], auctions["ts"],
        auctions[out_key])).build())
    pb = graph.add_source(SourceBuilder(_record_source(
        bids["auction"], bids["ts"], bids["price"])).build())
    pa.chain(tag_side(LEFT))
    pb.chain(tag_side(RIGHT))
    merged = pa.merge(pb)
    merged.add(WindowJoin(
        win_len, join_fn=lambda attr, price: (int(attr), float(price)),
        parallelism=parallelism, name="ab_join"))
    return merged


def _rekey_joined(merged, name):
    """Re-key the joined (attr, price) record stream by attr, keeping
    (auction-key, price) as the value for the closing-price agg."""
    from ..operators.basic_ops import FlatMap
    from ..core.tuples import BasicRecord

    def rekey(rec, shipper):
        attr, price = rec.value
        shipper.push(BasicRecord(attr, rec.id, rec.ts,
                                 (rec.key, price)))
    merged.chain(FlatMap(rekey, name=name))
    return merged


def build_q4_avg_price(graph, auctions, bids, win_len, sink,
                       parallelism: int = 1):
    """Q4: average closing price per CATEGORY over tumbling windows.
    auctions |><| bids on auction id per window, closing price =
    per-auction max, averaged per category.  Sinked records:
    key = category, ts = window start, value = average."""
    from ..eventtime import EventTimeWindow
    from ..operators.basic_ops import Sink

    merged = _build_auction_bid_join(graph, auctions, bids, win_len,
                                     "category", parallelism)
    _rekey_joined(merged, "q4_by_category")
    merged.add(EventTimeWindow(_closing_price_agg, win_len,
                               parallelism=parallelism,
                               name="q4_avg"))
    merged.add_sink(Sink(sink, name="q4_sink"))
    return graph


def build_q6_avg_seller(graph, auctions, bids, win_len, sink,
                        parallelism: int = 1):
    """Q6: average selling price per SELLER over tumbling windows --
    the Q4 join re-keyed by seller.  Sinked records: key = seller,
    ts = window start, value = average closing price."""
    from ..eventtime import EventTimeWindow
    from ..operators.basic_ops import Sink

    merged = _build_auction_bid_join(graph, auctions, bids, win_len,
                                     "seller", parallelism)
    _rekey_joined(merged, "q6_by_seller")
    merged.add(EventTimeWindow(_closing_price_agg, win_len,
                               parallelism=parallelism,
                               name="q6_avg"))
    merged.add_sink(Sink(sink, name="q6_sink"))
    return graph


def _q4q6_oracle(auctions, bids, win_len, attr):
    """Shared Q4/Q6 oracle: {(attr, win_start): avg closing price}
    where a (auction, bid) pair joins when both land in the window."""
    a_wins = {}
    for auc, at, ts in zip(auctions["auction"], auctions[attr],
                           auctions["ts"]):
        a_wins[(int(auc), int(ts) // win_len * win_len)] = int(at)
    best = {}
    for auc, price, ts in zip(bids["auction"], bids["price"],
                              bids["ts"]):
        w = int(ts) // win_len * win_len
        at = a_wins.get((int(auc), w))
        if at is None:
            continue
        k = (at, w, int(auc))
        if k not in best or price > best[k]:
            best[k] = float(price)
    sums = {}
    for (at, w, _auc), price in best.items():
        s = sums.setdefault((at, w), [0.0, 0])
        s[0] += price
        s[1] += 1
    return {k: v[0] / v[1] for k, v in sums.items()}


def q4_oracle(auctions, bids, win_len):
    return _q4q6_oracle(auctions, bids, win_len, "category")


def q6_oracle(auctions, bids, win_len):
    return _q4q6_oracle(auctions, bids, win_len, "seller")


def build_q8_new_users(graph, persons, auctions, win_len, sink,
                       parallelism: int = 1, source_of=None):
    """Q8: monitor new users -- persons who registered AND opened an
    auction in the same tumbling window (persons |><| auctions
    re-keyed by seller).  Sinked records: key = person id, ts =
    window start, value = (city, auction id).  ``source_of(keys, tss,
    values)`` overrides the watermarked record source -- bench.py
    injects stamped sources to measure watermark-to-result latency."""
    from ..builders.builders import SourceBuilder
    from ..eventtime import LEFT, RIGHT, WindowJoin, tag_side
    from ..operators.basic_ops import Sink

    if source_of is None:
        source_of = _record_source
    pp = graph.add_source(SourceBuilder(source_of(
        persons["person"], persons["ts"], persons["city"])).build())
    pa = graph.add_source(SourceBuilder(source_of(
        auctions["seller"], auctions["ts"],
        auctions["auction"])).build())
    pp.chain(tag_side(LEFT))
    pa.chain(tag_side(RIGHT))
    merged = pp.merge(pa)
    merged.add(WindowJoin(
        win_len, join_fn=lambda city, auc: (int(city), int(auc)),
        parallelism=parallelism, name="q8_join"))
    merged.add_sink(Sink(sink, name="q8_sink"))
    return graph


def q8_oracle(persons, auctions, win_len):
    """Numpy oracle / baseline twin for Q8: sorted multiset of
    (person, win_start, city, auction)."""
    by_pw = {}
    for pid, city, ts in zip(persons["person"], persons["city"],
                             persons["ts"]):
        w = int(ts) // win_len * win_len
        by_pw.setdefault((int(pid), w), []).append(int(city))
    out = []
    for seller, auc, ts in zip(auctions["seller"],
                               auctions["auction"], auctions["ts"]):
        w = int(ts) // win_len * win_len
        for city in by_pw.get((int(seller), w), ()):
            out.append((int(seller), w, city, int(auc)))
    return sorted(out)


# eager baseline twins for the bench gate (tools/bench_gate.py): the
# oracles ARE the single-threaded reference implementations, exposed
# under the twin names the bench rows cite
q3_baseline = q3_oracle
q4_baseline = q4_oracle
q6_baseline = q6_oracle
q8_baseline = q8_oracle
