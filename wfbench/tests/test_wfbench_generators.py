"""The benchmark's YSB generator: the same seed gives the same inputs,
every field has YSB's width and law, event times read back as the
events' times, and the join finds each ad's campaign by its whole id."""
import numpy as np
import pytest

from wfbench_testlib import ROOT, harness

CELL = {"rate": 1000, "source_batch": 5000, "device_batch": 512,
        "inflight": 8}
BIG_SEED = 2 ** 33 + 5


def _ysb(seed, pool=1 << 16):
    d = ROOT / "wfbench" / "configs"
    cfg = harness.load_json(d / "ysb.json")
    cfg["assumed"] = dict(cfg["assumed"], pool_events=pool)
    mod = harness.load_file(d / "ysb.py", "gen_ysb")
    return mod.make_stream(cfg, CELL, seed), cfg, mod


def _same(a, b):
    return all(np.array_equal(a[k], b[k]) for k in a)


def test_wfbench_generator_is_a_function_of_the_seed():
    first, n = 123_457, 20_000
    a = _ysb(BIG_SEED)[0].columns(first, n)
    b = _ysb(BIG_SEED)[0].columns(first, n)
    c = _ysb(BIG_SEED + 1)[0].columns(first, n)
    assert _same(a, b)
    assert not _same(a, c)
    assert np.array_equal(a["id"], np.arange(first, first + n))
    assert np.array_equal(a["ts"], a["id"] + 9 * CELL["rate"])


def test_wfbench_ysb_fields_have_ysb_widths_and_laws():
    s, cfg, mod = _ysb(7)
    cols = s.columns(0, 60_000)
    for name, width in cfg["field_bytes"].items():
        assert cols[name].dtype == np.dtype(f"S{width}"), name
    ids = cols["ad_id"]
    assert all(len(u) == 36 and u.count(b"-") == 4 and u[14:15] == b"4"
               for u in ids[:50])
    assert len(np.unique(cols["user_id"])) == cfg["user_ids"]
    assert len(np.unique(ids)) == cfg["campaigns"] * cfg["ads_per_campaign"]
    types = {t.encode() for t in cfg["event_types"]}
    assert set(np.unique(cols["event_type"])) == types
    assert (cols["ip_address"] == cfg["ip_address"].encode()).all()
    share = (cols["event_type"] == b"view").mean()
    assert abs(share - 1 / 3) < 0.01
    assert np.all(np.bincount(s.campaign_of_ad) == cfg["ads_per_campaign"])


@pytest.mark.parametrize("first,n", [(0, 10), (99_990, 20),
                                     (2 ** 33 + 99_000, 250_000),
                                     ((1 << 16) - 100, 300)])
def test_wfbench_ysb_event_time_reads_back_as_the_time(first, n):
    s, cfg, mod = _ysb(3)
    cols = s.columns(first, n)
    assert np.array_equal(mod.parse_time(cols["event_time"]), cols["ts"])
    assert np.array_equal(cols["event_time"][:1].astype(np.int64),
                          cols["ts"][:1])


def test_wfbench_ysb_pool_wraps_with_event_index():
    s, cfg, mod = _ysb(7, pool=1 << 12)
    wrap = s.columns((1 << 12) - 100, 300)
    again = s.columns(2 * (1 << 12) - 100, 300)
    assert np.array_equal(wrap["ad_id"], again["ad_id"])
    assert not np.array_equal(wrap["event_time"], again["event_time"])


def test_wfbench_ysb_join_looks_up_the_whole_id():
    s, cfg, mod = _ysb(5)
    table = mod.AdCampaigns(s.ad_ids, s.campaign_of_ad)
    ads = s.pool["ad_id"][:5000]
    want = {a: c for a, c in zip(s.ad_ids, s.campaign_of_ad)}
    assert table(ads).tolist() == [want[a] for a in ads]
    # an id that differs in one character of its middle is not found
    bad = ads[:3].copy()
    raw = bad.view(np.uint8).reshape(-1, 36)
    raw[1, 20] = ord("g")
    with pytest.raises(KeyError):
        table(bad)
