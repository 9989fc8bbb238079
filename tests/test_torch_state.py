"""The port's tiered keyed state (windflow_tpu_torch/state/), replica
supervision and delta-lane recovery held against the reference's
(tests/test_state_tiers.py, tests/test_supervision.py,
tests/test_state_recovery.py, tests/test_durability_delta.py):

* the spill store, the budget ladder and the tiered store: the same
  operations through both packages give the same tiers, counters,
  bytes and answers;
* graphs: a tiered graph equal to the all-hot graph; a delta-lane clean
  run and a crash restart; a torn delta chain falling back with
  ``blob_missing``; a supervised heal in place; a kill-restart while
  the store spills; a full disk that aborts commits and recovers;
  a delta-lane restore into another parallelism.

Every durable graph drives its own epochs at fixed stream indices
(``torch_graphs.gated_source``) and is held to the closed-form oracle
and to the reference's sink output of the same graph without epochs.
"""
import importlib
import json
import os
import pickle
import warnings

import pytest

from torch_graphs import (PACKAGES, PORT, Effects, acc_graph, acc_oracle,
                          assert_ledger_exact, effects_per_key, mod,
                          reference_clean)

REF = PACKAGES[0]


# ---------------------------------------------------------------------------
# spill store, budget, tiered store
# ---------------------------------------------------------------------------

def _tier_store(pkg, root, limit, flight=None, dead=None, **kw):
    st = mod(pkg, "state")
    kw.setdefault("maintain_every", 4)
    kw.setdefault("spill_batch", 8)
    return st.TieredKeyedStore(st.StateBudget(limit),
                               st.SpillStore(str(root)), node="acc.0",
                               flight=flight, dead_letters=dead, **kw)


def _spill_trace(pkg, root):
    SpillStore = mod(pkg, "state").SpillStore
    s = SpillStore(str(root))
    batch = {k: pickle.dumps(k * 2) for k in range(10)}
    nbytes = s.put_batch(batch)
    names = sorted(n for n in os.listdir(s.root) if n.endswith(".spill"))
    got = (nbytes, len(s), pickle.loads(s.get(3)), s.get(99),
           dict(s.items_pickled()) == batch, names)
    for k in range(9):
        s.discard(k)
    compacted = s.compact()
    return got + (compacted > 0, pickle.loads(s.get(9)), len(s))


def test_spill_store_matches_reference(tmp_path):
    port = _spill_trace(PORT, tmp_path / "port")
    assert port == _spill_trace(REF, tmp_path / "ref")
    assert port[1] == 10 and port[2] == 6 and port[-1] == 1


@pytest.mark.parametrize("pkg", PACKAGES)
def test_spill_torn_segment_detected_and_working_set_wiped(pkg, tmp_path):
    SpillStore = mod(pkg, "state").SpillStore
    root = tmp_path / "sp"
    s = SpillStore(str(root))
    s.put_batch({1: pickle.dumps("a"), 2: pickle.dumps("b")})
    s._cache.clear()
    with open(next(iter(s._seg_path.values())), "r+b") as f:
        f.truncate(8)
    with pytest.raises(RuntimeError, match="digest"):
        s.get(1)
    (root / "orphan.tmp").write_bytes(b"half a segment")
    assert len(SpillStore(str(root))) == 0
    assert not [n for n in os.listdir(root)
                if n.endswith(".spill") or n.endswith(".tmp")]


def test_budget_ladder_matches_reference():
    rows = {}
    for pkg in PACKAGES:
        b = mod(pkg, "state").StateBudget(1000)
        rows[pkg] = ((b.demote_at, b.spill_at),
                     [b.pressure(x) for x in (100, 750, 900, 1001)])
    assert rows[PORT] == rows[REF] == ((700, 850),
                                       ["ok", "demote", "spill", "shed"])


def _tier_trace(pkg, root):
    """Demote, spill, promote, delete, pin and census one store."""
    st = _tier_store(pkg, root, 3000)
    st.bind_hot_sketch(lambda: {0, 1})
    blob = "x" * 64
    for k in range(40):
        st[k] = (k, blob)
        st.get(0), st.get(1)
    st.maintain()
    tiers = [st.tier_of(k) for k in range(40)]
    cold = [k for k in range(40) if tiers[k] == "cold"]
    head = (tiers, st.demotions, st.spilled_keys, st.mem_bytes())
    read = st[cold[0]]
    after = (st.tier_of(cold[0]), st.promotions)
    del st[cold[1]]
    total, mem, extras = st.census()
    pickled = st.keyed_state_pickled()
    return head + (read, after, len(st), sorted(st.keys()), total, mem,
                   extras["tiers"], extras["spills"],
                   {k: pickle.loads(v) for k, v in pickled.items()})


def test_tier_transitions_match_reference(tmp_path):
    port = _tier_trace(PORT, tmp_path / "port")
    assert port == _tier_trace(REF, tmp_path / "ref")
    tiers, demotions, spilled, mem = port[:4]
    assert "cold" in tiers and demotions > 0 and spilled > 0
    assert mem <= 3000 and tiers[0] == tiers[1] == "hot"
    assert port[5][0] == "hot" and port[5][1] >= 1     # promoted
    assert port[6] == 39


def _shed_trace(pkg, root):
    FlightRecorder = mod(pkg, "telemetry.recorder").FlightRecorder
    dead = mod(pkg, "resilience.policies").DeadLetterStore()
    FaultPlan = mod(pkg, "resilience").FaultPlan
    flight = FlightRecorder(64)
    st = _tier_store(pkg, root, 1500, flight=flight, dead=dead)
    st.spill.fault_plan = FaultPlan(seed=1).fail_write(
        "spill", at_write=1, count=10_000)
    for k in range(60):
        st[k] = "v" * 200
    st.maintain()
    kinds = sorted({e["kind"] for e in flight.snapshot()})
    return st.sheds, dead.count(), st.mem_bytes(), kinds


def test_shed_past_budget_matches_reference(tmp_path):
    port = _shed_trace(PORT, tmp_path / "port")
    assert port == _shed_trace(REF, tmp_path / "ref")
    assert port[0] > 0 and port[1] == port[0] and port[2] <= 2000
    assert {"spill_abort", "state_pressure"} <= set(port[3])


@pytest.mark.parametrize("pkg", PACKAGES)
def test_replace_all_wipes_every_tier(pkg, tmp_path):
    st = _tier_store(pkg, tmp_path / "sp", 2000)
    for k in range(40):
        st[k] = "v" * 100
    st.maintain()
    assert len(st.spill) > 0
    st.replace_all({"a": 1, "b": 2})
    assert dict(st.items()) == {"a": 1, "b": 2} and len(st.spill) == 0
    st.clear()
    assert len(st) == 0


# ---------------------------------------------------------------------------
# graphs
# ---------------------------------------------------------------------------

N = 4000
EPOCHS_AT = (1000, 2000, 3000)


def _reference_clean(tmp_path, n=N, n_keys=4):
    return reference_clean(str(tmp_path / "ref_clean"), n, n_keys)


def _exactly_once(rows, ref, n=N, n_keys=4):
    assert len(rows) == n and len(set(rows)) == n, (len(rows), n)
    got = effects_per_key(rows)
    assert got == acc_oracle(n, n_keys) == ref


def _epochs(factory, **kw):
    return mod(PORT, "durability").run_with_epochs(factory, max_restarts=2,
                                                   **kw)


def _chains(path):
    store = mod(PORT, "durability").EpochStore(path)
    e, _ = store.latest()
    raw = store._load_raw(e)
    return store, [v for v in raw["states"].values()
                   if isinstance(v, dict) and "keyed_chain" in v]


def test_delta_lane_clean_run(tmp_path):
    eff = Effects()
    path = str(tmp_path / "epochs")
    g = acc_graph(PORT, N, path, eff, epochs_at=EPOCHS_AT, delta=True)
    g.run()
    _exactly_once(eff.rows, _reference_clean(tmp_path))
    assert_ledger_exact(g)
    assert g.durability.delta and g.durability.commits == 4
    store, chains = _chains(path)
    assert chains and store.blobs.digests_on_disk()
    block = json.loads(g.stats.to_json())["Durability"]
    assert block["Delta"] and block["Last_commit_bytes"] > 0


def test_delta_lane_crash_restart(tmp_path):
    FaultPlan = mod(PORT, "resilience").FaultPlan
    eff = Effects()

    def factory(attempt):
        plan = (FaultPlan(seed=3).crash_replica("accumulator",
                                                at_tuple=1200)
                if attempt == 0 else None)
        return acc_graph(PORT, N, str(tmp_path / "epochs"), eff,
                         plan=plan, epochs_at=EPOCHS_AT, delta=True)

    g = _epochs(factory)
    assert g._epoch_restored == 2
    _exactly_once(eff.rows, _reference_clean(tmp_path))
    assert_ledger_exact(g)
    assert g.durability.committed > g._epoch_restored


def _newest_only_blob(store):
    from windflow_tpu_torch.durability.delta import chain_refs
    epochs = store._epochs_on_disk()
    newest = {r.digest for r in chain_refs(
        store._load_raw(epochs[-1])["states"])}
    older = set()
    for e in epochs[:-1]:
        older |= {r.digest for r in chain_refs(
            store._load_raw(e)["states"])}
    only = sorted(newest - older)
    assert only, "the newest manifest shares every blob"
    return epochs[-1], only[0]


def test_torn_delta_chain_falls_back_with_blob_missing(tmp_path):
    dur = mod(PORT, "durability")
    FaultPlan = mod(PORT, "resilience").FaultPlan
    path = str(tmp_path / "epochs")
    sink = dur.EpochTaggedStore()
    torn = {}

    def factory(attempt):
        if attempt == 1:
            # after the crash, before recovery reads the manifests: a
            # blob only the newest chain references goes missing
            st = dur.EpochStore(path)
            torn["epoch"], digest = _newest_only_blob(st)
            st.blobs.unlink(digest)
        plan = (FaultPlan(seed=13).crash_replica("accumulator",
                                                 at_tuple=1600)
                if attempt == 0 else None)
        return acc_graph(PORT, N, path, sink, plan=plan,
                         epochs_at=EPOCHS_AT, delta=True,
                         sink_mode="idempotent")

    g = _epochs(factory,
                on_restore=lambda g_, e, payload: sink.truncate_above(e))
    assert torn["epoch"] == 3 and g._epoch_restored == 2
    aborts = [e for e in g.flight.snapshot()
              if e["kind"] == "epoch_abort"
              and e.get("reason") == "blob_missing"]
    assert aborts and aborts[0]["epoch"] == 3
    rows = [(r.key, r.id, r.value) for r in sink.items()]
    assert len(rows) == N and len(set(rows)) == N
    got = {k: sorted(v) for k, v in effects_per_key(rows).items()}
    assert got == acc_oracle(N) == _reference_clean(tmp_path)


def test_supervised_crash_heals_in_place(tmp_path):
    """A poison tuple (key 1, id 600: stream index 2401, after epochs 1
    and 2 committed) kills one accumulator replica once; the supervisor
    rebuilds it in place from epoch 2 and the run ends exactly once."""
    SupervisionConfig = mod(PORT, "core.basic").SupervisionConfig
    crashed = []

    def acc(t, a):
        if t.id == 600 and t.key == 1 and not crashed:
            crashed.append(1)
            raise RuntimeError("injected poison tuple")
        a.value += t.value

    eff = Effects()
    g = acc_graph(PORT, N, str(tmp_path / "epochs"), eff,
                  epochs_at=EPOCHS_AT, acc_fn=acc, restartable=True,
                  cfg_kw={"supervision": SupervisionConfig(
                      max_restarts=3, seed=7)})
    g.run()
    assert crashed
    _exactly_once(eff.rows, _reference_clean(tmp_path))
    assert_ledger_exact(g, healed=True)
    assert g._supervisor.heals == 1
    evs = [e for e in g.flight.snapshot() if e["kind"] == "replica_restart"]
    assert len(evs) == 1
    ev = evs[0]
    assert ev["group"] == "pipe0/accumulator" and ev["epoch"] == 2
    assert "injected poison tuple" in ev["error"]
    assert g.durability.committed > ev["epoch"]
    assert json.loads(g.stats.to_json())["Durability"][
        "Replica_restarts"] == 1


@pytest.mark.parametrize("pkg", PACKAGES)
def test_supervision_needs_the_durability_plane(pkg, tmp_path):
    SupervisionConfig = mod(pkg, "core.basic").SupervisionConfig
    g = acc_graph(pkg, 10, None, lambda r: None, durable=False,
                  restartable=True,
                  cfg_kw={"supervision": SupervisionConfig()})
    with pytest.raises(RuntimeError, match="durability"):
        g.run()


WIDE_KEYS, WIDE_N = 120, 6000
WIDE_EPOCHS = (1500, 3000, 4500)


def _tiered(tmp_path, eff, plan=None, budget=5_000):
    return acc_graph(PORT, WIDE_N, str(tmp_path / "epochs"), eff, plan=plan,
                     epochs_at=WIDE_EPOCHS, n_keys=WIDE_KEYS,
                     cfg_kw={"state_budget_bytes": budget,
                             "log_dir": str(tmp_path / "log")})


def _spills(g):
    stores = g.tiered_state.stores.values()
    return (sum(s.spilled_keys for s in stores),
            sum(s.sheds for s in stores))


def test_kill_restart_mid_spill(tmp_path):
    FaultPlan = mod(PORT, "resilience").FaultPlan
    eff = Effects()

    def factory(attempt):
        return _tiered(tmp_path, eff, FaultPlan(seed=5).crash_replica(
            "accumulator", at_tuple=2000) if attempt == 0 else None)

    g = _epochs(factory)
    assert g._epoch_restored == 2
    _exactly_once(eff.rows, _reference_clean(tmp_path, WIDE_N, WIDE_KEYS),
                  WIDE_N, WIDE_KEYS)
    assert_ledger_exact(g)
    spills, sheds = _spills(g)
    assert spills > 0 and sheds == 0


def test_disk_full_commits_degrade_and_recover(tmp_path):
    """Manifest writes 2-4 fail with ENOSPC: those epochs abort with
    ``disk_full``, the graph stays up, and the later commits release
    every buffered effect exactly once.  (The reference test of this
    name fails on its ledger identity, ROADMAP.md C2: its aligner
    counts re-parked barriers again.)"""
    FaultPlan = mod(PORT, "resilience").FaultPlan
    eff = Effects()
    epochs_at = tuple(range(500, WIDE_N, 500))
    g = acc_graph(PORT, WIDE_N, str(tmp_path / "epochs"), eff,
                  plan=FaultPlan(seed=11).fail_write("manifest",
                                                     at_write=2, count=3),
                  epochs_at=epochs_at, n_keys=WIDE_KEYS,
                  cfg_kw={"state_budget_bytes": 5_000,
                          "log_dir": str(tmp_path / "log")})
    g.run()
    _exactly_once(eff.rows, _reference_clean(tmp_path, WIDE_N, WIDE_KEYS),
                  WIDE_N, WIDE_KEYS)
    assert_ledger_exact(g)
    evs = [e for e in g.flight.snapshot()
           if e["kind"] == "epoch_abort" and e.get("reason") == "disk_full"]
    assert [e["epoch"] for e in evs] == [2, 3, 4]
    assert g.durability.aborts == 3
    assert all("injected" in e["error"] for e in evs)
    assert g.durability.committed > 4
    from windflow_tpu_torch.diagnosis.report import build_report
    rep = build_report(json.loads(g.stats.to_json()),
                       flight=g.flight.snapshot())
    assert "DISK FULL" in rep["Verdict"]


def _keyed_graph(pkg, n, n_keys, budget, sunk, log_dir):
    wf = importlib.import_module(pkg)
    BasicRecord = mod(pkg, "core").BasicRecord
    state = {"i": 0}

    def src(shipper, ctx=None):
        i = state["i"]
        if i >= n:
            return False
        shipper.push(BasicRecord(i % n_keys, i // n_keys, i, float(i)))
        state["i"] = i + 1
        return True

    def fold(t, a):
        a.value += t.value

    cfg = wf.RuntimeConfig(audit_interval_s=0.05, state_budget_bytes=budget,
                           log_dir=log_dir)
    if pkg == PORT:
        cfg.device = "cpu"
    g = wf.PipeGraph("tiers", wf.Mode.DEFAULT, config=cfg)
    g.add_source(wf.SourceBuilder(src).build()) \
        .add(wf.AccumulatorBuilder(fold)
             .with_initial_value(BasicRecord(value=0.0))
             .with_parallelism(2).build()) \
        .add_sink(wf.SinkBuilder(
            lambda r: sunk.append((r.key, r.id, r.value))
            if r is not None else None).build())
    return g


def test_tiered_graph_equals_all_hot(tmp_path):
    n, n_keys = 20_000, 400
    runs = {}
    for pkg, budget in ((REF, None), (PORT, None), (PORT, 30_000)):
        sunk = []
        g = _keyed_graph(pkg, n, n_keys, budget, sunk,
                         str(tmp_path / f"{pkg}{budget}"))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            g.run()
        runs[(pkg, budget)] = (sorted(sunk), g)
    tiered, g = runs[(PORT, 30_000)]
    assert len(tiered) == n
    assert tiered == runs[(PORT, None)][0] == runs[(REF, None)][0]
    assert runs[(PORT, None)][1].tiered_state is None
    spills, sheds = _spills(g)
    assert spills > 0 and sheds == 0
    rows = (json.loads(g.stats.to_json()).get("Skew") or {}).get(
        "Census") or []
    assert rows and all("tiers" in r for r in rows)


def test_delta_restore_into_other_parallelism(tmp_path):
    """The twin of the reference's delta restore into another
    parallelism (tests/test_durability_delta.py): crashed at accumulator
    parallelism 2, restarted at 4, the delta chain resolves to per-key
    entries, which repartition through the elastic hash % n owner; every
    effect once, equal to the reference's clean run, the ledger exact."""
    FaultPlan = mod(PORT, "resilience").FaultPlan
    eff = Effects()
    pars = []

    def factory(attempt):
        par = 2 if attempt == 0 else 4
        pars.append(par)
        plan = (FaultPlan(seed=5).crash_replica("accumulator",
                                                at_tuple=1200)
                if attempt == 0 else None)
        return acc_graph(PORT, N, str(tmp_path / "epochs"), eff,
                         plan=plan, epochs_at=EPOCHS_AT, delta=True,
                         acc_par=par)

    g = _epochs(factory, parallelism_overrides={"accumulator": 4})
    assert pars == [2, 4]
    assert g._epoch_restored == 2
    _exactly_once(eff.rows, _reference_clean(tmp_path))
    ev = [e for e in g.flight.snapshot() if e["kind"] == "epoch_restore"]
    assert ev and ev[-1].get("repartitioned") == ["accumulator"]
    assert g.durability.delta
    assert_ledger_exact(g)
