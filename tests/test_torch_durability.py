"""The port's durability plane (windflow_tpu_torch/durability/) held
against the reference's (tests/test_durability.py,
tests/test_durability_delta.py):

* the manifest store: the same commits through both packages leave the
  same epochs on disk, the same ``latest()`` and the same pruning; a
  torn newest manifest falls back alike; foreign and newer schemas are
  refused alike;
* the delta encoder: the same keyed states epoch by epoch give the same
  chain (base and link epochs, each link's dirty keys, the same blob
  digests), and ``resolve_chain`` the same keyed state;
* the barrier aligner: alignment, hold-back, the final barrier, and the
  exact barrier count -- the port counts a parked future-epoch barrier
  once, the reference again on each replay (ROADMAP.md C2, a deliberate
  divergence);
* durable graphs (clean, a crash at an epoch, a crash mid-stream, a
  torn commit, an idempotent sink, the fused device-engine segment):
  every result exactly once, equal to a closed-form oracle and to the
  reference's sink output for the same graph run without epochs.

The durable graphs' sources drive their own epochs
(``torch_graphs.gated_source``): each epoch begins at a fixed stream
index and the source waits for its commit, so a fault always lands
after the commit it targets and no assertion depends on wall time.
"""
import collections
import importlib
import os
import pickle

import pytest

from torch_graphs import (PACKAGES, PORT, Effects, acc_graph, acc_oracle,
                          assert_ledger_exact, durable_config, dur_val,
                          effects_per_key, gated_source, mod,
                          reference_clean)

REF = PACKAGES[0]
N = 4000
EPOCHS_AT = (1000, 2000, 3000)


# ---------------------------------------------------------------------------
# manifest store
# ---------------------------------------------------------------------------

def _store_run(pkg, root):
    EpochStore = mod(pkg, "durability").EpochStore
    store = EpochStore(str(root), retained=2)
    sizes = []
    for e in (1, 2, 3, 4):
        path, nbytes = store.commit(
            e, {"n": pickle.dumps({"x": e})}, {"src": e * 10})
        assert os.path.exists(path) and not os.path.exists(path + ".tmp")
        sizes.append(nbytes > 0)
    e, payload = store.latest()
    return (sorted(os.listdir(str(root))), e, payload["offsets"],
            pickle.loads(payload["states"]["n"]), sizes)


def test_epoch_store_commit_and_retention_match_reference(tmp_path):
    ref = _store_run(REF, tmp_path / "ref")
    port = _store_run(PORT, tmp_path / "port")
    assert port == ref
    assert port[0] == ["epoch-000000000003.ckpt", "epoch-000000000004.ckpt"]
    assert port[1:4] == (4, {"src": 40}, {"x": 4})


def _torn_latest(pkg, root):
    EpochStore = mod(pkg, "durability").EpochStore
    FlightRecorder = mod(pkg, "telemetry").FlightRecorder
    store = EpochStore(str(root), retained=4)
    for e in (1, 2, 3):
        store.commit(e, {"n": pickle.dumps({"x": e})}, {"src": e})
    p = store.manifest_path(3)
    blob = open(p, "rb").read()
    with open(p, "wb") as f:
        f.write(blob[:len(blob) // 2])
    flight = FlightRecorder(64)
    e, payload = store.latest(flight=flight)
    aborts = [(ev["reason"], ev["epoch"]) for ev in flight.snapshot()
              if ev["kind"] == "epoch_abort"]
    return e, pickle.loads(payload["states"]["n"]), aborts


def test_epoch_store_truncated_manifest_falls_back_like_reference(tmp_path):
    port = _torn_latest(PORT, tmp_path / "port")
    assert port == _torn_latest(REF, tmp_path / "ref")
    assert port == (2, {"x": 2}, [("manifest_corrupt", 3)])


@pytest.mark.parametrize("pkg", PACKAGES)
def test_epoch_store_refuses_foreign_and_newer_schema(pkg, tmp_path):
    store = mod(pkg, "durability").EpochStore(str(tmp_path / "ep"))
    with open(store.manifest_path(1), "wb") as f:
        pickle.dump({"magic": "something-else"}, f)
    with pytest.raises(RuntimeError, match="not a windflow epoch"):
        store.load(1)
    with open(store.manifest_path(2), "wb") as f:
        pickle.dump({"magic": "windflow-epoch-manifest", "schema": 99,
                     "states": {}}, f)
    with pytest.raises(RuntimeError, match="newer than this runtime"):
        store.load(2)
    # neither is taken for the newest epoch
    assert store.latest() == (None, None)


def test_snapshot_header_and_errors_match_reference(tmp_path):
    from windflow_tpu_torch.utils.checkpoint import (read_snapshot,
                                                     write_snapshot)
    ref = mod(REF, "utils.checkpoint")
    path = str(tmp_path / "s.pkl")
    write_snapshot(path, {"a": {"x": 1}}, epoch=7)
    # the header is the reference's: either package reads the other's
    # plain-typed snapshot
    assert ref.read_snapshot(path) == read_snapshot(path) == {"a": {"x": 1}}
    assert pickle.load(open(path, "rb"))["epoch"] == 7
    blob = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(blob[:len(blob) // 2])
    with pytest.raises(RuntimeError, match="truncated or corrupt"):
        read_snapshot(path)
    with open(path, "wb") as f:
        pickle.dump({"magic": "other-tool"}, f)
    with pytest.raises(RuntimeError, match="not a windflow graph"):
        read_snapshot(path)
    with open(path, "wb") as f:
        pickle.dump({"node": {"x": 2}}, f)
    assert read_snapshot(path) == {"node": {"x": 2}}


# ---------------------------------------------------------------------------
# delta encoder, blob chains, keyed payloads
# ---------------------------------------------------------------------------

def _keyed_epochs(seed=5, n_keys=40, n_epochs=12):
    """Keyed states epoch by epoch from a numpy seed: a few keys change,
    appear or disappear each epoch."""
    import numpy as np
    rng = np.random.default_rng(seed)
    state = {int(k): float(k) for k in range(n_keys)}
    out = []
    for _e in range(n_epochs):
        for k in rng.choice(n_keys, 3, replace=False):
            state[int(k)] = float(rng.integers(0, 1000))
        if rng.random() < 0.3:
            state.pop(int(rng.integers(0, n_keys)), None)
        if rng.random() < 0.3:
            state[int(rng.integers(n_keys, 2 * n_keys))] = 1.0
        out.append(dict(state))
    return out


def _chain_run(pkg, root, states):
    delta = mod(pkg, "durability.delta")
    blobs = delta.BlobStore(str(root))
    enc = delta.DeltaEncoder(chain_max=4)
    trace = []
    for st in states:
        writes = {}
        cap = delta.KeyedCapture({k: pickle.dumps(v)
                                  for k, v in st.items()})
        chain = enc.encode(cap, writes)
        for digest, payload in writes.items():
            blobs.write(digest, payload)
        links = []
        for ref in chain:
            doc = pickle.loads(blobs.read(ref.digest))
            links.append((ref.digest, ref.base, sorted(doc["put"]),
                          sorted(doc["del"])))
        resolved = {k: pickle.loads(v)
                    for k, v in delta.resolve_chain(blobs, chain).items()}
        trace.append((links, sorted(writes), resolved))
    return trace


def test_delta_chain_matches_reference_epoch_by_epoch(tmp_path):
    states = _keyed_epochs()
    port = _chain_run(PORT, tmp_path / "port", states)
    assert port == _chain_run(REF, tmp_path / "ref", states)
    for (links, _writes, resolved), st in zip(port, states):
        assert resolved == st
        assert links[0][1] and not any(base for _d, base, _p, _x
                                       in links[1:])
    # compaction at chain_max 4: some epoch starts a fresh base
    assert any(len(t[0]) == 1 for t in port[1:])


def test_delta_commit_ratio_and_gc_match_reference(tmp_path):
    """1 %-dirty epochs: delta commits >= 10x below full ones in both
    packages, the same full-manifest bytes, and the same blobs survive
    GC.  (A delta manifest pickles its ``BlobRef`` class, whose module
    path names the package, so its bytes differ by that name.)"""
    out = {}
    for pkg in PACKAGES:
        dur = mod(pkg, "durability")
        delta = mod(pkg, "durability.delta")
        full = dur.EpochStore(str(tmp_path / pkg / "full"), retained=3)
        dstore = dur.EpochStore(str(tmp_path / pkg / "delta"), retained=3)
        enc = delta.DeltaEncoder(chain_max=8)
        state = {k: float(k) for k in range(2000)}
        fb, db = [], []
        for e in range(1, 8):
            for k in range(e * 20, e * 20 + 20):
                state[k] += 1.0
            fb.append(full.commit(e, {"acc.0": pickle.dumps(state)},
                                  {"src": e})[1])
            writes = {}
            cap = delta.KeyedCapture({k: pickle.dumps(v)
                                      for k, v in state.items()})
            chain = enc.encode(cap, writes)
            db.append(dstore.commit(e, {"acc.0": {"keyed_chain": chain}},
                                    {"src": e}, blob_writes=writes)[1])
        _, payload = dstore.latest()
        decoded = pickle.loads(payload["states"]["acc.0"])
        assert delta.unpack_keyed(decoded) == state
        assert sum(db[1:]) * 10 <= sum(fb[1:]), (db, fb)
        out[pkg] = (sum(fb[1:]), sorted(dstore.blobs.digests_on_disk()))
    assert out[PORT] == out[REF]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_pack_keyed_round_trips(pkg):
    delta = mod(pkg, "durability.delta")
    entries = {k: pickle.dumps((k, k * 2.0)) for k in range(6)}
    doc = pickle.loads(delta.pack_keyed(entries))
    assert delta.is_keyed_payload(doc)
    assert delta.unpack_keyed(doc) == {k: (k, k * 2.0) for k in range(6)}


def test_resolve_chain_refuses_headless_and_missing_links(tmp_path):
    from windflow_tpu_torch.durability.delta import (BlobRef, BlobStore,
                                                     make_blob,
                                                     resolve_chain)
    import hashlib
    store = BlobStore(str(tmp_path))
    payload = make_blob(False, {1: pickle.dumps(1.0)}, [])
    d = hashlib.sha256(payload).hexdigest()
    store.write(d, payload)
    with pytest.raises(RuntimeError, match="base link missing"):
        resolve_chain(store, [BlobRef(d, len(payload))])
    with pytest.raises(RuntimeError, match="missing or unreadable"):
        resolve_chain(store, [BlobRef("0" * 64, 1, base=True)])


# ---------------------------------------------------------------------------
# barrier aligner
# ---------------------------------------------------------------------------

class _Coord:
    def __init__(self):
        self.snaps = []
        self.acks = []

    def add_snapshot(self, epoch, states):
        self.snaps.append(epoch)

    def sink_ack(self, epoch, name):
        self.acks.append(epoch)


def _sink_node():
    class _Node:
        name = "sink.0"
        outlets = ()
        faults = None
        epoch_barriers_in = 0
        epoch_barriers_out = 0

        class logic:  # stateless, no quiesce/epoch_mark hooks
            pass

        def _emit(self, item):
            raise AssertionError("a sink emits nothing")

    return _Node()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_aligner_holds_back_post_barrier_items(pkg):
    EpochAligner = mod(pkg, "durability.barrier").EpochAligner
    EpochBarrier = mod(pkg, "runtime.queues").EpochBarrier
    node, coord = _sink_node(), _Coord()
    al = EpochAligner(node, coord, n_producers=2)
    seen = []

    def process(cid, item):
        seen.append((cid, item))

    assert not al.offer(0, "a0", process)
    process(0, "a0")
    assert al.offer(0, EpochBarrier(1), process)
    assert al.busy and al.offer(0, "a1", process)   # held back
    assert not al.offer(1, "b0", process)
    process(1, "b0")
    assert al.offer(1, EpochBarrier(1), process)    # completes the cut
    assert not al.busy and coord.acks == [1]
    assert seen == [(0, "a0"), (1, "b0"), (0, "a1")]
    assert node.epoch_barriers_in == 2


@pytest.mark.parametrize("pkg", PACKAGES)
def test_aligner_final_barrier_unblocks_alignment(pkg):
    EpochAligner = mod(pkg, "durability.barrier").EpochAligner
    EpochBarrier = mod(pkg, "runtime.queues").EpochBarrier
    node, coord = _sink_node(), _Coord()
    al = EpochAligner(node, coord, n_producers=2)
    al.offer(0, EpochBarrier(-1, final=True), lambda c, i: None)
    al.offer(1, EpochBarrier(1), lambda c, i: None)   # completes at once
    al.offer(1, EpochBarrier(2), lambda c, i: None)
    assert coord.acks == [1, 2]
    assert node.epoch_barriers_in == 3


def _parked_run(pkg, depth):
    """Producer 0 runs ``depth`` epochs ahead of producer 1: its later
    barriers park in the hold-back buffer (re-parked on each replay
    while an earlier epoch aligns).  Returns (barriers received,
    epoch_barriers_in, acks, items in processing order)."""
    EpochAligner = mod(pkg, "durability.barrier").EpochAligner
    EpochBarrier = mod(pkg, "runtime.queues").EpochBarrier
    node, coord = _sink_node(), _Coord()
    al = EpochAligner(node, coord, n_producers=2)
    seen = []

    def process(cid, item):
        seen.append((cid, item))

    received = 0
    for e in range(1, depth + 2):
        if not al.offer(0, f"a{e}", process):
            process(0, f"a{e}")
        al.offer(0, EpochBarrier(e), process)
        received += 1
    for e in range(1, depth + 2):
        if not al.offer(1, f"b{e}", process):
            process(1, f"b{e}")
        al.offer(1, EpochBarrier(e), process)
        received += 1
    assert not al.busy
    return received, node.epoch_barriers_in, coord.acks, seen


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_aligner_counts_a_parked_barrier_once(depth):
    """The documented divergence (ROADMAP.md C2): the port's
    ``epoch_barriers_in`` equals the barriers received; the reference
    counts a parked future barrier again each time it replays, so the
    ledger subtracts it more than once.  Everything else -- cuts,
    acks, the order items are processed in -- is the reference's."""
    received, port_in, port_acks, port_seen = _parked_run(PORT, depth)
    ref_received, ref_in, ref_acks, ref_seen = _parked_run(REF, depth)
    assert received == ref_received == 2 * (depth + 1)
    assert port_in == received
    # a barrier parked at epoch e replays once per later alignment
    assert ref_in == received + depth * (depth + 1) // 2
    assert port_acks == ref_acks == list(range(1, depth + 2))
    assert port_seen == ref_seen


# ---------------------------------------------------------------------------
# durable graphs
# ---------------------------------------------------------------------------

def _reference_clean(tmp_path, n=N):
    return reference_clean(str(tmp_path / "ref_clean"), n)


def _assert_exactly_once(rows, graph, ref, n=N):
    assert len(rows) == n and len(set(rows)) == n, \
        (len(rows), len(set(rows)), n)
    got = effects_per_key(rows)
    assert got == acc_oracle(n)
    assert got == ref
    assert_ledger_exact(graph)


def _run_port(tmp_path, plan_for, n=N, epochs_at=EPOCHS_AT, **kw):
    run_with_epochs = mod(PORT, "durability").run_with_epochs
    eff = Effects()
    attempts = []

    def factory(attempt):
        attempts.append(attempt)
        return acc_graph(PORT, n, str(tmp_path / "epochs"), eff,
                         plan=plan_for(attempt), epochs_at=epochs_at, **kw)

    g = run_with_epochs(factory, max_restarts=2)
    return g, eff.rows, attempts


def test_durable_clean_run_exactly_once(tmp_path):
    g, rows, attempts = _run_port(tmp_path, lambda a: None)
    assert attempts == [0]
    _assert_exactly_once(rows, g, _reference_clean(tmp_path))
    dur = g.durability
    # three driven epochs plus the final commit at the clean end
    assert dur.commits == 4 and dur.committed == 4
    kinds = collections.Counter(e["kind"] for e in g.flight.snapshot())
    assert kinds["epoch_begin"] == 3
    assert kinds["epoch_commit"] == kinds["checkpoint_epoch"] == 4
    finals = [e for e in g.flight.snapshot()
              if e["kind"] == "epoch_commit" and e.get("final")]
    assert len(finals) == 1 and finals[0]["effects"] > 0
    import json
    block = json.loads(g.stats.to_json())["Durability"]
    assert block["Committed_epoch"] == 4 and not block["Stalled"]


def test_durable_run_on_the_coordinators_cadence(tmp_path):
    """Epochs on the coordinator's own clock (no driven epochs): the
    results are exact whatever the number of commits."""
    eff = Effects()
    g = acc_graph(PORT, N, str(tmp_path / "epochs"), eff, interval=0.01)
    g.run()
    _assert_exactly_once(eff.rows, g, _reference_clean(tmp_path))
    assert g.durability.commits >= 1   # the final commit at least


def test_live_checkpoint_is_non_stop_under_durability(tmp_path):
    """With the plane on, ``live_checkpoint`` forces one epoch (no
    pause of the sources) and mirrors its states to a
    ``restore_graph``-compatible file.  Taken at stream index 2,000
    (the source waits for it), between the driven epochs 1 and 2."""
    import threading
    from windflow_tpu_torch.utils.checkpoint import read_snapshot
    eff = Effects()
    path = str(tmp_path / "live.pkl")
    taken = []
    holder = {}

    def checkpoint():
        done = threading.Event()

        def run():
            try:
                taken.append(holder["g"].live_checkpoint(path, timeout=60))
            finally:
                done.set()
        threading.Thread(target=run, daemon=True).start()
        return done

    g = acc_graph(PORT, N, str(tmp_path / "epochs"), eff,
                  epochs_at=(1000, 3000), hooks={2000: checkpoint})
    holder["g"] = g
    g.run()
    assert taken and taken[0] >= 1
    states = read_snapshot(path)
    assert states["pipe0/ckpt_source"]["i"] == 2000
    _assert_exactly_once(eff.rows, g, _reference_clean(tmp_path))
    evs = [e for e in g.flight.snapshot()
           if e["kind"] == "checkpoint_epoch" and e.get("non_stop")]
    assert len(evs) == 1 and evs[0]["path"] == path and evs[0]["epoch"] == 2
    # the forced epoch is one of the run's commits: 1, 2 (forced), 3
    # and the final one
    assert g.durability.commits == 4


def test_crash_at_epoch_restores_previous_epoch(tmp_path):
    FaultPlan = mod(PORT, "resilience").FaultPlan
    g, rows, attempts = _run_port(
        tmp_path, lambda a: (FaultPlan(seed=5).crash_at_epoch(
            "accumulator", 2) if a == 0 else None))
    assert attempts == [0, 1]
    assert g._epoch_restored == 1
    restores = [e for e in g.flight.snapshot()
                if e["kind"] == "epoch_restore"]
    assert restores and restores[0]["epoch"] == 1
    _assert_exactly_once(rows, g, _reference_clean(tmp_path))
    # numbering continues past the restored epoch
    assert g.durability.committed > 2


def test_crash_midstream_restarts_exactly_once(tmp_path):
    """A replica dies on its 1,200th tuple (past the source's index
    2,000, so after epochs 1 and 2 committed)."""
    FaultPlan = mod(PORT, "resilience").FaultPlan
    g, rows, attempts = _run_port(
        tmp_path, lambda a: (FaultPlan(seed=3).crash_replica(
            "accumulator", at_tuple=1200) if a == 0 else None))
    assert attempts == [0, 1]
    assert g._epoch_restored == 2
    _assert_exactly_once(rows, g, _reference_clean(tmp_path))
    assert g.durability.committed > g._epoch_restored


def test_torn_commit_falls_back_previous_epoch(tmp_path):
    FaultPlan = mod(PORT, "resilience").FaultPlan
    EpochStore = mod(PORT, "durability").EpochStore
    g, rows, attempts = _run_port(
        tmp_path, lambda a: FaultPlan(seed=7).torn_commit(2)
        if a == 0 else None)
    assert attempts == [0, 1]
    assert g._epoch_restored == 1
    aborts = [e for e in g.flight.snapshot()
              if e["kind"] == "epoch_abort"
              and e.get("reason") == "manifest_corrupt"]
    assert aborts and aborts[0]["epoch"] == 2
    _assert_exactly_once(rows, g, _reference_clean(tmp_path))
    e, payload = EpochStore(str(tmp_path / "epochs")).latest()
    assert e is not None and e >= 2 and payload["epoch"] == e


def test_idempotent_sink_truncates_on_restore(tmp_path):
    dur = mod(PORT, "durability")
    FaultPlan = mod(PORT, "resilience").FaultPlan
    store = dur.EpochTaggedStore()

    def factory(attempt):
        plan = (FaultPlan(seed=13).crash_replica("accumulator",
                                                 at_tuple=1200)
                if attempt == 0 else None)
        return acc_graph(PORT, N, str(tmp_path / "epochs"), store,
                         plan=plan, epochs_at=EPOCHS_AT,
                         sink_mode="idempotent")

    g = dur.run_with_epochs(
        factory, max_restarts=2,
        on_restore=lambda g_, e, payload: store.truncate_above(e))
    assert g._epoch_restored == 2
    rows = [(r.key, r.id, r.value) for r in store.items()]
    assert len(rows) == N and len(set(rows)) == N
    got = {k: sorted(v) for k, v in effects_per_key(rows).items()}
    assert got == acc_oracle(N) == _reference_clean(tmp_path)
    assert store.epochs() == sorted(store.epochs())


@pytest.mark.parametrize("pkg", PACKAGES)
def test_idempotent_sink_rejects_plain_callable(pkg):
    wf = importlib.import_module(pkg)
    with pytest.raises(TypeError, match="epoch-keyed writer"):
        g = wf.PipeGraph("bad", config=durable_config(pkg, None,
                                                      durable=False))
        g.add_source(gated_source(pkg, 10)).add_sink(
            wf.SinkBuilder(lambda r: None)
            .with_exactly_once("idempotent").build())
        g.start()


# ---------------------------------------------------------------------------
# the fused device-engine segment (tests/test_durability.py:569)
# ---------------------------------------------------------------------------

WIN, SLIDE = 16, 8
N_WIN = 6000


def _window_oracle(n, n_keys=4):
    """(key, window id) -> sum of values over ts [w*SLIDE, w*SLIDE+WIN)
    of the key's tuples (ts = i, key = i % n_keys), every window whose
    start a key's tuples reached."""
    out = {}
    for k in range(n_keys):
        last = max(i for i in range(k, n, n_keys))
        w = 0
        while w * SLIDE <= last:
            out[(k, w)] = float(sum(
                dur_val(i) for i in range(max(k, w * SLIDE),
                                          min(n, w * SLIDE + WIN))
                if i % n_keys == k))
            w += 1
    return out


def _win_run(pkg, path, plan=None, durable=True):
    wf = importlib.import_module(pkg)
    wins = {}
    counts = collections.Counter()

    def sink(r):
        if r is None:
            return
        wins[(r.key, r.id)] = r.value
        counts[(r.key, r.id)] += 1

    def factory(attempt):
        cfg = durable_config(pkg, path, plan if attempt == 0 else None,
                             durable)
        g = wf.PipeGraph("dur_win", wf.Mode.DEFAULT, config=cfg)
        sb = wf.SinkBuilder(sink)
        if durable:
            sb = sb.with_exactly_once()
        g.add_source(gated_source(pkg, N_WIN, epochs_at=(1500, 3000,
                                                          4500))) \
            .add(wf.MapBuilder(lambda t: None).build()) \
            .add(wf.WinSeqTPUBuilder("sum").with_tb_windows(WIN, SLIDE)
                 .build()) \
            .add_sink(sb.build())
        return g

    if durable:
        g = mod(pkg, "durability").run_with_epochs(factory, max_restarts=2)
    else:
        g = factory(0)
        g.run()
    return g, wins, counts


def test_crash_inside_fused_segment_with_device_engine(tmp_path):
    """Source + map + WinSeqTPU + transactional sink fused in one
    replica; the crash fires on the fused-away map's clock; barriers
    cross the segments and the engine's epoch fence drains its
    in-flight launches.  Every window once, equal to the oracle and
    to the reference's run without epochs."""
    FaultPlan = mod(PORT, "resilience").FaultPlan
    _g, ref, ref_counts = _win_run(REF, None, durable=False)
    assert max(ref_counts.values()) == 1
    _g, clean, clean_counts = _win_run(PORT, str(tmp_path / "clean"))
    plan = FaultPlan(seed=11).crash_replica("map", at_tuple=3500)
    g, wins, counts = _win_run(PORT, str(tmp_path / "chaos"), plan)
    assert g._epoch_restored == 2
    assert max(counts.values()) == 1 and max(clean_counts.values()) == 1
    oracle = _window_oracle(N_WIN)
    assert wins == clean == ref == oracle
    # the device engine rode a fused node
    names = [n.name for n in g._all_nodes()]
    assert any("+" in name and "win_seq_tpu" in name for name in names), \
        names
