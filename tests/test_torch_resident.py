"""The port's resident lanes held against the reference
(tests/test_resident.py, tests/test_tpu_operators.py TestResidentFFAT):

* the resident pane carry of ``WinSeqTPULogic`` (ResidentPaneCarry):
  results equal to the reference's resident lane and to the port's
  rebuild lane, a fraction of the rebuild lane's bytes, checkpoint,
  lane flip, forest growth, planner promotion;
* the resident FFAT forest (``WinSeqFFATResident``): results and byte
  accounting equal to the reference, one fused launch per chunk, the TB
  mirror bound, keyed-state repartitioning, a reference snapshot carried
  over by ``convert`` and continued;
* the FFAT rebuild lane (``WinSeqTPU`` with an ffat kind,
  ``WinSeqFFATTPU``, ``KeyFFATTPU``) at a small cut of bench config 15,
  graph against graph;
* online re-planning (graph/replanner.py): the pure verdict and a
  scripted lane flip with zero lost windows.

Values are integer-valued, so every f32 sum is exact: keys, ids, order
and values must be equal exactly.  The port runs with ``device="cpu"``
(the plain versions of its kernels); tests/test_torch_card.py reruns
the lanes on the card.
"""
import importlib
import pickle
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

PACKAGES = ("windflow_tpu", "windflow_tpu_torch")
N_KEYS = 3
# the reference's combine and the port's, by name
ADD = {"windflow_tpu": jnp.add, "windflow_tpu_torch": torch.add}
MAX = {"windflow_tpu": jnp.maximum, "windflow_tpu_torch": torch.maximum}
# a user combine no kernel builds in (the card compiles it from its
# torch ops): held within rtol 1e-5, as jnp.logaddexp and
# torch.logaddexp may part by an ulp a combine
LAE = {"windflow_tpu": jnp.logaddexp, "windflow_tpu_torch": torch.logaddexp}
# name -> (combine by package, neutral)
FFAT_COMBINES = {"add": (ADD, 0.0), "logaddexp": (LAE, -np.inf)}
LAE_RTOL = 1e-5


def _same_windows(got, want, name):
    """Equal windows (keys, ids, and ts where carried); values exactly
    for add, within LAE_RTOL for logaddexp."""
    assert sorted(got) == sorted(want)
    if name == "add":
        assert got == want
        return
    g = np.array([np.ravel(got[k])[0] for k in sorted(want)], np.float64)
    w = np.array([np.ravel(want[k])[0] for k in sorted(want)], np.float64)
    np.testing.assert_allclose(g, w, rtol=LAE_RTOL, atol=0)
    if isinstance(next(iter(want.values())), tuple):  # (value, ts)
        assert [got[k][1] for k in sorted(want)] == \
            [want[k][1] for k in sorted(want)]


def _mod(pkg, path):
    return importlib.import_module(f"{pkg}.{path}")


def _dev(pkg):
    return {"device": "cpu"} if pkg == "windflow_tpu_torch" else {}


@pytest.fixture(autouse=True)
def _pin_cost_model(monkeypatch, tmp_path):
    """Deterministic cost-model inputs in both packages (tiny RTT floor,
    pinned host rate, no compute calibration, calibration files under
    tmp_path)."""
    monkeypatch.setenv("WINDFLOW_RTT_FLOOR_MS", "0.001")
    monkeypatch.setenv("WINDFLOW_HOST_RATE_TPS", "20000000")
    monkeypatch.setenv("WINDFLOW_DEVICE_COMPUTE_MS", "0")
    for pkg in PACKAGES:
        planner = _mod(pkg, "graph.planner")
        monkeypatch.setattr(planner, "_DEV_CALIB_PATH",
                            str(tmp_path / f"{pkg}_device_cal.json"))
        monkeypatch.setattr(planner, "_device_compute_ms", None)


def _batch(pkg, lo, hi, n_keys=N_KEYS, vmod=7):
    TupleBatch = _mod(pkg, "core.tuples").TupleBatch
    idx = np.arange(lo, hi)
    return TupleBatch({"key": idx % n_keys, "id": idx // n_keys,
                       "ts": idx // n_keys,
                       "value": (idx % vmod).astype(np.float64)})


def _flat(out):
    flat = {}
    for r in out:
        if hasattr(r, "columns") or hasattr(r, "take"):
            for i in range(len(r)):
                flat[(int(r.key[i]), int(r.id[i]))] = \
                    (float(r["value"][i]), int(r.ts[i]))
        else:
            flat[(r.key, r.id)] = (r.value, r.ts)
    return flat


def _run_logic(pkg, lg, n, chunk=500, n_keys=N_KEYS):
    out = []
    for c in range(0, n, chunk):
        lg.svc(_batch(pkg, c, min(c + chunk, n), n_keys), 0, out.append)
    lg.eos_flush(out.append)
    return _flat(out)


# ---------------------------------------------------------------------------
# the resident pane carry of WinSeqTPULogic
# ---------------------------------------------------------------------------

def _win_logic(pkg, resident, kind="sum", win=256, slide=32, win_type=None,
               batch_len=16):
    WinSeqTPULogic = _mod(pkg, "operators.tpu.win_seq_tpu").WinSeqTPULogic
    wt = win_type or importlib.import_module(pkg).WinType.CB
    # value_of defeats the native engine so the Python staging path
    # (the one the resident carry extends) is compared; launches are
    # size-triggered only (the time trigger out of reach), so both
    # packages cut the same batches however loaded the machine is
    return WinSeqTPULogic(kind, win, slide, wt, batch_len=batch_len,
                          async_dispatch=False, resident=resident,
                          max_batch_delay_ms=1e9,
                          value_of=lambda t: t.value, **_dev(pkg))


class TestResidentPaneCarry:
    @pytest.mark.parametrize("kind,wt", [("sum", "CB"), ("count", "CB"),
                                         ("max", "CB"), ("sum", "TB")])
    def test_matches_reference_and_rebuild(self, kind, wt):
        got = {}
        for pkg in PACKAGES:
            for resident in (False, True):
                lg = _win_logic(pkg, resident, kind, win_type=getattr(
                    importlib.import_module(pkg).WinType, wt))
                got[pkg, resident] = _run_logic(pkg, lg, 6000)
        want = got["windflow_tpu", True]
        assert want and got["windflow_tpu_torch", True] == want
        assert got["windflow_tpu_torch", False] == want

    def test_ships_the_reference_bytes_a_fraction_of_rebuild(self):
        shipped = {}
        for pkg in PACKAGES:
            StatsRecord = _mod(pkg, "monitoring.stats").StatsRecord
            for resident in (False, True):
                lg = _win_logic(pkg, resident, "sum", win=4096, slide=64,
                                batch_len=8)
                lg.stats = StatsRecord()
                _run_logic(pkg, lg, 40_000)
                assert lg.stats.num_launches > 4
                shipped[pkg, resident] = (lg.stats.bytes_to_device,
                                          lg.stats.num_launches)
                if resident:
                    assert lg.stats.device_state_bytes > 0
                    assert lg.device_resident_bytes() \
                        == lg.stats.device_state_bytes
        for resident in (False, True):
            assert shipped["windflow_tpu_torch", resident] \
                == shipped["windflow_tpu", resident]
        per = {r: b / n for (p, r), (b, n) in shipped.items()
               if p == "windflow_tpu_torch"}
        assert per[True] < per[False] / 3, per

    def test_checkpoint_restore_continues_identically(self):
        pkg = "windflow_tpu_torch"
        ref = _run_logic(pkg, _win_logic(pkg, True), 8000)
        a = _win_logic(pkg, True)
        out = []
        for c in range(0, 4000, 500):
            a.svc(_batch(pkg, c, c + 500), 0, out.append)
        a.quiesce(out.append)  # snapshot contract: nothing in flight
        blob = pickle.loads(pickle.dumps(a.state_dict()))
        b = _win_logic(pkg, True)
        b.load_state(blob)
        for c in range(4000, 8000, 500):
            b.svc(_batch(pkg, c, c + 500), 0, out.append)
        b.eos_flush(out.append)
        assert _flat(out) == ref

    def test_lane_flip_drops_then_recovers_residency(self):
        pkg = "windflow_tpu_torch"
        lg = _win_logic(pkg, True)
        out = []
        lg.svc(_batch(pkg, 0, 2000), 0, out.append)
        assert lg._resident is not None
        lg.apply_placement("host")
        assert lg._resident is None
        lg.apply_placement("device")
        assert lg.maybe_enable_resident()
        assert lg._resident.device == torch.device("cpu")
        lg.svc(_batch(pkg, 2000, 6000), 0, out.append)
        lg.eos_flush(out.append)
        assert _flat(out) == _run_logic(pkg, _win_logic(pkg, False), 6000)

    def test_many_keys_grow_forest_empty_swap(self):
        """More keys than the initial forest holds swap in a bigger EMPTY
        forest and re-ship dirty partials; results stay equal to the
        reference's."""
        got = {}
        for pkg in PACKAGES:
            lg = _win_logic(pkg, True, win=64, slide=32)
            got[pkg] = _run_logic(pkg, lg, 20_000, n_keys=40)
            assert lg._resident.forest.n_keys >= 40
        assert got["windflow_tpu"] and \
            got["windflow_tpu_torch"] == got["windflow_tpu"]

    def test_forced_resident_rejects_ineligible_shapes(self):
        pkg = "windflow_tpu_torch"
        with pytest.raises(ValueError, match="resident"):
            _win_logic(pkg, True, "mean")
        with pytest.raises(ValueError, match="resident"):
            _win_logic(pkg, True, "sum", win=24, slide=6)

    def test_planner_promotes_eligible_device_engines(self):
        for opt_out, expect in ((False, True), (True, False)):
            rows = {}
            for pkg in PACKAGES:
                wf = importlib.import_module(pkg)
                WinSeqTPU = _mod(pkg, "operators.tpu.win_seq_tpu").WinSeqTPU
                out = []
                g = wf.PipeGraph("resident_promo", wf.Mode.DEFAULT,
                                 config=wf.RuntimeConfig(**_dev(pkg)))
                op = WinSeqTPU("sum", 256, 32, wf.WinType.CB, batch_len=32,
                               value_of=lambda t: t.value,
                               resident=(False if opt_out else None))
                g.add_source(_mod(pkg, "operators.batch_ops").BatchSource(
                    _counted(pkg, 20_000, 2000))).add(op).add_sink(
                    _mod(pkg, "operators.basic_ops").Sink(out.append))
                g.run()
                entry = next(p for p in g.placements
                             if p["operator"].endswith("win_seq_tpu.0"))
                assert entry.get("resident", False) is expect
                rows[pkg] = [(r.key, r.id, r.value) for r in out
                             if r is not None]
            assert rows["windflow_tpu"] and \
                rows["windflow_tpu_torch"] == rows["windflow_tpu"]


def _counted(pkg, n, sb, n_keys=N_KEYS, pace_s=0.0):
    state = {"i": 0}

    def fn():
        i = state["i"]
        if i * sb >= n:
            return None
        state["i"] = i + 1
        if pace_s:
            time.sleep(pace_s)
        return _batch(pkg, i * sb, min((i + 1) * sb, n), n_keys)

    return fn


# ---------------------------------------------------------------------------
# the resident FFAT forest
# ---------------------------------------------------------------------------

def _resident(pkg, win=512, slide=16, tb=False, combine=ADD, neutral=0.0):
    mod = _mod(pkg, "operators.tpu.ffat_resident")
    wt = importlib.import_module(pkg).WinType
    return mod.WinSeqFFATResidentLogic(
        lambda t: t.value, combine[pkg], neutral, win, slide,
        win_type=wt.TB if tb else wt.CB, **_dev(pkg))


class _Node:
    """The RtNode fields ``merge_keyed_states`` reads."""

    def __init__(self, logic):
        self.logic = logic
        self.name = "win_seqffat_resident"


def _tree(pkg, lg):
    """A resident logic's forest [K, 2n] on the host."""
    if pkg == "windflow_tpu_torch":
        return lg.forest.tree_numpy()
    return np.asarray(lg.forest.tree)


class TestResidentFFAT:
    def test_bytes_per_launch_10x_below_rebuild(self):
        """The bench-15 claim at a small size, in both packages: the
        resident lane ships >= 10x fewer bytes per launch than the
        rebuild lane, with identical results and identical counts."""
        win, slide, n = 512, 16, 30_000
        got, stats = {}, {}
        for pkg in PACKAGES:
            StatsRecord = _mod(pkg, "monitoring.stats").StatsRecord
            WinSeqTPULogic = _mod(pkg,
                                  "operators.tpu.win_seq_tpu").WinSeqTPULogic
            rebuild = WinSeqTPULogic(
                ("ffat", ADD[pkg], 0.0), win, slide,
                importlib.import_module(pkg).WinType.CB, batch_len=64,
                async_dispatch=False, value_of=lambda t: t.value,
                **_dev(pkg))
            resident = _resident(pkg, win, slide)
            for name, lg in (("rebuild", rebuild), ("resident", resident)):
                lg.stats = StatsRecord()
                got[pkg, name] = {k: v[0] for k, v in
                                  _run_logic(pkg, lg, n).items()}
                s = lg.stats
                stats[pkg, name] = (s.num_launches, s.bytes_to_device,
                                    s.bytes_from_device)
            per = {name: (stats[pkg, name][1] + stats[pkg, name][2])
                   / stats[pkg, name][0] for name in ("rebuild",
                                                      "resident")}
            assert per["rebuild"] >= 10 * per["resident"], per
            assert resident.stats.device_state_bytes > 0
        want = got["windflow_tpu", "resident"]
        assert want and all(v == want for v in got.values())
        assert stats["windflow_tpu_torch", "resident"] \
            == stats["windflow_tpu", "resident"]

    def test_one_fused_launch_per_chunk(self):
        pkg = "windflow_tpu_torch"
        lg = _resident(pkg, 64, 16)
        out = []
        lg.svc(_batch(pkg, 0, 300, 1), 0, out.append)
        assert out  # windows fired
        assert lg.launched_batches == 1

    def test_tb_mirror_stays_bounded_and_matches_reference(self):
        got = {}
        for pkg in PACKAGES:
            TupleBatch = _mod(pkg, "core.tuples").TupleBatch
            lg = _resident(pkg, 64, 16, tb=True, combine=MAX)
            out = []
            for c in range(0, 20_000, 1000):
                idx = np.arange(c, c + 1000)
                lg.svc(TupleBatch({"key": np.zeros(1000, np.int64),
                                   "id": idx, "ts": idx,
                                   "value": (idx % 7).astype(np.float64)}),
                       0, out.append)
            st = lg.keys[0]
            assert len(st.ts_vals) < 8192 and st.ts_base > 10_000
            lg.eos_flush(out.append)
            got[pkg] = _flat(out)
        assert len(got["windflow_tpu"]) == (20_000 - 1) // 16 + 1
        assert got["windflow_tpu_torch"] == got["windflow_tpu"]

    def test_snapshot_does_not_alias_the_live_forest(self):
        """A resident lane's ``state_dict()`` and ``keyed_state_dict()``
        are snapshots: stepping the lane on after them leaves them as
        the reference's snapshots at the same point (the port's CPU
        forest was once read in place, ROADMAP.md C6)."""
        snaps = {}
        for pkg in PACKAGES:
            lg = _resident(pkg, 128, 32)
            out = []
            for c in range(0, 3000, 500):
                lg.svc(_batch(pkg, c, c + 500), 0, out.append)
            snap, keyed = lg.state_dict(), lg.keyed_state_dict()
            for c in range(3000, 6000, 500):
                lg.svc(_batch(pkg, c, c + 500), 0, out.append)
            snaps[pkg] = (np.array(snap["tree"]),
                          {k: b["leaves"].tolist() for k, b in keyed.items()})
        np.testing.assert_array_equal(snaps[PACKAGES[1]][0],
                                      snaps[PACKAGES[0]][0])
        assert snaps[PACKAGES[1]][1] == snaps[PACKAGES[0]][1]

    @pytest.mark.parametrize("steps", [(2,), (3, 1)],
                             ids=["1-2", "1-3-1"])
    def test_keyed_state_partitions_across_replicas(self, steps):
        """The twin of the reference's 1->2 repartition
        (tests/test_resident.py::test_keyed_state_partitions_across_replicas),
        also taken 1->3->1 so the owners hold unequal key counts: each
        package cuts its own lane with its own ``partition_keyed_state``
        / ``owner_of`` / ``merge_keyed_states``.  After every cut each
        replica's forest (leaves and inner nodes) equals the
        reference's, and the windows equal the reference's and the
        uninterrupted run's."""
        n, n_keys, chunk = 12_000, 5, 600
        cuts = [n // 2 + i * n // (2 * len(steps)) for i in range(len(steps))]
        got, trees = {}, {}
        for pkg in PACKAGES:
            el = _mod(pkg, "elastic")
            out = []
            reps = [_resident(pkg, 128, 32)]
            for c in range(0, n, chunk):
                if c in cuts:
                    merged, stateful = el.merge_keyed_states(
                        [_Node(r) for r in reps])
                    assert stateful and set(merged) == set(range(n_keys))
                    new_n = steps[cuts.index(c)]
                    parts = el.partition_keyed_state(merged, new_n)
                    reps = [_resident(pkg, 128, 32) for _ in range(new_n)]
                    for part, rep in zip(parts, reps):
                        rep.load_keyed_state(part)
                    trees[pkg, c] = [_tree(pkg, r) for r in reps]
                batch = _batch(pkg, c, c + chunk, n_keys)
                owners = np.array([el.owner_of(int(k), len(reps))
                                   for k in batch.key])
                for i, rep in enumerate(reps):
                    if (owners == i).any():
                        rep.svc(batch.take(np.nonzero(owners == i)[0]), 0,
                                out.append)
            for rep in reps:
                rep.eos_flush(out.append)
            got[pkg] = _flat(out)
        full = _run_logic(PACKAGES[0], _resident(PACKAGES[0], 128, 32), n,
                          chunk, n_keys)
        assert got[PACKAGES[1]] == got[PACKAGES[0]] == full
        for c in cuts:
            assert len(trees[PACKAGES[1], c]) == len(trees[PACKAGES[0], c])
            for t_port, t_ref in zip(trees[PACKAGES[1], c],
                                     trees[PACKAGES[0], c]):
                np.testing.assert_array_equal(t_port, t_ref)

    @pytest.mark.parametrize("src,dst", [PACKAGES, PACKAGES[::-1]],
                             ids=["reference-to-port", "port-to-reference"])
    def test_keyed_state_blob_crosses_packages(self, src, dst):
        """A resident lane's ``keyed_state_dict()`` blob of one package
        loads into the other's ``load_keyed_state`` as it is (both hold
        the same fields: counters and numpy leaf and timestamp spans),
        and the lane goes on to the uninterrupted run's windows."""
        n, half = 9000, 4500
        full = _run_logic(src, _resident(src, 256, 32), n)
        a, out = _resident(src, 256, 32), []
        for c in range(0, half, 500):
            a.svc(_batch(src, c, c + 500), 0, out.append)
        blob = pickle.loads(pickle.dumps(a.keyed_state_dict()))
        b, own = _resident(dst, 256, 32), _resident(src, 256, 32)
        b.load_keyed_state(blob)
        own.load_keyed_state(pickle.loads(pickle.dumps(blob)))
        np.testing.assert_array_equal(_tree(dst, b), _tree(src, own))
        for c in range(half, n, 500):
            b.svc(_batch(dst, c, c + 500), 0, out.append)
        b.eos_flush(out.append)
        assert _flat(out) == full

    @pytest.mark.parametrize("name", list(FFAT_COMBINES))
    def test_reference_snapshot_continues_in_port(self, name):
        """A reference resident forest checkpointed mid-stream resumes in
        the port (``convert.from_reference_state``) and emits the same
        remaining windows as the uninterrupted reference run -- under
        add, and under a user combine (jnp.logaddexp in the reference,
        torch.logaddexp in the port)."""
        from windflow_tpu_torch.convert import from_reference_state
        combine, neutral = FFAT_COMBINES[name]
        n, half = 9000, 4500

        def make(pkg):
            return _resident(pkg, 256, 32, combine=combine, neutral=neutral)

        full = _run_logic("windflow_tpu", make("windflow_tpu"), n)
        ref, out = make("windflow_tpu"), []
        for c in range(0, half, 500):
            ref.svc(_batch("windflow_tpu", c, c + 500), 0, out.append)
        snap = pickle.loads(pickle.dumps(ref.state_dict()))
        port = make("windflow_tpu_torch")
        port.load_state(from_reference_state(snap))
        np.testing.assert_array_equal(port.forest.tree_numpy(), snap["tree"])
        for c in range(half, n, 500):
            port.svc(_batch("windflow_tpu_torch", c, c + 500), 0,
                     out.append)
        port.eos_flush(out.append)
        _same_windows(_flat(out), full, name)

    @pytest.mark.parametrize("name", list(FFAT_COMBINES))
    def test_operator_graph_matches_reference(self, name):
        combine, neutral = FFAT_COMBINES[name]
        got = {}
        for pkg in PACKAGES:
            op = _mod(pkg, "operators.tpu.ffat_resident").WinSeqFFATResident(
                lambda t: t.value, combine[pkg], neutral, 256, 16,
                **_dev(pkg))
            got[pkg], g = _graph(pkg, op, 24_000)
            entry = g.placements[0]
            assert entry["resident"] and entry["placement"] == "device"
        _same_windows(got["windflow_tpu_torch"], got["windflow_tpu"], name)


def _records(pkg, lg, recs, out):
    BasicRecord = _mod(pkg, "core.tuples").BasicRecord
    for key, tid, ts, val in recs:
        lg.svc(BasicRecord(key, tid, ts, val), 0, out.append)


class TestResidentFFATRecords:
    """Twins of the reference's record-path cases of the resident forest
    (tests/test_tpu_operators.py TestResidentFFAT), both packages fed the
    same records."""

    def _logic(self, pkg, win, slide, tb=False, combine=ADD, **kw):
        mod = _mod(pkg, "operators.tpu.ffat_resident")
        wt = importlib.import_module(pkg).WinType
        return mod.WinSeqFFATResidentLogic(
            lambda t: t.value, combine[pkg], 0.0, win, slide,
            win_type=wt.TB if tb else wt.CB, **kw, **_dev(pkg))

    def test_tb_ring_growth_and_sparse_gaps_match_reference(self):
        """A TB span holding more tuples than a forced tiny ring grows
        the ring (re-scatter through the host); sparse timestamps leave
        empty windows at the masked 0."""
        dense = [(0, i, i // 8, 1.0) for i in range(512)]
        sparse = [(0, ts, ts, float(ts)) for ts in (0, 1, 2, 50, 51, 90)]
        for recs, win, slide, tiny in ((dense, 16, 8, True),
                                       (sparse, 8, 8, False)):
            got = {}
            for pkg in PACKAGES:
                lg = self._logic(pkg, win, slide, tb=True)
                if tiny:
                    lg._chunk_headroom = 32
                    lg.capacity = 64
                    lg.forest = _mod(pkg, {
                        "windflow_tpu": "ops.flatfat_jax",
                        "windflow_tpu_torch": "ops.flatfat_torch"}[pkg]) \
                        .BatchedFlatFAT(ADD[pkg], 0.0, 2, 64, **_dev(pkg))
                out = []
                _records(pkg, lg, recs, out)
                lg.eos_flush(out.append)
                if tiny:
                    assert lg.capacity > 64
                got[pkg] = _flat(out)
            assert got["windflow_tpu"] and \
                got["windflow_tpu_torch"] == got["windflow_tpu"]

    def test_tb_rejects_out_of_order(self):
        lg = self._logic("windflow_tpu_torch", 8, 4, tb=True)
        _records("windflow_tpu_torch", lg, [(0, 0, 10, 1.0)], [])
        with pytest.raises(ValueError, match="in-order"):
            _records("windflow_tpu_torch", lg, [(0, 1, 3, 1.0)], [])

    def test_window_fires_on_completing_tuple(self):
        lg = self._logic("windflow_tpu_torch", 16, 8)
        out = []
        _records("windflow_tpu_torch", lg,
                 [(0, i, i * 3, float(i)) for i in range(16)], out)
        assert len(out) == 1 and out[0].value == sum(range(16))
        assert out[0].ts == 15 * 3  # CB result ts = last tuple in extent

    def test_checkpoint_roundtrip_and_restore_pins_rows(self):
        """A pickled snapshot continues identically, and restoring pins
        the forest to the snapshot's rows: new keys after the restore
        never alias checkpointed rows."""
        pkg = "windflow_tpu_torch"
        recs = [(i % 2, i // 2, i // 2, float(i)) for i in range(120)]
        ref, want = self._logic(pkg, 16, 8), []
        _records(pkg, ref, recs, want)
        ref.eos_flush(want.append)
        a, out = self._logic(pkg, 16, 8), []
        _records(pkg, a, recs[:60], out)
        b = self._logic(pkg, 16, 8)
        b.load_state(pickle.loads(pickle.dumps(a.state_dict())))
        _records(pkg, b, recs[60:], out)
        b.eos_flush(out.append)
        assert _flat(out) == _flat(want)

        a = self._logic(pkg, 8, 8, initial_keys=2)
        _records(pkg, a, [(i % 4, i // 4, 0, 1.0) for i in range(32)], [])
        b = self._logic(pkg, 8, 8)
        b.load_state(pickle.loads(pickle.dumps(a.state_dict())))
        out = []
        _records(pkg, b, [(i % 6, i // 6, 0, 2.0) for i in range(48)], out)
        by_key = {}
        for r in out:
            by_key.setdefault(r.key, []).append(r.value)
        assert by_key[4] == [16.0] and by_key[5] == [16.0]

    def test_min_combine_graph_matches_reference(self):
        got = {}
        for pkg in PACKAGES:
            combine = {"windflow_tpu": jnp.minimum,
                       "windflow_tpu_torch": torch.minimum}[pkg]
            op = _mod(pkg, "operators.tpu.ffat_resident").WinSeqFFATResident(
                lambda t: t.value, combine, float("inf"), 12, 12,
                **_dev(pkg))
            got[pkg], _g = _graph(pkg, op, 6000)
        assert got["windflow_tpu"] == got["windflow_tpu_torch"]


# ---------------------------------------------------------------------------
# bench config 15 at a small size: the FFAT rebuild lane and its farms
# ---------------------------------------------------------------------------

def _graph(pkg, op, n_events, n_keys=8, sb=4096, cfg=None):
    wf = importlib.import_module(pkg)
    BatchSource = _mod(pkg, "operators.batch_ops").BatchSource
    Sink = _mod(pkg, "operators.basic_ops").Sink
    state = {"i": 0}

    def source():
        i = state["i"]
        if i >= n_events:
            return None
        state["i"] = i + sb
        return _batch(pkg, i, min(i + sb, n_events), n_keys, vmod=97)

    out, lock = {}, threading.Lock()

    def sink(r):
        if r is not None:
            with lock:
                out[(r.key, r.id)] = r.value

    g = wf.PipeGraph("bench15_small", wf.Mode.DEFAULT,
                     config=wf.RuntimeConfig(**(cfg or _dev(pkg))))
    g.add_source(BatchSource(source)).add(op).add_sink(Sink(sink))
    g.run()
    return out, g


def _oracle15(n_events, n_keys, win, slide, name="add"):
    """Every window of the stream law (key = e % keys, id = e // keys,
    value = e % 97), CB partial tails at EOS included: the sum, or for
    logaddexp log(sum(exp(v))) as 96 + log of float64 prefix sums of
    exp(v - 96)."""
    out = {}
    per = n_events // n_keys
    for k in range(n_keys):
        v = (np.arange(per) * n_keys + k) % 97
        if name == "logaddexp":
            v = np.exp(v - 96.0)
        c = np.concatenate([[0], np.cumsum(v)])
        w = 0
        while w * slide < per:
            s = c[min(w * slide + win, per)] - c[w * slide]
            out[(k, w)] = float(s if name == "add" else 96.0 + np.log(s))
            w += 1
    return out


@pytest.mark.parametrize("name", list(FFAT_COMBINES))
@pytest.mark.parametrize("op_name", ["win_seq_tpu", "win_seqffat_tpu",
                                     "key_ffat_tpu"])
def test_ffat_rebuild_lane_matches_reference_and_oracle(op_name, name):
    combine, neutral = FFAT_COMBINES[name]
    win, slide, n = 512, 16, 40_960
    got = {}
    for pkg in PACKAGES:
        wt = importlib.import_module(pkg).WinType.CB
        kw = {"batch_len": 128, "max_buffer_elems": 1 << 21,
              "inflight_depth": 8}
        if op_name == "win_seq_tpu":
            op = _mod(pkg, "operators.tpu.win_seq_tpu").WinSeqTPU(
                ("ffat", combine[pkg], neutral), win, slide, wt, **kw)
        else:
            farms = _mod(pkg, "operators.tpu.farms_tpu")
            cls = (farms.WinSeqFFATTPU if op_name == "win_seqffat_tpu"
                   else farms.KeyFFATTPU)
            op = cls(lambda t: t.value, (combine[pkg], neutral), win, slide,
                     wt, **kw)
        got[pkg], g = _graph(pkg, op, n)
        if pkg == "windflow_tpu_torch":
            entry = g.placements[0]
            assert entry["placement"] == "device" \
                and entry["device"] == "cpu"
    want = _oracle15(n, 8, win, slide, name)
    _same_windows(got["windflow_tpu_torch"], got["windflow_tpu"], name)
    _same_windows(got["windflow_tpu_torch"], want, name)


def test_unported_farms_raise_naming_the_roadmap_item():
    """The device farms are ported (tests/test_torch_farms.py); the mesh
    farms, the one farm family left, name their ROADMAP item."""
    import windflow_tpu_torch as wf
    farms = _mod("windflow_tpu_torch", "operators.tpu.farms_tpu")
    for name in ("KeyFarmTPU", "WinFarmTPU", "PaneFarmTPU",
                 "WinMapReduceTPU"):
        assert getattr(farms, name).__module__ == farms.__name__
    for name in ("KeyFarmMesh", "PaneFarmMesh", "WinMapReduceMesh"):
        with pytest.raises(AttributeError, match="ROADMAP.md A11"):
            getattr(wf, name)


def test_ffat_strategy_builds_the_ffat_operator():
    from windflow_tpu_torch.graph.planner import plan_window_operator
    from windflow_tpu_torch.operators.tpu.farms_tpu import WinSeqFFATTPU
    import windflow_tpu_torch as wf
    op = plan_window_operator("max", 64, 4, wf.WinType.CB)
    assert isinstance(op, WinSeqFFATTPU) and op.kind == "max"
    with pytest.raises(ValueError, match="device-pinned"):
        plan_window_operator("max", 64, 4, wf.WinType.CB, placement="host")


# ---------------------------------------------------------------------------
# online re-planning
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lane,measured,tuples,calib", [
    ("device", 2.5, 2048, 0.0), ("device", 0.02, 65536, 0.0),
    ("host", None, 65536, 0.01), ("host", None, 65536, 50.0)])
def test_replan_decision_matches_reference(lane, measured, tuples, calib):
    from windflow_tpu.graph.replanner import replan_decision as ref
    from windflow_tpu_torch.graph.replanner import replan_decision
    args = dict(measured_ms_per_launch=measured, tuples_per_launch=tuples,
                bytes_per_launch=1200, rtt_ms=0.01, host_tps=20e6,
                calibrated_compute_ms=calib)
    assert replan_decision(lane, **args) == ref(lane, **args)


def test_scripted_load_shift_flips_lane_zero_loss():
    """The reference's acceptance scenario through the port on the CPU
    device: 'auto' resolves 'device' from the tiny pinned RTT floor, the
    measured launch walls contradict it, the re-planner flips the lane
    mid-run -- zero lost or duplicated windows, values equal to the
    integer oracle on both sides of the flip, the flip recorded and
    explained."""
    import windflow_tpu_torch as wf
    from windflow_tpu_torch.diagnosis.report import render_text
    from windflow_tpu_torch.operators.tpu.win_seq_tpu import WinSeqTPU
    pkg = "windflow_tpu_torch"
    win, slide, sb, cap = 1024, 32, 1500, 800
    cfg = wf.RuntimeConfig(device="cpu", replan=True, replan_ticks=2,
                           diagnosis_interval_s=0.15, audit_interval_s=0.1)
    g = wf.PipeGraph("replan_flip", wf.Mode.DEFAULT, cfg)
    rows = []
    op = WinSeqTPU("sum", win, slide, wf.WinType.CB, batch_len=64,
                   inflight_depth=1, placement="auto",
                   value_of=lambda t: t.value)
    state = {"i": 0, "tail": 0}

    def batch():
        i = state["i"]
        if any(e["kind"] == "replacement" for e in g.flight.snapshot()):
            state["tail"] += 1
        if i >= cap * sb or state["tail"] > 25:
            return None
        state["i"] = i + sb
        time.sleep(0.004)
        return _batch(pkg, i, i + sb)

    g.add_source(_mod(pkg, "operators.batch_ops").BatchSource(batch)).add(
        op).add_sink(_mod(pkg, "operators.basic_ops").Sink(rows.append))
    g.run()
    n = state["i"]
    got = {}
    for r in rows:
        if r is not None:
            got.setdefault((r.key, r.id), []).append(r.value)
    entry = next(p for p in g.placements if "win_seq_tpu" in p["operator"])
    assert entry["placement"] == "host" and entry.get("replanned")
    flips = [e for e in g.flight.snapshot() if e["kind"] == "replacement"]
    assert flips and flips[0]["old"] == "device" \
        and flips[0]["new"] == "host"
    assert all(len(v) == 1 for v in got.values())
    per_key = n // N_KEYS
    assert len(got) == N_KEYS * ((per_key - 1) // slide + 1)
    for key in range(N_KEYS):
        for w in (0, per_key // (2 * slide), (per_key - 1) // slide):
            ids = range(w * slide, min(w * slide + win, per_key))
            assert got[(key, w)][0] == float(sum((i * N_KEYS + key) % 7
                                                 for i in ids))
    rep = g.explain()
    assert rep["Replacements"][0]["operator"] == flips[0]["operator"]
    assert "device -> host" in render_text(rep)


# ---------------------------------------------------------------------------
# the resident lanes under the durability plane (tests/test_resident.py
# TestResidentDurability): epochs snapshot the resident state, a crash
# restores it, every window once
# ---------------------------------------------------------------------------

def _cb_oracle(n, n_keys, win, slide):
    """(key, window) -> sum over the key's tuples [w*slide, w*slide+win)
    of a gated_source stream (tuple i: key i % n_keys, value i % 7),
    partial tail windows included."""
    from torch_graphs import dur_val
    out = {}
    for k in range(n_keys):
        vals = [dur_val(i) for i in range(k, n, n_keys)]
        w = 0
        while w * slide < len(vals):
            out[(k, w)] = float(sum(vals[w * slide: w * slide + win]))
            w += 1
    return out


def _durable_run(pkg, make_op, n, path, plan=None, durable=True,
                 epochs_at=(), hooks_for=None):
    """gated source -> ``make_op(wf)`` -> exactly-once sink under
    ``run_with_epochs`` (attempt 0 gets ``plan`` and the hooks of
    ``hooks_for(graph)``); ``durable=False`` runs the same graph once
    without epochs.  Returns the last graph, its windows and how many
    times each window reached the sink."""
    from torch_graphs import durable_config, gated_source
    wf = importlib.import_module(pkg)
    wins, counts = {}, {}
    lock = threading.Lock()

    def sink(r):
        if r is not None:
            with lock:
                wins[(r.key, r.id)] = r.value
                counts[(r.key, r.id)] = counts.get((r.key, r.id), 0) + 1

    def factory(attempt):
        cfg = durable_config(pkg, path, plan if attempt == 0 else None,
                             durable)
        g = wf.PipeGraph("dur_resident", wf.Mode.DEFAULT, config=cfg)
        hooks = hooks_for(g) if hooks_for and attempt == 0 else None
        sb = wf.SinkBuilder(sink)
        if durable:
            sb = sb.with_exactly_once()
        g.add_source(gated_source(pkg, n, epochs_at=epochs_at,
                                  hooks=hooks)) \
            .add(make_op(wf)).add_sink(sb.build())
        return g

    if durable:
        g = _mod(pkg, "durability").run_with_epochs(factory, max_restarts=2)
    else:
        g = factory(0)
        g.run()
    return g, wins, counts


def _resident_op(wf):
    return wf.WinSeqFFATTPUBuilder(lambda t: t.value, "sum") \
        .with_cb_windows(96, 16).build()


def test_crash_restart_resident_ffat_lane(tmp_path):
    """Epoch snapshots carry the resident forest (copied off the
    device); a crash on the engine restores it into a fresh forest and
    the rerun emits every window once, equal to the oracle, to the
    uninterrupted durable run and to the reference without epochs."""
    n = 5000
    pkg = "windflow_tpu_torch"
    FaultPlan = _mod(pkg, "resilience").FaultPlan
    epochs = (1200, 2400, 3600)
    _g, ref, rc = _durable_run("windflow_tpu", _resident_op, n, None,
                               durable=False)
    _g, clean, cc = _durable_run(pkg, _resident_op, n,
                                 str(tmp_path / "clean"), epochs_at=epochs)
    plan = FaultPlan(seed=9).crash_replica("win_seqffat_tpu",
                                           at_tuple=3000)
    g, wins, counts = _durable_run(pkg, _resident_op, n,
                                   str(tmp_path / "chaos"), plan=plan,
                                   epochs_at=epochs)
    assert g._epoch_restored == 2
    assert max(counts.values()) == max(cc.values()) == max(rc.values()) == 1
    assert wins == clean == ref == _cb_oracle(n, 4, 96, 16)
    logic = next(lg for nd in g._all_nodes()
                 for lg in _segment_logics(nd)
                 if type(lg).__name__ == "WinSeqFFATResidentLogic")
    assert logic.launched_batches > 0


def _segment_logics(node):
    segs = getattr(node.logic, "segments", None)
    return [s.logic for s in segs] if segs else [node.logic]


def test_lane_flip_between_epochs_exactly_once(tmp_path):
    """A scripted device -> host lane flip at stream index 3,000 (the
    source waits for it), between epochs 1 (index 1,500) and 2 (index
    4,500); a crash on the engine's 5,200th tuple restores epoch 2,
    taken on the host lane, into a fresh device-lane engine.  Every
    window once, equal to the oracle and to the reference's run
    without epochs or flip."""
    n, win, slide = 6000, 64, 32
    pkg = "windflow_tpu_torch"
    FaultPlan = _mod(pkg, "resilience").FaultPlan

    def make_op_for(p):
        WinSeqTPU = _mod(p, "operators.tpu.win_seq_tpu").WinSeqTPU
        WinType = importlib.import_module(p).WinType
        return lambda wf: WinSeqTPU("sum", win, slide, WinType.CB,
                                    batch_len=32, placement="device",
                                    value_of=lambda t: t.value)

    flips = []

    def hooks_for(g):
        def flip():
            done = threading.Event()

            def run():
                try:
                    flips.append(g.replace_lane(
                        "pipe0/win_seq_tpu.0", "host", trigger="script"))
                finally:
                    done.set()
            threading.Thread(target=run, daemon=True).start()
            return done
        return {3000: flip}

    _g, ref, rc = _durable_run("windflow_tpu", make_op_for("windflow_tpu"),
                               n, None, durable=False)
    plan = FaultPlan(seed=13).crash_replica("win_seq_tpu", at_tuple=5200)
    g, wins, counts = _durable_run(pkg, make_op_for(pkg), n,
                                   str(tmp_path / "chaos"), plan=plan,
                                   epochs_at=(1500, 4500),
                                   hooks_for=hooks_for)
    assert flips and flips[0] is not None and flips[0]["new"] == "host"
    assert g._epoch_restored == 2
    assert max(counts.values()) == max(rc.values()) == 1
    assert wins == ref == _cb_oracle(n, 4, win, slide)
