"""The port's restore into a different parallelism
(``utils/checkpoint._repartition_group`` through the elastic
``partition_keyed_state``) held against the reference's
(tests/test_recovery_rescale.py):

* ``restore_states`` with overrides: the same 2-replica manifest loads
  into 4 and into 1 replicas with the same per-replica key sets as the
  reference; a structure mismatch and a key held by two slices raise
  the reference's errors;
* crash at accumulator parallelism 2, restart at 4, at 1 and at 2
  (``run_with_epochs(parallelism_overrides=...)``): every effect exactly
  once, per key equal to the closed form and to the reference's clean
  run, the repartition named in the ``epoch_restore`` flight event, and
  the ledger identity exact (the port's aligner counts a barrier once,
  ROADMAP.md C2).

The durable graphs begin their epochs at fixed stream indices and wait
for each commit (``torch_graphs.gated_source``), so the restored epoch
is asserted exactly.
"""
import importlib
import pickle

import pytest

from torch_graphs import (PACKAGES, PORT, Effects, acc_graph, acc_oracle,
                          assert_ledger_exact, effects_per_key, mod,
                          reference_clean)

REF = PACKAGES[0]
N = 4000
EPOCHS_AT = (1000, 2000, 3000)


# ---------------------------------------------------------------------------
# unit: restore_states with overrides
# ---------------------------------------------------------------------------

def _built_acc_graph(pkg, par):
    """An unstarted accumulator graph at ``par`` replicas, wired far
    enough for ``iter_logics`` to walk it."""
    wf = importlib.import_module(pkg)
    BasicRecord = mod(pkg, "core").BasicRecord

    def acc(t, a):
        a.value += t.value

    cfg = wf.RuntimeConfig()
    if pkg == PORT:
        cfg.device = "cpu"
    g = wf.PipeGraph("repart_unit", config=cfg)
    g.add_source(wf.SourceBuilder(lambda shipper, ctx: False).build()) \
        .add(wf.AccumulatorBuilder(acc)
             .with_initial_value(BasicRecord(value=0.0))
             .with_parallelism(par).build()) \
        .add_sink(wf.SinkBuilder(lambda r: None).build())
    return g


def _acc_logics(pkg, g):
    iter_logics = mod(pkg, "graph.fuse").iter_logics
    return {name: logic for name, logic in iter_logics(g)
            if "accumulator" in name}


def _manifest(pkg, layout):
    """A 2-replica donor's manifest: replica i holds ``layout[i]``
    (key -> value)."""
    BasicRecord = mod(pkg, "core").BasicRecord
    logics = _acc_logics(pkg, _built_acc_graph(pkg, 2))
    for name, lg in logics.items():
        idx = int(name.rsplit(".", 1)[1])
        lg.load_keyed_state({k: BasicRecord(key=k, value=v)
                             for k, v in layout[idx].items()})
    return {name: pickle.dumps(lg.state_dict())
            for name, lg in logics.items()}


def _restored_layout(pkg, manifest, new_par):
    restore_states = mod(pkg, "utils.checkpoint").restore_states
    target = _built_acc_graph(pkg, new_par)
    n = restore_states(target, dict(manifest), "test manifest",
                       decode=pickle.loads,
                       overrides={"accumulator": new_par})
    assert n == new_par
    out = {}
    for name, lg in _acc_logics(pkg, target).items():
        out[int(name.rsplit(".", 1)[1])] = {
            k: v.value for k, v in lg.keyed_state_dict().items()}
    return out


@pytest.mark.parametrize("new_par", [4, 1])
def test_restore_states_repartitions_across_parallelism(new_par):
    """A 2-replica manifest loads into 4 and 1 replicas: the union of
    the keyed state is kept exactly, every key lands on its hash % n
    owner, and the per-replica layout is the reference's."""
    all_keys = {k: float(k) for k in range(40)}
    layouts = {}
    for pkg in PACKAGES:
        parts = mod(pkg, "elastic").partition_keyed_state(all_keys, 2)
        layouts[pkg] = _restored_layout(pkg, _manifest(pkg, parts),
                                        new_par)
    assert layouts[PORT] == layouts[REF]
    want = mod(PORT, "elastic").partition_keyed_state(all_keys, new_par)
    assert layouts[PORT] == dict(enumerate(want))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_restore_states_structure_mismatch_names_overrides(pkg):
    restore_states = mod(pkg, "utils.checkpoint").restore_states
    manifest = _manifest(pkg, [{0: 1.0}, {1: 1.0}])
    target = _built_acc_graph(pkg, 3)
    with pytest.raises(RuntimeError, match="structure mismatch"):
        restore_states(target, dict(manifest), "test manifest",
                       decode=pickle.loads)
    with pytest.raises(RuntimeError,
                       match="matched no repartitionable group"):
        restore_states(target, dict(manifest), "test manifest",
                       decode=pickle.loads,
                       overrides={"no_such_operator": 3})


@pytest.mark.parametrize("pkg", PACKAGES)
def test_restore_states_duplicate_key_across_slices_aborts(pkg):
    restore_states = mod(pkg, "utils.checkpoint").restore_states
    manifest = _manifest(pkg, [{7: 1.0}, {7: 1.0}])   # both own key 7
    target = _built_acc_graph(pkg, 4)
    with pytest.raises(RuntimeError, match="more than one manifest"):
        restore_states(target, dict(manifest), "test manifest",
                       decode=pickle.loads,
                       overrides={"accumulator": 4})


# ---------------------------------------------------------------------------
# end to end: crash at parallelism 2, restart into another
# ---------------------------------------------------------------------------

def _restart_into(tmp_path, new_par, seed, at_tuple):
    FaultPlan = mod(PORT, "resilience").FaultPlan
    eff = Effects()
    pars = []

    def factory(attempt):
        par = 2 if attempt == 0 else new_par
        pars.append(par)
        plan = (FaultPlan(seed=seed).crash_replica("accumulator",
                                                   at_tuple=at_tuple)
                if attempt == 0 else None)
        return acc_graph(PORT, N, str(tmp_path / "epochs"), eff, plan=plan,
                         epochs_at=EPOCHS_AT, acc_par=par)

    g = mod(PORT, "durability").run_with_epochs(
        factory, max_restarts=2,
        parallelism_overrides={"accumulator": new_par})
    return g, eff, pars


def _exactly_once(rows, tmp_path):
    assert len(rows) == N and len(set(rows)) == N, len(rows)
    ref = reference_clean(str(tmp_path / "ref_clean"), N)
    assert effects_per_key(rows) == acc_oracle(N) == ref


@pytest.mark.parametrize("new_par", [4, 1])
def test_chaos_restart_into_different_parallelism(tmp_path, new_par):
    """Crash mid-stream at accumulator parallelism 2, rebuild at 4 and
    at 1: the resumed run's effects are exactly once and per key equal
    to the reference's uninterrupted run, the repartition is named in
    the ``epoch_restore`` event, and the ledger is exact."""
    g, eff, pars = _restart_into(tmp_path, new_par, seed=3, at_tuple=1200)
    assert pars == [2, new_par]
    assert g._epoch_restored == 2
    _exactly_once(eff.rows, tmp_path)
    ev = [e for e in g.flight.snapshot() if e["kind"] == "epoch_restore"]
    assert ev and ev[-1].get("repartitioned") == ["accumulator"]
    assert g.durability.committed > g._epoch_restored
    assert_ledger_exact(g)


def test_same_parallelism_override_is_harmless(tmp_path):
    """An override naming the same replica count degenerates to the
    exact-structure path and restores cleanly."""
    g, eff, pars = _restart_into(tmp_path, 2, seed=7, at_tuple=900)
    assert pars == [2, 2]
    assert g._epoch_restored == 1
    _exactly_once(eff.rows, tmp_path)
    ev = [e for e in g.flight.snapshot() if e["kind"] == "epoch_restore"]
    # the event names the declared overrides, as the reference's does
    assert ev and ev[-1].get("repartitioned") == ["accumulator"]
    assert_ledger_exact(g)

