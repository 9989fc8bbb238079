"""Package rules of the port (windflow_tpu_torch) and its small host
pieces: no module of the port, and not chip_smoke.py, imports jax or
the reference package; the umbrella exports the ported names and names
the ROADMAP item of the rest; the profiler hook; the atomic,
lock-guarded build of the port's shared libraries."""
import ast
import os
import pathlib
import threading

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "windflow_tpu")


def _port_sources():
    pkg = REPO / "windflow_tpu_torch"
    return sorted(p for p in pkg.rglob("*.py")
                  if "_build" not in p.relative_to(pkg).parts) + [
        REPO / "chip_smoke.py"]


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            yield node.lineno, node.args[0].value


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_never_imports_jax_or_the_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(line, mod) for line, mod in _imported_modules(tree)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_guard_walks_the_distributed_plane_and_the_scheduler():
    walked = {str(p.relative_to(REPO)) for p in _port_sources()}
    for name in ("partition", "transport", "wiring", "runtime", "worker",
                 "smoke", "wire", "observe", "identity", "__init__"):
        assert f"windflow_tpu_torch/distributed/{name}.py" in walked
    for name in ("errors", "__init__"):
        assert f"windflow_tpu_torch/scheduler/{name}.py" in walked


def test_guard_sees_every_import_form():
    tree = ast.parse("import jax.numpy\nfrom windflow_tpu.core import x\n"
                     "import importlib\n"
                     "importlib.import_module('windflow_tpu.ops')\n")
    mods = [m.split(".")[0] for _line, m in _imported_modules(tree)]
    assert mods.count("jax") == 1 and mods.count("windflow_tpu") == 2


def test_umbrella_exports_ported_names_and_names_the_rest():
    import windflow_tpu_torch as wf
    assert wf.PipeGraph.__module__ == "windflow_tpu_torch.graph.pipegraph"
    assert wf.RuntimeConfig().device == "cuda"
    assert wf.WinSeqTPUBuilder.__module__ == \
        "windflow_tpu_torch.builders.builders_tpu"
    assert wf.KeyFarmBuilder.__module__ == \
        "windflow_tpu_torch.builders.builders"
    assert wf.EpochCoordinator.__module__ == \
        "windflow_tpu_torch.durability.coordinator"
    assert wf.run_with_epochs.__module__ == \
        "windflow_tpu_torch.durability.recovery"
    with pytest.raises(AttributeError, match="ROADMAP.md A10h"):
        wf.Server
    assert wf.ElasticController.__module__ == \
        "windflow_tpu_torch.elastic.controller"
    assert wf.EventTimeWindow.__module__ == \
        "windflow_tpu_torch.eventtime.windows"
    assert wf.Watermark.__module__ == "windflow_tpu_torch.runtime.queues"
    with pytest.raises(AttributeError, match="ROADMAP.md A10h"):
        wf.TenantSpec
    with pytest.raises(AttributeError, match="ROADMAP.md A11"):
        wf.KeyFarmMesh
    # the distributed runtime plane is ported (distributed/)
    assert wf.merge_stats.__module__ == \
        "windflow_tpu_torch.distributed.observe"
    assert wf.wire_table.__module__ == \
        "windflow_tpu_torch.distributed.observe"
    for name, module in (("run_distributed", "runtime"),
                         ("DistributedSpec", "runtime"),
                         ("WorkerFailure", "runtime"),
                         ("plan_partition", "partition"),
                         ("MsgDecoder", "wire")):
        assert getattr(wf, name).__module__ == \
            f"windflow_tpu_torch.distributed.{module}"
    with pytest.raises(AttributeError, match="no attribute"):
        wf.NoSuchName


def _split_forward_group():
    """A distributed spec whose pins put the two ends of one FORWARD
    group (batch_source -> batch_map -> sink) on different workers."""
    from windflow_tpu_torch.distributed.runtime import DistributedSpec
    return DistributedSpec(
        worker_id=0, n_workers=2,
        endpoints=[("127.0.0.1", 0), ("127.0.0.1", 0)],
        assignment={"batch_source": 0, "sink": 1})


@pytest.mark.parametrize("field,value", [
    ("sched_lease", object()),
    # the distributed plane is ported: its partition planner refuses,
    # at start, pins that would split a FORWARD group between workers
    ("distributed", _split_forward_group())])
def test_unported_planes_raise_at_start(field, value):
    import windflow_tpu_torch as wf
    from windflow_tpu_torch.distributed import PartitionError
    from windflow_tpu_torch.operators.basic_ops import Sink
    from windflow_tpu_torch.operators.batch_ops import BatchMap, BatchSource
    cfg = wf.RuntimeConfig(device="cpu")
    setattr(cfg, field, value)
    g = wf.PipeGraph("x", wf.Mode.DEFAULT, config=cfg)
    g.add_source(BatchSource(lambda ctx: None, 1)).add(
        BatchMap(lambda b: b)).add_sink(Sink(lambda item: None))
    if field == "distributed":
        with pytest.raises(PartitionError, match="conflicting"):
            g.start()
    else:
        with pytest.raises(NotImplementedError, match="ROADMAP.md A10h"):
            g.start()


def test_with_slo_starts_and_publishes_the_slo_block():
    """The SLO plane is ported: ``with_slo`` sets ``RuntimeConfig.slo``
    and a started CPU graph publishes the ``Slo`` stats block."""
    import json
    import tempfile
    import windflow_tpu_torch as wf
    from windflow_tpu_torch.operators.basic_ops import Sink
    from windflow_tpu_torch.operators.batch_ops import BatchSource
    from windflow_tpu_torch.slo import SloConfig
    with tempfile.TemporaryDirectory() as tmp:
        cfg = wf.RuntimeConfig(device="cpu", log_dir=tmp)
        g = wf.PipeGraph("x", wf.Mode.DEFAULT, config=cfg)
        assert g.with_slo(p99_ms=5.0, min_throughput_rps=1.0) is g
        assert isinstance(cfg.slo, SloConfig)
        assert cfg.slo.objectives() == {"p99_ms": 5.0,
                                        "min_throughput_rps": 1.0}
        g.add_source(BatchSource(lambda ctx: None, 1)).add_sink(
            Sink(lambda item: None))
        g.run()
        assert g.diagnosis.slo is not None
        g.diagnosis.maybe_tick(force=True)
        slo = json.loads(g.stats.to_json())["Slo"]
        assert slo["Objectives"] == cfg.slo.objectives()
        assert slo["Ticks"] >= 1 and slo["Breaches_total"] == 0


def test_launch_span_is_a_record_function_only_when_asked(monkeypatch):
    import torch
    from windflow_tpu_torch.telemetry import profiler
    monkeypatch.delenv("WINDFLOW_TORCH_PROFILE", raising=False)
    profiler.reset()
    assert not isinstance(profiler.launch_span("x"),
                          torch.profiler.record_function)
    monkeypatch.setenv("WINDFLOW_TORCH_PROFILE", "1")
    profiler.reset()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with profiler.launch_span("windflow/window_launch"):
                torch.ones(4).sum()
        names = {e.key for e in prof.key_averages()}
        assert "windflow/window_launch" in names
    finally:
        monkeypatch.delenv("WINDFLOW_TORCH_PROFILE")
        profiler.reset()


def test_build_is_atomic_under_concurrent_builders(tmp_path, monkeypatch):
    """Several processes' worth of builders race on one library: each
    sees a complete file, the compiler runs once, and a source change
    rebuilds."""
    from windflow_tpu_torch.runtime import build
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    src = tmp_path / "lib.src"
    src.write_text("v1")
    runs = tmp_path / "runs"
    runs.write_text("")
    script = tmp_path / "cc.sh"
    script.write_text(f'echo x >> "{runs}"; sleep 0.2; cp "$1" "$2"\n')
    cmd = ["sh", str(script), str(src), build.OUT]
    paths, errors = [], []

    def one():
        try:
            paths.append(build.build_shared("libx.so", cmd, [str(src)]))
        except Exception as e:  # surfaced by the assertion below
            errors.append(e)

    threads = [threading.Thread(target=one) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errors and len(set(paths)) == 1 and len(paths) == 6
    assert pathlib.Path(paths[0]).read_text() == "v1"
    assert runs.read_text().count("x") == 1
    assert not [p for p in os.listdir(tmp_path / "_build")
                if p.endswith(".tmp")]
    # a newer source rebuilds
    src.write_text("v2")
    os.utime(src, (os.path.getmtime(paths[0]) + 10,) * 2)
    assert pathlib.Path(build.build_shared(
        "libx.so", cmd, [str(src)])).read_text() == "v2"
    assert runs.read_text().count("x") == 2
