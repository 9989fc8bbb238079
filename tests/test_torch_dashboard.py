"""The port's dashboard (windflow_tpu_torch/monitoring/dashboard.py and
webui.py) and doctor CLI (windflow_tpu_torch/doctor.py) held against
the reference's: twins of tests/test_monitoring.py::
test_dashboard_http_webui and ::test_webui_script_structure,
tests/test_telemetry.py::test_metrics_endpoint_serves_traced_graph, and
tests/test_diagnosis.py::test_doctor_cli_names_bottleneck_from_offline_dump,
::test_doctor_cli_rejects_missing_dump and
::test_dashboard_flight_and_explain_endpoints.

Each graph runs in both packages on the same records (the port with
``device="cpu"``), each reporting to its own package's dashboard; both
meet the reference test's assertions, and their sinks receive the same
windows or records.  Two choices keep the twins steady when the host is
loaded, where the reference's tests are not (ROADMAP.md C3): endpoints
are read once the app has deregistered (its final report applied), and
the slow map sleeps 5 ms a tuple (0.8 ms in the reference) over fewer
tuples.  Every server binds port 0 and is stopped in a ``finally``;
every graph writes its logs under the test's temporary directory.
"""
import contextlib
import json
import re
import time
import urllib.request
import warnings

import numpy as np
import pytest

from torch_graphs import (PACKAGES, PORT, Collector, cpu_config, doctor,
                          mod, record_source)

REF = PACKAGES[0]
# the slow map's sleep a tuple: slow enough that the sink's inbound
# channel is empty at nearly every audit pass, so the sink's frontier
# never reads as held back when six test workers share the host
SLOW_S = 0.005
SETTLE_S = 20.0


@contextlib.contextmanager
def dashboard(pkg):
    """A ``DashboardServer`` and its HTTP front, both on port 0; yields
    ``(dash, get)`` with ``get(path) -> (content type, body)``."""
    dmod = mod(pkg, "monitoring.dashboard")
    dash = dmod.DashboardServer(port=0)
    dash.start()
    httpd = None
    try:
        httpd = dmod.serve_http(dash, port=0)
        port = httpd.server_address[1]

        def get(path):
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                        timeout=5) as r:
                return r.headers["Content-Type"], r.read().decode()

        yield dash, get
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        dash.stop()


def settled(get):
    """``/apps`` once every registered app has deregistered: its final
    report, sent at ``wait_end``, has then been applied by the
    dashboard's connection thread."""
    deadline = time.time() + SETTLE_S
    while True:
        apps = json.loads(get("/apps")[1])
        assert apps, "the graph did not register"
        if not any(a["active"] for a in apps.values()) \
                or time.time() > deadline:
            return apps
        time.sleep(0.05)


# ---------------------------------------------------------------------------
# test_monitoring.py: the web page and the registered app
# ---------------------------------------------------------------------------

def small_graph(pkg, config, rows):
    wf = __import__(pkg)
    BasicRecord = mod(pkg, "core").BasicRecord
    g = wf.PipeGraph("traced", wf.Mode.DEFAULT, config)
    state = {}

    def src(shipper, ctx):
        i = state.setdefault("i", 0)
        if i >= 50:
            return False
        shipper.push(BasicRecord(i % 2, i // 2, i, float(i)))
        state["i"] = i + 1
        return True

    def ident(t):
        pass

    g.add_source(wf.SourceBuilder(src).build()) \
        .add(wf.MapBuilder(ident).with_parallelism(2).build()) \
        .add_sink(wf.SinkBuilder(rows).build())
    return g


def _webui(pkg, tmp_path):
    rows = Collector()
    with dashboard(pkg) as (dash, get):
        cfg = cpu_config(pkg, tracing=True, log_dir=str(tmp_path / pkg),
                         dashboard_port=dash.port)
        small_graph(pkg, cfg, rows).run()
        ctype, html = get("/")
        assert ctype.startswith("text/html")
        for marker in ("parseDot", "sparkline", "Device_launches",
                       "/apps"):
            assert marker in html, marker
        assert get("/apps")[0].startswith("application/json")
        (app,) = settled(get).values()
        assert app["diagram"].lstrip().startswith("<svg")
        assert app["report"]["PipeGraph_name"] == "traced"
        assert not app["active"], "graph deregistered at wait_end"
    ops = sorted(op["Operator_name"] for op in app["report"]["Operators"])
    return sorted(rows.results), ops, app["diagram"]


def test_dashboard_http_webui(tmp_path):
    want = _webui(REF, tmp_path)
    got = _webui(PORT, tmp_path)
    assert got == want
    assert len(got[0]) == 50


def _title_free(page):
    return re.sub(r"WindFlow[^<]*dashboard[^<]*", "", page)


def test_webui_script_structure():
    """The reference's structural lint of the page's embedded script,
    over the port's page; the page equals the reference's but for its
    title."""
    from windflow_tpu.monitoring.webui import HTML_PAGE as REF_PAGE
    from windflow_tpu_torch.monitoring.webui import HTML_PAGE
    assert _title_free(HTML_PAGE) == _title_free(REF_PAGE)
    assert HTML_PAGE != REF_PAGE
    m = re.search(r"<script>\n(.*?)</script>", HTML_PAGE, re.S)
    assert m, "no script block"
    src = m.group(1)
    legit = ("\\\\n", "\\\\s", "\\\\w", "\\\\[", "\\\\]", "\\\\.",
             "\\\\(")
    stripped = src
    for esc in legit:
        stripped = stripped.replace(esc, "")
    assert "\\\\" not in stripped, \
        "unresolved double backslash outside regex"
    stack = []
    pairs = {")": "(", "]": "[", "}": "{"}
    i, n, state = 0, len(src), None
    while i < n:
        c = src[i]
        if state is None:
            if c == "/" and i + 1 < n and src[i + 1] == "/":
                i = src.find("\n", i)
                i = n if i < 0 else i
                continue
            if c == "/" and i + 1 < n and src[i + 1] == "*":
                end = src.find("*/", i + 2)
                assert end >= 0, f"unterminated block comment at {i}"
                i = end + 2
                continue
            if c == "/":
                j = i - 1
                while j >= 0 and src[j] in " \t\n":
                    j -= 1
                word = re.search(r"[A-Za-z$_]+$", src[:j + 1])
                if (j < 0 or src[j] in "(,=:[!&|?{;"
                        or (src[j] == ">" and j > 0 and src[j - 1] == "=")
                        or (word and word.group(0) in (
                            "return", "typeof", "case", "in", "of",
                            "new", "delete", "void", "instanceof"))):
                    in_class = False
                    i += 1
                    while i < n:
                        if src[i] == "\\":
                            i += 2
                            continue
                        if src[i] == "[":
                            in_class = True
                        elif src[i] == "]":
                            in_class = False
                        elif src[i] == "/" and not in_class:
                            break
                        i += 1
                    i += 1
                    continue
            if c == "}" and stack and stack[-1][0] == "${":
                stack.pop()
                state = "`"
            elif c in "\"'`":
                state = c
            elif c in "([{":
                stack.append((c, i))
            elif c in ")]}":
                assert stack and stack[-1][0] == pairs[c], \
                    f"unbalanced {c!r} at offset {i}"
                stack.pop()
        else:
            if c == "\\":
                i += 2
                continue
            assert not (c == "\n" and state in "\"'"), \
                f"unterminated {state} string literal before offset {i}"
            if state == "`" and c == "$" and i + 1 < n and src[i + 1] == "{":
                stack.append(("${", i))
                state = None
                i += 2
                continue
            if c == state:
                state = None
        i += 1
    assert state is None, f"unterminated {state} literal"
    assert not stack, f"unclosed {stack[-3:]}"


# ---------------------------------------------------------------------------
# test_telemetry.py: /metrics over a traced window graph
# ---------------------------------------------------------------------------

def replay_windowed_graph(pkg, tmp_path, n, port):
    """The reference's ingest-fed windowed run: replay source ->
    WinSeqTPU(sum) -> sink, reporting to the dashboard at ``port``."""
    wf = __import__(pkg)
    TupleBatch = mod(pkg, "core.tuples").TupleBatch
    WinSeqTPU = mod(pkg, "operators.tpu.win_seq_tpu").WinSeqTPU
    Sink = mod(pkg, "operators.basic_ops").Sink
    keys = np.arange(n, dtype=np.int64)
    ids = keys // 4
    trace = TupleBatch({"key": keys % 4, "id": ids, "ts": ids,
                        "value": np.ones(n, np.float32)})
    src = wf.SourceBuilder.from_replay(trace, speedup=None, chunk=8192) \
        .with_tracing(2).build()
    cfg = cpu_config(pkg, tracing=True, log_dir=str(tmp_path / pkg),
                     latency_target_ms=50.0, dashboard_port=port)
    g = wf.PipeGraph("telem_win", wf.Mode.DEFAULT, cfg)
    op = WinSeqTPU("sum", 128, 64, wf.WinType.TB, batch_len=256,
                   emit_batches=True)
    wins = []

    def sink(b):
        if b is not None and hasattr(b, "cols"):
            wins.append(np.stack([np.asarray(b.key, np.float64),
                                  np.asarray(b.id, np.float64),
                                  np.asarray(b["value"], np.float64)]))

    g.add_source(src).add(op).add_sink(Sink(sink))
    return g, wins


def _metrics(pkg, tmp_path):
    with dashboard(pkg) as (dash, get):
        g, wins = replay_windowed_graph(pkg, tmp_path, 60_000, dash.port)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            g.run()
        settled(get)
        ctype, text = get("/metrics")
    assert "openmetrics-text" in ctype
    assert text.endswith("# EOF\n")
    assert "windflow_inputs_total" in text
    assert "windflow_service_time_seconds_bucket" in text
    assert "windflow_e2e_latency_seconds_count" in text
    m = [ln for ln in text.splitlines()
         if ln.startswith("windflow_e2e_latency_seconds_count")]
    assert m and float(m[0].rsplit(" ", 1)[1]) > 0
    w = np.concatenate(wins, axis=1)
    w = w[:, np.lexsort((w[1], w[0]))]
    families = sorted({ln.split()[2] for ln in text.splitlines()
                       if ln.startswith("# TYPE")})
    return w, families


def test_metrics_endpoint_serves_traced_graph(tmp_path):
    want, ref_families = _metrics(REF, tmp_path)
    got, families = _metrics(PORT, tmp_path)
    np.testing.assert_array_equal(got, want)
    assert got.shape[1] > 0
    assert families == ref_families


# ---------------------------------------------------------------------------
# test_diagnosis.py: the doctor over an offline dump; /flight, /explain
# ---------------------------------------------------------------------------

def slow_map_graph(pkg, tmp_path, n, par, rows, sleep_s=SLOW_S, **kw):
    """The reference's source -> deliberately slow map -> sink."""
    wf = __import__(pkg)
    kw.setdefault("tracing", True)
    kw.setdefault("trace_sample", 4)
    kw.setdefault("log_dir", str(tmp_path / pkg))
    kw.setdefault("queue_capacity", 64)
    kw.setdefault("audit_interval_s", 0.05)
    kw.setdefault("diagnosis_interval_s", 0.05)
    g = wf.PipeGraph(f"diag_slow{par}", wf.Mode.DEFAULT,
                     cpu_config(pkg, **kw))

    def slow(t):
        time.sleep(sleep_s)
        return None

    g.add_source(wf.SourceBuilder(record_source(pkg, n)).build()) \
        .add(wf.MapBuilder(slow).with_name("slowmap")
             .with_parallelism(par).build()) \
        .add_sink(wf.SinkBuilder(rows).build())
    return g


def _offline_dump(pkg, tmp_path):
    rows = Collector()
    g = slow_map_graph(pkg, tmp_path, 800, 2, rows)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        g.run()
    d = tmp_path / pkg
    assert list(d.glob("*_stats.json")) or list(d.glob("*.json"))
    rc, out, _err = doctor(pkg, [str(d)])
    assert rc == 0
    assert "pipe0/slowmap" in out
    assert "bottleneck" in out
    assert "share sum" in out
    rc, out, _err = doctor(pkg, [str(d), "--json"])
    assert rc == 0
    rep = json.loads(out)
    assert rep["Bottleneck"]["Operator"] == "pipe0/slowmap"
    assert rep["Attribution"]["Share_sum"] == pytest.approx(1.0, abs=0.02)
    return sorted(rows.results), rep["Graph"], rep["Bottleneck"]["Operator"]


def test_doctor_cli_names_bottleneck_from_offline_dump(tmp_path):
    want = _offline_dump(REF, tmp_path)
    got = _offline_dump(PORT, tmp_path)
    assert got == want and len(got[0]) == 800


def test_doctor_cli_rejects_missing_dump(tmp_path):
    out = [doctor(pkg, [str(tmp_path / "empty")]) for pkg in PACKAGES]
    assert out[1] == out[0]
    rc, _out, err = out[1]
    assert rc == 2 and "doctor:" in err


def _flight_explain(pkg, tmp_path):
    rows = Collector()
    with dashboard(pkg) as (dash, get):
        g = slow_map_graph(pkg, tmp_path, 1600, 2, rows,
                           dashboard_port=dash.port)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            g.start()
            g._monitor.interval_s = 0.1
            g.wait_end()
        settled(get)
        ex = json.loads(get("/explain")[1])
        assert ex, "no app reported to the dashboard"
        rep = next(iter(ex.values()))
        assert rep["Graph"] == "diag_slow2"
        assert rep["Bottleneck"]["Operator"] == "pipe0/slowmap"
        fl = json.loads(get("/flight")[1])
        assert isinstance(next(iter(fl.values())), list)
        met = get("/metrics")[1]
        assert "windflow_regressions_active" in met
        assert "windflow_bottleneck_score" in met
    return sorted(rows.results), rep["Graph"], rep["Bottleneck"]["Operator"]


def test_dashboard_flight_and_explain_endpoints(tmp_path):
    want = _flight_explain(REF, tmp_path)
    got = _flight_explain(PORT, tmp_path)
    assert got == want and len(got[0]) == 1600
