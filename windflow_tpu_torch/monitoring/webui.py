"""Self-contained HTML front-end for the dashboard.

The reference's dashboard is a Java Spring + React app (README "Web
Dashboard"; its directory is empty in the snapshot).  This module is
the renderer-free equivalent: one dependency-free HTML page, served by
``dashboard.serve_http`` at ``/``, that polls the ``/apps`` JSON
snapshot once a second and renders

* per-app stat tiles (throughput, memory, dropped tuples, replicas),
* the PipeGraph topology (parsed client-side from the DOT diagram the
  MonitoringThread registers -- multipipe.hpp:522-591 equivalent),
* a throughput sparkline built from successive report deltas,
* the per-operator replica table (stats_record.hpp:45-165 counters).

No external assets: the page must work on an air-gapped GPU host.
"""

HTML_PAGE = """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>WindFlow dashboard (PyTorch/CUDA port)</title>
<style>
  .viz-root {
    color-scheme: light;
    --surface-1: #fcfcfb; --surface-2: #f1f0ee;
    --text-primary: #0b0b0b; --text-secondary: #52514e;
    --series-1: #2a78d6; --grid: #e3e2df;
    --status-good: #008300; --status-serious: #e34948;
  }
  @media (prefers-color-scheme: dark) {
    :root:where(:not([data-theme="light"])) .viz-root {
      color-scheme: dark;
      --surface-1: #1a1a19; --surface-2: #242423;
      --text-primary: #ffffff; --text-secondary: #c3c2b7;
      --series-1: #3987e5; --grid: #33332f;
      --status-good: #35b559; --status-serious: #e66767;
    }
  }
  body { margin: 0; }
  .viz-root {
    font: 14px/1.45 system-ui, sans-serif; background: var(--surface-1);
    color: var(--text-primary); min-height: 100vh; padding: 20px 24px;
    box-sizing: border-box;
  }
  h1 { font-size: 17px; font-weight: 600; margin: 0 0 4px; }
  .sub { color: var(--text-secondary); font-size: 12px; margin: 0 0 18px; }
  .app { border: 1px solid var(--grid); border-radius: 8px;
         padding: 14px 16px; margin-bottom: 16px; }
  .app h2 { font-size: 14px; font-weight: 600; margin: 0 8px 0 0;
            display: inline-block; }
  .badge { font-size: 11px; border-radius: 9px; padding: 1px 8px;
           vertical-align: 1px; }
  .badge.live  { color: var(--status-good);
                 border: 1px solid var(--status-good); }
  .badge.ended { color: var(--status-serious);
                 border: 1px solid var(--status-serious); }
  .tiles { display: flex; flex-wrap: wrap; gap: 10px; margin: 12px 0; }
  .tile { background: var(--surface-2); border-radius: 6px;
          padding: 8px 14px; min-width: 110px; }
  .tile .v { font-size: 20px; font-weight: 600; font-variant-numeric:
             tabular-nums; }
  .tile .v.bad { color: var(--status-serious); }
  .tile .k { color: var(--text-secondary); font-size: 11px; }
  svg text { fill: var(--text-secondary); font: 11px system-ui, sans-serif; }
  .topo rect { fill: var(--surface-2); stroke: var(--grid); rx: 4; }
  .topo text.op { fill: var(--text-primary); }
  .topo path { stroke: var(--text-secondary); fill: none;
               stroke-width: 1.2; }
  table { border-collapse: collapse; width: 100%; margin-top: 10px;
          font-variant-numeric: tabular-nums; }
  th { text-align: right; color: var(--text-secondary); font-weight: 500;
       font-size: 11px; padding: 4px 10px; border-bottom: 1px solid
       var(--grid); }
  th:first-child, td:first-child { text-align: left; }
  td { text-align: right; padding: 4px 10px; border-bottom: 1px solid
       var(--grid); }
  .spark-wrap { position: relative; margin-top: 6px; }
  .hist-row { display: flex; flex-wrap: wrap; gap: 14px; margin-top: 6px; }
  .hist-row .k { color: var(--text-secondary); font-size: 11px; }
  #tip { position: fixed; pointer-events: none; display: none;
         background: var(--surface-2); border: 1px solid var(--grid);
         border-radius: 4px; padding: 2px 8px; font-size: 11px;
         color: var(--text-primary); z-index: 9; }
</style>
</head>
<body>
<div class="viz-root">
  <h1>WindFlow dashboard (PyTorch/CUDA port)</h1>
  <p class="sub">polling <code>/apps</code> every second &mdash; framed-TCP
  ingest from traced PipeGraphs (RuntimeConfig.tracing)</p>
  <div id="apps"><p class="sub">no applications registered yet</p></div>
  <div id="tip"></div>
</div>
<script>
"use strict";
const hist = {};           // app id -> [{t, outputs}] report-delta history
// counters come off the wire: coerce before arithmetic so a malformed
// report cannot smuggle strings through the sums into the markup
const num = v => { const n = Number(v); return isFinite(n) ? n : 0; };
const fmt = v => { const n = num(v);
  return n >= 1e9 ? (n / 1e9).toFixed(2) + "B"
       : n >= 1e6 ? (n / 1e6).toFixed(2) + "M"
       : n >= 1e3 ? (n / 1e3).toFixed(1) + "k" : String(n); };
// names come off the wire (any local process can register an app) --
// escape everything interpolated into innerHTML
const esc = s => String(s).replace(/[&<>"']/g, c => ({"&": "&amp;",
  "<": "&lt;", ">": "&gt;", '"': "&quot;", "'": "&#39;"}[c]));

function svgImg(svg) {
  // foreign SVG payloads render as an <img> data URI: an image context
  // never executes scripts or event handlers, unlike raw injection
  const b64 = btoa(unescape(encodeURIComponent(svg)));
  return `<img class="topo" alt="topology" ` +
         `src="data:image/svg+xml;base64,${b64}">`;
}

function parseDot(src) {
  const nodes = [], labels = {}, edges = [];
  for (const line of (src || "").split("\\n")) {
    // labels use DOT double-quoted-string escaping (graph_to_dot):
    // match escaped sequences so a quote in an operator name does not
    // truncate the label, then unescape for display
    let m = line.match(/^\\s*(\\w+)\\s*\\[label="((?:[^"\\\\]|\\\\.)*)"/);
    if (m) {
      nodes.push(m[1]);
      labels[m[1]] = m[2].replace(/\\\\(.)/g, "$1");
      continue;
    }
    m = line.match(/^\\s*(\\w+)\\s*->\\s*(\\w+)/);
    if (m) edges.push([m[1], m[2]]);
  }
  return { nodes, labels, edges };
}

function topoSvg(g) {
  if (!g.nodes.length) return "";
  const depth = {};                       // longest path from a root
  for (let pass = 0; pass <= g.nodes.length; pass++)
    for (const [a, b] of g.edges)
      depth[b] = Math.max(depth[b] || 0, (depth[a] || 0) + 1);
  const cols = {};
  for (const n of g.nodes) (cols[depth[n] || 0] ||= []).push(n);
  const CW = 148, RH = 40, pos = {};
  let H = 0;
  for (const [c, ns] of Object.entries(cols)) {
    ns.forEach((n, i) => pos[n] = [8 + c * CW, 8 + i * RH]);
    H = Math.max(H, ns.length * RH);
  }
  const W = 8 + (Object.keys(cols).length) * CW;
  let s = `<svg class="topo" width="${W}" height="${H + 10}"
    role="img" aria-label="pipeline topology">`;
  for (const [a, b] of g.edges) {
    if (!pos[a] || !pos[b]) continue;   // edge to an undeclared node
    const [x1, y1] = pos[a], [x2, y2] = pos[b];
    s += `<path d="M ${x1 + 128} ${y1 + 13} C ${x1 + 140} ${y1 + 13},
      ${x2 - 12} ${y2 + 13}, ${x2} ${y2 + 13}" />`;
  }
  for (const n of g.nodes) {
    const [x, y] = pos[n], lab = g.labels[n] || n;
    s += `<rect x="${x}" y="${y}" width="128" height="26" rx="4"></rect>
      <text class="op" x="${x + 64}" y="${y + 17}" text-anchor="middle">
      ${esc(lab.length > 18 ? lab.slice(0, 17) + "\\u2026" : lab)}</text>`;
  }
  return s + "</svg>";
}

function sparkline(id, h) {
  if (h.length < 2) return "";
  const W = 320, H = 48, rates = [];
  for (let i = 1; i < h.length; i++) {
    const dt = (h[i].t - h[i - 1].t) / 1000 || 1;
    rates.push(Math.max(0, (h[i].outputs - h[i - 1].outputs) / dt));
  }
  const mx = Math.max(...rates, 1);
  const pts = rates.map((r, i) =>
    [8 + i * (W - 16) / Math.max(1, rates.length - 1),
     H - 6 - r / mx * (H - 16), r]);
  let s = `<svg width="${W}" height="${H}" data-app="${esc(id)}"
    class="spark" role="img" aria-label="output rate">`;
  s += `<line x1="8" y1="${H - 6}" x2="${W - 8}" y2="${H - 6}"
    stroke="var(--grid)" />`;
  s += `<polyline fill="none" stroke="var(--series-1)" stroke-width="2"
    points="${pts.map(p => p[0].toFixed(1) + "," + p[1].toFixed(1)).join(" ")}" />`;
  const last = pts[pts.length - 1];
  s += `<circle cx="${last[0]}" cy="${last[1]}" r="3"
    fill="var(--series-1)" />`;
  s += `<text x="${W - 8}" y="10" text-anchor="end">${fmt(last[2])}/s</text>`;
  return s + "</svg>";
}

function hookHover() {
  const tip = document.getElementById("tip");
  document.querySelectorAll("svg.spark").forEach(sv => {
    sv.onmousemove = e => {
      const h = hist[sv.dataset.app] || [];
      if (h.length < 2) return;
      const r = sv.getBoundingClientRect();
      const i = Math.min(h.length - 2, Math.max(0, Math.round(
        (e.clientX - r.left - 8) / (r.width - 16) * (h.length - 2))));
      const dt = (h[i + 1].t - h[i].t) / 1000 || 1;
      tip.textContent = fmt((h[i + 1].outputs - h[i].outputs) / dt)
        + " results/s";
      tip.style.left = (e.clientX + 12) + "px";
      tip.style.top = (e.clientY - 10) + "px";
      tip.style.display = "block";
    };
    sv.onmouseleave = () => tip.style.display = "none";
  });
}

// latency pretty-printer: log-bucketed histogram values in microseconds
const lus = v => { const n = num(v);
  return n >= 1e6 ? (n / 1e6).toFixed(2) + "s"
       : n >= 1e3 ? (n / 1e3).toFixed(1) + "ms" : n.toFixed(0) + "us"; };

// diagnosis plane: server-side gauge-history sparklines (the History
// stats block -- trends survive a page reload, unlike the client-side
// report-delta history above)
function histSpark(label, vals, fmtfn) {
  if (!vals || vals.length < 2) return "";
  const W = 150, H = 36;
  const mx = Math.max(...vals), mn = Math.min(...vals, 0);
  const pts = vals.map((v, i) =>
    [4 + i * (W - 8) / (vals.length - 1),
     H - 8 - (num(v) - mn) / ((mx - mn) || 1) * (H - 18)]);
  return `<div><svg width="${W}" height="${H}" role="img"
      aria-label="${esc(label)}">
    <line x1="4" y1="${H - 8}" x2="${W - 4}" y2="${H - 8}"
      stroke="var(--grid)" />
    <polyline fill="none" stroke="var(--series-1)" stroke-width="1.5"
      points="${pts.map(p => p[0].toFixed(1) + "," + p[1].toFixed(1)).join(" ")}" />
    <text x="${W - 4}" y="10" text-anchor="end">
      ${fmtfn(vals[vals.length - 1])}</text>
  </svg><div class="k">${esc(label)}</div></div>`;
}

function historyRow(hist) {
  const s = (hist || {}).Series || {};
  if (!(hist || {}).Len) return "";
  return `<div class="hist-row">
    ${histSpark("results/s (history)", s.throughput_rps, fmt)}
    ${histSpark("e2e p99", s.e2e_p99_us, lus)}
    ${histSpark("frontier lag", s.frontier_lag_ms,
                v => num(v).toFixed(0) + "ms")}
    ${histSpark("queue depth", s.queue_depth, fmt)}
  </div>`;
}

// audit plane: keyed-state census + hot-key skew (Skew block)
function skewTable(skew) {
  if (!skew) return "";
  const hot = (skew.Hot_keys || []).filter(h => num(h.observed) > 0);
  const census = (skew.Census || []).filter(c => num(c.keys) > 0);
  if (!hot.length && !census.length) return "";
  let s = "";
  if (hot.length) {
    s += `<table><thead><tr><th>keyby edge</th><th>hot key</th>
      <th>share</th><th>est count</th><th>observed</th></tr></thead><tbody>`;
    for (const h of hot) {
      const top = (h.top || [])[0] || [];
      s += `<tr><td>${esc(h.operator)}</td><td>${esc(top[0])}</td>
        <td>${(num(h.share) * 100).toFixed(1)}%</td>
        <td>${fmt(top[1])}</td><td>${fmt(h.observed)}</td></tr>`;
    }
    s += "</tbody></table>";
  }
  if (census.length) {
    s += `<table><thead><tr><th>keyed state (replica)</th>
      <th>keys</th><th>est bytes</th><th>tiers</th></tr></thead><tbody>`;
    for (const c of census) {
      // tiered stores (state/tiers.py): per-tier key/byte splits
      const tiers = c.tiers ?
        Object.entries(c.tiers).filter(([, v]) => num(v[0]) > 0)
          .map(([t, v]) => `${esc(t)}:${fmt(v[0])}k/${fmt(v[1])}B`)
          .join(" ") : "–";
      s += `<tr><td>${esc(c.replica)}</td><td>${fmt(c.keys)}</td>
        <td>${fmt(c.bytes_est)}B</td><td>${tiers || "–"}</td></tr>`;
    }
    s += "</tbody></table>";
  }
  return s;
}

function opRow(op) {
  const rs = op.Replicas || [];
  const sum = k => rs.reduce((a, r) => a + num(r[k]), 0);
  const svc = rs.length ?
    rs.reduce((a, r) => a + num(r.Service_time_usec), 0) / rs.length : 0;
  // telemetry plane: merged per-operator latency histograms
  const lat = op.Latency || {};
  const svcH = lat.service || {}, resH = lat.residency || {};
  const svcP = svcH.n ? `${lus(svcH.p50_us)}/${lus(svcH.p99_us)}` : "–";
  const resP = resH.n ? lus(resH.p99_us) : "–";
  // ingest replicas report credits / queue depth / controller batch
  // size; other operators render a dash
  const ing = rs.some(r => "Ingest_batch_size" in r) ?
    `${fmt(sum("Ingest_credits"))}cr q${fmt(sum("Ingest_queue_depth"))} ` +
    `b${fmt(sum("Ingest_batch_size"))}` : "–";
  // standalone load gauges (refresh_gauges): inbound channel depth and
  // credit-wait seconds -- the elastic signal plane's raw inputs
  const cwait = sum("Credit_wait_s");
  // audit plane: peak inbound depth + the most held-back replica's
  // frontier lag (0 everywhere = every operator caught up)
  const hwm = rs.reduce((a, r) =>
    Math.max(a, num(r.Queue_high_watermark)), 0);
  const flag = rs.reduce((a, r) =>
    Math.max(a, num(r.Frontier_lag_ms)), 0);
  return `<tr><td>${esc(op.Operator_name)}</td><td>${num(op.Parallelism)}</td>
    <td>${fmt(sum("Inputs_received"))}</td>
    <td>${fmt(sum("Outputs_sent"))}</td>
    <td>${fmt(sum("Inputs_ignored"))}</td>
    <td>${fmt(sum("Svc_failures"))}</td>
    <td>${fmt(sum("Shed_tuples"))}</td>
    <td>${fmt(sum("Queue_depth"))}</td>
    <td>${fmt(hwm)}</td>
    <td>${flag ? lus(flag * 1e3) : "–"}</td>
    <td>${cwait ? cwait.toFixed(1) + "s" : "–"}</td>
    <td>${ing}</td>
    <td>${svc.toFixed(1)}</td>
    <td>${svcP}</td>
    <td>${resP}</td>
    <td>${fmt(sum("Device_launches"))}</td>
    <td>${sum("Device_time_ms") ? sum("Device_time_ms").toFixed(0) : "–"}</td>
    <td>${fmt(sum("Bytes_to_device"))}</td>
    <td>${fmt(sum("Bytes_from_device"))}</td>
    <td>${sum("Device_launches")
      ? fmt(Math.round((sum("Bytes_to_device") + sum("Bytes_from_device"))
                       / sum("Device_launches"))) : "–"}</td>
    <td>${sum("Device_state_bytes_resident")
      ? fmt(sum("Device_state_bytes_resident")) : "–"}</td></tr>`;
}

// serving plane: tenants index (one row per tenant-carrying app, the
// multi-tenant operator's discovery view; /tenants serves the JSON)
function tenantsIndex(apps) {
  const rows = Object.keys(apps).filter(id =>
    ((apps[id] || {}).report || {}).Tenant);
  if (!rows.length) return "";
  let s = `<div class="app"><h2>tenants</h2>
    <span class="badge live">${rows.length} registered</span>
    <table><thead><tr><th>tenant</th><th>graph</th><th>state</th>
    <th>priority</th><th>weight</th><th>credits</th>
    <th>arbitrations</th><th>slo</th><th>links</th></tr></thead><tbody>`;
  for (const id of rows) {
    const a = apps[id], rep = a.report || {}, t = rep.Tenant || {};
    const slo = rep.Slo;
    const sloTxt = !slo ? "\\u2013"
      : slo.Breached ? "\\u2715 breached" : "\\u2713 in SLO";
    s += `<tr><td>${esc(t.Name)}</td>
      <td>${esc(rep.PipeGraph_name || "")}</td>
      <td>${esc(t.State || (a.active ? "RUNNING" : "ended"))}</td>
      <td>${num(t.Priority)}</td><td>${num(t.Weight)}</td>
      <td>${fmt(t.Credits)}</td><td>${num(t.Arbitrations)}</td>
      <td>${sloTxt}</td>
      <td><a href="/explain?app=${esc(id)}">explain</a>
        <a href="/flight?app=${esc(id)}">flight</a>
        <a href="/apps?app=${esc(id)}">stats</a></td></tr>`;
  }
  return s + "</tbody></table></div>";
}

function render(apps) {
  const root = document.getElementById("apps");
  const ids = Object.keys(apps);
  if (!ids.length) return;
  root.innerHTML = tenantsIndex(apps) + ids.map(id => {
    const a = apps[id], rep = a.report || {};
    const ops = rep.Operators || [];
    const outputs = ops.length ?          // sink row: results RECEIVED
      (ops[ops.length - 1].Replicas || []).reduce(
        (s, r) => s + num(r.Inputs_received), 0) : 0;
    (hist[id] ||= []).push({ t: Date.now(), outputs });
    if (hist[id].length > 120) hist[id].shift();
    const replicas = ops.reduce((s, o) => s + num(o.Parallelism), 0);
    const h = hist[id], rate = h.length > 1 ?
      Math.max(0, (h[h.length - 1].outputs - h[h.length - 2].outputs) /
        ((h[h.length - 1].t - h[h.length - 2].t) / 1000 || 1)) : 0;
    return `<div class="app">
      <h2>#${esc(id)} ${esc(rep.PipeGraph_name || "(no report yet)")}</h2>
      <span class="badge ${a.active ? "live" : "ended"}">
        ${a.active ? "\\u25cf live" : "\\u25a0 ended"}</span>
      ${rep.Tenant ? `<span class="badge live">tenant
        ${esc(rep.Tenant.Name)} p${num(rep.Tenant.Priority)}
        ${fmt(rep.Tenant.Credits)}cr</span>` : ""}
      <div class="tiles">
        <div class="tile"><div class="v">${fmt(rate)}/s</div>
          <div class="k">result rate at sink</div></div>
        <div class="tile"><div class="v">${fmt(outputs)}</div>
          <div class="k">results received</div></div>
        <div class="tile"><div class="v">${fmt(rep.Dropped_tuples || 0)}
          </div><div class="k">dropped tuples</div></div>
        <div class="tile"><div class="v${num(rep.Svc_failures) ? " bad" : ""}">
          ${fmt(rep.Svc_failures || 0)}</div>
          <div class="k">svc failures
          (${fmt(rep.Dead_letter_tuples || 0)} dead-lettered)</div></div>
        <div class="tile"><div class="v${num(rep.Shed_tuples) ? " bad" : ""}">
          ${fmt(rep.Shed_tuples || 0)}</div>
          <div class="k">shed tuples (admission)</div></div>
        <div class="tile"><div class="v">${replicas}</div>
          <div class="k">replicas (${num(rep.Operator_number)} ops)</div></div>
        ${rep.Conservation ? `<div class="tile">
          <div class="v${num(rep.Conservation.Violations_total)
            ? " bad" : ""}">
            ${num(rep.Conservation.Violations_total)
              ? fmt(rep.Conservation.Violations_total) + " viol."
              : (rep.Conservation.Edges_balanced
                 ? "\\u2713 balanced" : "\\u2026 settling")}</div>
          <div class="k">conservation ledger
            (${fmt((rep.Conservation.Edges || []).length)} edges,
            ${fmt(rep.Conservation.Audit_passes || 0)} audits)</div>
          </div>` : ""}
        <div class="tile"><div class="v">${fmt(rep.Rescales || 0)}</div>
          <div class="k">rescale events${(rep.Rescale_events || []).length
            ? " (last " + esc((e => e.old_parallelism + "\\u2192" +
              e.new_parallelism)(rep.Rescale_events[
                rep.Rescale_events.length - 1])) + ")" : ""}</div></div>
        <div class="tile"><div class="v">
          ${fmt(num(rep.Memory_usage_KB) * 1024)}B</div>
          <div class="k">resident memory</div></div>
        ${(rep.Latency_e2e && rep.Latency_e2e.n) ? `<div class="tile">
          <div class="v">${lus(rep.Latency_e2e.p50_us)} /
            ${lus(rep.Latency_e2e.p99_us)}</div>
          <div class="k">e2e latency p50/p99
            (${fmt(rep.Latency_e2e.n)} traces)</div></div>` : ""}
        ${(() => {  // diagnosis plane: doctor verdict tile
          const d = rep.Diagnosis || {}, bn = d.Bottleneck || {};
          const anoms = (d.Anomalies || []).length;
          if (!bn.Operator && !anoms) return "";
          const bad = anoms || bn.Verdict === "backpressure";
          const name = String(bn.Operator || "\\u2013");
          return `<div class="tile"><div class="v${bad ? " bad" : ""}">
            ${esc(name.length > 16 ? "\\u2026" + name.slice(-15) : name)}
            </div><div class="k">bottleneck (${esc(bn.Verdict || "?")},
            score ${num(bn.Score).toFixed(2)},
            ${anoms} regression${anoms === 1 ? "" : "s"})</div></div>`;
        })()}
        ${(() => {  // SLO plane: burn-rate tile (Slo stats block)
          const s = rep.Slo;
          if (!s) return "";
          const bad = !!s.Breached;
          return `<div class="tile"><div class="v${bad ? " bad" : ""}">
            ${bad ? "\\u2715 SLO breached" : "\\u2713 in SLO"}</div>
            <div class="k">burn ${num(s.Burn_rate_fast).toFixed(1)}x /
            ${num(s.Burn_rate_slow).toFixed(1)}x, budget
            ${(num(s.Budget_burned) * 100).toFixed(0)}% burned
            (${num(s.Breaches_total)} episode${
              num(s.Breaches_total) === 1 ? "" : "s"})</div></div>`;
        })()}
      </div>
      ${a.diagram.trim().startsWith("<svg") ? svgImg(a.diagram) : topoSvg(parseDot(a.diagram))}
      <div class="spark-wrap">${sparkline(id, hist[id])}</div>
      ${historyRow(rep.History)}
      <table><thead><tr><th>operator</th><th>par</th><th>in</th>
        <th>out</th><th>ignored</th><th>fails</th><th>shed</th>
        <th>q-depth</th><th>q-hwm</th><th>fr-lag</th><th>cr-wait</th>
        <th>ingest</th><th>svc &micro;s</th>
        <th>svc p50/p99</th><th>res p99</th>
        <th>launches</th><th>dev ms</th>
        <th>B&rarr;dev</th><th>B&larr;dev</th>
        <th>dev B/launch</th><th>dev B resident</th></tr>
      </thead><tbody>${ops.map(opRow).join("")}</tbody></table>
      ${skewTable(rep.Skew)}
    </div>`;
  }).join("");
  hookHover();
}

async function tick() {
  let apps;
  try {
    const r = await fetch("/apps");
    apps = await r.json();
  } catch (e) { return; /* server restarting */ }
  try {
    render(apps);
  } catch (e) { console.error("dashboard render:", e); }
}
setInterval(tick, 1000); tick();
</script>
</body>
</html>
"""
