"""A/B of the FlatFAT query kernel (K2, ``wf_flatfat_query``) between
checkouts, and between variants of one checkout's source, on one CUDA
card, in one process.

    python3 tools/ab_k2.py PARENT_DIR CHANGE_DIR [--tree NAME=DIR ...]
        [--variant NAME:CONST=VALUE[,CONST=VALUE] ...] [--rounds 2]
        [--entry query|build_query]
        [--shapes rebuild,deploy,...] [--out REPORT.json]

Each side (PARENT_DIR, CHANGE_DIR, each ``--tree``) is a library
built with nvcc from a checkout's own
``windflow_tpu_torch/ops/cuda/flatfat_query.cu`` (``-Xptxas -v``; the
registers and spills of each instantiation of ``flatfat_query_kernel``
are printed) -- the builtin combines, and one library per user combine
of ``chip_smoke.user_combines()``, generated as the port generates it.
A ``--variant`` is CHANGE_DIR's source with each line ``constexpr int
CONST = ...;`` named set to its VALUE (``chunk8:kWalkChunk=8``).  The
libraries go to CHANGE_DIR's ``windflow_tpu_torch/_build/ab_k2/``.

The shapes are ``chip_smoke.k2_shapes`` of CHANGE_DIR, drawn as
``chip_smoke.check_k2`` draws them, with its data laws (integer leaves
for add, random f32 for max and min, each user combine's own).
``--entry build_query`` times the same libraries' fused build+query
kernel (K2r, ``wf_flatfat_build_query``, which shares the combines) at
``chip_smoke.k2r_shapes`` instead.  For
each shape and combine, every side's result must be bitwise equal to
the first side's and to the plain version (within
``chip_smoke.ULP_BOUND`` ulp of it for ``logaddexp``), else the script
fails.  Then each side's device ms a call is read ``--rounds`` times,
the sides in turns (forward in even rounds, backward in odd ones):
torch.profiler's device time over 50 calls, and CUDA events around 50
calls queued behind a sleep kernel (``chip_smoke.queued_ms``), which
stands in where the profiler sees nothing.  The script prints every
reading, then per shape and combine each side's median and its ratio
to the first side, the bound (``chip_smoke.walk_work``) and the share of
it, and writes the same as JSON to ``--out``.  Exits non-zero without
a CUDA device, or if a build or a check fails.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import threading

import numpy as np


def parse_variant(text: str):
    """NAME:CONST=VALUE[,CONST=VALUE...] -> (NAME, [(CONST, VALUE)])."""
    name, _, assigns = text.partition(":")
    pairs = [a.partition("=")[::2] for a in assigns.split(",")]
    if not name or not all(c and v for c, v in pairs):
        raise argparse.ArgumentTypeError(
            f"variant {text!r} is not NAME:CONST=VALUE[,CONST=VALUE]")
    return name, pairs


def variant_source(src: str, pairs) -> str:
    text = open(src).read()
    for const, value in pairs:
        pat = re.compile(rf"^constexpr int {re.escape(const)} = [^;]+;",
                         re.MULTILINE)
        if len(pat.findall(text)) != 1:
            raise SystemExit(f"{src}: no single 'constexpr int {const}' "
                             f"line")
        text = pat.sub(f"constexpr int {const} = {value};", text)
    return text


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--variant", type=parse_variant, action="append",
                    default=[])
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=DIR: one more checkout to time")
    ap.add_argument("--entry", choices=("query", "build_query"),
                    default="query")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--shapes", default="")
    ap.add_argument("--out", default=None,
                    help="the JSON report (default: report.json beside the "
                         "libraries)")
    args = ap.parse_args()
    change = os.path.abspath(args.change)
    sys.path.insert(0, change)
    import torch
    if not torch.cuda.is_available():
        print("ab_k2: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from windflow_tpu_torch.ops.cuda import flatfat_query as fq
    from windflow_tpu_torch.ops.cuda.combine_lower import lower_combine
    from windflow_tpu_torch.runtime.build import OUT, nvcc_command

    rel = os.path.join("windflow_tpu_torch", "ops", "cuda",
                       "flatfat_query.cu")
    out_dir = os.path.join(change, "windflow_tpu_torch", "_build", "ab_k2")
    os.makedirs(out_dir, exist_ok=True)
    # side -> the directory holding its flatfat_query.cu
    srcs = {"parent": os.path.dirname(os.path.join(
                os.path.abspath(args.parent), rel)),
            "change": os.path.dirname(os.path.join(change, rel))}
    for name, _, d in (t.partition("=") for t in args.tree):
        srcs[name] = os.path.dirname(os.path.join(os.path.abspath(d), rel))
    for name, pairs in args.variant:
        d = os.path.join(out_dir, f"src_{name}")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "flatfat_query.cu"), "w") as f:
            f.write(variant_source(os.path.join(change, rel), pairs))
        srcs[name] = d
    users = cs.user_combines()
    combines = dict(cs.k2_combines())
    combines.update({u: v[:3] for u, v in users.items()})

    # every (side, library) built at once; "" is the builtin library
    jobs, built, errors = [], {}, []
    for side, d in srcs.items():
        jobs.append((side, "", os.path.join(d, "flatfat_query.cu"), d))
        for u, (comb, *_r) in users.items():
            gen = os.path.join(out_dir, f"{side}_{u}.cu")
            with open(gen, "w") as f:
                f.write(fq.user_source(lower_combine(comb)))
            jobs.append((side, u, gen, d))

    def build(side, lib, src, inc):
        so = os.path.join(out_dir, f"{side}_{lib or 'builtin'}.so")
        cmd = [so if a == OUT else a
               for a in nvcc_command(src, include_dirs=[inc])]
        cmd[1:1] = ["-Xptxas", "-v"]
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=900)
        if r.returncode != 0:
            errors.append(f"{side} {lib or 'builtin'}:\n{r.stderr}")
            return
        built[(side, lib)] = fq._bind(so)
        entry = None
        for line in r.stderr.splitlines():
            m = re.search(r"entry function '(\w+)'", line)
            if m:
                entry = m.group(1)
            elif entry and "flatfat_query_kernel" in entry and (
                    "registers" in line or "spill" in line):
                op = re.search(r"(AddOp|MaxOp|MinOp|UserOp)", entry)
                print(f"[ptxas] {side} {lib or 'builtin'} "
                      f"{op.group(1) if op else entry}: "
                      f"{line.split(':', 1)[-1].strip()}", flush=True)

    threads = [threading.Thread(target=build, args=j) for j in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise SystemExit("build failed: " + "\n".join(errors))

    card = cs.card_line()
    print(f"[ab_k2] sides {list(srcs)}; {card}", flush=True)
    device = torch.device("cuda", 0)
    rng = np.random.default_rng(1)
    if args.entry == "query":
        shapes = cs.k2_shapes(rng)
    else:  # one tree each: (K, n, rows, starts, ends) as k2_shapes
        shapes = {k: (1, n, None, s, e)
                  for k, (n, s, e) in cs.k2r_shapes(rng).items()}
    if args.shapes:
        shapes = {k: shapes[k] for k in args.shapes.split(",")}
    sides = list(srcs)
    report = {"card": card, "sides": sides,
              "variants": dict(args.variant), "shapes": {}}

    def check(rc):
        if rc != 0:
            raise RuntimeError(f"launch failed: cudaError {rc}")

    def query_case(shape, leaves, comb, neutral, opc):
        """(run(lib, code, out), plain result, (bytes, ops)) of K2."""
        K, n, rows, starts, ends = shape
        r_d = None if rows is None else torch.from_numpy(
            np.asarray(rows, np.int32)).to(device)
        s_d = torch.from_numpy(np.asarray(starts, np.int32)).to(device)
        e_d = torch.from_numpy(np.asarray(ends, np.int32)).to(device)
        tree = cs.forest_of(torch.from_numpy(leaves).to(device), comb)

        def run(lib, code, out):
            check(lib.wf_flatfat_query(
                tree.data_ptr(), n, n.bit_length() - 1, K,
                None if r_d is None else r_d.data_ptr(), s_d.data_ptr(),
                e_d.data_ptr(), out.data_ptr(), len(starts), float(neutral),
                code, torch.cuda.current_stream().cuda_stream))

        plain = fq.flatfat_query_plain(tree, r_d, s_d, e_d, comb, neutral)
        return run, plain, cs.walk_work(n, rows, starts, ends, opc)

    def build_query_case(shape, leaves, comb, neutral, opc):
        """The same of K2r (the rebuild lane's build+query launch)."""
        _K, n, _rows, starts, ends = shape
        v = torch.from_numpy(leaves.reshape(-1)).to(device)
        se = cs.pack(starts, ends, device)
        nodes = torch.empty(n, dtype=torch.float32, device=device)

        def run(lib, code, out):
            check(lib.wf_flatfat_build_query(
                v.data_ptr(), n, se.data_ptr(), len(starts),
                nodes.data_ptr(), out.data_ptr(), float(neutral), code,
                torch.cuda.current_stream().cuda_stream))

        plain = fq.flatfat_build_query_plain(v, se, comb, neutral)
        return run, plain, (4 * n + 12 * len(starts), (
            n - 1 + cs.walk_nodes(n, None, starts, ends)[1]) * opc)

    case = query_case if args.entry == "query" else build_query_case
    for sname, shape in shapes.items():
        K, n, _rows, starts, _ends = shape
        rep = report["shapes"][sname] = {}
        for cname, (comb, neutral, opc) in combines.items():
            if cname in users:
                leaves = cs.combine_values(cname, rng, (K, n))
                lib_key, code = cname, fq.USER_OP
            else:
                leaves = (rng.integers(0, 97, (K, n)).astype(np.float32)
                          if cname == "add" else
                          rng.random((K, n), dtype=np.float32))
                lib_key, code = "", fq.builtin_op(comb)
            run, plain, (nbytes, ops) = case(shape, leaves, comb, neutral,
                                             opc)
            plain = plain.cpu().numpy()
            outs = {}
            for side in sides:
                o = torch.empty(len(starts), dtype=torch.float32,
                                device=device)
                run(built[(side, lib_key)], code, o)
                outs[side] = o
            torch.cuda.synchronize()
            first = outs[sides[0]].cpu().numpy()
            for side in sides:
                got = outs[side].cpu().numpy()
                if got.tobytes() != first.tobytes():
                    raise SystemExit(f"[ab_k2] {sname} {cname}: {side} not "
                                     f"bitwise equal to {sides[0]}")
                cs.hold_user(got, plain, cname == "logaddexp",
                             f"ab_k2 {sname} {cname} {side}")
            readings = {s: {"profiler": [], "events": []} for s in sides}
            for r in range(args.rounds):
                for side in (sides if r % 2 == 0 else sides[::-1]):
                    lib, o = built[(side, lib_key)], outs[side]

                    def fn(lib=lib, o=o):
                        run(lib, code, o)

                    dev, _wall = cs.timed(fn)
                    q = cs.queued_ms(fn)
                    readings[side]["profiler"].append(dev)
                    readings[side]["events"].append(q)
                    print(f"[ab_k2] {sname} {cname} round {r} {side}: "
                          f"profiler {cs.fmt_ms(dev) if dev else 'none'}, "
                          f"events {cs.fmt_ms(q)} ms", flush=True)
            bms, bound_by = cs.bound_ms(nbytes, ops)
            med = {}
            for side in sides:
                prof = [x for x in readings[side]["profiler"] if x]
                med[side] = {
                    "profiler_ms": float(np.median(prof)) if prof else None,
                    "events_ms": float(np.median(
                        readings[side]["events"])),
                    "readings": readings[side]}
            base = med[sides[0]]
            parts = []
            for side in sides:
                m = med[side]
                src = "profiler" if m["profiler_ms"] else "events"
                ms = m[f"{src}_ms"]
                ref = base[f"{src}_ms"] or base["events_ms"]
                m["share_of_bound"] = bms / ms
                parts.append(f"{side} {ms:.5f} ({src}; {ms / ref:.3f}x "
                             f"{sides[0]}, {100 * bms / ms:.1f} % of "
                             f"bound)")
            print(f"[ab_k2] {sname} {cname} medians: {'; '.join(parts)}; "
                  f"bound {bms:.4g} ms ({bound_by}) ({card})", flush=True)
            rep[cname] = {"bound_ms": bms, "bound_by": bound_by, **med}
            del run, outs
        torch.cuda.empty_cache()
    out = args.out or os.path.join(out_dir, "report.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"[ab_k2] every side bitwise equal on every shape and combine; "
          f"report in {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
