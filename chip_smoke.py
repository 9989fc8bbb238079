"""Chip smoke test of the PyTorch/CUDA port (windflow_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; the last line is printed only when
every phase passed):

1. device  -- the CUDA card's name, and its name and power limit as
   nvidia-smi reports them.
2. build   -- window_sum.cu (the window-sum kernel K1, two forms) and
   flatfat_query.cu (the FlatFAT query kernel K2, the fused FlatFAT
   update+query kernel and the fused build+query kernel of the rebuild
   lane) for the builtin combines and once more for each user combine
   below (a library of its own, the combine lowered from its torch ops),
   nvcc for sm_90a, and the native C++ engine (g++), built from the
   checkout's sources in parallel into windflow_tpu_torch/_build/.
3. kernel  -- K1, the window-sum kernel, in both forms (a thread per
   window, the engine's choice up to extents of 32; a warp per window
   with float4 loads above) against its plain torch version and a
   float64 numpy sum on the card, at the headline launch shape (pane
   partials, B = 4096, 2-pane extents), the pane-rebuild cell's launch
   (1,024 windows of 64 panes, padded to 2,048), a wide raw-tuple shape
   (extents up to 4096 over T = 2^21), 12,288 such extents laid end to
   end (~100 MB, each value read once, from HBM: the streaming rate)
   and edge cases (empty extents, extents ending at T, single elements):
   exact on integer data, rtol 1e-5 on random f32.  First the launch floor: the thread form's device
   time on one window.  Per shape: device time of the form the engine
   takes and of both forms (torch.profiler), its ratio to the floor, the
   bytes the function must move and their share of the card's HBM rate,
   the plain version's time and a sparse CSR mv's.
   User combines: torch.mul (leaves near 1), the non-commutative
   left_weighted (0.5 a + b), torch.logaddexp (neutral -inf) and a
   NaN-skipping max written with torch.where (NaNs among the leaves),
   each through its generated library in K2, K2f and K2r at every shape
   below: bitwise against the plain version for the arithmetic ones,
   within 64 ulp for logaddexp (the run reports whether it came out
   bitwise); device time beside add's at the same shape.
   kernel K2 -- the FlatFAT query kernel against its plain torch version
   for add, max, min and the user combines,
   at the rebuild lane's launch shape of bench config 15 (one tree of
   T_pad = 2^17 leaves, B = 4096 windows), the resident shape before the
   fused kernel (16 rows x 8192 leaves, ring-wrap pieces), a
   deployment-size forest (4096 rows x 8192 leaves = 256 MiB, 65,536
   queries up to 4096 leaves) and edges (empty extents, [0, n), n = 2,
   end = n): exact for max/min and for add on integer data, rtol 1e-5 on
   random f32.  Per shape: device time, the bound (extents, output and
   each tree node the queries need, read once), the plain version's time
   and, for add, a sparse CSR mv.
   kernel K2 rebuild -- the fused build+query kernel against its plain
   version (build_tree, the plain query, the where) and the chain the
   rebuild lane ran before it (build_tree's torch sweep, K2, the where),
   bitwise for add, max and min on integer and random f32 leaves, at
   the rebuild lane's launch (2^17 leaves, 4096 windows), two tiles
   (2048 leaves) with edges (empty and reversed extents, [0, n), end =
   n) and two tiling rounds (2^22 leaves).  At the rebuild shape: device
   time, the launch floor (2048 leaves, one window), the pre-PR chain's
   device time, the bound (leaves and extents read, output written
   once), the plain version's time and a sparse CSR mv's.
   kernel K2 fused (run first, before any phase starts the profiler) --
   the fused update+query kernel against its plain
   version on the same packed inputs, results and forests after the
   step, for add, max, min and the user combines, at the resident FFAT
   lane's step (forest
   [16, 2 x 8192], one 1024-leaf run crossing the ring's end, 64 windows
   of 4096, half wrapping), the resident pane lane's step (the carry's
   forest [16, 2 x 2048], a 128-pane run for each of 8 keys, 1024
   windows), a deployment-size forest (4096 x 8192, one 64-leaf run a
   row, 16 windows a row) and edges (n = 16 and n = 2, two runs on one
   row, an empty run, a row with windows and no run, windows of 0 and n
   leaves): exact for max/min and for add on integer data, rtol 1e-5 on
   random f32.  Per main shape: device time, the bound (the staged
   inputs and the output once, each dirty node written once, each clean
   node the update or the walks read once), the plain version's time,
   and one whole step as a lane pays it (host staging to host result,
   perf_counter and CUDA events) against the chain of torch ops and the
   query kernel that ran before the fused kernel.  Then the fused
   kernel's launch floor: one forest row of 2048 leaves, one run of one
   leaf, one window.
3b. signed zeros -- +0/-0 with NaN through every path that folds max
   or min on the card, each max and min, held bit for bit against a
   numpy oracle of the reference's rule (jnp's order: -0 below +0, NaN
   propagating; in compute_wmr the reduce over 'win' as the reference's
   lax.pmax/pmin fold the shards in order, passing NaN over): the
   window engine's sparse table at Q7's launch shape; compute_wmr at
   [mesh wmr]'s stripes and compute_pf_ring on [mesh pf3]'s 8-ring
   (their reductions); the resident pane carry's launch (K2f); K2, K2f
   and K2r under the builtin names "max" and "min", which must launch
   the shared library (no user library).  One line a path; then the
   two mesh forms under max and min timed beside sum at those shapes.
4. main    -- the headline graph, bench.py config 2 (64M events, 64
   keys, TB window 4096 / slide 2048, source batch 2^20, device batch
   4096, buffer 2^21, 8 in flight, 10 ms delay), through PipeGraph ->
   BatchSource -> WinSeqTPU -> Sink of the port, with the native lane
   active and the kernel launched on every batch; every window's
   (key, id, value) is held exactly against a closed-form numpy oracle
   of the synthetic law.  Prints tuples/s, windows, p50/p99 window
   latency.
5. profile -- the main path once more under torch.profiler: the
   device's busy and idle share and its top device ops.
5b. main3 -- bench.py config 3 (bench.py:501-527): PaneFarmTPU("sum",
   "sum", 4096, 2048, TB, LEVEL2, emit_batches) -- the device PLQ (pane
   sums, the window-sum kernel) thread-fused with the host's columnar
   WLQ -- over the headline's stream at 32M events, as bench.py runs it
   (bench.py:2434); the chunks SyntheticSource(chunked=True) emits,
   stamped at the source for the window latency.
   main4 -- bench.py config 4 (:530-551): KeyFarmTPU("sum", ...,
   parallelism=2) at 32M events, coalesced into one engine (the
   default) and as two replicas behind the key hash.
   farms -- WinFarmTPU(parallelism=2) at 8M events and WinMapReduceTPU
   (MAP on the card, two stripes; REDUCE on the host) at 2^15 events
   of the same law as records (its map emitter routes records, not
   batches).
   custom -- KeyFarmTPU over a torch custom window function (the sum of
   squares, vmapped over the windows) at 1M events.
   Each: every window held against the closed-form float64 oracle
   (exact; the sums of squares within rtol 1e-5), per key in id order,
   the launches of the lane's kernel equal to the batches of the farm's
   device engines and no other kernel launched -- the window-sum kernel,
   or the fused update+query kernel where the planner promotes the
   engines onto the resident pane lane (WinFarmTPU's striped replicas),
   none for the custom function; tuples/s, p50/p99 window latency.
   Then configs 3 and 4 once more each under torch.profiler: device
   busy and idle share, top device ops.
6. main15  -- bench.py config 15_resident_state at its full size (8M
   events, 8 keys, CB window 4096 / slide 16, source batch 65,536)
   through PipeGraph -> BatchSource -> lane -> Sink of the port, for the
   FFAT rebuild lane (WinSeqTPU(("ffat", torch.add, 0.0)), batch 128,
   buffer 2^21, 8 in flight; the fused build+query kernel per launch)
   and the resident FFAT lane (WinSeqFFATResident; the fused
   update+query kernel per launch): every window equal between the
   lanes and to a closed-form float64 oracle, shipped bytes per launch
   rebuild/resident >= 10x, each lane's kernel launches equal to its
   launched batches and the other kernels not launched.  Prints
   tuples/s, window latency p50/p99 and the forest's resident bytes.
   main15 logaddexp -- the same two cells under the user combine, built
   as a user builds them: WinSeqFFATTPUBuilder(lift, (torch.logaddexp,
   -inf)), with_rebuild(True) (K2r) and the CB default (the resident
   lane, K2f); keys and ids exact, values within rtol 1e-5 of the
   float64 closed form (96 + log of window differences of prefix sums of
   exp(v - 96)) and of each other; every FlatFAT launch one of the
   generated library's, equal to the batches or steps.
7. resident pane -- WinSeqTPU("sum", 4096, 64, CB) with value_of on the
   same stream, promoted by the planner onto the resident pane lane (the
   fused kernel per launch), against resident=False (K1 per launch):
   bitwise equal, equal to the oracle, launches checked as in main15.
   key_ffat -- KeyFFATTPUBuilder with the same combine at parallelism 2,
   coalesce=False (two replicas, one library), on config 15's stream
   cut 64x (125,000 events), held as main15 logaddexp.
8. flatfat -- FlatFATTorch, the single tree a user builds, updates and
   queries (the one path left that launches the query-only K2): built
   over 2^17 leaves, queried, updated, queried, exact against float64
   sums, two K2 launches and nothing else; then the same under
   torch.logaddexp, within rtol 1e-5 of a float64 log-sum-exp, two
   launches of the generated K2.
9. profile15 -- both FFAT lanes once more at 2M events (a quarter of
   config 15's) under torch.profiler: device busy and idle share and
   the top device ops; the rebuild lane's only kernel must be the fused
   build+query kernel.
10. models -- bench configs 5 and 6 through the port's own builders
   (windflow_tpu_torch.models), at the bench's size, every window equal
   to a numpy oracle exactly (bincounts of the re-timestamped pools;
   Q7's maxima as float32 of the float64 max), each cell's kernel
   counts set to 0 just before and read just after: count windows sum
   per-pane counts with the window-sum kernel, once a batch, as the
   reference does; max is the torch sparse-table program (no hand
   kernel); the host lane launches nothing.
   main5 -- Yahoo (bench.py:553-567): warm-up at 2M, then 16M events,
   1,000 ads, 100 campaigns, TB window = slide = 2^20, source batch
   2^20, device batch 4096, with the device step on and off (bitwise
   equal); tuples/s, p50/p99 window latency, and vs_baseline against
   the native record-plane twin (bench.py:615-647).
   main6 q5 / q7 -- NEXMark Q5 (KeyFarmTPU("count"), window 2^18,
   slide 2^17) and Q7 (Q1's map, WinSeqTPU("max"), tumbling 2^13) on
   16M bids of 1,000 auctions, source batch 2^20, device batch 16,384,
   8 in flight (bench.py:579-610, :2446-2460): warm-up at 2M, LEVEL0
   and LEVEL2 (fused_delta), the native twin; Q5 also with
   placement="host" and "auto", printing the planner's decision.
   step models -- Q5, Q7 and Yahoo at 2M: device step on and off
   bitwise equal, at most 2 launches per ingest chunk.
   sparse_table -- the max kind's torch program at Q7's mean launch
   (padded shape and sizes from the engine's launch_shapes): device
   time, the bound of its sweeps and of the function, and
   torch.segment_reduce over the same windows.
   profile -- each model once more at 16M under torch.profiler.
11. durable -- the durability plane (windflow_tpu_torch/durability/,
   utils/checkpoint.py, state/) on the card, each kernel count set to
   0 just before a path and read just after (a crash cell's: once its
   restored attempt is loaded).
   durable11 -- bench config 11 (``run_checkpoint_overhead``,
   bench.py:1281-1375) at its 16M events: the template feed through
   config 11's WinSeqTPU (batch 4096, buffer 2^21, 8 in flight), one
   calibration run, the epoch cadence min(1 s, run/8) (at least
   0.02 s), epochs off and on interleaved, best of 3: windows
   identical on and off, at least one periodic commit, recovery
   seconds (newest manifest into a fresh graph), K1 launches equal to
   the batches in every run; overhead_frac printed, not gated; then
   one epochs-on run under torch.profiler (idle share).
   durable11 crash -- the same graph with a transactional sink and
   FaultPlan.crash_at_epoch on the WinSeqTPU replica under
   run_with_epochs; its offset-checkpointable source carries the
   headline's integer law and begins epochs 1 and 2 itself at chunks
   4 and 8, waiting for each commit: restored epoch 1, every window
   once and equal to the closed form, K1 launched after the restore.
   durable resident -- config 15's resident FFAT lane (8M events, 8
   keys, CB 4096/16) crashed at epoch 2's cut: every window once and
   equal to oracle15, the forest's bytes a cut, K2f launched after the
   restore.
   durable step -- source, BatchMap, config 11's WinSeqTPU and a
   transactional sink lowered into one device-step node, crashed on the
   map's 10th chunk: restored epoch 2, every window once, K1 after the
   restore, at most 2 launches a chunk.
   delta16, tiered17 -- bench configs 16 and 17 (bench.py:1378, :1543)
   with the bench's own gates (no kernel runs): config 17 at its size,
   config 16 with 100 of its 400 rounds of the hot set.
12. planes -- the elastic scaling plane and the event-time plane
   (windflow_tpu_torch/elastic/, eventtime/), each kernel count set to
   0 just before a path and read just after.
   rescale15 -- config 15's resident FFAT lane at its size (8M events,
   8 keys, CB 4096/16, source batch 65,536, torch.add) with its forest
   repartitioned on the card as a rescale moves keyed state: one
   WinSeqFFATResidentLogic takes the first half, its keyed_state_dict()
   goes through partition_keyed_state into 3 fresh logics on the card
   (load_keyed_state), the next quarter is routed to them by owner_of,
   and merge_keyed_states brings it back into one logic, which
   finishes the stream: every window equal to oracle15 and to
   [main15]'s unsplit lane, every forest on the card, each logic's
   fused update+query launches equal to its batches (the refills
   counted apart), no other kernel; the bytes copied off and onto the
   card, the seconds and the forest shapes of each cut, tuples/s.
   elastic2i -- bench config 2i (bench.py:331-404) at 4,500 events
   (9,000 in the bench): a skewed-key step load (500/s, 2,000/s,
   500/s, open-loop paced) into an elastic accumulator with a 1,000 us
   sleep fold (1..4 replicas, target 0.5), the controller on: every
   tuple conserved, each key's last value equal to its count, at least
   one scale-up,
   every event inside [1, 4], the controller's threads stopped at the
   end of run(); the rescale events, the rate, p50/p99 a phase.
   nexmark18 -- bench config 18 (bench.py:2088-2218) at 50,000 bids
   through the port's builders: Q4 against q4_oracle within 1e-9 per
   window, Q8 against q8_oracle exactly with its watermark-to-result
   latency (bench.py's _WmClock and _stamped_record_source), the
   planted-late lane (every straggler in dead letters, the late_data
   flight events counting them), no on-time tuple quarantined.
13. mission -- the observability planes over config 11's graph (the
   template feed of bench.py, 16M events, through WinSeqTPU("sum",
   4096, 2048, TB): native fold, K1), each run with every kernel count
   set to 0 just before it and read just after: K1's launches equal the
   engine's batches, no other kernel launches.  Each cell interleaves
   its plane off and on, best of 3, with every run's windows bitwise
   equal and their keys and ids exact and values within rtol 1e-5 of
   the feed's float64 closed form.
   overhead8, overhead9, overhead10 -- bench configs 8, 9 and 10
   (bench.py:728, :802, :861): tracing at the default sampling (and a
   trace_sample 1 readout of the e2e latency; the 3 % bar reported,
   not gated), the audit plane (zero conservation violations, the
   final check done, every edge balanced), the diagnosis plane
   (explain()'s hop-class shares sum to 1 within 0.02, also in a
   trace_sample 1 run that must attribute traces).
   slo13 -- bench config 13 (bench.py:928-1007): SLO off, and SLO on
   with a ClusterObserver fed by a StatsPusher every 0.25 s: every push
   delivered, the Slo block in the merged live view; rate_on,
   rate_off, overhead_frac, slo_ticks, breaches, budget_burned.
   slo breach -- the same graph with a p99 budget a quarter of the
   plane-off e2e p50 and windows scaled onto the run: a slo_breach
   episode opens on the live K1 graph, its windows bitwise slo13's.
   dashboard -- a traced K1 graph at 2M events reporting to an
   in-process DashboardServer and pushing to a ClusterObserver (all on
   port 0): /, /apps, /metrics, /flight, /explain and /cluster answer
   200, the report's Device_launches equal K1's counted launches, and
   ``python -m windflow_tpu_torch.doctor`` over the log directory and
   with ``--watch --once`` against the observer exit 0 naming a
   bottleneck.
   K2r under torch.logaddexp is read 7 times at the rebuild shape in
   phase 3 (median and spread; a profile of any reading twice the
   fastest).
14. distributed -- bench config 12 (NEXMark Q5, bench.py:1659-1735) at
   4M bids in one process and across two worker processes, on the host
   lane and on the device lane (worker 1 launches K1; each worker
   writes an exit probe), and both modes of
   ``python -m windflow_tpu_torch.distributed.smoke``.
15. serving -- the serving plane and the global scheduler, every kernel
   count set to 0 just before a run and read just after (a fleet
   worker's: in its exit probe).
   contend K1 -- the reference's contended-chip chaos test at
   deployment size: under Server(devices=1) the victim (priority 5, a
   throughput SLO) runs a paced record lane and config 11's K1 lane
   (16M events), the neighbour (priority 0) a burner farm and an
   endless paced K1 lane; the planner leases the card to both, the
   arbiter's first decision demotes the neighbour's lane device->host
   and its ladder restores the victim's SLO; the victim's windows
   bitwise its solo run on the card, K1's launches the victim's batches
   plus the neighbour's up to its flip, the neighbour's windows
   gap-free across the flip; seconds from submit to breach, breach to
   demotion, demotion to slo_recovered.
   serve14, sched20 -- bench configs 14 (bench.py:1010-1120) and 20
   (:1123-1278) on the port's Server and FleetServer (2 workers) with
   the bench's gates: config 14 at 500k records, config 20's 4 tenants
   at the bench's 250k records each, its record-only workers holding
   no CUDA context and launching no kernel.
   fleet K1 -- two TenantSpec(devices=1) tenants of config 11's K1 lane
   (16M events each) placed on the two workers of a second fleet:
   windows bitwise [contend K1]'s solo run, each worker's K1 launches
   equal to its engines' batches, a CUDA context where its device lane
   ran, no jax in any worker.

16. mesh -- the mesh plane (windflow_tpu_torch/parallel/, the mesh
   operators) on logical shards of the card, every kernel count set to 0
   just before a cell and read just after.
   mesh kf4 -- KeyFarmMesh("sum") on make_mesh(8, win_axis=1) (8 key
   shards on cuda:0) over bench config 4's feed and window at its 32M
   events as TupleBatches, 1,024 windows a launch: every window equal
   to the oracle exactly and to [main4 coalesced]'s, one K1 launch a
   batch for all 8 shards, no other kernel; K1 at the mesh launch
   against its plain version and the float64 sums, its device time.
   mesh kf kinds -- the same graph under max and under ('ffat', lift,
   torch.logaddexp, -inf) at 32M events: one K2r launch a batch (the
   generated library's for logaddexp), max exact, logaddexp within rtol
   1e-5 of the float64 oracle; K2r at the mesh launch against its plain
   version (bitwise, or within 64 ulp), its device time.
   mesh pf3 -- PaneFarmMesh("sum") on win_axis 2 at config 3's window
   and on the full 8-ring at slide 512 (4 hops), 32M events each: every
   window once and exact; the ring is a torch program.
   mesh wmr -- WinMapReduceMesh("sum") on win_axis 4 at 8M events:
   exact; a torch program.
   mesh step -- ShardedWindowEngine.step on the dry run's mesh (8 slots,
   win_axis 2) at config 4's window and the KF cell's widths: equal to
   numpy exactly.  The torch forms' (compute_wmr, compute_pf_ring, step)
   device time a call, device ops a call and bound at their cells'
   shapes.
17. feed -- the feed and placement plane (windflow_tpu_torch/ingest/,
   graph/planner.py, graph/device_step.py, graph/replanner.py), every
   kernel count set to 0 just before a cell and read just after, every
   engine on cuda:0 but on the lanes that are host by design.
   feed2b -- bench config 2b (bench.py:2330-2337): the headline graph
   at 16M events, source batch 2^17, launch delay 5 ms: exact, K1 =
   batches; tuples/s, p50/p99.
   feed2f -- config 2f (:2343-2346): the headline's 64M events as
   materialised TupleBatches: exact, K1 = batches.
   ingest2g, ingest2h -- configs 2g and 2h (:291-322, :2352-2377): a
   16M-event replay trace of random f32 values through
   SourceBuilder.from_replay (microbatch 2^19, credits 2^21, a 50 ms
   latency target for the AIMD controller, pane pre-reduction) at
   LEVEL0 and LEVEL2: within rtol 1e-5 of the float64 oracle, nothing
   shed, K1 = batches; vs_feed, fused_delta, the controller's final
   batch and the credit waits.
   planner2j -- config 2j (:407-460, :2390-2434): 64M events through
   FeedSource(feeders=2) into WinSeqTPU(placement=p,
   adaptive_batch=True) for p in auto, device, host: within rtol 1e-5
   on every lane, K1 = Device_launches on a lane on the card, none on
   the host lane; the planner's decision and inputs, the three rates,
   auto_not_worse (read, not asserted), device_time_ms, the final batch
   and its resizes.
   step19 -- config 19 (:1936-2010) at 2M events (a quarter of the
   bench's): WinSeqTPU("sum", 1024, 16, CB, batch_len 16, value_of), 8
   keys, source batch 8192, the device step off and on interleaved,
   three reps: bitwise equal and exact every rep, the lane's kernel
   (the fused update+query kernel: the planner promotes the lane onto
   the resident pane lane) = batches = Device_launches, at most 2
   launches an ingest chunk with the step on; best-of-3 rates, p50/p99.
   profile19 -- each config-19 lane once more at 500k events under
   torch.profiler: idle share, launches, device time a launch, and the
   host's seconds in the source, the engine's ingest, the step's flush,
   the hand-off to the dispatcher, the launch, the D2H wait and the sink.
   replan15 -- config 15_replan_shift (:1835-1933), last: the cost
   model pinned (RTT floor 0.001 ms, host 20M tuples/s, device compute
   0) and restored after, a paced stream of 1,500-event batches every
   4 ms into WinSeqTPU("sum", 1024, 32, CB, batch_len 64, placement
   auto) with the re-planner on: the lane starts on cuda:0 and is
   flipped device -> host (a replacement flight event), no
   conservation_violation, every window once and equal to the integer
   oracle across the flip, the lane's kernel launched as often as the
   batches up to the flip; the flip's evidence and duration.

Then one JSON line describing each kernel (the window-sum kernel's
launches: the headline's, phase 5b's, the models', phase 11's,
phase 13's, phase 14's, phase 15's, phase 16's and phase 17's; the
three FlatFAT kernels twice: builtin, and compiled with torch.logaddexp,
each with the launches of its own paths, the fused update+query
kernel's including phase 12's and phase 17's config 19 and
15_replan_shift, the build+query kernel's phase 16's), the card line,
and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import collections
import json
import os
import subprocess
import sys
import threading
import time
import warnings

import numpy as np
import torch

# bench.py config 2 (the headline)
N_EVENTS = 64_000_000
N_KEYS = 64
WIN = 4096
SLIDE = 2048
SOURCE_BATCH = 1_048_576
DEVICE_BATCH = 4096
MAX_BUFFER = 1 << 21
INFLIGHT = 8
DELAY_MS = 10.0
VMOD = 97

# published peaks of one H100 SXM (NVIDIA data sheet), at 700 W
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

RTOL_F32 = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------

def build_all() -> None:
    from windflow_tpu_torch.ops.cuda import flatfat_query, window_sum
    from windflow_tpu_torch.runtime import native

    results = {}

    def run(name, fn):
        t0 = time.perf_counter()
        try:
            results[name] = (fn(), time.perf_counter() - t0)
        except BaseException as e:  # re-raised on the main thread
            results[name] = (e, time.perf_counter() - t0)

    t0 = time.perf_counter()
    # one nvcc per library, all started together: the builtin library
    # of each source, and flatfat_query.cu once per user combine
    builds = [("window_sum.cu (nvcc)", window_sum.load_kernel),
              ("flatfat_query.cu (nvcc)", flatfat_query.load_kernel),
              ("native/*.cpp (g++)", native.get_lib)]
    for uname, (comb, *_rest) in user_combines().items():
        builds.append((f"flatfat_query.cu, user combine {uname} (nvcc)",
                       lambda c=comb: flatfat_query.resolve_combine(c)))
    threads = [threading.Thread(target=run, args=(n, f)) for n, f in builds]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for name, (res, secs) in results.items():
        if isinstance(res, BaseException):
            raise RuntimeError(f"build of {name} failed") from res
        if res is None:
            raise RuntimeError(f"build of {name} failed (toolchain "
                               f"unavailable or compile error)")
        log(f"[build] {name}: {secs:.1f} s")
    log(f"[build] total (parallel): {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# 3. kernel against its plain version
# ---------------------------------------------------------------------------

def headline_extents(n_keys=N_KEYS, per_key=DEVICE_BATCH // N_KEYS):
    """The launch shape the headline's native lane produces: per key,
    ``per_key + 1`` pane partials and ``per_key`` windows of 2 panes
    sliding by one pane."""
    starts, ends = [], []
    off = 0
    for _ in range(n_keys):
        s = off + np.arange(per_key)
        starts.append(s)
        ends.append(s + WIN // SLIDE)
        off += per_key + 1
    return off, np.concatenate(starts), np.concatenate(ends)


def wide_extents(rng, T=1 << 21, B=4096, max_w=4096):
    lens = rng.integers(1, max_w + 1, B)
    starts = rng.integers(0, T - max_w, B)
    return T, starts, starts + lens


def disjoint_extents(rng, B=3 * 4096, max_w=4096):
    """The wide shape's extent lengths laid end to end, three times as
    many (~100 MB of values in a buffer of 2^25, twice the 50 MB L2):
    every value is read once and repeated calls cannot keep them in L2,
    so the kernel's rate here is its streaming rate from HBM (the wide
    shape's windows overlap and re-read from L2)."""
    lens = rng.integers(1, max_w + 1, B)
    ends = np.cumsum(lens)
    return 1 << 25, ends - lens, ends


def edge_extents(T=5000):
    starts = np.array([0, 7, 100, T - 1, T, T, 0, 4999, 128, 127])
    ends = np.array([0, 7, 101, T, T, T, T, 5000, 256, 129])
    return T, starts, ends


def pack(starts, ends, device):
    B = len(starts)
    se = np.zeros((2, B), np.int32)
    se[0], se[1] = starts, ends
    return torch.from_numpy(se).to(device)


def float64_sums(values: np.ndarray, starts, ends) -> np.ndarray:
    c = np.concatenate([[0.0], np.cumsum(values.astype(np.float64))])
    return c[ends] - c[starts]


def device_busy_ms(prof) -> float:
    """Device time of every kernel and copy a torch.profiler capture
    saw (CUPTI traces kernels launched outside torch too)."""
    return sum(getattr(e, "self_device_time_total", 0)
               for e in prof.key_averages()) / 1e3


def timed(fn, reps: int = 50, warmup: int = 5, profile_out=None):
    """(device ms per call, wall ms per call) of ``fn`` on the card.

    Device time: torch.profiler's CUPTI record of the kernels and copies
    of ``reps`` calls, over ``reps`` -- what the card spends, without
    the host's launch overhead (None if the profiler saw no device
    activity).  Wall time: median of single calls bracketed by CUDA
    events, which includes the host's launch path while the card
    waits.  ``profile_out``, a list, receives the profiler run."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy = device_busy_ms(prof)
    if profile_out is not None:
        profile_out.append(prof)
    return (busy / reps if busy > 0 else None), float(np.median(times))


def device_timed(fn):
    """(device ms a call, its source, wall ms a call): timed(fn)'s
    torch.profiler device time, or queued_ms(fn) -- CUDA events around
    calls queued behind a sleep kernel -- where the profiler saw none
    (ROADMAP B4)."""
    dev, wall = timed(fn)
    if dev is not None:
        return dev, "profiler", wall
    return queued_ms(fn), "events", wall


def fmt_sourced(t) -> str:
    return f"{t[0]:.5f} ({t[1]}; wall {t[2]:.4f})"


def user_timing(t_k, t_p, work) -> dict:
    """A user-combine kernel's JSON numbers: its device ms per call and
    its plain version's (the call's wall where the profiler saw no
    device time), and its bound from (bytes, f32 ops); no library call
    computes a fold under a user combine."""
    ms, plain_ms = (d if d is not None else w for d, w in (t_k, t_p))
    bms, bound_by = bound_ms(*work)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": bound_by, "library_ms": None}


def fmt_ms(ms) -> str:
    return f"{ms:.5f}"


def fmt(t) -> str:
    dev, wall = t
    return (f"{dev:.5f}" if dev is not None else "not measured") + \
        f" ({wall:.4f})"


def work_of(T: int, starts, ends):
    """(bytes, adds) the function needs on these inputs: each value
    inside some extent read once, the extents read once, the sums
    written once; one add per element of each extent."""
    cover = np.zeros(T + 1, np.int64)
    np.add.at(cover, starts, 1)
    np.add.at(cover, ends, -1)
    touched = int((np.cumsum(cover[:T]) > 0).sum())
    B = len(starts)
    return 4 * touched + 8 * B + 4 * B, int((ends - starts).sum())


def bound_ms(nbytes: int, ops: int):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def csr_of(T: int, starts, ends, device):
    """The extents as a [B, T] 0/1 CSR matrix: the library yardstick
    computes the window sums as one sparse matrix-vector product."""
    lens = ends - starts
    crow = np.concatenate([[0], np.cumsum(lens)])
    cols = np.concatenate([np.arange(s, e) for s, e in zip(starts, ends)]
                          or [np.empty(0, np.int64)])
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(
            torch.from_numpy(crow).to(device),
            torch.from_numpy(cols).to(device),
            torch.ones(len(cols), dtype=torch.float32, device=device),
            size=(len(starts), T), check_invariants=True)


def pane_extents():
    """The pane-rebuild cell's launch (config 15's stream through
    WinSeqTPU("sum", 4096, 64) with resident=False): a 65,536-event
    chunk gives each of the 8 keys 128 new pane partials after 63
    carried ones and fires 128 windows of 64 panes a key; the engine
    pads T = 1,528 and B = 1,024 to 2,048 (padding windows (0, 0))."""
    w = WIN15 // PANE_SLIDE
    per_key = PANE_NEW + w - 1
    s = (np.arange(KEYS15)[:, None] * per_key
         + np.arange(PANE_NEW)[None, :]).ravel()
    starts = np.zeros(2048, np.int64)
    ends = np.zeros(2048, np.int64)
    starts[:len(s)], ends[:len(s)] = s, s + w
    return 2048, starts, ends


# a hint that picks each form of the window-sum kernel (either form is
# right for any extent; the engine passes the batch's widest extent)
K1_FORM_HINTS = {"thread": 0, "warp": None}


def check_kernel(device, card: str) -> dict:
    from windflow_tpu_torch.ops.cuda import window_sum as ws
    rng = np.random.default_rng(0)
    shapes = {"headline": headline_extents(), "pane": pane_extents(),
              "wide": wide_extents(rng),
              "wide_disjoint": disjoint_extents(rng),
              "edges": edge_extents()}
    # the launch floor: the form the headline takes, on one window
    one = pack([0], [2], device)
    tiny = torch.ones(8, dtype=torch.float32, device=device)
    t_floor = timed(lambda: ws.window_sums(tiny, one, max_extent=2))
    floor_ms = t_floor[0] if t_floor[0] is not None else t_floor[1]
    log(f"[kernel] launch floor: the thread form on one window, device ms "
        f"per call (wall ms per call) {fmt(t_floor)} ({card})")
    entry = None
    worst_err = 0.0
    for name, (T, starts, ends) in shapes.items():
        se = pack(starts, ends, device)
        # the engine's hint: the batch's widest extent, known on the host
        hint = int((ends - starts).max())
        form = ws.form_for(hint)
        # integer data: every sum below 2^24, so kernel, plain version
        # and the float64 oracle must agree exactly -- bounded by the
        # widest extent where the plain version sums tiles, by the whole
        # buffer where it takes the prefix scan
        hi = max(2, (1 << 24) // (T if hint > 32 else hint))
        ints = rng.integers(0, hi, T).astype(np.float32)
        f32 = rng.random(T, dtype=np.float32)
        p = ws.window_sums_plain(torch.from_numpy(ints).to(device),
                                 se).cpu().numpy()
        ref = float64_sums(ints, starts, ends)
        if not np.array_equal(p, ref):
            raise AssertionError(f"[kernel] {name}: plain version not exact "
                                 f"on integers, err {np.abs(p - ref).max()}")
        ref32 = float64_sums(f32, starts, ends)
        # both forms: exact on integers, rtol 1e-5 on random f32
        for fname, fhint in K1_FORM_HINTS.items():
            vals = torch.from_numpy(ints).to(device)
            k = ws.window_sums(vals, se, max_extent=fhint).cpu().numpy()
            if not np.array_equal(k, ref):
                raise AssertionError(
                    f"[kernel] {name} {fname} form: integer data not "
                    f"exact: err {np.abs(k - ref).max()}")
            worst_err = max(worst_err, float(np.abs(k - p).max()))
            vals = torch.from_numpy(f32).to(device)
            k = ws.window_sums(vals, se, max_extent=fhint).cpu().numpy()
            np.testing.assert_allclose(
                k, ref32, rtol=RTOL_F32, atol=0,
                err_msg=f"[kernel] {name} {fname} form: random f32")
        vals = torch.from_numpy(f32).to(device)
        k = ws.window_sums(vals, se, max_extent=hint).cpu().numpy()
        p = ws.window_sums_plain(vals, se).cpu().numpy()
        f32_err = float(np.abs(k - p).max())
        if name == "headline":
            # the plain version takes the tile form here: the same two
            # adds as the kernel
            np.testing.assert_allclose(k, p, rtol=1e-6, atol=0,
                                       err_msg="[kernel] headline vs plain")
            worst_err = max(worst_err, f32_err)
        torch.cuda.synchronize()
        t_forms = {f: timed(lambda: ws.window_sums(vals, se, max_extent=h))
                   for f, h in K1_FORM_HINTS.items()}
        t_k = t_forms[form]
        t_p = timed(lambda: ws.window_sums_plain(vals, se), reps=20)
        csr = csr_of(T, starts, ends, device)
        t_l = timed(lambda: torch.mv(csr, vals), reps=20)
        # device time where the profiler saw it, else the call's wall
        ms, plain_ms, lib_ms = (d if d is not None else w
                                for d, w in (t_k, t_p, t_l))
        lib = torch.mv(csr, vals).cpu().numpy()
        np.testing.assert_allclose(lib, ref32, rtol=RTOL_F32, atol=0,
                                   err_msg=f"[kernel] {name}: library")
        nbytes, ops = work_of(T, starts, ends)
        bms, bound_by = bound_ms(nbytes, ops)
        share = nbytes / (ms * 1e-3) / HBM_BYTES_PER_S
        # what direct summation reads: every window its own extent
        read = 4 * int(np.maximum(ends - starts, 0).sum())
        log(f"[kernel] {name}: T={T} B={len(starts)} max_extent={hint} -> "
            f"{form} form; both forms exact on integers, rtol {RTOL_F32} on "
            f"f32; f32 |kernel-plain|max={f32_err:.3g}; device ms per call "
            f"(wall ms per call): kernel {fmt(t_k)} (thread form "
            f"{fmt(t_forms['thread'])}, warp form {fmt(t_forms['warp'])}), "
            f"{ms / floor_ms:.2f}x the launch floor; plain {fmt(t_p)}, "
            f"sparse mv {fmt(t_l)}; bound {bms:.4g} ms ({bound_by}), "
            f"{nbytes} B moved = {100 * share:.2f}% of HBM peak at the "
            f"kernel's device time; the windows' own extents are {read} B, "
            f"{read / (ms * 1e-3) / 1e12:.3f} TB/s ({card})")
        if name == "headline":
            entry = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                     "bound_by": bound_by, "library_ms": lib_ms}
    entry["max_abs_err"] = worst_err
    return entry


# ---------------------------------------------------------------------------
# 4. main path
# ---------------------------------------------------------------------------

def oracle(n_events: int, power: int = 1):
    """Closed form of the synthetic law under TB windows, float64:
    key k holds ts 0..M-1 (M = n/keys) with value (ts*keys + k) % 97;
    window w covers ts [w*slide, w*slide + win), and every window opened
    by a tuple fires (partial tail windows flush at EOS).  Each window
    holds the sum of its values to the ``power``."""
    assert n_events % N_KEYS == 0
    M = n_events // N_KEYS
    keys = np.arange(N_KEYS)
    t = np.arange(VMOD)
    # partial[k, r] = sum_{t < r} (t*keys + k) % 97; the law has period 97
    per = ((t[None, :] * N_KEYS + keys[:, None]) % VMOD) ** power
    partial = np.concatenate([np.zeros((N_KEYS, 1), np.int64),
                              np.cumsum(per, axis=1)], axis=1)
    full = int(per[0].sum())

    def prefix(n):  # [keys, W] prefix sums at ts n
        return (n // VMOD) * full + np.take_along_axis(partial, n % VMOD,
                                                       axis=1)

    n_win = (M - 1) // SLIDE + 1
    w = np.arange(n_win)
    a = np.broadcast_to(w * SLIDE, (N_KEYS, n_win))
    b = np.broadcast_to(np.minimum(w * SLIDE + WIN, M), (N_KEYS, n_win))
    sums = prefix(b) - prefix(a)
    return (np.repeat(keys, n_win), np.tile(w, N_KEYS),
            sums.reshape(-1).astype(np.float64))


class LatencySink:
    """bench.py's window-latency sink: birth = emit stamp of the source
    chunk (``chunk`` events) carrying the window's closing tuple,
    emission = arrival.  Takes result batches and result records.
    ``closing(ids, keys)`` is the event index of each window's closing
    tuple (default: the headline's law, ts = e // N_KEYS)."""

    def __init__(self, stamps, chunk=SOURCE_BATCH, closing=None):
        self.stamps = stamps
        self.chunk = chunk
        self.closing = closing or (
            lambda ids, keys: (ids * SLIDE + (WIN - 1)) * N_KEYS + keys)
        self.lock = threading.Lock()
        self.keys, self.ids, self.vals, self.lats = [], [], [], []

    def __call__(self, item):
        if item is None:
            return
        now = time.perf_counter()
        if hasattr(item, "get_control_fields"):
            keys, ids = np.array([item.key]), np.array([item.id])
            vals = np.array([item.value], np.float64)
        else:
            keys, ids = np.asarray(item.key).copy(), np.asarray(item.id).copy()
            vals = np.asarray(item["value"], np.float64).copy()
        with self.lock:
            self.keys.append(keys)
            self.ids.append(ids)
            self.vals.append(vals)
            self.lats.extend((now - self.births(self.closing(ids, keys)))
                             .tolist())

    def births(self, closing: np.ndarray) -> np.ndarray:
        """Emit stamps of the chunks holding events ``closing``."""
        chunk = np.minimum(closing // self.chunk, len(self.stamps) - 1)
        return np.asarray(self.stamps)[chunk]


def device_logics(graph, cls=None):
    """Every window engine of class ``cls`` (default: the device window
    engine) in a graph: fused segments' logics, and both halves of an
    operator-fused stage (PaneFarmTPU's PLQ)."""
    from windflow_tpu_torch.operators.tpu.win_seq_tpu import WinSeqTPULogic
    from windflow_tpu_torch.runtime.node import ChainedLogic, FusedLogic
    cls = cls or WinSeqTPULogic
    found = []
    for node in graph._all_nodes():
        for lg in ([seg.logic for seg in node.logic.segments]
                   if isinstance(node.logic, FusedLogic) else [node.logic]):
            halves = [lg.a, lg.b] if isinstance(lg, ChainedLogic) else [lg]
            found += [h for h in halves if isinstance(h, cls)]
    return found


def find_logic(graph, cls=None):
    found = device_logics(graph, cls)
    if len(found) != 1:
        raise AssertionError(f"expected one window engine, found "
                             f"{len(found)}")
    return found[0]


def run_main(n_events: int, device: str, make_op=None, records=False,
             materialize=False, closing=None, source_batch=SOURCE_BATCH):
    """The headline's stream through the headline's operator, or through
    ``make_op()``: SynthChunks of ``source_batch`` events, stamped as they
    leave the source -- the chunks SyntheticSource(chunked=True) emits;
    with ``materialize``, their TupleBatches (SyntheticSource(
    chunked=False)'s), for operators that take batches, not chunks --
    or, with ``records``, their records, pushed one by one by a record
    source (65,536 a stamp), for operators on the record plane.
    ``closing`` as LatencySink takes it (default: the headline's
    window)."""
    import windflow_tpu_torch as wf
    from windflow_tpu_torch.core.tuples import BasicRecord, SynthChunk
    from windflow_tpu_torch.operators.basic_ops import Sink, Source
    from windflow_tpu_torch.operators.batch_ops import BatchSource
    from windflow_tpu_torch.operators.tpu.win_seq_tpu import WinSeqTPU

    stamps: list = []
    state = {"i": 0}
    chunk = RECORD_CHUNK if records else source_batch

    def next_chunk():
        i = state["i"]
        if i >= n_events:
            return None
        state["i"] = i + chunk
        stamps.append(time.perf_counter())
        c = SynthChunk(i, min(chunk, n_events - i), N_KEYS, VMOD, 1.0, 0.0)
        return c.materialize() if materialize else c

    def record_source(shipper):
        c = next_chunk()
        if c is None:
            return False
        b = c.materialize()
        for k, t, v in zip(b.key.tolist(), b.ts.tolist(),
                           b["value"].tolist()):
            shipper.push(BasicRecord(k, t, t, v))
        return True

    sink = LatencySink(stamps, chunk, closing)
    g = wf.PipeGraph("chip_smoke", wf.Mode.DEFAULT,
                     config=wf.RuntimeConfig(device=device))
    op = make_op() if make_op is not None else WinSeqTPU(
        "sum", WIN, SLIDE, wf.WinType.TB, batch_len=DEVICE_BATCH,
        emit_batches=True, max_buffer_elems=MAX_BUFFER,
        inflight_depth=INFLIGHT, max_batch_delay_ms=DELAY_MS)
    src = (Source(record_source) if records
           else BatchSource(lambda ctx: next_chunk(), 1))
    g.add_source(src).add(op).add_sink(Sink(sink))
    t0 = time.perf_counter()
    g.run()
    secs = time.perf_counter() - t0
    return g, sink, secs


def check_main(g, sink, n_events: int) -> int:
    logic = find_logic(g)
    if logic._native is None:
        raise AssertionError("[main] the native lane was not active")
    return len(check_windows(sink, oracle(n_events), "main")[0])


def check_windows(sink, want, tag: str, rtol: float = 0.0):
    """Every window the sink received, held against ``want`` (keys, ids,
    values sorted by key then id: exact, or within ``rtol`` of the
    float64 values); per key, ids arrive in order and once.  Returns the
    sink's windows sorted as ``want``."""
    keys = np.concatenate(sink.keys)
    ids = np.concatenate(sink.ids)
    vals = np.concatenate(sink.vals)
    # per key, windows are emitted in id order
    by_key = np.argsort(keys, kind="stable")
    k, i = keys[by_key], ids[by_key]
    same = k[1:] == k[:-1]
    if not np.all(i[1:][same] > i[:-1][same]):
        raise AssertionError(f"[{tag}] a key's ids arrived out of order")
    ok, oi, ov = want
    if len(keys) != len(ok):
        raise AssertionError(f"[{tag}] {len(keys)} windows, oracle "
                             f"{len(ok)}")
    order = np.lexsort((ids, keys))
    close = (np.array_equal(vals[order], ov) if not rtol else
             np.allclose(vals[order], ov, rtol=rtol, atol=0))
    if not (np.array_equal(keys[order], ok) and np.array_equal(ids[order], oi)
            and close):
        bad = np.nonzero(vals[order] != ov)[0]
        raise AssertionError(f"[{tag}] windows differ from the oracle "
                             f"({len(bad)} values differ)")
    return keys[order], ids[order], vals[order]


def profile_main(card: str) -> None:
    """The main path once more under torch.profiler (CUDA activity
    only): the device's busy and idle share of the run's wall time and
    the device ops that fill the busy part."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        g, sink, secs = run_main(N_EVENTS, "cuda")
    check_main(g, sink, N_EVENTS)
    log(f"[profile] main path under the profiler: "
        f"{profile_summary(prof, secs, 6)} ({card})")


def profile_summary(prof, secs: float, n_top: int) -> str:
    """Wall, device busy and idle share, and the top device ops of one
    profiled run."""
    ops = sorted(((getattr(e, "self_device_time_total", 0) / 1e3, e.count,
                   e.key) for e in prof.key_averages()), reverse=True)
    busy = sum(ms for ms, _n, _k in ops)
    top = "; ".join(f"{k[:48]} x{n} {ms:.3f} ms" for ms, n, k in ops[:n_top]
                    if ms > 0)
    return (f"wall {secs:.3f} s, device busy {busy:.3f} ms = "
            f"{100 * busy / (secs * 1e3):.3f}% (idle "
            f"{100 - 100 * busy / (secs * 1e3):.3f}%); top device ops: {top}")


# ---------------------------------------------------------------------------
# 4b. bench configs 3 and 4, the device farms, a custom window function
# ---------------------------------------------------------------------------

# bench.py runs configs 3 and 4 at 32M events (bench.py:2434-2437)
N34 = 32_000_000
# [farms]: WinFarmTPU on 8M events of the headline stream; WinMapReduceTPU
# on 2^15 (its map emitter routes records, not batches: the record plane
# runs at 1-2e4 tuples/s, so more would outlast the rest of the script)
N_FARM = 8_000_000
N_WMR = 1 << 15
N_CUSTOM = 1_000_000
RECORD_CHUNK = 65_536
# f32 sums of squares of values < 97 over 4096-tick windows reach 3.8e7,
# past f32's exact integers: held to the float64 oracle within rtol
RTOL_SQUARES = RTOL_F32


# each farm cell's windows as check_windows returned them ([mesh kf4]
# holds its windows to config 4's)
FARM_WINDOWS: dict = {}


def sum_of_squares(gwid, cols, mask):
    """The custom window function of the reference's engine test
    (tests/test_tpu_operators.py:96-98), in torch."""
    v = torch.where(mask, cols["value"], 0.0)
    return torch.sum(v * v)


def reduce_sum(gwid, iterable, result):
    result.value = sum(t.value for t in iterable)


def farm_op(cell: str):
    """The operator of one farm cell, as bench.py builds configs 3
    (bench.py:501-527) and 4 (:530-551): the headline's window, device
    batch, buffer and in-flight depth, the default 10 ms delay."""
    import windflow_tpu_torch as wf
    from windflow_tpu_torch.operators.tpu.farms_tpu import (
        KeyFarmTPU, PaneFarmTPU, WinFarmTPU, WinMapReduceTPU)
    common = dict(batch_len=DEVICE_BATCH, max_buffer_elems=MAX_BUFFER,
                  inflight_depth=INFLIGHT)
    tb = wf.WinType.TB
    if cell == "main3":
        return PaneFarmTPU("sum", "sum", WIN, SLIDE, tb, plq_parallelism=1,
                           wlq_parallelism=1, opt_level=wf.OptLevel.LEVEL2,
                           emit_batches=True, **common)
    if cell in ("main4 coalesced", "main4 replicas"):
        return KeyFarmTPU("sum", WIN, SLIDE, tb, parallelism=2,
                          emit_batches=True,
                          coalesce=cell == "main4 coalesced", **common)
    if cell == "farms WinFarmTPU":
        return WinFarmTPU("sum", WIN, SLIDE, tb, parallelism=2, **common)
    if cell == "farms WinMapReduceTPU":
        return WinMapReduceTPU("sum", reduce_sum, WIN, SLIDE, tb,
                               map_parallelism=2, **common)
    return KeyFarmTPU(sum_of_squares, WIN, SLIDE, tb, parallelism=2,
                      emit_batches=True, **common)


def run_farm(cell: str, n_events: int, card: str, device="cuda"):
    """One farm cell on the card through PipeGraph -> source -> farm ->
    Sink: every window held against the closed-form oracle, the launches
    of the lane's kernel equal to the batches of the farm's device
    engines, no other kernel launched.  The lane's kernel is the
    window-sum kernel, or the fused update+query kernel where the
    planner promoted the engines onto the resident pane lane (as it
    promotes WinFarmTPU's striped replicas, whose private slide makes
    the pane as long as the window); a custom window function launches
    none.  Returns (kernel name or None, its launches)."""
    custom = cell == "custom"
    reset_counts()
    g, sink, secs = run_main(n_events, device, lambda: farm_op(cell),
                             records=cell == "farms WinMapReduceTPU")
    counts = read_counts()
    logics = device_logics(g)
    if not logics or any(lg.device is None or lg.device.type != device
                         for lg in logics):
        raise AssertionError(f"[{cell}] device engines "
                             f"{[str(lg.device) for lg in logics]}")
    resident = sum(lg._resident is not None for lg in logics)
    if resident not in (0, len(logics)):
        raise AssertionError(f"[{cell}] {resident} of {len(logics)} "
                             f"engines on the resident lane")
    kernel = (None if custom else
              "flatfat_update_query" if resident else "window_sum")
    launches = check_launches(cell, logics, counts, kernel)
    FARM_WINDOWS[cell] = check_windows(
        sink, oracle(n_events, 2 if custom else 1), cell,
        RTOL_SQUARES if custom else 0.0)
    windows = len(FARM_WINDOWS[cell][0])
    p50, p99 = (float(np.percentile(sink.lats, q)) * 1e3 for q in (50, 99))
    batches = sum(lg.launched_batches for lg in logics)
    log(f"[{cell}] {n_events} events in {secs:.3f} s = "
        f"{n_events / secs:.1f} tuples/s; {windows} windows match the "
        f"oracle {'within rtol %g' % RTOL_SQUARES if custom else 'exactly'}"
        f"; window latency p50 {p50:.3f} ms, p99 {p99:.3f} ms; "
        f"{len(logics)} device engine(s)"
        f"{' on the resident pane lane' if resident else ''}, {batches} "
        f"batches, "
        + (f"{launches} {kernel} launches, other kernels 0"
           if kernel else "no kernel launched (a torch program)")
        + f" ({card})")
    return kernel, launches


def profile_farm(cell: str, n_events: int, card: str) -> None:
    """A farm cell once more under torch.profiler (CUDA activity only):
    the device's busy and idle share and its top device ops; every
    window held against the oracle again."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        _g, sink, secs = run_main(n_events, "cuda", lambda: farm_op(cell))
    check_windows(sink, oracle(n_events), cell)
    log(f"[profile {cell}] {n_events} events under the profiler: "
        f"{profile_summary(prof, secs, 6)} ({card})")


# ---------------------------------------------------------------------------
# 3b. the FlatFAT query kernel (K2) against its plain version
# ---------------------------------------------------------------------------

# bench.py config 15_resident_state (bench.py:1737-1832, run at :2559
# with N_EVENTS // 8)
N15 = 8_000_000
KEYS15 = 8
WIN15, SLIDE15 = 4096, 16
SOURCE15 = 65_536
BATCH15 = 128
# the rebuild lane's launch shape there: the whole-partition device step
# launches once per 65,536-event chunk, so a launch carries 4096 windows
# over the 8 keys' retained series (~98k values), padded to T_pad = 2^17
# and B_pad = 4096 ([main15] checks this against the run)
T_PAD15, B_PAD15 = 1 << 17, 4096
# the resident forest: 16 initial rows x pow2(4096 + 16 + 1024) leaves;
# a chunk of 1024 leaves fires 64 windows -> 256 padded query pieces
RES_K, RES_N, RES_CHUNK = 16, 8192, 1024
# the resident pane lane's slide (pane = gcd(4096, 64) = 64 >= 16)
PANE_SLIDE = 64
# the config-15 graphs' device (the CPU only to rehearse the phases
# without a card, at a small N15)
DEVICE15 = "cuda"


def k2_combines():
    """The builtin combines, compiled into the FlatFAT kernels' shared
    library: name -> (combine, neutral, f32 ops per combine)."""
    return {"add": (torch.add, 0.0, 1), "max": (torch.maximum, -np.inf, 1),
            "min": (torch.minimum, np.inf, 1)}


def left_weighted(a, b):
    """The reference tests' non-commutative combine (0.5 a is exact): it
    shows that the walks keep oldest -> newest order."""
    return a * 0.5 + b


def nan_skipping_max(a, b):
    return torch.where(torch.isnan(a) | (b > a), b, a)


# the path phase's user combine: config 15's FFAT lanes under
# log-sum-exp, through the public builder
PATH_COMBINE = "logaddexp"


def user_combines():
    """User FFAT combines that no kernel builds in: each lowered from
    its torch ops and compiled into a library of its own.  name ->
    (combine, neutral, f32 ops per combine, transcendental)."""
    return {"mul": (torch.mul, 1.0, 1, False),
            "left_weighted": (left_weighted, 0.0, 2, False),
            # |a - b|, exp, log1p, max, add (and the isinf test)
            "logaddexp": (torch.logaddexp, -np.inf, 7, True),
            "where_max": (nan_skipping_max, -np.inf, 3, False)}


# a transcendental combine (logaddexp) in the kernels against its plain
# version on the card: the kernel calls the expf/log1pf that torch's own
# CUDA kernel calls, so each combine is expected bitwise; the bound
# allows one ulp a combine over the deepest fold checked (2 x 22 levels
# + 1, the 2^22-leaf tree) with room to spare
ULP_BOUND = 64


def combine_values(name, rng, shape) -> np.ndarray:
    """f32 leaves for a user combine: near 1 for the product (no
    overflow or underflow inside a window), with a NaN in 16 for the
    NaN-skipping max, uniform [0, 1) otherwise."""
    if name == "mul":
        return rng.uniform(0.9, 1.1, shape).astype(np.float32)
    v = rng.random(shape, dtype=np.float32)
    if name == "where_max" and v.size:
        flat = v.reshape(-1)
        flat[rng.integers(0, flat.size, max(1, flat.size // 16))] = np.nan
    return v


def ulp_distance(k: np.ndarray, p: np.ndarray) -> int:
    """The largest distance in f32 ulps between two arrays (NaNs must
    sit at the same places; equal infinities are 0 apart)."""
    k = np.ascontiguousarray(k, np.float32).reshape(-1)
    p = np.ascontiguousarray(p, np.float32).reshape(-1)
    nan = np.isnan(k)
    if not np.array_equal(nan, np.isnan(p)):
        return 1 << 31
    if nan.all():
        return 0

    def ordered(a):
        i = a[~nan].view(np.int32).astype(np.int64)
        return np.where(i >= 0, i, -(i & 0x7FFFFFFF))

    return int(np.abs(ordered(k) - ordered(p)).max())


def hold_user(k, p, transcendental: bool, tag: str):
    """A user combine's kernel result against its plain version:
    bitwise for an arithmetic combine, within ULP_BOUND for a
    transcendental one.  Returns (bitwise, ulps)."""
    k = np.ascontiguousarray(k, np.float32)
    p = np.ascontiguousarray(p, np.float32)
    bitwise = k.tobytes() == p.tobytes()
    ulps = 0 if bitwise else ulp_distance(k, p)
    if not bitwise and (not transcendental or ulps > ULP_BOUND):
        want = (f"within {ULP_BOUND} ulp of" if transcendental
                else "bitwise")
        raise AssertionError(f"[{tag}] not {want} the plain version "
                             f"({ulps} ulp)")
    return bitwise, ulps


class UserTally:
    """Per user combine, across a phase's shapes: bitwise or not, the
    largest ulp distance and the largest absolute difference."""

    def __init__(self):
        self.rows = {}

    def add(self, name, bitwise, ulps, k, p):
        b, u, e = self.rows.get(name, (True, 0, 0.0))
        fin = np.isfinite(k) & np.isfinite(p)
        err = float(np.abs(k[fin] - p[fin]).max()) if fin.any() else 0.0
        self.rows[name] = (b and bitwise, max(u, ulps), max(e, err))

    def line(self) -> str:
        return "; ".join(f"{n} {'bitwise' if b else f'{u} ulp max'}"
                         for n, (b, u, _e) in self.rows.items())


def forest_of(leaves: torch.Tensor, comb) -> torch.Tensor:
    """[K, 2n] heap forest over leaves [K, n], one combine per level."""
    K, n = leaves.shape
    tree = torch.zeros((K, 2 * n), dtype=torch.float32, device=leaves.device)
    tree[:, n:] = leaves
    lo = n // 2
    while lo >= 1:
        ch = tree[:, 2 * lo: 4 * lo]
        tree[:, lo: 2 * lo] = comb(ch[:, 0::2], ch[:, 1::2])
        lo //= 2
    return tree


def pieces(n: int, keys, starts, ends):
    """Windows [starts, ends) in id space as the query kernel took them
    before the fused kernel: padded to a pow2 bucket of at least 256, a
    wrapping window as two pieces ([s, n), then [0, e mod n)) combined
    on the host in time order.  Returns (k2, s2, e2, wraps, B)."""
    keys = np.asarray(keys, np.int64)
    starts = np.asarray(starts, np.int64)
    ends = np.asarray(ends, np.int64)
    s = starts % n
    e_raw = ends % n
    wraps = (ends > starts) & (e_raw <= s)
    B = len(keys)
    b = 256
    while b < 2 * B:
        b <<= 1
    k2, s2, e2 = (np.zeros(b, np.int32) for _ in range(3))
    k2[:B] = keys
    s2[:B] = s
    e2[:B] = np.where(ends > starts, np.where(wraps, n, e_raw), s)
    k2[B:2 * B] = keys
    e2[B:2 * B] = np.where(wraps, e_raw, 0)
    return k2, s2, e2, wraps, B


# the single tree of [kernel K2]'s "single" shape
SINGLE_N = 1 << 20


def k2_shapes(rng):
    """name -> (K, n, rows or None, starts, ends) at the main paths'
    launch shapes, a deployment-size forest, a single tree at a real
    batch and edges."""
    shapes = {}
    # rebuild lane: one tree over the 8 keys' series, 512 windows each
    per_key = WIN15 + (B_PAD15 // KEYS15 - 1) * SLIDE15
    off = np.repeat(np.arange(KEYS15) * per_key, B_PAD15 // KEYS15)
    starts = off + np.tile(np.arange(B_PAD15 // KEYS15) * SLIDE15, KEYS15)
    shapes["rebuild"] = (1, T_PAD15, None, starts, starts + WIN15)
    # resident lane before the fused kernel: one chunk's 64 windows of
    # one key, ring-wrapping, as query pieces
    first = 5 * RES_N + 4000  # past several ring turns; half wrap
    qs = first + np.arange(RES_CHUNK // SLIDE15) * SLIDE15
    k2, s2, e2, wraps, _B = pieces(RES_N, np.full(len(qs), 3), qs,
                                   qs + WIN15)
    assert wraps.any()
    shapes["resident"] = (RES_K, RES_N, k2, s2, e2)
    # deployment-size forest: 4096 keys x 8192 leaves (256 MiB)
    B = 65_536
    s = rng.integers(0, RES_N, B)
    shapes["deploy"] = (4096, RES_N, rng.integers(0, 4096, B), s,
                        np.minimum(s + rng.integers(1, WIN15 + 1, B), RES_N))
    # FlatFATTorch's query at a real batch (rows None, the path
    # [flatfat] takes): one tree of 2^20 leaves, 65,536 windows of 1 to
    # 4,096 leaves; its own generator, so a caller that takes only the
    # rebuild shape draws what it drew before
    one = np.random.default_rng(2)
    s = one.integers(0, SINGLE_N - WIN15, B)
    shapes["single"] = (1, SINGLE_N, None, s,
                        s + one.integers(1, WIN15 + 1, B))
    shapes["edges16"] = (1, 16, None, np.array([0, 3, 0, 15, 16, 7, 9]),
                         np.array([0, 3, 16, 16, 16, 16, 4]))
    shapes["edges2"] = (1, 2, None, np.array([0, 0, 1, 2, 1]),
                        np.array([2, 1, 2, 2, 1]))
    return shapes


def walk_nodes(n: int, rows, starts, ends):
    """(forest node ids, combines) of the bit-walks over [starts, ends)
    of rows (None: one tree): each node a walk takes, and one combine
    per node taken plus the final one of each non-empty extent."""
    two_n = 2 * n
    levels = n.bit_length() - 1
    r = np.zeros(len(starts), np.int64) if rows is None else \
        np.asarray(rows, np.int64)
    s = np.clip(np.asarray(starts, np.int64), 0, n)
    e = np.clip(np.asarray(ends, np.int64), 0, n)
    lo, hi, base = s + n, e + n, r * two_n
    nodes, combines = [], int((e > s).sum())
    for _ in range(levels + 1):
        tl = (lo < hi) & ((lo & 1) == 1)
        nodes.append((base + lo)[tl])
        lo = np.where(tl, lo + 1, lo)
        tr = (lo < hi) & ((hi & 1) == 1)
        hi = np.where(tr, hi - 1, hi)
        nodes.append((base + hi)[tr])
        combines += int(tl.sum() + tr.sum())
        lo, hi = lo >> 1, hi >> 1
    return np.concatenate(nodes), combines


def walk_work(n: int, rows, starts, ends, ops_per_combine: int):
    """(bytes, f32 ops) the queries need on these inputs: extents, row
    ids and outputs once, each distinct tree node the walks take read
    once; one combine per node taken plus the final one."""
    nodes, combines = walk_nodes(n, rows, starts, ends)
    B = len(starts)
    nbytes = 8 * B + (4 * B if rows is not None else 0) + 4 * B \
        + 4 * len(np.unique(nodes))
    return nbytes, combines * ops_per_combine


def range_csr(n_cols: int, n: int, rows, starts, ends, device):
    """The queries as a [B, K*n] 0/1 CSR matrix over the forest's leaves:
    the library yardstick sums them as one sparse matrix-vector product."""
    s = torch.as_tensor(np.asarray(starts, np.int64), device=device)
    e = torch.as_tensor(np.asarray(ends, np.int64), device=device)
    r = (torch.zeros_like(s) if rows is None else
         torch.as_tensor(np.asarray(rows, np.int64), device=device))
    lens = torch.clamp(e - s, min=0)
    crow = torch.cat([lens.new_zeros(1), torch.cumsum(lens, 0)])
    nnz = int(crow[-1])
    cols = torch.repeat_interleave(r * n + s - crow[:-1], lens,
                                   output_size=nnz) \
        + torch.arange(nnz, device=device)
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(
            crow, cols, torch.ones(nnz, dtype=torch.float32, device=device),
            size=(len(starts), n_cols))


def float64_ranges(leaves: np.ndarray, rows, starts, ends) -> np.ndarray:
    """The float64 sums of leaves [K, n] over [starts, ends) of rows
    (None: one tree), extents clamped to [0, n] as the kernel clamps
    them; 0 for an empty extent."""
    K, n = leaves.shape
    c = np.zeros((K, n + 1))
    c[:, 1:] = np.cumsum(leaves.astype(np.float64), axis=1)
    r = 0 if rows is None else np.asarray(rows, np.int64)
    s = np.clip(np.asarray(starts, np.int64), 0, n)
    e = np.clip(np.asarray(ends, np.int64), 0, n)
    return np.where(e > s, c[r, e] - c[r, s], 0.0)


def check_k2(device, card: str) -> dict:
    """The query kernel against its plain version at every shape of
    k2_shapes: bitwise for add, max, min and the arithmetic user
    combines, within ULP_BOUND ulp for logaddexp, add on integer leaves
    exact against float64 too; device times of every combine, the plain
    version's, the sparse mv's, the bound, the share of it and the
    launch floor (edges2)."""
    from windflow_tpu_torch.ops.cuda import flatfat_query as fq
    rng = np.random.default_rng(1)
    out = {}
    worst_err = 0.0
    tally = UserTally()
    summary = []
    for name, (K, n, rows, starts, ends) in k2_shapes(rng).items():
        r_d = None if rows is None else torch.from_numpy(
            np.asarray(rows, np.int32)).to(device)
        s_d = torch.from_numpy(np.asarray(starts, np.int32)).to(device)
        e_d = torch.from_numpy(np.asarray(ends, np.int32)).to(device)
        ints_np = rng.integers(0, 97, (K, n)).astype(np.float32)
        ints = torch.from_numpy(ints_np).to(device)
        f32 = torch.from_numpy(
            rng.random((K, n), dtype=np.float32)).to(device)
        times = []
        for cname, (comb, neutral, opc) in k2_combines().items():
            for integer in ((True, False) if cname == "add" else (False,)):
                tree = forest_of(ints if integer else f32, comb)
                k = fq.flatfat_query(tree, r_d, s_d, e_d, comb, neutral)
                p = fq.flatfat_query_plain(tree, r_d, s_d, e_d, comb,
                                           neutral)
                torch.cuda.synchronize()
                k, p = k.cpu().numpy(), p.cpu().numpy()
                if k.tobytes() != p.tobytes():
                    raise AssertionError(
                        f"[kernel K2] {name} {cname}"
                        f"{' integer' if integer else ''}: not bitwise "
                        f"equal to the plain version, err "
                        f"{np.nanmax(np.abs(k - p))}")
                if integer and not np.array_equal(
                        k, float64_ranges(ints_np, rows, starts, ends)):
                    raise AssertionError(f"[kernel K2] {name} add: not "
                                         f"exact against float64")
                fin = np.isfinite(p)
                if fin.any():
                    worst_err = max(worst_err, float(
                        np.abs(k[fin] - p[fin]).max()))
            t_k = device_timed(lambda: fq.flatfat_query(
                tree, r_d, s_d, e_d, comb, neutral))
            times.append(f"{cname} {fmt_sourced(t_k)}")
            if cname == "add":
                add_tree, add_k = tree, t_k
        # the user combines, each through its own generated library
        for uname, (comb, neutral, opc, trans) in user_combines().items():
            leaves = torch.from_numpy(
                combine_values(uname, rng, (K, n))).to(device)
            tree = forest_of(leaves, comb)
            k = fq.flatfat_query(tree, r_d, s_d, e_d, comb, neutral)
            p = fq.flatfat_query_plain(tree, r_d, s_d, e_d, comb, neutral)
            torch.cuda.synchronize()
            k, p = k.cpu().numpy(), p.cpu().numpy()
            tally.add(uname, *hold_user(k, p, trans,
                                        f"kernel K2 {name} {uname}"), k, p)
            t_u = device_timed(lambda: fq.flatfat_query(
                tree, r_d, s_d, e_d, comb, neutral))
            times.append(f"{uname} {fmt_sourced(t_u)}")
            if name == "rebuild" and uname == PATH_COMBINE:
                t_up = timed(lambda: fq.flatfat_query_plain(
                    tree, r_d, s_d, e_d, comb, neutral), reps=20)
                user_entry = user_timing(t_u[::2], t_up, walk_work(
                    n, rows, starts, ends, opc))
                times.append(f"{uname} plain {fmt(t_up)}, bound "
                             f"{user_entry['bound_ms']:.4g} ms "
                             f"({user_entry['bound_by']})")
            del leaves, tree
        t_p = timed(lambda: fq.flatfat_query_plain(
            add_tree, r_d, s_d, e_d, torch.add, 0.0), reps=20)
        nbytes, ops = walk_work(n, rows, starts, ends, 1)
        bms, bound_by = bound_ms(nbytes, ops)
        ms = add_k[0]
        plain_ms = t_p[0] if t_p[0] is not None else t_p[1]
        lib_ms, lib_txt = None, "none"
        if name != "edges2":
            csr = range_csr(K * n, n, rows, starts, ends, device)
            leaves = add_tree[:, n:].reshape(-1).contiguous()
            lib = torch.mv(csr, leaves).cpu().numpy()
            ref = fq.flatfat_query(add_tree, r_d, s_d, e_d, torch.add,
                                   0.0).cpu().numpy()
            np.testing.assert_allclose(lib, ref, rtol=RTOL_F32, atol=1e-5,
                                       err_msg=f"[kernel K2] {name} mv")
            t_l = timed(lambda: torch.mv(csr, leaves), reps=20)
            lib_ms = t_l[0] if t_l[0] is not None else t_l[1]
            lib_txt = fmt(t_l)
            del csr
        log(f"[kernel K2] {name}: K={K} n={n} B={len(starts)} "
            f"max_extent={int(np.max(np.asarray(ends) - np.asarray(starts)))}"
            f"; bitwise equal to the plain version for add, max, min and "
            f"the arithmetic user combines (logaddexp within {ULP_BOUND} "
            f"ulp), add on integer leaves exact against float64; device ms "
            f"per call (source; wall ms per call): kernel "
            f"{'; '.join(times)}; plain (add) {fmt(t_p)}; sparse mv (add) "
            f"{lib_txt}, range max/min: no library call; bound {bms:.4g} "
            f"ms ({bound_by}; {nbytes} B, {ops} combines) ({card})")
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                     "bound_by": bound_by, "library_ms": lib_ms}
        summary.append((name, add_k, bms, bound_by))
        del ints, f32, add_tree
        torch.cuda.empty_cache()
    floor = out["edges2"]["ms"]
    log("[kernel K2] add, device ms per call against the bound and the "
        "launch floor (edges2): " + "; ".join(
            f"{name} {t[0]:.5f} ({t[1]}), bound {bms:.4g} ms ({by}), "
            f"share of bound {100 * bms / t[0]:.2f} %, "
            f"{t[0] / floor:.2f}x the floor"
            for name, t, bms, by in summary) + f" ({card})")
    log(f"[kernel K2] user combines against the plain version over every "
        f"shape: {tally.line()} ({card})")
    out["max_abs_err"] = worst_err
    user_entry["max_abs_err"] = tally.rows[PATH_COMBINE][2]
    out["user"] = user_entry
    return out


# ---------------------------------------------------------------------------
# 3b'. the fused build+query kernel of the rebuild lane (K2r)
# ---------------------------------------------------------------------------

def k2r_shapes(rng):
    """name -> (n, starts, ends): the rebuild lane's launch (the query
    kernel's rebuild extents over one tree of T_PAD15 leaves), two tiles
    with the edges (empty and reversed extents, [0, n), end = n), and
    two tiling rounds (2^22 leaves: 4096 tile roots)."""
    rebuild = k2_shapes(rng)["rebuild"]
    shapes = {"rebuild": (T_PAD15, rebuild[3], rebuild[4])}
    for name, n in (("edges2048", 2048), ("rounds", 1 << 22)):
        starts = rng.integers(0, n, 4096)
        ends = np.minimum(starts + rng.integers(0, WIN15 + 1, 4096), n)
        edges = [(0, n), (n - 1, n), (5, 5), (9, 3), (1021, 1027), (n, n),
                 (0, 1), (n - 4096, n)]
        for i, (s, e) in enumerate(edges):
            starts[i], ends[i] = s, e
        shapes[name] = (n, starts, ends)
    return shapes


def legacy_rebuild(leaves, se, comb, neutral):
    """The rebuild lane's launch as it ran before the fused kernel: the
    17-level torch sweep of build_tree, the query kernel, the where."""
    from windflow_tpu_torch.ops.cuda import flatfat_query as fq
    tree = fq.build_tree(leaves, comb, neutral)
    out = fq.flatfat_query(tree, None, se[0], se[1], comb, neutral)
    return torch.where(se[1] > se[0], out, torch.zeros_like(out))


# readings of K2r under the path's user combine, in one process: one
# reading of 0.05590 ms stood against 0.0052-0.0094 ms in every other
K2R_READINGS = 7
# a reading this many times the fastest is slow: its profile is logged
SLOW_READING = 2.0


def repeated_readings(fn, tag: str, card: str):
    """``timed(fn)`` K2R_READINGS times: logs every device reading, the
    median and the spread, and for a reading at SLOW_READING times the
    fastest or more, its profile's top device ops.  Returns the median
    (device ms, wall ms)."""
    reads, profs = [], []
    for _ in range(K2R_READINGS):
        reads.append(timed(fn, profile_out=profs))
    devs = [d for d, _w in reads if d is not None]
    if len(devs) != len(reads):
        raise AssertionError(f"[{tag}] the profiler saw no device time")
    lo = min(devs)
    med = (float(np.median(devs)), float(np.median([w for _d, w in reads])))
    log(f"[{tag} readings] device ms per call: "
        f"{', '.join(f'{d:.5f}' for d in devs)}; median {med[0]:.5f}, "
        f"spread {lo:.5f}-{max(devs):.5f} ({card})")
    for i, d in enumerate(devs):
        if d >= SLOW_READING * lo:
            ops = sorted(((getattr(e, "self_device_time_total", 0) / 1e3,
                           e.count, e.key)
                          for e in profs[i].key_averages()), reverse=True)
            log(f"[{tag} readings] reading {i + 1} is {d / lo:.1f}x the "
                f"fastest; its profile's device ops: "
                + "; ".join(f"{k[:60]} x{n} {ms:.4f} ms"
                            for ms, n, k in ops[:6] if ms > 0))
    return med


def check_k2r(device, card: str) -> dict:
    """The fused build+query kernel against its plain version: bitwise
    for the four combines on integer and random f32 leaves, at every
    shape; timings at the rebuild lane's launch."""
    from windflow_tpu_torch.ops.cuda import flatfat_query as fq
    rng = np.random.default_rng(3)
    tally = UserTally()
    for name, (n, starts, ends) in k2r_shapes(rng).items():
        se = pack(starts, ends, device)
        leaves = {"int": torch.from_numpy(rng.integers(0, 97, n).astype(
            np.float32)).to(device),
            "f32": torch.from_numpy(rng.random(n, dtype=np.float32)).to(
                device)}
        user_t = []
        for uname, (comb, neutral, opc, trans) in user_combines().items():
            v = torch.from_numpy(combine_values(uname, rng, n)).to(device)
            k = fq.flatfat_build_query(v, se, comb, neutral)
            p = fq.flatfat_build_query_plain(v, se, comb, neutral)
            torch.cuda.synchronize()
            k, p = k.cpu().numpy(), p.cpu().numpy()
            tally.add(uname, *hold_user(
                k, p, trans, f"kernel K2 rebuild {name} {uname}"), k, p)
            if name == "rebuild" and uname == PATH_COMBINE:
                t_u = repeated_readings(
                    lambda: fq.flatfat_build_query(v, se, comb, neutral),
                    f"kernel K2 rebuild {uname}", card)
                user_t.append(f"{uname} {fmt(t_u)} (median of "
                              f"{K2R_READINGS})")
            elif name == "rebuild":
                t_u = timed(lambda: fq.flatfat_build_query(v, se, comb,
                                                           neutral))
                user_t.append(f"{uname} {fmt(t_u)}")
            if name == "rebuild":
                if uname == PATH_COMBINE:
                    t_up = timed(lambda: fq.flatfat_build_query_plain(
                        v, se, comb, neutral), reps=20)
                    # as add's bound below, each combine opc f32 ops
                    user_entry = user_timing(t_u, t_up, (
                        4 * n + 12 * len(starts),
                        (n - 1 + walk_nodes(n, None, starts, ends)[1])
                        * opc))
                    user_t.append(f"{uname} plain {fmt(t_up)}, bound "
                                  f"{user_entry['bound_ms']:.4g} ms "
                                  f"({user_entry['bound_by']})")
            del v
        for cname, (comb, neutral, _opc) in k2_combines().items():
            for data, v in leaves.items():
                k = fq.flatfat_build_query(v, se, comb, neutral)
                p = fq.flatfat_build_query_plain(v, se, comb, neutral)
                legacy = legacy_rebuild(v, se, comb, neutral)
                torch.cuda.synchronize()
                k, p = k.cpu().numpy(), p.cpu().numpy()
                if not (np.array_equal(k, p) and np.array_equal(
                        k, legacy.cpu().numpy())):
                    raise AssertionError(
                        f"[kernel K2 rebuild] {name} {cname} {data}: not "
                        f"bitwise the plain version (err "
                        f"{np.nanmax(np.abs(k - p), initial=0)})")
        log(f"[kernel K2 rebuild] {name}: n={n} B={len(starts)} bitwise "
            f"equal to the plain version and the pre-PR chain for add, "
            f"max, min on integer and random f32 leaves; user combines "
            f"against the plain version: {tally.line()}"
            + (f"; user combines' device ms per call (wall ms per call): "
               f"{'; '.join(user_t)}" if user_t else "") + f" ({card})")
        if name != "rebuild":
            del leaves
            continue
        v = leaves["int"]
        t_k = timed(lambda: fq.flatfat_build_query(v, se, torch.add, 0.0))
        t_chain = timed(lambda: legacy_rebuild(v, se, torch.add, 0.0))
        t_p = timed(lambda: fq.flatfat_build_query_plain(
            v, se, torch.add, 0.0), reps=20)
        csr = range_csr(n, n, None, starts, ends, device)
        lib = torch.mv(csr, v).cpu().numpy()
        np.testing.assert_array_equal(
            lib, fq.flatfat_build_query(v, se, torch.add, 0.0).cpu().numpy(),
            err_msg="[kernel K2 rebuild] sparse mv")
        t_l = timed(lambda: torch.mv(csr, v), reps=20)
        # the launch floor: the same kernel on its smallest tree, one window
        small = torch.ones(2048, dtype=torch.float32, device=device)
        one = pack([0], [2], device)
        t_floor = timed(lambda: fq.flatfat_build_query(small, one, torch.add,
                                                       0.0))
        # the least work: leaves and extents read, outputs written once;
        # n - 1 combines to build, and the walks' combines
        nbytes = 4 * n + 8 * len(starts) + 4 * len(starts)
        ops = n - 1 + walk_nodes(n, None, starts, ends)[1]
        bms, bound_by = bound_ms(nbytes, ops)
        ms, chain_ms, plain_ms, lib_ms, floor_ms = (
            d if d is not None else w
            for d, w in (t_k, t_chain, t_p, t_l, t_floor))
        log(f"[kernel K2 rebuild] {name}: device ms per call (wall ms per "
            f"call): kernel (add) {fmt(t_k)}, launch floor (n=2048, one "
            f"window) {fmt(t_floor)} = {ms / floor_ms:.2f}x it; pre-PR "
            f"chain (build_tree, query kernel, where) {fmt(t_chain)} = "
            f"{chain_ms / ms:.1f}x the kernel; plain (add) {fmt(t_p)}; sparse "
            f"mv (add) {fmt(t_l)}, max/min: no library call; bound "
            f"{bms:.4g} ms ({bound_by}; {nbytes} B, {ops} combines) ({card})")
        out = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
               "bound_by": bound_by, "library_ms": lib_ms,
               "max_abs_err": 0.0}
        del leaves, v, csr
        torch.cuda.empty_cache()
    user_entry["max_abs_err"] = tally.rows[PATH_COMBINE][2]
    out["user"] = user_entry
    return out


# ---------------------------------------------------------------------------
# 3c. the fused FlatFAT update+query kernel against its plain version
# ---------------------------------------------------------------------------

# the resident pane lane's carry: pow2(64 panes a window + 1024 headroom)
# leaves, 16 initial rows; a 65,536-event chunk brings 128 new panes for
# each of the 8 keys and fires 128 windows of 64 panes per key
PANE_N, PANE_NEW = 2048, 128


def fused_shapes(rng):
    """name -> (K, n, runs (rows, starts, lens), windows (rows, starts,
    ends)) in id space, at the resident lanes' launch shapes, a
    deployment-size forest and edges."""
    shapes = {}
    # resident FFAT lane: one 1024-leaf chunk of key 3 crossing the
    # ring's end and the 64 windows of 4096 it closes (half wrap)
    s0 = 6 * RES_N - 512
    ends = s0 + SLIDE15 * np.arange(1, RES_CHUNK // SLIDE15 + 1)
    shapes["resident"] = (RES_K, RES_N, ([3], [s0], [RES_CHUNK]),
                          (np.full(len(ends), 3), ends - WIN15, ends))
    # resident pane lane: one run of 128 panes per key, 128 windows each
    p0 = rng.integers(4 * PANE_N, 8 * PANE_N, KEYS15)
    ends = (p0[:, None] + PANE_NEW - np.arange(PANE_NEW)[None, :]).ravel()
    shapes["pane"] = (16, PANE_N, (np.arange(KEYS15), p0,
                                   np.full(KEYS15, PANE_NEW)),
                      (np.repeat(np.arange(KEYS15), PANE_NEW),
                       ends - WIN15 // PANE_SLIDE, ends))
    # deployment forest: 4096 keys x 8192 leaves (256 MiB), one 64-leaf
    # run per row (some wrap), 16 windows per row of up to 4096 leaves
    K = 4096
    r0 = rng.integers(RES_N, 8 * RES_N, K)
    ends = (np.repeat(r0 + 64, 16) - rng.integers(0, 128, 16 * K))
    shapes["deploy"] = (K, RES_N, (np.arange(K), r0, np.full(K, 64)),
                        (np.repeat(np.arange(K), 16),
                         ends - rng.integers(1, WIN15 + 1, 16 * K), ends))
    # edges: two runs on one row crossing the ring's end, an empty run,
    # a row with windows and no run, windows of 0 and of n leaves
    shapes["edges16"] = (3, 16, ([0, 0, 1], [14, 18, 5], [4, 3, 0]),
                         ([0, 0, 0, 2, 2, 1, 0], [10, 0, 20, 5, 30, 7, 16],
                          [26, 16, 20, 9, 40, 8, 21]))
    shapes["edges2"] = (2, 2, ([1], [1], [2]),
                        ([0, 1, 1, 1, 1], [0, 1, 1, 0, 3], [2, 3, 2, 0, 4]))
    return shapes


def fused_work(n: int, runs, wins, sizes, ops_per_combine: int):
    """(bytes, f32 ops) one fused step needs on these inputs: the staged
    buffer (descriptors and values) read and the output written once;
    each dirty node (new leaves and their ancestors) written once; each
    clean node the step needs read once: the children of dirty nodes
    that no run made dirty, and the nodes the walks take outside the
    dirty ones.  One combine per dirty inner node, per node a walk takes
    and per wrapping window."""
    levels = n.bit_length() - 1
    rows, starts, lens = (np.asarray(a, np.int64) for a in runs)
    which = np.repeat(np.arange(len(lens)), lens)
    idx = n + (starts[which] + np.arange(len(which))
               - np.repeat(np.cumsum(lens) - lens, lens)) % n
    base = rows[which] * 2 * n
    dirty = [base + idx]
    for _ in range(levels):
        idx = idx >> 1
        dirty.append(base + idx)
    dirty = np.unique(np.concatenate(dirty))
    parents = dirty[dirty % (2 * n) < n]  # dirty inner nodes
    row_base = parents - parents % (2 * n)
    children = np.concatenate([2 * parents - row_base,
                               2 * parents - row_base + 1])
    inner = len(parents)
    q_rows, q_s, q_e = (np.asarray(a, np.int64) for a in wins)
    s, e = q_s % n, q_s % n + np.maximum(q_e - q_s, 0)
    wrap = (q_e > q_s) & (e >= n)
    nodes, combines = walk_nodes(
        n, np.concatenate([q_rows, q_rows[wrap]]),
        np.concatenate([s, np.zeros(int(wrap.sum()), np.int64)]),
        np.concatenate([np.minimum(e, n), (e - n)[wrap]]))
    clean = np.setdiff1d(np.concatenate([children, nodes]), dirty)
    G, R, Q, V = sizes
    nbytes = 4 * (3 * G + 2 + 3 * R + 3 * Q + V) + 4 * Q \
        + 4 * len(dirty) + 4 * len(clean)
    return nbytes, (inner + combines + int(wrap.sum())) * ops_per_combine


def legacy_step(tree, comb, neutral, runs, values, wins) -> np.ndarray:
    """One resident step as the lanes paid it before the fused kernel:
    host packing into five pinned copies, run expansion, the 13-level
    torch root-path sweep and the query kernel over two pieces a
    wrapping window (the plain version's expand_runs and update_sparse,
    then K2), a blocking copy back, the pieces combined on the host."""
    from windflow_tpu_torch.ops.cuda import flatfat_query as fq
    n = tree.shape[-1] // 2

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).pin_memory().to(
            tree.device, non_blocking=True)

    rows, starts, lens = (np.asarray(a, np.int64) for a in runs)
    R, total = len(rows), int(lens.sum())
    rb = 8
    while rb < R:
        rb <<= 1
    rr = np.zeros(3 * rb, np.int32)
    rr[:R], rr[rb:rb + R], rr[2 * rb:2 * rb + R] = rows, starts % n, lens
    vb = 512
    while vb < total:
        vb <<= 1
    v = np.full(vb, neutral, np.float32)
    v[:total] = values
    k2, s2, e2, wraps, B = pieces(n, *wins)
    qd = put(np.concatenate([k2, s2, e2]))
    rd = put(rr)
    b = len(k2)
    keys, pos, valid = fq.expand_runs(rd[:rb], rd[rb:2 * rb], rd[2 * rb:],
                                      vb, n)
    fq.update_sparse(tree, keys, pos, put(v), valid, comb)
    out = fq.flatfat_query(tree, qd[:b], qd[b:2 * b], qd[2 * b:], comb,
                           neutral).cpu().numpy()
    head, tail = out[:B], out[B:2 * B]
    if not wraps.any():
        return head
    return np.where(wraps, comb(torch.from_numpy(head),
                                torch.from_numpy(tail)).numpy(), head)


def step_walls(step, reps: int):
    """(median ms by perf_counter, median ms by CUDA events) of one
    blocking step, host staging to host result."""
    for _ in range(3):
        step()
    walls, evs = [], []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        step()
        b.record()
        walls.append((time.perf_counter() - t0) * 1e3)
        b.synchronize()
        evs.append(a.elapsed_time(b))
    return float(np.median(walls)), float(np.median(evs))


def check_fused(device, card: str) -> dict:
    from windflow_tpu_torch.ops.cuda import flatfat_query as fq
    from windflow_tpu_torch.ops.flatfat_torch import (BatchedFlatFAT,
                                                      pack_step,
                                                      step_inputs)
    rng = np.random.default_rng(2)
    out = {}
    worst_err = 0.0
    tally = UserTally()
    pending = []
    for name, (K, n, runs, wins) in fused_shapes(rng).items():
        V = int(np.sum(runs[2]))
        # the user combines, each through its own generated library
        for uname, (comb, neutral, opc, trans) in user_combines().items():
            vals = combine_values(uname, rng, V)
            buf, sizes = pack_step(n, K, *runs, vals, *wins, pinned=True)
            inputs = step_inputs(buf.to(device), sizes)
            fk = forest_of(torch.from_numpy(
                combine_values(uname, rng, (K, n))).to(device), comb)
            fp = fk.clone()
            k = fq.flatfat_update_query(fk, inputs, comb, neutral)
            p = fq.flatfat_update_query_plain(fp, inputs, comb, neutral)
            torch.cuda.synchronize()
            tag = f"kernel K2 fused {name} {uname}"
            k, p = k.cpu().numpy(), p.cpu().numpy()
            tally.add(uname, *hold_user(k, p, trans, tag), k, p)
            hold_user(fk.cpu().numpy(), fp.cpu().numpy(), trans,
                      tag + " forest")
            if not name.startswith("edges"):
                # timed once every step wall is taken (the profiler
                # stays off until then); the forest is updated in place
                # by every call: the same step again
                pending.append((name, uname, fk, inputs, comb, neutral,
                                fused_work(n, runs, wins, sizes, opc)))
            del fp
        data = {}
        for integer in (True, False):
            vals = (rng.integers(0, 97, V) if integer
                    else rng.random(V)).astype(np.float32)
            buf, sizes = pack_step(n, K, *runs, vals, *wins, pinned=True)
            leaves = (rng.integers(0, 97, (K, n)) if integer
                      else rng.random((K, n))).astype(np.float32)
            data[integer] = (vals, step_inputs(buf.to(device), sizes),
                             torch.from_numpy(leaves).to(device), sizes)
        for cname, (comb, neutral, _opc) in k2_combines().items():
            for integer in ((True, False) if cname == "add" else (False,)):
                _vals, inputs, leaves, _sizes = data[integer]
                fk = forest_of(leaves, comb)
                fp = fk.clone()
                k = fq.flatfat_update_query(fk, inputs, comb, neutral)
                p = fq.flatfat_update_query_plain(fp, inputs, comb, neutral)
                torch.cuda.synchronize()
                k, p = k.cpu().numpy(), p.cpu().numpy()
                tk, tp = fk.cpu().numpy(), fp.cpu().numpy()
                if integer or cname in ("max", "min"):
                    if not (np.array_equal(k, p) and np.array_equal(tk, tp)):
                        raise AssertionError(
                            f"[kernel K2 fused] {name} {cname}: not exact, "
                            f"err {np.nanmax(np.abs(k - p), initial=0)}, "
                            f"forest err {np.nanmax(np.abs(tk - tp))}")
                else:
                    np.testing.assert_allclose(
                        k, p, rtol=RTOL_F32, atol=1e-6,
                        err_msg=f"[kernel K2 fused] {name} {cname} f32")
                    np.testing.assert_allclose(
                        tk, tp, rtol=RTOL_F32, atol=1e-6,
                        err_msg=f"[kernel K2 fused] {name} {cname} forest")
                fin = np.isfinite(p)
                if not np.array_equal(fin, np.isfinite(k)):
                    raise AssertionError(f"[kernel K2 fused] {name} "
                                         f"{cname}: non-finite results "
                                         f"differ")
                if fin.any():
                    worst_err = max(worst_err, float(
                        np.abs(k[fin] - p[fin]).max()))
                del fk, fp
        if name.startswith("edges"):
            log(f"[kernel K2 fused] {name}: K={K} n={n} exact on integers "
                f"and max/min, rtol {RTOL_F32} on f32, forests equal; user "
                f"combines bitwise (logaddexp within {ULP_BOUND} ulp), "
                f"forests too")
            continue
        # timings: add on integer data, the forest updated in place by
        # every call (the same step again: idempotent).  First one whole
        # step as the lane pays it, and the chain that ran before the
        # fused kernel, then the profiled timings
        vals, inputs, leaves, sizes = data[True]
        fk = forest_of(leaves, torch.add)
        bf = BatchedFlatFAT(torch.add, 0.0, K, n, device=device)
        bf.tree = fk
        fused_res = bf.update_runs_query(*runs, vals, *wins)
        old_res = legacy_step(fk, torch.add, 0.0, runs, vals, wins)
        if not np.array_equal(fused_res, old_res):
            raise AssertionError(f"[kernel K2 fused] {name}: the fused step "
                                 f"and the pre-fused chain differ")
        reps = 20 if name == "deploy" else 100
        new_wall = step_walls(lambda: bf.update_runs_query(*runs, vals, *wins),
                              reps)
        old_wall = step_walls(lambda: legacy_step(fk, torch.add, 0.0, runs,
                                                  vals, wins), reps)
        t_k = timed(lambda: fq.flatfat_update_query(fk, inputs, torch.add,
                                                    0.0))
        t_p = timed(lambda: fq.flatfat_update_query_plain(
            fk, inputs, torch.add, 0.0), reps=10)
        nbytes, ops = fused_work(n, runs, wins, sizes, 1)
        bms, bound_by = bound_ms(nbytes, ops)
        ms, plain_ms = (d if d is not None else w for d, w in (t_k, t_p))
        log(f"[kernel K2 fused] {name}: K={K} n={n} runs={len(runs[0])} "
            f"windows={len(wins[0])}; exact on integers and max/min, rtol "
            f"{RTOL_F32} on f32, forests equal; device ms per call (wall ms "
            f"per call): kernel {fmt(t_k)}, plain (add) {fmt(t_p)}; bound {bms:.4g} "
            f"ms ({bound_by}; {nbytes} B, {ops} combines); one step host "
            f"staging to host result, median ms (perf_counter / CUDA "
            f"events): fused {new_wall[0]:.4f} / {new_wall[1]:.4f}, "
            f"pre-fused chain {old_wall[0]:.4f} / {old_wall[1]:.4f} "
            f"({old_wall[0] / new_wall[0]:.1f}x) ({card})")
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                     "bound_by": bound_by, "library_ms": None}
        del fk, bf, data, inputs
        torch.cuda.empty_cache()
    # the launch floor: one forest row of 2048 leaves, one run of one
    # leaf, one window of two leaves
    buf, sizes = pack_step(2048, 1, [0], [5], [1], np.ones(1, np.float32),
                           [0], [4], [6], pinned=True)
    inputs = step_inputs(buf.to(device), sizes)
    f1 = forest_of(torch.zeros(1, 2048, device=device), torch.add)
    t_floor = timed(lambda: fq.flatfat_update_query(f1, inputs, torch.add,
                                                    0.0))
    floor_ms = t_floor[0] if t_floor[0] is not None else t_floor[1]
    log(f"[kernel K2 fused] launch floor (K=1, n=2048, one run of one "
        f"leaf, one window): device ms per call (wall ms per call) "
        f"{fmt(t_floor)}; the resident step is "
        f"{out['resident']['ms'] / floor_ms:.2f}x it ({card})")
    log(f"[kernel K2 fused] user combines against the plain version over "
        f"every shape: {tally.line()} ({card})")
    user_t = collections.defaultdict(list)
    for name, uname, fk, inputs, comb, neutral, work in pending:
        t_u = timed(lambda: fq.flatfat_update_query(fk, inputs, comb,
                                                    neutral))
        user_t[name].append(f"{uname} {fmt(t_u)}")
        if name == "resident" and uname == PATH_COMBINE:
            t_up = timed(lambda: fq.flatfat_update_query_plain(
                fk, inputs, comb, neutral), reps=10)
            user_entry = user_timing(t_u, t_up, work)
            user_t[name].append(f"{uname} plain {fmt(t_up)}, bound "
                                f"{user_entry['bound_ms']:.4g} ms "
                                f"({user_entry['bound_by']}; {work[0]} B, "
                                f"{work[1]} f32 ops)")
    del pending
    torch.cuda.empty_cache()
    for name, rows in user_t.items():
        log(f"[kernel K2 fused] {name}: user combines' device ms per call "
            f"(wall ms per call), beside add's {fmt_ms(out[name]['ms'])}: "
            f"{'; '.join(rows)} ({card})")
    out["max_abs_err"] = worst_err
    user_entry["max_abs_err"] = tally.rows[PATH_COMBINE][2]
    out["user"] = user_entry
    return out


# ---------------------------------------------------------------------------
# 3b. signed zeros under max and min (ROADMAP C12)
# ---------------------------------------------------------------------------

ZERO_DEVICE = "cuda"


def zero_leaves(rng, shape, kind: str, zero_rate: float,
                n_nan: int = 0) -> np.ndarray:
    """f32 values whose max (min) is often a zero of either sign: values
    that lose to a zero under ``kind`` (-1 or -2 for max, 1 or 2 for
    min), a share ``zero_rate`` of them +0 or -0 in equal measure, and
    NaN at ``n_nan`` random places."""
    v = (rng.integers(1, 3, shape) * (-1 if kind == "max" else 1)).astype(
        np.float32)
    z = rng.random(shape) < zero_rate
    v[z] = np.where(rng.random(int(z.sum())) < 0.5, np.float32(0.0),
                    np.float32(-0.0))
    if n_nan:
        v.reshape(-1)[rng.integers(0, v.size, n_nan)] = np.nan
    return v


def order_key(x) -> np.ndarray:
    """int64 keys of f32 values in XLA's order of max and min: the bits
    of a value with its sign bit clear, else minus its magnitude's bits
    minus one, so -0 sorts just below +0."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.int64)
    return np.where(b >> 31, -(b & 0x7FFFFFFF) - 1, b)


def xla_fold(x: np.ndarray, kind: str, axis: int = -1) -> np.ndarray:
    """The reference's ``jnp.max`` / ``jnp.min`` along ``axis``: NaN
    propagates, -0 orders below +0."""
    x = np.asarray(x, np.float32)
    k = order_key(x)
    idx = (k.argmax if kind == "max" else k.argmin)(axis=axis)
    out = np.take_along_axis(x, np.expand_dims(idx, axis), axis)
    return np.where(np.isnan(x).any(axis), np.float32(np.nan),
                    out.squeeze(axis)).astype(np.float32)


def xla_ranges(values: np.ndarray, starts, ends, kind: str,
               empty: float) -> np.ndarray:
    """:func:`xla_fold` over ``values[s:e]`` for each extent, ``empty``
    where ``e <= s``."""
    out = np.full(len(starts), empty, np.float32)
    for i, (s, e) in enumerate(zip(starts, ends)):
        if e > s:
            out[i] = xla_fold(values[s:e], kind, 0)
    return out


def shard_fold(x: np.ndarray, kind: str, axis: int) -> np.ndarray:
    """The reference's ``lax.pmax`` / ``lax.pmin`` over the shards on
    ``axis`` (as its host devices run it): the shards in order from the
    neutral, each taken only when strictly greater (less), so a tie
    keeps the earlier shard's zero and NaN is passed over."""
    acc = np.full(np.delete(x.shape, axis),
                  -np.inf if kind == "max" else np.inf, np.float32)
    for i in range(x.shape[axis]):
        xi = np.take(x, i, axis)
        acc = np.where(xi > acc if kind == "max" else xi < acc, xi, acc)
    return acc.astype(np.float32)


def hold_bits(got, want: np.ndarray, tag: str) -> str:
    """``got`` bit for bit ``want`` (a NaN facing a NaN); the results'
    mix of zeros and NaN as text."""
    got = np.asarray(got, np.float32)
    nan = np.isnan(want)
    bad = np.isnan(got) != nan
    bad[~nan] |= got[~nan].view(np.uint32) != want[~nan].view(np.uint32)
    if got.shape != want.shape or bad.any():
        raise AssertionError(
            f"[signed zeros] {tag}: {int(bad.sum())} of {want.size} "
            f"results differ from the reference's rule")
    zero = ~nan & (want == 0)
    return (f"{want.size} results, {int(zero.sum())} zeros "
            f"({int(np.signbit(want[zero]).sum())} of them -0), "
            f"{int(nan.sum())} NaN")


def random_extents(rng, T: int, B: int, max_w: int):
    starts = rng.integers(0, T - 1, B)
    ends = np.minimum(starts + rng.integers(0, max_w + 1, B), T)
    return starts.astype(np.int32), ends.astype(np.int32)


def zero_sparse_table(kind: str, dev) -> str:
    """The max and min kinds' sparse table through the window engine at
    Q7's launch shape (T_pad 2048, B_pad 2048), extents of 0..64."""
    from windflow_tpu_torch.ops.window_compute import WindowComputeEngine
    rng = np.random.default_rng(40)
    T, B = 2000, 1500
    vals = zero_leaves(rng, T, kind, 0.1, n_nan=2)
    starts, ends = random_extents(rng, T, B, 64)
    got = WindowComputeEngine(kind, device=dev).compute(
        {"value": vals.astype(np.float64)}, starts, ends,
        np.arange(B)).block()
    return hold_bits(got, xla_ranges(vals, starts, ends, kind, 0.0),
                     f"sparse_table {kind}")


def zero_wmr(kind: str, dev):
    """compute_wmr (``_fold``'s reduction over each stripe, then the
    reference's pmax / pmin over 'win') at [mesh wmr]'s stripes
    [64, 4, 8, 1024]; returns the line and the engine and stripes."""
    from windflow_tpu_torch.parallel.mesh import make_mesh
    from windflow_tpu_torch.parallel.sharded import ShardedWindowEngine
    rng = np.random.default_rng(41)
    stripes = zero_leaves(rng, (64, 4, 8, 1024), kind, 0.003, n_nan=8)
    eng = ShardedWindowEngine(make_mesh(8, win_axis=4, device=dev), WIN,
                              SLIDE, kind)
    x = torch.from_numpy(stripes).to(dev)
    got = eng.compute_wmr(x).cpu().numpy()
    want = shard_fold(xla_fold(stripes, kind, -1), kind, 1)
    return hold_bits(got, want, f"compute_wmr {kind}"), eng, x


def zero_pf_ring(kind: str, dev):
    """compute_pf_ring (``_fold`` over each pane, then over each
    window's panes after the ring hops) on [mesh pf3]'s 8-ring, panes
    [64, 16, 4], windows of 2 panes sliding by 1."""
    from windflow_tpu_torch.parallel.mesh import make_mesh
    from windflow_tpu_torch.parallel.sharded import ShardedWindowEngine
    rng = np.random.default_rng(42)
    panes = zero_leaves(rng, (64, 16, 4), kind, 0.2, n_nan=3)
    eng = ShardedWindowEngine(make_mesh(8, win_axis=8, device=dev), WIN,
                              SLIDE, kind)
    x = torch.from_numpy(panes).to(dev)
    got = eng.compute_pf_ring(x, SLIDE).cpu().numpy()
    partials = xla_fold(panes, kind, -1)
    P, wpp = partials.shape[1], WIN // SLIDE
    want = np.zeros((panes.shape[0], P), np.float32)
    for g in range(P - wpp + 1):
        want[:, g] = xla_fold(partials[:, g: g + wpp], kind, -1)
    return hold_bits(got, want, f"compute_pf_ring {kind}"), eng, x


def zero_carry(kind: str, dev) -> str:
    """The resident pane carry's launch (K2f with the carry's combine)
    at its lane's step: 8 keys' 512-pane runs, 256 windows of 16 panes
    a key, in one forest of 2048-pane rows."""
    from windflow_tpu_torch.ops.window_compute import ResidentPaneCarry
    rng = np.random.default_rng(43)
    K, P, Q, wpp = 8, 512, 256, 16
    carry = ResidentPaneCarry(kind, wpp, initial_keys=K, device=dev)
    panes = zero_leaves(rng, (K, P), kind, 0.05, n_nan=2)
    for k in range(K):
        carry.row_of(k)
    q_rows = np.repeat(np.arange(K), Q).astype(np.int32)
    starts = rng.integers(0, P - wpp, K * Q)
    ends = starts + rng.integers(1, wpp + 1, K * Q)
    launch = carry.launch_engine()
    with launch.launch_context():
        handle = launch.compute(
            {"run_rows": np.arange(K, dtype=np.int32),
             "run_starts": np.zeros(K, np.int64),
             "run_lens": np.full(K, P, np.int32),
             "value": panes.reshape(-1), "q_rows": q_rows},
            starts, ends, np.arange(K * Q))
    got = handle.block()
    want = np.concatenate([
        xla_ranges(panes[k], starts[q_rows == k], ends[q_rows == k], kind,
                   0.0) for k in range(K)])
    return hold_bits(got, want, f"resident pane carry {kind}")


def zero_flatfat(kind: str, dev) -> dict:
    """K2, K2f and K2r under the builtin name ``kind``: a forest query,
    an update+query step and a rebuild, each against the rule."""
    from windflow_tpu_torch.ops import minmax
    from windflow_tpu_torch.ops.cuda import flatfat_query as fq
    from windflow_tpu_torch.ops.flatfat_torch import pack_step, step_inputs
    rng = np.random.default_rng(44)
    neutral = -np.inf if kind == "max" else np.inf
    comb = minmax.maximum if kind == "max" else minmax.minimum
    lines = {}
    # K2: a forest of 4 rows of 2^14 leaves, 4096 windows of 0..256
    K, n, B = 4, 1 << 14, 4096
    leaves = zero_leaves(rng, (K, n), kind, 0.02, n_nan=2)
    rows = rng.integers(0, K, B)
    starts, ends = random_extents(rng, n, B, 256)
    forest = forest_of(torch.from_numpy(leaves).to(dev), comb)
    got = fq.flatfat_query(
        forest, *(torch.from_numpy(a.astype(np.int32)).to(dev)
                  for a in (rows, starts, ends)), kind, neutral)
    want = np.concatenate([[xla_ranges(leaves[r], [s], [e], kind,
                                       neutral)[0]]
                           for r, s, e in zip(rows, starts, ends)])
    lines["K2"] = hold_bits(got.cpu().numpy(), want, f"K2 {kind}")
    # K2f: a 1024-leaf run into each row from leaf 512, then 4096
    # windows of 0..256 over the updated rows
    vals = zero_leaves(rng, K * 1024, kind, 0.02, n_nan=1)
    runs = (np.arange(K), np.full(K, 512), np.full(K, 1024))
    buf, sizes = pack_step(n, K, *runs, vals, rows, starts, ends,
                           pinned=dev == "cuda")
    after = leaves.copy()
    after[:, 512:1536] = vals.reshape(K, 1024)
    got = fq.flatfat_update_query(forest, step_inputs(buf.to(dev), sizes),
                                  kind, neutral)
    want = np.concatenate([[xla_ranges(after[r], [s], [e], kind,
                                       neutral)[0]]
                           for r, s, e in zip(rows, starts, ends)])
    lines["K2f"] = hold_bits(got.cpu().numpy(), want, f"K2f {kind}")
    # K2r: one tree of 2^16 leaves, 4096 windows of 0..256
    n = 1 << 16
    leaves = zero_leaves(rng, n, kind, 0.02, n_nan=2)
    starts, ends = random_extents(rng, n, B, 256)
    se = torch.from_numpy(np.stack([starts, ends])).to(dev)
    got = fq.flatfat_build_query(torch.from_numpy(leaves).to(dev), se, kind,
                                 neutral)
    lines["K2r"] = hold_bits(got.cpu().numpy(),
                             xla_ranges(leaves, starts, ends, kind, 0.0),
                             f"K2r {kind}")
    return lines


def signed_zeros(card: str) -> None:
    """Phase 3b: +0/-0 and NaN through every path that folds max or min
    on the card, each held bit for bit against a numpy oracle of the
    reference's rule (``jnp``'s order, -0 below +0, NaN propagating;
    ``lax.pmax``'s shard fold over 'win' in compute_wmr).  K2, K2f and
    K2r run under the builtin names and must launch the shared library
    (no user library); the torch forms of the mesh under max are timed
    at their cells' shapes beside sum."""
    from windflow_tpu_torch.ops.cuda import flatfat_query as fq
    dev = ZERO_DEVICE
    users = dict(fq.user_launch_counts())
    before = (fq.launch_count(), fq.fused_launch_count(),
              fq.build_query_launch_count())
    forms = {}
    for kind in ("max", "min"):
        log(f"[signed zeros] sparse_table {kind}: "
            f"{zero_sparse_table(kind, dev)}; bits equal the rule")
        text, eng, x = zero_wmr(kind, dev)
        log(f"[signed zeros] compute_wmr {kind} (stripes [64, 4, 8, "
            f"1024]): {text}; bits equal the rule")
        forms[f"compute_wmr {kind}"] = (eng, x, None)
        text, eng, x = zero_pf_ring(kind, dev)
        log(f"[signed zeros] compute_pf_ring {kind} (panes [64, 16, 4], "
            f"8-ring): {text}; bits equal the rule")
        forms[f"compute_pf_ring {kind}"] = (eng, x, SLIDE)
        log(f"[signed zeros] resident pane carry {kind}: "
            f"{zero_carry(kind, dev)}; bits equal the rule")
        for entry, text in zero_flatfat(kind, dev).items():
            log(f"[signed zeros] {entry} {kind!r}: {text}; bits equal the "
                f"rule")
    after = (fq.launch_count(), fq.fused_launch_count(),
             fq.build_query_launch_count())
    # K2 once, K2f twice (the carry, the step), K2r once, a kind
    expect = (2, 4, 2) if dev == "cuda" else (0, 0, 0)
    if tuple(a - b for a, b in zip(after, before)) != expect \
            or fq.user_launch_counts() != users:
        raise AssertionError(
            f"[signed zeros] launches K2/K2f/K2r {after} from {before} "
            f"(want +{expect}), user libraries {fq.user_launch_counts()} "
            f"from {users}")
    if dev == "cuda":
        from windflow_tpu_torch.parallel.sharded import ShardedWindowEngine
        readings = []
        for name, (eng, x, pane_len) in forms.items():
            method = name.split()[0]
            args = (x,) if pane_len is None else (x, pane_len)
            summed = getattr(ShardedWindowEngine(eng.mesh, WIN, SLIDE,
                                                 "sum"), method)
            folded = getattr(eng, method)
            if pane_len is None:  # the stripes, the windows
                n_out = x.shape[0] * x.shape[2]
                ops = x.numel()
            else:  # the panes, each window's wpp partials
                n_out = x.shape[0] * x.shape[1]
                ops = x.numel() + n_out * (WIN // SLIDE)
            nbytes = 4 * (x.numel() + n_out)
            r = torch_form_reading(lambda: folded(*args), nbytes, ops)
            s = torch_form_reading(lambda: summed(*args), nbytes, ops)
            readings.append(f"{form_text(name, r)}; under sum "
                            f"{fmt(s['t'])} ms, {s['launches']:g} ops")
        log(f"[signed zeros] the mesh forms under max and min at these "
            f"shapes: {'; '.join(readings)} ({card})")


# ---------------------------------------------------------------------------
# 6. bench config 15 through both FFAT lanes
# ---------------------------------------------------------------------------

class RecordSink:
    """Per-record sink with bench.py's window latency (config 15): birth
    = emit stamp of the source chunk carrying the window's closing tuple
    (id w*slide + win - 1 of its key), emission = arrival."""

    def __init__(self, stamps, slide):
        self.stamps = stamps
        self.slide = slide
        self.lock = threading.Lock()
        self.rows = []

    def __call__(self, r):
        if r is None:
            return
        now = time.perf_counter()
        with self.lock:
            self.rows.append((r.key, r.id, r.value, now))

    def columns(self):
        a = np.array([(k, i) for k, i, _v, _t in self.rows], np.int64)
        keys, ids = (a[:, 0], a[:, 1]) if len(a) else (a, a)
        vals = np.array([v for _k, _i, v, _t in self.rows], np.float64)
        now = np.array([t for _k, _i, _v, t in self.rows])
        closing = (ids * self.slide + WIN15 - 1) * KEYS15 + keys
        chunk = np.minimum(closing // SOURCE15, len(self.stamps) - 1)
        lats = now - np.asarray(self.stamps)[chunk]
        return keys, ids, vals, lats


def run15(make_op, n_events: int, slide: int, before_run=None):
    """One config-15 graph on the card: BatchSource of the stream law
    (key = e % 8, id = ts = e // 8, value = e % 97) -> op -> Sink."""
    import windflow_tpu_torch as wf
    from windflow_tpu_torch.core.tuples import TupleBatch
    from windflow_tpu_torch.operators.basic_ops import Sink
    from windflow_tpu_torch.operators.batch_ops import BatchSource

    stamps: list = []
    state = {"i": 0}

    def source():
        i = state["i"]
        if i >= n_events:
            return None
        state["i"] = i + SOURCE15
        stamps.append(time.perf_counter())
        idx = np.arange(i, min(i + SOURCE15, n_events))
        return TupleBatch({"key": idx % KEYS15, "id": idx // KEYS15,
                           "ts": idx // KEYS15,
                           "value": (idx % VMOD).astype(np.float64)})

    sink = RecordSink(stamps, slide)
    g = wf.PipeGraph("chip_smoke15", wf.Mode.DEFAULT,
                     config=wf.RuntimeConfig(device=DEVICE15))
    g.add_source(BatchSource(source)).add(make_op()).add_sink(Sink(sink))
    if before_run is not None:
        before_run(g)
    t0 = time.perf_counter()
    g.run()
    return g, sink, time.perf_counter() - t0


def oracle15(n_events: int, slide: int):
    """(keys, ids, sums) of every window of the config-15 law, float64:
    key k holds ids 0..M-1 with value (id*8 + k) % 97; CB window w covers
    ids [w*slide, w*slide + 4096) clipped at M, for every w*slide < M
    (partial tail windows flush at EOS)."""
    M = n_events // KEYS15
    n_win = (M - 1) // slide + 1
    w = np.arange(n_win)
    keys, ids, sums = [], [], []
    for k in range(KEYS15):
        c = np.concatenate([[0], np.cumsum((np.arange(M) * KEYS15 + k)
                                           % VMOD)])
        sums.append((c[np.minimum(w * slide + WIN15, M)]
                     - c[w * slide]).astype(np.float64))
        keys.append(np.full(n_win, k))
        ids.append(w)
    return np.concatenate(keys), np.concatenate(ids), np.concatenate(sums)


def sorted_windows(sink, tag: str):
    keys, ids, vals, lats = sink.columns()
    order = np.lexsort((ids, keys))
    keys, ids, vals = keys[order], ids[order], vals[order]
    if len(keys) > 1 and np.any((np.diff(keys) == 0) & (np.diff(ids) == 0)):
        raise AssertionError(f"[{tag}] duplicate windows")
    return keys, ids, vals, lats


def hold_to_oracle(got, want, tag: str) -> None:
    keys, ids, vals = got[:3]
    if len(keys) != len(want[0]) or not (
            np.array_equal(keys, want[0]) and np.array_equal(ids, want[1])
            and np.array_equal(vals, want[2])):
        n_bad = (int((vals != want[2]).sum())
                 if len(vals) == len(want[2]) else -1)
        raise AssertionError(f"[{tag}] {len(keys)} windows vs oracle "
                             f"{len(want[0])}; {n_bad} values differ")


def bytes_per_launch(logic) -> float:
    st = logic.stats
    if st is None or not st.num_launches:
        raise AssertionError("device byte accounting missing")
    return (st.bytes_to_device + st.bytes_from_device) / st.num_launches


def ffat_lane(lane: str):
    """Config 15's operator for one FFAT lane, as bench.py builds it."""
    from windflow_tpu_torch.operators.tpu.ffat_resident import \
        WinSeqFFATResident
    from windflow_tpu_torch.operators.tpu.win_seq_tpu import WinSeqTPU
    import windflow_tpu_torch as wf
    if lane == "rebuild":
        return WinSeqTPU(("ffat", torch.add, 0.0), WIN15, SLIDE15,
                         wf.WinType.CB, batch_len=BATCH15,
                         max_buffer_elems=MAX_BUFFER, inflight_depth=INFLIGHT)
    return WinSeqFFATResident(lambda t: t.value, torch.add, 0.0, WIN15,
                              SLIDE15, wf.WinType.CB)


# (keys, ids, values) of [main15]'s resident lane, sorted by key and id
MAIN15_RESIDENT: list = []


def check_launches(tag: str, logics, kernels: dict, expect) -> int:
    """The path's launches of the kernel named ``expect`` equal the
    batches its device window engine (or engines: a list) launched, and
    every other kernel counted in ``kernels`` (name -> launches in the
    run) stayed at 0; ``expect=None``: a path that launches none of
    them (a custom window function's torch program)."""
    if not isinstance(logics, (list, tuple)):
        logics = [logics]
    want = sum(lg.launched_batches for lg in logics)
    if expect is None:
        if want <= 0 or any(kernels.values()):
            raise AssertionError(f"[{tag}] {want} batches; kernels "
                                 f"{kernels} on a path that runs none")
        return 0
    if kernels[expect] <= 0 or kernels[expect] != want:
        raise AssertionError(f"[{tag}] {expect} launches {kernels[expect]} "
                             f"!= batches launched {want}")
    for name, count in kernels.items():
        if name != expect and count:
            raise AssertionError(f"[{tag}] {name} launched {count} times "
                                 f"on a path that runs {expect}")
    return want


def reset_counts() -> None:
    from windflow_tpu_torch.ops.cuda import flatfat_query as fq
    from windflow_tpu_torch.ops.cuda import window_sum
    fq.reset_launch_count()
    fq.reset_fused_launch_count()
    fq.reset_build_query_launch_count()
    fq.reset_user_launch_counts()
    window_sum.reset_launch_count()


def read_counts() -> dict:
    from windflow_tpu_torch.ops.cuda import flatfat_query as fq
    from windflow_tpu_torch.ops.cuda import window_sum
    return {"flatfat_query": fq.launch_count(),
            "flatfat_update_query": fq.fused_launch_count(),
            "flatfat_build_query": fq.build_query_launch_count(),
            "window_sum": window_sum.launch_count()}


def reading(secs: float, got) -> str:
    p50, p99 = (float(np.percentile(got[3], q)) * 1e3 for q in (50, 99))
    return (f"{N15} events in {secs:.3f} s = {N15 / secs:.1f} tuples/s; "
            f"{len(got[0])} windows match the oracle exactly; window "
            f"latency p50 {p50:.3f} ms, p99 {p99:.3f} ms")


def main15(card: str) -> dict:
    """Config 15 through the FFAT rebuild lane (the fused build+query
    kernel per launch) and the resident FFAT lane (the fused
    update+query kernel per launch): returns each path's kernel
    launches."""
    from windflow_tpu_torch.operators.tpu.ffat_resident import \
        WinSeqFFATResidentLogic
    from windflow_tpu_torch.ops.cuda.window_sum import next_pow2

    want = oracle15(N15, SLIDE15)
    shapes = collections.Counter()

    def record_shapes(g):
        eng = find_logic(g).engine
        compute = eng.compute

        def recorded(cols, starts, ends, gwids):
            T = len(next(iter(cols.values())))
            # windows per launch shape
            shapes[(next_pow2(max(T, 2048)),
                    next_pow2(max(len(starts), 2048)))] += len(starts)
            return compute(cols, starts, ends, gwids)
        eng.compute = recorded

    lanes = {}
    for lane, cls, hook, kernel in (
            ("rebuild", None, record_shapes, "flatfat_build_query"),
            ("resident", WinSeqFFATResidentLogic, None,
             "flatfat_update_query")):
        reset_counts()
        g, sink, secs = run15(lambda: ffat_lane(lane), N15, SLIDE15, hook)
        counts = read_counts()
        logic = find_logic(g, cls)
        if logic.device is None or logic.device.type != DEVICE15:
            raise AssertionError(f"[main15] {lane} device {logic.device}")
        launches = check_launches(f"main15 {lane}", logic, counts, kernel)
        got = sorted_windows(sink, f"main15 {lane}")
        hold_to_oracle(got, want, f"main15 {lane}")
        if lane == "resident":
            # the unsplit lane's windows, which [rescale15] must equal
            MAIN15_RESIDENT[:] = got[:3]
        lanes[lane] = {"bpl": bytes_per_launch(logic), "launches": launches,
                       "state": logic.device_resident_bytes()
                       if lane == "resident" else 0}
        log(f"[main15] {lane} lane: {reading(secs, got)}; "
            f"{launches} {kernel} launches = {logic.launched_batches} "
            f"batches, other kernels 0; "
            f"{lanes[lane]['bpl']:.1f} bytes shipped per launch"
            + (f"; Device_state_bytes_resident {lanes[lane]['state']}"
               if lane == "resident" else
               f"; windows per launch shape (T_pad, B_pad): "
               f"{dict(shapes)}")
            + f" ({card})")
    if shapes.most_common(1)[0][0] != (T_PAD15, B_PAD15):
        raise AssertionError(f"[main15] rebuild launch shapes {shapes}: "
                             f"[kernel K2 rebuild] timed another shape")
    ratio = lanes["rebuild"]["bpl"] / lanes["resident"]["bpl"]
    if ratio < 10:
        raise AssertionError(f"[main15] bytes/launch ratio {ratio:.2f} < 10")
    log(f"[main15] both lanes equal window for window; shipped bytes per "
        f"launch rebuild/resident = {ratio:.1f}x")
    return {"flatfat_build_query": lanes["rebuild"]["launches"],
            "flatfat_update_query": lanes["resident"]["launches"]}


def oracle15_lse(n_events: int, slide: int, keys: int = KEYS15):
    """(keys, ids, values) of every window of the config-15 law under
    log-sum-exp, float64: 96 + log of window differences of float64
    prefix sums of exp(v - 96), v = (id*8 + k) % 97.  Every full window
    holds a 96, so its sum is >= 1 and the difference loses nothing; a
    partial tail window (fewer than 4096 ids, flushed at EOS) is summed
    directly."""
    M = n_events // keys
    n_win = (M - 1) // slide + 1
    w = np.arange(n_win)
    out_k, out_i, out_v = [], [], []
    for k in range(keys):
        x = np.exp((np.arange(M) * keys + k) % VMOD - 96.0)
        c = np.concatenate([[0.0], np.cumsum(x)])
        ends = np.minimum(w * slide + WIN15, M)
        sums = c[ends] - c[w * slide]
        for i in np.nonzero(ends - w * slide < WIN15)[0]:
            sums[i] = x[w[i] * slide:ends[i]].sum()
        out_k.append(np.full(n_win, k))
        out_i.append(w)
        out_v.append(96.0 + np.log(sums))
    return np.concatenate(out_k), np.concatenate(out_i), \
        np.concatenate(out_v)


def hold_to_oracle_rtol(got, want, tag: str, rtol: float) -> None:
    """Keys and ids exactly, values within ``rtol``."""
    keys, ids, vals = got[:3]
    if len(keys) != len(want[0]) or not (
            np.array_equal(keys, want[0]) and np.array_equal(ids, want[1])):
        raise AssertionError(f"[{tag}] {len(keys)} windows vs oracle "
                             f"{len(want[0])}: keys or ids differ")
    rel = np.abs(vals - want[2]) / np.abs(want[2])
    if not np.all(rel <= rtol):
        raise AssertionError(f"[{tag}] {int((rel > rtol).sum())} values "
                             f"outside rtol {rtol} (worst {rel.max():.3g})")


def user_ffat_op(lane: str):
    """Config 15's FFAT lane under the path's user combine, built as a
    user builds it: WinSeqFFATTPUBuilder(lift, (torch.logaddexp, -inf))
    -- with_rebuild(True) (the rebuild lane, K2r; batch, buffer and
    in-flight depth as the torch.add cell) or the CB default (the
    resident lane, K2f)."""
    import windflow_tpu_torch as wf
    comb, neutral = user_combines()[PATH_COMBINE][:2]
    b = wf.WinSeqFFATTPUBuilder(lambda t: t.value, (comb, neutral)) \
        .with_cb_windows(WIN15, SLIDE15)
    if lane == "rebuild":
        b = b.with_rebuild(True).with_batch(BATCH15) \
            .with_max_buffer(MAX_BUFFER).with_inflight(INFLIGHT)
    return b.build()


def check_user_launches(tag: str, logics, counts: dict, users: dict,
                        entry: str) -> int:
    """The path went through the user combine's generated kernel: its
    launches of ``entry`` equal the batches (steps) of its engines, and
    every launch of ``entry`` is one (no builtin FlatFAT launch), and no
    other kernel ran."""
    launches = check_launches(tag, logics, counts, entry)
    if users[entry] != launches or any(
            n for e, n in users.items() if e != entry):
        raise AssertionError(f"[{tag}] user-combine launches {users}: "
                             f"expected {launches} of {entry} and no other")
    return launches


def main15_user(card: str) -> dict:
    """Config 15's rebuild and resident FFAT cells at full size under
    the user combine torch.logaddexp (neutral -inf), through
    WinSeqFFATTPUBuilder: each window's (key, id) exactly and its value
    within rtol 1e-5 of the float64 closed form, the two lanes within the
    same tolerance of each other, every FlatFAT launch one of the
    generated library's -- equal to the batches (K2r) or steps (K2f).
    Returns each kernel's user launches."""
    from windflow_tpu_torch.operators.tpu.ffat_resident import \
        WinSeqFFATResidentLogic
    from windflow_tpu_torch.ops.cuda import flatfat_query as fq

    want = oracle15_lse(N15, SLIDE15)
    got, out = {}, {}
    for lane, cls, entry in (
            ("rebuild", None, "flatfat_build_query"),
            ("resident", WinSeqFFATResidentLogic, "flatfat_update_query")):
        tag = f"main15 {lane} {PATH_COMBINE}"
        reset_counts()
        g, sink, secs = run15(lambda: user_ffat_op(lane), N15, SLIDE15)
        counts, users = read_counts(), fq.user_launch_counts()
        logic = find_logic(g, cls)
        if logic.device is None or logic.device.type != DEVICE15:
            raise AssertionError(f"[{tag}] device {logic.device}")
        out[entry] = check_user_launches(tag, logic, counts, users, entry)
        got[lane] = sorted_windows(sink, tag)
        hold_to_oracle_rtol(got[lane], want, tag, RTOL_F32)
        p50, p99 = (float(np.percentile(got[lane][3], q)) * 1e3
                    for q in (50, 99))
        log(f"[main15 {PATH_COMBINE}] {lane} lane "
            f"(WinSeqFFATTPUBuilder, {type(logic).__name__}): {N15} events "
            f"in {secs:.3f} s = {N15 / secs:.1f} tuples/s; "
            f"{len(got[lane][0])} windows, keys and ids exact, values "
            f"within rtol {RTOL_F32} of the float64 closed form; window "
            f"latency p50 {p50:.3f} ms, p99 {p99:.3f} ms; {out[entry]} "
            f"{entry} launches of the generated library = "
            f"{logic.launched_batches} batches, builtin FlatFAT launches 0 "
            f"({card})")
    a, b = got["rebuild"][2], got["resident"][2]
    if not np.allclose(a, b, rtol=RTOL_F32, atol=0):
        raise AssertionError(f"[main15 {PATH_COMBINE}] lanes differ "
                             f"beyond rtol {RTOL_F32}")
    log(f"[main15 {PATH_COMBINE}] rebuild and resident lanes within rtol "
        f"{RTOL_F32} of each other (bitwise equal: "
        f"{bool(np.array_equal(a, b))})")
    return out


# KeyFFATTPUBuilder at parallelism 2 as two replicas: a cut of config
# 15's stream (1/64 of its events: the two replicas ran 1M events at 89k
# tuples/s on the H100, 11 s), so the cell adds seconds to the script
N15_KEYFFAT = N15 // 64
# [profile15]'s events
N15_PROFILE = N15 // 4


def key_ffat_user(card: str) -> int:
    """KeyFFATTPUBuilder(lift, (torch.logaddexp, -inf)) at parallelism 2
    with coalesce=False: two replicas, each its own engine and stream,
    sharing one build of the generated library; held to the closed form
    as main15_user; every launch the generated build+query kernel's.
    Returns its launches."""
    import windflow_tpu_torch as wf
    from windflow_tpu_torch.ops.cuda import flatfat_query as fq
    comb, neutral = user_combines()[PATH_COMBINE][:2]
    tag = f"key_ffat {PATH_COMBINE}"

    def make():
        return wf.KeyFFATTPUBuilder(lambda t: t.value, (comb, neutral)) \
            .with_parallelism(2).with_coalesce(False) \
            .with_cb_windows(WIN15, SLIDE15).with_batch(BATCH15) \
            .with_max_buffer(MAX_BUFFER).build()

    reset_counts()
    g, sink, secs = run15(make, N15_KEYFFAT, SLIDE15)
    counts, users = read_counts(), fq.user_launch_counts()
    logics = device_logics(g)
    if len(logics) != 2:
        raise AssertionError(f"[{tag}] {len(logics)} engines, not 2")
    libs = {lg.engine._ffat_combine.lib._handle for lg in logics}
    if len(libs) != 1:
        raise AssertionError(f"[{tag}] replicas load {len(libs)} libraries")
    launches = check_user_launches(tag, logics, counts, users,
                                   "flatfat_build_query")
    got = sorted_windows(sink, tag)
    hold_to_oracle_rtol(got, oracle15_lse(N15_KEYFFAT, SLIDE15), tag,
                        RTOL_F32)
    log(f"[{tag}] KeyFFATTPUBuilder parallelism 2, coalesce=False, "
        f"{N15_KEYFFAT} events (config 15's stream cut 64x): {secs:.3f} s = "
        f"{N15_KEYFFAT / secs:.1f} tuples/s; {len(got[0])} windows held as "
        f"[main15 {PATH_COMBINE}]; two replicas, one library; {launches} "
        f"generated build+query launches = batches of both replicas "
        f"({card})")
    return launches


def resident_pane(card: str) -> int:
    """WinSeqTPU sum over panes of 64 on the config-15 stream: promoted
    onto the resident pane lane (the fused kernel per launch) by the
    planner, against resident=False (K1 per launch).  Returns the fused
    kernel's launches."""
    from windflow_tpu_torch.operators.tpu.win_seq_tpu import WinSeqTPU
    import windflow_tpu_torch as wf

    want = oracle15(N15, PANE_SLIDE)
    got = {}
    fused = 0
    for resident in (None, False):
        reset_counts()
        g, sink, secs = run15(lambda: WinSeqTPU(
            "sum", WIN15, PANE_SLIDE, wf.WinType.CB, placement="device",
            value_of=lambda t: t.value, resident=resident), N15, PANE_SLIDE)
        counts = read_counts()
        logic = find_logic(g)
        entry = g.placements[0]
        tag = "resident" if resident is None else "rebuild"
        if bool(entry.get("resident")) != (resident is None):
            raise AssertionError(f"[resident pane] {tag}: placement {entry}")
        kernel = "flatfat_update_query" if resident is None else "window_sum"
        launches = check_launches(f"resident pane {tag}", logic, counts,
                                  kernel)
        if resident is None:
            fused = launches
        got[tag] = sorted_windows(sink, f"resident pane {tag}")
        hold_to_oracle(got[tag], want, f"resident pane {tag}")
        log(f"[resident pane] {tag} lane: "
            f"{reading(secs, got[tag])}; {launches} "
            f"{kernel} launches = {logic.launched_batches} batches, other "
            f"kernels 0; {bytes_per_launch(logic):.1f} bytes per launch; "
            f"Device_state_bytes_resident {logic.device_resident_bytes()} "
            f"({card})")
    if not all(np.array_equal(a, b) for a, b in zip(got["resident"][:3],
                                                     got["rebuild"][:3])):
        raise AssertionError("[resident pane] lanes differ")
    log("[resident pane] resident and rebuild lanes bitwise equal")
    return fused


def profile15(card: str, lane: str, n_events: int) -> None:
    """One FFAT lane of config 15 once more under torch.profiler (CUDA
    activity only): device busy and idle share, top device ops.  The
    rebuild lane must show one kernel, the fused build+query kernel;
    the rest is copies."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        g, sink, secs = run15(lambda: ffat_lane(lane), n_events, SLIDE15)
    hold_to_oracle(sorted_windows(sink, "profile15"),
                   oracle15(n_events, SLIDE15), "profile15")
    extra = ""
    if lane == "rebuild":
        kernels = {e.key: e.count for e in prof.key_averages()
                   if getattr(e, "self_device_time_total", 0) > 0
                   and not e.key.startswith(("Memcpy", "Memset"))}
        if not kernels or any("flatfat_build_query_kernel" not in k
                              for k in kernels):
            raise AssertionError(f"[profile15] rebuild lane kernels "
                                 f"{kernels}: not one fused kernel")
        extra = (f"; kernels traced: {sum(kernels.values())} fused "
                 f"build+query for {find_logic(g).launched_batches} "
                 f"launched batches, no other kernel")
    log(f"[profile15] {lane} lane, {n_events} events, under the profiler: "
        f"{profile_summary(prof, secs, 8)}{extra} ({card})")


def drive_flatfat(card: str) -> int:
    """The single-tree FlatFAT a user builds, updates and queries
    (FlatFATTorch, the twin of the reference's FlatFATJax), the one
    path that launches the query-only kernel: a tree of T_PAD15 leaves,
    the rebuild lane's 4096 windows, then 1024 leaves updated and the
    windows again.  Every window against a float64 prefix sum; returns
    the query kernel's launches."""
    from windflow_tpu_torch.ops.flatfat_torch import FlatFATTorch
    rng = np.random.default_rng(4)
    leaves = rng.integers(0, 97, T_PAD15).astype(np.float32)
    starts, ends = k2_shapes(rng)["rebuild"][3:]
    ft = FlatFATTorch(torch.add, 0.0, T_PAD15, device=DEVICE15)
    reset_counts()
    ft.build(leaves)
    got = [ft.query_ranges(starts, ends)]
    want = [float64_sums(leaves, starts, ends)]
    pos = rng.choice(T_PAD15, 1024, replace=False)
    leaves[pos] = rng.integers(0, 97, 1024)
    ft.update(pos, leaves[pos])
    got.append(ft.query_ranges(starts, ends))
    want.append(float64_sums(leaves, starts, ends))
    torch.cuda.synchronize()
    counts = read_counts()
    if counts["flatfat_query"] != 2 or sum(counts.values()) != 2:
        raise AssertionError(f"[flatfat] launches {counts}: expected two "
                             f"query kernel launches and nothing else")
    if not all(np.array_equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("[flatfat] windows differ from the float64 sum")
    log(f"[flatfat] FlatFATTorch: build, {len(starts)} windows, 1024 leaves "
        f"updated, the windows again, exact against the float64 sum; "
        f"{counts['flatfat_query']} query kernel launches, other kernels 0 "
        f"({card})")
    return counts["flatfat_query"]


def drive_flatfat_user(card: str) -> int:
    """FlatFATTorch under the path's user combine (torch.logaddexp,
    neutral -inf), as drive_flatfat: the same build, windows, update and
    windows again, each window within rtol 1e-5 of a float64
    log-sum-exp; two launches of the generated query kernel and nothing
    else.  Returns them."""
    from windflow_tpu_torch.ops.cuda import flatfat_query as fq
    from windflow_tpu_torch.ops.flatfat_torch import FlatFATTorch
    comb, neutral = user_combines()[PATH_COMBINE][:2]
    rng = np.random.default_rng(5)
    leaves = (rng.random(T_PAD15) * 20).astype(np.float32)
    starts, ends = k2_shapes(rng)["rebuild"][3:]
    ft = FlatFATTorch(comb, neutral, T_PAD15, device=DEVICE15)

    def lse(v):
        c = np.concatenate([[0.0], np.cumsum(np.exp(v.astype(np.float64)
                                                    - 20.0))])
        return 20.0 + np.log(c[ends] - c[starts])

    reset_counts()
    ft.build(leaves)
    got = [ft.query_ranges(starts, ends)]
    want = [lse(leaves)]
    pos = rng.choice(T_PAD15, 1024, replace=False)
    leaves[pos] = (rng.random(1024) * 20).astype(np.float32)
    ft.update(pos, leaves[pos])
    got.append(ft.query_ranges(starts, ends))
    want.append(lse(leaves))
    torch.cuda.synchronize()
    counts, users = read_counts(), fq.user_launch_counts()
    if counts["flatfat_query"] != 2 or sum(counts.values()) != 2 \
            or users["flatfat_query"] != 2:
        raise AssertionError(f"[flatfat {PATH_COMBINE}] launches {counts}, "
                             f"user {users}: expected two generated query "
                             f"kernel launches and nothing else")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL_F32, atol=0,
                                   err_msg=f"[flatfat {PATH_COMBINE}]")
    log(f"[flatfat {PATH_COMBINE}] FlatFATTorch(torch.logaddexp, -inf): "
        f"the same steps, every window within rtol {RTOL_F32} of the "
        f"float64 log-sum-exp; {users['flatfat_query']} launches of the "
        f"generated query kernel, other kernels 0 ({card})")
    return users["flatfat_query"]


# ---------------------------------------------------------------------------
# 10. the application models: bench configs 5 and 6
# ---------------------------------------------------------------------------

# bench.py config 5 (run_yahoo, bench.py:553-567, run at :2440) and
# config 6 (run_nexmark, :579-610, run at :2446-2460), at the bench's size
N_MODEL = 16_000_000
N_MODEL_WARM = 2_000_000      # bench.py:2453's per-query warm-up
N_STEP_MODELS = 2_000_000
YAHOO_WIN = 1 << 20
YAHOO_ADS, YAHOO_CAMPAIGNS = 1000, 100
NEX_BATCH = 4 * DEVICE_BATCH  # bench.py:597
N_AUCTIONS = 1000
Q5_WIN, Q5_SLIDE = 1 << 18, 1 << 17
Q7_WIN = 1 << 13
# query -> (window, slide) of its one window stage
MODEL_WINDOWS = {"yahoo": (YAHOO_WIN, YAHOO_WIN), "q5": (Q5_WIN, Q5_SLIDE),
                 "q7": (Q7_WIN, Q7_WIN)}
# the models' device (the CPU only to rehearse the phases without a card)
MODELS_DEVICE = "cuda"


def stamp_source(g, stamps: list) -> None:
    """Record when each batch leaves the graph's one batch source (the
    head of a chain where the model chains its stages to it)."""
    from windflow_tpu_torch.operators.batch_ops import BatchSourceLogic
    from windflow_tpu_torch.runtime.node import ChainedLogic
    heads = [n.logic for n in g._all_nodes()]
    while any(isinstance(h, ChainedLogic) for h in heads):
        heads = [h.a if isinstance(h, ChainedLogic) else h for h in heads]
    (logic,) = [h for h in heads if isinstance(h, BatchSourceLogic)]
    fn = logic.user_fn

    def stamped():
        batch = fn()
        if batch is not None:
            stamps.append(time.perf_counter())
        return batch

    logic.user_fn = stamped


def run_model(query: str, n: int, opt_level=None, device_step: bool = True,
              placement: str = "device"):
    """One model through the port's own builder, as bench.py runs it:
    Yahoo (build_pipeline), Q5 (build_q5_hot_items) or Q7
    (build_q7_highest_bid).  Returns (graph, sink, seconds)."""
    import windflow_tpu_torch as wf
    from windflow_tpu_torch.models import nexmark, yahoo
    cfg = wf.RuntimeConfig(device=MODELS_DEVICE, device_step=device_step)
    if opt_level is not None:
        cfg.opt_level = opt_level
    g = wf.PipeGraph(f"chip_smoke_{query}", wf.Mode.DEFAULT, config=cfg)
    stamps: list = []
    win, slide = MODEL_WINDOWS[query]
    # the models' timestamps are the event index
    sink = LatencySink(stamps,
                       closing=lambda ids, _keys: ids * slide + win - 1)
    if query == "yahoo":
        yahoo.build_pipeline(g, n, n_ads=YAHOO_ADS,
                             n_campaigns=YAHOO_CAMPAIGNS, win_len=YAHOO_WIN,
                             slide_len=YAHOO_WIN, batch_size=SOURCE_BATCH,
                             device_batch=DEVICE_BATCH, sink=sink,
                             placement=placement)
    elif query == "q5":
        nexmark.build_q5_hot_items(g, n, Q5_WIN, Q5_SLIDE, sink,
                                   n_auctions=N_AUCTIONS,
                                   batch_size=SOURCE_BATCH,
                                   device_batch=NEX_BATCH,
                                   inflight_depth=INFLIGHT,
                                   placement=placement)
    else:
        nexmark.build_q7_highest_bid(g, n, Q7_WIN, sink,
                                     n_auctions=N_AUCTIONS,
                                     batch_size=SOURCE_BATCH,
                                     device_batch=NEX_BATCH,
                                     inflight_depth=INFLIGHT,
                                     placement=placement)
    stamp_source(g, stamps)
    t0 = time.perf_counter()
    g.run()
    return g, sink, time.perf_counter() - t0


def pool_column(col: np.ndarray, n: int) -> np.ndarray:
    """A pool column as the models' sources emit it: the pool's first
    min(batch, n - i) entries at every batch start i."""
    return np.concatenate([col[:min(SOURCE_BATCH, n - i)]
                           for i in range(0, n, SOURCE_BATCH)])


def count_windows(keys: np.ndarray, ts: np.ndarray, win: int, slide: int):
    """(keys, ids, counts) of TB windows, sorted by key then id: pane
    counts bincount(key * P + ts // slide), summed over win // slide
    panes, for every window of a key up to its last timestamp."""
    r = win // slide
    assert r * slide == win
    n_keys, P = int(keys.max()) + 1, int(ts.max()) // slide + 1
    panes = np.bincount(keys * P + ts // slide,
                        minlength=n_keys * P).reshape(n_keys, P)
    c = np.concatenate([np.zeros((n_keys, 1), np.int64),
                        np.cumsum(panes, axis=1)], axis=1)
    w = np.arange(P)
    wins = c[:, np.minimum(w + r, P)] - c[:, w]
    seen = panes > 0
    last = P - 1 - np.argmax(seen[:, ::-1], axis=1)
    mask = (w[None, :] <= last[:, None]) & seen.any(axis=1)[:, None]
    k, i = np.nonzero(mask)
    return k, i, wins[mask].astype(np.float64)


def model_oracle(query: str, n: int):
    """numpy oracle of a model's windows, (keys, ids, values) sorted by
    key then id: Yahoo's view counts per (campaign, window) and Q5's bid
    counts per (auction, window) exactly; Q7's per-window max as float32
    of the float64 max (rounding to f32 is monotone, so the max of the
    rounded prices is the rounding of the max)."""
    from windflow_tpu_torch.models import nexmark, yahoo
    ts = np.arange(n, dtype=np.int64)
    if query == "yahoo":
        pool = yahoo.synth_events(SOURCE_BATCH, YAHOO_ADS, seed=0)
        campaign = yahoo.make_campaign_map(YAHOO_ADS, YAHOO_CAMPAIGNS)
        view = pool_column(pool["event_type"], n) == yahoo.VIEW
        return count_windows(campaign[pool_column(pool["ad_id"], n)][view],
                             ts[view], YAHOO_WIN, YAHOO_WIN)
    pool = nexmark.synth_bids(SOURCE_BATCH, N_AUCTIONS)
    if query == "q5":
        return count_windows(pool_column(pool["auction"], n), ts, Q5_WIN,
                             Q5_SLIDE)
    prices = pool_column(pool["price"], n) * nexmark.DOL_TO_EUR
    starts = np.arange(0, n, Q7_WIN)
    best = np.maximum.reduceat(prices, starts).astype(np.float32)
    return (np.zeros(len(starts), np.int64), np.arange(len(starts)),
            best.astype(np.float64))


def bitwise(a, b, tag: str) -> None:
    if not all(np.array_equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"[{tag}] results differ")


def step_info(g) -> tuple:
    """(ingest chunks, launches) summed over the graph's device-step
    nodes, and how many there are."""
    from windflow_tpu_torch.graph.device_step import DeviceStepLogic
    steps = [n.logic for n in g._all_nodes()
             if isinstance(n.logic, DeviceStepLogic)]
    return (sum(s.chunks_in for s in steps),
            sum(s.chunk_launches for s in steps), len(steps))


def model_cell(tag: str, query: str, n: int, card: str, want=None, **kw):
    """One model cell on the card, every kernel count set to 0 just
    before and read just after: the windows held to the oracle, the
    device engines on CUDA (device placement) and their kernel launches.
    Count windows sum their per-pane counts, as the reference's do
    (windflow_tpu/operators/tpu/win_seq_tpu.py:1029-1033): the
    window-sum kernel, once a batch; max folds through its torch program
    and launches no hand kernel; the host lane launches nothing.
    Returns (graph, sorted rows, tuples/s, p50 ms, p99 ms, window-sum
    launches, None on the host lane)."""
    reset_counts()
    g, sink, secs = run_model(query, n, **kw)
    counts = read_counts()
    on_device = [lg for lg in device_logics(g)
                 if lg.resolved_placement != "host"]
    if kw.get("placement", "device") == "device" and (
            not on_device or any(lg.device is None
                                 or lg.device.type != MODELS_DEVICE
                                 for lg in on_device)):
        raise AssertionError(f"[{tag}] device engines "
                             f"{[str(lg.device) for lg in on_device]}")
    if on_device:
        launches = check_launches(tag, on_device, counts,
                                  None if query == "q7" else "window_sum")
    elif any(counts.values()):
        raise AssertionError(f"[{tag}] kernels {counts} on the host lane")
    else:
        launches = None
    rows = check_windows(sink, want if want is not None
                         else model_oracle(query, n), tag)
    p50, p99 = (float(np.percentile(sink.lats, q)) * 1e3 for q in (50, 99))
    return g, rows, n / secs, p50, p99, launches


def cell_line(n: int, rate: float, p50: float, p99: float, rows) -> str:
    return (f"{n} events at {rate:.1f} tuples/s; {len(rows[0])} windows "
            f"equal to the numpy oracle exactly; window latency p50 "
            f"{p50:.3f} ms, p99 {p99:.3f} ms")


def native_baseline(query: str, n: int) -> float:
    """The native record-plane twin of a model (bench.py:615-686, the
    port's NativeRecordPipeline): the same stream and windows through
    the reference-architecture C++ engine (thread-per-stage, SPSC
    rings), the models' filter/join/map applied as feed-side numpy.
    Returns tuples/s."""
    from windflow_tpu_torch.models import nexmark, yahoo
    from windflow_tpu_torch.runtime.native import NativeRecordPipeline
    rp = NativeRecordPipeline("threaded", 1)
    win, slide = MODEL_WINDOWS[query]
    rp.add_window(win, slide, True, "max" if query == "q7" else "count")
    rp.set_feed()
    if query == "yahoo":
        pool = yahoo.synth_events(SOURCE_BATCH, YAHOO_ADS, seed=0)
        campaign = yahoo.make_campaign_map(YAHOO_ADS, YAHOO_CAMPAIGNS)
    else:
        pool = nexmark.synth_bids(SOURCE_BATCH, N_AUCTIONS, 7)
    ones = np.ones(SOURCE_BATCH, np.float64)
    zeros = np.zeros(SOURCE_BATCH, np.int64)
    t0 = time.perf_counter()
    rp.start()
    sent = 0
    while sent < n:
        m = min(SOURCE_BATCH, n - sent)
        ts = sent + pool["ts"][:m]
        if query == "yahoo":
            view = pool["event_type"][:m] == yahoo.VIEW
            ts = ts[view]
            rp.feed(campaign[pool["ad_id"][:m][view]], ts, ts,
                    ones[:len(ts)])
        elif query == "q5":
            rp.feed(pool["auction"][:m], ts, ts, ones[:m])
        else:
            rp.feed(zeros[:m], ts, ts, pool["price"][:m] * nexmark.DOL_TO_EUR)
        sent += m
    rp.feed_eos()
    rp.wait()
    return n / (time.perf_counter() - t0)


def kernel_note(query: str, launches) -> str:
    return ("the host lane: no kernel launched" if launches is None else
            "no hand kernel launched (max: a torch program)"
            if query == "q7" else
            f"{launches} window-sum kernel launches = the batches, other "
            f"kernels 0")


def main5(card: str) -> int:
    """[main5] bench config 5, Yahoo: a warm-up at 2M events (bench.py
    runs config 5 in a process the configs before it warmed), then 16M
    events with the device step on (the default) and off, bitwise equal
    and exact; the native twin.  Returns the window-sum kernel's
    launches."""
    k1 = model_cell("main5 warm-up", "yahoo", N_MODEL_WARM, card)[-1]
    want = model_oracle("yahoo", N_MODEL)
    g, rows, rate, p50, p99, n_k1 = model_cell("main5", "yahoo", N_MODEL,
                                               card, want)
    k1 += n_k1
    chunks, launches, _n = step_info(g)
    _g, rows_off, rate_off, p50_off, p99_off, k1_off = model_cell(
        "main5 step off", "yahoo", N_MODEL, card, want, device_step=False)
    bitwise(rows, rows_off, "main5 step on/off")
    base = native_baseline("yahoo", N_MODEL)
    log(f"[main5] Yahoo (config 5): {cell_line(N_MODEL, rate, p50, p99, rows)}"
        f"; {kernel_note('yahoo', n_k1)}; device step: {chunks} chunks, "
        f"{launches} launches; step off: {rate_off:.1f} tuples/s, p50 "
        f"{p50_off:.3f} ms, p99 {p99_off:.3f} ms, bitwise equal, {k1_off} "
        f"window-sum launches; native record-plane twin {base:.1f} "
        f"tuples/s, vs_baseline {rate / base:.3f} ({card})")
    return k1 + k1_off


def main6(query: str, card: str):
    """[main6 q5] / [main6 q7] bench config 6's query: warm-up at 2M,
    LEVEL0 and LEVEL2 at 16M (fused_delta), the native twin; for Q5
    also placement host and auto.  Returns (the window-sum kernel's
    launches, the LEVEL2 run's window engine)."""
    import windflow_tpu_torch as wf
    tag = f"main6 {query}"
    k1 = model_cell(f"{tag} warm-up", query, N_MODEL_WARM, card)[-1]
    want = model_oracle(query, N_MODEL)
    rates = {}
    for level in ("LEVEL0", "LEVEL2"):
        g, rows, rates[level], p50, p99, n_k1 = model_cell(
            f"{tag} {level}", query, N_MODEL, card, want,
            opt_level=getattr(wf.OptLevel, level))
        k1 += n_k1
        line = cell_line(N_MODEL, rates[level], p50, p99, rows)
        log(f"[{tag}] {level}: {line}"
            f"{' (float32 of the float64 max)' if query == 'q7' else ''}; "
            f"{kernel_note(query, n_k1)} ({card})")
    engine = find_logic(g)
    base = native_baseline(query, N_MODEL)
    log(f"[{tag}] fused_delta (LEVEL2 / LEVEL0) "
        f"{rates['LEVEL2'] / rates['LEVEL0']:.3f}; native record-plane "
        f"twin {base:.1f} tuples/s, vs_baseline "
        f"{rates['LEVEL2'] / base:.3f} ({card})")
    for placement in (("host", "auto") if query == "q5" else ()):
        g, rows, rate, p50, p99, n_k1 = model_cell(
            f"{tag} {placement}", query, N_MODEL, card, want,
            placement=placement)
        k1 += n_k1 or 0
        lanes = [{k: p[k] for k in ("placement", "reason", "device_rate_tps",
                                    "host_rate_tps", "rtt_floor_ms")
                  if k in p} for p in g.placements]
        log(f"[{tag}] placement={placement}: "
            f"{cell_line(N_MODEL, rate, p50, p99, rows)}; the planner "
            f"placed {json.dumps(lanes)}; {kernel_note(query, n_k1)} "
            f"({card})")
    return k1, engine


def step_models(card: str) -> int:
    """[step models] Q5, Q7 and Yahoo at 2M events: the device step on
    and off bitwise equal (and exact), at most 2 launches per ingest
    chunk.  Returns the window-sum kernel's launches."""
    k1 = 0
    for query in ("q5", "q7", "yahoo"):
        want = model_oracle(query, N_STEP_MODELS)
        g, rows, *_, n_on = model_cell(f"step models {query}", query,
                                       N_STEP_MODELS, card, want)
        _g, rows_off, *_, n_off = model_cell(
            f"step models {query} off", query, N_STEP_MODELS, card, want,
            device_step=False)
        k1 += n_on + n_off
        bitwise(rows, rows_off, f"step models {query}")
        chunks, launches, n_steps = step_info(g)
        if n_steps != 1 or chunks <= 0 or launches > 2 * chunks:
            raise AssertionError(f"[step models {query}] {n_steps} step "
                                 f"nodes, {chunks} chunks, {launches} "
                                 f"launches")
        log(f"[step models] {query}: {N_STEP_MODELS} events, step on and "
            f"off bitwise equal and exact ({len(rows[0])} windows); "
            f"{chunks} chunks, {launches} launches = "
            f"{launches / chunks:.3f} a chunk (<= 2); step on: "
            f"{kernel_note(query, n_on)} ({card})")
    return k1


def sparse_table_reading(logic, card: str) -> None:
    """[sparse_table] the max kind's torch program at Q7's launch shape
    (the padded shape the LEVEL2 run launched most, with the mean
    values and windows of its launches there, the windows laid end to
    end as the tumbling windows are): torch.profiler's device time,
    the bound, and torch.segment_reduce over the same windows."""
    from windflow_tpu_torch.models import nexmark
    from windflow_tpu_torch.ops.window_compute import _sparse_table
    (T_pad, B_pad), (n_launch, T, B) = max(
        logic.engine.launch_shapes.items(), key=lambda kv: kv[1][0])
    T, B = -(-T // n_launch), -(-B // n_launch)   # the mean launch
    n_levels = max(1, int(np.log2(T_pad)) + 1)
    prices = nexmark.synth_bids(T, N_AUCTIONS)["price"] * nexmark.DOL_TO_EUR
    values = torch.full((T_pad,), float("-inf"), device=MODELS_DEVICE)
    values[:T] = torch.from_numpy(prices.astype(np.float32))
    bounds = np.linspace(0, T, B + 1).astype(np.int64)
    se = np.zeros((2, B_pad), np.int32)
    se[0, :B], se[1, :B] = bounds[:-1], bounds[1:]
    se = torch.from_numpy(se).to(MODELS_DEVICE)
    lengths = torch.from_numpy(np.diff(bounds)).to(MODELS_DEVICE)
    t_k = timed(lambda: _sparse_table(values, se, "max", n_levels))
    t_lib = timed(lambda: torch.segment_reduce(values[:T], "max",
                                               lengths=lengths))
    got = _sparse_table(values, se, "max", n_levels)[:B].cpu().numpy()
    lib = torch.segment_reduce(values[:T], "max",
                               lengths=lengths).cpu().numpy()
    want = np.maximum.reduceat(prices, bounds[:-1]).astype(np.float32)
    if not (np.array_equal(got, want) and np.array_equal(lib, want)):
        raise AssertionError("[sparse_table] window maxima differ")
    # the program's n_levels sweeps, each level read and written once,
    # with the extents and the output; and the function's own bytes
    sweeps = bound_ms(8 * n_levels * T_pad + 12 * B_pad, n_levels * T_pad)
    func = bound_ms(4 * T + 12 * B, T)
    log(f"[sparse_table] _sparse_table('max') at Q7's launch shape T_pad "
        f"{T_pad}, B_pad {B_pad} ({T} values, {B} windows end to end, "
        f"{n_levels} levels; {n_launch} of the LEVEL2 run's "
        f"{logic.launched_batches} launches): device {fmt(t_k)} ms "
        f"(device (wall)); bound of its sweeps {sweeps[0]:.4g} ms "
        f"({sweeps[1]}), of the function {func[0]:.4g} ms ({func[1]}); "
        f"torch.segment_reduce {fmt(t_lib)} ms; all three equal to the "
        f"float32 of the float64 max ({card})")


def profile_model(query: str, card: str) -> None:
    """A model at 16M events once more under torch.profiler (CUDA
    activity only): the device's busy and idle share and its top device
    ops; every window held against the oracle again."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        _g, sink, secs = run_model(query, N_MODEL)
    check_windows(sink, model_oracle(query, N_MODEL), f"profile {query}")
    log(f"[profile {query}] {N_MODEL} events under the profiler: "
        f"{profile_summary(prof, secs, 6)} ({card})")


def main_models(card: str) -> int:
    """Bench configs 5 and 6 and the device step on the models' graphs;
    returns the window-sum kernel's launches on their paths."""
    k1 = main5(card)
    k1 += main6("q5", card)[0]
    k1_q7, q7_engine = main6("q7", card)
    k1 += k1_q7 + step_models(card)
    sparse_table_reading(q7_engine, card)
    for query in ("yahoo", "q5", "q7"):
        profile_model(query, card)
    return k1


# ---------------------------------------------------------------------------
# 11. the durability plane on the card: exactly-once epochs, checkpoints
#     and tiered keyed state (bench configs 11, 16, 17; config 15's
#     resident lane and the device step crash-restarted)
# ---------------------------------------------------------------------------

# bench.py runs config 11 at N_EVENTS // 4 (bench.py:2515)
N11 = 16_000_000
# bench.py:1318-1328: the epoch cadence calibrated to the run's length
EPOCH_S11 = 1.0
EPOCH_FLOOR_S = 0.02
# the crash cells' sources drive their own epochs at these chunk indices
# (each waits for its commit), so a crash at epoch 2 always restores 1
CRASH_EPOCHS = (4, 8)
RESIDENT_EPOCHS = (32, 64)
COMMIT_WAIT_S = 120.0
DURABLE_DEVICE = "cuda"


def template_source(n_events: int):
    """bench.py's ``_template_source`` (:93-125) at SOURCE_PARALLELISM 1:
    key round-robin over 64, per-key dense ids, the f32 value pool of
    ``default_rng(0)``."""
    from windflow_tpu_torch.core.tuples import TupleBatch
    sb = SOURCE_BATCH
    arange = np.arange(sb, dtype=np.int64)
    keys_t, ids_t = arange % N_KEYS, arange // N_KEYS
    pool = np.random.default_rng(0).random(sb).astype(np.float32)
    state = {"sent": 0}

    def source(ctx):
        i = state["sent"]
        if i >= n_events:
            return None
        n = min(sb, n_events - i)
        ids = ids_t[:n] + (i // N_KEYS)
        state["sent"] = i + n
        return TupleBatch({"key": keys_t[:n], "id": ids, "ts": ids,
                           "value": pool[:n]})

    return source


def durable_source(n_events: int, chunk: int, n_keys: int,
                   epochs_at=(), name="durable_source"):
    """An offset-checkpointable chunk source of the headline's integer
    law (key = e % n_keys, id = ts = e // n_keys, value = e % 97): one
    TupleBatch of ``chunk`` events a step, its offset in ``state_dict``
    so a restore rewinds it.  At each chunk index in ``epochs_at`` it
    begins an epoch and emits nothing more until the coordinator has
    committed it (or given it up): the crash cells' faults land after
    the commit they target, whatever the timing."""
    from windflow_tpu_torch.core.basic import Pattern, RoutingMode
    from windflow_tpu_torch.core.tuples import TupleBatch
    from windflow_tpu_torch.operators.base import Operator, StageSpec
    from windflow_tpu_torch.runtime.emitters import StandardEmitter
    from windflow_tpu_torch.runtime.node import SourceLoopLogic
    marks = {c * chunk for c in epochs_at}

    class Logic(SourceLoopLogic):
        def __init__(self):
            self.i = 0
            self.began = -1
            self.wait = None
            super().__init__(self._step)

        def _step(self, emit):
            i = self.i
            if i >= n_events:
                return False
            inj = self.epoch_injector
            if self.wait is not None:
                epoch, deadline = self.wait
                coord = inj.coord
                with coord._cond:
                    done = coord.committed >= epoch or (
                        epoch not in coord._pending
                        and coord._committing != epoch)
                if not done and time.monotonic() < deadline:
                    time.sleep(0.0005)
                    return True
                if not done:
                    raise AssertionError(f"[{name}] epoch {epoch} did not "
                                         f"commit in {COMMIT_WAIT_S} s")
                self.wait = None
            elif inj is not None and i in marks and self.began != i:
                self.began = i
                self.wait = (inj.coord.begin_epoch(),
                             time.monotonic() + COMMIT_WAIT_S)
                return True
            idx = np.arange(i, min(i + chunk, n_events), dtype=np.int64)
            emit(TupleBatch({"key": idx % n_keys, "id": idx // n_keys,
                             "ts": idx // n_keys,
                             "value": (idx % VMOD).astype(np.float32)}))
            self.i = i + len(idx)
            return True

        def state_dict(self):
            return {"i": self.i}

        def load_state(self, st):
            self.i = st["i"]

        def progress_frontier(self):
            return self.i

    class Source(Operator):
        def __init__(self):
            super().__init__(name, 1, RoutingMode.NONE, Pattern.SOURCE)

        def stages(self):
            return [StageSpec(self.name, [Logic()], StandardEmitter(),
                              self.routing)]

    return Source()


class WindowSink:
    """Every window a sink receives (result batches or records), for
    ``check_windows`` (each window once, per key in id order, equal to
    an oracle) or for comparing runs; a sink of the durable cells sees
    only committed windows (transactional release)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.keys, self.ids, self.vals = [], [], []

    def __call__(self, item):
        if item is None:
            return
        with self.lock:
            if hasattr(item, "get_control_fields"):
                self.keys.append(np.array([item.key]))
                self.ids.append(np.array([item.id]))
                self.vals.append(np.array([item.value], np.float64))
            else:
                self.keys.append(np.asarray(item.key).copy())
                self.ids.append(np.asarray(item.id).copy())
                self.vals.append(np.asarray(item["value"],
                                            np.float64).copy())

    def sorted(self):
        keys = np.concatenate(self.keys) if self.keys else np.empty(0)
        ids = np.concatenate(self.ids) if self.ids else np.empty(0)
        vals = np.concatenate(self.vals) if self.vals else np.empty(0)
        order = np.lexsort((ids, keys))
        return keys[order], ids[order], vals[order]


def config11_op(**kw):
    """bench.py:1307-1310: the headline feed's engine (``kw``: more
    WinSeqTPU arguments)."""
    import windflow_tpu_torch as wf
    from windflow_tpu_torch.operators.tpu.win_seq_tpu import WinSeqTPU
    return WinSeqTPU("sum", WIN, SLIDE, wf.WinType.TB,
                     batch_len=DEVICE_BATCH, emit_batches=True,
                     max_buffer_elems=MAX_BUFFER, inflight_depth=INFLIGHT,
                     **kw)


def durable_config(path, interval_s, plan=None, **kw):
    import windflow_tpu_torch as wf
    from windflow_tpu_torch.core import DurabilityConfig
    return wf.RuntimeConfig(device=DURABLE_DEVICE, fault_plan=plan,
                            durability=DurabilityConfig(
                                epoch_interval_s=interval_s, path=path,
                                **kw))


def run11(durable: bool, epoch_dir: str, interval_s: float):
    """One config-11 run (bench.py:1303-1340): the template feed through
    WinSeqTPU into a sink, epochs on or off.  Returns the graph, its
    sorted windows, the seconds, the kernel counts and, with epochs on,
    the periodic commits and the recovery seconds (newest manifest into
    a freshly built graph)."""
    import windflow_tpu_torch as wf
    from windflow_tpu_torch.durability import EpochStore, restore_epoch
    from windflow_tpu_torch.operators.basic_ops import Sink
    from windflow_tpu_torch.operators.batch_ops import BatchSource

    def build():
        cfg = (durable_config(epoch_dir, interval_s) if durable
               else wf.RuntimeConfig(device=DURABLE_DEVICE))
        g = wf.PipeGraph("bench11", wf.Mode.DEFAULT, config=cfg)
        sink = WindowSink()
        g.add_source(BatchSource(template_source(N11), 1)) \
            .add(config11_op()).add_sink(Sink(sink))
        return g, sink

    g, sink = build()
    reset_counts()
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        # the bench's stateless source: epochs commit, a restart would
        # replay it from the start (the coordinator warns)
        warnings.simplefilter("ignore", RuntimeWarning)
        g.run()
    secs = time.perf_counter() - t0
    counts = read_counts()
    commits = recovery = None
    if durable:
        commits = sum(1 for e in g.flight.snapshot()
                      if e["kind"] == "epoch_commit" and not e.get("final"))
        epoch, payload = EpochStore(epoch_dir).latest()
        if epoch is not None:
            g2, _s2 = build()
            t0 = time.perf_counter()
            restore_epoch(g2, payload)
            recovery = time.perf_counter() - t0
    return g, sink.sorted(), secs, counts, commits, recovery


def durable11(card: str) -> int:
    """[durable11]: bench config 11 at its size, as
    ``run_checkpoint_overhead`` runs it: a calibration run, the cadence
    set to min(1 s, run/8) (at least 0.02 s), then epochs off and on
    interleaved, best of 3.  Gates: windows identical on and off, at
    least one periodic commit, a recovery time; the window-sum kernel's
    launches equal the batches in every run, no other kernel.  Returns
    the kernel's launches."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip-smoke-epochs-")
    k1 = []

    def one(durable, idx, interval):
        g, wins, secs, counts, commits, rec = run11(
            durable, f"{tmp}/run{idx}", interval)
        k1.append(check_launches(
            f"durable11 {'on' if durable else 'off'}", find_logic(g),
            counts, "window_sum"))
        shutil.rmtree(f"{tmp}/run{idx}", ignore_errors=True)
        return N11 / secs, wins, commits, rec

    try:
        rate0, ref, _c, _r = one(False, 99, None)
        interval = max(min(EPOCH_S11, N11 / rate0 / 8), EPOCH_FLOOR_S)
        offs, ons = [], []
        for i in range(3):
            offs.append(one(False, 2 * i, None))
            ons.append(one(True, 2 * i + 1, interval))
        for rate, wins, _c, _r in offs + ons:
            if not all(np.array_equal(a, b) for a, b in zip(wins, ref)):
                raise AssertionError("[durable11] the windows differ "
                                     "between runs (epochs on/off)")
        commits = max(c for _r8, _w, c, _rs in ons)
        if commits < 1:
            raise AssertionError("[durable11] no periodic epoch committed")
        recs = [rs for _r8, _w, _c, rs in ons if rs is not None]
        if not recs:
            raise AssertionError("[durable11] no manifest to recover from")
        rate_off = max(r for r, _w, _c, _rs in offs)
        rate_on = max(r for r, _w, _c, _rs in ons)
        log(f"[durable11] {N11} events, {len(ref[0])} windows identical "
            f"with epochs on and off (total {float(ref[2].sum()):.6f}); "
            f"tuples/s on {rate_on:.1f} (runs "
            f"{', '.join(f'{r:.1f}' for r, *_x in ons)}), off "
            f"{rate_off:.1f} (runs "
            f"{', '.join(f'{r:.1f}' for r, *_x in offs)}); overhead_frac "
            f"{1.0 - rate_on / rate_off:.4f} (best of 3; not gated); "
            f"epoch interval {interval:.4f} s; periodic commits "
            f"{', '.join(str(c) for _r8, _w, c, _rs in ons)}; recovery "
            f"{', '.join(f'{r:.6f}' for r in recs)} s; window_sum "
            f"launches = batches in all 7 runs ({', '.join(map(str, k1))}; "
            f"calibration, then off/on pairs), other kernels 0 ({card})")
        # the idle share: one more epochs-on run under the profiler
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            g, wins, secs, counts, commits, _rec = run11(
                True, f"{tmp}/profiled", interval)
        k1.append(check_launches("durable11 profiled", find_logic(g),
                                 counts, "window_sum"))
        log(f"[durable11 profile] epochs on, {commits} periodic commits, "
            f"{k1[-1]} window_sum launches: "
            f"{profile_summary(prof, secs, 6)} ({card})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return sum(k1)


def crash_run(tag: str, make_graph, fault, engine_cls, kernel: str):
    """``run_with_epochs`` over ``make_graph(path, plan)``: attempt 0
    carries ``fault``, attempt 1 none.  Every kernel count is set to 0
    once the restore has loaded attempt 1 (``on_restore``, before it
    runs), so the counts read after the run are the restored attempt's:
    ``kernel``'s must equal the batches its engine launched in that
    attempt, above 0, the others 0.  Returns the final graph and that
    count."""
    import shutil
    import tempfile
    from windflow_tpu_torch.durability import run_with_epochs
    tmp = tempfile.mkdtemp(prefix="chip-smoke-crash-")
    attempts = []
    restored = {}

    def factory(attempt):
        attempts.append(attempt)
        return make_graph(tmp, fault if attempt == 0 else None)

    def on_restore(g, epoch, payload):
        # a restored engine carries its snapshot's launch counter
        restored["base"] = find_logic(g, engine_cls).launched_batches
        reset_counts()

    try:
        g = run_with_epochs(factory, max_restarts=1, on_restore=on_restore)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    counts = read_counts()
    if attempts != [0, 1] or "base" not in restored:
        raise AssertionError(f"[{tag}] attempts {attempts}: the fault did "
                             f"not fire once, or nothing was restored")
    logic = find_logic(g, engine_cls)
    if logic.device is None or logic.device.type != DURABLE_DEVICE:
        raise AssertionError(f"[{tag}] engine device {logic.device}")
    launched = logic.launched_batches - restored["base"]
    if launched <= 0 or counts[kernel] != launched or any(
            n for name, n in counts.items() if name != kernel):
        raise AssertionError(f"[{tag}] after the restore: {launched} "
                             f"batches, kernel counts {counts}")
    return g, launched


def durable11_crash(card: str) -> int:
    """[durable11 crash]: config 11's graph with an exactly-once sink
    and ``FaultPlan.crash_at_epoch`` on the WinSeqTPU replica, under
    ``run_with_epochs``; the source is offset-checkpointable and carries
    the headline's integer law, so every window is held to the closed
    form.  Returns the window-sum kernel's launches after the restore."""
    import windflow_tpu_torch as wf
    from windflow_tpu_torch.resilience import FaultPlan

    sink = WindowSink()

    def make_graph(path, plan):
        g = wf.PipeGraph("bench11_crash", wf.Mode.DEFAULT,
                         config=durable_config(path, 3600.0, plan))
        g.add_source(durable_source(N11, SOURCE_BATCH, N_KEYS,
                                    CRASH_EPOCHS)) \
            .add(config11_op()) \
            .add_sink(wf.SinkBuilder(sink).with_exactly_once().build())
        return g

    t0 = time.perf_counter()
    g, k1 = crash_run("durable11 crash", make_graph,
                      FaultPlan(seed=11).crash_at_epoch("win_seq_tpu", 2),
                      None, "window_sum")
    secs = time.perf_counter() - t0
    if g._epoch_restored != 1:
        raise AssertionError(f"[durable11 crash] restored epoch "
                             f"{g._epoch_restored}, not 1")
    n_win = len(check_windows(sink, oracle(N11), "durable11 crash")[0])
    log(f"[durable11 crash] crash at epoch 2's cut on win_seq_tpu, "
        f"restored epoch {g._epoch_restored}, then "
        f"{g.durability.commits} commits; {n_win} windows exactly once, "
        f"equal to the closed form; {k1} window_sum launches after the "
        f"restore = batches, other kernels 0; both attempts "
        f"{secs:.3f} s ({card})")
    return k1


def durable_resident(card: str) -> int:
    """[durable resident]: config 15's resident FFAT lane at its size
    (8M events, 8 keys, CB 4096/16, the fused update+query kernel a
    step) with an exactly-once sink and a crash at epoch 2's cut on the
    engine.  Every window once, equal to ``oracle15``; the forest's
    bytes a cut (the D2H copy each snapshot takes, and its pickled
    state in the manifest) printed; the fused kernel launched after the
    restore.  Returns those launches."""
    import pickle
    import windflow_tpu_torch as wf
    from windflow_tpu_torch.durability import EpochStore
    from windflow_tpu_torch.operators.tpu.ffat_resident import \
        WinSeqFFATResidentLogic
    from windflow_tpu_torch.resilience import FaultPlan

    sink = WindowSink()
    cut = {}

    def make_graph(path, plan):
        g = wf.PipeGraph("resident_crash", wf.Mode.DEFAULT,
                         config=durable_config(path, 3600.0, plan))
        g.add_source(durable_source(N15, SOURCE15, KEYS15,
                                    RESIDENT_EPOCHS)) \
            .add(ffat_lane("resident")) \
            .add_sink(wf.SinkBuilder(sink).with_exactly_once().build())
        if plan is None:
            # the restored attempt: the manifest it restores from holds
            # the forest's state as one epoch cut captured it
            epoch, payload = EpochStore(path).latest()
            blob = next(v for k, v in payload["states"].items()
                        if "win_seqffat_resident" in k)
            cut.update(epoch=epoch, state=len(blob),
                       tree=pickle.loads(blob)["tree"].nbytes)
        return g

    t0 = time.perf_counter()
    g, k2f = crash_run(
        "durable resident", make_graph,
        FaultPlan(seed=15).crash_at_epoch("win_seqffat_resident", 2),
        WinSeqFFATResidentLogic, "flatfat_update_query")
    secs = time.perf_counter() - t0
    if g._epoch_restored != 1:
        raise AssertionError(f"[durable resident] restored epoch "
                             f"{g._epoch_restored}, not 1")
    n_win = len(check_windows(sink, oracle15(N15, SLIDE15),
                              "durable resident")[0])
    logic = find_logic(g, WinSeqFFATResidentLogic)
    log(f"[durable resident] {N15} events, crash at epoch 2's cut, "
        f"restored epoch {g._epoch_restored}; {n_win} windows exactly "
        f"once, equal to oracle15; the forest a cut: {cut['tree']} bytes "
        f"copied off the card, {cut['state']} bytes pickled in epoch "
        f"{cut['epoch']}'s manifest (Device_state_bytes_resident "
        f"{logic.device_resident_bytes()}); {k2f} flatfat_update_query "
        f"launches after the restore = steps, other kernels 0; both "
        f"attempts {secs:.3f} s ({card})")
    return k2f


def durable_step(card: str) -> int:
    """[durable step]: the device step's fused segment -- the
    checkpointable source, a BatchMap, config 11's WinSeqTPU and a
    transactional sink in one node -- crashed on the map's clock inside
    the segment (tests/test_durability.py:569 at config 11's width).
    Every window once, equal to the closed form; the window-sum kernel
    launched after the restore; at most 2 launches a chunk.  Returns
    the kernel's launches after the restore."""
    import windflow_tpu_torch as wf
    from windflow_tpu_torch.graph.device_step import DeviceStepLogic
    from windflow_tpu_torch.operators.batch_ops import BatchMap
    from windflow_tpu_torch.resilience import FaultPlan

    sink = WindowSink()

    def make_graph(path, plan):
        g = wf.PipeGraph("step_crash", wf.Mode.DEFAULT,
                         config=durable_config(path, 3600.0, plan))
        g.add_source(durable_source(N11, SOURCE_BATCH, N_KEYS,
                                    CRASH_EPOCHS)) \
            .add(BatchMap(lambda b: b)) \
            .add(config11_op()) \
            .add_sink(wf.SinkBuilder(sink).with_exactly_once().build())
        return g

    t0 = time.perf_counter()
    g, k1 = crash_run("durable step", make_graph,
                      FaultPlan(seed=19).crash_replica("batch_map",
                                                       at_tuple=10),
                      None, "window_sum")
    secs = time.perf_counter() - t0
    if g._epoch_restored != 2:
        raise AssertionError(f"[durable step] restored epoch "
                             f"{g._epoch_restored}, not 2")
    steps = [n.logic for n in g._all_nodes()
             if isinstance(n.logic, DeviceStepLogic)]
    if len(steps) != 1 or len(steps[0].segments) != 4:
        raise AssertionError(f"[durable step] nodes "
                             f"{[n.name for n in g._all_nodes()]}: not "
                             f"one step node of 4 segments")
    step = steps[0]
    if step.chunk_launches > 2 * step.chunks_in:
        raise AssertionError(f"[durable step] {step.chunk_launches} "
                             f"launches for {step.chunks_in} chunks")
    n_win = len(check_windows(sink, oracle(N11), "durable step")[0])
    log(f"[durable step] one step node ({g._all_nodes()[0].name}); crash "
        f"on batch_map's 10th chunk, restored epoch {g._epoch_restored}; "
        f"{n_win} windows exactly once, equal to the closed form; "
        f"{step.chunk_launches} launches for {step.chunks_in} chunks "
        f"after the restore; {k1} window_sum launches = batches, other "
        f"kernels 0; both attempts {secs:.3f} s ({card})")
    return k1


def delta16(card: str) -> None:
    """[delta16]: bench config 16 (``run_delta_snapshot_overhead``,
    bench.py:1378-1540) with its own gates: per-epoch commit bytes at
    least 10x smaller under delta at 1 % churn, identical sink effects,
    bitwise-equal restored keyed state.  No kernel runs."""
    import shutil
    import tempfile
    import windflow_tpu_torch as wf
    from windflow_tpu_torch.core import BasicRecord
    from windflow_tpu_torch.core.basic import Pattern, RoutingMode
    from windflow_tpu_torch.durability import EpochStore, restore_epoch
    from windflow_tpu_torch.graph.fuse import iter_logics
    from windflow_tpu_torch.operators.base import Operator, StageSpec
    from windflow_tpu_torch.runtime.emitters import StandardEmitter
    from windflow_tpu_torch.runtime.node import SourceLoopLogic

    # bench.py runs 400 dirty rounds; 100 keep the script's time (its
    # record plane ran about 13 s a lane at 200 on the H100; PERF.md §4)
    n_keys, dirty_frac, dirty_rounds, interval_s = 10_000, 0.01, 100, 0.06
    n_dirty = max(1, int(n_keys * dirty_frac))
    n_events = n_keys + dirty_rounds * n_dirty
    tmp = tempfile.mkdtemp(prefix="chip-smoke-delta-")

    class SrcLogic(SourceLoopLogic):
        def __init__(self):
            self.i = 0
            super().__init__(self._step)

        def _step(self, emit):
            i = self.i
            if i >= n_events:
                return False
            if i >= n_keys and i % 64 == 0:
                time.sleep(0.0015)
            k = i if i < n_keys else (i - n_keys) % n_dirty
            emit(BasicRecord(k, i, i, float(i % 97)))
            self.i = i + 1
            return True

        def state_dict(self):
            return {"i": self.i}

        def load_state(self, st):
            self.i = st["i"]

        def progress_frontier(self):
            return self.i

    class Src(Operator):
        def __init__(self):
            super().__init__("delta_bench_source", 1, RoutingMode.NONE,
                             Pattern.SOURCE)

        def stages(self):
            return [StageSpec(self.name, [SrcLogic()], StandardEmitter(),
                              self.routing)]

    def build(delta, epoch_dir):
        effects = {"n": 0, "sum": 0.0}

        def acc(t, a):
            a.value += t.value

        def sink(r):
            if r is not None:
                effects["n"] += 1
                effects["sum"] += r.value

        g = wf.PipeGraph("bench16", wf.Mode.DEFAULT, config=durable_config(
            epoch_dir, interval_s, delta=delta, delta_chain_max=64))
        g.add_source(Src()) \
            .add(wf.MapBuilder(lambda t: None).with_key_by().build()) \
            .add(wf.AccumulatorBuilder(acc)
                 .with_initial_value(BasicRecord(value=0.0))
                 .with_parallelism(2).build()) \
            .add_sink(wf.SinkBuilder(sink).build())
        return g, effects

    def keyed_of(g):
        out = {}
        for name, lg in iter_logics(g):
            if "accumulator" in name:
                for k, v in lg.keyed_state_dict().items():
                    if k in out:
                        raise AssertionError(f"[delta16] key {k} twice")
                    out[k] = v.value
        return out

    def lane(delta):
        epoch_dir = f"{tmp}/{'delta' if delta else 'full'}"
        g, effects = build(delta, epoch_dir)
        t0 = time.perf_counter()
        g.run()
        dt = time.perf_counter() - t0
        per = [e["bytes"] for e in g.flight.snapshot()
               if e["kind"] == "checkpoint_epoch" and not e.get("final")]
        epoch, payload = EpochStore(epoch_dir).latest()
        if epoch is None:
            raise AssertionError("[delta16] no manifest committed")
        g2, _e2 = build(delta, f"{tmp}/scratch")
        t0 = time.perf_counter()
        restore_epoch(g2, payload)
        return (n_events / dt, dict(effects), per, keyed_of(g2),
                time.perf_counter() - t0)

    try:
        rate_d, eff_d, bytes_d, state_d, rec_d = lane(True)
        rate_f, eff_f, bytes_f, state_f, rec_f = lane(False)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if eff_d != eff_f:
        raise AssertionError(f"[delta16] effects {eff_d} vs {eff_f}")
    if state_d != state_f or len(state_d) != n_keys:
        raise AssertionError("[delta16] restored keyed state differs")
    if len(bytes_d) < 3 or len(bytes_f) < 3:
        raise AssertionError(f"[delta16] {len(bytes_d)}/{len(bytes_f)} "
                             f"periodic commits: the cadence never engaged")
    med_d, med_f = float(np.median(bytes_d)), float(np.median(bytes_f))
    if med_f / med_d < 10:
        raise AssertionError(f"[delta16] delta commits only "
                             f"{med_f / med_d:.1f}x smaller")
    log(f"[delta16] {n_events} events, {n_keys} keys, 1 % churn: "
        f"median commit bytes delta {med_d:.1f} (base {bytes_d[0]}) vs "
        f"full {med_f:.1f} = {med_f / med_d:.1f}x smaller; epochs "
        f"{len(bytes_d)} / {len(bytes_f)}; effects and restored state "
        f"identical; tuples/s delta {rate_d:.1f}, full {rate_f:.1f}; "
        f"recovery delta {rec_d:.6f} s, full {rec_f:.6f} s ({card})")


def tiered17(card: str) -> None:
    """[tiered17]: bench config 17 (``run_tiered_spill``,
    bench.py:1543-1640) with its own gates: identical effects and keyed
    state all-hot and tiered (budget a tenth of the all-hot footprint),
    spills and promotions above 0, no sheds.  No kernel runs."""
    import pickle
    import shutil
    import tempfile
    import windflow_tpu_torch as wf
    from windflow_tpu_torch.core import BasicRecord
    from windflow_tpu_torch.graph.fuse import iter_logics

    n_keys, hot_frac, hot_rounds = 4_000, 0.02, 200
    n_hot = max(1, int(n_keys * hot_frac))
    n_events = n_keys + hot_rounds * n_hot
    tmp = tempfile.mkdtemp(prefix="chip-smoke-tiered-")

    def build(budget):
        effects = {"n": 0, "sum": 0.0}
        state = {"i": 0}

        def src(shipper, ctx=None):
            i = state["i"]
            if i >= n_events:
                return False
            k = i if i < n_keys else (i - n_keys) % n_hot
            shipper.push(BasicRecord(k, i, i, float(i % 97)))
            state["i"] = i + 1
            return True

        def acc(t, a):
            a.value += t.value

        def sink(r):
            if r is not None:
                effects["n"] += 1
                effects["sum"] += r.value

        g = wf.PipeGraph("bench17", wf.Mode.DEFAULT, config=wf.RuntimeConfig(
            device=DURABLE_DEVICE, state_budget_bytes=budget,
            log_dir=f"{tmp}/log"))
        g.add_source(wf.SourceBuilder(src).build()) \
            .add(wf.AccumulatorBuilder(acc)
                 .with_initial_value(BasicRecord(value=0.0))
                 .with_parallelism(2).build()) \
            .add_sink(wf.SinkBuilder(sink).build())
        return g, effects

    def keyed_of(g):
        out = {}
        for name, lg in iter_logics(g):
            if "accumulator" in name:
                for k, v in lg.keyed_state_dict().items():
                    if k in out:
                        raise AssertionError(f"[tiered17] key {k} twice")
                    out[k] = v.value
        return out

    def lane(budget):
        g, effects = build(budget)
        t0 = time.perf_counter()
        g.run()
        return g, n_events / (time.perf_counter() - t0), dict(effects), \
            keyed_of(g)

    try:
        _g, rate_hot, eff_hot, state_hot = lane(None)
        footprint = sum(len(pickle.dumps(v, pickle.HIGHEST_PROTOCOL)) + 96
                        for v in state_hot.values())
        budget = max(8_192, footprint // 10)
        g_t, rate_t, eff_t, state_t = lane(budget)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if eff_t != eff_hot:
        raise AssertionError(f"[tiered17] effects {eff_t} vs {eff_hot}")
    if state_t != state_hot or len(state_t) != n_keys:
        raise AssertionError("[tiered17] keyed state differs")
    stores = list((g_t.tiered_state.stores or {}).values())
    spills = sum(s.spilled_keys for s in stores)
    promotions = sum(s.promotions for s in stores)
    sheds = sum(s.sheds for s in stores)
    if not stores or spills <= 0 or promotions <= 0 or sheds:
        raise AssertionError(f"[tiered17] stores {len(stores)}, spills "
                             f"{spills}, promotions {promotions}, sheds "
                             f"{sheds}")
    log(f"[tiered17] {n_events} events, {n_keys} keys: budget {budget} "
        f"bytes (all-hot footprint {footprint}); resident "
        f"{sum(s.mem_bytes() for s in stores)} bytes; spilled keys "
        f"{spills} ({sum(s.spill.bytes_written for s in stores)} bytes), "
        f"promotions {promotions}, sheds 0; effects and keyed state "
        f"identical; tuples/s tiered {rate_t:.1f}, all-hot "
        f"{rate_hot:.1f} ({card})")


def main_durable(card: str) -> tuple:
    """The durability plane's cells; returns the window-sum kernel's and
    the fused update+query kernel's launches on their paths."""
    k1 = durable11(card)
    k1 += durable11_crash(card)
    k2f = durable_resident(card)
    k1 += durable_step(card)
    delta16(card)
    tiered17(card)
    return k1, k2f


# ---------------------------------------------------------------------------
# 12. the elastic scaling plane and the event-time plane
# ---------------------------------------------------------------------------

# [rescale15]: the replica count after each cut, made at the first
# source batch at or past its event: 1 -> 3 at half the stream, 3 -> 1
# at three quarters
RESCALE15 = ((N15 // 2, 3), (3 * N15 // 4, 1))
# bench config 2i (bench.py:331-404, run at :2375)
N2I = 4_500  # 9,000 in bench.py, halved for phase 15's room (PERF.md §4)
SVC2I_US, LOW2I, BURST2I = 1000.0, 500.0, 4.0
# bench config 18 (bench.py:2088-2218, run at :2581): 200,000 bids, cut
# 4x for phase 15's room (PERF.md §4)
N18 = 50_000
WIN18 = 256
LATE18_M, LATE18_PLANTED = 20_000, 7


class _ReplicaNode:
    """The fields of a replica node ``merge_keyed_states`` reads."""

    def __init__(self, logic):
        self.logic = logic
        self.name = "win_seqffat_resident"


def rescale15(card: str) -> int:
    """[rescale15]: config 15's resident FFAT lane at its size (8M
    events, 8 keys, CB 4096/16, source batch 65,536, ``torch.add``),
    its forest repartitioned across replicas on the card as the elastic
    plane moves keyed state (tests/test_resident.py:344, taken 1->3->1):
    one ``WinSeqFFATResidentLogic`` on the card takes the first half of
    the stream; its ``keyed_state_dict()`` goes through
    ``partition_keyed_state`` into 3 fresh logics on the card
    (``load_keyed_state``), which take the next quarter routed by
    ``owner_of`` (keys {0,3,6}, {1,4,7}, {2,5}); ``merge_keyed_states``
    brings the state back into one logic, which finishes the stream.
    Every window equals ``oracle15`` and [main15]'s unsplit lane exactly;
    every forest is on the card; on every logic the fused update+query
    launches equal its launched batches, the refills' launches counted
    apart, no other kernel.  Returns the fused kernel's launches."""
    from windflow_tpu_torch.core.tuples import TupleBatch
    from windflow_tpu_torch.elastic import (merge_keyed_states, owner_of,
                                            partition_keyed_state)
    from windflow_tpu_torch.operators.tpu.ffat_resident import \
        WinSeqFFATResidentLogic
    from windflow_tpu_torch.ops.cuda import flatfat_query as fq

    def fresh():
        return WinSeqFFATResidentLogic(lambda t: t.value, torch.add, 0.0,
                                       WIN15, SLIDE15, device=DEVICE15)

    stamps: list = []
    sink = RecordSink(stamps, SLIDE15)
    reps = [fresh()]
    steps = [0]          # the fused kernel's launches a logic, this stage
    refills = 0
    cuts = list(RESCALE15)
    reset_counts()
    t0 = time.perf_counter()
    for c in range(0, N15, SOURCE15):
        if cuts and c >= cuts[0][0]:
            for rep, k2f in zip(reps, steps):
                if k2f != rep.launched_batches or k2f <= 0:
                    raise AssertionError(
                        f"[rescale15] {k2f} fused launches != "
                        f"{rep.launched_batches} batches on a logic")
            torch.cuda.synchronize()
            t_cut = time.perf_counter()
            off = sum(r.forest.state_bytes for r in reps)
            merged, stateful = merge_keyed_states(
                [_ReplicaNode(r) for r in reps])
            if not stateful or sorted(merged) != list(range(KEYS15)):
                raise AssertionError(f"[rescale15] merged keys "
                                     f"{sorted(merged)}")
            new_n = cuts.pop(0)[1]
            old_n = len(reps)
            reps = [fresh() for _ in range(new_n)]
            k0 = fq.fused_launch_count()
            for part, rep in zip(partition_keyed_state(merged, new_n),
                                 reps):
                rep.load_keyed_state(part)
            torch.cuda.synchronize()
            secs_cut = time.perf_counter() - t_cut
            refill = fq.fused_launch_count() - k0
            refills += refill
            on = sum(b["leaves"].nbytes for b in merged.values())
            for rep in reps:
                if rep.forest.tree.device.type != DEVICE15:
                    raise AssertionError("[rescale15] forest off the card")
            shapes = [tuple(r.forest.tree.shape) for r in reps]
            owned = [sorted(r.keys) for r in reps]
            log(f"[rescale15] {old_n} -> {new_n} at event {c}: "
                f"{off} forest bytes copied off the card, {on} leaf "
                f"bytes copied onto it ({refill} refill launches of the "
                f"fused kernel); {secs_cut:.6f} s; forests {shapes}, keys "
                f"{owned} ({card})")
            steps = [0] * new_n
        idx = np.arange(c, min(c + SOURCE15, N15))
        stamps.append(time.perf_counter())
        batch = TupleBatch({"key": idx % KEYS15, "id": idx // KEYS15,
                            "ts": idx // KEYS15,
                            "value": (idx % VMOD).astype(np.float64)})
        owner = np.array([owner_of(k, len(reps)) for k in range(KEYS15)])
        owners = owner[batch.key]
        for i, rep in enumerate(reps):
            sel = np.nonzero(owners == i)[0]
            if len(sel):
                k0 = fq.fused_launch_count()
                rep.svc(batch.take(sel), 0, sink)
                steps[i] += fq.fused_launch_count() - k0
    k0 = fq.fused_launch_count()
    reps[0].eos_flush(sink)
    steps[0] += fq.fused_launch_count() - k0
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    if steps[0] != reps[0].launched_batches:
        raise AssertionError(f"[rescale15] {steps[0]} fused launches != "
                             f"{reps[0].launched_batches} batches")
    for name, count in counts.items():
        if name != "flatfat_update_query" and count:
            raise AssertionError(f"[rescale15] {name} launched {count} "
                                 f"times")
    got = sorted_windows(sink, "rescale15")
    hold_to_oracle(got, oracle15(N15, SLIDE15), "rescale15")
    if not all(np.array_equal(a, b) for a, b in zip(got[:3],
                                                    MAIN15_RESIDENT)):
        raise AssertionError("[rescale15] windows differ from [main15]'s "
                             "unsplit resident lane")
    k2f = counts["flatfat_update_query"]
    if cuts or not refills:
        raise AssertionError(f"[rescale15] cuts {cuts} not made")
    log(f"[rescale15] {N15} events in {secs:.3f} s = {N15 / secs:.1f} "
        f"tuples/s over the phase; {len(got[0])} windows equal oracle15 "
        f"and [main15]'s unsplit lane exactly; {k2f} flatfat_update_query "
        f"launches = the logics' steps + {refills} refills, every logic's "
        f"steps = its batches, other kernels 0 ({card})")
    return k2f


def elastic2i(card: str) -> None:
    """[elastic2i]: bench config 2i (bench.py:331-404) at 4,500 of its
    9,000 events: keys zipf(1.3) % 32 from default_rng(0), three
    open-loop phases at 500/s, 2,000/s and 500/s, a 1,000 us sleep fold in an
    elastic ``AccumulatorBuilder`` (1..4 replicas, target_util 0.5)
    under ``ElasticityConfig(sample_period_s=0.1, cooldown_s=1.0,
    ewma_alpha=0.6)``.  Every tuple conserved, each key's last
    accumulated value equal to its count, at least one scale-up, every
    event inside [1, 4], the controller and sampler threads stopped by
    the end of ``run()``; no kernel on this path."""
    import windflow_tpu_torch as wf
    from windflow_tpu_torch.elastic import ElasticityConfig

    phase_len = max(1, N2I // 3)
    state = {"i": 0}
    keys = (np.random.default_rng(0).zipf(1.3, size=N2I) % 32) \
        .astype(np.int64)
    sched = [0.0]

    def src(shipper, ctx):
        i = state["i"]
        if i >= N2I:
            return False
        rate = LOW2I * (BURST2I if min(i // phase_len, 2) == 1 else 1.0)
        now = time.perf_counter()
        if sched[0] == 0.0:
            sched[0] = now
        if now < sched[0]:
            time.sleep(sched[0] - now)
        sched[0] += 1.0 / rate
        shipper.push(wf.BasicRecord(int(keys[i]), i,
                                    time.perf_counter_ns() // 1000, 1.0))
        state["i"] = i + 1
        return True

    lats = {0: [], 1: [], 2: []}
    last: dict = {}
    lock = threading.Lock()

    def sink(r):
        if r is None:
            return
        lat_ms = (time.perf_counter_ns() // 1000 - r.ts) / 1e3
        with lock:
            lats[min(r.id // phase_len, 2)].append(lat_ms)
            last[r.key] = max(last.get(r.key, 0.0), r.value)

    def fold(t, acc):
        time.sleep(SVC2I_US / 1e6)
        acc.value += t.value

    cfg = wf.RuntimeConfig(elasticity=ElasticityConfig(
        sample_period_s=0.1, cooldown_s=1.0, ewma_alpha=0.6))
    g = wf.PipeGraph("chip_smoke2i", wf.Mode.DEFAULT, config=cfg)
    acc = wf.AccumulatorBuilder(fold).with_name("acc") \
        .with_initial_value(wf.BasicRecord()) \
        .with_elasticity(1, 4, target_util=0.5).build()
    g.add_source(wf.SourceBuilder(src).build()) \
        .add(acc).add_sink(wf.SinkBuilder(sink).build())
    reset_counts()
    t0 = time.perf_counter()
    g.run()
    secs = time.perf_counter() - t0
    counts = read_counts()
    events = json.loads(g.stats.to_json())["Rescale_events"]
    sunk = sum(len(v) for v in lats.values())
    if sunk != N2I:
        raise AssertionError(f"[elastic2i] sunk {sunk} != emitted {N2I}")
    want = collections.Counter(keys.tolist())
    if last != {k: float(c) for k, c in want.items()}:
        raise AssertionError("[elastic2i] a key's last value is not its "
                             "count")
    if not any(e["new_parallelism"] > e["old_parallelism"] for e in events):
        raise AssertionError(f"[elastic2i] no scale-up: {events}")
    if not all(1 <= e["new_parallelism"] <= 4 for e in events):
        raise AssertionError(f"[elastic2i] outside [1, 4]: {events}")
    if any(counts.values()):
        raise AssertionError(f"[elastic2i] kernels launched {counts}")
    ctl = g._controller
    if ctl is None or ctl.is_alive() or ctl.sampler.is_alive():
        raise AssertionError("[elastic2i] controller threads still alive")
    phases = "; ".join(
        f"phase {ph} p50 {np.percentile(lats[ph], 50):.3f} ms, p99 "
        f"{np.percentile(lats[ph], 99):.3f} ms" for ph in (0, 1, 2))
    path = " ".join(f"{e['old_parallelism']}->{e['new_parallelism']}"
                    f"@{e['duration_s']:.6f}s" for e in events)
    log(f"[elastic2i] {N2I} events in {secs:.3f} s = {N2I / secs:.1f} "
        f"tuples/s; sunk {sunk} = emitted; every key's last value = its "
        f"count; rescales {path}; {phases}; controller and sampler "
        f"stopped; no kernel ({card})")


class _WmClock:
    """bench.py's ``_WmClock``: the wall time at which a watermarked
    source's promise first reached each value (the seal stamps +inf)."""

    def __init__(self):
        self.w, self.t = [], []

    def note(self, wm):
        self.w.append(wm)
        self.t.append(time.perf_counter())

    def reached(self, x):
        import bisect
        i = bisect.bisect_left(self.w, x)
        return self.t[i] if i < len(self.t) else None


def _stamped_record_source(keys, tss, values, clock, every=32):
    """bench.py's ``_stamped_record_source``: NEXMark's record source
    with its watermark cadence stamped into ``clock``."""
    from windflow_tpu_torch.core.tuples import BasicRecord
    from windflow_tpu_torch.eventtime import watermarked

    n = len(keys)
    state = {"i": 0, "hi": float("-inf")}

    def body(shipper):
        i = state["i"]
        if i >= n:
            clock.note(float("inf"))
            return False
        shipper.push(BasicRecord(int(keys[i]), i, int(tss[i]), values[i]))
        if float(tss[i]) > state["hi"]:
            state["hi"] = float(tss[i])
        state["i"] = i + 1
        if state["i"] % every == 0:
            clock.note(state["hi"])
        return True

    return watermarked(body, every=every)


def nexmark18(card: str) -> None:
    """[nexmark18]: bench config 18 (bench.py:2088-2218) at its 200,000
    bids, through the port's own builders: Q4 (auctions |><| bids per
    tumbling window, the closing-price average per category) against
    ``q4_oracle`` per window within 1e-9; Q8 (persons |><| auctions, new
    users) against ``q8_oracle`` as an exact multiset, with the
    watermark-to-result latency; the planted-late lane, every straggler
    in dead letters and counted by the ``late_data`` flight events.  No
    on-time tuple quarantined; no kernel on these paths."""
    import windflow_tpu_torch as wf
    from windflow_tpu_torch.core.tuples import BasicRecord
    from windflow_tpu_torch.eventtime import EventTimeWindow, watermarked
    from windflow_tpu_torch.models.nexmark import (
        build_q4_avg_price, build_q8_new_users, q4_oracle, q8_oracle,
        synth_auctions, synth_bids, synth_persons)
    from windflow_tpu_torch.operators.basic_ops import Sink

    n_side = max(256, N18 // 8)
    persons = synth_persons(n_side, n_cities=16)
    auctions = synth_auctions(n_side, n_sellers=max(8, n_side // 2))
    bids = synth_bids(N18, n_auctions=n_side)
    lock = threading.Lock()
    reset_counts()

    q4 = {}

    def q4_sink(r):
        if r is not None:
            with lock:
                q4[(r.key, r.ts)] = r.value

    g4 = wf.PipeGraph("chip_smoke18_q4", wf.Mode.DEFAULT)
    build_q4_avg_price(g4, auctions, bids, WIN18, q4_sink)
    t0 = time.perf_counter()
    g4.run()
    dt4 = time.perf_counter() - t0
    want4 = q4_oracle(auctions, bids, WIN18)
    if set(q4) != set(want4) or not all(abs(q4[k] - want4[k]) < 1e-9
                                        for k in want4):
        raise AssertionError("[nexmark18] Q4 diverged from q4_oracle")
    if g4.dead_letters.count():
        raise AssertionError("[nexmark18] Q4 quarantined on-time tuples")

    clocks = iter((_WmClock(), _WmClock()))
    used = []
    q8 = []

    def q8_sink(r):
        if r is not None:
            now = time.perf_counter()
            with lock:
                q8.append((r.key, r.ts, r.value, now))

    def source_of(k, t, v):
        clock = next(clocks)
        used.append(clock)
        return _stamped_record_source(k, t, v, clock)

    g8 = wf.PipeGraph("chip_smoke18_q8", wf.Mode.DEFAULT)
    build_q8_new_users(g8, persons, auctions, WIN18, q8_sink,
                       source_of=source_of)
    t0 = time.perf_counter()
    g8.run()
    dt8 = time.perf_counter() - t0
    got8 = sorted((int(k), int(ts), int(v[0]), int(v[1]))
                  for k, ts, v, _ in q8)
    if got8 != q8_oracle(persons, auctions, WIN18):
        raise AssertionError("[nexmark18] Q8 diverged from q8_oracle")
    if g8.dead_letters.count():
        raise AssertionError("[nexmark18] Q8 quarantined on-time tuples")
    lats = [max(0.0, now - max(c.reached(ts + WIN18) for c in used))
            for _k, ts, _v, now in q8]

    ts = list(range(LATE18_M))
    stragglers = ts[LATE18_M // 2:LATE18_M // 2 + LATE18_PLANTED]
    on_time = ts[:LATE18_M // 2] + ts[LATE18_M // 2 + LATE18_PLANTED:]
    order = on_time + stragglers
    state = {"i": 0}

    def late_body(shipper):
        i = state["i"]
        if i >= len(order):
            return False
        shipper.push(BasicRecord(0, i, float(order[i]), 1.0))
        state["i"] = i + 1
        return True

    sums = {}

    def late_sink(r):
        if r is not None:
            with lock:
                sums[r.ts] = r.value

    gl = wf.PipeGraph("chip_smoke18_late", wf.Mode.DEFAULT)
    gl.add_source(wf.SourceBuilder(
        watermarked(late_body, every=16)).build()) \
        .add(EventTimeWindow(sum, 32.0, name="late_win")) \
        .add_sink(Sink(late_sink, name="late_sink"))
    gl.run()
    quarantined = gl.dead_letters.count()
    flights = sum(e["n"] for e in gl.flight.snapshot()
                  if e["kind"] == "late_data")
    if quarantined != LATE18_PLANTED or flights != LATE18_PLANTED:
        raise AssertionError(f"[nexmark18] planted {LATE18_PLANTED}, "
                             f"quarantined {quarantined}, late_data "
                             f"{flights}")
    expect: dict = {}
    for t in on_time:
        expect[float(t // 32 * 32)] = expect.get(float(t // 32 * 32), 0) + 1
    if sums != expect:
        raise AssertionError("[nexmark18] late lane fired wrong sums")
    counts = read_counts()
    if any(counts.values()):
        raise AssertionError(f"[nexmark18] kernels launched {counts}")
    fed = N18 + 3 * n_side
    p50, p99 = (float(np.percentile(lats, q)) * 1e3 for q in (50, 99))
    log(f"[nexmark18] {N18} bids, {n_side} persons and auctions: "
        f"{fed / (dt4 + dt8):.1f} tuples/s (Q4 {dt4:.3f} s, "
        f"{(N18 + n_side) / dt4:.1f}/s, {len(q4)} windows within 1e-9 of "
        f"q4_oracle; Q8 {dt8:.3f} s, {2 * n_side / dt8:.1f}/s, "
        f"{len(got8)} pairs equal q8_oracle); Q8 watermark-to-result "
        f"p50 {p50:.3f} ms, p99 {p99:.3f} ms; late lane: "
        f"{LATE18_PLANTED} planted, {quarantined} quarantined, late_data "
        f"n {flights}; Q4 and Q8 quarantined 0; no kernel ({card})")


def main_planes(card: str) -> int:
    """The elastic and event-time planes' cells; returns the fused
    update+query kernel's launches on [rescale15]."""
    k2f = rescale15(card)
    elastic2i(card)
    nexmark18(card)
    return k2f


# ---------------------------------------------------------------------------
# 13. the mission-control plane on the card: the SLO plane, the live
#     cluster view, the dashboard and the doctor (bench config 13), and
#     the observability planes' overhead gates (bench configs 8, 9, 10)
# ---------------------------------------------------------------------------

# bench.py runs configs 8, 9, 10 and 13 at N_EVENTS // 4 (bench.py:2473,
# :2488, :2501, :2536)
N13 = 16_000_000
N_DASH = 2_000_000
MISSION_DEVICE = "cuda"
# the diagnosis and audit cadence of the breach run: the auditor's floor
# of 20 ms, so a run of a few hundred ms judges its objectives ~10 times
BREACH_TICK_S = 0.02
# fast and slow windows of the breach run in stream seconds, both mapped
# onto the run's length by window_scale: with ticks 20-40 ms apart a
# shorter fast window would hold fewer than the 2 samples a burn needs
BREACH_FAST_S = BREACH_SLOW_S = 40.0
# the p99 budget of the breach run, as a fraction of the plane-off p50
BREACH_BUDGET = 0.25
# the breach run's pusher: each push also offers the diagnosis a tick
BREACH_PUSH_S = 0.05
DOCTOR_TIMEOUT_S = 120


def template_oracle(n_events: int):
    """Closed form of ``template_source`` under config 11's TB windows,
    float64: key k holds ids 0..M-1 (M = n/keys) with value
    pool[(id % P) * keys + k], P = SOURCE_BATCH / keys (every source
    batch repeats the pool); window w covers ids [w*slide, w*slide +
    win), partial tail windows flushed at EOS."""
    assert n_events % N_KEYS == 0
    pool = np.random.default_rng(0).random(SOURCE_BATCH).astype(np.float32)
    M = n_events // N_KEYS
    per = pool.astype(np.float64).reshape(-1, N_KEYS)      # [P, keys]
    vals = np.tile(per, (-(-M // per.shape[0]), 1))[:M]     # [M, keys]
    prefix = np.concatenate([np.zeros((1, N_KEYS)),
                             np.cumsum(vals, axis=0)])
    n_win = (M - 1) // SLIDE + 1
    a = np.arange(n_win) * SLIDE
    b = np.minimum(a + WIN, M)
    sums = (prefix[b] - prefix[a]).T                        # [keys, W]
    return (np.repeat(np.arange(N_KEYS), n_win),
            np.tile(np.arange(n_win), N_KEYS), sums.reshape(-1))


def plane_run(tag: str, log_dir: str, n_events: int = 0, attach=None,
              **cfg_kw):
    """One run of the template feed through config 11's WinSeqTPU into a
    sink, under ``RuntimeConfig(**cfg_kw)`` on MISSION_DEVICE, timed
    from ``start`` to ``wait_end`` as bench.py times configs 8-13.
    ``attach(g)`` runs inside the timed span right after ``start`` (the
    observer and pusher of config 13) and returns what ``plane_run``
    hands back.  Every kernel count is set to 0 just before and read
    just after; the window-sum kernel's launches must equal the
    engine's batches and no other kernel may launch.  Returns (tuples/s,
    the sink's sorted windows, K1 launches, the graph, attach's
    value).  ``n_events`` 0 means N13."""
    import windflow_tpu_torch as wf
    from windflow_tpu_torch.operators.basic_ops import Sink
    from windflow_tpu_torch.operators.batch_ops import BatchSource
    n_events = n_events or N13
    cfg = wf.RuntimeConfig(device=MISSION_DEVICE, log_dir=log_dir, **cfg_kw)
    g = wf.PipeGraph("bench13", wf.Mode.DEFAULT, config=cfg)
    sink = WindowSink()
    g.add_source(BatchSource(template_source(n_events), 1)) \
        .add(config11_op()).add_sink(Sink(sink))
    reset_counts()
    hook = None
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the dashboard-less fallback
        g.start()
        if attach is not None:
            hook = attach(g)
        g.wait_end()
    secs = time.perf_counter() - t0
    k1 = check_launches(tag, find_logic(g), read_counts(), "window_sum")
    return n_events / secs, sink.sorted(), k1, g, hook


def hold_lanes(tag: str, runs, want) -> None:
    """Every run's windows bitwise equal to the first's, and the first's
    keys and ids exact and values within RTOL_F32 of the float64
    oracle."""
    ref = runs[0][1]
    for r in runs[1:]:
        if not all(np.array_equal(a, b) for a, b in zip(r[1], ref)):
            raise AssertionError(f"[{tag}] the windows differ between "
                                 f"runs (plane on/off)")
    ok, oi, ov = want
    if not (np.array_equal(ref[0], ok) and np.array_equal(ref[1], oi)):
        raise AssertionError(f"[{tag}] window keys or ids differ from the "
                             f"template oracle ({len(ref[0])} windows, "
                             f"oracle {len(ok)})")
    if not np.allclose(ref[2], ov, rtol=RTOL_F32, atol=0):
        raise AssertionError(f"[{tag}] window values outside rtol "
                             f"{RTOL_F32} of the template oracle (max rel "
                             f"err {np.max(np.abs(ref[2] - ov) / ov):.3g})")


def interleaved(one):
    """bench.py's protocol: off, on, three times; returns (off runs, on
    runs) and each lane's best rate."""
    offs, ons = [], []
    for _ in range(3):
        offs.append(one(False))
        ons.append(one(True))
    return offs, ons, max(r[0] for r in offs), max(r[0] for r in ons)


def rates(runs) -> str:
    return ", ".join(f"{r[0]:.1f}" for r in runs)


def observed(interval_s: float):
    """An ``attach`` for ``plane_run``: a ClusterObserver on a free port
    and a StatsPusher from the graph to it every ``interval_s``."""
    from windflow_tpu_torch.distributed.observe import (ClusterObserver,
                                                         attach_pusher)

    def attach(g):
        obs = ClusterObserver()
        obs.start()
        return obs, attach_pusher(g, obs.host, obs.port, interval_s)

    return attach


def settle(tag: str, hook) -> tuple:
    """Stop the pusher (its final push carries the settled books) and let
    the observer ingest every push; the caller stops the observer.
    Gates: at least one push, no push error.  Returns the merged live
    view and the pushes."""
    obs, pusher = hook
    pusher.stop()
    deadline = time.monotonic() + 10.0
    while obs.pushes < pusher.pushes and time.monotonic() < deadline:
        time.sleep(0.01)
    merged = obs.merged() or {}
    if pusher.pushes < 1 or pusher.errors != 0:
        raise AssertionError(f"[{tag}] pusher: {pusher.pushes} pushes, "
                             f"{pusher.errors} errors")
    return merged, pusher.pushes


def slo13(card: str, tmp: str, want) -> tuple:
    """[slo13]: bench config 13 (``run_slo_overhead``, bench.py:928-1007)
    at its 16M events: traced runs with diagnosis ticks every 0.25 s,
    SLO off, and SLO on (generous objectives) with a ClusterObserver and
    a StatsPusher every 0.25 s, interleaved best of 3.  Gates: windows
    bitwise equal across the lanes and equal to the template oracle,
    every push delivered (pushes >= 1, errors 0) and the Slo block in
    the merged live view, K1 launches = batches in each run.  Returns
    the off runs and the K1 launches."""
    from windflow_tpu_torch.slo import SloConfig
    t0 = time.perf_counter()
    k1 = []

    def one(slo_on):
        kw = dict(tracing=True, diagnosis_interval_s=0.25)
        if slo_on:
            kw["slo"] = SloConfig(p99_ms=1e9, min_throughput_rps=0.001)
        r = plane_run(f"slo13 {'on' if slo_on else 'off'}",
                      f"{tmp}/slo13_{len(k1)}",
                      attach=observed(0.25) if slo_on else None, **kw)
        k1.append(r[2])
        live = None
        if slo_on:
            try:
                merged, pushes = settle("slo13", r[4])
            finally:
                r[4][0].stop()
            live = merged.get("Slo")
            if live is None:
                raise AssertionError("[slo13] the Slo block never reached "
                                     "the live merged view")
            live = dict(live, pushes=pushes)
        return r[0], r[1], live, r[3]

    offs, ons, rate_off, rate_on = interleaved(one)
    hold_lanes("slo13", offs + ons, want)
    best = max(ons, key=lambda r: r[0])[2]
    log(f"[slo13] {N13} events, {len(want[0])} windows bitwise equal with "
        f"the SLO plane on and off, keys and ids exact and values within "
        f"rtol {RTOL_F32} of the template oracle; rate_on {rate_on:.1f} "
        f"(runs {rates(ons)}), rate_off {rate_off:.1f} (runs "
        f"{rates(offs)}) tuples/s; overhead_frac "
        f"{1.0 - rate_on / rate_off:.4f} (best of 3; not gated); "
        f"slo_ticks {best.get('Ticks', 0)}, breaches "
        f"{best.get('Breaches_total', 0)}, budget_burned "
        f"{best.get('Budget_burned')}; pushes "
        f"{', '.join(str(r[2]['pushes']) for r in ons)} (errors 0); "
        f"window_sum launches = batches in all 6 runs "
        f"({', '.join(map(str, k1))}), other kernels 0; "
        f"{time.perf_counter() - t0:.1f} s ({card})")
    return offs, sum(k1)


def slo_breach(card: str, tmp: str, offs, p50_us: float) -> int:
    """[slo breach]: the same graph once more with trace_sample 1,
    diagnosis and audit ticks every BREACH_TICK_S, and a p99 budget of
    BREACH_BUDGET times ``p50_us``, the traced e2e p50 of the plane-off
    graph
    ([overhead8]'s trace_sample 1 readout: at the default sampling of
    1 in 128 source batches [slo13]'s 16 batches close no trace);
    window_scale maps the slow window onto the off lane's run time, so
    both windows fill within the run.  Gates: a slo_breach flight
    episode opens, Breaches_total >= 1, windows bitwise [slo13]'s off
    lane's, the episode in the merged view of a ClusterObserver the run
    pushes to every BREACH_PUSH_S, K1 launches = batches."""
    from windflow_tpu_torch.slo import SloConfig
    t0 = time.perf_counter()
    if not p50_us:
        raise AssertionError("[slo breach] no traced e2e p50 to set the "
                             "budget from")
    p50_ms = p50_us / 1e3
    run_s = N13 / max(r[0] for r in offs)
    cfg = SloConfig(p99_ms=p50_ms * BREACH_BUDGET, target=0.9,
                    fast_burn=5.0,
                    fast_window_s=BREACH_FAST_S,
                    slow_window_s=BREACH_SLOW_S,
                    window_scale=run_s / BREACH_SLOW_S, warmup_ticks=1)
    rate, wins, k1, g, hook = plane_run(
        "slo breach", f"{tmp}/slo_breach", attach=observed(BREACH_PUSH_S),
        tracing=True, trace_sample=1, diagnosis_interval_s=BREACH_TICK_S,
        audit_interval_s=BREACH_TICK_S, slo=cfg)
    try:
        merged, pushes = settle("slo breach", hook)
    finally:
        hook[0].stop()
    if not all(np.array_equal(a, b) for a, b in zip(wins, offs[0][1])):
        raise AssertionError("[slo breach] the windows differ from "
                             "[slo13]'s off lane")
    kinds = [e["kind"] for e in g.flight.snapshot()]
    slo = json.loads(g.stats.to_json())["Slo"]
    if "slo_breach" not in kinds or (slo or {}).get("Breaches_total", 0) < 1:
        raise AssertionError(f"[slo breach] no breach episode (flight "
                             f"{sorted(set(kinds))}, Slo {slo})")
    live = merged.get("Slo") or {}
    if live.get("Breaches_total", 0) < 1 or not any(
            e.get("kind") == "slo_breach" for e in merged.get("Flight") or ()):
        raise AssertionError(f"[slo breach] the breach never reached the "
                             f"live merged view (Slo {live})")
    rep = g.explain()
    log(f"[slo breach] p99 budget {p50_ms * BREACH_BUDGET:.3f} ms "
        f"({BREACH_BUDGET} x the plane-off traced e2e p50 {p50_ms:.3f} ms), "
        f"windows fast "
        f"{slo['Windows']['fast_s']} s / slow {slo['Windows']['slow_s']} s: "
        f"slo_breach opened ({kinds.count('slo_breach')} episode(s), "
        f"Breaches_total {slo['Breaches_total']}, ticks {slo['Ticks']}, bad "
        f"{slo['Bad_ticks']}, burn fast {slo['Burn_rate_fast']} / slow "
        f"{slo['Burn_rate_slow']}, budget_burned {slo['Budget_burned']}, "
        f"values {slo['Values']}); verdict: {rep['Verdict']!r}; windows "
        f"bitwise [slo13]'s off lane; the episode in the observer's merged "
        f"view after {pushes} pushes; {rate:.1f} tuples/s; window_sum "
        f"launches = batches ({k1}), other kernels 0; "
        f"{time.perf_counter() - t0:.1f} s ({card})")
    return k1


def http_get(url: str):
    import urllib.request
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read().decode()


def doctor_cli(*args) -> str:
    """``python -m windflow_tpu_torch.doctor <args>`` as a user runs it;
    fails unless it exits 0 and names a bottleneck."""
    p = subprocess.run([sys.executable, "-m", "windflow_tpu_torch.doctor",
                        *args], capture_output=True, text=True,
                       timeout=DOCTOR_TIMEOUT_S)
    if p.returncode != 0 or "bottleneck" not in p.stdout:
        raise AssertionError(f"[dashboard] doctor {args}: rc "
                             f"{p.returncode}, stdout {p.stdout[-400:]!r}, "
                             f"stderr {p.stderr[-400:]!r}")
    line = next((ln for ln in p.stdout.splitlines()
                 if "bottleneck" in ln), "")
    return line.strip()


def dashboard_phase(card: str, tmp: str) -> int:
    """[dashboard]: a traced K1 graph (the template feed at N_DASH)
    reporting to an in-process DashboardServer (port 0) with its HTTP
    front (port 0), and pushing to a ClusterObserver.  Gates: the graph
    registered (/apps non-empty); /, /apps, /metrics, /flight,
    /explain and /cluster answer 200, and the observer's /cluster too;
    /apps's report carries Device_launches equal to K1's counted
    launches; ``python -m windflow_tpu_torch.doctor <log_dir>`` and
    ``--watch <observer> --once`` exit 0 and name a bottleneck."""
    from windflow_tpu_torch.monitoring.dashboard import (DashboardServer,
                                                          serve_http)
    t0 = time.perf_counter()
    log_dir = f"{tmp}/dashboard"
    dash = DashboardServer(port=0)
    dash.start()
    httpd = hook = None
    try:
        httpd = serve_http(dash, port=0)
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        rate, wins, k1, g, hook = plane_run(
            "dashboard", log_dir, n_events=N_DASH, attach=observed(0.25),
            tracing=True, dashboard_port=dash.port)
        obs = hook[0]
        _merged, pushes = settle("dashboard", hook)
        obs.serve_http(port=0)
        # the deregister frame lands on the dashboard's connection thread
        deadline = time.monotonic() + 10.0
        while True:
            apps = json.loads(http_get(base + "/apps")[1])
            if apps and not any(a.get("active") for a in apps.values()) \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        if not apps:
            raise AssertionError("[dashboard] the graph never registered "
                                 "(/apps is empty)")
        (app,) = apps.values()
        launches = sum(r.get("Device_launches", 0)
                       for op in app["report"]["Operators"]
                       for r in op.get("Replicas") or ())
        if launches != k1:
            raise AssertionError(f"[dashboard] /apps Device_launches "
                                 f"{launches} != window_sum launches {k1}")
        paths = ("/", "/apps", "/metrics", "/flight", "/explain", "/cluster")
        for path in paths:
            code, body = http_get(base + path)
            if code != 200 or not body:
                raise AssertionError(f"[dashboard] GET {path}: {code}")
        code, body = http_get(obs.http_url + "/cluster")
        if code != 200 or not json.loads(body).get("merged"):
            raise AssertionError(f"[dashboard] observer /cluster: {code}")
        offline = doctor_cli(log_dir)
        live = doctor_cli("--watch", obs.http_url, "--once")
    finally:
        if hook is not None:
            for part in reversed(hook):  # the pusher, then the observer
                part.stop()
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        dash.stop()
    log(f"[dashboard] {N_DASH} events at {rate:.1f} tuples/s, "
        f"{len(wins[0])} windows; registered as app(s) {sorted(apps)}; "
        f"GET {', '.join(paths)} and the observer's /cluster: 200; /apps "
        f"Device_launches {launches} = window_sum launches {k1} = "
        f"batches, other kernels 0; {pushes} pushes; doctor "
        f"{log_dir.rsplit('/', 1)[-1]}/: {offline!r}; doctor --watch "
        f"--once: {live!r}; {time.perf_counter() - t0:.1f} s ({card})")
    return k1


def overhead8(card: str, tmp: str, want) -> int:
    """[overhead8]: bench config 8 (``run_tracing_overhead``,
    bench.py:728-799) at 16M events: tracing off and on (default
    sampling), interleaved best of 3, windows identical, then the e2e
    readout run at trace_sample 1.  The 3 % bar is reported, not
    gated, as the bench does."""
    t0 = time.perf_counter()
    k1 = []

    def one(tracing, sample=None):
        kw = {"tracing": tracing}
        if sample is not None:
            kw["trace_sample"] = sample
        r = plane_run(f"overhead8 {'on' if tracing else 'off'}",
                      f"{tmp}/o8_{len(k1)}", **kw)
        k1.append(r[2])
        return r

    offs, ons, rate_off, rate_on = interleaved(one)
    readout = one(True, sample=1)
    hold_lanes("overhead8", offs + ons + [readout], want)
    e2e = json.loads(readout[3].stats.to_json()).get("Latency_e2e") or {}
    ovh = 1.0 - rate_on / rate_off
    log(f"[overhead8] {N13} events, windows bitwise equal with tracing on "
        f"and off and in the trace_sample=1 readout, equal to the template "
        f"oracle; rate_on {rate_on:.1f} (runs {rates(ons)}), rate_off "
        f"{rate_off:.1f} (runs {rates(offs)}) tuples/s; overhead_frac "
        f"{ovh:.4f} against the bench's 3 % bar: "
        f"{'under' if ovh < 0.03 else 'over'} it (reported, not gated); "
        f"e2e at trace_sample 1: n {e2e.get('n')}, p50 "
        f"{e2e.get('p50_us')} us, p99 {e2e.get('p99_us')} us; window_sum "
        f"launches = batches in all 7 runs ({', '.join(map(str, k1))}), "
        f"other kernels 0; {time.perf_counter() - t0:.1f} s ({card})")
    return sum(k1), e2e.get("p50_us")


def overhead9(card: str, tmp: str, want) -> int:
    """[overhead9]: bench config 9 (``run_audit_overhead``,
    bench.py:802-858) at 16M events: the audit plane off and on,
    interleaved best of 3; windows identical, and every audited run
    with zero conservation violations, its final check done and every
    edge balanced."""
    t0 = time.perf_counter()
    k1, books = [], []

    def one(audit):
        r = plane_run(f"overhead9 {'on' if audit else 'off'}",
                      f"{tmp}/o9_{len(k1)}", audit=audit)
        k1.append(r[2])
        if audit:
            a = r[3].auditor
            if a.violations or not a.final_done:
                raise AssertionError(f"[overhead9] violations "
                                     f"{a.violations}, final check done "
                                     f"{a.final_done}")
            cons = a.ledger.conservation_block(
                a.ledger.edges(), r[3]._all_nodes(), a.violations,
                a.passes, a.final_done)
            if not all(e["balanced"] for e in cons["Edges"]):
                raise AssertionError(f"[overhead9] unbalanced edge: "
                                     f"{cons['Edges']}")
            books.append(len(cons["Edges"]))
        return r

    offs, ons, rate_off, rate_on = interleaved(one)
    hold_lanes("overhead9", offs + ons, want)
    log(f"[overhead9] {N13} events, windows bitwise equal with the audit "
        f"plane on and off, equal to the template oracle; 0 conservation "
        f"violations, final check done, every edge balanced "
        f"({', '.join(map(str, books))} edges); rate_on {rate_on:.1f} "
        f"(runs {rates(ons)}), rate_off {rate_off:.1f} (runs "
        f"{rates(offs)}) tuples/s; overhead_frac "
        f"{1.0 - rate_on / rate_off:.4f} (not gated); window_sum launches "
        f"= batches in all 6 runs ({', '.join(map(str, k1))}), other "
        f"kernels 0; {time.perf_counter() - t0:.1f} s ({card})")
    return sum(k1)


def overhead10(card: str, tmp: str, want) -> int:
    """[overhead10]: bench config 10 (``run_diagnosis_overhead``,
    bench.py:861-925) at 16M events: tracing on in both lanes,
    ``diagnosis`` off and on (ticks every 0.25 s), interleaved best of
    3; windows identical, and each diagnosed run's ``explain()``
    hop-class shares summing to 1 within 0.02 where it attributed a
    trace (the bench's own gate).  At the default sampling a 16-batch
    run may close no trace, so one more diagnosed run at trace_sample 1
    must attribute traces and meet the same gate."""
    t0 = time.perf_counter()
    k1, summ = [], []

    def one(diagnosis, sample=None):
        kw = {} if sample is None else {"trace_sample": sample}
        r = plane_run(f"overhead10 {'on' if diagnosis else 'off'}",
                      f"{tmp}/o10_{len(k1)}", tracing=True,
                      diagnosis=diagnosis, diagnosis_interval_s=0.25, **kw)
        k1.append(r[2])
        if diagnosis:
            rep = r[3].explain()
            attr = rep.get("Attribution")
            if sample is not None and not (attr or {}).get("Traces"):
                raise AssertionError(f"[overhead10] the trace_sample "
                                     f"{sample} run attributed no trace")
            if attr is not None and abs(attr["Share_sum"] - 1.0) >= 0.02:
                raise AssertionError(f"[overhead10] shares sum to "
                                     f"{attr['Share_sum']}: {attr}")
            summ.append(((rep.get("Bottleneck") or {}).get("Operator"),
                         (attr or {}).get("Traces", 0),
                         (attr or {}).get("Share_sum")))
        return r

    offs, ons, rate_off, rate_on = interleaved(one)
    readout = one(True, sample=1)
    hold_lanes("overhead10", offs + ons + [readout], want)
    log(f"[overhead10] {N13} events, windows bitwise equal with the "
        f"diagnosis plane on and off and in a trace_sample=1 readout, "
        f"equal to the template oracle; explain() (bottleneck, traces, "
        f"share sum) per diagnosed run, the readout last: {summ}; rate_on {rate_on:.1f} (runs {rates(ons)}), rate_off "
        f"{rate_off:.1f} (runs {rates(offs)}) tuples/s; overhead_frac "
        f"{1.0 - rate_on / rate_off:.4f} (not gated); window_sum launches "
        f"= batches in all 7 runs ({', '.join(map(str, k1))}), other "
        f"kernels 0; {time.perf_counter() - t0:.1f} s ({card})")
    return sum(k1)


def main_mission(card: str) -> int:
    """Phase 13's cells; returns the window-sum kernel's launches."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip-smoke-mission-")
    try:
        want = template_oracle(N13)
        k1, p50_us = overhead8(card, tmp, want)
        k1 += overhead9(card, tmp, want)
        k1 += overhead10(card, tmp, want)
        offs, k = slo13(card, tmp, want)
        k1 += k + slo_breach(card, tmp, offs, p50_us)
        k1 += dashboard_phase(card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return k1


# ---------------------------------------------------------------------------
# 14. distributed
# ---------------------------------------------------------------------------

# bench config 12 (bench.py:1659-1735, run at :2525 with N_EVENTS // 4)
# bench config 12's 16M bids, cut 4x for phase 15's room (PERF.md §4)
N12 = N_EVENTS // 16
WIN12, SLIDE12 = 8192, 4096
SOURCE12 = 1 << 18
AUCTIONS12 = 1000
# the device engines' device (the CPU only to rehearse the phase without
# a card)
DIST_DEVICE = "cuda"
DIST_TIMEOUT_S = 300.0
SMOKE_TIMEOUT_S = 300


def dist12_build(g):
    """Worker-side build of bench config 12 (bench.py:1659-1681) on the
    port.  The workers load it from this file, executed under an alias
    (distributed/runtime._load_ref), so ``main`` does not run there.
    The lane, the stream length and the paths travel as environment
    variables: WINDFLOW_DIST12_PLACEMENT ('host' as the bench, or
    'device'), WINDFLOW_DIST12_N, WINDFLOW_DIST12_OUT (the sink's
    windows, an .npz written at EOS) and WINDFLOW_DIST12_PROBE (a
    directory: each worker writes what it ran there at exit)."""
    import atexit
    from windflow_tpu_torch.models.nexmark import build_q5_hot_items
    n = int(os.environ["WINDFLOW_DIST12_N"])
    out = os.environ["WINDFLOW_DIST12_OUT"]
    cols = {"key": [], "id": [], "value": []}

    def sink(item):
        if item is None:
            np.savez(out, **{c: np.concatenate(v) if v else np.zeros(0)
                             for c, v in cols.items()})
            return
        for c in cols:
            cols[c].append(np.array(item[c] if c == "value"
                                    else getattr(item, c)))

    build_q5_hot_items(g, n, WIN12, SLIDE12, sink, n_auctions=AUCTIONS12,
                       batch_size=SOURCE12, device_batch=DEVICE_BATCH,
                       parallelism=2,
                       placement=os.environ["WINDFLOW_DIST12_PLACEMENT"])
    probe = os.environ.get("WINDFLOW_DIST12_PROBE")
    if probe:
        atexit.register(write_probe, g, probe)


def dist12_config(worker_id):
    """bench12_config (bench.py:1684-1689), its device engines on
    WINDFLOW_DIST12_DEVICE (DIST_DEVICE, set by the coordinator)."""
    import windflow_tpu_torch as wf
    return wf.RuntimeConfig(tracing=True, trace_sample=2,
                            device=os.environ["WINDFLOW_DIST12_DEVICE"],
                            log_dir=os.environ["WINDFLOW_DIST12_LOG"])


def probe_doc(graphs) -> dict:
    """What a worker process ran, read at its exit: the kernels' counted
    launches, the window engines of ``graphs`` with their batches,
    whether it holds a CUDA context and on which card, and whether jax
    or the reference package was imported."""
    cuda = torch.cuda.is_initialized()
    return {"pid": os.getpid(), "counts": read_counts(),
            "engines": [{"tenant": g.name,
                         "placement": lg.resolved_placement,
                         "device": str(lg.device),
                         "batches": lg.launched_batches}
                        for g in graphs for lg in device_logics(g)],
            "cuda": cuda,
            "device_name": torch.cuda.get_device_name(0) if cuda else None,
            "jax": "jax" in sys.modules,
            "reference": "windflow_tpu" in sys.modules}


def write_probe(g, probe_dir: str) -> None:
    """A distributed worker's exit probe, ``w<worker>.json``."""
    from windflow_tpu_torch.distributed.identity import worker_id
    doc = dict(probe_doc([g]), worker=worker_id())
    with open(os.path.join(probe_dir, f"w{doc['worker']}.json"), "w") as f:
        json.dump(doc, f)


def dist12_oracle(n: int):
    """Config 12's windows by numpy: per-auction bid counts of every
    window of 8192 / 4096 up to the auction's last bid, over the pool
    the source repeats every SOURCE12 bids."""
    from windflow_tpu_torch.models import nexmark
    pool = nexmark.synth_bids(SOURCE12, AUCTIONS12)["auction"]
    keys = np.concatenate([pool[:min(SOURCE12, n - i)]
                           for i in range(0, n, SOURCE12)])
    return count_windows(keys, np.arange(n, dtype=np.int64), WIN12,
                         SLIDE12)


def dist12_windows(path: str, want, tag: str):
    """The sink's windows (arrival order) held to the oracle exactly, as
    integer counts; sorted by key then id."""
    import types
    with np.load(path) as z:
        got = types.SimpleNamespace(keys=[z["key"]], ids=[z["id"]],
                                    vals=[z["value"].astype(np.float64)])
    rows = check_windows(got, want, tag)
    if not np.array_equal(rows[2], np.round(rows[2])):
        raise AssertionError(f"[{tag}] a count is not an integer")
    return rows


def dist12_lane(card: str, placement: str, want, tmp: str):
    """One lane of config 12: the build in this process, then across 2
    worker processes (spawn and import inside the wall, bench.py:1706;
    observe=False, bench.py:1707-1711).  Returns the 2-process windows,
    the K1 launches of both runs and the workers' probes."""
    import windflow_tpu_torch as wf
    from windflow_tpu_torch.diagnosis.report import build_report
    from windflow_tpu_torch.distributed import run_distributed
    tag = f"dist12 {placement}"
    os.environ["WINDFLOW_DIST12_N"] = str(N12)
    os.environ["WINDFLOW_DIST12_PLACEMENT"] = placement
    os.environ["WINDFLOW_DIST12_DEVICE"] = DIST_DEVICE
    os.environ["WINDFLOW_DIST12_LOG"] = os.path.join(tmp, "log")
    os.environ.pop("WINDFLOW_DIST12_PROBE", None)
    local = os.path.join(tmp, f"{placement}_1proc.npz")
    os.environ["WINDFLOW_DIST12_OUT"] = local
    g = wf.PipeGraph("bench12_local", config=dist12_config(0))
    dist12_build(g)
    reset_counts()
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the dashboard-less fallback
        g.run()
    rate_1p = N12 / (time.perf_counter() - t0)
    counts = read_counts()
    engines = device_logics(g)
    if placement == "device":
        k1_local = check_launches(f"{tag} 1proc", engines, counts,
                                  "window_sum")
    elif any(counts.values()):
        raise AssertionError(f"[{tag}] kernels {counts} on the host lane")
    else:
        k1_local = 0
    rows_1p = dist12_windows(local, want, f"{tag} 1proc")

    probe = os.path.join(tmp, f"{placement}_probe")
    os.makedirs(probe)
    os.environ["WINDFLOW_DIST12_PROBE"] = probe
    dist = os.path.join(tmp, f"{placement}_2proc.npz")
    os.environ["WINDFLOW_DIST12_OUT"] = dist
    t0 = time.perf_counter()
    report = run_distributed(dist12_build, n_workers=2,
                             config_fn=dist12_config,
                             graph_name=f"bench12_{placement}",
                             workdir=os.path.join(tmp, f"{placement}_work"),
                             timeout_s=DIST_TIMEOUT_S, observe=False)
    rate_2p = N12 / (time.perf_counter() - t0)
    os.environ.pop("WINDFLOW_DIST12_PROBE")
    merged = report["merged"]
    wire = merged.get("Wire") or {}
    cons = merged.get("Conservation") or {}
    flags = (wire.get("Balanced"), cons.get("Edges_balanced"),
             cons.get("Final_check"))
    if flags != (True, True, True):
        raise AssertionError(f"[{tag}] Wire.Balanced, Edges_balanced, "
                             f"Final_check = {flags}")
    rows = dist12_windows(dist, want, f"{tag} 2proc")
    bitwise(rows, rows_1p, f"{tag} 1proc vs 2proc")
    probes = []
    for w in (0, 1):
        with open(os.path.join(probe, f"w{w}.json")) as f:
            probes.append(json.load(f))
    if any(p["jax"] or p["reference"] for p in probes):
        raise AssertionError(f"[{tag}] a worker imported jax or the "
                             f"reference package: {probes}")
    if probes[0]["engines"] or len(probes[1]["engines"]) != 1:
        raise AssertionError(f"[{tag}] engines per worker "
                             f"{[p['engines'] for p in probes]}: the "
                             f"engine belongs to worker 1")
    (engine,) = probes[1]["engines"]
    device_launches = sum(int(r.get("Device_launches", 0) or 0)
                          for op in merged.get("Operators") or ()
                          for r in op.get("Replicas") or ())
    k1_dist = probes[1]["counts"]["window_sum"]
    if any(probes[0]["counts"].values()) or probes[0]["cuda"]:
        raise AssertionError(f"[{tag}] worker 0 owns no device engine, "
                             f"yet: {probes[0]}")
    if placement == "device":
        if engine["placement"] != "device" \
                or not engine["device"].startswith(DIST_DEVICE):
            raise AssertionError(f"[{tag}] worker 1's engine {engine}")
        # the worker's counts: K1 once a batch, no other kernel
        others = {k: v for k, v in probes[1]["counts"].items()
                  if k != "window_sum"}
        if DIST_DEVICE == "cuda" and (k1_dist <= 0
                                      or k1_dist != engine["batches"]
                                      or k1_dist != device_launches
                                      or any(others.values())):
            raise AssertionError(
                f"[{tag}] worker 1: K1 {k1_dist}, batches "
                f"{engine['batches']}, Device_launches {device_launches}, "
                f"other kernels {others}")
    elif any(probes[1]["counts"].values()) or probes[1]["cuda"] \
            or engine["placement"] != "host":
        raise AssertionError(f"[{tag}] the host lane touched the card: "
                             f"{probes[1]}")
    wire_rows = wire.get("Edges") or []
    attr = build_report(merged).get("Attribution") or {}
    if placement == "device":
        kernel = (f"K1 launches 1proc {k1_local}, worker 0 "
                  f"{probes[0]['counts']['window_sum']}, worker 1 "
                  f"{k1_dist} = batches {engine['batches']} = "
                  f"Device_launches {device_launches}")
    else:
        # the host lane's traces carry no device hop, so the diagnosis
        # plane never probes the card's round trip: no CUDA context
        kernel = (f"host lane: worker 1's engine {engine['batches']} "
                  f"batches, no kernel, no CUDA context in either worker")
    log(f"[{tag}] {N12} bids: rate {rate_2p:.1f}, rate_1proc "
        f"{rate_1p:.1f}, vs_1proc {rate_2p / rate_1p:.4f}; wire_tuples "
        f"{sum(r.get('tuples_sent', 0) for r in wire_rows)}, wire_edges "
        f"{len(wire_rows)}; traced e2e p50 {attr.get('E2e_p50_ms')} / "
        f"p99 {attr.get('E2e_p99_ms')} ms, wire class share "
        f"{(attr.get('Classes') or {}).get('wire')}; {len(rows[0])} "
        f"windows equal to the oracle and the 1-process run exactly; "
        f"Wire.Balanced, Edges_balanced, Final_check true; {kernel}; "
        f"devices "
        f"{[p['device_name'] for p in probes]}; jax in no worker "
        f"({card})")
    return rows, k1_local + k1_dist


def dist_smoke(*args) -> None:
    """``python -m windflow_tpu_torch.distributed.smoke [args]`` as a
    user runs it from the checkout; fails unless it exits 0."""
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m",
                        "windflow_tpu_torch.distributed.smoke", *args],
                       capture_output=True, text=True,
                       timeout=SMOKE_TIMEOUT_S,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
    last = (p.stdout.strip().splitlines() or [""])[-1]
    if p.returncode != 0:
        raise AssertionError(f"[dist smoke{' ' if args else ''}"
                             f"{' '.join(args)}] rc {p.returncode}: "
                             f"{last!r}, stderr {p.stderr[-600:]!r}")
    log(f"[dist smoke{' ' if args else ''}{' '.join(args)}] "
        f"{time.perf_counter() - t0:.1f} s: {last}")


def main_distributed(card: str) -> int:
    """Phase 14's cells; returns the window-sum kernel's launches (the
    device lane's, in this process and in worker 1)."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip-smoke-dist-")
    try:
        want = dist12_oracle(N12)
        host, _k1 = dist12_lane(card, "host", want, tmp)
        device, k1 = dist12_lane(card, "device", want, tmp)
        bitwise(device, host, "dist12 device vs host")
        dist_smoke()
        dist_smoke("--live")
    finally:
        for var in ("WINDFLOW_DIST12_N", "WINDFLOW_DIST12_PLACEMENT",
                    "WINDFLOW_DIST12_DEVICE", "WINDFLOW_DIST12_LOG",
                    "WINDFLOW_DIST12_OUT",
                    "WINDFLOW_DIST12_PROBE"):
            os.environ.pop(var, None)
        shutil.rmtree(tmp, ignore_errors=True)
    return k1


# ---------------------------------------------------------------------------
# 15. serving: the serving plane and the global scheduler (A10h)
# ---------------------------------------------------------------------------

# [contend K1]: the victim's device lane is config 11's template feed;
# the neighbour's endless K1 lane emits CONTEND_CHUNK events of the same
# law every CONTEND_PACE_S seconds (its windows have the same closed form)
N_CONTEND = N11
CONTEND_CHUNK = 65_536
CONTEND_PACE_S = 0.05
# the neighbour's burner farm (the reference test's 4 replicas) and the
# victim's throughput floor: the reference's SLO with its 60 records/s
# floor raised to the card's host, where the paced lane reads 786/s
# alone, 141/s beside 1 burner, 117/s beside 2 and 103/s beside 4 or 8
# (tools/burner_calibration.py, PERF.md §4): 4 burners breach it and
# the arbiter's squeeze to 1 clears it
BURNERS = 4
CONTEND_FLOOR_RPS = 125.0
# bench config 14 (bench.py:1010-1120), cut from N_EVENTS // 16 records
# to fit the script's time, and config 20 (:1123-1278) at the bench's
# count a tenant (N_EVENTS // 32 over 8) with 4 of its 8 tenants
# (PERF.md §4)
N14 = N_EVENTS // 128
N20_TENANT = N_EVENTS // 32 // 8
N20_TENANTS = 4
N_FLEET_K1 = N11
# the tenants' device (the CPU only to rehearse the phase without a card)
SERVE_DEVICE = "cuda"
SERVE_WAIT_S = 180.0


def serve_config(log_dir: str, **kw):
    """A tenant's RuntimeConfig: its device lanes on SERVE_DEVICE, the
    elastic controller off (the arbiter alone rescales), logs under
    ``log_dir``."""
    import windflow_tpu_torch as wf
    from windflow_tpu_torch.elastic import ElasticityConfig
    kw.setdefault("elasticity", ElasticityConfig(enabled=False))
    return wf.RuntimeConfig(device=SERVE_DEVICE, log_dir=log_dir, **kw)


def paced_records(n: int, pace_s: float, counter: dict):
    """The reference chaos test's SLO lane: key i % 4, id i // 4, one
    record every ``pace_s``."""
    import windflow_tpu_torch as wf

    def fn(shipper, ctx):
        i = counter["sent"]
        if i >= n:
            return False
        time.sleep(pace_s)
        shipper.push(wf.BasicRecord(i % 4, i // 4, i, float(i)))
        counter["sent"] = i + 1
        return True

    return fn


def burner_records(stop: threading.Event):
    import windflow_tpu_torch as wf
    state = {"i": 0}

    def fn(shipper, ctx):
        if stop.is_set():
            return False
        i = state["i"]
        shipper.push(wf.BasicRecord(i % 64, i, i, 1.0))
        state["i"] = i + 1
        return True

    return fn


def burn_10ms(t):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 0.01:
        pass
    return None


def paced_template(stop: threading.Event, counter: dict):
    """``template_source``'s law (event e: key e % 64, id = ts = e // 64,
    value pool[e % SOURCE_BATCH]) in chunks of CONTEND_CHUNK events, one
    every CONTEND_PACE_S, until ``stop``; ``counter["sent"]`` counts
    the events, so ``template_oracle`` of it is the lane's closed form."""
    from windflow_tpu_torch.core.tuples import TupleBatch
    pool = np.random.default_rng(0).random(SOURCE_BATCH).astype(np.float32)

    def source(ctx):
        if stop.is_set():
            return None
        time.sleep(CONTEND_PACE_S)
        i = counter["sent"]
        idx = np.arange(i, i + CONTEND_CHUNK, dtype=np.int64)
        counter["sent"] = i + CONTEND_CHUNK
        return TupleBatch({"key": idx % N_KEYS, "id": idx // N_KEYS,
                           "ts": idx // N_KEYS,
                           "value": pool[idx % SOURCE_BATCH]})

    return source


class EndSink(WindowSink):
    """A ``WindowSink`` that notes when the end of its stream arrives
    and how many windows it holds."""

    def __init__(self):
        super().__init__()
        self.end_t = None

    def __call__(self, item):
        if item is None:
            self.end_t = time.perf_counter()
        super().__call__(item)

    def count(self) -> int:
        with self.lock:
            return sum(len(k) for k in self.keys)


def wait_until(tag: str, pred, what: str, timeout: float = SERVE_WAIT_S,
               detail=None):
    """Poll ``pred`` until it holds; on timeout fail with ``detail()``."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return time.perf_counter()
        time.sleep(0.02)
    raise AssertionError(f"[{tag}] {what} within {timeout} s"
                         + (f": {detail()}" if detail is not None else ""))


def tenant_detail(srv, counters: dict):
    """What a stuck serving cell shows: each tenant's state and error,
    its Slo block and flight kinds, and the given counters."""
    def detail():
        rows = {}
        for name, h in srv.tenants().items():
            doc = json.loads(h.graph.stats.to_json(0, 0))
            rows[name] = {"state": h.state, "error": repr(h.error),
                          "slo": doc.get("Slo"),
                          "flight": dict(collections.Counter(
                              e["kind"] for e in h.graph.flight.snapshot()))}
        return {"tenants": rows, "decisions": list(srv.arbiter.decisions)
                if srv.arbiter is not None else None, **counters}
    return detail


def first_event(g, kind: str):
    return next((e for e in g.flight.snapshot() if e["kind"] == kind), None)


def recovered_after_a_decision(srv, victim) -> bool:
    """The arbiter has decided, and the victim's SLO recovered after its
    first ``arbitration`` event (an episode that closes before
    ``breach_ticks`` elapse is not the one under test)."""
    if not srv.arbiter.decisions:
        return False
    evs = victim.graph.flight.snapshot()
    first = next((e["seq"] for e in evs if e["kind"] == "arbitration"),
                 None)
    return first is not None and any(
        e["kind"] == "slo_recovered" and e["seq"] > first for e in evs)


def contend_k1(card: str, tmp: str, want):
    """[contend K1]: the reference's
    ``test_contended_chip_arbiter_demotes_neighbor_slo_recovers``
    (tests/test_scheduler.py:448-605) at deployment size on the card.
    Under ``Server(devices=1)`` the victim (priority 5, the reference's
    throughput SLO) runs the paced record lane and config 11's K1 lane
    over N_CONTEND events; the neighbour (priority 0) runs the burner
    farm (BURNERS replicas) and an endless paced K1 lane until the cell
    ends.  Gates: the
    reference test's, plus the victim's windows bitwise its solo run on
    the card and within RTOL_F32 of the closed form, K1's launches =
    the victim's batches + the neighbour's batches at its flip (none
    after it), and the neighbour's windows one gap-free sequence per
    key across the flip, equal to their closed form.  Returns K1's
    launches in the contended run and the solo run's windows."""
    import windflow_tpu_torch as wf
    from windflow_tpu_torch.operators.basic_ops import Sink
    from windflow_tpu_torch.operators.batch_ops import BatchSource
    from windflow_tpu_torch.serving import ArbiterConfig, Server, TenantSpec
    tag = "contend K1"
    t_cell = time.perf_counter()
    solo = WindowSink()
    g = wf.PipeGraph("contend_solo", wf.Mode.DEFAULT,
                     serve_config(f"{tmp}/solo"))
    g.add_source(BatchSource(template_source(N_CONTEND), 1)) \
        .add(config11_op()).add_sink(Sink(solo))
    reset_counts()
    t0 = time.perf_counter()
    g.run()
    solo_rate = N_CONTEND / (time.perf_counter() - t0)
    k1_solo = check_launches(f"{tag} solo", find_logic(g), read_counts(),
                             "window_sum")
    solo_rows = solo.sorted()
    hold_lanes(f"{tag} solo", [(None, solo_rows)], want)

    stop = threading.Event()
    vrec = {"sent": 0}
    nsent = {"sent": 0}
    vsink, nsink = EndSink(), EndSink()
    flip = {}
    srv = Server(capacity=1 << 16, devices=1, arbiter=ArbiterConfig(
        interval_s=0.25, breach_ticks=2, cooldown_s=1.0,
        clear_ticks=10 ** 6))
    try:
        def build_victim(g):
            g.add_source(wf.SourceBuilder(
                paced_records(10 ** 6, 0.001, vrec)).build()) \
                .add(wf.MapBuilder(lambda t: None).with_name("vmap")
                     .build()) \
                .add_sink(wf.SinkBuilder(lambda r: None).build())
            g.add_source(BatchSource(template_source(N_CONTEND), 1)) \
                .add(config11_op()).add_sink(Sink(vsink))

        def build_noisy(g):
            g.add_source(wf.SourceBuilder(burner_records(stop)).build()) \
                .add(wf.MapBuilder(burn_10ms).with_name("burn")
                     .with_key_by().with_parallelism(BURNERS)
                     .with_elasticity(1, BURNERS).build()) \
                .add_sink(wf.SinkBuilder(lambda r: None).build())
            g.add_source(BatchSource(paced_template(stop, nsent), 1)) \
                .add(config11_op()).add_sink(Sink(nsink))

        reset_counts()
        t_v = time.perf_counter()
        hv = srv.submit(
            "vic", build_victim,
            TenantSpec(credits=1024, priority=5,
                       slo=dict(min_throughput_rps=CONTEND_FLOOR_RPS,
                                target=0.9,
                                fast_window_s=3.0, slow_window_s=30.0,
                                warmup_ticks=1, fast_burn=2.0)),
            config=serve_config(f"{tmp}/vic", diagnosis_interval_s=0.2,
                                audit_interval_s=0.1))
        t_n, t_n_wall = time.perf_counter(), time.time()
        hn = srv.submit("noisy", build_noisy,
                        TenantSpec(credits=4096, priority=0),
                        config=serve_config(f"{tmp}/noisy",
                                            queue_capacity=32))
        for h in (hv, hn):
            if h.state != "RUNNING":
                raise AssertionError(f"[{tag}] tenant {h.name} {h.state}: "
                                     f"{h.error!r}")
        if not srv.devices.contended():
            raise AssertionError(f"[{tag}] two device lanes on one card "
                                 f"must contend: {srv.devices.block()}")
        leases = srv.devices.rows()
        chip = "cuda:0"
        if {r["Chip"] for r in leases} != {chip} or len(leases) != 2:
            raise AssertionError(f"[{tag}] lease rows {leases}")
        vlogic, nlogic = find_logic(hv.graph), find_logic(hn.graph)
        orig = nlogic.apply_placement

        def spy(placement, rtt_floor_ms=None):
            # called inside replace_lane's quiesce: no batch in flight,
            # so the engine's batches are its device launches
            if placement == "host" and "batches" not in flip:
                flip.update(batches=nlogic.launched_batches,
                            windows=nsink.count(),
                            t=time.perf_counter())
            return orig(placement, rtt_floor_ms=rtt_floor_ms)

        nlogic.apply_placement = spy
        detail = tenant_detail(srv, {"victim records": vrec,
                                     "neighbour events": nsent})
        wait_until(tag, lambda: hv.graph.diagnosis.slo is not None
                   and hv.graph.diagnosis.slo.breached,
                   "the victim breached under contention", timeout=60.0,
                   detail=detail)
        wait_until(tag, lambda: recovered_after_a_decision(srv, hv),
                   "the victim's SLO recovered after an arbitration",
                   detail=detail)
        decisions = list(srv.arbiter.decisions)
        dev = [a for d in decisions for a in d["actions"]
               if a["type"] == "device"]
        first = decisions[0]
        if not (dev and dev[0].get("applied") and dev[0]["to"] == "host"
                and any(a["type"] == "device" for a in first["actions"])
                and (first["donor"], first["victim"]) == ("noisy", "vic")
                and first["evidence"].get("contended") is True):
            raise AssertionError(f"[{tag}] the first decision is not an "
                                 f"applied device demotion noisy -> vic: "
                                 f"{decisions}")
        repl = [e for e in hn.graph.flight.snapshot()
                if e["kind"] == "replacement"]
        if not any("arbiter:device->host for vic" in (e.get("trigger") or "")
                   for e in repl):
            raise AssertionError(f"[{tag}] no arbiter replacement: {repl}")
        if srv.devices.tenant_rows("noisy") or srv.devices.contended() \
                or not srv.devices.tenant_rows("vic"):
            raise AssertionError(f"[{tag}] leases after the demotion: "
                                 f"{srv.devices.block()}")
        for h in (hv, hn):
            if not any("demoted" in (e.get("action") or "")
                       for e in h.graph.flight.snapshot()
                       if e["kind"] == "arbitration"):
                raise AssertionError(f"[{tag}] {h.name}'s flight names no "
                                     f"demotion")
        blk = srv.scheduler_block()["Devices"]
        if blk["Holders"] != 1 or blk["Contended"] is not False:
            raise AssertionError(f"[{tag}] Devices block {blk}")
        wait_until(tag, lambda: vsink.end_t is not None,
                   "the victim's K1 lane ended")
        # the neighbour's host lane goes on: let it close windows past
        # the flip, then end its sources
        wait_until(tag, lambda: nsink.count() > flip["windows"],
                   "the neighbour's host lane emitted a window")
        stop.set()
        if hn.wait(SERVE_WAIT_S) != "COMPLETED":
            raise AssertionError(f"[{tag}] neighbour {hn.state}: "
                                 f"{hn.error!r}")
        t_end = time.perf_counter()
        counts = read_counts()
        # the episode the demotion answered: the last breach before the
        # flip, and the first recovery after it
        ev_r = first_event(hn.graph, "replacement")
        vev = hv.graph.flight.snapshot()
        ev_b = [e for e in vev if e["kind"] == "slo_breach"
                and e["t"] <= ev_r["t"]][-1]
        ev_s = next(e for e in vev if e["kind"] == "slo_recovered"
                    and e["t"] > ev_r["t"])
        vrecs = vrec["sent"]
        arbs = srv.arbiter.decisions_total
    finally:
        stop.set()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            srv.close()
    # K1: the victim's batches and the neighbour's up to its flip
    if not flip:
        raise AssertionError(f"[{tag}] the neighbour's lane never flipped")
    others = {k: v for k, v in counts.items() if k != "window_sum"}
    if SERVE_DEVICE == "cuda" and (
            counts["window_sum"] != vlogic.launched_batches + flip["batches"]
            or any(others.values())) or flip["batches"] <= 0:
        raise AssertionError(
            f"[{tag}] K1 launches {counts['window_sum']} != victim batches "
            f"{vlogic.launched_batches} + the neighbour's batches at its "
            f"flip {flip['batches']} (other kernels {others})")
    if nlogic.launched_batches <= flip["batches"]:
        raise AssertionError(f"[{tag}] the neighbour's host lane made no "
                             f"batch after the flip")
    vrows = vsink.sorted()
    bitwise(vrows, solo_rows, f"{tag} victim vs solo")
    nrows = check_windows(nsink, template_oracle(nsent["sent"]),
                          f"{tag} neighbour", rtol=RTOL_F32)
    v_rate = N_CONTEND / (vsink.end_t - t_v)
    n_rate = nsent["sent"] / (t_end - t_n)
    log(f"[{tag}] Server(devices=1), two K1 tenants on {chip}: contended "
        f"at submit (2 lease rows); submit -> breach "
        f"{ev_b['t'] - t_n_wall:.3f} s, breach -> demotion "
        f"{ev_r['t'] - ev_b['t']:.3f} s (replace_lane "
        f"{ev_r['duration_ms']} ms), demotion -> slo_recovered "
        f"{ev_s['t'] - ev_r['t']:.3f} s; {arbs} decisions, the first "
        f"{first['actions'][0]}; victim: {N_CONTEND} events at "
        f"{v_rate:.1f} tuples/s (solo {solo_rate:.1f}), "
        f"{len(vrows[0])} windows bitwise its solo run and within "
        f"{RTOL_F32} of the closed form, {vrecs} paced records in "
        f"{t_end - t_v:.1f} s ({vrecs / (t_end - t_v):.1f}/s); neighbour: "
        f"{nsent['sent']} events at {n_rate:.1f} tuples/s, "
        f"{len(nrows[0])} windows gap-free per key across the flip and "
        f"within {RTOL_F32} of the closed form ({flip['windows']} before "
        f"it); K1 launches {counts['window_sum']} = victim "
        f"{vlogic.launched_batches} + neighbour {flip['batches']} at its "
        f"flip (then {nlogic.launched_batches - flip['batches']} host "
        f"batches, no K1); solo K1 {k1_solo} = batches; "
        f"{time.perf_counter() - t_cell:.1f} s ({card})")
    return counts["window_sum"] + k1_solo, solo_rows


def bench_records(n: int, acc: dict):
    """bench.py's config 14/20 tenant graph (:1036-1056): n records
    (key i % 8, id = ts = i // 8, value i % 101) through a map scaling
    the value by 1.0001 into a sink folding (count, sum)."""
    import windflow_tpu_torch as wf

    def build(g):
        state = {"i": 0}

        def src(shipper):
            i = state["i"]
            if i >= n:
                return False
            shipper.push(wf.BasicRecord(i % 8, i // 8, i // 8,
                                        float(i % 101)))
            state["i"] = i + 1
            return True

        def sink(r):
            if r is not None:
                acc["n"] += 1
                acc["sum"] += r.value

        g.add_source(wf.SourceBuilder(src).build()) \
            .add(wf.MapBuilder(lambda t: wf.BasicRecord(
                t.key, t.id, t.ts, t.value * 1.0001)).build()) \
            .add_sink(wf.SinkBuilder(sink).build())

    return build


def latency_row(name: str, records: int, rate: float, e2e) -> dict:
    e2e = e2e or {}
    return {"tenant": name, "records": records, "rate": round(rate, 1),
            "p50_ms": round((e2e.get("p50_us") or 0) / 1e3, 3),
            "p99_ms": round((e2e.get("p99_us") or 0) / 1e3, 3)}


def serve14(card: str, tmp: str) -> None:
    """[serve14]: bench config 14 (``run_multitenant_contention``,
    bench.py:1010-1120) on the port: 3 record-plane tenants under one
    ``Server(capacity=3 * 4096)`` over N14 records, then one tenant
    uncontended with the arbiter on and off.  Gates: every tenant
    COMPLETED, the A/B's (count, sum) bitwise identical, zero decisions,
    no kernel launched."""
    import windflow_tpu_torch as wf
    from windflow_tpu_torch.serving import ArbiterConfig, Server, TenantSpec
    t_cell = time.perf_counter()
    n_tenants = 3
    per_n = N14 // n_tenants

    def cfg():
        return serve_config(f"{tmp}/serve14", trace_sample=16)

    reset_counts()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        srv = Server(capacity=n_tenants * 4096, arbiter=ArbiterConfig())
        try:
            accs = [{"n": 0, "sum": 0.0} for _ in range(n_tenants)]
            t0 = time.perf_counter()
            handles = [srv.submit(f"bench14-t{i}",
                                  bench_records(per_n, accs[i]),
                                  TenantSpec(credits=4096, priority=i),
                                  config=cfg()) for i in range(n_tenants)]
            for h in handles:
                if h.wait(SERVE_WAIT_S) != "COMPLETED":
                    raise AssertionError(f"[serve14] {h.name} {h.state}: "
                                         f"{h.error!r}")
            dt = time.perf_counter() - t0
            rows = [latency_row(h.name, accs[i]["n"], accs[i]["n"] / dt,
                                json.loads(h.graph.stats.to_json(0, 0))
                                .get("Latency_e2e"))
                    for i, h in enumerate(handles)]
        finally:
            srv.close()

        def one(arbiter):
            acc = {"n": 0, "sum": 0.0}
            s = Server(capacity=1 << 14, arbiter=arbiter)
            try:
                t1 = time.perf_counter()
                h = s.submit("bench14-ab", bench_records(per_n, acc),
                             TenantSpec(credits=4096), config=cfg())
                if h.wait(SERVE_WAIT_S) != "COMPLETED":
                    raise AssertionError(f"[serve14] A/B {h.state}: "
                                         f"{h.error!r}")
                secs = time.perf_counter() - t1
                decisions = len(s.arbiter.decisions) \
                    if s.arbiter is not None else 0
            finally:
                s.close()
            return acc, decisions, per_n / secs

        acc_on, decisions_on, rate_on = one(ArbiterConfig(interval_s=0.2))
        acc_off, _, rate_off = one(False)
    counts = read_counts()
    if acc_on != acc_off or decisions_on != 0 or any(counts.values()):
        raise AssertionError(f"[serve14] A/B {acc_on} vs {acc_off}, "
                             f"{decisions_on} decisions, kernels {counts}")
    if any(r["records"] != per_n for r in rows):
        raise AssertionError(f"[serve14] records {rows}")
    total = sum(r["records"] for r in rows) / dt
    log(f"[serve14] {n_tenants} tenants x {per_n} records under one "
        f"Server(capacity={n_tenants * 4096}): total {total:.1f} "
        f"records/s; {rows}; A/B one tenant: arbiter on {rate_on:.1f}, "
        f"off {rate_off:.1f} records/s, (count, sum) bitwise identical "
        f"{acc_on}, 0 decisions; no kernel launched; "
        f"{time.perf_counter() - t_cell:.1f} s ({card})")


FLEET_HOSTED = []  # the tenant graphs this fleet worker built


def register_fleet_probe(g) -> None:
    """Count ``g`` into this fleet worker's exit probe: at exit the
    worker writes :func:`probe_doc` of every tenant graph it built to
    ``<WINDFLOW_SERVE_PROBE>/p<pid>.json``."""
    import atexit
    out_dir = os.environ.get("WINDFLOW_SERVE_PROBE")
    if not out_dir:
        return
    if not FLEET_HOSTED:
        atexit.register(write_fleet_probe, out_dir)
    FLEET_HOSTED.append(g)


def write_fleet_probe(out_dir: str) -> None:
    with open(os.path.join(out_dir, f"p{os.getpid()}.json"), "w") as f:
        json.dump(probe_doc(FLEET_HOSTED), f)


def read_fleet_probes(out_dir: str, tag: str, n_workers: int) -> list:
    docs = []
    for name in sorted(os.listdir(out_dir)):
        with open(os.path.join(out_dir, name)) as f:
            docs.append(json.load(f))
    if len(docs) != n_workers:
        raise AssertionError(f"[{tag}] {len(docs)} worker probes, not "
                             f"{n_workers}: {docs}")
    return docs


def bench20_build(g):
    """Worker-side tenant graph of bench config 20 (bench.py:1137-1156)
    on the port: WINDFLOW_SERVE20_N records.  Fleet workers load it from
    this file, executed under an alias, so ``main`` does not run
    there."""
    bench_records(int(os.environ["WINDFLOW_SERVE20_N"]),
                  {"n": 0, "sum": 0.0})(g)
    register_fleet_probe(g)


def bench20_config():
    """bench20's worker config (bench.py:1125-1134): its tenants' device
    (WINDFLOW_SERVE_DEVICE) and logs (WINDFLOW_SERVE_LOG) set by the
    fleet's caller."""
    from windflow_tpu_torch.elastic import ElasticityConfig
    import windflow_tpu_torch as wf
    return wf.RuntimeConfig(trace_sample=16,
                            device=os.environ["WINDFLOW_SERVE_DEVICE"],
                            log_dir=os.environ["WINDFLOW_SERVE_LOG"],
                            elasticity=ElasticityConfig(enabled=False))


def fleet_k1_build(g):
    """Worker-side K1 tenant: config 11's template feed over
    WINDFLOW_FLEETK1_N events through its WinSeqTPU; the sink writes its
    windows to <WINDFLOW_FLEETK1_OUT>/<tenant>.npz at the end."""
    from windflow_tpu_torch.operators.basic_ops import Sink
    from windflow_tpu_torch.operators.batch_ops import BatchSource
    out = os.path.join(os.environ["WINDFLOW_FLEETK1_OUT"], f"{g.name}.npz")
    sink = WindowSink()

    def on_item(item):
        sink(item)
        if item is None:
            k, i, v = sink.sorted()
            np.savez(out, key=k, id=i, value=v)

    g.add_source(BatchSource(
        template_source(int(os.environ["WINDFLOW_FLEETK1_N"])), 1)) \
        .add(config11_op()).add_sink(Sink(on_item))
    register_fleet_probe(g)


def run_fleet(tmp: str, tag: str, env: dict, tenants: list,
              n_workers: int = 2):
    """Submit ``tenants`` ((name, build, spec) triples) to a FleetServer
    of ``n_workers`` workers, wait for each and close the fleet.
    Returns each tenant's worker, its final row, the seconds from the
    first submit to the last end, the fleet's flight events and the
    workers' exit probes."""
    from windflow_tpu_torch.scheduler import FleetServer
    probe = os.path.join(tmp, f"{tag}_probe")
    os.makedirs(probe)
    env = dict(env, WINDFLOW_SERVE_DEVICE=SERVE_DEVICE,
               WINDFLOW_SERVE_LOG=os.path.join(tmp, f"{tag}_log"),
               WINDFLOW_SERVE_PROBE=probe)
    os.environ.update(env)
    try:
        fleet = FleetServer(workers=n_workers,
                            capacity=len(tenants) * 4096,
                            push_interval_s=0.2,
                            log_dir=os.path.join(tmp, f"{tag}_workers"))
        try:
            t0 = time.perf_counter()
            placed = {name: fleet.submit(name, build, spec,
                                         config_fn=bench20_config)["Worker"]
                      for name, build, spec in tenants}
            rows = {name: fleet.wait(name, timeout=SERVE_WAIT_S)
                    for name in placed}
            secs = time.perf_counter() - t0
            flight = fleet.stats()["Flight"]
        finally:
            fleet.close()
    finally:
        for var in env:
            os.environ.pop(var, None)
    return placed, rows, secs, flight, read_fleet_probes(probe, tag,
                                                         n_workers)


def check_fleet_probes(tag: str, probes: list, placed: dict) -> None:
    """Each worker's exit probe: no jax, no reference package, no
    FlatFAT kernel, K1 launches equal to its engines' batches, a CUDA
    context exactly where a device lane ran, and its engines those of
    the tenants placed on it."""
    for p in probes:
        device = [e for e in p["engines"] if e["placement"] == "device"]
        batches = sum(e["batches"] for e in device)
        others = {k: v for k, v in p["counts"].items() if k != "window_sum"}
        k1_ok = (p["counts"]["window_sum"] == batches
                 and p["cuda"] == bool(device)) if SERVE_DEVICE == "cuda" \
            else p["counts"]["window_sum"] == 0
        workers = {placed[e["tenant"]] for e in p["engines"]}
        if p["jax"] or p["reference"] or any(others.values()) or not k1_ok \
                or len(workers) > 1:
            raise AssertionError(f"[{tag}] worker probe {p}")


def sched20(card: str, tmp: str) -> None:
    """[sched20]: bench config 20 (``run_global_scheduler``,
    bench.py:1158-1278) at the bench's count a tenant: N20_TENANTS
    record tenants placed by ``plan_placement`` over a FleetServer of 2
    workers, then one tenant in-process with the scheduler plane on and
    off.  Gates: every worker used, every tenant COMPLETED with
    ``Edges_balanced``, the A/B identical, ``Sched_wait_s`` 0.0, and
    each worker's exit probe: no jax, no kernel and no CUDA context (no
    device lane ran there)."""
    from windflow_tpu_torch.serving import Server, TenantSpec
    t_cell = time.perf_counter()
    n_workers = 2
    per_n = N20_TENANT
    names = [f"bench20-t{i}" for i in range(N20_TENANTS)]
    reset_counts()
    placed, rows, dt, flight, probes = run_fleet(
        tmp, "sched20", {"WINDFLOW_SERVE20_N": str(per_n)},
        [(name, bench20_build, TenantSpec(credits=4096, priority=i % 3))
         for i, name in enumerate(names)], n_workers)
    bad = [r for r in rows.values() if r["State"] != "COMPLETED"
           or not (r.get("Conservation") or {}).get("Edges_balanced")]
    if len(set(placed.values())) != n_workers or bad:
        raise AssertionError(f"[sched20] placements {placed}; tenants not "
                             f"COMPLETED or unbalanced: {bad}")
    check_fleet_probes("sched20", probes, placed)
    if any(p["cuda"] or p["engines"] or any(p["counts"].values())
           for p in probes):
        raise AssertionError(f"[sched20] a record worker touched the "
                             f"card: {probes}")
    per_tenant = [latency_row(name, per_n, per_n / dt,
                              rows[name].get("Latency_e2e"))
                  for name in names]

    def one(scheduled):
        acc = {"n": 0, "sum": 0.0}
        extra = ({"fair_share": True, "devices": 1, "worker_id": 0}
                 if scheduled else {})
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            srv = Server(capacity=1 << 14, arbiter=False, **extra)
            try:
                h = srv.submit("bench20-ab", bench_records(per_n, acc),
                               TenantSpec(credits=4096),
                               config=serve_config(f"{tmp}/sched20",
                                                   trace_sample=16))
                if h.wait(SERVE_WAIT_S) != "COMPLETED":
                    raise AssertionError(f"[sched20] A/B {h.state}: "
                                         f"{h.error!r}")
                wait_s = srv.scheduler_block()["Sched_wait_s"] \
                    if scheduled else None
            finally:
                srv.close()
        return acc, wait_s

    acc_on, wait_on = one(True)
    acc_off, _ = one(False)
    counts = read_counts()
    if acc_on != acc_off or wait_on != 0.0 or any(counts.values()):
        raise AssertionError(f"[sched20] A/B {acc_on} vs {acc_off}, "
                             f"Sched_wait_s {wait_on}, kernels {counts}")
    kinds = collections.Counter(e["kind"] for e in flight)
    log(f"[sched20] {N20_TENANTS} tenants x {per_n} records over "
        f"{n_workers} FleetServer workers (placements "
        f"{sorted(placed.items())}): total "
        f"{N20_TENANTS * per_n / dt:.1f} records/s in {dt:.1f} s; "
        f"{per_tenant}; every tenant COMPLETED, Edges_balanced; worker "
        f"probes: no kernel, no CUDA context, no jax; A/B in-process "
        f"(count, sum) identical {acc_on}, Sched_wait_s {wait_on}; flight "
        f"{dict(kinds)}; {time.perf_counter() - t_cell:.1f} s ({card})")


def fleet_k1(card: str, tmp: str, solo_rows) -> int:
    """[fleet K1]: two ``TenantSpec(devices=1)`` tenants, each config
    11's K1 lane over N_FLEET_K1 events, on a FleetServer of 2 workers.
    Gates: placed on different workers, each one's windows bitwise
    [contend K1]'s solo run, each worker's exit probe: K1 launches =
    its engines' batches, a CUDA context where its device lane ran, no
    jax.  Returns the workers' K1 launches."""
    from windflow_tpu_torch.serving import TenantSpec
    t_cell = time.perf_counter()
    out = os.path.join(tmp, "fleet_k1")
    os.makedirs(out)
    names = ("fleet-k1-a", "fleet-k1-b")
    placed, rows, secs, _flight, probes = run_fleet(
        tmp, "fleet_k1", {"WINDFLOW_FLEETK1_N": str(N_FLEET_K1),
                          "WINDFLOW_FLEETK1_OUT": out},
        [(name, fleet_k1_build, TenantSpec(credits=4096, devices=1))
         for name in names])
    if sorted(placed.values()) != [0, 1]:
        raise AssertionError(f"[fleet K1] placements {placed}")
    for name, row in rows.items():
        if row["State"] != "COMPLETED":
            raise AssertionError(f"[fleet K1] {name}: {row}")
        with np.load(os.path.join(out, f"{name}.npz")) as z:
            got = (z["key"], z["id"], z["value"])
        bitwise(got, solo_rows, f"fleet K1 {name} vs [contend K1] solo")
    check_fleet_probes("fleet K1", probes, placed)
    if sorted(e["tenant"] for p in probes for e in p["engines"]) \
            != sorted(names) \
            or any(e["batches"] == 0 for p in probes for e in p["engines"]):
        raise AssertionError(f"[fleet K1] worker probes {probes}")
    probe_rows = [(placed[p["engines"][0]["tenant"]],
                   p["counts"]["window_sum"],
                   [(e["tenant"], e["batches"]) for e in p["engines"]],
                   p["cuda"], p["device_name"]) for p in probes]
    log(f"[fleet K1] two TenantSpec(devices=1) K1 tenants placed on "
        f"workers {placed}, {N_FLEET_K1} events each in {secs:.1f} s "
        f"(spawned workers, K1 from the checkout's build): windows bitwise "
        f"[contend K1]'s solo run; worker probes: {sorted(probe_rows)} "
        f"(worker, K1 launches, engines and batches, CUDA context, card); "
        f"jax in no worker; {time.perf_counter() - t_cell:.1f} s ({card})")
    return sum(p["counts"]["window_sum"] for p in probes)


def main_serving(card: str) -> int:
    """Phase 15's cells; returns the window-sum kernel's launches (this
    process's and the fleet workers')."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip-smoke-serve-")
    try:
        k1, solo_rows = contend_k1(card, tmp, template_oracle(N_CONTEND))
        serve14(card, tmp)
        sched20(card, tmp)
        k1 += fleet_k1(card, tmp, solo_rows)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return k1


# ---------------------------------------------------------------------------
# 16. mesh: the mesh plane on logical shards of the card
# ---------------------------------------------------------------------------

# [mesh kf4]: bench config 4's feed and window (bench.py:530-551: 64 keys,
# TB 4096 / 2048, value e % 97, source batches of 2^20 as TupleBatches)
# at its 32M events through KeyFarmMesh on 8 logical key shards
N_MESH = N34
MESH_BATCH_WINDOWS = 1024
# the other cells' depth: config 4's, the striped WMR's cut for the
# script's time (PERF.md §4)
N_MESH_KINDS = N34
N_MESH_PF = N34
N_MESH_WMR = N34 // 4
# config 3's window has 2 panes of 2048, so its ring is one hop at any
# epoch size; the 8-ring cell slides by 512 (8 panes a window, 2 panes a
# shard at 16 panes an epoch): 4 hops
PF_RING_SLIDE = 512
PF_RING_EPOCH = 16
# [mesh step]: the dry run's mesh (__graft_entry__.py:55-60, 8 devices,
# win_axis 2) at config 4's window and the KF cell's widths
STEP_T, STEP_STRIPE_B, STEP_PANES = 1 << 19, 16, 8
# the mesh cells' device (the CPU only to rehearse the phase)
MESH_DEVICE = "cuda"


def record_calls(engine, name: str, into: dict) -> None:
    """Keep the arguments of ``engine``'s last ``name`` call: the launch
    shape the cell gave it."""
    fn = getattr(engine, name)

    def wrapped(*args):
        into[name] = args
        return fn(*args)

    setattr(engine, name, wrapped)


def mesh_oracle(n_events: int, win: int, slide: int, kind: str = "sum"):
    """(keys, ids, values) of every window of the headline's law (key k,
    ts t, value (t*64 + k) % 97) under TB windows ``win`` / ``slide``
    folded by ``kind`` ('sum', 'max', 'logaddexp'), float64, partial
    tail windows flushed at EOS: blocks of gcd(win, slide) ticks folded,
    then each window's blocks."""
    M = n_events // N_KEYS
    pane = int(np.gcd(win, slide))
    wpp, spp = win // pane, slide // pane
    n_blocks = -(-M // pane)
    n_win = (M - 1) // slide + 1
    # block n_blocks is the neutral: windows past the stream's end
    idx = np.minimum(np.arange(n_win)[:, None] * spp + np.arange(wpp),
                     n_blocks)
    t = np.arange(n_blocks * pane)
    neutral = 0.0 if kind == "sum" else -np.inf
    vals = []
    with np.errstate(invalid="ignore"):
        for k in range(N_KEYS):
            v = ((t * N_KEYS + k) % VMOD).astype(np.float64)
            v[M:] = neutral
            b = v.reshape(n_blocks, pane)
            if kind == "sum":
                blocks = b.sum(1)
            elif kind == "max":
                blocks = b.max(1)
            else:
                m = b.max(1)
                blocks = m + np.log(np.exp(b - m[:, None]).sum(1))
            w = np.append(blocks, neutral)[idx]
            vals.append(w.sum(1) if kind == "sum" else w.max(1)
                        if kind == "max" else np.logaddexp.reduce(w, 1))
    return (np.repeat(np.arange(N_KEYS), n_win),
            np.tile(np.arange(n_win), N_KEYS), np.concatenate(vals))


def queued_ms(fn, reps: int = 50) -> float:
    """Device ms a call from CUDA events around ``reps`` calls queued
    behind a sleep kernel, so the card never waits for the host between
    them (each call's device time and the gap between launches)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def kernel_timed(fn):
    """(device ms, wall ms) a call from device_timed (torch.profiler
    missed K2r in a run of phase 16 alone, and a sparse mv and
    compute_wmr in a run of the whole script)."""
    ms, _source, wall = device_timed(fn)
    return ms, wall


def flat_extents(starts, ends, stride: int):
    """[S, B] per-shard extents as one flat pair into the [S, stride]
    buffer laid end to end (compute_kf's one-launch layout)."""
    off = np.arange(starts.shape[0], dtype=np.int64)[:, None] * stride
    return ((starts + off).reshape(-1), (ends + off).reshape(-1))


def mesh_cell(tag: str, make_op, n: int, cls, closing=None):
    """One mesh graph on the card through PipeGraph -> source (the
    headline law as TupleBatches, stamped) -> mesh operator -> Sink,
    every kernel count set to 0 just before and read just after.
    Returns (logic, counts, user counts, sink, seconds)."""
    from windflow_tpu_torch.ops.cuda import flatfat_query as fq
    reset_counts()
    g, sink, secs = run_main(n, MESH_DEVICE, make_op, materialize=True,
                             closing=closing)
    counts, users = read_counts(), dict(fq.user_launch_counts())
    logic = find_logic(g, cls)
    if logic.engine.device.type != MESH_DEVICE:
        raise AssertionError(f"[{tag}] engine on {logic.engine.device}")
    return logic, counts, users, sink, secs


def feed_line(tag: str, n: int, secs: float, sink) -> str:
    p50, p99 = (float(np.percentile(sink.lats, q)) * 1e3 for q in (50, 99))
    return (f"[{tag}] {n} events in {secs:.3f} s = {n / secs:.1f} "
            f"tuples/s; window latency p50 {p50:.3f} ms, p99 {p99:.3f} ms")


def mesh_line(tag: str, n: int, secs: float, sink, logic) -> str:
    return (f"{feed_line(tag, n, secs, sink)}; {logic.launched_batches} "
            f"batches")



def k1_at_mesh_shape(tag: str, args, card: str) -> str:
    """K1 at the cell's last launch (every shard's row laid end to end):
    exact against the float64 sums on the launch's own values, and on
    integer values drawn so that every prefix stays below 2^24 (as phase
    3 draws them) exact against its plain version too; device time, the
    bound, the plain version's and a sparse CSR mv's."""
    from windflow_tpu_torch.ops.cuda import window_sum as ws
    values, starts, ends = args
    S, T = values.shape
    s, e = flat_extents(starts, ends, T)
    dev = torch.device(MESH_DEVICE)
    se = pack(s, e, dev)
    hint = int((e - s).max())
    v = torch.from_numpy(np.ascontiguousarray(values.reshape(-1))).to(dev)
    ints = np.random.default_rng(16).integers(
        0, max(2, (1 << 24) // (S * T)), S * T).astype(np.float32)
    vi = torch.from_numpy(ints).to(dev)
    for name, x, host in (("launch", v, values.reshape(-1)),
                          ("bounded", vi, ints)):
        k = ws.window_sums(x, se, hint).cpu().numpy()
        ref = float64_sums(host, s, e)
        if not np.array_equal(k, ref):
            raise AssertionError(f"[{tag}] K1 at the mesh shape ({name} "
                                 f"values) not exact: err "
                                 f"{np.abs(k - ref).max()}")
    p = ws.window_sums_plain(vi, se).cpu().numpy()
    if not np.array_equal(p, ref):
        raise AssertionError(f"[{tag}] K1's plain version at the mesh shape "
                             f"not exact: err {np.abs(p - ref).max()}")
    t_k = kernel_timed(lambda: ws.window_sums(v, se, hint))
    t_p = timed(lambda: ws.window_sums_plain(v, se), reps=20)
    csr = csr_of(S * T, s, e, dev)
    t_l = kernel_timed(lambda: torch.mv(csr, v))
    bms, by = bound_ms(*work_of(S * T, s, e))
    del csr
    return (f"K1 at the mesh launch (S={S} x T_pad={T}, {len(s)} "
            f"extents, widest {hint}, {ws.form_for(hint)} form) exact on "
            f"the launch's values and, with its plain version, on bounded "
            f"integers; device ms per launch (wall): {fmt(t_k)}, plain "
            f"{fmt(t_p)}, sparse mv {fmt(t_l)}, bound {bms:.4g} ms ({by}) "
            f"({card})")


def k2r_at_mesh_shape(tag: str, args, comb, neutral: float, opc: int,
                      transcendental: bool, card: str) -> str:
    """K2r at the cell's last launch (one tree over every shard's row)
    against its plain version (bitwise, or within ULP_BOUND for a
    transcendental combine); device time, the bound, the plain
    version's; no library call folds under max or logaddexp."""
    from windflow_tpu_torch.ops.cuda import flatfat_query as fq
    from windflow_tpu_torch.ops.cuda.window_sum import next_pow2
    values, starts, ends = args
    S, T = values.shape
    stride = next_pow2(T)
    n = max(fq.BUILD_QUERY_MIN_LEAVES, next_pow2(S) * stride)
    leaves = np.full(n, neutral, np.float32)
    leaves[: S * stride].reshape(S, stride)[:, :T] = values
    s, e = flat_extents(starts, ends, stride)
    dev = torch.device(MESH_DEVICE)
    lv = torch.from_numpy(leaves).to(dev)
    se = pack(s, e, dev)
    k = fq.flatfat_build_query(lv, se, comb, neutral).cpu().numpy()
    p = fq.flatfat_build_query_plain(lv, se, comb, neutral).cpu().numpy()
    bitwise, ulps = hold_user(k, p, transcendental, f"{tag} K2r")
    t_k = kernel_timed(lambda: fq.flatfat_build_query(lv, se, comb,
                                                      neutral))
    t_p = timed(lambda: fq.flatfat_build_query_plain(lv, se, comb, neutral),
                reps=10)
    bms, by = bound_ms(4 * n + 12 * len(s),
                       (n - 1 + walk_nodes(n, None, s, e)[1]) * opc)
    return (f"K2r at the mesh launch (S={S} x T_pad={T} in a tree of {n} "
            f"leaves, {len(s)} extents) "
            f"{'bitwise' if bitwise else f'{ulps} ulp from'} its plain "
            f"version; device ms per launch (wall): {fmt(t_k)}, plain "
            f"{fmt(t_p)}, bound {bms:.4g} ms ({by}), no library call "
            f"({card})")


def torch_form_reading(fn, nbytes: int, ops: int, reps: int = 20) -> dict:
    """A torch form's device ms a call (torch.profiler; queued_ms where
    it saw no device time), the device ops (kernels and copies) a call
    launches and the costliest of them, from the same profiler run (none
    where it saw none), and its bound."""
    profs: list = []
    t = timed(fn, reps=reps, profile_out=profs)
    if t[0] is None:
        t = (queued_ms(fn), t[1])
    rows = sorted(((getattr(e, "self_device_time_total", 0), e.count, e.key)
                   for e in profs[0].key_averages()), reverse=True)
    rows = [r for r in rows if r[0] > 0]
    bms, by = bound_ms(nbytes, ops)
    return {"t": t, "launches": sum(r[1] for r in rows) / reps,
            "top": "; ".join(f"{k[:40]} {us / reps:.2f} us"
                             for us, _n, k in rows[:3]),
            "bound_ms": bms, "bound_by": by}


def form_text(name: str, r: dict) -> str:
    return (f"{name} {fmt(r['t'])} device ms a call (wall), "
            f"{r['launches']:g} device ops a call (costliest: {r['top']}), "
            f"bound {r['bound_ms']:.4g} ms ({r['bound_by']})")


def mesh_kf4(card: str) -> int:
    """[mesh kf4]: KeyFarmMesh("sum") on 8 logical key shards of the card
    at config 4's size: every window equal to the float64 oracle exactly
    and to [main4 coalesced]'s (KeyFarmTPU on the same feed), K1's
    launches equal to the batches, no other kernel."""
    import windflow_tpu_torch as wf
    from windflow_tpu_torch.operators.tpu.mesh_farm import (
        KeyFarmMesh, KeyFarmMeshLogic)
    from windflow_tpu_torch.parallel.mesh import make_mesh
    rec: dict = {}

    def make():
        op = KeyFarmMesh(make_mesh(8, win_axis=1, device=MESH_DEVICE), WIN,
                         SLIDE, wf.WinType.TB,
                         batch_windows=MESH_BATCH_WINDOWS)
        record_calls(op.engine, "compute_kf", rec)
        return op

    logic, counts, _u, sink, secs = mesh_cell("mesh kf4", make, N_MESH,
                                              KeyFarmMeshLogic)
    launches = check_launches("mesh kf4", logic, counts, "window_sum")
    got = check_windows(sink, oracle(N_MESH), "mesh kf4")
    farm = FARM_WINDOWS.get("main4 coalesced")
    if farm is not None and not all(np.array_equal(a, b)
                                    for a, b in zip(got, farm)):
        raise AssertionError("[mesh kf4] windows differ from KeyFarmTPU's")
    k1 = k1_at_mesh_shape("mesh kf4", rec["compute_kf"], card)
    log(f"{mesh_line('mesh kf4', N_MESH, secs, sink, logic)}, {launches} "
        f"K1 launches, other kernels 0; {len(got[0])} windows equal to the "
        f"oracle exactly"
        + (" and to [main4 coalesced]'s (KeyFarmTPU)" if farm is not None
           else "") + f"; {k1}")
    return launches


def mesh_kinds(card: str) -> tuple:
    """[mesh kf kinds]: the KF graph under max and under an FFAT spec
    ('ffat', lift, torch.logaddexp, -inf): K2r's launches equal the
    batches (logaddexp's all from its generated library); max exact,
    logaddexp within rtol 1e-5 of the float64 oracle, K2r at the mesh
    shape within ULP_BOUND of its plain version.  Returns K2r's builtin
    and user-combine launches."""
    import windflow_tpu_torch as wf
    from windflow_tpu_torch.operators.tpu.mesh_farm import (
        KeyFarmMesh, KeyFarmMeshLogic)
    from windflow_tpu_torch.parallel.mesh import make_mesh
    lse, lse_neutral, lse_ops, _t = user_combines()[PATH_COMBINE]
    out = {}
    for label, spec, comb, neutral, opc, trans in (
            ("max", "max", torch.maximum, -np.inf, 1, False),
            (PATH_COMBINE, ("ffat", lambda v: v, lse, lse_neutral), lse,
             lse_neutral, lse_ops, True)):
        tag = f"mesh kf {label}"
        rec: dict = {}

        def make(spec=spec, rec=rec):
            op = KeyFarmMesh(make_mesh(8, win_axis=1, device=MESH_DEVICE),
                             WIN, SLIDE, wf.WinType.TB,
                             batch_windows=MESH_BATCH_WINDOWS, kind=spec)
            record_calls(op.engine, "compute_kf", rec)
            return op

        logic, counts, users, sink, secs = mesh_cell(tag, make, N_MESH_KINDS,
                                                     KeyFarmMeshLogic)
        if trans:
            out["user"] = check_user_launches(tag, logic, counts, users,
                                              "flatfat_build_query")
            want = mesh_oracle(N_MESH_KINDS, WIN, SLIDE, "logaddexp")
            got = check_windows(sink, want, tag, rtol=RTOL_F32)
            held = (f"within rtol {RTOL_F32} of the float64 oracle "
                    f"({ulp_distance(got[2], want[2])} ulp at most)")
        else:
            out["builtin"] = check_launches(tag, logic, counts,
                                            "flatfat_build_query")
            got = check_windows(sink, mesh_oracle(N_MESH_KINDS, WIN, SLIDE,
                                                  "max"), tag)
            held = "equal to the oracle exactly"
        k2r = k2r_at_mesh_shape(tag, rec["compute_kf"], comb, neutral, opc,
                                trans, card)
        log(f"{mesh_line(tag, N_MESH_KINDS, secs, sink, logic)}, "
            f"{logic.launched_batches} K2r launches, other kernels 0; "
            f"{len(got[0])} windows {held}; {k2r}")
    return out["builtin"], out["user"]


def mesh_pf3(card: str) -> dict:
    """[mesh pf3]: PaneFarmMesh("sum") on make_mesh(8, win_axis=2) at
    config 3's window and on a full 8-ring (win_axis=8) whose windows
    span 4 hops: every window once, exact against the oracle, no hand
    kernel (the ring is a torch program).  Returns the ring's launch
    arguments of the 8-ring cell."""
    import windflow_tpu_torch as wf
    from windflow_tpu_torch.operators.tpu.pane_mesh import (
        PaneFarmMesh, PaneFarmMeshLogic)
    from windflow_tpu_torch.parallel.mesh import make_mesh
    rec: dict = {}
    for win_axis, slide, epoch in ((2, SLIDE, 64),
                                   (8, PF_RING_SLIDE, PF_RING_EPOCH)):
        tag = f"mesh pf3 win_axis={win_axis}"
        calls: dict = {}

        def make(win_axis=win_axis, slide=slide, epoch=epoch, calls=calls):
            op = PaneFarmMesh(make_mesh(8, win_axis=win_axis,
                                        device=MESH_DEVICE), WIN, slide,
                              wf.WinType.TB, panes_per_epoch=epoch)
            record_calls(op.engine, "compute_pf_ring", calls)
            calls["engine"] = op.engine
            return op

        logic, counts, _u, sink, secs = mesh_cell(
            tag, make, N_MESH_PF, PaneFarmMeshLogic,
            closing=lambda ids, keys, s=slide: (ids * s + WIN - 1) * N_KEYS
            + keys)
        check_launches(tag, logic, counts, None)
        got = check_windows(sink, mesh_oracle(N_MESH_PF, WIN, slide), tag)
        pane_vals, pane_len = calls["compute_pf_ring"]
        eng = calls["engine"]
        wpp = max(1, eng.win_len // pane_len)
        p_loc = pane_vals.shape[1] // win_axis
        hops = min(win_axis - 1, -(-(wpp - 1) // p_loc))
        log(f"{mesh_line(tag, N_MESH_PF, secs, sink, logic)} (ring "
            f"launches), no hand kernel; {len(got[0])} windows once each, "
            f"equal to the oracle exactly; window {WIN} / slide {slide}: "
            f"{wpp} panes a window, {p_loc} a shard, {hops} hop(s); last "
            f"launch {pane_vals.shape[0]} rows x {pane_vals.shape[1]} panes "
            f"({card})")
        rec[win_axis] = calls
    return rec


def mesh_wmr(card: str) -> dict:
    """[mesh wmr]: WinMapReduceMesh("sum") on make_mesh(8, win_axis=4):
    exact against the oracle, no hand kernel (the stripes' folds and
    their combine over 'win' are a torch program)."""
    import windflow_tpu_torch as wf
    from windflow_tpu_torch.operators.tpu.wmr_mesh import (
        WinMapReduceMesh, WinMapReduceMeshLogic)
    from windflow_tpu_torch.parallel.mesh import make_mesh
    calls: dict = {}

    def make():
        op = WinMapReduceMesh(make_mesh(8, win_axis=4, device=MESH_DEVICE),
                              WIN, SLIDE, wf.WinType.TB,
                              batch_windows=MESH_BATCH_WINDOWS)
        record_calls(op.engine, "compute_wmr", calls)
        calls["engine"] = op.engine
        return op

    logic, counts, _u, sink, secs = mesh_cell("mesh wmr", make, N_MESH_WMR,
                                              WinMapReduceMeshLogic)
    check_launches("mesh wmr", logic, counts, None)
    got = check_windows(sink, oracle(N_MESH_WMR), "mesh wmr")
    stripes = calls["compute_wmr"][0]
    log(f"{mesh_line('mesh wmr', N_MESH_WMR, secs, sink, logic)}, no hand "
        f"kernel; {len(got[0])} windows equal to the oracle exactly; last "
        f"launch stripes {list(stripes.shape)} ({card})")
    return calls


def mesh_step(card: str):
    """[mesh step]: ShardedWindowEngine.step on the dry run's mesh (8
    slots, win_axis 2) at config 4's window and the KF cell's widths, on
    integer data (every prefix below 2^24): KF, WMR and PF outputs equal
    numpy's float64 exactly; no hand kernel.  Returns the engine and its
    device inputs."""
    from windflow_tpu_torch.parallel.mesh import make_mesh
    from windflow_tpu_torch.parallel.sharded import ShardedWindowEngine
    eng = ShardedWindowEngine(make_mesh(8, win_axis=2, device=MESH_DEVICE),
                              WIN, SLIDE)
    K, W = eng.n_key_shards, eng.n_win_shards
    rows = N_KEYS
    rng = np.random.default_rng(16)
    values = rng.integers(0, 32, (K, STEP_T)).astype(np.float32)
    B = (STEP_T - WIN) // SLIDE + 1
    starts = np.tile(np.arange(B, dtype=np.int32) * SLIDE, (K, 1))
    ends = starts + np.int32(WIN)
    stripes = rng.integers(0, VMOD, (rows, W, STEP_STRIPE_B, WIN // W)
                           ).astype(np.float32)
    panes = rng.integers(0, VMOD, (rows, W, STEP_PANES, SLIDE)
                         ).astype(np.float32)
    dev = torch.device(MESH_DEVICE)
    args = tuple(torch.from_numpy(a).to(dev)
                 for a in (values, starts, ends, stripes, panes))
    reset_counts()
    kf, wmr, pf = (t.cpu().numpy() for t in eng.step(*args))
    counts = read_counts()
    if any(counts.values()):
        raise AssertionError(f"[mesh step] kernels {counts} on a torch "
                             f"program")
    c = np.concatenate([np.zeros((K, 1)), np.cumsum(values, 1,
                                                    dtype=np.float64)], 1)
    want_kf = np.take_along_axis(c, ends, 1) - np.take_along_axis(c, starts,
                                                                  1)
    partials = panes.astype(np.float64).sum(-1).reshape(rows, -1)
    wpp, spp = WIN // SLIDE, 1
    n_win = (partials.shape[1] - wpp) // spp + 1
    want_pf = np.stack([partials[:, w * spp: w * spp + wpp].sum(1)
                        for w in range(n_win)], 1)
    for name, g_, w_ in (("kf", kf, want_kf),
                         ("wmr", wmr[:, 0, :],
                          stripes.astype(np.float64).sum((1, 3))),
                         ("pf", pf, want_pf)):
        if not np.array_equal(g_, w_):
            raise AssertionError(f"[mesh step] {name} differs from numpy "
                                 f"(err {np.abs(g_ - w_).max()})")
    log(f"[mesh step] mesh {eng.mesh.shape}, KF [{K}, {STEP_T}] x {B} "
        f"windows, stripes {list(stripes.shape)}, panes "
        f"{list(panes.shape)}: KF, WMR and PF equal to numpy exactly; no "
        f"hand kernel ({card})")
    return eng, args


def mesh_forms(card: str, wmr_calls: dict, pf_calls: dict, step) -> dict:
    """The mesh plane's torch forms at their cells' shapes: device ms a
    call, device ops a call, bound (inputs read and outputs written once;
    one f32 op an element folded)."""
    dev = torch.device(MESH_DEVICE)
    eng = wmr_calls["engine"]
    stripes = torch.from_numpy(wmr_calls["compute_wmr"][0]).to(dev)
    R, W, B, L = stripes.shape
    forms = {"compute_wmr": torch_form_reading(
        lambda: eng.compute_wmr(stripes), 4 * (R * W * B * L + R * B),
        R * W * B * L)}
    ring = pf_calls["engine"]
    pane_vals, pane_len = pf_calls["compute_pf_ring"]
    pv = torch.from_numpy(pane_vals).to(dev)
    K, P, pl = pv.shape
    wpp = max(1, ring.win_len // pane_len)
    spp = max(1, ring.slide_len // pane_len)
    n_out = P // spp
    forms["compute_pf_ring"] = torch_form_reading(
        lambda: ring.compute_pf_ring(pv, pane_len),
        4 * (K * P * pl + K * n_out), K * P * pl + K * n_out * wpp)
    seng, args = step
    v, s, e, st, pn = args
    Ks, T = v.shape
    Bs = s.shape[1]
    Rr, Wr, B2, L2 = st.shape
    P2, pl2 = pn.shape[2], pn.shape[3]
    n_win = (Wr * P2 - WIN // SLIDE) + 1
    forms["step"] = torch_form_reading(
        lambda: seng.step(*args),
        4 * (Ks * T + 3 * Ks * Bs + Rr * Wr * B2 * L2 + Rr * B2
             + Rr * Wr * P2 * pl2 + Rr * n_win),
        Ks * T + Rr * Wr * B2 * L2 + Rr * Wr * P2 * pl2
        + Rr * n_win * (WIN // SLIDE))
    log(f"[mesh forms] torch programs on the card at their cells' shapes: "
        f"{form_text('compute_wmr', forms['compute_wmr'])} (stripes "
        f"[{R}, {W}, {B}, {L}]); "
        f"{form_text('compute_pf_ring', forms['compute_pf_ring'])} ("
        f"[{K}, {P}, {pl}], 8-ring); {form_text('step', forms['step'])} "
        f"({card})")
    return forms


def main_mesh(card: str) -> dict:
    """Phase 16's cells; returns the kernels' launches: K1 (window_sum),
    K2r builtin (max) and K2r under the user combine (logaddexp)."""
    walls = {}

    def cell(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[name] = round(time.perf_counter() - t0, 1)
        return out

    k1 = cell("kf4", mesh_kf4, card)
    k2r, k2r_user = cell("kinds", mesh_kinds, card)
    pf = cell("pf3", mesh_pf3, card)
    wmr = cell("wmr", mesh_wmr, card)
    step = cell("step", mesh_step, card)
    cell("forms", mesh_forms, card, wmr, pf[8], step)
    log(f"[mesh] seconds a cell, checks and readings included: {walls}")
    return {"window_sum": k1, "flatfat_build_query": k2r, "user": k2r_user}


# ---------------------------------------------------------------------------
# 17. feed: the feed and placement plane (bench configs 2b, 2f, 2g, 2h,
#     2j, 19 and 15_replan_shift)
# ---------------------------------------------------------------------------

# bench.py:2330-2337: config 2b, the headline graph at 16M events with
# source batches of 2^17 and a 5 ms launch delay
N2B = N_EVENTS // 4
SOURCE2B = SOURCE_BATCH // 8
DELAY2B_MS = 5.0
# bench.py:2343-2346: config 2f, the headline's events as TupleBatches
N2F = N_EVENTS
# bench.py:291-322, :2352-2377: configs 2g (LEVEL0) and 2h (LEVEL2), a
# replay trace of random f32 values through the ingest plane
N2G = N_EVENTS // 4
INGEST_MICROBATCH = 1 << 19
INGEST_CREDITS = 1 << 21
INGEST_LATENCY_MS = 50.0
# bench.py:407-460, :2390-2434: config 2j, two feeders through the planner
N2J = N_EVENTS
FEEDERS2J = 2
# bench.py:1936-2010, :2585-2594: config 19, the device step on/off, at
# a quarter of the bench's N_EVENTS // 8: its step-off lane runs about
# 170k tuples/s on the card, 53 s a run at 8M events (PERF.md §4)
N19 = N_EVENTS // 32
WIN19, SLIDE19, KEYS19, SOURCE19, BATCH19 = 1024, 16, 8, 8192, 16
REPS19 = 3
# [profile19]'s depth: a quarter of the cell's, for a readable trace
N19_PROFILE = N19 // 4
# bench.py:1835-1933: config 15_replan_shift
REPLAN_PINS = {"WINDFLOW_RTT_FLOOR_MS": "0.001",
               "WINDFLOW_HOST_RATE_TPS": "20000000",
               "WINDFLOW_DEVICE_COMPUTE_MS": "0"}
N15R, SOURCE15R, PACE15R_S, TAIL15R = 1_200_000, 1500, 0.004, 25
WIN15R, SLIDE15R, KEYS15R, BATCH15R = 1024, 32, 4, 64
# the feed cells' device (the CPU only to rehearse the phase)
FEED_DEVICE = "cuda"


def feed_card() -> str:
    """The device name a feed cell's engine must be bound to."""
    return "cuda:0" if FEED_DEVICE == "cuda" else FEED_DEVICE


def feed_engine(tag: str, g, host: bool = False):
    """The graph's one window engine: on ``feed_card()``, or on the host
    lane where the cell is host by design."""
    logic = find_logic(g)
    if host:
        if logic.resolved_placement != "host":
            raise AssertionError(f"[{tag}] engine on "
                                 f"{logic.resolved_placement}, not host")
    elif str(logic.device) != feed_card():
        raise AssertionError(f"[{tag}] engine device {logic.device}")
    return logic


def periodic_oracle(period: np.ndarray, M: int, win: int, slide: int):
    """(keys, ids, sums) of every window of the series ``period[k, t % P]``
    (t < M, float64) under windows ``win`` / ``slide`` over t, partial
    tail windows flushed at EOS, sorted by key then id."""
    K, P = period.shape
    partial = np.concatenate([np.zeros((K, 1)), np.cumsum(period, 1)], 1)

    def prefix(n):
        return (n // P) * partial[:, -1:] + partial[:, n % P]

    n_win = (M - 1) // slide + 1
    a = np.arange(n_win) * slide
    sums = prefix(np.minimum(a + win, M)) - prefix(a)
    return (np.repeat(np.arange(K), n_win), np.tile(np.arange(n_win), K),
            sums.reshape(-1))


def law_period(n_keys: int, vmod: int) -> np.ndarray:
    """[keys, vmod] period of the law value(event t*keys + k) = e % vmod."""
    t = np.arange(vmod)
    return ((t[None, :] * n_keys + np.arange(n_keys)[:, None])
            % vmod).astype(np.float64)


def feed_cell(tag: str, n: int, card: str, **kw):
    """Configs 2b and 2f: the headline graph, every kernel count set to 0
    just before and read just after; every window equal to the oracle
    exactly, K1's launches equal to the batches.  Returns (K1 launches,
    tuples/s)."""
    reset_counts()
    g, sink, secs = run_main(n, FEED_DEVICE, **kw)
    counts = read_counts()
    logic = feed_engine(tag, g)
    launches = check_launches(tag, logic, counts, "window_sum")
    got = check_windows(sink, oracle(n), tag)
    log(f"{feed_line(tag, n, secs, sink)}; {len(got[0])} windows equal to "
        f"the oracle exactly; {launches} K1 launches = batches, native "
        f"lane {logic._native is not None} ({card})")
    return launches, n / secs


class IngestLatencySink(LatencySink):
    """bench.py's _IngestLatencySink: birth = the replay source's stamp of
    the ship that carried the window's closing tuple (its cumulative raw
    tuples emitted)."""

    def __init__(self, stamps_fn):
        super().__init__([])
        self.stamps_fn = stamps_fn  # the source's logic exists once wired

    def births(self, closing: np.ndarray) -> np.ndarray:
        stamps = self.stamps_fn()
        cums = np.asarray([s[0] for s in stamps])
        ts = np.asarray([s[1] for s in stamps])
        return ts[np.minimum(np.searchsorted(cums, closing, side="right"),
                             len(cums) - 1)]


def ingest_trace(n: int):
    """bench.py:307-312: key e % 64, id = ts = e // 64, random f32 values
    (default_rng(0))."""
    from windflow_tpu_torch.core.tuples import TupleBatch
    arange = np.arange(n, dtype=np.int64)
    ids = arange // N_KEYS
    vals = np.random.default_rng(0).random(n).astype(np.float32)
    return TupleBatch({"key": arange % N_KEYS, "id": ids, "ts": ids,
                       "value": vals}), vals


def ingest_cell(tag: str, level: str, trace, want, card: str) -> dict:
    """Configs 2g / 2h: the replay trace through SourceBuilder.from_replay
    (microbatch 2^19, credits 2^21, the AIMD controller on a 50 ms
    target, pane pre-reduction) into the headline's WinSeqTPU at
    ``level``: windows within rtol 1e-5 of the float64 oracle, nothing
    shed, K1's launches equal to the batches."""
    import windflow_tpu_torch as wf
    from windflow_tpu_torch.operators.basic_ops import Sink
    src = wf.SourceBuilder.from_replay(trace, speedup=None, chunk=None) \
        .with_microbatch(INGEST_MICROBATCH) \
        .with_credits(INGEST_CREDITS).build()
    cfg = wf.RuntimeConfig(device=FEED_DEVICE,
                           latency_target_ms=INGEST_LATENCY_MS,
                           opt_level=getattr(wf.OptLevel, level))
    g = wf.PipeGraph(f"chip_smoke_{tag}", wf.Mode.DEFAULT, config=cfg)
    sink = IngestLatencySink(lambda: src.logics[0].emit_stamps)
    g.add_source(src).add(config11_op()).add_sink(Sink(sink))
    reset_counts()
    t0 = time.perf_counter()
    g.run()
    secs = time.perf_counter() - t0
    counts = read_counts()
    logic = feed_engine(tag, g)
    launches = check_launches(tag, logic, counts, "window_sum")
    got = check_windows(sink, want, tag, rtol=RTOL_F32)
    shed = src.shed_count()
    if shed:
        raise AssertionError(f"[{tag}] {shed} tuples shed")
    m = src.logics[0].metrics()
    pre = src.logics[0].coalescer.pre_reduce is not None
    log(f"{feed_line(tag, N2G, secs, sink)}; {len(got[0])} windows within "
        f"rtol {RTOL_F32} of the float64 oracle; 0 shed; {launches} K1 "
        f"launches = batches; pane pre-reduction {pre}; "
        f"controller_batch_final {m['batch_size']}, credit_waits "
        f"{m['credit_waits']} ({card})")
    return {"rate": N2G / secs, "k1": launches, "batch": m["batch_size"],
            "waits": m["credit_waits"]}


def lane_stats(g) -> dict:
    """The engine replica's device timing from the stats JSON (bench.py
    :446-454): launches, Device_time_ms, bytes a launch."""
    dev = {}
    for o in json.loads(g.stats.to_json())["Operators"]:
        for r in o["Replicas"]:
            if r.get("Device_launches"):
                dev = {"launches": r["Device_launches"],
                       "device_time_ms": r["Device_time_ms"],
                       "bytes_per_launch": r.get("Device_bytes_per_launch")}
    return dev


def planner_lane(placement: str, want, card: str) -> dict:
    """Config 2j at ``placement``: FeedSource(chunk_fn, feeders=2) (its
    columns from the shared arena) into WinSeqTPU(placement=...,
    adaptive_batch=True); windows within rtol 1e-5 of the oracle; K1's
    launches equal to Device_launches on a lane resolved to the card,
    no kernel on the host lane."""
    import windflow_tpu_torch as wf
    from windflow_tpu_torch.ingest.feed import FeedSource
    from windflow_tpu_torch.operators.basic_ops import Sink
    tag = f"planner2j {placement}"
    sb = SOURCE_BATCH
    n_chunks = N2J // sb  # whole chunks only, as bench.py:430
    stamps = [0.0] * n_chunks
    pool = np.random.default_rng(0).random(sb).astype(np.float32)

    def chunk_fn(i, take):
        if i >= n_chunks:
            return None
        idx = take(sb, np.int64)
        idx[:] = np.arange(i * sb, (i + 1) * sb)
        keys = np.mod(idx, N_KEYS, out=take(sb, np.int64))
        ids = np.floor_divide(idx, N_KEYS, out=idx)
        vals = take(sb, np.float32)
        vals[:] = pool
        stamps[i] = time.perf_counter()
        return keys, ids, ids, vals

    g = wf.PipeGraph(f"chip_smoke_2j_{placement}", wf.Mode.DEFAULT,
                     config=wf.RuntimeConfig(device=FEED_DEVICE))
    sink = LatencySink(stamps, sb)
    g.add_source(FeedSource(chunk_fn, feeders=FEEDERS2J)) \
        .add(config11_op(placement=placement, adaptive_batch=True)) \
        .add_sink(Sink(sink))
    reset_counts()
    t0 = time.perf_counter()
    g.run()
    secs = time.perf_counter() - t0
    counts = read_counts()
    (entry,) = g.placements
    host = entry["placement"] == "host"
    logic = feed_engine(tag, g, host=host)
    dev = lane_stats(g)
    if host:
        if any(counts.values()):
            raise AssertionError(f"[{tag}] kernels {counts} on the host "
                                 f"lane")
        launches = 0
    else:
        launches = check_launches(tag, logic, counts, "window_sum")
        if dev.get("launches") != launches:
            raise AssertionError(f"[{tag}] K1 {launches} != "
                                 f"Device_launches {dev.get('launches')}")
    got = check_windows(sink, want, tag, rtol=RTOL_F32)
    resizes = (list(logic._adaptive.resizes) if logic._adaptive is not None
               else [])
    decision = {k: entry[k] for k in (
        "placement", "reason", "rtt_floor_ms", "host_rate_tps",
        "device_rate_tps", "device_compute_ms", "tuples_per_launch",
        "bytes_per_launch") if k in entry}
    log(f"{feed_line(tag, n_chunks * sb, secs, sink)}; {len(got[0])} "
        f"windows within rtol {RTOL_F32} of the oracle; lane "
        f"{entry['placement']}; "
        f"{launches} K1 launches"
        + ("" if host else " = Device_launches") + f"; the planner: "
        f"{json.dumps(decision)}; device_time_ms "
        f"{dev.get('device_time_ms')}, launches {dev.get('launches')}, "
        f"bytes a launch {dev.get('bytes_per_launch')}; final_batch_len "
        f"{logic.batch_len}, batch_resizes {resizes} ({card})")
    return {"rate": n_chunks * sb / secs, "k1": launches,
            "placement": entry["placement"]}


def planner2j(card: str) -> tuple:
    """Config 2j's three lanes at equal N; auto_not_worse read, not
    asserted.  Returns (K1 launches, the auto lane's tuples/s)."""
    from windflow_tpu_torch.graph import planner
    n_keys_period = SOURCE_BATCH // N_KEYS
    pool = np.random.default_rng(0).random(SOURCE_BATCH).astype(np.float32)
    n = N2J // SOURCE_BATCH * SOURCE_BATCH
    want = periodic_oracle(pool.astype(np.float64)
                           .reshape(n_keys_period, N_KEYS).T,
                           n // N_KEYS, WIN, SLIDE)
    lanes = {p: planner_lane(p, want, card)
             for p in ("auto", "device", "host")}
    rates = {p: round(r["rate"], 1) for p, r in lanes.items()}
    ok = rates["auto"] >= 0.9 * min(rates["device"], rates["host"])
    log(f"[planner2j] lane rates {json.dumps(rates)}; "
        f"auto resolved {lanes['auto']['placement']}; auto_not_worse {ok} "
        f"(auto >= 0.9 x min(device, host)); planner inputs: RTT floor "
        f"{planner.rtt_floor_ms():.4f} ms, host rate "
        f"{planner.host_rate_tps():.1f} tuples/s, device compute "
        f"{planner.device_compute_ms_per_launch():.4f} ms a launch "
        f"({card})")
    return sum(r["k1"] for r in lanes.values()), rates["auto"]


class DictSink:
    """bench.py's config-19 sink: each window's value by (key, id), how
    many times it arrived, and its latency from the stamp of the source
    batch holding its closing tuple (id * slide + win - 1 of its key)."""

    def __init__(self, stamps, win, slide, n_keys, chunk):
        self.stamps, self.win, self.slide = stamps, win, slide
        self.n_keys, self.chunk = n_keys, chunk
        self.lock = threading.Lock()
        self.results, self.counts, self.lats = {}, {}, []

    def __call__(self, r):
        if r is None:
            return
        now = time.perf_counter()
        with self.lock:
            k = (r.key, r.id)
            self.results[k] = r.value
            self.counts[k] = self.counts.get(k, 0) + 1
            closing = (r.id * self.slide + self.win - 1) * self.n_keys + r.key
            ci = min(closing // self.chunk, len(self.stamps) - 1)
            if ci >= 0:
                self.lats.append(now - self.stamps[ci])

    def check(self, want, tag: str) -> int:
        """Every window once and equal to ``want`` exactly."""
        if self.counts and max(self.counts.values()) != 1:
            raise AssertionError(f"[{tag}] duplicate windows")
        keys, ids, vals = want
        got = np.array([self.results.get((int(k), int(i)), np.nan)
                        for k, i in zip(keys, ids)])
        if len(self.results) != len(keys) or not np.array_equal(got, vals):
            raise AssertionError(f"[{tag}] {len(self.results)} windows, "
                                 f"oracle {len(keys)}; "
                                 f"{int(np.sum(got != vals))} differ")
        return len(keys)


def lane_kernel(logic) -> str:
    """The kernel a device lane launches: the fused update+query kernel
    on the resident pane lane the planner promotes it to, K1 else."""
    return ("flatfat_update_query" if logic._resident is not None
            else "window_sum")


def run19(step: bool, n: int, clock=None):
    """One config-19 lane (bench.py:1960-2000): BatchSource of the law
    (key e % 8, id = ts = e // 8, value e % 97) -> WinSeqTPU("sum",
    1024, 16, CB, batch_len 16, value_of) -> Sink, with the device step
    on or off.  ``clock`` (a HostClock) times the source and the sink.
    Returns (graph, sink, seconds)."""
    import windflow_tpu_torch as wf
    from windflow_tpu_torch.core.tuples import TupleBatch
    from windflow_tpu_torch.operators.basic_ops import Sink
    from windflow_tpu_torch.operators.batch_ops import BatchSource
    from windflow_tpu_torch.operators.tpu.win_seq_tpu import WinSeqTPU
    stamps: list = []
    state = {"i": 0}

    def batch():
        i = state["i"]
        if i >= n:
            return None
        state["i"] = i + SOURCE19
        stamps.append(time.perf_counter())
        idx = np.arange(i, min(i + SOURCE19, n))
        return TupleBatch({"key": idx % KEYS19, "id": idx // KEYS19,
                           "ts": idx // KEYS19,
                           "value": (idx % VMOD).astype(np.float64)})

    sink = DictSink(stamps, WIN19, SLIDE19, KEYS19, SOURCE19)
    src_fn, sink_fn = batch, sink
    if clock is not None:
        src_fn, sink_fn = clock.wrap("source", batch), clock.wrap("sink",
                                                                  sink)
    g = wf.PipeGraph("chip_smoke19", wf.Mode.DEFAULT,
                     config=wf.RuntimeConfig(device=FEED_DEVICE,
                                             device_step=step))
    op = WinSeqTPU("sum", WIN19, SLIDE19, wf.WinType.CB,
                   batch_len=BATCH19, max_buffer_elems=MAX_BUFFER,
                   inflight_depth=INFLIGHT, value_of=lambda t: t.value)
    g.add_source(BatchSource(src_fn)).add(op).add_sink(Sink(sink_fn))
    t0 = time.perf_counter()
    g.run()
    return g, sink, time.perf_counter() - t0


def step19_lane(step: bool, want, card: str) -> dict:
    """One gated config-19 run: every window once and exact, the lane's
    kernel launched once a batch and as often as Device_launches, the
    step engaged exactly when on with at most 2 launches an ingest
    chunk (its own counters and Device_launches)."""
    tag = f"step19 {'on' if step else 'off'}"
    reset_counts()
    g, sink, secs = run19(step, N19)
    counts = read_counts()
    logic = feed_engine(tag, g)
    kernel = lane_kernel(logic)
    launches = check_launches(tag, logic, counts, kernel)
    dev = lane_stats(g)
    if dev.get("launches") != launches:
        raise AssertionError(f"[{tag}] {kernel} {launches} != "
                             f"Device_launches {dev.get('launches')}")
    sink.check(want, tag)
    chunks, boundary, n_steps = step_info(g)
    if bool(n_steps) != step:
        raise AssertionError(f"[{tag}] {n_steps} step nodes")
    if step and not (chunks > 0 and boundary <= 2 * chunks
                     and launches <= 2 * chunks):
        raise AssertionError(f"[{tag}] {chunks} chunks, {boundary} "
                             f"boundary launches, {launches} launches")
    return {"g": g, "sink": sink, "rate": N19 / secs, "kernel": kernel,
            "launches": launches, "chunks": chunks}


def step19(card: str) -> dict:
    """Config 19: step off and on interleaved, REPS19 reps, bitwise equal
    in every rep; best-of-3 rates.  Returns the launches by kernel."""
    want = periodic_oracle(law_period(KEYS19, VMOD), N19 // KEYS19, WIN19,
                           SLIDE19)
    best = {False: 0.0, True: 0.0}
    launches = collections.Counter()
    for rep in range(REPS19):
        runs = {step: step19_lane(step, want, card) for step in (False, True)}
        if runs[False]["sink"].results != runs[True]["sink"].results:
            raise AssertionError(f"[step19] rep {rep}: step on and off "
                                 f"differ")
        for step, r in runs.items():
            best[step] = max(best[step], r["rate"])
            launches[r["kernel"]] += r["launches"]
        on = runs[True]
        log(f"[step19] rep {rep}: off {runs[False]['rate']:.1f} tuples/s "
            f"({runs[False]['launches']} {runs[False]['kernel']} "
            f"launches), on {on['rate']:.1f} tuples/s ({on['launches']} "
            f"{on['kernel']} launches, {on['chunks']} chunks = "
            f"{on['launches'] / on['chunks']:.3f} a chunk); bitwise equal, "
            f"{len(want[0])} windows exact ({card})")
    lats = on["sink"].lats
    p50, p99 = (float(np.percentile(lats, q)) * 1e3 for q in (50, 99))
    log(f"[step19] best of {REPS19}: step on {best[True]:.1f}, off "
        f"{best[False]:.1f} tuples/s (speedup "
        f"{best[True] / best[False]:.3f}); launches a chunk "
        f"{on['launches'] / on['chunks']:.3f}; step lane window latency "
        f"p50 {p50:.3f} ms, p99 {p99:.3f} ms ({card})")
    return launches


class HostClock:
    """Seconds spent in named callables, summed over every thread that
    called them (a callable running inside another counts in both)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.secs = collections.Counter()
        self.calls = collections.Counter()

    def wrap(self, name: str, fn):
        def clocked(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                dt = time.perf_counter() - t0
                with self.lock:
                    self.secs[name] += dt
                    self.calls[name] += 1
        return clocked

    def patch(self, name: str, cls, attr: str):
        """Time ``cls.attr`` for every instance; returns the undo."""
        orig = cls.__dict__[attr]
        setattr(cls, attr, self.wrap(name, orig))
        return lambda: setattr(cls, attr, orig)

    def text(self) -> str:
        return ", ".join(f"{n} {self.secs[n]:.3f} s in {self.calls[n]} "
                         f"calls" for n in self.secs)


def profile19(card: str) -> None:
    """[profile19] one run of each config-19 lane at N19_PROFILE events
    under torch.profiler (CUDA activity): the card's idle share, the
    launches, device time a launch, and the host's time in the source,
    the engine's ingest (svc), the step's boundary flush, the hand-off
    to the dispatcher (_submit, inside svc or the flush), the launch
    (engine compute on the dispatcher thread), the wait for the D2H
    copy (the handle's block) and the sink."""
    from windflow_tpu_torch.graph.device_step import DeviceStepLogic
    from windflow_tpu_torch.operators.tpu.win_seq_tpu import WinSeqTPULogic
    from windflow_tpu_torch.ops import window_compute as wc
    want = periodic_oracle(law_period(KEYS19, VMOD),
                           N19_PROFILE // KEYS19, WIN19, SLIDE19)
    for step in (False, True):
        tag = f"profile19 {'on' if step else 'off'}"
        clock = HostClock()
        undo = [clock.patch("svc", WinSeqTPULogic, "svc"),
                clock.patch("step flush", DeviceStepLogic, "_flush_boundary"),
                clock.patch("dispatch", WinSeqTPULogic, "_submit"),
                clock.patch("launch", wc.WindowComputeEngine, "compute"),
                clock.patch("launch", wc._ResidentPaneLaunch, "compute"),
                clock.patch("D2H wait", wc.DeviceBatchHandle, "block")]
        act = torch.profiler.ProfilerActivity
        try:
            # CPU activity only to rehearse the phase without a card
            with torch.profiler.profile(activities=[
                    act.CUDA if FEED_DEVICE == "cuda" else act.CPU]) as p:
                g, sink, secs = run19(step, N19_PROFILE, clock)
        finally:
            for u in undo:
                u()
        sink.check(want, tag)
        logic = feed_engine(tag, g)
        launches = lane_stats(g).get("launches", 0)
        busy = device_busy_ms(p)
        chunks, _b, _n = step_info(g)
        log(f"[{tag}] {N19_PROFILE} events, wall {secs:.3f} s, "
            f"{N19_PROFILE / secs:.1f} tuples/s; {launches} launches "
            f"({lane_kernel(logic)})"
            + (f", {chunks} chunks" if step else "")
            + f"; device busy {busy:.3f} ms = {busy / max(1, launches):.5f} "
            f"ms a launch, idle {100 - 100 * busy / (secs * 1e3):.3f}%; "
            f"host: {clock.text()}; {profile_summary(p, secs, 4)} ({card})")


def replan15(card: str) -> dict:
    """[replan15] config 15_replan_shift (bench.py:1835-1933), with the
    cost model pinned (RTT floor 0.001 ms, host 20M tuples/s, device
    compute 0) and restored after: a paced stream of 1,500-event
    batches every 4 ms into WinSeqTPU("sum", 1024, 32, CB, batch_len 64,
    inflight 1, placement auto, value_of) with the online re-planner on
    (replan_ticks 2), until 25 batches after the flip or 1.2M events.
    Gates: the lane starts on the card, a replacement flight event
    device -> host, no conservation_violation, every window once and
    equal to the integer oracle on both sides of the flip, and the
    lane's kernel launched as often as the batches up to the flip
    (read inside the flip's quiesce) and not after.  Returns the
    launches by kernel."""
    import windflow_tpu_torch as wf
    from windflow_tpu_torch.core.tuples import TupleBatch
    from windflow_tpu_torch.operators.basic_ops import Sink
    from windflow_tpu_torch.operators.batch_ops import BatchSource
    from windflow_tpu_torch.operators.tpu.win_seq_tpu import WinSeqTPU
    tag = "replan15"
    saved = {k: os.environ.get(k) for k in REPLAN_PINS}
    os.environ.update(REPLAN_PINS)
    try:
        cfg = wf.RuntimeConfig(device=FEED_DEVICE, replan=True,
                               replan_ticks=2, diagnosis_interval_s=0.15,
                               audit_interval_s=0.1)
        g = wf.PipeGraph("chip_smoke15r", wf.Mode.DEFAULT, config=cfg)
        state = {"i": 0, "tail": 0}
        stamps: list = []

        def batch():
            i = state["i"]
            if any(e["kind"] == "replacement" for e in g.flight.snapshot()):
                state["tail"] += 1
            if i >= N15R or state["tail"] > TAIL15R:
                return None
            state["i"] = i + SOURCE15R
            time.sleep(PACE15R_S)
            stamps.append(time.perf_counter())
            idx = np.arange(i, i + SOURCE15R)
            return TupleBatch({"key": idx % KEYS15R, "id": idx // KEYS15R,
                               "ts": idx // KEYS15R,
                               "value": (idx % 7).astype(np.float64)})

        sink = DictSink(stamps, WIN15R, SLIDE15R, KEYS15R, SOURCE15R)
        op = WinSeqTPU("sum", WIN15R, SLIDE15R, wf.WinType.CB,
                       batch_len=BATCH15R, inflight_depth=1,
                       placement="auto", value_of=lambda t: t.value)
        g.add_source(BatchSource(batch)).add(op).add_sink(Sink(sink))
        reset_counts()
        t0 = time.perf_counter()
        g.start()
        logic = find_logic(g)
        flip: dict = {}
        orig = logic.apply_placement

        def spy(placement, rtt_floor_ms=None):
            # inside replace_lane's quiesce: no batch in flight, so the
            # engine's batches so far are its device launches
            if placement == "host" and "batches" not in flip:
                flip.update(batches=logic.launched_batches,
                            kernel=lane_kernel(logic),
                            counts=read_counts(), device=str(logic.device))
            return orig(placement, rtt_floor_ms=rtt_floor_ms)

        logic.apply_placement = spy
        g.wait_end()
        secs = time.perf_counter() - t0
        counts = read_counts()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    events = g.flight.snapshot()
    flips = [e for e in events if e["kind"] == "replacement"]
    (entry,) = [p for p in g.placements if "win_seq_tpu" in p["operator"]]
    if entry.get("device") != feed_card():
        raise AssertionError(f"[{tag}] the lane started on "
                             f"{entry.get('device')}, not {feed_card()}")
    if not flips or (flips[0].get("old"), flips[0].get("new")) != (
            "device", "host"):
        last = lane_stats(g)
        raise AssertionError(
            f"[{tag}] no device -> host flip after {state['i']} events in "
            f"{secs:.3f} s: flight {[e['kind'] for e in events][-20:]}; "
            f"Device_time_ms {last.get('device_time_ms')} over "
            f"{last.get('launches')} launches ({card})")
    if any(e["kind"] == "conservation_violation" for e in events):
        raise AssertionError(f"[{tag}] conservation violated across the "
                             f"flip")
    fed = state["i"]
    n_win = sink.check(periodic_oracle(law_period(KEYS15R, 7),
                                       fed // KEYS15R, WIN15R, SLIDE15R),
                       tag)
    kernel = flip["kernel"]
    if flip["device"] != feed_card() or counts[kernel] != flip["batches"] \
            or flip["batches"] <= 0 \
            or any(c for k, c in counts.items() if k != kernel):
        raise AssertionError(f"[{tag}] {kernel} launches {counts}, "
                             f"{flip['batches']} batches on "
                             f"{flip['device']} at the flip")
    ev = flips[0].get("evidence") or {}
    log(f"[{tag}] {fed} events in {secs:.3f} s = {fed / secs:.1f} tuples/s; "
        f"flipped device -> host ({flips[0].get('trigger')}) in "
        f"{flips[0].get('duration_ms')} ms, evidence measured_ms "
        f"{ev.get('measured_ms')}, device_compute_ms "
        f"{ev.get('device_compute_ms')}, device_rate_tps "
        f"{ev.get('device_rate_tps')} against host_rate_tps "
        f"{ev.get('host_rate_tps')}; {n_win} windows once each and equal "
        f"to the oracle across the flip, no conservation_violation; "
        f"{flip['batches']} {kernel} launches on {flip['device']} up to "
        f"the flip, {logic.launched_batches - flip['batches']} host "
        f"batches after ({card})")
    return {kernel: flip["batches"]}


def main_feed(card: str) -> dict:
    """Phase 17's cells, each with every kernel
    count set to 0 just before it and read just after; [replan15] last,
    since the re-planner records its measured device compute in-process
    and every later 'auto' decision would read it.  Returns the
    launches by kernel."""
    walls = {}
    launches = collections.Counter()

    def cell(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        walls[name] = round(time.perf_counter() - t0, 1)
        return out

    k1, _rate = cell("2b", feed_cell, "feed2b", N2B, card,
                     make_op=lambda: config11_op(
                         max_batch_delay_ms=DELAY2B_MS),
                     source_batch=SOURCE2B)
    launches["window_sum"] += k1
    k1, rate2f = cell("2f", feed_cell, "feed2f", N2F, card,
                      materialize=True)
    launches["window_sum"] += k1
    trace, vals = ingest_trace(N2G)
    want = periodic_oracle(vals.astype(np.float64).reshape(-1, N_KEYS).T,
                           N2G // N_KEYS, WIN, SLIDE)
    g2g = cell("2g", ingest_cell, "ingest2g", "LEVEL0", trace, want, card)
    g2h = cell("2h", ingest_cell, "ingest2h", "LEVEL2", trace, want, card)
    del trace, vals, want
    launches["window_sum"] += g2g["k1"] + g2h["k1"]
    log(f"[ingest2g] vs_feed {g2g['rate'] / rate2f:.3f} (2g / 2f); "
        f"[ingest2h] fused_delta {g2h['rate'] / g2g['rate']:.3f} (2h / 2g) "
        f"({card})")
    k1, _auto = cell("2j", planner2j, card)
    launches["window_sum"] += k1
    launches.update(cell("19", step19, card))
    cell("profile19", profile19, card)
    launches.update(cell("15r", replan15, card))
    log(f"[feed] seconds a cell, checks and readings included: {walls}")
    return launches


def kernel_entry(name, source, replaces, launches, err, t) -> dict:
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"[device] torch: {name}; nvidia-smi: {card}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    device = torch.device("cuda", 0)

    build_all()
    # the fused kernel first: its step walls are host times, taken
    # before any phase has run the profiler in this process
    k2f = check_fused(device, card)
    k1 = check_kernel(device, card)
    k2 = check_k2(device, card)
    k2r = check_k2r(device, card)
    log(f"[smoke] kernels checked at {time.perf_counter() - t_start:.1f} s")
    # signed zeros under max and min through every path that folds them
    # (its K2/K2f/K2r launches are not the main path's)
    signed_zeros(card)

    reset_counts()
    g, sink, secs = run_main(N_EVENTS, "cuda")
    counts = read_counts()
    logic = find_logic(g)
    if logic.device is None or logic.device.type != "cuda":
        raise AssertionError(f"[main] engine device {logic.device}")
    launches = check_launches("main", logic, counts, "window_sum")
    windows = check_main(g, sink, N_EVENTS)
    p50, p99 = (float(np.percentile(sink.lats, q)) * 1e3 for q in (50, 99))
    log(f"[main] {N_EVENTS} events in {secs:.3f} s = "
        f"{N_EVENTS / secs:.1f} tuples/s; {windows} windows match the "
        f"oracle exactly; window latency p50 {p50:.3f} ms, p99 "
        f"{p99:.3f} ms; {launches} kernel launches = "
        f"{logic.launched_batches} batches ({card})")
    profile_main(card)

    # bench configs 3 and 4 (config 4 with its replicas coalesced into
    # one engine, the default, and as two), the other device farms and
    # a custom window function; each path driven with every launch
    # count set to 0 just before it and read just after
    farm_launches = collections.Counter()
    for cell, n in (("main3", N34), ("main4 coalesced", N34),
                    ("main4 replicas", N34), ("farms WinFarmTPU", N_FARM),
                    ("farms WinMapReduceTPU", N_WMR), ("custom", N_CUSTOM)):
        kernel, count = run_farm(cell, n, card)
        if kernel is not None:
            farm_launches[kernel] += count
    for cell in ("main3", "main4 coalesced", "main4 replicas"):
        profile_farm(cell, N34, card)
    log(f"[smoke] farms done at {time.perf_counter() - t_start:.1f} s")

    # config 15's four cells and its two FFAT cells under the user
    # combine; each path driven with every launch count set to 0 just
    # before it and read just after
    launches15 = main15(card)
    launches15["flatfat_update_query"] += resident_pane(card)
    user15 = main15_user(card)
    user15["flatfat_build_query"] += key_ffat_user(card)
    launches15["flatfat_query"] = drive_flatfat(card)
    user15["flatfat_query"] = drive_flatfat_user(card)
    # the profiled reruns at a quarter of config 15's events: room in
    # the script's time for the durability cells (phase 11)
    profile15(card, "rebuild", N15_PROFILE)
    profile15(card, "resident", N15_PROFILE)
    log(f"[smoke] config 15 done at {time.perf_counter() - t_start:.1f} s")

    # bench configs 5 and 6 (the application models); each cell driven
    # with every launch count set to 0 just before it and read just
    # after: count windows sum pane counts with the window-sum kernel,
    # max is a torch program
    launches += main_models(card)
    log(f"[smoke] models done at {time.perf_counter() - t_start:.1f} s")

    # the durability plane: config 11 with epochs on and off, the crash
    # cells (config 11, config 15's resident lane, the device step) and
    # configs 16 and 17; each kernel count set to 0 just before a path
    # and read just after (a crash cell's: its restored attempt)
    k1_durable, k2f_durable = main_durable(card)
    launches += k1_durable
    launches15["flatfat_update_query"] += k2f_durable
    log(f"[smoke] durability done at {time.perf_counter() - t_start:.1f} s")

    # the elastic and event-time planes: config 15's resident forest
    # repartitioned 1 -> 3 -> 1 on the card, configs 2i and 18; each
    # path driven with every launch count set to 0 just before it and
    # read just after
    launches15["flatfat_update_query"] += main_planes(card)
    log(f"[smoke] planes done at {time.perf_counter() - t_start:.1f} s")

    # the mission-control plane: bench config 13 (the SLO plane and the
    # live cluster view), a breach on a live K1 graph, the dashboard and
    # the doctor, and the overhead gates 8-10; each run with every
    # kernel count set to 0 just before it and read just after
    launches += main_mission(card)
    log(f"[smoke] mission done at {time.perf_counter() - t_start:.1f} s")

    # the distributed runtime plane: bench config 12's Q5 shuffle in one
    # process and across two worker processes, on the host lane as the
    # bench has it and on the device lane (worker 1 launches K1), and
    # the plane's smoke modules; each run with every kernel count set to
    # 0 just before it and read just after (a worker's: at its exit)
    t14 = time.perf_counter()
    launches += main_distributed(card)
    log(f"[smoke] distributed done in {time.perf_counter() - t14:.1f} s")

    # the serving plane and the global scheduler: two tenants' K1 lanes
    # leased and contended on the card, the neighbour's demoted by the
    # arbiter; bench configs 14 and 20; two K1 tenants on two fleet
    # workers; each run with every kernel count set to 0 just before it
    # and read just after (a fleet worker's: at its exit)
    t15 = time.perf_counter()
    launches += main_serving(card)
    log(f"[smoke] serving done in {time.perf_counter() - t15:.1f} s")

    # the mesh plane: KeyFarmMesh at config 4's size on 8 logical key
    # shards of the card (K1), under max and logaddexp (K2r), the pane
    # farm's ring, the striped WMR and the fused step; each cell with
    # every kernel count set to 0 just before it and read just after
    t16 = time.perf_counter()
    mesh = main_mesh(card)
    launches += mesh["window_sum"]
    launches15["flatfat_build_query"] += mesh["flatfat_build_query"]
    user15["flatfat_build_query"] += mesh["user"]
    log(f"[smoke] mesh done in {time.perf_counter() - t16:.1f} s")

    # the feed and placement plane: bench configs 2b, 2f (K1), the
    # ingest plane at 2g and 2h (K1), the planner's parallel feed at 2j
    # (auto, device: K1; host: none), the device step at 19 and the
    # re-planner at 15_replan_shift (the lanes' own kernel up to the
    # flip); each cell with every kernel count set to 0 just before it
    # and read just after
    t17 = time.perf_counter()
    feed = main_feed(card)
    launches += feed["window_sum"]
    launches15["flatfat_update_query"] += feed["flatfat_update_query"]
    log(f"[smoke] feed done in {time.perf_counter() - t17:.1f} s")
    log(f"[smoke] total {time.perf_counter() - t_start:.1f} s")

    src = "windflow_tpu_torch/ops/cuda/flatfat_query.cu"
    log(json.dumps({"kernels": [
        kernel_entry("window_sum", "windflow_tpu_torch/ops/cuda/window_sum.cu",
                     "windflow_tpu/ops/pallas/window_sum.py:62",
                     launches + farm_launches["window_sum"],
                     k1["max_abs_err"], k1),
        kernel_entry("flatfat_query", src,
                     "windflow_tpu/ops/pallas/flatfat_query.py:91",
                     launches15["flatfat_query"], k2["max_abs_err"],
                     k2["rebuild"]),
        kernel_entry("flatfat_update_query", src,
                     "windflow_tpu/ops/pallas/flatfat_query.py:91",
                     launches15["flatfat_update_query"]
                     + farm_launches["flatfat_update_query"],
                     k2f["max_abs_err"], k2f["resident"]),
        kernel_entry("flatfat_build_query", src,
                     "windflow_tpu/ops/pallas/flatfat_query.py:91",
                     launches15["flatfat_build_query"], k2r["max_abs_err"],
                     k2r)] + [
        # the same kernels compiled with the user combine of the path
        kernel_entry(f"{entry} (user combine torch.{PATH_COMBINE})", src,
                     "windflow_tpu/ops/pallas/flatfat_query.py:91",
                     user15[entry], t["user"]["max_abs_err"], t["user"])
        for entry, t in (("flatfat_query", k2),
                         ("flatfat_update_query", k2f),
                         ("flatfat_build_query", k2r))]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
