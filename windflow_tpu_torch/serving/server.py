"""Multi-tenant serving plane: one shared runtime hosting many
PipeGraphs (docs/SERVING.md).

The :class:`Server` turns the library into an operable runtime:

* **dynamic submission/teardown** -- ``submit(name, build_fn,
  tenant=TenantSpec(...))`` constructs a fresh PipeGraph, lets the
  caller's ``build_fn`` populate it, starts it, and registers it
  against the server's shared monitoring/dashboard plane; the returned
  :class:`TenantHandle` watches the graph to a terminal state
  (``COMPLETED`` / ``STOPPED`` / ``FAILED``).  ``handle.stop()`` /
  ``Server.evict(name)`` tear a tenant down with full resource
  reclamation: replica/monitor/auditor threads joined by the graph's
  own ``wait_end``, dashboard sockets closed, ColumnPool arenas
  drained, credit reservation returned to the cap.  One tenant's crash
  surfaces as a FAILED handle while every other tenant keeps flowing
  -- isolation is per-graph by construction (own channels, own
  CancelToken, own DeadLetterStore, own buffer pool).
* **per-tenant budgets + admission control** -- every tenant reserves
  its ``TenantSpec.credits`` under the server's global ``capacity``
  cap at submit (strictly: an over-cap submit raises
  :class:`~windflow_tpu_torch.serving.tenant.AdmissionError`), and the
  reservation is partitioned across the tenant's ingest credit gates,
  so a tenant over budget blocks or sheds at ITS OWN ingest boundary
  into ITS OWN ledger-visible dead letters.
* **the cross-tenant arbiter** -- see serving/arbiter.py; the server
  supplies :meth:`tenant_views` and applies decisions
  (:meth:`apply_arbitration` / :meth:`apply_restitution`), recording
  every decision as an ``arbitration`` flight event in its own ring
  and both affected tenants' graph rings.
* **per-tenant observability** -- each graph's stats JSON carries a
  ``Tenant`` block, the dashboard serves a registered-apps index and a
  ``/tenants`` view, ``/metrics`` grows ``windflow_tenant_*``
  families, and ``doctor`` explains every arbitration.

Tenant graphs run their device lanes on the CUDA card unless the
tenant's config asks for ``RuntimeConfig(device="cpu")``; a tenant
whose graph asks for the card where there is none ends ``FAILED`` with
the error on its handle, and never runs on the CPU instead.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Callable, Dict, List, Optional

from .arbiter import (ArbiterConfig, CrossTenantArbiter, Donation,
                      TenantView, describe_actions, describe_evidence)
from .tenant import AdmissionError, TenantSpec, TenantState


def process_census() -> dict:
    """Thread + file-descriptor census of this process -- the
    lifecycle-leak regression surface (tests assert repeated
    submit/evict cycles return to the baseline census)."""
    threads = sorted(t.name for t in threading.enumerate())
    try:
        fds = len(os.listdir("/proc/self/fd"))
    except OSError:  # non-procfs platform: thread census only
        fds = -1
    return {"threads": len(threads), "names": threads, "fds": fds}


class TenantHandle:
    """One submitted tenant: the graph, its live resource lease, and a
    watcher thread driving the handle to a terminal state."""

    def __init__(self, server: "Server", name: str, spec: TenantSpec,
                 graph):
        self.server = server
        self.name = name
        self.spec = spec
        self.graph = graph
        self.state = TenantState.RUNNING
        self.error: Optional[BaseException] = None
        self.credits = spec.credits     # live allocation (arbiter moves it)
        self.arbitrations = 0
        self._ingest: List = []          # IngestSourceLogic instances
        self._stop_requested = False
        self._done = threading.Event()
        self._watcher = threading.Thread(
            target=self._watch, name=f"windflow-tenant-{name}",
            daemon=True)

    # -- lifecycle -----------------------------------------------------
    def _watch(self) -> None:
        error: Optional[BaseException] = None
        try:
            self.graph.wait_end()
            state = TenantState.STOPPED if self._stop_requested \
                else TenantState.COMPLETED
        except BaseException as exc:
            # cancellation we asked for is not a failure -- but a
            # GENUINE replica error racing our stop() must still
            # surface as FAILED (a pure-cancel NodeFailureError
            # carries no (name, error) pairs; one from a real crash
            # does, whether or not a stop was also in flight)
            genuine = bool(getattr(exc, "errors", None))
            if self._stop_requested and not genuine:
                state = TenantState.STOPPED
            else:
                state, error = TenantState.FAILED, exc
        self.state, self.error = state, error
        self.server._on_tenant_end(self)
        self._done.set()

    def wait(self, timeout: Optional[float] = None) -> str:
        """Block until the tenant reaches a terminal state (or the
        timeout passes); returns the current state either way."""
        self._done.wait(timeout)
        return self.state

    def done(self) -> bool:
        return self._done.is_set()

    def stop(self, timeout: float = 30.0) -> str:
        """Cancel the graph and wait for teardown: replica + plane
        threads joined by ``wait_end``, then arenas drained.  A tenant
        already terminal just reclaims.  Returns the terminal state."""
        if not self._done.is_set():
            self._stop_requested = True
            self.graph.cancel()
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"tenant {self.name!r} did not tear down in {timeout}s")
        self._reclaim()
        return self.state

    def _reclaim(self) -> None:
        pool = getattr(self.graph, "buffer_pool", None)
        if pool is not None:
            pool.drain()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"<TenantHandle {self.name} {self.state} "
                f"credits={self.credits}>")


class Server:
    """Shared-runtime control plane hosting many tenant PipeGraphs
    under one global credit capacity cap, one monitoring/dashboard
    plane and one cross-tenant arbiter."""

    def __init__(self, capacity: int = 1 << 20, *,
                 name: str = "windflow-server",
                 arbiter=None, dashboard: bool = True,
                 http_port: Optional[int] = None,
                 fair_share: bool = False,
                 devices=None,
                 worker_id: Optional[int] = None):
        if capacity < 1:
            raise ValueError("Server capacity must be >= 1")
        self.name = name
        self.capacity = capacity
        self._granted = 0
        self._lock = threading.RLock()
        self._tenants: Dict[str, TenantHandle] = {}
        self._closed = False
        # global-scheduler plane (scheduler/): both knobs
        # default OFF so a plain Server behaves exactly as before --
        # the FleetServer's workers turn them on.
        self.worker_id = worker_id
        self.shares = None
        if fair_share:
            from ..scheduler.leases import FairShareRegistry
            self.shares = FairShareRegistry()
        self.devices = None
        if devices is not None:
            from ..scheduler.devices import DeviceLeaseRegistry
            self.devices = DeviceLeaseRegistry(lanes=devices) \
                if isinstance(devices, int) else devices
        from ..telemetry import FlightRecorder
        self.flight = FlightRecorder(512)
        # shared monitoring plane: every tenant's MonitoringThread
        # registers here (ephemeral port -- many servers coexist)
        self.dash = None
        self.httpd = None
        if not dashboard and http_port is not None:
            raise ValueError("http_port needs the dashboard plane "
                             "(Server(dashboard=False) has nothing "
                             "to serve)")
        if dashboard:
            from ..monitoring.dashboard import DashboardServer, serve_http
            self.dash = DashboardServer(port=0)
            self.dash.start()
            if http_port is not None:
                self.httpd = serve_http(self.dash, http_port,
                                        server=self)
        # the arbiter: ArbiterConfig | None (defaults) | False (off)
        if arbiter is False:
            acfg = None
        elif arbiter is None or arbiter is True:
            acfg = ArbiterConfig()
        else:
            acfg = arbiter
        self.arbiter = None
        if acfg is not None and acfg.enabled:
            self.arbiter = CrossTenantArbiter(self, acfg)
            self.arbiter.start()

    # -- submission / teardown -----------------------------------------
    def submit(self, name: str, build_fn: Callable,
               tenant: Optional[TenantSpec] = None,
               config=None) -> TenantHandle:
        """Construct, start and register one tenant graph.

        ``build_fn(graph)`` populates the fresh PipeGraph (sources,
        operators, sinks); ``tenant`` declares its budget/standing;
        ``config`` seeds the RuntimeConfig (cloned -- the server owns
        the tracing/dashboard/credit fields it needs)."""
        spec = tenant or TenantSpec()
        with self._lock:
            if self._closed:
                raise RuntimeError("Server is closed")
            if name in self._tenants:
                raise ValueError(f"tenant {name!r} already submitted "
                                 "(evict it first)")
            if self._granted + spec.credits > self.capacity:
                raise AdmissionError(
                    f"tenant {name!r} wants {spec.credits} credits but "
                    f"only {self.capacity - self._granted} of "
                    f"{self.capacity} remain under the global cap")
            self._granted += spec.credits
        handle: Optional[TenantHandle] = None
        try:
            handle = self._build_and_start(name, spec, build_fn, config)
        except BaseException:
            with self._lock:
                self._granted -= spec.credits
            raise
        if handle.error is not None:
            return self._register_failed_start(handle)
        with self._lock:
            # re-check BOTH refusal conditions at registration: a
            # close() that raced the build has already evicted its
            # registry snapshot (registering now would leak a running
            # graph nobody manages), and a concurrent same-name
            # submit may have won the registration -- overwriting it
            # would orphan the winner's graph the same way
            closed = self._closed
            duplicate = not closed and name in self._tenants
            if not closed and not duplicate:
                self._tenants[name] = handle
        if closed or duplicate:
            with self._lock:
                self._granted -= spec.credits
            handle.graph.cancel()

            def _unwind():
                try:
                    handle.graph.wait_end()
                except BaseException:
                    pass  # cancellation unwind; the refusal is the story
                handle._reclaim()

            # bounded like every other teardown here: a wedged loser
            # graph must not hang the refusing submit() forever
            t = threading.Thread(target=_unwind, daemon=True,
                                 name=f"windflow-submit-unwind-{name}")
            t.start()
            t.join(30.0)
            if closed:
                raise RuntimeError("Server is closed")
            raise ValueError(f"tenant {name!r} already submitted "
                             "(evict it first)")
        if self.arbiter is not None:
            # a re-submitted name starts with clean hysteresis state
            self.arbiter.forget(name)
        self.flight.record("tenant_submit", tenant=name,
                           credits=spec.credits, priority=spec.priority)
        handle._watcher.start()
        return handle

    def _build_and_start(self, name: str, spec: TenantSpec,
                         build_fn: Callable, config) -> TenantHandle:
        from ..core.basic import Mode, RuntimeConfig
        from ..graph.pipegraph import PipeGraph
        cfg = dataclasses.replace(config) if config is not None \
            else RuntimeConfig()
        # the serving plane is an OPERATED runtime: monitoring is on,
        # reporting to the server's shared dashboard (results stay
        # bitwise identical -- tracing sampling never alters the
        # item path, bench 8/13/14 assert it)
        cfg.tracing = True
        if self.dash is not None:
            cfg.dashboard_machine = "127.0.0.1"
            cfg.dashboard_port = self.dash.port
        # the tenant's credit allocation seeds every non-explicit
        # ingest gate; the per-gate split is rebalanced after start
        cfg.ingest_credits = spec.credits
        if spec.slo is not None:
            from ..slo import SloConfig
            cfg.slo = SloConfig(**spec.slo) \
                if isinstance(spec.slo, dict) else spec.slo
        if self.shares is not None:
            # the tenant's consume loops share cores by weighted
            # credit, not by the OS scheduler (scheduler/leases.py)
            cfg.sched_lease = self.shares.lease(name, spec.weight)
        g = PipeGraph(name, Mode.DEFAULT, cfg)
        if self.devices is not None:
            # the planner consults the worker's device-lease registry
            # before resolving 'device' (graph/planner.py)
            g.device_leases = self.devices
            g.tenant_name = name
            g.tenant_priority = spec.priority
        if spec.pool_buffers is not None and g.buffer_pool is not None:
            from ..core.tuples import ColumnPool
            g.buffer_pool = ColumnPool(max_per_bucket=spec.pool_buffers)
        handle = TenantHandle(self, name, spec, g)
        self._set_tenant_block(handle)
        build_fn(g)
        try:
            g.start()
        except BaseException as exc:
            # a partially-started graph must not strand threads: poison
            # whatever came up.  The graph was built: it ends FAILED
            # with the start error on its handle (a device lane asking
            # for CUDA on a box without a card never runs on the CPU)
            try:
                g.cancel()
            except Exception:
                pass

            def _unwind():
                # stop the planes that came up before the failure (the
                # monitor starts before the planner binds the card)
                try:
                    g.wait_end()
                except BaseException:
                    pass  # the start error is the story

            t = threading.Thread(target=_unwind, daemon=True,
                                 name=f"windflow-start-unwind-{name}")
            t.start()
            t.join(30.0)
            handle.error = exc
            return handle
        self._collect_ingest(handle)
        self._set_scheduler_block(handle)   # after plan: leases exist
        return handle

    def _register_failed_start(self, handle: TenantHandle) -> TenantHandle:
        """A built graph whose ``start`` raised: its reservation returns
        to the cap at once, and the handle is registered terminal
        (``FAILED``, the start error on ``handle.error``) so the
        tenant's row and ``Server.get`` show why.  The reference raises
        the error from ``submit`` instead; a build_fn error still
        does here."""
        name = handle.name
        handle.state = TenantState.FAILED
        with self._lock:
            self._granted -= handle.spec.credits
            closed = self._closed
            if not closed and name not in self._tenants:
                self._tenants[name] = handle
        if closed:
            raise RuntimeError("Server is closed")
        if self.get(name) is not handle:
            raise ValueError(f"tenant {name!r} already submitted "
                             "(evict it first)")
        if self.arbiter is not None:
            self.arbiter.forget(name)
        self.flight.record("tenant_submit", tenant=name,
                           credits=handle.spec.credits,
                           priority=handle.spec.priority)
        if self.shares is not None:
            self.shares.release(name)
        if self.devices is not None:
            self.devices.release(name)
        self._set_tenant_block(handle)
        self.flight.record("tenant_end", tenant=name, state=handle.state,
                           error=repr(handle.error))
        handle._done.set()
        return handle

    # -- resource plumbing ---------------------------------------------
    def _collect_ingest(self, handle: TenantHandle) -> None:
        """Find the tenant's ingest credit gates (source heads are
        never fused) and split its allocation across them."""
        from ..ingest.sources import IngestSourceLogic
        logics = [n.logic for n in handle.graph._all_nodes()
                  if isinstance(n.logic, IngestSourceLogic)]
        handle._ingest = logics
        if logics:
            self._apply_credit_split(handle)

    def _apply_credit_split(self, handle: TenantHandle) -> None:
        """Partition the live lease EXACTLY across the tenant's ingest
        gates (remainder to the first gates -- an even-only split
        would silently shave up to n-1 credits off the lease).  A
        CreditGate cannot hold less than one credit, so a lease below
        the gate count is effectively one credit per gate -- the only
        corner where the gates sum above the lease, and one the
        arbiter cannot create (its clamp floors at
        ``TenantSpec.min_credits``)."""
        gates = handle._ingest
        if not gates:
            return
        base, rem = divmod(max(handle.credits, len(gates)), len(gates))
        for i, logic in enumerate(gates):
            logic.gate.resize(base + (1 if i < rem else 0))

    def _transfer_credits(self, src: TenantHandle, dst: TenantHandle,
                          moved: int) -> int:
        """Zero-sum lease move between two RUNNING tenants.  The state
        check and both lease writes happen under the server lock --
        the same lock the watcher's end-of-tenant release takes and
        the watcher sets the terminal state BEFORE calling it, so a
        tenant terminating mid-move can never strand credits outside
        the ``_granted`` cap accounting.  Returns the amount actually
        moved (clamped against the live lease and ``src``'s floor)."""
        with self._lock:
            if src.state != TenantState.RUNNING \
                    or dst.state != TenantState.RUNNING:
                return 0
            moved = min(moved, src.credits - src.spec.min_credits)
            if moved <= 0:
                return 0
            src.credits -= moved
            dst.credits += moved
        for h in (src, dst):
            if h._ingest:
                self._apply_credit_split(h)
            self._set_tenant_block(h)
        return moved

    def _set_tenant_block(self, handle: TenantHandle) -> None:
        handle.graph.stats.set_tenant({
            "Name": handle.name,
            "State": handle.state,
            "Credits": handle.credits,
            "Arbitrations": handle.arbitrations,
            **handle.spec.block(),
        })

    def _set_scheduler_block(self, handle: TenantHandle) -> None:
        """The per-graph ``Scheduler`` stats block (schema v11): only
        published when some scheduler feature is on -- a plain
        Server's tenants keep the block None."""
        if self.shares is None and self.devices is None \
                and self.worker_id is None:
            return
        blk = {"Tenant": handle.name, "Worker": self.worker_id,
               "Fair_share": self.shares is not None}
        if self.shares is not None:
            blk["Weight"] = handle.spec.weight
        if self.devices is not None:
            blk["Device_leases"] = self.devices.tenant_rows(handle.name)
        handle.graph.stats.set_scheduler(blk)

    def _on_tenant_end(self, handle: TenantHandle) -> None:
        """Watcher callback at the tenant's terminal state: return its
        credit reservation to the cap and publish the final block."""
        with self._lock:
            self._granted -= handle.credits
        if self.shares is not None:
            # drop the lease so survivors' fair-share floor no longer
            # counts this tenant (activity expiry would also age it
            # out, but release is immediate and exact)
            self.shares.release(handle.name)
        if self.devices is not None:
            self.devices.release(handle.name)
        self._set_scheduler_block(handle)
        self._set_tenant_block(handle)
        self.flight.record("tenant_end", tenant=handle.name,
                           state=handle.state,
                           error=repr(handle.error)
                           if handle.error is not None else None)

    def evict(self, name: str, timeout: float = 30.0) -> TenantHandle:
        """Tear a tenant down (stop if still running) and drop it from
        the registry; its name becomes submittable again."""
        with self._lock:
            handle = self._tenants.get(name)
            if handle is None:
                raise KeyError(f"no tenant {name!r}")
        handle.stop(timeout)
        with self._lock:
            self._tenants.pop(name, None)
        return handle

    def tenants(self) -> Dict[str, TenantHandle]:
        with self._lock:
            return dict(self._tenants)

    def get(self, name: str) -> Optional[TenantHandle]:
        with self._lock:
            return self._tenants.get(name)

    @property
    def granted(self) -> int:
        with self._lock:
            return self._granted

    # -- arbiter surface -----------------------------------------------
    def tenant_views(self) -> List[TenantView]:
        """Gauge-grade snapshot of every registered tenant for the
        arbiter's planner: SLO tracker state, elastic headroom, credit
        lease.  Reads only state other planes already maintain."""
        views = []
        for handle in self.tenants().values():
            g = handle.graph
            tracker = getattr(g.diagnosis, "slo", None) \
                if g.diagnosis is not None else None
            breached = None
            burn_fast = budget = 0.0
            violating: tuple = ()
            values: dict = {}
            if tracker is not None:
                blk = tracker.block()
                breached = bool(blk.get("Breached"))
                burn_fast = float(blk.get("Burn_rate_fast") or 0.0)
                budget = float(blk.get("Budget_burned") or 0.0)
                violating = tuple(blk.get("Violating") or ())
                values = dict(blk.get("Values") or {})
            elastic = []
            for key, eh in getattr(g, "elastic", {}).items():
                elastic.append((key, eh.parallelism,
                                eh.spec.min_replicas,
                                eh.spec.max_replicas))
            scores = getattr(g.diagnosis, "_scores", None) or {} \
                if g.diagnosis is not None else {}
            views.append(TenantView(
                name=handle.name,
                running=handle.state == TenantState.RUNNING,
                priority=handle.spec.priority,
                weight=handle.spec.weight,
                donor=handle.spec.donor,
                breached=breached,
                burn_fast=burn_fast,
                budget_burned=budget,
                violating=violating,
                values=values,
                credits=handle.credits,
                min_credits=handle.spec.min_credits,
                elastic=elastic,
                bottleneck=max(scores.values(), default=0.0),
                device_ops=self.devices.tenant_rows(handle.name)
                if self.devices is not None else [],
                handle=handle,
            ))
        return views

    def _record_arbitration(self, victim, donor: TenantHandle,
                            action: str, evidence: dict,
                            actions: List[dict]) -> None:
        """``victim`` is a TenantHandle, or just its name when a
        restitution fires after the victim left -- the donor-side
        actuation must STILL be explained (every actuation is an
        arbitration flight event, ARCHITECTURE decision 16)."""
        victim_handle = victim if isinstance(victim, TenantHandle) \
            else None
        victim_name = victim.name if victim_handle is not None \
            else victim
        fields = dict(victim=victim_name, donor=donor.name,
                      action=action, evidence=evidence,
                      detail=describe_evidence(evidence),
                      actions=actions)
        self.flight.record("arbitration", **fields)
        donor.graph.flight.record("arbitration", **fields)
        donor.arbitrations += 1
        self._set_tenant_block(donor)
        if victim_handle is not None:
            victim_handle.graph.flight.record("arbitration", **fields)
            victim_handle.arbitrations += 1
            self._set_tenant_block(victim_handle)

    def apply_arbitration(self, decision: dict, victim=None,
                          donor=None) -> bool:
        """Apply one planned decision; returns True when at least one
        action took effect (the arbiter then opens the donor's
        cooldown and ledgers the donation).  ``victim``/``donor``
        accept the HANDLES the decision's views were taken from, so an
        evict + same-name resubmit after the snapshot actuates the
        departed handle (whose terminal state refuses below), never
        an unrelated namesake."""
        victim = victim if victim is not None \
            else self.get(decision["victim"])
        donor = donor if donor is not None \
            else self.get(decision["donor"])
        # both sides must still be RUNNING: the view was a snapshot,
        # and squeezing a donor (a possibly seconds-long rescale
        # drain) for a victim that just died is pure waste
        if victim is None or donor is None \
                or donor.state != TenantState.RUNNING \
                or victim.state != TenantState.RUNNING:
            return False
        cfg = self.arbiter.cfg if self.arbiter is not None \
            else ArbiterConfig()
        applied_any = False
        for a in decision["actions"]:
            if a["type"] == "rescale":
                try:
                    donor.graph.rescale(
                        a["operator"], a["new"],
                        trigger=f"arbiter:donate->{victim.name}",
                        timeout=cfg.rescale_timeout_s)
                    a["applied"] = True
                    applied_any = True
                except Exception as exc:
                    a["applied"] = False
                    a["error"] = repr(exc)
            elif a["type"] == "credits":
                # _transfer_credits re-clamps against the LIVE lease
                # under the server lock and refuses if either side
                # reached a terminal state (a released lease granted
                # anyway would corrupt the cap accounting)
                moved = self._transfer_credits(donor, victim,
                                               a["moved"])
                if moved > 0:
                    a["moved"] = moved
                    a["applied"] = True
                    applied_any = True
                else:
                    a["applied"] = False
            elif a["type"] == "device":
                # the contended-chip rung: flip the donor's lane
                # device->host through the quiesce path (zero lost
                # tuples) and release its chip lease so the victim
                # stops sharing the device
                try:
                    donor.graph.replace_lane(
                        a["operator"], "host",
                        trigger=f"arbiter:device->host"
                                f" for {victim.name}",
                        timeout=cfg.rescale_timeout_s,
                        evidence=decision.get("evidence") or None)
                    if self.devices is not None:
                        self.devices.release(donor.name,
                                             a["operator"])
                        self._set_scheduler_block(donor)
                        self._set_scheduler_block(victim)
                    a["applied"] = True
                    applied_any = True
                except Exception as exc:
                    a["applied"] = False
                    a["error"] = repr(exc)
        if applied_any:
            applied = [a for a in decision["actions"]
                       if a.get("applied")]
            self._record_arbitration(
                victim, donor,
                describe_actions(applied, donor.name, victim.name),
                decision.get("evidence") or {}, decision["actions"])
        return applied_any

    def apply_restitution(self, d: Donation) -> bool:
        """Reverse one ledgered donation (victim recovered or left).
        Mutates ``d`` to reflect what actually came back -- a restored
        rescale clears ``d.operator``, returned credits subtract from
        ``d.credits_moved`` -- so a PARTIAL restore (victim's floor or
        the cap clamped the give-back) stays ledgered for its
        remainder instead of silently forfeiting the donor's lease."""
        donor = self.get(d.donor)
        if donor is None or donor.state != TenantState.RUNNING:
            return False
        # a departed victim's name may have been re-submitted by an
        # UNRELATED tenant: never resolve the donation against it
        victim = None if d.victim_departed else self.get(d.victim)
        cfg = self.arbiter.cfg if self.arbiter is not None \
            else ArbiterConfig()
        actions: List[dict] = []
        if d.operator is not None and d.old_parallelism:
            eh = donor.graph.elastic.get(d.operator)
            cur = eh.parallelism if eh is not None else None
            if cur is None or cur >= d.old_parallelism:
                # already at/above the restore target (a manual or
                # elastic-controller rescale intervened): moot
                d.operator = None
            elif cur != d.new_parallelism:
                # a NEWER squeeze on this operator is still applied
                # below this one: restoring d.old_parallelism now
                # would silently undo it mid-breach.  Donations on one
                # operator unwind strictly LIFO -- leave this entry
                # for the tick after the newer one restores.
                pass
            else:
                try:
                    donor.graph.rescale(
                        d.operator, d.old_parallelism,
                        trigger=f"arbiter:restore<-{d.victim}",
                        timeout=cfg.rescale_timeout_s)
                    actions.append({"type": "rescale",
                                    "operator": d.operator,
                                    "old": d.new_parallelism,
                                    "new": d.old_parallelism,
                                    "applied": True})
                    d.operator = None   # restored; nothing left
                except Exception as exc:
                    actions.append({"type": "rescale",
                                    "operator": d.operator,
                                    "applied": False,
                                    "error": repr(exc)})
        if d.credits_moved > 0:
            if victim is not None \
                    and victim.state == TenantState.RUNNING:
                give_back = self._transfer_credits(victim, donor,
                                                   d.credits_moved)
            else:
                # a gone victim's lease was already released to the
                # cap; re-reserve for the donor only what the cap
                # still holds -- atomically with the donor's own
                # possible termination
                with self._lock:
                    if donor.state != TenantState.RUNNING:
                        give_back = 0
                    else:
                        give_back = min(d.credits_moved,
                                        self.capacity - self._granted)
                        if give_back > 0:
                            self._granted += give_back
                            donor.credits += give_back
                if give_back > 0:
                    if donor._ingest:
                        self._apply_credit_split(donor)
                    self._set_tenant_block(donor)
            if give_back > 0:
                d.credits_moved -= give_back
                actions.append({"type": "credits",
                                "moved": give_back,
                                "applied": True})
        applied = [a for a in actions if a.get("applied")]
        if applied:
            # record even when the victim already left: the donor-side
            # actuation must still be explained by doctor
            self._record_arbitration(
                victim if victim is not None else d.victim, donor,
                describe_actions(applied, d.donor, d.victim,
                                 restore=True),
                {}, actions)
        return bool(applied)

    # -- observability -------------------------------------------------
    def scheduler_block(self) -> Optional[dict]:
        """Worker-level ``Scheduler`` block (None when the scheduler
        plane is off): capacity envelope, per-tenant placements, fair
        -share leases with their accumulated waits, device leases.
        Fleet workers push this to the ClusterObserver so the policy
        re-reads live load, and ``merge_stats`` folds it fleet-wide."""
        if self.shares is None and self.devices is None \
                and self.worker_id is None:
            return None
        placements = []
        for handle in self.tenants().values():
            placements.append({
                "Tenant": handle.name,
                "Worker": self.worker_id,
                "State": handle.state,
                "Credits": handle.credits,
                "Priority": handle.spec.priority,
                "Weight": handle.spec.weight,
                "Devices": handle.spec.devices,
            })
        blk = {
            "Worker": self.worker_id,
            "Capacity": self.capacity,
            "Granted": self.granted,
            "Fair_share": self.shares is not None,
            "Placements": placements,
        }
        if self.shares is not None:
            blk.update(self.shares.block())
        if self.devices is not None:
            blk["Devices"] = self.devices.block()
        return blk

    def stats(self) -> dict:
        """The server-level ``Tenants`` block: one row per registered
        tenant with its standing, lease, state, last SLO judgement and
        arbitration count."""
        rows = []
        for handle in self.tenants().values():
            g = handle.graph
            with g.stats.lock:
                slo = g.stats.slo
            rows.append({
                "Name": handle.name,
                "State": handle.state,
                "Priority": handle.spec.priority,
                "Weight": handle.spec.weight,
                "Donor": handle.spec.donor,
                "Credits": handle.credits,
                "Arbitrations": handle.arbitrations,
                "Slo": slo,
                "Error": repr(handle.error)
                if handle.error is not None else None,
            })
        out = {
            "Server": self.name,
            "Capacity": self.capacity,
            "Granted": self.granted,
            "Tenant_count": len(rows),
            "Arbitration_decisions":
                self.arbiter.decisions_total
                if self.arbiter is not None else 0,
            "Tenants": rows,
        }
        sched = self.scheduler_block()
        if sched is not None:
            out["Scheduler"] = sched
        return out

    def stats_json(self) -> str:
        return json.dumps(self.stats())

    def explain(self, name: str) -> dict:
        """The tenant's doctor report (arbitration events included via
        its graph's flight ring)."""
        handle = self.get(name)
        if handle is None:
            raise KeyError(f"no tenant {name!r}")
        g = handle.graph
        if not g._ended:
            return g.explain()
        from ..diagnosis.report import build_report
        stats = json.loads(g.stats.to_json(
            g.get_num_dropped_tuples(), g.dead_letters.count()))
        return build_report(stats, g.flight.snapshot())

    # -- shutdown ------------------------------------------------------
    def close(self, timeout: float = 30.0) -> None:
        """Stop the arbiter, tear down every tenant, and close the
        shared dashboard/HTTP plane.  Idempotent.

        Cancellation is broadcast FIRST and the joins share ONE
        deadline (the DistRuntime.stop discipline: K wedged tenants
        cannot stack K x timeout).  A tenant that still refuses to
        tear down is surfaced with a warning and left registered --
        its watcher still releases the credit reservation whenever it
        finally unwinds, and its monitor falls back to stats-JSON
        snapshots once the dashboard is gone."""
        import time as _time
        import warnings as _warnings
        with self._lock:
            if self._closed:
                return
            self._closed = True
        if self.arbiter is not None:
            self.arbiter.stop()
        handles = self.tenants()
        for h in handles.values():
            if not h._done.is_set():
                h._stop_requested = True
                h.graph.cancel()
        deadline = _time.monotonic() + timeout
        stuck = []
        for name, h in handles.items():
            remaining = max(0.1, deadline - _time.monotonic())
            if h._done.wait(remaining):
                h._reclaim()
                with self._lock:
                    self._tenants.pop(name, None)
            else:
                stuck.append(name)
        if self.httpd is not None:
            self.httpd.shutdown()
            self.httpd.server_close()
            self.httpd = None
        if self.dash is not None:
            self.dash.stop()
            self.dash = None
        if stuck:
            _warnings.warn(
                f"Server.close: tenants did not tear down within "
                f"{timeout}s: {stuck} (threads abandoned as stuck; "
                f"their reservations release if they ever unwind)",
                RuntimeWarning, stacklevel=2)

    def __enter__(self) -> "Server":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
